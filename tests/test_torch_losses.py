"""The port's training loss (``GaussianDiffusion.loss`` / ``p_losses``)
against the JAX package's, fed the same x_start, the same epsilon function
and JAX's own draws (t, then the noise, replayed from the same key).

Tolerance: the JAX tests' f32 rtol 2e-4 / atol 2e-5 (tests/
test_pallas_kernels.py:29), for the losses and for the gradient of the loss
with respect to a scale of the epsilon function."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_turbulence_tpu.data import grid as jgrid
from generative_turbulence_tpu.data.schema import read_metadata as j_read_metadata
from generative_turbulence_tpu.data.synthetic import generate_case as j_generate_case
from generative_turbulence_tpu.data.variables import Variable as JVariable
from generative_turbulence_tpu.diffusion import gaussian as jg
from generative_turbulence_tpu_torch.data import grid as tgrid
from generative_turbulence_tpu_torch.data.schema import read_metadata
from generative_turbulence_tpu_torch.data.variables import Variable
from generative_turbulence_tpu_torch.diffusion import gaussian as tg
from test_torch_diffusion import Replay

T = 20
F32_TOL = dict(rtol=2e-4, atol=2e-5)


class ReplayDraws(Replay):
    """Replay that also hands out the loss's timestep draw."""

    def randint(self, n, high):
        draw = self.draws.pop(0)
        assert draw.shape == (n,) and 0 <= draw.min() and draw.max() < high
        return torch.tensor(draw, dtype=torch.long)


def jax_loss_draws(rng, shape, num_timesteps):
    """The draws of the JAX ``loss``, in its order: t from the first half of
    ``rng``, the noise of ``shape`` from the second."""
    rng_t, rng_noise = jax.random.split(rng)
    t = jax.random.randint(rng_t, (shape[0],), 0, num_timesteps, dtype=jnp.int32)
    return [np.asarray(t), np.asarray(jax.random.normal(rng_noise, shape))]


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    file = j_generate_case(
        tmp_path_factory.mktemp("loss") / "case", cell_counts=(10, 6, 6), n_frames=1, seed=4
    )
    variables = (JVariable.U, JVariable.P), (Variable.U, Variable.P)
    jgm = jgrid.GridMap.from_metadata(j_read_metadata(file), variables[0], cached=False)
    tgm = tgrid.GridMap.from_metadata(read_metadata(file), variables[1], device="cpu")
    return jgm, tgm


def _eps_fns(learned_variances):
    """An epsilon function of x, t and a scale, in JAX and torch; with
    learned variances it also returns the variance interpolation channels."""

    def j_eps(x, t, scale):
        eps = scale * jnp.tanh(x) + 0.02 * t[:, None, None, None, None].astype(jnp.float32) * jnp.cos(x)
        return jnp.concatenate([eps, 0.5 * jnp.sin(x)], -1) if learned_variances else eps

    def t_eps(x, t, scale):
        eps = scale * torch.tanh(x) + 0.02 * t[:, None, None, None, None].float() * torch.cos(x)
        return torch.cat([eps, 0.5 * torch.sin(x)], -1) if learned_variances else eps

    return j_eps, t_eps


CASES = {
    "l2": {},
    "l1": dict(loss_type="l1"),
    "l2-pinned-bcs": dict(noise_bcs=False),
    "l1-pinned-bcs": dict(loss_type="l1", noise_bcs=False),
    "v": dict(parameterization="v"),
    "min-snr-5": dict(loss_weighting="min-snr-5"),
    "v-min-snr-5": dict(parameterization="v", loss_weighting="min-snr-5"),
    "learned-variances-elbo": dict(learned_variances=True, elbo_weight=0.1),
    "learned-variances-elbo-attached": dict(learned_variances=True, elbo_weight=0.1, detach_elbo_mean=False),
    "learned-variances-no-elbo": dict(learned_variances=True),
}


@pytest.mark.parametrize("kind", ["loss", "p_losses-t0", "grad"])
@pytest.mark.parametrize("case", list(CASES))
def test_loss_matches_jax(grids, case, kind):
    """``loss`` with JAX's draws; ``p_losses`` at timesteps that include
    t = 0 (the ELBO's likelihood branch); and d loss / d scale."""
    jgm, tgm = grids
    kw = CASES[case]
    jd = jg.GaussianDiffusion.create(timesteps=T, **kw)
    td = tg.GaussianDiffusion.create(timesteps=T, **kw)
    x_start = np.random.default_rng(sum(map(ord, case))).normal(size=(3, *jgm.shape, 4)).astype(np.float32)
    j_eps, t_eps = _eps_fns(kw.get("learned_variances", False))
    rng = jax.random.PRNGKey(len(case))
    jx, tx = jnp.asarray(x_start), torch.from_numpy(x_start)

    if kind == "p_losses-t0":
        t = np.array([0, T - 1, 7], np.int32)
        noise = np.asarray(jax.random.normal(rng, x_start.shape))
        want = jd.p_losses(lambda x, tt: j_eps(x, tt, 0.8), jx, jnp.asarray(t), jgm, rng)
        got = td.p_losses(lambda x, tt: t_eps(x, tt, 0.8), tx, torch.tensor(t, dtype=torch.long), tgm,
                          Replay([noise]))
        np.testing.assert_allclose(float(got), float(want), **F32_TOL)
        return

    draws = jax_loss_draws(rng, x_start.shape, T)
    if kind == "loss":
        want = jd.loss(lambda x, tt: j_eps(x, tt, 0.8), jx, jgm, rng)
        got = td.loss(lambda x, tt: t_eps(x, tt, 0.8), tx, tgm, ReplayDraws(draws))
        assert got.dim() == 0 and got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), **F32_TOL)
        return

    want = jax.grad(lambda s: jd.loss(lambda x, tt: j_eps(x, tt, s), jx, jgm, rng))(0.8)
    scale = torch.tensor(0.8, requires_grad=True)
    td.loss(lambda x, tt: t_eps(x, tt, scale), tx, tgm, ReplayDraws(draws)).backward()
    assert abs(float(want)) > 1e-3
    np.testing.assert_allclose(float(scale.grad), float(want), **F32_TOL)


def test_loss_draws_from_a_generator(grids):
    """On its own the loss takes t and the noise from a torch.Generator
    (``GeneratorNoise``): the same seed gives the same loss."""
    _, tgm = grids
    td = tg.GaussianDiffusion.create(timesteps=T)
    x = torch.randn(2, *tgm.shape, 4, generator=torch.Generator().manual_seed(0))
    losses = [
        float(td.loss(lambda x, t: torch.tanh(x), x, tgm, tg.GeneratorNoise(torch.Generator().manual_seed(5), "cpu")))
        for _ in range(2)
    ]
    assert losses[0] == losses[1] and np.isfinite(losses[0])


@pytest.mark.parametrize("kw, match", [
    (dict(loss_type="huber"), "loss type"), (dict(loss_weighting="snr"), "loss weighting"),
])
def test_unknown_loss_options_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        tg.GaussianDiffusion.create(timesteps=T, **kw)
