"""The port's diffusion constants and samplers against the JAX package, fed
JAX's own normals (replayed from the same keys) and the same epsilon
function."""

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

T = 20
F32_TOL = dict(rtol=2e-4, atol=2e-5)
SAMPLER_TOL = dict(rtol=1e-3, atol=1e-4)


def jax_normals(rng, shape, n_steps, noise_bcs):
    """The standard normals the JAX samplers draw, in their order: x_T from
    the first half of ``rng``, then per step ``noise`` and ``bc_noise`` from
    ``split(split(rng)[1], n_steps)[i]``.  Drawn flat as (B, X*Y*Z*F), a
    C-order reshape of the dense state."""
    B = shape[0]
    n = int(np.prod(shape[1:]))
    rng_init, rng_scan = jax.random.split(rng)
    out = [jax.random.normal(rng_init, (B, n))]
    for r in jax.random.split(rng_scan, n_steps):
        rng_noise, rng_bc = jax.random.split(r)
        out.append(jax.random.normal(rng_noise, (B, n)))
        if noise_bcs:
            out.append(jax.random.normal(rng_bc, (B, n)))
    return [np.asarray(a).reshape(shape) for a in out]


class Replay:
    """A noise source that hands out a fixed sequence of draws."""

    def __init__(self, draws):
        self.draws = list(draws)

    def __call__(self, shape):
        draw = self.draws.pop(0)
        assert tuple(shape) == draw.shape
        return torch.tensor(draw)


def j_eps(x, t):
    return 0.8 * jnp.tanh(x) + 0.02 * t[:, None, None, None, None].astype(jnp.float32) * jnp.cos(x)


def t_eps(x, t):
    return 0.8 * torch.tanh(x) + 0.02 * t[:, None, None, None, None].float() * torch.cos(x)


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    file = j_generate_case(
        tmp_path_factory.mktemp("diff") / "case", cell_counts=(10, 6, 6), n_frames=1, seed=2
    )
    jgm = jgrid.GridMap.from_metadata(j_read_metadata(file), (JVariable.U, JVariable.P), cached=False)
    tgm = tgrid.GridMap.from_metadata(read_metadata(file), (Variable.U, Variable.P), device="cpu")
    return jgm, tgm


def _x_bcs(grid_shape, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(2, *grid_shape, 4)).astype(np.float32)


def _pair(**kw):
    return (
        jg.GaussianDiffusion.create(timesteps=T, **kw),
        tg.GaussianDiffusion.create(timesteps=T, **kw),
    )


@pytest.mark.parametrize("schedule", ["log-snr-linear", "linear", "log-linear", "cosine", "sigmoid"])
def test_constants_equal(schedule):
    jc = jg.DiffusionConstants.create(schedule, 50)
    tc = tg.DiffusionConstants.create(schedule, 50)
    for field in jc.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(tc, field), np.asarray(getattr(jc, field)), err_msg=field)


def test_q_sample(grids):
    jd, td = _pair()
    x = _x_bcs(grids[1].shape)
    noise = _x_bcs(grids[1].shape, seed=1)
    t = np.array([0, 13], np.int32)
    want = np.asarray(jd.q_sample(x, jnp.asarray(t), noise))
    got = td.q_sample(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize(
    "kw",
    [
        dict(),
        dict(noise_bcs=False, clip_denoised=True),
        dict(parameterization="v", learned_variances=True),
    ],
)
def test_model_predictions(grids, kw):
    jgm, tgm = grids
    jd, td = _pair(**kw)
    x = _x_bcs(tgm.shape)
    t = np.array([4, 19], np.int32)
    if kw.get("learned_variances"):
        j_fn = lambda x_, t_: jnp.concatenate([j_eps(x_, t_), jnp.sin(x_)], axis=-1)  # noqa: E731
        t_fn = lambda x_, t_: torch.cat([t_eps(x_, t_), torch.sin(x_)], dim=-1)  # noqa: E731
    else:
        j_fn, t_fn = j_eps, t_eps
    want = jd.model_predictions(j_fn, jnp.asarray(x), jnp.asarray(t), jgm)
    got = td.model_predictions(t_fn, torch.from_numpy(x), torch.from_numpy(t).long(), tgm)
    for field in want._fields:
        np.testing.assert_allclose(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)), **F32_TOL, err_msg=field
        )


def test_model_predictions_clip_bounds(grids):
    jgm, tgm = grids
    lo, hi = np.array([-0.5, -1, -1, -2], np.float32), np.array([0.5, 1, 1, 0.1], np.float32)
    jd = jg.GaussianDiffusion.create(timesteps=T, clip_denoised=True)
    jd = jg.dataclasses.replace(jd, clip_bounds=(lo, hi))
    td = tg.GaussianDiffusion.create(timesteps=T, clip_denoised=True, clip_bounds=(lo, hi))
    x = _x_bcs(tgm.shape)
    t = np.array([9, 2], np.int32)
    want = jd.model_predictions(j_eps, jnp.asarray(x), jnp.asarray(t), jgm).x_start
    got = td.model_predictions(t_eps, torch.from_numpy(x), torch.from_numpy(t).long(), tgm).x_start
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("eta", [0.0, 1.0])
@pytest.mark.parametrize("noise_bcs", [True, False])
def test_ddim_sample_loop(grids, eta, noise_bcs):
    jgm, tgm = grids
    jd, td = _pair(noise_bcs=noise_bcs)
    x_bcs = _x_bcs(tgm.shape)
    rng = jax.random.PRNGKey(7)
    steps = 6
    want = np.asarray(jd.ddim_sample_loop(j_eps, jnp.asarray(x_bcs), jgm, rng, num_steps=steps, eta=eta))
    noise = Replay(jax_normals(rng, x_bcs.shape, steps, noise_bcs))
    got = td.ddim_sample_loop(t_eps, torch.from_numpy(x_bcs), tgm, noise, num_steps=steps, eta=eta)
    assert not noise.draws  # every replayed draw consumed, in order
    np.testing.assert_allclose(got.numpy(), want, **SAMPLER_TOL)


@pytest.mark.parametrize("noise_bcs", [True, False])
@pytest.mark.parametrize("start_from", [None, 5])
def test_p_sample_loop(grids, noise_bcs, start_from):
    jgm, tgm = grids
    jd, td = _pair(noise_bcs=noise_bcs)
    x_bcs = _x_bcs(tgm.shape)
    rng = jax.random.PRNGKey(3)
    want = np.asarray(jd.p_sample_loop(j_eps, jnp.asarray(x_bcs), jgm, rng, start_from=start_from))
    n_steps = T if start_from is None else start_from
    noise = Replay(jax_normals(rng, x_bcs.shape, n_steps, noise_bcs))
    got = td.p_sample_loop(t_eps, torch.from_numpy(x_bcs), tgm, noise, start_from=start_from)
    assert not noise.draws
    np.testing.assert_allclose(got.numpy(), want, **SAMPLER_TOL)
    # The exact boundary values are imposed on the final sample.
    outside = ~tgm.inside_mask.numpy()
    np.testing.assert_array_equal(got.numpy()[:, outside], x_bcs[:, outside])


def test_generator_noise_is_seeded():
    a = tg.GeneratorNoise(torch.Generator().manual_seed(5), "cpu")((2, 3))
    b = tg.GeneratorNoise(torch.Generator().manual_seed(5), "cpu")((2, 3))
    assert torch.equal(a, b) and a.dtype == torch.float32
