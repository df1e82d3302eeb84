"""Full DenoisingModel forward: the port with converted weights against flax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_turbulence_tpu.models import Conditioning as JConditioning
from generative_turbulence_tpu.models import DenoisingModel as JDenoisingModel
from generative_turbulence_tpu_torch.models.conditioning import Conditioning
from generative_turbulence_tpu_torch.models.unet import DenoisingModel
from generative_turbulence_tpu_torch.toolchain.from_flax import torch_state_dict_from_flax

GRID = (14, 8, 8)
CONFIG = dict(out_features=4, timesteps=20, dim=8, u_net_levels=2)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, *GRID, 4)).astype(np.float32)
    t = np.array([3, 17], np.int32)
    cell_types = rng.integers(0, 6, size=GRID).astype(np.int32)
    return x, t, cell_types


def _flax_params(kind, seed=0):
    """Initialized flax params with biases and norm parameters perturbed."""
    rng = np.random.default_rng(seed + 100)
    x, t, ct = _inputs()
    jm = JDenoisingModel(**CONFIG, attention_kind=kind, conditioning=JConditioning())
    params = jm.init(jax.random.PRNGKey(seed), x, t, ct)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.1 * rng.normal(size=a.shape).astype(np.float32) if a.ndim == 1 else 0),
        params,
    )


def _both(kind, jdtype, tdtype):
    x, t, ct = _inputs()
    params = _flax_params(kind)
    jm = JDenoisingModel(**CONFIG, attention_kind=kind, conditioning=JConditioning(), dtype=jdtype)
    want = np.asarray(jm.apply(params, x, t, ct))
    tm = DenoisingModel(**CONFIG, attention_kind=kind, conditioning=Conditioning(), dtype=tdtype)
    tm.load_state_dict(torch_state_dict_from_flax(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(ct).long())
    assert got.dtype == torch.float32  # decode_out always runs in f32
    return got.numpy(), want


@pytest.mark.parametrize("kind", ["full", "linear", "local"])
def test_forward_f32(kind):
    got, want = _both(kind, None, None)
    assert got.shape == (2, *GRID, 4)
    # measured max abs error 1.8e-5 at max |out| 6.4 (full attention)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("kind", ["full", "local"])
def test_forward_bf16(kind):
    got, want = _both(kind, jnp.bfloat16, torch.bfloat16)
    # The bf16 tolerance applies to outputs in units of their scale: the JAX
    # model's own bf16 output differs from its f32 output by up to 0.094 at
    # max |out| 6.6 (measured), more than atol 0.03 in absolute terms, and the
    # port's bf16 output differs from the JAX bf16 one by about as much (0.13).
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=0.06, atol=0.03)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999


def test_state_dict_covers_every_flax_parameter():
    params = _flax_params("full")
    n_flax = len(jax.tree_util.tree_leaves(params))
    tm = DenoisingModel(**CONFIG, conditioning=Conditioning())
    state = torch_state_dict_from_flax(params)
    assert len(state) == n_flax == len(tm.state_dict())
    for name, value in tm.state_dict().items():
        assert state[name].shape == value.shape, name


def test_requires_cell_types_with_conditioning():
    x, t, _ = _inputs()
    tm = DenoisingModel(**CONFIG, conditioning=Conditioning())
    with pytest.raises(ValueError, match="cell_types"):
        tm(torch.from_numpy(x), torch.from_numpy(t).long())
