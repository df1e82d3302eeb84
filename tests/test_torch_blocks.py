"""The port's model building blocks against flax, with converted weights."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from generative_turbulence_tpu.models import blocks as jb
from generative_turbulence_tpu.models import embeddings as je
from generative_turbulence_tpu.models.conditioning import Conditioning as JConditioning
from generative_turbulence_tpu.models.unet import GeometryEmbedding as JGeometryEmbedding
from generative_turbulence_tpu.ops import attention as jattn
from generative_turbulence_tpu.ops.interp import resize_trilinear as j_resize
from generative_turbulence_tpu_torch.models import blocks as tb
from generative_turbulence_tpu_torch.models import embeddings as te
from generative_turbulence_tpu_torch.models.conditioning import Conditioning
from generative_turbulence_tpu_torch.models.unet import GeometryEmbedding
from generative_turbulence_tpu_torch.ops import attention as tattn
from generative_turbulence_tpu_torch.ops.interp import downsample_size, resize_trilinear
from generative_turbulence_tpu_torch.toolchain.from_flax import torch_state_dict_from_flax

F32_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_pallas_kernels.py:29
BF16_TOL = dict(rtol=0.06, atol=0.03)  # tests/test_pallas_kernels.py:132


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _init(jmodule, *args, seed=0):
    """flax params with every 1-D leaf (biases, norm scales) perturbed, so
    that a dropped bias or a swapped scale shows."""
    rng = np.random.default_rng(seed + 100)
    params = jmodule.init(jax.random.PRNGKey(seed), *args)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (_normal(rng, *a.shape, scale=0.1) if a.ndim == 1 else 0), params
    )


def _load(tmodule, params):
    tmodule.load_state_dict(torch_state_dict_from_flax(params))
    return tmodule


def _run(tmodule, *args):
    with torch.no_grad():
        out = tmodule(*(torch.from_numpy(np.asarray(a)) if a is not None else None for a in args))
    return out.float().numpy()


@pytest.mark.parametrize("dilation", [1, 2])
def test_conv3d(dilation):
    rng = np.random.default_rng(0)
    x = _normal(rng, 2, 6, 5, 7, 3)
    jm = jb.Conv3d(4, 3, dilation=dilation)
    p = _init(jm, x)
    want = np.asarray(jm.apply(p, x))
    got = _run(_load(tb.Conv3d(3, 4, 3, dilation=dilation), p), x)
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("norm_type", ["group", "layer", "instance"])
@pytest.mark.parametrize("film", [True, False])
def test_conv_block(norm_type, film):
    rng = np.random.default_rng(1)
    x = _normal(rng, 2, 6, 5, 4, 8)
    ss = (_normal(rng, 2, 16, scale=0.3), _normal(rng, 2, 16, scale=0.3)) if film else None
    jm = jb.ConvBlock(16, fnn.silu, norm_type)
    p = _init(jm, x, ss)
    want = np.asarray(jm.apply(p, x, ss))
    tm = _load(tb.ConvBlock(8, 16, F.silu, norm_type), p)
    with torch.no_grad():
        tss = tuple(torch.from_numpy(s) for s in ss) if film else None
        got = tm(torch.from_numpy(x), tss).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("c_in", [8, 16])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_resnet_block(c_in, dtype):
    rng = np.random.default_rng(2)
    x = _normal(rng, 2, 6, 5, 4, c_in)
    c = _normal(rng, 2, 12)
    jdt, tdt = (None, None) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jm = jb.ResnetBlock(16, fnn.silu, "group", jdt)
    p = _init(jm, x, c)
    want = np.asarray(jm.apply(p, x, c)).astype(np.float32)
    got = _run(_load(tb.ResnetBlock(c_in, 16, 12, F.silu, "group", tdt), p), x, c)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        np.testing.assert_allclose(got, want, **BF16_TOL)
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999


@pytest.mark.parametrize("kind", ["full", "linear", "local"])
def test_voxel_attention(kind):
    rng = np.random.default_rng(3)
    x = _normal(rng, 2, 6, 5, 7, 16)  # not a window multiple: exercises the pad
    jm = jb.VoxelAttention(heads=2, dim_head=8, kind=kind, window_size=4)
    p = _init(jm, x)
    want = np.asarray(jm.apply(p, x))
    got = _run(_load(tb.VoxelAttention(16, heads=2, dim_head=8, kind=kind, window_size=4), p), x)
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_attention_primitives():
    rng = np.random.default_rng(4)
    q, k, v = (_normal(rng, 2, 3, 40, 8) for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    np.testing.assert_allclose(
        tattn.multihead_attention(tq, tk, tv).numpy(), np.asarray(jattn._xla_attention(q, k, v)), **F32_TOL
    )
    np.testing.assert_allclose(
        tattn.efficient_linear_attention(tq, tk, tv).numpy(),
        np.asarray(jattn.efficient_linear_attention(q, k, v)), **F32_TOL,
    )


@pytest.mark.parametrize("size", [(5, 3, 4), (13, 7, 9), (20, 11, 16), (6, 7, 5)])
def test_resize_trilinear(size):
    # the measurement behind ROADMAP's F.interpolate choice, at (2,13,7,9,5)
    x = _normal(np.random.default_rng(5), 2, 13, 7, 9, 5)
    got = resize_trilinear(torch.from_numpy(x), size).numpy()
    np.testing.assert_allclose(got, np.asarray(j_resize(jnp.asarray(x), size)), rtol=2e-4, atol=2.5e-6)


def test_downsample_size():
    assert downsample_size((194, 50, 50)) == (97, 25, 25)
    assert downsample_size((24, 6, 6)) == (12, 3, 3)
    assert downsample_size((12, 3, 3)) == (6, 3, 3)


@pytest.mark.parametrize("kind", ["nyquist", "sinusoidal"])
def test_time_embeddings(kind):
    t = np.array([0, 1, 17, 250, 499], np.float32)
    if kind == "nyquist":
        jm, tm = je.NyquistFrequencyEmbedding(32, 500), te.NyquistFrequencyEmbedding(32, 500)
    else:
        jm, tm = je.SinusoidalTimeEmbedding(32), te.SinusoidalTimeEmbedding(32)
    want = np.asarray(jm.apply({}, jnp.asarray(t)))
    assert dict(tm.state_dict()) == {}  # no parameters, buffers not in the state_dict
    np.testing.assert_allclose(_run(tm, t), want, rtol=2e-4, atol=1e-4)  # sin of args up to ~5e2


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(),
        dict(cell_type_embedding="onehot"),
        dict(cell_type_embedding_dim=3, cell_pos_features=True),
    ],
)
def test_conditioning(kwargs):
    cell_types = np.random.default_rng(6).integers(0, 6, size=(7, 5, 4)).astype(np.int32)
    jm = JConditioning(**kwargs)
    p = jm.init(jax.random.PRNGKey(0), cell_types)
    want = np.asarray(jm.apply(p, cell_types))
    tm = Conditioning(**kwargs)
    if p:
        _load(tm, p)
    assert tm.out_dim == jm.out_dim
    np.testing.assert_allclose(_run(tm, cell_types.astype(np.int64)), want, **F32_TOL)


def test_geometry_embedding():
    c_local = _normal(np.random.default_rng(7), 52, 45, 45, 4)
    jm = JGeometryEmbedding(8, fnn.silu)
    p = _init(jm, c_local)
    want = np.asarray(jm.apply(p, c_local))
    got = _run(_load(GeometryEmbedding(4, 8, F.silu), p), c_local)
    assert got.shape == (1, 8)
    np.testing.assert_allclose(got, want, **F32_TOL)
