"""The port's fused ResnetBlock chain (ops/cuda_kernels.py) against the JAX
package: the plain chain against ``_reference_double_conv`` in f32, and the
plain chain and the kernel decomposition (each kernel's plain version plus
the GroupNorm fold) against the Pallas ``fused_double_conv_block`` in
interpret mode at bf16 tolerance.  The kernels themselves run only on the
card: ``tests/test_torch_gpu.py`` (marker ``gpu``)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from generative_turbulence_tpu.ops import pallas_kernels as jk
from generative_turbulence_tpu_torch.models import blocks as tblocks
from generative_turbulence_tpu_torch.ops import cuda_kernels as ck
from generative_turbulence_tpu_torch.ops.interp import downsample_size

F32_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_pallas_kernels.py:29
BF16_TOL = dict(rtol=0.06, atol=0.03)  # tests/test_pallas_kernels.py:132


def _make_args(B=2, X=8, Y=6, Z=6, C=12, F=16, film=True, seed=0):
    """The inputs of tests/test_pallas_kernels.py::TestFusedDoubleConvBlock."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, X, Y, Z, C)).astype(np.float32)
    w1 = rng.normal(size=(3, 3, 3, C, F)).astype(np.float32) * 0.2
    b1 = rng.normal(size=(F,)).astype(np.float32) * 0.1
    g1 = 1.0 + 0.1 * rng.normal(size=(F,)).astype(np.float32)
    be1 = 0.1 * rng.normal(size=(F,)).astype(np.float32)
    w2 = rng.normal(size=(3, 3, 3, F, F)).astype(np.float32) * 0.2
    b2 = rng.normal(size=(F,)).astype(np.float32) * 0.1
    g2 = 1.0 + 0.1 * rng.normal(size=(F,)).astype(np.float32)
    be2 = 0.1 * rng.normal(size=(F,)).astype(np.float32)
    if film:
        scale = 0.2 * rng.normal(size=(B, F)).astype(np.float32)
        shift = 0.2 * rng.normal(size=(B, F)).astype(np.float32)
    else:
        scale = shift = None
    return (x, w1, b1, g1, be1, scale, shift, w2, b2, g2, be2)


def _torch(args):
    return [torch.from_numpy(a) if a is not None else None for a in args]


def _assert_bf16_close(got, want):
    np.testing.assert_allclose(got, want, **BF16_TOL)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999


@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("num_groups", [1, 8])
def test_reference_matches_jax_reference_f32(film, num_groups):
    args = _make_args(film=film)
    want = np.asarray(jk._reference_double_conv(*args, num_groups=num_groups, eps=1e-5))
    got = ck.reference_double_conv(*_torch(args), num_groups=num_groups, eps=1e-5)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_reference_matches_jax_reference_odd_z():
    args = _make_args(B=1, X=5, Y=7, Z=9, C=8, F=8, film=True, seed=3)
    want = np.asarray(jk._reference_double_conv(*args, num_groups=8, eps=1e-5))
    got = ck.reference_double_conv(*_torch(args), num_groups=8, eps=1e-5)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


@pytest.mark.parametrize(
    "shape,film,num_groups",
    [((2, 8, 6, 6, 12, 16), True, 8), ((1, 5, 7, 9, 8, 8), False, 1)],
)
def test_chain_matches_pallas_fused_block(shape, film, num_groups):
    """Pallas interpret mode on the CPU (about 4 s a call)."""
    B, X, Y, Z, C, Fo = shape
    args = _make_args(B=B, X=X, Y=Y, Z=Z, C=C, F=Fo, film=film, seed=3)
    want = np.asarray(jk.fused_double_conv_block(*args, num_groups, 1e-5))
    targs = _torch(args)
    reference = ck.reference_double_conv(*targs, num_groups=num_groups, eps=1e-5)
    _assert_bf16_close(reference.numpy(), want)
    # The kernel decomposition, each step by its plain version on the CPU.
    chain = ck.kernel_chain(*targs, num_groups=num_groups, eps=1e-5)
    _assert_bf16_close(chain.numpy(), want)


@pytest.mark.parametrize("film", [True, False])
def test_gn_affine_matches_jax(film):
    rng = np.random.default_rng(1)
    B, n_planes, Fo, G, count = 2, 5, 16, 8, 5 * 4 * 3
    s = rng.normal(size=(B, n_planes, Fo)).astype(np.float32)
    ss = (s**2 + rng.uniform(0.5, 2.0, size=s.shape)).astype(np.float32)
    stats = np.zeros((B, n_planes, 8, Fo), np.float32)
    stats[:, :, 0], stats[:, :, 1] = s, ss
    gamma = (1 + 0.1 * rng.normal(size=Fo)).astype(np.float32)
    beta = (0.1 * rng.normal(size=Fo)).astype(np.float32)
    scale = (0.2 * rng.normal(size=(B, Fo))).astype(np.float32) if film else None
    shift = (0.2 * rng.normal(size=(B, Fo))).astype(np.float32) if film else None
    wa, wb = jk._gn_affine(stats, gamma, beta, scale, shift, count=count, num_groups=G, eps=1e-5)
    sums = torch.from_numpy(np.stack([s.sum(1), ss.sum(1)], axis=1))
    ga, gb = ck._gn_affine(
        sums, *_torch((gamma, beta, scale, shift)), count=count, num_groups=G, eps=1e-5
    )
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), **F32_TOL)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), **F32_TOL)


def test_plain_conv_moments_are_sums_of_its_output():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2, 4, 5, 6, 8)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.normal(size=(3, 3, 3, 8, 8)).astype(np.float32) * 0.1).bfloat16()
    b = torch.from_numpy(rng.normal(size=8).astype(np.float32))
    y, sums = ck.conv3x3x3_stats(x, w, b)
    assert y.dtype == torch.bfloat16 and y.shape == (2, 4, 5, 6, 8)
    yf = y.float()
    np.testing.assert_allclose(sums[:, 0].numpy(), yf.sum((1, 2, 3)).numpy(), rtol=1e-2, atol=0.2)
    np.testing.assert_allclose(sums[:, 1].numpy(), (yf * yf).sum((1, 2, 3)).numpy(), rtol=1e-2, atol=0.2)


@pytest.mark.parametrize("C,Fo", [(12, 20), (32, 32), (64, 128), (128, 64), (160, 160)])
def test_pack_conv_weights_round_trips(C, Fo):
    """The packed B ring images hold every weight once, where the kernel's
    descriptors read it, and zeros beyond C and F."""
    rng = np.random.default_rng(C + Fo)
    w = torch.from_numpy(rng.normal(size=(3, 3, 3, C, Fo)).astype(np.float32)).bfloat16()
    bn, kc = ck.conv_tiling(C, Fo)
    wp = ck.pack_conv_weights(w, bn, kc)
    n_ft, n_ch = -(-Fo // bn), -(-C // kc)
    assert wp.dtype == torch.bfloat16 and wp.is_contiguous()
    assert wp.shape == (n_ft, n_ch, 27, kc // 16, bn // 8, 2, 8, 8)
    # Inverse permutation back to (tap, C padded, F padded).
    back = wp.permute(2, 1, 3, 5, 7, 0, 4, 6).reshape(27, n_ch * kc, n_ft * bn)
    assert torch.equal(back[:, :C, :Fo], w.reshape(27, C, Fo))
    assert not back[:, C:].any() and not back[:, :, Fo:].any()
    # A few elements by the documented index formula.
    for t, c, tap, k, j, h, r, e in rng.integers(0, [n_ft, n_ch, 27, kc // 16, bn // 8, 2, 8, 8], (32, 8)):
        ci, fi = c * kc + 16 * k + 8 * h + e, t * bn + 8 * j + r
        want = w[tap // 9, tap // 3 % 3, tap % 3, ci, fi] if ci < C and fi < Fo else 0.0
        assert float(wp[t, c, tap, k, j, h, r, e]) == float(want)


def test_conv_tiling_covers_the_engaged_widths():
    assert [ck.conv_tiling(c, f) for c, f in [(64, 64), (64, 128), (128, 32), (32, 32), (12, 20)]] == [
        (64, 64), (128, 64), (32, 64), (32, 32), (32, 32)
    ]
    # One y line of 8 x 8 output voxels per warpgroup: four up to 64 channels, two at 128.
    assert [ck.conv_brick(bn) for bn in (32, 64, 128)] == [(8, 4, 8), (8, 4, 8), (8, 2, 8)]


@pytest.mark.parametrize("brick", [(8, 4, 8), (8, 2, 8), (1, 1, 1), (3, 5, 2), (16, 16, 16)])
@pytest.mark.parametrize("shape", [(5, 6, 50), (7, 5, 9), (4, 4, 8)])
def test_brick_partials_sum_to_whole_grid_moments(brick, shape):
    """For any brick split, the per-brick moments sum to the moments over the
    whole grid, one row per ``conv_n_bricks`` brick, and each row is the
    moments of its own brick (z fastest)."""
    rng = np.random.default_rng(sum(shape))
    B, Fo = 2, 12
    y = torch.from_numpy(rng.normal(size=(B, *shape, Fo)).astype(np.float32))
    part = ck._brick_partials(y, brick)
    assert part.shape == (B, ck.conv_n_bricks(*shape, brick), 2, Fo)
    whole = torch.stack([y.sum((1, 2, 3)), (y * y).sum((1, 2, 3))], dim=1)
    np.testing.assert_allclose(part.sum(1).numpy(), whole.numpy(), rtol=1e-5, atol=1e-4)
    nz = -(-shape[2] // brick[2])
    ny = -(-shape[1] // brick[1])
    last = part.shape[1] - 1
    bx, by, bz = last // (ny * nz), last // nz % ny, last % nz
    tail = y[:, bx * brick[0]:, by * brick[1]:, bz * brick[2]:]
    np.testing.assert_allclose(part[:, last, 0].numpy(), tail.sum((1, 2, 3)).numpy(), rtol=1e-5, atol=1e-5)


def test_conv_stats_plain_moments_come_from_its_partials():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 5, 6, 9, 12)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.normal(size=(3, 3, 3, 12, 20)).astype(np.float32) * 0.1).bfloat16()
    b = torch.from_numpy(rng.normal(size=20).astype(np.float32))
    act = (torch.from_numpy(1 + 0.2 * rng.normal(size=(2, 12)).astype(np.float32)),
           torch.from_numpy(0.2 * rng.normal(size=(2, 12)).astype(np.float32)))
    y, part = ck._conv3x3x3_stats_plain(x, w, b, act)
    assert part.shape == (2, ck.conv_n_bricks(5, 6, 9, ck.conv_brick(32)), 2, 20)
    _, sums = ck.conv3x3x3_stats(x, w, b, act)
    assert torch.equal(sums, part.sum(1))


def test_cpu_path_launches_no_kernel():
    ck.reset_launch_counts()
    args = _torch(_make_args(B=1, X=4, Y=4, Z=4, C=8, F=8))
    ck.fused_double_conv_block(*args, 8, 1e-5)
    ck.kernel_chain(*args, num_groups=8, eps=1e-5)
    assert all(v == 0 for v in ck.LAUNCH_COUNTS.values())


def test_resnet_block_routes_through_fused_chain(monkeypatch):
    """Force the gate open: the block calls fused_double_conv_block once and
    matches its unfused path (on the CPU the chain is the plain f32 chain)."""
    torch.manual_seed(0)
    block = tblocks.ResnetBlock(12, 16, 8, F.silu, "group", None)
    x = torch.randn(2, 8, 6, 6, 12)
    c = torch.randn(2, 8)
    with torch.no_grad():
        want = block(x, c)
        calls = []
        real = ck.fused_double_conv_block

        def spy(*args, **kwargs):
            calls.append(args[0].shape)
            return real(*args, **kwargs)

        monkeypatch.setattr(ck, "fused_block_applicable", lambda *a, **k: True)
        monkeypatch.setattr(ck, "fused_double_conv_block", spy)
        got = block(x, c)
    assert calls == [x.shape]
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)


def test_gate_engages_the_four_shapes_grid_blocks():
    """At the shapes grid (194x50x50, dim 32, 4 levels, conditioning) exactly
    down_0, down_1, up_0 and decode_resnet take the fused chain; worked out
    from the module widths and the U-Net's level sizes alone."""
    from generative_turbulence_tpu_torch.models.conditioning import Conditioning
    from generative_turbulence_tpu_torch.models.unet import DenoisingModel

    with torch.device("meta"):
        model = DenoisingModel(
            out_features=4, timesteps=500, dim=32, u_net_levels=4,
            conditioning=Conditioning(cell_type_embedding_dim=4),
        )
    sizes = [(194, 50, 50)]
    for _ in range(4):
        sizes.append(downsample_size(sizes[-1]))
    engaged = {}
    for name, module in model.named_modules():
        if not isinstance(module, tblocks.ResnetBlock):
            continue
        leaf = name.rsplit(".", 1)[-1]
        level = int(leaf.split("_")[1]) if leaf[:3] in ("dow", "up_") else (
            4 if leaf.startswith("center") else 0
        )
        c_in = module.block1.conv.weight.shape[1]
        x = torch.empty((8, *sizes[level], c_in), device="meta")
        if ck.fused_block_applicable(x, c_in, module.features):
            engaged[name] = (sizes[level], c_in, module.features)
    assert engaged == {
        "u_net.down_0": ((194, 50, 50), 64, 64),
        "u_net.down_1": ((97, 25, 25), 64, 128),
        "u_net.up_0": ((194, 50, 50), 128, 32),
        "decode_resnet": ((194, 50, 50), 32, 32),
    }
