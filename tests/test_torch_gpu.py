"""The Hopper kernels on the card, each against its plain torch version,
with the launch counts (marker ``gpu``; every test skips without CUDA).

This file imports neither JAX nor the JAX package, since the card's machine
has neither; run it there without the JAX-pinning conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from generative_turbulence_tpu_torch.ops import cuda_kernels as ck

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


def _assert_bf16_close(got, want, scaled=False):
    """The bf16 tolerance and correlation > 0.999.  ``scaled`` holds the
    result to the output's scale: atol relative to max |want| and a relative
    L2 error within 1e-2 (attention over thousands of keys gives outputs far
    below the plain atol, where a wrong scale would pass)."""
    tol = dict(BF16_TOL, atol=BF16_TOL["atol"] * np.abs(want).max()) if scaled else BF16_TOL
    np.testing.assert_allclose(got, want, **tol)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999
    if scaled:
        assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "B,X,Y,Z,C,Fo,film,G",
    [(2, 13, 11, 9, 12, 20, False, 1), (2, 40, 12, 12, 64, 128, True, 8)],
)
def test_kernels_match_plain_on_gpu(B, X, Y, Z, C, Fo, film, G):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU")
    args = _make_args(B=B, X=X, Y=Y, Z=Z, C=C, F=Fo, film=film)
    targs = [a.cuda() if a is not None else None for a in _torch(args)]
    targs[0] = targs[0].bfloat16()
    before = dict(ck.LAUNCH_COUNTS)
    got = ck.fused_double_conv_block(*targs, G, 1e-5)
    want = ck.reference_double_conv(*targs, num_groups=G, eps=1e-5)
    torch.cuda.synchronize()
    assert {k: ck.LAUNCH_COUNTS[k] - before[k] for k in before} == {
        "conv3x3x3_stats": 1, "conv3x3x3_stats_silu_in": 1, "affine_silu": 1,
        "conv3x3x3_stats_halo": 0, "conv3x3x3_stats_silu_in_halo": 0, "conv3d_3x3": 0, "flash_attention": 0,
    }
    _assert_bf16_close(got.float().cpu().numpy(), want.float().cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize(
    "B,H,N,D,dtype,strided",
    [
        (2, 2, 300, 32, torch.float32, False),
        (2, 2, 2100, 16, torch.float32, False),
        (2, 4, 2100, 32, torch.bfloat16, False),
        (1, 3, 700, 24, torch.bfloat16, False),
        (2, 4, 2048, 32, torch.bfloat16, True),
        (2, 4, 2048, 32, torch.float32, True),
    ],
)
def test_flash_attention_matches_plain_on_gpu(B, H, N, D, dtype, strided):
    """The kernel against its plain version (TF32 off): f32 at the f32
    tolerance, bf16 at the bf16 one; ``strided`` passes the U-Net's
    ``qkv[:, :, i].transpose(1, 2)`` views.  One launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(N + D)
    if strided:
        qkv = torch.randn(B, N, 3, H, D, generator=gen).to("cuda", dtype)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    else:
        q, k, v = (torch.randn(B, H, N, D, generator=gen).to("cuda", dtype) for _ in range(3))
    before = ck.LAUNCH_COUNTS["flash_attention"]
    got = ck.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert ck.LAUNCH_COUNTS["flash_attention"] == before + 1
    want = ck._flash_attention_plain(q, k, v)
    assert got.dtype == dtype and got.shape == (B, H, N, D)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **F32_TOL)
    else:
        _assert_bf16_close(got.float().cpu().numpy(), want.float().cpu().numpy(), scaled=True)


def _flash_inputs(B, H, N, D, dtype, strided, seed):
    gen = torch.Generator().manual_seed(seed)
    if strided:  # the U-Net's qkv[:, :, i].transpose(1, 2) views
        qkv = torch.randn(B, N, 3, H, D, generator=gen).to("cuda", dtype)
        return [qkv[:, :, i].transpose(1, 2) for i in range(3)]
    return [torch.randn(B, H, N, D, generator=gen).to("cuda", dtype) for _ in range(3)]


def _assert_flash_matches_plain(q, k, v):
    """One launch, the plain version's result at the dtype's tolerance, and
    a second run bit-equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    before = ck.LAUNCH_COUNTS["flash_attention"]
    got = ck.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert ck.LAUNCH_COUNTS["flash_attention"] == before + 1
    want = ck._flash_attention_plain(q, k, v)
    assert got.dtype == q.dtype and got.shape == q.shape and got.is_contiguous()
    if q.dtype == torch.float32:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **F32_TOL)
    else:
        _assert_bf16_close(got.float().cpu().numpy(), want.float().cpu().numpy(), scaled=True)
    assert torch.equal(got, ck.flash_attention(q, k, v))


@pytest.mark.gpu
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("N", [1, 63, 64, 127, 128, 129, 2100, 6912])
def test_flash_attention_edges_on_gpu(N, D, dtype, strided):
    """Token counts around the key tiles (64 and 128) and the 128- and
    192-query work items, every head width the bf16 kernel rounds to (16,
    32, 64, 128) and the f32 one (32, 64, 128), contiguous and strided."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU")
    B, H = (1, 2) if N > 2048 else (2, 3)
    _assert_flash_matches_plain(*_flash_inputs(B, H, N, D, dtype, strided, seed=N * 131 + D))


@pytest.mark.gpu
@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "strided"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,N,D", [(2, 2, 2100, 16), (2, 4, 4096, 32)])
def test_flash_attention_gradients_on_gpu(B, H, N, D, dtype, strided):
    """flash_attention on the card is differentiable: its forward launches
    the kernel once (the output has a grad_fn), its backward launches none,
    and the gradients of q, k and v (or of the strided views' qkv) equal
    those of the plain version (f32 at the f32 tolerance, bf16 at the bf16
    one held to the gradient's scale)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(N + D)
    cot = torch.randn(B, H, N, D, generator=gen).to("cuda", dtype)
    base = torch.randn(B, N, 3, H, D, generator=gen).to("cuda", dtype)

    def grads(fn):
        if strided:
            leaves = [base.clone().requires_grad_()]
            q, k, v = (leaves[0][:, :, i].transpose(1, 2) for i in range(3))
        else:
            leaves = [base[:, :, i].transpose(1, 2).contiguous().requires_grad_() for i in range(3)]
            q, k, v = leaves
        out = fn(q, k, v)
        assert out.grad_fn is not None
        launched = ck.LAUNCH_COUNTS["flash_attention"]
        out.backward(cot)
        assert ck.LAUNCH_COUNTS["flash_attention"] == launched
        return [t.grad for t in leaves]

    before = ck.LAUNCH_COUNTS["flash_attention"]
    got = grads(ck.flash_attention)
    assert ck.LAUNCH_COUNTS["flash_attention"] == before + 1
    want = grads(ck._flash_attention_plain)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        if dtype == torch.float32:
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), **F32_TOL)
        else:
            _assert_bf16_close(g.float().cpu().numpy(), w.float().cpu().numpy(), scaled=True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_takes_more_than_65535_heads_on_gpu(dtype):
    """The kernels walk a 1-D list of work items, so B * H is not bound by
    a grid dimension's 65,535."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU")
    _assert_flash_matches_plain(*_flash_inputs(3, 22000, 5, 8, dtype, False, seed=9))


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Fo", [20, 32, 64, 128])
@pytest.mark.parametrize("spatial", [(3, 5, 7), (17, 33, 31)])
def test_affine_silu_matches_plain_on_gpu(spatial, Fo, out_dtype):
    """affine_silu against its plain version: F = 20 takes the scalar path;
    3 x 5 x 7 = 105 voxels is odd, and 17 x 33 x 31 x F elements are no
    multiple of a block's 4 x 256 x 8; a second run is bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU")
    gen = torch.Generator().manual_seed(Fo)
    B = 3
    h = torch.randn(B, *spatial, Fo, generator=gen).to("cuda", torch.bfloat16)
    a = (1 + 0.3 * torch.randn(B, Fo, generator=gen)).cuda()
    c = (0.3 * torch.randn(B, Fo, generator=gen)).cuda()
    before = ck.LAUNCH_COUNTS["affine_silu"]
    got = ck.affine_silu(h, a, c, out_dtype)
    torch.cuda.synchronize()
    assert ck.LAUNCH_COUNTS["affine_silu"] == before + 1
    want = ck._affine_silu_plain(h, a, c, out_dtype)
    assert got.dtype == out_dtype and got.shape == h.shape
    if out_dtype == torch.float32:
        # expf on the card against torch's silu: a few ulp.
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-6)
    else:
        _assert_bf16_close(got.float().cpu().numpy(), want.float().cpu().numpy())
    assert torch.equal(got, ck.affine_silu(h, a, c, out_dtype))


@pytest.mark.gpu
def test_affine_silu_launches_nothing_on_an_empty_tensor():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU")
    h = torch.empty(2, 0, 5, 5, 32, device="cuda", dtype=torch.bfloat16)
    a = torch.ones(2, 32, device="cuda")
    before = ck.LAUNCH_COUNTS["affine_silu"]
    out = ck.affine_silu(h, a, a, torch.float32)
    assert out.shape == h.shape and out.dtype == torch.float32
    assert ck.LAUNCH_COUNTS["affine_silu"] == before


@pytest.mark.gpu
def test_flash_attention_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU")
    q = torch.zeros(1, 1, 64, 12, device="cuda")
    with pytest.raises(ValueError, match="multiple of 8"):
        ck.flash_attention(q, q, q)
    q = torch.zeros(1, 1, 64, 16, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        ck.flash_attention(q, q, q)
    q = torch.zeros(1, 1, 16, 64, device="cuda").transpose(-1, -2)
    with pytest.raises(ValueError, match="unit stride"):
        ck.flash_attention(q, q, q)


def _moment_errors(sums, want_sums, n):
    """Max |mean err| / std and |var err| / var of per-channel moments."""
    mean, want_mean = sums[:, 0] / n, want_sums[:, 0] / n
    var = sums[:, 1] / n - mean**2
    want_var = want_sums[:, 1] / n - want_mean**2
    err_mean = float(((mean - want_mean).abs() / want_var.sqrt()).max())
    err_var = float(((var - want_var).abs() / want_var).max())
    return err_mean, err_var


# (X, Y, Z, C, F): bricks of 8x4x8 or 8x2x8 overhang X, Y or Z (Z = 50, Z = 9), C not
# a multiple of 8 or 16 and above one 64-channel chunk, F not a multiple of 8
# and a full 128-channel tile.
CONV_SHAPES = [
    (5, 6, 50, 64, 64),
    (7, 5, 9, 12, 20),
    (6, 7, 9, 32, 32),
    (5, 9, 11, 128, 128),
    (9, 5, 10, 64, 128),
    (4, 4, 8, 128, 32),
    (3, 6, 13, 12, 64),
]


@pytest.mark.gpu
@pytest.mark.parametrize("silu_in", [False, True])
@pytest.mark.parametrize("X,Y,Z,C,Fo", CONV_SHAPES)
def test_conv_stats_kernel_matches_plain_on_gpu(X, Y, Z, C, Fo, silu_in):
    """The conv kernel with moments (STATS), with and without the silu
    prologue, against ``_conv3x3x3_stats_plain``: output at the bf16
    tolerance, per-brick partials of the same shape, channel moments within
    1e-3, a second run bit-equal, one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU")
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(X * 1000 + C + Fo)
    B = 2
    x = torch.randn(B, X, Y, Z, C, generator=gen).to("cuda", torch.bfloat16)
    w = (torch.randn(3, 3, 3, C, Fo, generator=gen) * (27 * C) ** -0.5).to("cuda", torch.bfloat16)
    bias = (0.5 + 0.1 * torch.randn(Fo, generator=gen)).cuda()
    act = None
    if silu_in:
        act = ((1 + 0.2 * torch.randn(B, C, generator=gen)).cuda(),
               (0.2 * torch.randn(B, C, generator=gen)).cuda())
    name = "conv3x3x3_stats_silu_in" if silu_in else "conv3x3x3_stats"
    before = ck.LAUNCH_COUNTS[name]
    got, partial = ck._conv3x3x3_stats_kernel(x, w, bias, act)
    torch.cuda.synchronize()
    assert ck.LAUNCH_COUNTS[name] == before + 1
    want, want_partial = ck._conv3x3x3_stats_plain(x, w, bias, act)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    n_bricks = ck.conv_n_bricks(X, Y, Z, ck.conv_brick(ck.conv_tiling(C, Fo)[0]))
    assert partial.shape == want_partial.shape == (B, n_bricks, 2, Fo)
    _assert_bf16_close(got.float().cpu().numpy(), want.float().cpu().numpy())
    err_mean, err_var = _moment_errors(partial.sum(1), want_partial.sum(1), X * Y * Z)
    assert max(err_mean, err_var) < 1e-3, (err_mean, err_var)
    again, again_partial = ck._conv3x3x3_stats_kernel(x, w, bias, act)
    assert torch.equal(got, again) and torch.equal(partial, again_partial)


@pytest.mark.gpu
@pytest.mark.parametrize("sides", ["lo", "hi", "both"])
@pytest.mark.parametrize("silu_in", [False, True])
@pytest.mark.parametrize("X,Y,Z,C,Fo", [(13, 6, 9, 32, 32), (9, 5, 10, 64, 128), (10, 4, 8, 128, 32)])
def test_conv_stats_halo_kernel_matches_plain_on_gpu(X, Y, Z, C, Fo, silu_in, sides):
    """The conv's halo variant (the spatial axis: x planes before and after
    an x slab, a null pointer at a global edge) against its plain twin:
    output at the bf16 tolerance, channel moments of the slab's own planes
    within 1e-3, one launch under the ``_halo`` name.  And the two slabs of
    a whole grid, each with its neighbour's plane, give the whole grid's conv
    (no halo) bit for bit: a voxel's sum does not depend on where its brick
    starts."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU")
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(X * 1000 + C + Fo + 7)
    B = 2
    whole = torch.randn(B, X, Y, Z, C, generator=gen).to("cuda", torch.bfloat16)
    w = (torch.randn(3, 3, 3, C, Fo, generator=gen) * (27 * C) ** -0.5).to("cuda", torch.bfloat16)
    bias = (0.5 + 0.1 * torch.randn(Fo, generator=gen)).cuda()
    act = None
    if silu_in:
        act = ((1 + 0.2 * torch.randn(B, C, generator=gen)).cuda(),
               (0.2 * torch.randn(B, C, generator=gen)).cuda())
    s, e = (1, X - 1) if sides == "both" else (1, X) if sides == "lo" else (0, X - 1)
    x = whole[:, s:e].contiguous()
    halo = (whole[:, s - 1 : s].contiguous(), whole[:, e : e + 1].contiguous())
    name = ("conv3x3x3_stats_silu_in" if silu_in else "conv3x3x3_stats") + "_halo"
    before = ck.LAUNCH_COUNTS[name]
    got, partial = ck._conv3x3x3_stats_kernel(x, w, bias, act, halo)
    torch.cuda.synchronize()
    assert ck.LAUNCH_COUNTS[name] == before + 1
    want, want_partial = ck._conv3x3x3_stats_plain(x, w, bias, act, halo)
    assert got.shape == want.shape == (B, e - s, Y, Z, Fo)
    _assert_bf16_close(got.float().cpu().numpy(), want.float().cpu().numpy())
    err_mean, err_var = _moment_errors(partial.sum(1), want_partial.sum(1), (e - s) * Y * Z)
    assert max(err_mean, err_var) < 1e-3, (err_mean, err_var)
    if sides == "both":
        full, _ = ck._conv3x3x3_stats_kernel(whole, w, bias, act)
        m = X // 2
        parts = [ck._conv3x3x3_stats_kernel(whole[:, a:b].contiguous(), w, bias, act,
                                            (whole[:, a - 1 : a].contiguous(), whole[:, b : b + 1].contiguous()))[0]
                 for a, b in ((0, m), (m, X))]
        assert torch.equal(torch.cat(parts, dim=1), full)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape,cin,cout",
    [((6, 10, 13), 12, 16), ((40, 12, 12), 64, 64), ((5, 7, 50), 128, 20), ((7, 5, 9), 32, 128)],
)
def test_conv3d_3x3_matches_plain_on_gpu(shape, cin, cout, dtype):
    """conv3d_3x3 (the conv kernel without moments) against its plain
    version, output in x's type; its backward gives finite gradients."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU")
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(cin)
    x = torch.randn(2, *shape, cin, generator=gen).to("cuda", dtype)
    w = (0.1 * torch.randn(3, 3, 3, cin, cout, generator=gen)).cuda()
    b = torch.randn(cout, generator=gen).cuda()
    before = ck.LAUNCH_COUNTS["conv3d_3x3"]
    got = ck.conv3d_3x3(x, w, b)
    torch.cuda.synchronize()
    assert ck.LAUNCH_COUNTS["conv3d_3x3"] == before + 1
    want = ck._conv3d_3x3_plain(x, w, b)
    assert got.dtype == dtype
    if dtype == torch.float32:
        # The same bf16 products summed in f32 in another order.
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-4)
    else:
        _assert_bf16_close(got.float().cpu().numpy(), want.float().cpu().numpy())
    assert torch.equal(got, ck.conv3d_3x3(x, w, b))
    leaves = [t.float().requires_grad_() for t in (x, w, b)]
    ck.conv3d_3x3(*leaves).square().mean().backward()
    assert all(bool(torch.isfinite(t.grad).all()) and float(t.grad.abs().max()) > 0 for t in leaves)


# ---- the evaluation path on the card --------------------------------------
# The ops against the same functions on the CPU, a .npyd DataModule batch on
# the card, and DiffusionTask.eval_step + on_eval_end on the card against the
# same task on the CPU, at the small synthetic grid (24x10x10 cells).

EVAL_OVERRIDES = ["model.dim=8", "model.u_net_levels=2", "model.timesteps=20", "model.sampler=ddim",
                  "model.ddim_steps=4"]
SPECTRA_RTOL = 1e-3  # cuFFT against pocketfft, f32
SINKHORN_TOL = dict(rtol=1e-4)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA Hopper GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module")
def npyd_root(tmp_path_factory):
    from generative_turbulence_tpu_torch.data.synthetic import generate_synthetic_dataset

    root = tmp_path_factory.mktemp("npyd") / "root"
    return generate_synthetic_dataset(root, n_train_cases=1, n_val_cases=1, n_test_cases=0, n_frames=12,
                                      format="npyd")


@pytest.mark.gpu
@pytest.mark.parametrize("points_shape", [(7, 3), (4, 9, 3)])
def test_interp3_on_gpu(points_shape):
    from generative_turbulence_tpu_torch.ops.interp import interp3

    _needs_card()
    rng = np.random.default_rng(0)
    grid = torch.from_numpy(rng.normal(size=(2, 7, 6, 5)).astype(np.float32))
    points = torch.from_numpy(rng.uniform(-1.5, 8.0, size=points_shape).astype(np.float32))  # past every face too
    got = interp3(grid.cuda(), points.cuda())
    assert got.is_cuda
    np.testing.assert_allclose(got.cpu().numpy(), interp3(grid, points).numpy(), **F32_TOL)


@pytest.mark.gpu
def test_log_tke_distance_matrix_on_gpu():
    from generative_turbulence_tpu_torch.ops.spectra import SpectrumOps, log_tke_distance_matrix

    _needs_card()
    rng = np.random.default_rng(1)
    fields = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for s in ((3, 12, 10, 10, 3), (4, 12, 10, 10, 3), (12, 10, 10, 3))]
    got = log_tke_distance_matrix(*(f.cuda() for f in fields), SpectrumOps.create(512, 16, device="cuda"))
    want = log_tke_distance_matrix(*fields, SpectrumOps.create(512, 16, device="cpu"))
    assert got[0].shape == (3, 4) and got[0].is_cuda
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=SPECTRA_RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("per_matrix_reg", [False, True], ids=["scalar-reg", "per-matrix-reg"])
def test_masked_sinkhorn_emd2_on_gpu(per_matrix_reg):
    """Padded clouds of mixed sizes (9x7, 4x11, 11x11 of an 11x11 pad)."""
    from generative_turbulence_tpu_torch.ops.sinkhorn import masked_sinkhorn_emd2

    _needs_card()
    rng = np.random.default_rng(2)
    M = torch.from_numpy(np.abs(rng.normal(size=(3, 11, 11))).astype(np.float32))
    rows = torch.arange(11)[None, :] < torch.tensor([[9], [4], [11]])
    cols = torch.arange(11)[None, :] < torch.tensor([[7], [11], [11]])
    M[~(rows[:, :, None] & cols[:, None, :])] = 123.0
    reg = torch.tensor([0.05, 0.1, 0.2]) if per_matrix_reg else 0.1
    on_card = reg.cuda() if per_matrix_reg else reg
    got = masked_sinkhorn_emd2(M.cuda(), rows.cuda(), cols.cuda(), reg=on_card, n_iters=300)
    want = masked_sinkhorn_emd2(M, rows, cols, reg=reg, n_iters=300)
    assert got.is_cuda and bool((got < 10).all())  # no mass on the padding
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **SINKHORN_TOL)


@pytest.mark.gpu
def test_npyd_datamodule_batch_on_gpu(npyd_root):
    from generative_turbulence_tpu_torch.data.dataset import DataModule

    _needs_card()
    host = next(iter(DataModule(npyd_root, eval_batch_size=4, val_samples=4).setup("validate").val_batches()))
    dm = DataModule(npyd_root, eval_batch_size=4, val_samples=4, device="cuda").setup("validate")
    batch = next(iter(dm.val_batches()))  # moved to the card in the prefetch thread
    assert batch.cells.is_cuda and batch.grid.cell_idx.is_cuda and batch.grid.cell_types.is_cuda
    np.testing.assert_array_equal(batch.cells.cpu().numpy(), host.cells)
    moved = host.to("cuda")
    assert moved.cells.is_cuda and moved.to("cuda") is moved
    np.testing.assert_array_equal(moved.cells.cpu().numpy(), host.cells)


class _HostNoise:
    """Standard normals (and ``randint``'s timesteps) from a seeded CPU
    generator, handed out on ``device``: the same draws on the CPU and on
    the card."""

    def __init__(self, seed: int, device):
        self.generator, self.device = torch.Generator().manual_seed(seed), device

    def __call__(self, shape):
        return torch.randn(tuple(shape), generator=self.generator).to(self.device)

    def randint(self, n: int, high: int):
        return torch.randint(0, high, (n,), generator=self.generator).to(self.device)


@pytest.mark.gpu
def test_eval_step_and_on_eval_end_on_gpu(npyd_root, tmp_path):
    """The 2-level f32 task (dim 8, DDIM-4) on the card and on the CPU with
    the same weights and draws: ``eval_step``'s sample statistics at rtol
    1e-3, and ``on_eval_end``'s ``val/tke`` and Sinkhorn ``val/wasserstein``
    (2 regions, 300 iterations, on each task's device) at rtol 5e-3."""
    from generative_turbulence_tpu_torch.data.dataset import DataModule
    from generative_turbulence_tpu_torch.eval.metrics import WassersteinMetric
    from generative_turbulence_tpu_torch.training.config import parse_cli_overrides
    from generative_turbulence_tpu_torch.training.diffusion_task import DiffusionTask

    _needs_card()
    dm = DataModule(npyd_root, eval_batch_size=4, val_samples=4).setup("validate")
    batch = next(iter(dm.val_batches()))
    cfg = parse_cli_overrides(EVAL_OVERRIDES).resolved().model
    results = {}
    for device in ("cpu", "cuda"):
        task = DiffusionTask(cfg, dm.stats, device, data_root=npyd_root, samples_root=tmp_path / device)
        if device == "cpu":
            task.net.init_weights(torch.Generator().manual_seed(0))
            weights = task.net.state_dict()
        else:
            task.net.load_state_dict(weights)
        for metric in task.metrics["val"].metrics:
            if isinstance(metric, WassersteinMetric):
                assert metric.solver == "sinkhorn" and metric.device == torch.device(device)
                metric.max_regions, metric.sinkhorn_iters = 2, 300
        task.on_eval_start("val")
        step = task.eval_step(batch, _HostNoise(0, device), "val")
        assert task.sample_stores["val"].n_samples("case-val-00") == 4
        results[device] = (step, task.on_eval_end(dm.stats, "val", expensive=True))
    (step, values), (want_step, want_values) = results["cuda"], results["cpu"]
    assert sorted(step) == sorted(want_step) and sorted(values) == sorted(want_values)
    for name in ("val/sample-u-std", "val/sample-u-absmax"):
        np.testing.assert_allclose(step[name], want_step[name], rtol=1e-3)
    for name in ("val/tke", "val/tke-back", "val/wasserstein"):
        assert np.isfinite(values[name]) and values[name] >= 0
        np.testing.assert_allclose(values[name], want_values[name], rtol=5e-3)


# ---- the training entry point on the card ----------------------------------
# Trainer.fit through the factory on the card against the same run on the
# CPU, and the baselines' forwards on the card against the CPU's.

TRAINER_OVERRIDES = ["model.dim=8", "model.u_net_levels=1", "model.timesteps=20", "model.sampler=ddim",
                     "model.ddim_steps=2", "model.batch_size=4", "model.ema_decay=0.9",
                     "model.compute_expensive_sample_metrics=false", "data.discard_first_seconds=-1",
                     "data.val_samples=4", "data.eval_batch_size=4", "trainer.max_epochs=1",
                     "trainer.log_every_n_steps=1", "trainer.render_plots=false"]


def _logged(run_dir, key):
    import json

    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    return {r["step"]: r[key] for r in records if key in r}


@pytest.mark.gpu
def test_trainer_fit_epoch_on_gpu(npyd_root, tmp_path):
    """One epoch (3 steps) and its validation through
    ``instantiate_data_and_task`` and ``Trainer.fit`` (dim 8, 1 level, f32)
    on the card and on the CPU, from the same start and draws: the logged
    losses at rtol 1e-3, ``val/tke`` at rtol 5e-3; the card's batches,
    parameters and EMA on the card, its checkpoints written."""
    import copy

    from generative_turbulence_tpu_torch.training.config import parse_cli_overrides
    from generative_turbulence_tpu_torch.training.factory import instantiate_data_and_task
    from generative_turbulence_tpu_torch.training.loop import Trainer, key_seed

    _needs_card()
    start, runs = None, {}
    for device in ("cpu", "cuda"):
        out = tmp_path / device
        config = parse_cli_overrides(TRAINER_OVERRIDES + [f"data.root={npyd_root}", f"trainer.out_dir={out}"])
        dm, task = instantiate_data_and_task(config.resolved(), device)
        if start is None:
            start = copy.deepcopy(task.init_weights(torch.Generator().manual_seed(0)).state_dict())
        noise = lambda kind, *key, d=device: _HostNoise(key_seed(0, kind, *key), d)  # noqa: E731
        metrics = Trainer(config, task, dm, noise_factory=noise).fit(copy.deepcopy(start))
        assert task.step == dm.n_train_batches() == 3 and np.isfinite(metrics["val/tke"])
        assert {"last.pt", "best.pt"} <= {p.name for p in (out / "checkpoints").iterdir()}
        runs[device] = (out, task, metrics)
    (out, task, metrics), (want_out, _, want) = runs["cuda"], runs["cpu"]
    assert next(task.net.parameters()).is_cuda and all(e.is_cuda for e in task.ema.values())
    assert next(iter(dm.train_batches(0))).cells.is_cuda
    got, ref = _logged(out, "train/loss"), _logged(want_out, "train/loss")
    assert got.keys() == ref.keys() == {1, 2, 3}
    np.testing.assert_allclose([got[k] for k in ref], [ref[k] for k in ref], rtol=1e-3)
    np.testing.assert_allclose(metrics["val/tke"], want["val/tke"], rtol=5e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("grid", [(11, 9, 7), (12, 8, 8)], ids=["odd", "even"])
@pytest.mark.parametrize("model", ["tfnet", "dilresnet"])
def test_baseline_forward_on_gpu(model, grid):
    """TF-Net and DilResNet (f32) on the card against the same module on the
    CPU, TF-Net's BatchNorm statistics away from (0, 1): f32 tolerance."""
    from generative_turbulence_tpu_torch.models.conditioning import Conditioning
    from generative_turbulence_tpu_torch.models.dilresnet import DilResNet
    from generative_turbulence_tpu_torch.models.tfnet import TFNet

    _needs_card()
    gen = torch.Generator().manual_seed(0)

    def build():
        conditioning = Conditioning(cell_type_embedding_dim=8)
        return TFNet(4, 6, conditioning=conditioning) if model == "tfnet" else DilResNet(4, 2, 16, conditioning)

    net = build().init_weights(gen)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith((".mean", ".bias")):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
            elif name.endswith(".var"):
                p.copy_(1 + 0.2 * torch.rand(p.shape, generator=gen))
    card = build().cuda()
    card.load_state_dict(net.state_dict())
    x = torch.randn(2, 6, *grid, 4, generator=gen)
    x = x if model == "tfnet" else x[:, 0]
    cell_types = torch.randint(0, 6, grid, generator=gen)
    with torch.no_grad():
        want = net(x, cell_types)
        got = card(x.cuda(), cell_types.cuda())
    assert got.is_cuda and got.shape == want.shape == (2, *grid, 4)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **F32_TOL)


# ---- checkpoint evaluation on the card ---------------------------------------
# eval_ckpt and import_checkpoint (python -m generative_turbulence_tpu_torch.
# scripts.*) on a tiny checkpoint, on the card against the CPU.

EVAL_CKPT_OVERRIDES = ["model=diffusion", "model.dim=8", "model.u_net_levels=2", "model.timesteps=20",
                       "model.sampler=ddim", "model.ddim_steps=10", "data.discard_first_seconds=-1",
                       "data.val_samples=4", "data.eval_batch_size=4", "model.batch_size=4",
                       "trainer.render_plots=false"]


@pytest.fixture(scope="module")
def tiny_checkpoint(npyd_root, tmp_path_factory):
    """A port checkpoint directory of a seeded 2-level net (dim 8, f32) on
    the .npyd dataset, with its source state."""
    from generative_turbulence_tpu_torch.training.checkpoint import CheckpointManager
    from generative_turbulence_tpu_torch.training.config import parse_cli_overrides
    from generative_turbulence_tpu_torch.training.factory import instantiate_data_and_task

    out = tmp_path_factory.mktemp("ckpt")
    config = parse_cli_overrides(EVAL_CKPT_OVERRIDES + [f"data.root={npyd_root}", f"trainer.out_dir={out}"])
    config = config.resolved()
    _, task = instantiate_data_and_task(config, "cpu")
    task.init_weights(torch.Generator().manual_seed(0))
    mgr = CheckpointManager(out / "checkpoints", config.to_json())
    mgr.save_last(task.state_dict(), 0)
    mgr.save_best(task.state_dict(), 0, 1.0)
    return out / "checkpoints", {k: v.clone() for k, v in task.net.state_dict().items()}


def _eval_ckpt(ckpt_dir, store, device, *overrides):
    from generative_turbulence_tpu_torch.scripts import eval_ckpt
    from generative_turbulence_tpu_torch.training.loop import key_seed

    noise = lambda kind, *key: _HostNoise(key_seed(0, kind, *key), device)  # noqa: E731
    return eval_ckpt.main([str(ckpt_dir), str(store), *overrides, "--device", device], noise_factory=noise)


def _stored(store, npyd_root):
    from generative_turbulence_tpu_torch.data.schema import read_metadata
    from generative_turbulence_tpu_torch.data.variables import Variable
    from generative_turbulence_tpu_torch.eval.sample_store import SampleStore

    meta = read_metadata(npyd_root / "val" / "case-val-00" / "data.npyd")
    return SampleStore(store, (Variable.U, Variable.P)).load_samples(meta).fields


@pytest.mark.gpu
def test_eval_ckpt_on_gpu(tiny_checkpoint, npyd_root, tmp_path):
    """eval_ckpt (DDIM-10, f32) on the card and on the CPU with the same
    draws: the stored samples at rtol 1e-3 / atol 1e-4 of their scale, the
    metrics at rtol 5e-3."""
    _needs_card()
    ckpt_dir, _ = tiny_checkpoint
    got = _eval_ckpt(ckpt_dir, tmp_path / "card.npyd", "cuda")
    want = _eval_ckpt(ckpt_dir, tmp_path / "cpu.npyd", "cpu")
    assert sorted(got) == sorted(want) and "val/tke" in got
    for name in want:
        assert np.isfinite(got[name])
        np.testing.assert_allclose(got[name], want[name], rtol=5e-3, err_msg=name)
    card, cpu = _stored(tmp_path / "card.npyd", npyd_root), _stored(tmp_path / "cpu.npyd", npyd_root)
    for v in cpu:
        assert card[v].shape == cpu[v].shape == (4, *cpu[v].shape[1:])
        scale = np.abs(cpu[v]).max()
        np.testing.assert_allclose(card[v] / scale, cpu[v] / scale, rtol=1e-3, atol=1e-4)


@pytest.mark.gpu
def test_import_checkpoint_round_trip_on_gpu(tiny_checkpoint, npyd_root, tmp_path):
    """The net under the reference's keys as a Lightning-style .ckpt,
    imported on the card: every tensor bit-equal to its source, the schedule
    exact, and eval_ckpt on the card bit-equal to the source checkpoint's."""
    from generative_turbulence_tpu_torch.diffusion.schedules import beta_schedule
    from generative_turbulence_tpu_torch.scripts import import_checkpoint
    from generative_turbulence_tpu_torch.toolchain.import_ckpt import to_reference_state_dict
    from generative_turbulence_tpu_torch.training.checkpoint import CheckpointManager

    _needs_card()
    ckpt_dir, source = tiny_checkpoint
    state_dict = to_reference_state_dict(source, 2)
    state_dict["model.betas"] = torch.from_numpy(beta_schedule("log-snr-linear", 20))
    torch.save({"state_dict": state_dict, "hyper_parameters": {"dim": 8, "timesteps": 20, "variables": ("U", "P")}},
               tmp_path / "turbdiff.ckpt")
    out = tmp_path / "imported"
    result = import_checkpoint.main([str(tmp_path / "turbdiff.ckpt"), str(out), f"data.root={npyd_root}",
                                     *EVAL_CKPT_OVERRIDES[2:], f"trainer.out_dir={tmp_path}", "--device", "cuda"])
    assert result["max_abs_betas_diff"] == 0.0
    restored = CheckpointManager(out).restore("best", map_location="cpu")["net"]
    assert restored.keys() == source.keys() and all(torch.equal(restored[k], source[k]) for k in source)
    got = _eval_ckpt(out, tmp_path / "imported.npyd", "cuda")
    want = _eval_ckpt(ckpt_dir, tmp_path / "source.npyd", "cuda")
    assert got == want
    imported, from_source = _stored(tmp_path / "imported.npyd", npyd_root), _stored(tmp_path / "source.npyd", npyd_root)
    for v in from_source:
        np.testing.assert_array_equal(imported[v], from_source[v])


# ---- several ranks and several cards ------------------------------------------------


@pytest.mark.gpu
def test_kernels_launch_on_the_tensors_card():
    """Tensors on cuda:1 while cuda:0 is the current device: each wrapper
    launches on the tensors' card (the library sets the shared-memory limit
    and reads the SM count on the current device), and cuda:0 stays
    current."""
    _needs_card()
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs a second card; this machine has {torch.cuda.device_count()}")
    torch.cuda.set_device(0)
    card = torch.device("cuda", 1)
    targs = [a.to(card) if a is not None else None for a in _torch(_make_args(B=2, X=40, Y=12, Z=12, C=64, F=128))]
    targs[0] = targs[0].bfloat16()
    got = ck.fused_double_conv_block(*targs, 8, 1e-5)
    want = ck.reference_double_conv(*targs, num_groups=8, eps=1e-5)
    q, k, v = (t.to(card) for t in _flash_inputs(2, 4, 2048, 32, torch.bfloat16, True, seed=3))
    flash = ck.flash_attention(q, k, v)
    torch.cuda.synchronize(card)
    assert got.device == flash.device == card and torch.cuda.current_device() == 0
    _assert_bf16_close(got.float().cpu().numpy(), want.float().cpu().numpy())
    _assert_bf16_close(flash.float().cpu().numpy(), ck._flash_attention_plain(q, k, v).float().cpu().numpy(),
                       scaled=True)


# 1 U-Net level at 66x26x26 voxels (past the chain's gate), bf16; RAdam at
# learning rate 0.5, whose first updates follow the gradient.
DP_OVERRIDES = ["model=diffusion", "data.discard_first_seconds=-1", "model.batch_size=4", "model.dim=8",
                "model.u_net_levels=1", "model.timesteps=10", "model.compute_dtype=bfloat16", "model.optimizer=radam",
                "model.learning_rate=0.5", "model.lr_decay=exp", "model.min_learning_rate=5e-3",
                "trainer.render_plots=false"]


@pytest.mark.gpu
@pytest.mark.parametrize("cards", [1, 2], ids=["gloo-shared-card", "nccl-two-cards"])
def test_two_rank_train_steps_on_gpu(tmp_path, cards):
    """Two ranks (``tests/_torch_dist_worker.py``) sharing card 0 over gloo,
    or on cards 0 and 1 over NCCL, 2 of the 4 rows a rank, 2 train steps
    against the same steps in one process on card 0: every rank launched
    the chain kernels on its card, the ranks' parameters are bit-equal, and
    the losses and each leaf's change agree with one process's at the bf16
    rule (rtol 0.06, atol 0.03 x the leaf's and x all leaves' largest
    change)."""
    from _torch_dist_worker import JOBS, run_ranks

    from generative_turbulence_tpu_torch.data.synthetic import generate_synthetic_dataset

    _needs_card()
    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} cards; this machine has {torch.cuda.device_count()}")
    root = generate_synthetic_dataset(tmp_path / "data", n_train_cases=1, n_val_cases=1, n_test_cases=0, n_frames=8,
                                      cell_counts=(64, 24, 24), format="npyd")
    spec = dict(device="cuda", steps=2,
                runs={"diffusion": DP_OVERRIDES + [f"data.root={root}", f"trainer.out_dir={tmp_path / 'run'}"]})
    one = JOBS["family_steps"](spec)["diffusion"]
    # One card visible to both ranks makes them share it.
    env = {"CUDA_VISIBLE_DEVICES": "0"} if cards == 1 else None
    results = run_ranks("family_steps", spec, tmp_path, timeout_s=300, env=env)
    for rank, (code, out, log) in enumerate(results):
        assert code == 0 and "error" not in out, f"rank {rank}:\n{log[-4000:]}"
    r0, r1 = (out["diffusion"] for _, out, _ in results)
    if cards == 1:
        assert "backend gloo, card shared by the host ranks" in results[0][2]
        assert r0["device"] == r1["device"] == "cuda:0"
    else:
        assert "backend nccl" in results[0][2] and (r0["device"], r1["device"]) == ("cuda:0", "cuda:1")
    assert r0["rows"] == r1["rows"] == [2, 2] and one["rows"] == [4, 4] and one["device"] == "cuda:0"
    for r in (r0, r1, one):
        assert all(r["launches"][name] > 0 for name in ("conv3x3x3_stats", "conv3x3x3_stats_silu_in", "affine_silu"))
    assert r0["launches"] == r1["launches"] == one["launches"]
    assert all(np.array_equal(r1["params"][k], v) for k, v in r0["params"].items())
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=0.06, atol=0.03)
    start = one["start"]
    changes = {k: (r0["params"][k] - start[k], one["params"][k] - start[k]) for k in start}
    floor = 0.03 * max(np.abs(w).max() for _, w in changes.values())
    for name, (g, w) in changes.items():
        np.testing.assert_allclose(g, w, rtol=0.06, atol=0.03 * np.abs(w).max() + floor, err_msg=name)
    g, w = (np.concatenate([c[i].ravel() for c in changes.values()]) for i in (0, 1))
    assert np.corrcoef(g, w)[0, 1] > 0.999


# ---- the study scripts on the card --------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("shape, sigma", [((2, 194, 50, 50, 3), 1.0), ((1, 13, 5, 9, 2), 3.0),
                                          ((2, 7, 1, 3, 1), 2.5), ((1, 26, 12, 12, 1), 3.0)])
def test_gaussian_smooth_on_gpu(shape, sigma):
    """trivial_baselines' smoothing on the card against scipy's
    ``gaussian_filter``: the shapes grid, odd axes, and radii past the axis
    (12 cells over 5, 1 and 12; 10 over 7, 1 and 3)."""
    from scipy.ndimage import gaussian_filter

    from generative_turbulence_tpu_torch.scripts.trivial_baselines import gaussian_smooth

    _needs_card()
    a = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got = gaussian_smooth(torch.from_numpy(a).cuda(), sigma)
    assert got.is_cuda and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), gaussian_filter(a, sigma=(0, sigma, sigma, sigma, 0)), rtol=1e-4,
                               atol=1e-7)


@pytest.mark.gpu
def test_profile_fwd_workload_on_gpu():
    """profile_fwd's workload at 66x26x26 voxels (past the chain's gate), dim
    8, 2 levels, bf16: one forward's chain launches, the same per U-Net
    evaluation under the profile of both modes, and a category table of the
    card's kernels that adds up to their total."""
    from generative_turbulence_tpu_torch.scripts import profile_fwd

    _needs_card()
    device = torch.device("cuda")
    w = profile_fwd.build_workload((64, 24, 24), dim=8, levels=2, batch=2, dtype=torch.bfloat16, device=device)
    ck.reset_launch_counts()
    with torch.inference_mode():
        w.forward()
    torch.cuda.synchronize()
    per_eval = dict(ck.LAUNCH_COUNTS)
    assert per_eval["conv3x3x3_stats"] == per_eval["conv3x3x3_stats_silu_in"] == per_eval["affine_silu"] > 0
    assert per_eval["flash_attention"] == per_eval["conv3d_3x3"] == 0
    for mode, probe in (("fwd", 8), ("ddim", 3)):
        fn, n_unet = w.runner(mode, probe)
        with torch.inference_mode():
            fn()
        ck.reset_launch_counts()
        result = profile_fwd.profile(fn, 2, n_unet, device)
        assert dict(ck.LAUNCH_COUNTS) == {k: v * 2 * n_unet for k, v in per_eval.items()}, mode
        entry = result[str(device)]
        assert isinstance(entry, dict) and entry["name"] == torch.cuda.get_device_name(device)
        assert sum(c["ms_per_eval"] for c in entry["categories"]) * 2 * n_unet == pytest.approx(entry["total_ms"])
        assert sum(c["pct"] for c in entry["categories"]) == pytest.approx(100.0)
        groups = {c["category"]: c["ms_per_eval"] for c in entry["categories"]}
        assert groups["chain convs"] > 0 and groups["affine_silu"] > 0 and "flash_attention" not in groups
        assert entry["idle_share"] < 1 and result["ms_per_unet_incl_host"] > 0


@pytest.mark.gpu
def test_tke_profile_on_gpu(npyd_root, tmp_path):
    """tke_profile of real frames (as samples) on the card against the CPU:
    the profiles at rtol 1e-4 and the same argmaxes."""
    from generative_turbulence_tpu_torch.data.schema import CaseRepository, find_data_files
    from generative_turbulence_tpu_torch.data.variables import Variable
    from generative_turbulence_tpu_torch.eval.sample_store import SampleStore
    from generative_turbulence_tpu_torch.scripts import tke_profile

    _needs_card()
    variables = (Variable.U, Variable.P)
    repo = CaseRepository(find_data_files(npyd_root / "val"), variables)
    store = SampleStore(tmp_path / "frames.npyd", variables)
    store.add_samples(repo.read(0, [0, 2, 4, 5]).stacked_cells(variables), repo.read_metadata(0))
    got, want = (tke_profile.main([str(tmp_path / "frames.npyd"), str(npyd_root / "val"), "--out",
                                   str(tmp_path / device / "profile"), "--device", device]) for device in ("cuda", "cpu"))
    assert list(got) == list(want) == ["case-val-00"]
    for case, w in want.items():
        np.testing.assert_allclose(got[case]["samples"], w["samples"], rtol=1e-4)
        np.testing.assert_allclose(got[case]["data"], w["data"], rtol=1e-4)
        assert [got[case][k] for k in ("argmax_samples", "argmax_data", "gt_pos")] == [
            w[k] for k in ("argmax_samples", "argmax_data", "gt_pos")]


@pytest.fixture(scope="module")
def toolchain_root(tmp_path_factory):
    """``generate_shapes --mock-direct --overfit 1 --frames 8 --scale 0.25``:
    the first train shape (48x12x12 cells) in ``.npyd``, every analysis."""
    from generative_turbulence_tpu_torch.scripts import generate_shapes

    _needs_card()
    root = tmp_path_factory.mktemp("toolchain") / "shapes"
    generate_shapes.main([str(root), "--mock-direct", "--overfit", "1", "--frames", "8", "--scale", "0.25"])
    return root


@pytest.mark.gpu
def test_first_turbulent_frame_on_gpu(toolchain_root):
    """The first turbulent frame of the generated case on the card against
    the CPU: the index equal, both distance matrices at the f32 tolerance."""
    from generative_turbulence_tpu_torch.toolchain import analysis

    _needs_card()
    data = next((toolchain_root / "train").iterdir()) / "data.npyd"
    got, want = (analysis.turbulent_frame_distances(data, device=device) for device in ("cuda", "cpu"))
    assert got["first"] == want["first"] == analysis.first_turbulent_frame(data, device="cuda")
    for key in ("late", "all"):
        finite = np.isfinite(want[key])
        assert np.array_equal(np.isfinite(got[key]), finite)
        np.testing.assert_allclose(got[key][finite], want[key][finite], **F32_TOL)


@pytest.mark.gpu
def test_generated_case_trains_on_gpu(toolchain_root, tmp_path):
    """One diffusion Trainer step (bf16, 1 level, dim 8) and its validation
    on the card, through the training entry point, on the generated case: a finite
    loss and finite metrics, those that read its ``mean-flow.npyd`` and
    ``max-mean-tke.npy`` among them."""
    import json

    from generative_turbulence_tpu_torch import train

    _needs_card()
    out = tmp_path / "run"
    score = train.main(["model=diffusion", *TRAINER_OVERRIDES, "model.compute_dtype=bfloat16", "trainer.max_steps=1",
                        f"data.root={toolchain_root}", f"trainer.out_dir={out}"])
    records = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    val = next(r for r in records if "val/tke" in r)
    assert losses and all(np.isfinite(losses))
    assert np.isfinite(score) and np.isfinite(val["val/tke"]) and np.isfinite(val["val/max-mean-tke-pos"])
