"""Hand-written Hopper kernels: the fused ResnetBlock conv chain, the
standalone ``conv3d_3x3`` op and ``flash_attention``.

``fused_double_conv_block`` is the ResnetBlock core without the residual:
conv3x3x3 -> GroupNorm -> FiLM -> SiLU -> conv3x3x3 -> GroupNorm -> SiLU,
with bf16 conv operands and f32 accumulation and statistics.  On a CUDA
tensor it runs three kernel launches from ``csrc/fused_double_conv.cu``:

1. ``conv3x3x3_stats``: the first conv, replicate padding by clamped
   addressing, with per-brick channel moments of the f32 result;
2. ``conv3x3x3_stats_silu_in``: the second conv, applying the first
   GroupNorm + FiLM + SiLU as ``silu(a*x + b)`` to its input once per
   staged element;
3. ``affine_silu``: the second GroupNorm + SiLU, written in the input dtype,
   8 channels per 16-byte vector.

The conv kernel takes its weights packed by ``pack_conv_weights`` (one
small pack per call) and writes one row of channel moments per output
brick of ``conv_brick`` voxels; ``conv3x3x3_stats`` sums them in a fixed
order.  Between the launches ``_gn_affine`` folds the moments into per-(B, F) ``a, b``
in a few f32 torch ops.  On a CPU tensor every wrapper takes its plain torch
version instead; nothing falls back silently from a CUDA tensor.

On the spatial axis (``parallel.spatial``: an x slab of the grid per rank)
the chain exchanges halo planes: the first conv reads its neighbours' edge
planes of x, the second their raw first-conv planes (exchanged between the
launches; its prologue maps them with the same ``a, b``, which
``_gn_affine`` folds from moments summed over the group and the global voxel
count), through the convs' halo variant (``conv3x3x3_stats_halo``,
``conv3x3x3_stats_silu_in_halo``: plane pointers, null at a global x edge,
where the clamp stays).  The moments cover each rank's own planes.

``conv3d_3x3`` is the first kernel's conv without the moments epilogue
(replicate-padded SAME 3x3x3 conv + bias, bf16 operands, f32 accumulation,
output in x's type); its backward is autograd of the plain conv.  No model
code calls it, as in the JAX package.  ``flash_attention`` is softmax
attention over (B, H, N, D) tokens with the online softmax inside one kernel
(``csrc/flash_attention.cu``: ``wgmma`` products fed by a TMA-filled ring of
K/V stages in bf16, register-blocked FMA in f32); ``ops.attention.multihead_attention``
takes it from ``FLASH_MIN_TOKENS`` tokens up; its backward is autograd of
its plain version.

The kernels are compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/kernels/`` (one ``nvcc`` per source, all started together, then one
link; the library is keyed by a hash of the sources and flags) and loaded
with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..parallel.spatial import Slab, halo_exchange, replicate_pad, sp_var_mean

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Launches per kernel since the last reset: each wrapper adds one where it
# launches its kernel, and nowhere else.
LAUNCH_COUNTS: Dict[str, int] = {
    "conv3x3x3_stats": 0,
    "conv3x3x3_stats_silu_in": 0,
    "conv3x3x3_stats_halo": 0,
    "conv3x3x3_stats_silu_in_halo": 0,
    "affine_silu": 0,
    "conv3d_3x3": 0,
    "flash_attention": 0,
}

MIN_SPATIAL_FOR_FUSED_BLOCK = 64 * 24 * 24
MAX_CHANNELS_FOR_FUSED_BLOCK = 160

_lib: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def build_library() -> Path:
    """Compile ``csrc/*.cu`` into one shared library unless it is built already.

    Each source compiles in its own ``nvcc`` process, all started together,
    and one more ``nvcc`` links the objects.  The file name carries a hash of
    the sources and flags, so an edited source rebuilds.  ``nvcc``'s output
    (``-Xptxas -v``: registers, shared memory, spills per kernel) is kept
    beside it as ``.log``.
    """
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    lib = BUILD_DIR / f"libgt_kernels_{digest.hexdigest()[:16]}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    logs = [obj.with_suffix(".log") for obj in objs]
    procs = []
    for src, obj, log in zip(sources, objs, logs):
        with open(log, "w") as out:
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            procs.append(subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT))
    codes = [proc.wait() for proc in procs]
    text = "".join(f"== {src.name}\n{log.read_text()}" for src, log in zip(sources, logs))
    for log in logs:
        log.unlink()
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    if not any(codes):
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *(str(o) for o in objs)],
            capture_output=True, text=True,
        )
        text += f"== link\n{link.stdout}{link.stderr}"
        codes.append(link.returncode)
    for obj in objs:
        obj.unlink(missing_ok=True)
    lib.with_suffix(".log").write_text(text)
    if any(codes):
        raise RuntimeError(f"nvcc failed ({codes}):\n{text}")
    os.replace(tmp, lib)
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gt_conv3x3x3_brick.argtypes = [i, ctypes.POINTER(i)]
        lib.gt_conv3x3x3_brick.restype = None
        for bn in (32, 64, 128):
            brick = (i * 3)()
            lib.gt_conv3x3x3_brick(bn, brick)
            if tuple(brick) != conv_brick(bn):
                raise RuntimeError(f"library brick {tuple(brick)} != conv_brick({bn}) {conv_brick(bn)}")
        lib.gt_conv3x3x3_stats.argtypes = [p, p, p, p, p, p, p, p, p, *([i] * 8), p]
        lib.gt_conv3x3x3_stats.restype = i
        lib.gt_affine_silu.argtypes = [p, p, p, p, i, i, ctypes.c_longlong, i, p]
        lib.gt_affine_silu.restype = i
        lib.gt_conv3d_3x3.argtypes = [p, p, p, p, *([i] * 9), p]
        lib.gt_conv3d_3x3.restype = i
        ll = ctypes.c_longlong
        lib.gt_flash_attention.argtypes = [p, p, p, p, i, i, i, i, i, *([ll] * 9), p]
        lib.gt_flash_attention.restype = i
        _lib = lib
    return _lib


def _check_status(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {status}")


def _require_cuda_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _require_hopper(device: torch.device) -> None:
    major, minor = torch.cuda.get_device_capability(device)
    if (major, minor) != (9, 0):
        raise RuntimeError(
            f"the kernels are built for sm_90a (Hopper); device has sm_{major}{minor}"
        )


# ---------------------------------------------------------------------------
# Kernel 1/2: conv3x3x3 with channel moments (+ optional silu(a*x+b) prologue)
# ---------------------------------------------------------------------------


def _spatial_bcast(v: torch.Tensor) -> torch.Tensor:
    """(B, C) -> (B, 1, 1, 1, C)."""
    return v[:, None, None, None, :]


def conv_tiling(c_in: int, features: int) -> Tuple[int, int]:
    """(BN, KC) of the conv kernel: output channels per block (32, 64 or 128;
    more are split over blocks) and input channels per halo chunk (32, or 64
    walked in chunks); both are zero-padded up to a multiple."""
    bn = 32 if features <= 32 else 64 if features <= 64 else 128
    return bn, 32 if c_in <= 32 else 64


def conv_brick(bn: int) -> Tuple[int, int, int]:
    """The output brick (x, y, z) of one block of the conv kernel at output
    tile ``bn``: one y line of 8 x 8 voxels (one wgmma m64 tile) per
    warpgroup, four warpgroups up to bn = 64, two at 128.  The library's
    gt_conv3x3x3_brick must agree (checked at load)."""
    return (8, 2 if bn == 128 else 4, 8)


def conv_n_bricks(X: int, Y: int, Z: int, brick: Tuple[int, int, int]) -> int:
    """Output bricks of ``brick`` voxels covering an X x Y x Z grid."""
    return -(-X // brick[0]) * -(-Y // brick[1]) * -(-Z // brick[2])


def pack_conv_weights(w: torch.Tensor, bn: int, kc: int) -> torch.Tensor:
    """(3, 3, 3, C, F) weights -> the kernel's B ring images, bf16.

    Shape (F tiles, C chunks, 27 taps, kc/16, bn/8, 2, 8, 8): for each F
    tile of ``bn`` channels, C chunk of ``kc`` channels and tap, one stage of
    the ring, walked in that order.  A stage holds kc/16 slabs of 16 input
    channels; a slab holds K-major 8x8 core matrices, (group j of 8 output
    channels, half h of the 16 input channels), each 8 output channels x 8
    input channels.  Element [t, c, tap, k, j, h, r, e] is
    w[tap, c*kc + 16k + 8h + e, t*bn + 8j + r]; channels beyond C or F are 0.
    """
    C, Fo = w.shape[3], w.shape[4]
    n_ch, n_ft = -(-C // kc), -(-Fo // bn)
    wp = torch.zeros(27, n_ch * kc, n_ft * bn, dtype=torch.bfloat16, device=w.device)
    wp[:, :C, :Fo] = w.reshape(27, C, Fo)
    # (tap, chunk, k, h, e, F tile, j, r) -> (F tile, chunk, tap, k, j, h, r, e)
    wp = wp.reshape(27, n_ch, kc // 16, 2, 8, n_ft, bn // 8, 8)
    return wp.permute(5, 1, 0, 2, 6, 3, 7, 4).contiguous()


def _brick_partials(y: torch.Tensor, brick: Tuple[int, int, int]) -> torch.Tensor:
    """Per-brick channel sums and sums of squares of y (B, X, Y, Z, F), in the
    kernel's brick order (z fastest): (B, conv_n_bricks(X, Y, Z, brick), 2, F)."""
    B, X, Y, Z, Fo = y.shape
    tx, ty, tz = brick
    nx, ny, nz = -(-X // tx), -(-Y // ty), -(-Z // tz)
    yp = F.pad(y.float(), (0, 0, 0, nz * tz - Z, 0, ny * ty - Y, 0, nx * tx - X))
    yb = yp.reshape(B, nx, tx, ny, ty, nz, tz, Fo)
    moments = [yb.sum(dim=(2, 4, 6)), (yb * yb).sum(dim=(2, 4, 6))]
    return torch.stack(moments, dim=-2).reshape(B, nx * ny * nz, 2, Fo)


def _conv3x3x3_stats_plain(x, w, bias, act, halo=None):
    """The kernel's plain version: (y bf16, per-brick moments of the f32 y)."""
    def prologue(t):
        if act is None:
            return t.float()
        a, b = act
        return F.silu(t.float() * _spatial_bcast(a) + _spatial_bcast(b)).to(torch.bfloat16).float()

    # f32 conv over bf16 values: exact products, f32 accumulation.
    hc = replicate_pad(prologue(x), 1, None if halo is None else tuple(prologue(t) for t in halo))
    y = F.conv3d(hc, w.float().permute(4, 3, 0, 1, 2), bias.float())
    y = y.permute(0, 2, 3, 4, 1)
    brick = conv_brick(conv_tiling(x.shape[-1], w.shape[-1])[0])
    return y.to(torch.bfloat16).contiguous(), _brick_partials(y, brick)


def _conv3x3x3_stats_kernel(x, w, bias, act, halo=None):
    """Launches the conv kernel (its halo variant with ``halo``): (y bf16,
    per-brick moments)."""
    B, X, Y, Z, C = x.shape
    Fo = w.shape[-1]
    _require_hopper(x.device)
    _require_cuda_tensor(x, "x", torch.bfloat16, (B, X, Y, Z, C))
    _require_cuda_tensor(w, "w", torch.bfloat16, (3, 3, 3, C, Fo))
    _require_cuda_tensor(bias, "bias", torch.float32, (Fo,))
    if act is not None:
        for name, v in zip(("a", "b"), act):
            _require_cuda_tensor(v, name, torch.float32, (B, C))
    planes = (None, None)
    if halo is not None:
        for name, t in zip(("lo", "hi"), halo):
            if t.shape[1]:
                _require_cuda_tensor(t, name, torch.bfloat16, (B, 1, Y, Z, C))
        planes = tuple(t.data_ptr() if t.shape[1] else None for t in halo)
    lib = _library()
    bn, kc = conv_tiling(C, Fo)
    wp = pack_conv_weights(w, bn, kc)
    out = torch.empty((B, X, Y, Z, Fo), dtype=torch.bfloat16, device=x.device)
    n_bricks = conv_n_bricks(X, Y, Z, conv_brick(bn))
    partial = torch.empty((B, n_bricks, 2, Fo), dtype=torch.float32, device=x.device)
    pa = act[0].data_ptr() if act is not None else None
    pb = act[1].data_ptr() if act is not None else None
    with torch.cuda.device(x.device):  # the library sets attributes on the current device
        status = lib.gt_conv3x3x3_stats(
            x.data_ptr(), *planes, wp.data_ptr(), bias.data_ptr(), pa, pb,
            out.data_ptr(), partial.data_ptr(), B, X, Y, Z, C, Fo, bn, kc,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    name = ("conv3x3x3_stats" if act is None else "conv3x3x3_stats_silu_in") + ("" if halo is None else "_halo")
    _check_status(status, name)
    LAUNCH_COUNTS[name] += 1
    return out, partial


def conv3x3x3_stats(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    act: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    halo: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replicate-padded SAME 3x3x3 conv + bias with channel moments.

    x: (B, X, Y, Z, C) bf16; w: (3, 3, 3, C, F) bf16; bias: (F,) f32;
    act: None, or per-(B, C) f32 ``(a, b)``, in which case the conv reads
    ``silu(a*x + b)`` rounded to bf16 instead of x.  halo: None, or the
    planes ``(lo, hi)`` before and after x along grid-x, each (B, 1, Y, Z,
    C) bf16 or (B, 0, Y, Z, C) at a global edge, where the pad replicates
    (the halo variant on a CUDA tensor).
    Returns (y (B, X, Y, Z, F) bf16, sums (B, 2, F) f32) with sums[:, 0] the
    sum of the f32 conv output over all voxels and sums[:, 1] its sum of squares.
    """
    run = _conv3x3x3_stats_kernel if x.is_cuda else _conv3x3x3_stats_plain
    out, partial = run(x, w, bias, act, halo)
    # Cross-brick reduction in a fixed order (no atomics): runs repeat bit for bit.
    return out, partial.sum(dim=1)


# ---------------------------------------------------------------------------
# Kernel 3: affine_silu
# ---------------------------------------------------------------------------


def _affine_silu_plain(h, a, b, out_dtype):
    return F.silu(h.float() * _spatial_bcast(a) + _spatial_bcast(b)).to(out_dtype)


def affine_silu(
    h: torch.Tensor, a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype
) -> torch.Tensor:
    """silu(a*h + b) with per-(B, F) f32 a, b over (B, X, Y, Z, F) bf16 h.

    On a CUDA tensor the kernel takes B <= 65535 and X*Y*Z*F below its
    32-bit offsets' limit (``gt_affine_silu``); past them it raises.
    """
    if not h.is_cuda:
        return _affine_silu_plain(h, a, b, out_dtype)
    B, X, Y, Z, Fo = h.shape
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"affine_silu writes f32 or bf16, not {out_dtype}")
    _require_cuda_tensor(h, "h", torch.bfloat16, (B, X, Y, Z, Fo))
    _require_cuda_tensor(a, "a", torch.float32, (B, Fo))
    _require_cuda_tensor(b, "b", torch.float32, (B, Fo))
    out = torch.empty(h.shape, dtype=out_dtype, device=h.device)
    if out.numel() == 0:
        return out  # nothing to launch
    lib = _library()
    with torch.cuda.device(h.device):
        status = lib.gt_affine_silu(
            h.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.float32), B, X * Y * Z, Fo,
            torch.cuda.current_stream(h.device).cuda_stream,
        )
    _check_status(status, "affine_silu")
    LAUNCH_COUNTS["affine_silu"] += 1
    return out


# ---------------------------------------------------------------------------
# Kernel 4: conv3d_3x3 (the conv kernel without moments)
# ---------------------------------------------------------------------------


def _conv3d_3x3_plain(x, w, b):
    """f32 conv over the bf16-rounded x and w, plus bias, in x's type."""
    bf = torch.bfloat16
    y = _conv3d_replicate(x.to(bf).float(), w.to(bf).float()) + b.float()
    return y.to(x.dtype)


def _conv3d_3x3_kernel(x, w, b):
    B, X, Y, Z, C = x.shape
    Fo = w.shape[-1]
    _require_hopper(x.device)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be f32 or bf16, got {x.dtype}")
    _require_cuda_tensor(x, "x", x.dtype, (B, X, Y, Z, C))
    if tuple(w.shape) != (3, 3, 3, C, Fo) or tuple(b.shape) != (Fo,):
        raise ValueError(
            f"w must be (3, 3, 3, {C}, F) and b (F,), got {tuple(w.shape)}, {tuple(b.shape)}"
        )
    bn, kc = conv_tiling(C, Fo)
    wp = pack_conv_weights(w.to(device=x.device, dtype=torch.bfloat16), bn, kc)
    bb = b.to(device=x.device, dtype=torch.float32).contiguous()
    lib = _library()
    out = torch.empty((B, X, Y, Z, Fo), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        status = lib.gt_conv3d_3x3(
            x.data_ptr(), wp.data_ptr(), bb.data_ptr(), out.data_ptr(),
            int(x.dtype == torch.float32), B, X, Y, Z, C, Fo, bn, kc,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _check_status(status, "conv3d_3x3")
    LAUNCH_COUNTS["conv3d_3x3"] += 1
    return out


class _Conv3d3x3(torch.autograd.Function):
    """Forward: the kernel (its plain version on a CPU tensor).  Backward:
    autograd of the plain conv in the inputs' types, with a zero bias, as the
    JAX package's ``_conv3d_3x3_bwd`` takes the XLA conv's gradients."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        if not x.is_cuda:
            return _conv3d_3x3_plain(x, w, b)
        return _conv3d_3x3_kernel(x, w, b)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        with torch.enable_grad():
            xi, wi = x.detach().requires_grad_(), w.detach().requires_grad_()
            bi = torch.zeros(w.shape[-1], dtype=x.dtype, device=x.device, requires_grad=True)
            y = _conv3d_replicate(xi, wi) + bi
            return torch.autograd.grad(y, (xi, wi, bi), grad.to(y.dtype))


def conv3d_3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Replicate-padded SAME 3x3x3 conv + bias.

    x: (B, X, Y, Z, C) f32 or bf16; w: (3, 3, 3, C, F); b: (F,).  Returns
    (B, X, Y, Z, F) in x's type: bf16 operands, f32 accumulation.  A CUDA
    tensor runs the Hopper kernel; a CPU tensor runs ``_conv3d_3x3_plain``.
    Differentiable in x, w and b.
    """
    return _Conv3d3x3.apply(x, w, b)


# ---------------------------------------------------------------------------
# Kernel 5: flash_attention
# ---------------------------------------------------------------------------


def _flash_attention_plain(q, k, v):
    """Scores and softmax in f32, output in q's type."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhnm,bhmd->bhnd", weights, v.float()).to(q.dtype)


def _flash_attention_kernel(q, k, v, strides):
    """Launches the kernel on checked q, k, v: the output, contiguous."""
    B, H, N, D = q.shape
    out = torch.empty((B, H, N, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out  # nothing to launch
    lib = _library()
    with torch.cuda.device(q.device):
        status = lib.gt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.float32), B, H, N, D, *strides,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _check_status(status, "flash_attention")
    LAUNCH_COUNTS["flash_attention"] += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel (its plain version on a CPU tensor).  Backward:
    autograd of the plain version on the saved q, k, v, as the JAX package
    differentiates its XLA attention; no kernel runs in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, strides):
        ctx.save_for_backward(q, k, v)
        if strides is None:
            return _flash_attention_plain(q, k, v)
        return _flash_attention_kernel(q, k, v, strides)

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = _flash_attention_plain(*leaves)
            return (*torch.autograd.grad(out, leaves, grad), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over q, k, v (B, H, N, D) -> (B, H, N, D).

    A CUDA tensor runs the Hopper kernel: f32 or bf16 (all three alike), D a
    multiple of 8 up to 128.  The kernel reads the inputs through their
    batch, head and token strides, so views such as the U-Net's
    ``qkv[:, :, i].transpose(1, 2)`` need no copy; the last stride must be 1
    and every pointer and stride 16-byte aligned.  The output is contiguous,
    in q's type.  B * H * ceil(N / 128) must stay below 2^31 (the kernels'
    work items).  A CPU tensor runs ``_flash_attention_plain``.
    Differentiable in q, k and v: the gradients are those of
    ``_flash_attention_plain``.
    """
    if not q.is_cuda:
        return _FlashAttention.apply(q, k, v, None)
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, N, D), got shape {tuple(q.shape)}")
    B, H, N, D = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention takes f32 or bf16, got {q.dtype}")
    if D % 8 or not 8 <= D <= 128:
        raise ValueError(f"flash_attention takes D a multiple of 8 up to 128, got {D}")
    items = B * H * -(-N // 128)
    if items >= 2**31:
        raise ValueError(f"B * H * ceil(N / 128) = {items} work items; the kernels take < 2^31")
    _require_hopper(q.device)
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype or tuple(t.shape) != (B, H, N, D):
            raise ValueError(
                f"{name} must be a {q.dtype} tensor of shape {(B, H, N, D)} on {q.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride in D, got {t.stride()}")
        per16 = 16 // t.element_size()
        if t.data_ptr() % 16 or any(
            s % per16 for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1
        ):
            raise ValueError(f"{name}: pointer and strides must be 16-byte aligned, got {t.stride()}")
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    return _FlashAttention.apply(q, k, v, tuple(strides))


# ---------------------------------------------------------------------------
# The chain
# ---------------------------------------------------------------------------


def _gn_affine(sums, gamma, beta, scale, shift, *, count, num_groups, eps):
    """Fold GroupNorm + FiLM into per-(B, F) ``a, b`` (f32 throughout):
    a = inv*gamma*(scale+1), b = (beta - mean*inv*gamma)*(scale+1) + shift."""
    B, _, Fo = sums.shape
    G = num_groups
    sg = sums[:, 0].reshape(B, G, Fo // G).sum(-1, keepdim=True)
    ssg = sums[:, 1].reshape(B, G, Fo // G).sum(-1, keepdim=True)
    n = count * (Fo // G)
    mean = sg / n
    # E[y^2] - E[y]^2 can cancel below zero in f32: clamp before rsqrt.
    var = torch.clamp(ssg / n - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    mean_c = mean.expand(B, G, Fo // G).reshape(B, Fo)
    inv_c = inv.expand(B, G, Fo // G).reshape(B, Fo)
    g = gamma.float()[None]
    be = beta.float()[None]
    if scale is None:
        a = inv_c * g
        b = be - mean_c * inv_c * g
    else:
        fs = scale.float() + 1.0
        a = inv_c * g * fs
        b = (be - mean_c * inv_c * g) * fs + shift.float()
    return a.contiguous(), b.contiguous()


def kernel_chain(
    x, w1, b1, gamma1, beta1, scale, shift, w2, b2, gamma2, beta2, *, num_groups, eps, slab=None, halo=None
):
    """The chain as its three kernels plus the two folds (no autograd).

    On CUDA tensors it launches the kernels; on CPU tensors each step takes
    its plain version, which keeps the fold algebra testable there.  With
    ``slab`` x is this rank's x slab of the spatial axis and ``halo`` its
    halo planes (``halo_exchange``): the convs take the halo variant, the
    first conv's output planes are exchanged between the launches, and the
    moments are summed over the group and divided by the global count."""
    B, X, Y, Z, _ = x.shape
    count = (X if slab is None else slab.X) * Y * Z
    bf = torch.bfloat16
    halo = None if slab is None else tuple(t.to(bf).contiguous() for t in halo)

    def group_sums(s):
        if slab is not None:
            dist.all_reduce(s, group=slab.axis.group)
        return s

    h1, s1 = conv3x3x3_stats(x.to(bf).contiguous(), w1.to(bf).contiguous(), b1.float(), halo=halo)
    a1, c1 = _gn_affine(
        group_sums(s1), gamma1, beta1, scale, shift, count=count, num_groups=num_groups, eps=eps
    )
    if slab is not None:
        halo = tuple(t.contiguous() for t in halo_exchange(h1, 1, slab.axis))
    h2, s2 = conv3x3x3_stats(h1, w2.to(bf).contiguous(), b2.float(), act=(a1, c1), halo=halo)
    s2 = group_sums(s2)
    a2, c2 = _gn_affine(
        s2, gamma2, beta2, None, None, count=count, num_groups=num_groups, eps=eps
    )
    return affine_silu(h2, a2, c2, x.dtype)


def _conv3d_replicate(h, w, halo=None):
    """SAME 3x3x3 conv with replicate padding in h.dtype, without bias.
    h: (B, X, Y, Z, C); w: (3, 3, 3, C, F) -> (B, X, Y, Z, F).  halo:
    None, or h's x halo planes (``replicate_pad``)."""
    y = F.conv3d(replicate_pad(h, 1, halo), w.to(h.dtype).permute(4, 3, 0, 1, 2))
    return y.permute(0, 2, 3, 4, 1)


def reference_double_conv(
    x, w1, b1, gamma1, beta1, scale, shift, w2, b2, gamma2, beta2, *, num_groups, eps, slab=None, halo=None
):
    """Plain torch version of the chain: conv in x.dtype, GroupNorm
    statistics in f32, output in x.dtype (the numerics of the JAX package's
    ``_reference_double_conv``).  ``slab``, ``halo`` as for
    ``kernel_chain``: the second conv's halo planes come from
    ``halo_exchange``, the statistics are the group's (two passes, each
    summed over the group), all differentiable."""

    def conv_gn_silu(h, w, b, gamma, beta, sc, sh, halo):
        y = _conv3d_replicate(h, w, halo).float() + b.float()
        B, X, Y, Z, Fo = y.shape
        G = num_groups
        yg = y.reshape(B, X, Y, Z, G, Fo // G)
        if slab is None:
            var, mean = torch.var_mean(yg, dim=(1, 2, 3, 5), keepdim=True, correction=0)
        else:
            var, mean = sp_var_mean(yg, (1, 2, 3, 5), slab.X * Y * Z * (Fo // G), slab.axis)
        yn = ((yg - mean) * torch.rsqrt(var + eps)).reshape(B, X, Y, Z, Fo)
        yn = yn * gamma.float() + beta.float()
        if sc is not None:
            yn = (_spatial_bcast(sc.float()) + 1.0) * yn + _spatial_bcast(sh.float())
        return F.silu(yn).to(x.dtype)

    h = conv_gn_silu(x, w1, b1, gamma1, beta1, scale, shift, halo)
    if slab is not None:
        halo = halo_exchange(h, 1, slab.axis)
    return conv_gn_silu(h, w2, b2, gamma2, beta2, None, None, halo)


class _FusedDoubleConv(torch.autograd.Function):
    """Forward: the kernels.  Backward: autograd of the plain chain (with a
    ``slab``, through the halo exchange's and the sums' own backward;
    ``lo, hi`` are x's halo planes, or None)."""

    @staticmethod
    def forward(ctx, num_groups, eps, slab, lo, hi, *args):
        ctx.num_groups, ctx.eps, ctx.slab = num_groups, eps, slab
        ctx.save_for_backward(lo, hi, *args)
        return kernel_chain(*args, num_groups=num_groups, eps=eps, slab=slab, halo=(lo, hi))

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            inputs = [a.detach().requires_grad_() if a is not None else None for a in ctx.saved_tensors]
            out = reference_double_conv(
                *inputs[2:], num_groups=ctx.num_groups, eps=ctx.eps, slab=ctx.slab, halo=inputs[:2]
            )
            live = [i for i in inputs if i is not None]
            grads = iter(torch.autograd.grad(out, live, grad, allow_unused=True))
            grads = [next(grads) if i is not None else None for i in inputs]
        return (None, None, None, *grads)


def fused_double_conv_block(
    x, w1, b1, gamma1, beta1, scale, shift, w2, b2, gamma2, beta2,
    num_groups: int = 8, eps: float = 1e-5, slab: Optional[Slab] = None,
):
    """The ResnetBlock core (both ConvBlocks, without the residual).

    x: (B, X, Y, Z, C); w*: (3, 3, 3, C_in, F); b*, gamma*, beta*: (F,);
    scale/shift: (B, F) FiLM vectors or None.  Returns (B, X, Y, Z, F) in
    x.dtype.  A CUDA tensor runs the Hopper kernels (bf16 operands, f32
    accumulation and statistics); a CPU tensor runs ``reference_double_conv``.
    With ``slab`` x is this rank's x slab of the spatial axis, and the
    chain exchanges halo planes with the group.
    """
    args = (x, w1, b1, gamma1, beta1, scale, shift, w2, b2, gamma2, beta2)
    lo, hi = (None, None) if slab is None else halo_exchange(x, 1, slab.axis)
    if not x.is_cuda:
        return reference_double_conv(*args, num_groups=num_groups, eps=eps, slab=slab, halo=(lo, hi))
    if x.dim() != 5:
        raise ValueError(f"x must be (B, X, Y, Z, C), got shape {tuple(x.shape)}")
    B, C = x.shape[0], x.shape[-1]
    Fo = w1.shape[-1]
    shapes = {
        "w1": (w1, (3, 3, 3, C, Fo)), "b1": (b1, (Fo,)), "gamma1": (gamma1, (Fo,)),
        "beta1": (beta1, (Fo,)), "w2": (w2, (3, 3, 3, Fo, Fo)), "b2": (b2, (Fo,)),
        "gamma2": (gamma2, (Fo,)), "beta2": (beta2, (Fo,)),
    }
    if scale is not None:
        shapes.update(scale=(scale, (B, Fo)), shift=(shift, (B, Fo)))
    elif shift is not None:
        raise ValueError("shift given without scale")
    for name, (t, shape) in shapes.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if Fo % num_groups:
        raise ValueError(f"{Fo} channels do not split into {num_groups} groups")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be f32 or bf16, got {x.dtype}")
    return _FusedDoubleConv.apply(num_groups, eps, slab, lo, hi, *args)


def fused_block_applicable(x: torch.Tensor, c_in: int, features: int, slab: Optional[Slab] = None) -> bool:
    """Envelope of ``fused_double_conv_block``: big grids and at most 160
    channels, the JAX package's gate without its TPU/env-flag checks (the
    caller checks for SiLU).  On an x ``slab`` it decides on the whole grid,
    so the same blocks engage at any sp."""
    X, Y, Z = x.shape[-4:-1]
    if slab is not None:
        X = slab.X
    if X * Y * Z < MIN_SPATIAL_FOR_FUSED_BLOCK:
        return False
    return max(c_in, features) <= MAX_CHANNELS_FOR_FUSED_BLOCK
