"""Building blocks of the denoising U-Net (channels-last torch modules).

Port of ``generative_turbulence_tpu/models/blocks.py``.  Every module takes
and returns the JAX layout ``(B, X, Y, Z, C)``; parameter names follow the
flax tree so ``toolchain.from_flax`` maps one onto the other.  ``dtype``
has flax semantics: parameters stay f32 and each layer casts its input and
weights to ``dtype`` (None computes in the promoted input/parameter type).

The ResnetBlock core takes the hand-written Hopper chain
``ops.cuda_kernels.fused_double_conv_block`` where its gate holds.  With
``remat`` the U-Net runs each ResnetBlock under ``torch.utils.checkpoint``
while gradients are recorded (flax's ``nn.remat``): the backward recomputes
the block's forward instead of keeping its activations.

On the spatial axis (``parallel.spatial``; the JAX package's ``sp`` mesh
axis, where XLA partitions the same modules) every activation is this
rank's x slab, and the modules that reach beyond it take the input's
``Slab`` as ``slab``: ``Conv3d`` takes its x halo from the neighbours (the
replicate pad stays at the global x edges and in y and z), ``GroupNorm``
sums its moments over the group, the chain exchanges halos itself, the
attention gathers the (smallest) centre grid and keeps this rank's rows of
its output, and the U-Net's resizes map global planes.  1x1 convs, FiLM and
``Dense`` stay local.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from ..ops import cuda_kernels
from ..ops.attention import efficient_linear_attention, multihead_attention
from ..ops.interp import downsample_size, resize_trilinear
from ..parallel.spatial import Slab, gather_x, halo_exchange, replicate_pad, slab_of, sp_var_mean

ActFn = Callable[[torch.Tensor], torch.Tensor]


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: Optional[torch.Generator] = None) -> None:
    """flax's lecun_normal: truncated normal (2 std) with variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


def _compute_dtype(dtype: Optional[torch.dtype], x: torch.Tensor) -> torch.dtype:
    return dtype if dtype is not None else torch.promote_types(x.dtype, torch.float32)


def _channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


class Dense(nn.Module):
    """flax ``nn.Dense``: weight (out, in), bias (out,)."""

    def __init__(self, in_features: int, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv(nn.Module):
    """flax ``nn.Conv`` with VALID padding over channels-last grids;
    weight (out, in, k, k, k).  A 1x1x1 conv is a matmul over channels."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: int = 1,
        stride: int = 1,
        use_bias: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        k = kernel_size
        self.stride = stride
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, k, k, k))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x)
        w = self.weight.to(dt)
        b = self.bias.to(dt) if self.bias is not None else None
        if w.shape[2:] == (1, 1, 1) and self.stride == 1:
            return F.linear(x.to(dt), w.flatten(1), b)
        y = F.conv3d(_channels_first(x.to(dt)), w, b, stride=self.stride)
        return _channels_last(y)


class Conv3d(nn.Module):
    """k x k x k conv with replicate ("edge") padding and SAME output size."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: int = 3,
        dilation: int = 1,
        use_bias: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        k = kernel_size
        self.dilation = dilation
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, k, k, k))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, slab: Optional[Slab] = None) -> torch.Tensor:
        """``slab``: x is this rank's x slab of the spatial axis, padded in
        x with its neighbours' planes."""
        k = self.weight.shape[-1]
        pad = (k - 1) // 2 * self.dilation
        halo = None if slab is None or pad == 0 else halo_exchange(x, pad, slab.axis)
        h = replicate_pad(x, pad, halo)
        dt = _compute_dtype(self.dtype, x)
        y = _channels_last(F.conv3d(h.to(dt), self.weight.to(dt), dilation=self.dilation))
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` over (B, ..., C): statistics over every
    non-batch axis within each channel group, in f32; output in ``dtype``."""

    def __init__(self, num_channels: int, num_groups: int, eps: float = 1e-5, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, slab: Optional[Slab] = None) -> torch.Tensor:
        """``slab``: x is this rank's x slab of the spatial axis; the
        group's moments, in two passes."""
        B, C = x.shape[0], x.shape[-1]
        G = self.num_groups
        xg = x.float().reshape(B, -1, G, C // G)
        if slab is None:
            var, mean = torch.var_mean(xg, dim=(1, 3), keepdim=True, correction=0)
        else:
            n = slab.X * x.shape[-3] * x.shape[-2] * (C // G)
            var, mean = sp_var_mean(xg, (1, 3), n, slab.axis)
        y = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        y = y * self.weight + self.bias
        return y.to(_compute_dtype(self.dtype, x))


def num_groups(norm_type: str, channels: int) -> int:
    """instance -> C groups, layer -> 1 group, group -> 8 groups."""
    try:
        return {"group": 8, "layer": 1, "instance": channels}[norm_type]
    except KeyError:
        raise ValueError(f"Unknown norm type {norm_type!r}") from None


def make_norm(norm_type: str, channels: int, dtype: Optional[torch.dtype] = None) -> GroupNorm:
    # eps 1e-5 as in torch.nn.GroupNorm (flax's default is 1e-6).
    return GroupNorm(channels, num_groups(norm_type, channels), eps=1e-5, dtype=dtype)


class ConvBlock(nn.Module):
    """conv3x3 -> norm -> optional FiLM ((scale+1) * x + shift) -> act."""

    def __init__(self, in_features: int, features: int, actfn: ActFn, norm_type: str = "group", dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.actfn = actfn
        self.conv = Conv3d(in_features, features, 3, dtype=dtype)
        self.norm = make_norm(norm_type, features, dtype)

    def forward(
        self,
        x: torch.Tensor,
        scale_shift: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        slab: Optional[Slab] = None,
    ) -> torch.Tensor:
        x = self.norm(self.conv(x, slab), slab)
        if scale_shift is not None:
            scale, shift = scale_shift
            x = (scale[:, None, None, None, :] + 1.0) * x + shift[:, None, None, None, :]
        return self.actfn(x)


class ResnetBlock(nn.Module):
    """Two conv blocks with FiLM conditioning on the first + 1x1 skip.

    Where ``cuda_kernels.fused_block_applicable`` holds (and the activation is
    SiLU) the two ConvBlocks run as ``cuda_kernels.fused_double_conv_block``:
    the Hopper kernels on a CUDA tensor, the plain chain on a CPU tensor."""

    def __init__(
        self,
        in_features: int,
        features: int,
        c_features: int,
        actfn: ActFn,
        norm_type: str = "group",
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.actfn = actfn
        self.features = features
        self.num_groups = num_groups(norm_type, features)
        self.film = Dense(c_features, 2 * features, dtype)
        self.block1 = ConvBlock(in_features, features, actfn, norm_type, dtype)
        self.block2 = ConvBlock(features, features, actfn, norm_type, dtype)
        self.skip = Conv(in_features, features, 1, dtype=dtype) if in_features != features else None

    def forward(
        self, x: torch.Tensor, c: Optional[torch.Tensor] = None, slab: Optional[Slab] = None
    ) -> torch.Tensor:
        """``slab``: x is this rank's x slab of the spatial axis (the
        chain's gate decides on the whole grid)."""
        scale_shift = None
        if c is not None:
            scale_shift = self.film(c).chunk(2, dim=-1)

        if self.actfn is F.silu and cuda_kernels.fused_block_applicable(
            x, x.shape[-1], self.features, slab
        ):
            b1, b2 = self.block1, self.block2
            scale, shift = scale_shift if scale_shift is not None else (None, None)
            h = cuda_kernels.fused_double_conv_block(
                x,
                b1.conv.weight.permute(2, 3, 4, 1, 0), b1.conv.bias,
                b1.norm.weight, b1.norm.bias, scale, shift,
                b2.conv.weight.permute(2, 3, 4, 1, 0), b2.conv.bias,
                b2.norm.weight, b2.norm.bias,
                self.num_groups, 1e-5, slab,
            )
        else:
            h = self.block2(self.block1(x, scale_shift, slab), slab=slab)

        if self.skip is not None:
            x = self.skip(x)
        return h + x


class VoxelAttention(nn.Module):
    """Self-attention over voxels (the U-Net bottleneck); kind: "full",
    "linear" or "local" (windows of ``window_size``^3 with zero padding)."""

    def __init__(
        self,
        in_features: int,
        heads: int = 4,
        dim_head: int = 32,
        kind: str = "full",
        window_size: int = 4,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if kind not in ("full", "linear", "local"):
            raise ValueError(f"Unknown attention kind {kind!r}")
        self.heads, self.dim_head, self.kind, self.window_size = heads, dim_head, kind, window_size
        hidden = heads * dim_head
        self.to_qkv = Conv(in_features, 3 * hidden, 1, use_bias=False, dtype=dtype)
        self.to_out = Conv(hidden, in_features, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, slab: Optional[Slab] = None) -> torch.Tensor:
        """``slab``: x is this rank's x slab of the spatial axis; the grid is
        gathered over the group, attended as a whole, and this rank's
        planes of the output kept."""
        if slab is not None:
            return slab_of(self._attend(gather_x(x, slab)), slab)
        return self._attend(x)

    def _attend(self, x: torch.Tensor) -> torch.Tensor:
        B, X, Y, Z, _ = x.shape
        hidden = self.heads * self.dim_head
        qkv = self.to_qkv(x)
        if self.kind == "local":
            out = self._local(qkv, (X, Y, Z))
        else:
            tokens = qkv.reshape(B, X * Y * Z, 3, self.heads, self.dim_head)
            q, k, v = (tokens[:, :, i].transpose(1, 2) for i in range(3))
            attend = multihead_attention if self.kind == "full" else efficient_linear_attention
            out = attend(q, k, v).transpose(1, 2).reshape(B, X, Y, Z, hidden)
        return self.to_out(out)

    def _local(self, qkv: torch.Tensor, spatial: Tuple[int, int, int]) -> torch.Tensor:
        B = qkv.shape[0]
        w = self.window_size
        X, Y, Z = spatial
        pads = [(-s) % w for s in spatial]
        if any(pads):
            # constant 0 padding: softens the padded cells' softmax weight
            qkv = F.pad(qkv, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        Xp, Yp, Zp = (s + p for s, p in zip(spatial, pads))
        nx, ny, nz = Xp // w, Yp // w, Zp // w
        H, D = self.heads, self.dim_head
        t = qkv.reshape(B, nx, w, ny, w, nz, w, 3, H, D)
        t = t.permute(0, 1, 3, 5, 7, 8, 2, 4, 6, 9).reshape(B * nx * ny * nz, 3, H, w**3, D)
        out = multihead_attention(t[:, 0], t[:, 1], t[:, 2])
        out = out.reshape(B, nx, ny, nz, H, w, w, w, D)
        out = out.permute(0, 1, 5, 2, 6, 3, 7, 4, 8).reshape(B, Xp, Yp, Zp, H * D)
        return out[:, :X, :Y, :Z]


class UNet(nn.Module):
    """Interpolation U-Net over arbitrary (non-power-of-two) grids.

    Downsampling halves each axis with a floor of 3; upsampling resizes to
    the skip's exact shape.  The centre is resnet -> prenorm-residual
    attention -> resnet.  Blocks are registered as ``down_{i}``,
    ``center_in``, ``center_norm``, ``center_attention``, ``center_out`` and
    ``up_{i}``, the flax names.  ``remat`` rematerializes the ResnetBlocks
    when gradients are recorded.
    """

    def __init__(
        self,
        in_features: int,
        dim: int,
        levels: int,
        c_features: int,
        actfn: ActFn,
        norm_type: str = "group",
        attention_kind: str = "full",
        dtype: Optional[torch.dtype] = None,
        remat: bool = False,
    ):
        super().__init__()
        self.levels = levels
        self.remat = remat
        block = lambda cin, cout: ResnetBlock(cin, cout, c_features, actfn, norm_type, dtype)  # noqa: E731
        ch = in_features
        for i in range(levels):
            self.add_module(f"down_{i}", block(ch, dim * 2 ** (i + 1)))
            ch = dim * 2 ** (i + 1)
        center = dim * 2**levels
        self.center_in = block(ch, center)
        self.center_norm = make_norm(norm_type, center, dtype)
        self.center_attention = VoxelAttention(center, kind=attention_kind, dtype=dtype)
        self.center_out = block(center, center)
        ch = center
        for i in reversed(range(levels)):
            self.add_module(f"up_{i}", block(ch + dim * 2 ** (i + 1), dim * 2**i))
            ch = dim * 2**i

    def _block(self, name: str, x: torch.Tensor, c: Optional[torch.Tensor], slab: Optional[Slab]) -> torch.Tensor:
        block = getattr(self, name)
        if self.remat and torch.is_grad_enabled():
            # The recompute runs in a profiler range of its own.
            contexts = lambda: (contextlib.nullcontext(), record_function("remat recompute"))  # noqa: E731
            return checkpoint(block, x, c, slab, use_reentrant=False, context_fn=contexts)
        return block(x, c, slab)

    def forward(
        self, x: torch.Tensor, c: Optional[torch.Tensor] = None, slab: Optional[Slab] = None
    ) -> torch.Tensor:
        """``slab``: x is this rank's x slab of the spatial axis; the levels'
        sizes are the whole grid's, each level's slab ``slab.at`` its x."""
        shape = (x.shape[-4] if slab is None else slab.X, *x.shape[-3:-1])
        at = lambda X: None if slab is None else slab.at(X)  # noqa: E731
        skips = []
        for i in range(self.levels):
            x = self._block(f"down_{i}", x, c, at(shape[0]))
            skips.append((x, shape))
            size = downsample_size(shape)
            x, shape = resize_trilinear(x, size, slab=at(shape[0])), size

        x = self._block("center_in", x, c, at(shape[0]))
        x = x + self.center_attention(self.center_norm(x, at(shape[0])), at(shape[0]))
        x = self._block("center_out", x, c, at(shape[0]))

        for i in reversed(range(self.levels)):
            skip, skip_shape = skips.pop()
            x, shape = resize_trilinear(x, skip_shape, slab=at(shape[0])), skip_shape
            x = self._block(f"up_{i}", torch.cat([x, skip], dim=-1), c, at(shape[0]))
        return x
