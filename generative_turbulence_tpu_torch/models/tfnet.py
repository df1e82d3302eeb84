"""TF-Net baseline generalized to 3D (turbulent-flow net).

Port of ``generative_turbulence_tpu/models/tfnet.py``.  Decomposes the
context window u = u_bar + u_tilde + u_prime via a learned spatial filter
(conv3d k=3, no bias) and a learned temporal filter over a sliding window,
encodes each component with a strided conv encoder (64->128->256->512), sums
encoder features per scale, and decodes with transposed convs + shape
clipping.  Channels-last ``(B, X, Y, Z, C)`` throughout; parameter names
follow the flax tree.

Three places where flax and torch differ, reproduced here:

- flax's ``padding="SAME"`` pads zeros by ``total = max((ceil(n/s)-1)*s + k -
  n, 0)``, ``lo = total // 2``: at stride 2 an even extent gets (0, 1), not
  torch's symmetric 1.  ``_SameConv`` pads explicitly, then convolves VALID.
- ``nn.ConvTranspose(k=4, s=2, padding="SAME")`` (``transpose_kernel=False``)
  is the input dilated by 2, padded (2, 2) and convolved with the kernel as
  it is.  That is ``F.conv_transpose3d(padding=1)`` with the kernel flipped
  on its spatial axes and its in/out axes swapped: ``toolchain.from_flax``
  converts the kernel so, and ``weight`` is in torch's layout (I, O, k, k, k).
- The encoders' ``nn.BatchNorm(use_running_average=True)`` normalizes by its
  ``batch_stats`` ``mean`` / ``var`` (eps 1e-5), never by batch moments, and
  the JAX regression task trains them with the rest (its ``state.params`` is
  the whole variables tree).  ``_BatchNorm`` holds them as parameters.

Dropout never acts on the JAX path (``deterministic=True``, no dropout rng),
so it is not built.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import Conv, _channels_first, _channels_last, _compute_dtype, lecun_normal_
from .conditioning import Conditioning


def _clip_to(a: torch.Tensor, shape3: Sequence[int]) -> torch.Tensor:
    return a[..., : shape3[0], : shape3[1], : shape3[2], :]


def same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """flax/XLA ``SAME`` padding (lo, hi) of one axis of extent ``n``."""
    total = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


class _SameConv(Conv):
    """flax ``nn.Conv(padding="SAME")``: zero padding by ``same_pads``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        pads = []
        for n in reversed(x.shape[-4:-1]):  # F.pad takes the last axis first
            pads += same_pads(n, k, self.stride)
        dt = _compute_dtype(self.dtype, x)
        h, w = F.pad(_channels_first(x), pads).to(dt), self.weight.to(dt)
        b = self.bias.to(dt) if self.bias is not None else None
        if dt == torch.bfloat16 and h.device.type == "cpu":
            # torch's CPU bf16 conv3d returns wrong values at stride 2 on small
            # grids with a batch above 1 (2.13, 128 -> 256 channels on 5x5x3):
            # the same products of the bf16 operands, summed in f32 and
            # rounded once, as a bf16 conv on the card computes them.
            y = F.conv3d(h.float(), w.float(), None if b is None else b.float(), stride=self.stride).to(dt)
        else:
            y = F.conv3d(h, w, b, stride=self.stride)
        return _channels_last(y)


class _BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(use_running_average=True)``: (x - mean) *
    (rsqrt(var + eps) * scale) + bias in f32, output in ``dtype``."""

    def __init__(self, features: int, eps: float = 1e-5, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.mean = nn.Parameter(torch.zeros(features))
        self.var = nn.Parameter(torch.ones(features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            for p, value in ((self.weight, 1.0), (self.bias, 0.0), (self.mean, 0.0), (self.var, 1.0)):
                p.fill_(value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x - self.mean
        mul = torch.rsqrt(self.var + self.eps) * self.weight
        y = y * mul + self.bias
        return y.to(_compute_dtype(self.dtype, x))


class _Encoder(nn.Module):
    def __init__(self, in_features: int, c_features: int, kernel_size: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        widths = {"conv1": (in_features, 64), "conv2": (64, 128), "conv3": (128, 256), "conv4": (256, 512)}
        if c_features:
            widths["conv1_local"] = (c_features, 64)
        for name, (c_in, c_out) in widths.items():
            setattr(self, name, _SameConv(c_in, c_out, kernel_size, stride=2, dtype=dtype))
            setattr(self, f"{name}_bn", _BatchNorm(c_out, dtype=dtype))

    def _conv(self, name: str, h: torch.Tensor) -> torch.Tensor:
        h = getattr(self, f"{name}_bn")(getattr(self, name)(h))
        return F.leaky_relu(h, 0.1)

    def forward(self, x: torch.Tensor, c_local: Optional[torch.Tensor]):
        out1 = self._conv("conv1", x)
        if c_local is not None:
            out1 = out1 + self._conv("conv1_local", c_local[None])
        out2 = self._conv("conv2", out1)
        out3 = self._conv("conv3", out2)
        out4 = self._conv("conv4", out3)
        return out1, out2, out3, out4


class _ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose(k=4, s=2, padding="SAME")`` as
    ``F.conv_transpose3d(stride=2, padding=1)``; ``weight`` (I, O, 4, 4, 4)
    is the flax kernel flipped and with in/out swapped."""

    def __init__(self, in_features: int, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(in_features, features, 4, 4, 4))
        self.bias = nn.Parameter(torch.empty(features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        lecun_normal_(self.weight, 64 * self.weight.shape[0], generator)  # flax's fan-in: 4^3 * I
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(self.dtype, x)
        y = F.conv_transpose3d(_channels_first(x.to(dt)), self.weight.to(dt), self.bias.to(dt),
                               stride=2, padding=1)
        return _channels_last(y)


class _Deconv(nn.Module):
    def __init__(self, in_features: int, features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.ConvTranspose_0 = _ConvTranspose(in_features, features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.ConvTranspose_0(x), 0.1)


class TFNet(nn.Module):
    def __init__(
        self,
        n_features: int,
        context_window: int = 6,
        temporal_filtering_length: int = 4,
        kernel_size: int = 3,
        conditioning: Optional[Conditioning] = None,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.temporal_filtering_length = temporal_filtering_length
        self.conditioning = conditioning
        self.spatial_filter = _SameConv(1, 1, kernel_size, use_bias=False, dtype=dtype)
        self.temporal_filter = nn.Parameter(torch.empty(temporal_filtering_length, 1))
        lecun_normal_(self.temporal_filter, temporal_filtering_length)
        n_windows = context_window - temporal_filtering_length + 1
        c_features = conditioning.out_dim if conditioning is not None else 0
        for name in ("encoder_bar", "encoder_tilde", "encoder_prime"):
            setattr(self, name, _Encoder(n_windows * n_features, c_features, kernel_size, dtype))
        for i, (c_in, c_out) in enumerate(((512, 256), (256, 128), (128, 64), (64, 32))):
            setattr(self, f"_Deconv_{i}", _Deconv(c_in, c_out, dtype))
        self.output_layer = _SameConv(32, n_features, kernel_size, dtype=torch.float32)

    def init_weights(self, generator: Optional[torch.Generator] = None) -> "TFNet":
        """Re-draw every parameter (flax's initializers) from ``generator``."""
        for module in self.modules():
            if isinstance(module, nn.Embedding):
                with torch.no_grad():
                    nn.init.normal_(module.weight, generator=generator)
            elif isinstance(module, (Conv, _ConvTranspose, _BatchNorm)):
                module.reset_parameters(generator)
        lecun_normal_(self.temporal_filter, self.temporal_filtering_length, generator)
        return self

    def forward(self, xx: torch.Tensor, cell_types: Optional[torch.Tensor] = None) -> torch.Tensor:
        """xx: (B, T, X, Y, Z, F) context -> (B, X, Y, Z, F) next-step prediction."""
        B, T, X, Y, Z, Fe = xx.shape

        c_local = None
        if self.conditioning is not None and cell_types is not None:
            c_local = self.conditioning(cell_types)

        # 1. Learned spatial filter applied per (frame, channel): move channels
        # into the batch so one single-channel filter convolves each field.
        flat = xx.permute(0, 1, 5, 2, 3, 4).reshape(B * T * Fe, X, Y, Z, 1)
        u_star = self.spatial_filter(flat)
        u_star = u_star.reshape(B, T, Fe, X, Y, Z).permute(0, 1, 3, 4, 5, 2)

        # 2. Residual after spatial filtering.
        u_prime = xx - u_star

        # 3. Learned temporal filter over sliding windows of length L.
        L = self.temporal_filtering_length
        n_windows = T - L + 1
        windows = torch.stack([u_star[:, i : i + L] for i in range(n_windows)], dim=1)
        u_bar = torch.einsum("bnlxyzf,lo->bnxyzf", windows, self.temporal_filter.to(windows.dtype))

        # 4. Residual after temporal filtering; align window counts.
        u_tilde = u_star[:, -n_windows:] - u_bar
        u_prime = u_prime[:, -n_windows:]

        def stack_time(u):  # (B, n, X, Y, Z, F) -> (B, X, Y, Z, n*F)
            return u.permute(0, 2, 3, 4, 1, 5).reshape(B, X, Y, Z, n_windows * Fe)

        outs_bar = self.encoder_bar(stack_time(u_bar), c_local)
        outs_tilde = self.encoder_tilde(stack_time(u_tilde), c_local)
        outs_prime = self.encoder_prime(stack_time(u_prime), c_local)
        out1, out2, out3, out4 = [a + b + c for a, b, c in zip(outs_bar, outs_tilde, outs_prime)]

        d3 = self._Deconv_0(out4)
        d2 = self._Deconv_1(out3 + _clip_to(d3, out3.shape[-4:-1]))
        d1 = self._Deconv_2(out2 + _clip_to(d2, out2.shape[-4:-1]))
        d0 = self._Deconv_3(out1 + _clip_to(d1, out1.shape[-4:-1]))
        return self.output_layer(_clip_to(d0, (X, Y, Z)).float())
