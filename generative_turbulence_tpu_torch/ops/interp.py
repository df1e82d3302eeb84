"""Align-corners trilinear resizing of channels-last grids.

Port of ``generative_turbulence_tpu/ops/interp.py::resize_trilinear`` and
``downsample_size``: ``F.interpolate(mode="trilinear", align_corners=True)``
on a channels-first view computes the same per-axis linear interpolation that
the JAX package writes as three dense contractions.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def resize_trilinear(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Resize the spatial axes of (B, X, Y, Z, C) to ``size`` (align corners)."""
    size = tuple(int(s) for s in size)
    if tuple(x.shape[-4:-1]) == size:
        return x
    y = F.interpolate(x.permute(0, 4, 1, 2, 3), size=size, mode="trilinear", align_corners=True)
    return y.permute(0, 2, 3, 4, 1)


def downsample_size(
    shape: Tuple[int, int, int], factor: float = 2.0, floor: int = 3
) -> Tuple[int, ...]:
    """Next-level U-Net size: max(int(s / factor), floor) per axis."""
    return tuple(max(int(s / factor), floor) for s in shape)
