"""Trilinear interpolation: grid resizing and sampling at scattered points.

Port of ``generative_turbulence_tpu/ops/interp.py``.  ``resize_trilinear``:
``F.interpolate(mode="trilinear", align_corners=True)`` on a channels-first
view computes the same per-axis linear interpolation that the JAX package
writes as three dense contractions.  ``interp3`` samples a grid at arbitrary
points (the TKE spectrum reads FFT magnitudes on spheres with it).
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


def interp3(grid: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Trilinearly interpolate ``grid`` (..., X, Y, Z), values at integer
    coordinates, at ``points`` (P..., 3): returns (..., P...).  Indices clamp
    to the grid (the weights do not), as in the JAX package: each of the 8
    corners is one gather from the flattened grid."""
    X, Y, Z = grid.shape[-3:]
    upper = torch.tensor([X - 1, Y - 1, Z - 1], device=points.device)
    p0f = torch.floor(points)
    p0 = torch.minimum(p0f.long().clamp_min(0), upper)
    p1 = torch.minimum((p0 + 1).clamp_min(0), upper)
    w = points - p0f  # fractional weights in [0, 1)
    flat = grid.reshape(*grid.shape[:-3], X * Y * Z)
    lead, pshape = grid.shape[:-3], points.shape[:-1]

    def g(xi, yi, zi):
        idx = ((xi * Y + yi) * Z + zi).reshape(-1)
        return flat.index_select(-1, idx).reshape(*lead, *pshape)

    (x0, y0, z0), (x1, y1, z1) = p0.unbind(-1), p1.unbind(-1)
    wx, wy, wz = w.unbind(-1)
    return (
        (1 - wx) * (1 - wy) * (1 - wz) * g(x0, y0, z0)
        + (1 - wx) * (1 - wy) * wz * g(x0, y0, z1)
        + (1 - wx) * wy * (1 - wz) * g(x0, y1, z0)
        + (1 - wx) * wy * wz * g(x0, y1, z1)
        + wx * (1 - wy) * (1 - wz) * g(x1, y0, z0)
        + wx * (1 - wy) * wz * g(x1, y0, z1)
        + wx * wy * (1 - wz) * g(x1, y1, z0)
        + wx * wy * wz * g(x1, y1, z1)
    )
