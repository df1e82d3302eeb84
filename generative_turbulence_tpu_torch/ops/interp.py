"""Trilinear interpolation: grid resizing and sampling at scattered points.

Port of ``generative_turbulence_tpu/ops/interp.py``.  ``resize_trilinear``:
``F.interpolate(mode="trilinear", align_corners=True)`` on a channels-first
view computes the same per-axis linear interpolation that the JAX package
writes as three dense contractions.  On the spatial axis
(``parallel.spatial``) each rank resizes its x slab: its output planes from
the input planes the global align-corners map reads, those beyond its slab
fetched from the ranks that hold them.  ``interp3`` samples a grid at
arbitrary points (the TKE spectrum reads FFT magnitudes on spheres with it).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.spatial import Slab, fetch_planes, x_slab


def resize_trilinear(x: torch.Tensor, size: Sequence[int], *, slab: Optional[Slab] = None) -> torch.Tensor:
    """Resize the spatial axes of (B, X, Y, Z, C) to ``size`` (align corners).

    With ``slab``, x is this rank's x slab of the spatial axis and ``size``
    the global output size; the result is this rank's slab of the output."""
    size = tuple(int(s) for s in size)
    if slab is not None:
        return _resize_slab(x, size, slab)
    if tuple(x.shape[-4:-1]) == size:
        return x
    y = F.interpolate(x.permute(0, 4, 1, 2, 3), size=size, mode="trilinear", align_corners=True)
    return y.permute(0, 2, 3, 4, 1)


def _x_source_planes(x_in: int, x_out: int, start: int, stop: int):
    """The align-corners map of output planes ``[start, stop)`` onto an
    axis of ``x_in`` planes, in ``F.interpolate``'s f32 arithmetic: the lower
    input plane of each, the upper one, and the upper one's weight."""
    scale = np.float32(x_in - 1) / np.float32(x_out - 1) if x_out > 1 else np.float32(0)
    src = scale * np.arange(start, stop, dtype=np.float32)
    lo = np.floor(src).astype(np.int64)
    hi = lo + (lo < x_in - 1)
    return lo, hi, (src - lo).astype(np.float32)


def _resize_slab(x: torch.Tensor, size: Tuple[int, int, int], slab: Slab) -> torch.Tensor:
    """``resize_trilinear`` of one rank's x slab: x by the global map over
    the fetched planes, then y and z by ``F.interpolate``."""
    X, axis, Xo = slab.X, slab.axis, size[0]
    if Xo < axis.size:
        raise ValueError(f"resize_trilinear: {Xo} output x-planes do not split over {axis.size} ranks")
    needs = []
    for r in range(axis.size):
        lo, hi, _ = _x_source_planes(X, Xo, *x_slab(Xo, r, axis.size))
        needs.append((int(lo.min()), int(hi.max()) + 1))
    left, right = fetch_planes(x, X, needs, axis)
    s, _ = axis.slab(X)
    first = s - left.shape[1]  # the global index of plane 0 below
    planes = torch.cat([left, x, right], dim=1)
    lo, hi, w = _x_source_planes(X, Xo, *axis.slab(Xo))
    index = lambda p: torch.as_tensor(p - first, device=x.device)  # noqa: E731
    wt = torch.as_tensor(w, device=x.device).reshape(1, -1, 1, 1, 1)
    h = planes.float()
    h = h.index_select(1, index(lo)) * (1 - wt) + h.index_select(1, index(hi)) * wt
    if tuple(h.shape[2:4]) != tuple(size[1:]):
        B, n, Y, Z, C = h.shape
        h = F.interpolate(h.reshape(B * n, Y, Z, C).permute(0, 3, 1, 2), size=size[1:], mode="bilinear",
                          align_corners=True)
        h = h.permute(0, 2, 3, 1).reshape(B, n, *size[1:], C)
    return h.to(x.dtype)


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
