"""Sparse <-> dense grid embedding with torch index ops.

The simulation stores only in-domain cell values ``(B, n_cells, F)``; the
models work on dense padded voxel grids ``(B, X, Y, Z, F)`` (channels last).
``GridMap`` holds the per-case index tensors, on one device, that move values
between the two.  Port of ``generative_turbulence_tpu/data/grid.py`` without
its LRU cache and cell bucketing, which work around XLA recompiles.  On the
spatial axis (``parallel.spatial``) a rank works on an x slab of the dense
grid: ``x_slab_view`` gives the map its masks see there, and ``masked_mean``
sums over the group.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.spatial import Slab, sp_all_reduce_sum
from .schema import CaseMetadata
from .variables import Variable, total_dims


@dataclasses.dataclass(frozen=True)
class GridMap:
    """Index tensors of one case geometry for a fixed variable tuple.

      cell_idx        (N,)      int64 flat indices of in-domain cells
      dirichlet_idx   (M,)      int64 flat indices of fixed-value boundary cells
      dirichlet_vals  (M, F)    float32 boundary values (stacked channels)
      cell_types      (X, Y, Z) int64 cell-type ids
      inside_mask     (X, Y, Z) bool
      h               (3,)      float32 physical cell size
      slab            None, or the x slab of a rank of the spatial axis
                      (``x_slab_view``)
    """

    cell_idx: torch.Tensor
    dirichlet_idx: torch.Tensor
    dirichlet_vals: torch.Tensor
    cell_types: torch.Tensor
    inside_mask: torch.Tensor
    h: torch.Tensor
    shape: Tuple[int, int, int]
    n_features: int
    slab: Optional[Slab] = None

    @staticmethod
    def from_metadata(
        meta: CaseMetadata,
        variables: Sequence[Variable],
        *,
        device: torch.device | str = "cuda",
    ) -> "GridMap":
        d_idx, d_vals = meta.dirichlet_table(variables)
        as_long = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)  # noqa: E731
        return GridMap(
            cell_idx=as_long(meta.cell_idx),
            dirichlet_idx=as_long(d_idx),
            dirichlet_vals=torch.as_tensor(
                np.asarray(d_vals, dtype=np.float32), device=device
            ),
            cell_types=as_long(meta.cell_types),
            inside_mask=torch.as_tensor(meta.inside_mask, device=device),
            h=torch.as_tensor(np.asarray(meta.h, dtype=np.float32), device=device),
            shape=tuple(int(c) for c in meta.cell_counts),
            n_features=total_dims(variables),
        )

    @property
    def n_cells(self) -> int:
        return int(self.cell_idx.shape[0])


def embed_cells(values: torch.Tensor, grid: GridMap) -> torch.Tensor:
    """Scatter per-cell values into a dense padded grid.

    values: (..., n_cells, F) -> (..., X, Y, Z, F).  Out-of-domain cells are
    zero except fixed-value (Dirichlet) boundary cells, which get their
    prescribed values.
    """
    X, Y, Z = grid.shape
    F = values.shape[-1]
    batch = values.shape[:-2]
    flat = values.new_zeros((*batch, X * Y * Z, F))
    flat[..., grid.cell_idx, :] = values
    if grid.dirichlet_idx.numel():
        flat[..., grid.dirichlet_idx, :] = grid.dirichlet_vals.to(values.dtype)
    return flat.reshape(*batch, X, Y, Z, F)


def gather_cells(x: torch.Tensor, grid: GridMap) -> torch.Tensor:
    """Gather in-domain cell values: (..., X, Y, Z, F) -> (..., n_cells, F)."""
    return ravel_grid(x).index_select(-2, grid.cell_idx)


def ravel_grid(x: torch.Tensor) -> torch.Tensor:
    """(..., X, Y, Z, F) -> (..., X*Y*Z, F)."""
    *batch, X, Y, Z, F = x.shape
    return x.reshape(*batch, X * Y * Z, F)


def apply_inside(x: torch.Tensor, grid: GridMap) -> torch.Tensor:
    """Zero out everything but the in-domain cells."""
    return torch.where(grid.inside_mask[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))


def x_slab_view(grid: GridMap, slab: Slab) -> GridMap:
    """``grid`` as a rank of the spatial axis sees it on its ``slab``: the
    slab's ``inside_mask`` and the slab itself; the whole grid's
    ``cell_types`` (the model conditions on the whole map), ``shape``,
    ``n_cells`` and index tensors (``embed_cells`` and ``gather_cells`` work
    on whole grids)."""
    return dataclasses.replace(grid, inside_mask=grid.inside_mask[slice(*slab.planes)], slab=slab)


def masked_mean(x: torch.Tensor, grid: GridMap, *, batch_ndim: int = 1) -> torch.Tensor:
    """Mean over in-domain cells and channels, keeping leading batch axes:
    (B..., X, Y, Z, F) -> (B...,).  On an x slab of the spatial axis (with
    ``x_slab_view``'s grid) the slab's sums are summed over the group."""
    mask = grid.inside_mask[..., None].to(x.dtype)
    total = (x * mask).sum(dim=tuple(range(batch_ndim, x.ndim)))
    if grid.slab is not None:
        total = sp_all_reduce_sum(total, grid.slab.axis)
    return total / (grid.n_cells * x.shape[-1])
