"""Synthetic case generator for tests, smoke runs and benchmarks.

numpy copy of ``generative_turbulence_tpu/data/synthetic.py::generate_case``,
split in two: ``build_case`` makes the geometry and the fields in memory
(the same arrays for the same seed), and ``generate_case`` writes them as a
``data.h5``.  The flow fields are smooth random Fourier fields around a plug
inflow profile: not physical, but they exercise the grid embedding, the
boundary conditions and the normalization.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from ..utils.index import ravel_multi_index
from .schema import BCType, BoundaryCondition, CaseMetadata, write_case_h5
from .variables import Variable

# The shapes dataset's physical cell size.
CELL_SIZE = 0.4 / 192


def _boundary_indices(
    inside: np.ndarray, padded: Tuple[int, int, int]
) -> Dict[str, np.ndarray]:
    """Classify non-domain cells adjacent (6-neighbourhood) to the domain into
    inlets/outlets/walls (and empties on the flat faces of 2D cases)."""
    X, Y, Z = padded
    adjacent = np.zeros_like(inside)
    for axis in range(3):
        for shift in (-1, 1):
            adjacent |= np.roll(inside, shift, axis=axis)
    boundary = adjacent & ~inside

    coords = np.argwhere(boundary)
    names = np.full(len(coords), "walls", dtype=object)
    names[coords[:, 0] == 0] = "inlets"
    names[coords[:, 0] == X - 1] = "outlets"
    for a in [a for a, n in enumerate(padded) if n == 3]:
        on_flat_face = (coords[:, a] == 0) | (coords[:, a] == padded[a] - 1)
        names[on_flat_face] = "empties"

    out: Dict[str, np.ndarray] = {}
    for name in ("inlets", "outlets", "walls", "empties"):
        sel = names == name
        if sel.any():
            out[name] = ravel_multi_index(coords[sel], padded).astype(np.int64)
    return out


def _smooth_field(
    rng: np.random.Generator,
    n_frames: int,
    shape: Tuple[int, int, int],
    n_channels: int,
    n_modes: int = 6,
) -> np.ndarray:
    """Random band-limited space-time field, (T, X, Y, Z, C)."""
    X, Y, Z = shape
    x = np.linspace(0, 2 * np.pi, X, endpoint=False)
    y = np.linspace(0, 2 * np.pi, Y, endpoint=False)
    z = np.linspace(0, 2 * np.pi, Z, endpoint=False)
    t = np.linspace(0, 2 * np.pi, n_frames, endpoint=False)
    field = np.zeros((n_frames, X, Y, Z, n_channels), dtype=np.float64)
    for c in range(n_channels):
        for _ in range(n_modes):
            kx, ky, kz, kt = rng.integers(1, 4, size=4)
            phase = rng.uniform(0, 2 * np.pi, size=4)
            amp = rng.uniform(0.2, 1.0) / n_modes
            field[..., c] += amp * (
                np.sin(kt * t + phase[3])[:, None, None, None]
                * np.sin(kx * x + phase[0])[None, :, None, None]
                * np.sin(ky * y + phase[1])[None, None, :, None]
                * np.sin(kz * z + phase[2])[None, None, None, :]
            )
    return field.astype(np.float32)


def _boundary_conditions(boundaries, inflow: float):
    fixed = lambda *v: BoundaryCondition(BCType.FIXED_VALUE, np.array(v, dtype=np.float32))  # noqa: E731
    zero_grad = BoundaryCondition(BCType.ZERO_GRADIENT)
    bcs: Dict[Variable, Dict[str, BoundaryCondition]] = {
        Variable.U: {}, Variable.P: {}, Variable.K: {}, Variable.NUT: {},
    }
    if "inlets" in boundaries:
        bcs[Variable.U]["inlets"] = fixed(inflow, 0.0, 0.0)
        bcs[Variable.P]["inlets"] = zero_grad
        bcs[Variable.K]["inlets"] = fixed(1e-3)
        bcs[Variable.NUT]["inlets"] = zero_grad
    if "walls" in boundaries:
        bcs[Variable.U]["walls"] = fixed(0.0, 0.0, 0.0)
        bcs[Variable.P]["walls"] = zero_grad
        bcs[Variable.K]["walls"] = fixed(0.0)
        bcs[Variable.NUT]["walls"] = fixed(0.0)
    if "outlets" in boundaries:
        bcs[Variable.U]["outlets"] = BoundaryCondition(BCType.INLET_OUTLET)
        bcs[Variable.P]["outlets"] = fixed(0.0)
        bcs[Variable.K]["outlets"] = zero_grad
        bcs[Variable.NUT]["outlets"] = zero_grad
    return bcs


def build_case(
    *,
    cell_counts: Tuple[int, int, int] = (24, 10, 10),
    n_frames: int = 1,
    inflow: float = 20.0,
    nu: float = 1e-5,
    hole: bool = True,
    seed: int = 0,
) -> Tuple[CaseMetadata, Dict[Variable, np.ndarray]]:
    """One synthetic case in memory: its geometry and ``n_frames`` frames of
    u, p, k, nut as {Variable: (n_frames, n_cells, dims) float32}.

    The returned ``CaseMetadata`` holds the same arrays that ``read_metadata``
    gives for the ``data.h5`` that ``generate_case`` writes with these
    arguments (its ``file`` is None).
    """
    rng = np.random.default_rng(seed)
    nx, ny, nz = cell_counts
    padded = (nx + 2, ny + 2, nz + 2)

    inside = np.zeros(padded, dtype=bool)
    inside[1 : nx + 1, 1 : ny + 1, 1 : nz + 1] = True

    holes = []
    if hole and min(ny, nz) >= 6:
        # A box obstacle in the front third of the channel.
        hx = max(2, nx // 8)
        hy, hz = max(2, ny // 3), max(2, nz // 3)
        ox = max(2, nx // 4)
        oy, oz = (ny - hy) // 2 + 1, (nz - hz) // 2 + 1
        inside[ox : ox + hx, oy : oy + hy, oz : oz + hz] = False
        holes.append(
            (
                np.array([ox - 1, oy - 1, oz - 1], dtype=np.int64),
                np.array([hx, hy, hz], dtype=np.int64),
            )
        )

    cell_idx = np.flatnonzero(inside.reshape(-1)).astype(np.int64)
    boundaries = {
        name: {"type": name, "idx": idx.astype(np.int32)}
        for name, idx in _boundary_indices(inside, padded).items()
    }

    # Fields on the dense padded grid, then gathered at in-domain cells.
    u_grid = _smooth_field(rng, n_frames, padded, 3) * 0.3 * inflow
    u_grid[..., 0] += inflow  # plug flow in x
    p_grid = _smooth_field(rng, n_frames, padded, 1) * 0.5 * inflow
    k_grid = np.abs(_smooth_field(rng, n_frames, padded, 1)) * 0.05 * inflow
    nut_grid = np.abs(_smooth_field(rng, n_frames, padded, 1)) * nu * 10

    def gather(grid: np.ndarray) -> np.ndarray:
        return grid.reshape(n_frames, -1, grid.shape[-1])[:, cell_idx, :]

    fields = {
        Variable.U: gather(u_grid),
        Variable.P: gather(p_grid),
        Variable.K: gather(k_grid),
        Variable.NUT: gather(nut_grid),
    }
    bounding_box = np.array([nx, ny, nz], dtype=np.float64) * CELL_SIZE
    meta = CaseMetadata(
        file=None,
        nu=nu,
        h=(bounding_box / np.array(cell_counts, dtype=np.int64)).astype(np.float32),
        cell_counts=np.array(padded, dtype=np.int64),
        cell_idx=cell_idx.astype(np.int32),
        boundaries=boundaries,
        boundary_conditions=_boundary_conditions(boundaries, inflow),
        holes=holes,
    )
    return meta, fields


def generate_case(
    case_dir: Path,
    *,
    cell_counts: Tuple[int, int, int] = (24, 10, 10),
    n_frames: int = 16,
    inflow: float = 20.0,
    nu: float = 1e-5,
    dt: float = 1e-4,
    hole: bool = True,
    seed: int = 0,
) -> Path:
    """Write one synthetic case (``build_case``) into ``case_dir/data.h5``.

    Only ``data.h5``: the evaluation side files of the JAX generator
    (mean flow, regions, max-mean-TKE position) belong to the evaluation port.
    """
    meta, fields = build_case(
        cell_counts=cell_counts, n_frames=n_frames, inflow=inflow, nu=nu,
        hole=hole, seed=seed,
    )
    file = Path(case_dir) / "data.h5"
    write_case_h5(
        file,
        nu=nu,
        bounding_box=np.array(cell_counts, dtype=np.float64) * CELL_SIZE,
        unpadded_cell_counts=np.array(cell_counts),
        cell_idx=meta.cell_idx,
        boundaries=meta.boundaries,
        boundary_conditions=meta.boundary_conditions,
        holes=meta.holes,
        times=(np.arange(n_frames) + 1) * dt,
        fields=fields,
    )
    return file
