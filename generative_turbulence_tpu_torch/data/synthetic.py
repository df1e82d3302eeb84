"""Synthetic datasets for tests, smoke runs and benchmarks.

numpy copy of ``generative_turbulence_tpu/data/synthetic.py``.
``build_case`` makes one case's geometry and fields in memory (the same
arrays for the same seed); ``generate_case`` writes them with the side files
the evaluation reads; ``generate_synthetic_dataset`` writes train/val/test
splits and the training set's ``stats.pickle`` (``compute_stats``).  Case
files are written as ``.h5`` or ``.npyd`` (``format``), with the same arrays
either way.  The flow fields are smooth random Fourier fields around a plug
inflow profile: not physical, but they exercise the grid embedding, the
boundary conditions, the normalization, the spectra and the metrics.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Sequence, Tuple

import numpy as np

from ..utils.index import ravel_multi_index
from .npyd import open_case_file, write_case_file
from .schema import (
    BCType, BoundaryCondition, CaseMetadata, FieldStats, read_metadata, write_case_h5, write_case_npyd,
)
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
    meta, fields, _ = _build_case(
        cell_counts=cell_counts, n_frames=n_frames, inflow=inflow, nu=nu, hole=hole, seed=seed
    )
    return meta, fields


def _build_case(*, cell_counts, n_frames, inflow, nu, hole, seed):
    """``build_case``, and the dense padded velocity grid (T, X, Y, Z, 3)."""
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
    return meta, fields, u_grid


FORMATS = {"h5": (".h5", write_case_h5), "npyd": (".npyd", write_case_npyd)}


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
    format: str = "h5",
) -> Path:
    """Write one synthetic case (``build_case``) into ``case_dir`` and return
    its data file.  ``format`` "h5" or "npyd" decides what the case file and
    the mean flow are written as.  Writes:

    - ``data.{h5,npyd}``: the whole case schema;
    - ``mean-flow.{h5,npyd}``: ``data/u`` and ``data/p``, the time means of
      the cell values;
    - ``regions.npz``: ``assignments``, the cell list cut into 4 contiguous
      regions (a stand-in for k-means homogeneous regions);
    - ``max-mean-tke.npy``: the x of the largest mean TKE (over y, z) at or
      behind x = 24 on the padded grid.
    """
    suffix, write = FORMATS[format]
    meta, fields, u_grid = _build_case(
        cell_counts=cell_counts, n_frames=n_frames, inflow=inflow, nu=nu, hole=hole, seed=seed,
    )
    case_dir = Path(case_dir)
    file = write(
        case_dir / f"data{suffix}",
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
    write_case_file(
        case_dir / f"mean-flow{suffix}",
        {"data/u": fields[Variable.U].mean(axis=0), "data/p": fields[Variable.P].mean(axis=0)},
    )
    n_regions = 4
    n_cells = len(meta.cell_idx)
    np.savez(case_dir / "regions.npz", assignments=(np.arange(n_cells) * n_regions // n_cells).astype(np.int64))
    u_fluc = u_grid - u_grid.mean(axis=0)
    tke = 0.5 * (u_fluc**2).sum(axis=-1).mean(axis=0)  # (X, Y, Z)
    x_cut = min(24, tke.shape[0] - 1)
    profile = tke[x_cut:].mean(axis=(1, 2))
    np.save(case_dir / "max-mean-tke.npy", float(np.argmax(profile) + x_cut))
    return file


def _numpy_curl(u: np.ndarray, h: np.ndarray) -> np.ndarray:
    """Curl of a dense (..., X, Y, Z, 3) field at interior cells, centered
    differences; leading axes (e.g. time) are kept."""

    def d(f: np.ndarray, axis: int) -> np.ndarray:
        lead = f.ndim - 3
        sl_p = [slice(None)] * lead + [slice(1, -1)] * 3
        sl_m = [slice(None)] * lead + [slice(1, -1)] * 3
        sl_p[lead + axis] = slice(2, None)
        sl_m[lead + axis] = slice(0, -2)
        return (f[tuple(sl_p)] - f[tuple(sl_m)]) / (2 * h[axis])

    ux, uy, uz = u[..., 0], u[..., 1], u[..., 2]
    return np.stack([d(uz, 1) - d(uy, 2), d(ux, 2) - d(uz, 0), d(uy, 0) - d(ux, 1)], axis=-1)


def compute_stats(train_files: Sequence[Path]) -> FieldStats:
    """Streaming min/max/mean/std over the train cases of p, u, k, nut,
    norm(u) and norm(curl), one frame at a time (the ``stats.pickle``
    protocol)."""
    acc: Dict[str, Dict[str, np.ndarray]] = {}

    def update(key: str, values: np.ndarray):
        values = values.reshape(-1, values.shape[-1]).astype(np.float64)
        entry = acc.setdefault(key, {
            "min": np.full(values.shape[-1], np.inf),
            "max": np.full(values.shape[-1], -np.inf),
            "sum": np.zeros(values.shape[-1]),
            "sumsq": np.zeros(values.shape[-1]),
            "count": np.zeros(1),
        })
        entry["min"] = np.minimum(entry["min"], values.min(axis=0))
        entry["max"] = np.maximum(entry["max"], values.max(axis=0))
        entry["sum"] += values.sum(axis=0)
        entry["sumsq"] += (values**2).sum(axis=0)
        entry["count"] += len(values)

    dense = None
    for file in train_files:
        meta = read_metadata(file)
        X, Y, Z = (int(c) for c in meta.cell_counts)
        if dense is None or dense.shape[0] != X * Y * Z:
            dense = np.zeros((X * Y * Z, 3), dtype=np.float32)
        with open_case_file(file) as f:
            for t in range(f["data/u"].shape[0]):
                u = np.asarray(f["data/u"][t], dtype=np.float32)
                update("u", u)
                for key in ("p", "k", "nut"):
                    update(key, np.asarray(f[f"data/{key}"][t], dtype=np.float32)[..., None])
                update("norm(u)", np.linalg.norm(u, axis=-1, keepdims=True))

                # Curl through the grid embedding, at unpadded interior cells.
                dense[:] = 0.0
                dense[meta.cell_idx] = u
                curl = _numpy_curl(dense.reshape(X, Y, Z, 3), meta.h)
                curl_cells = curl.reshape(-1, 3)[meta.unpadded_cell_idx]
                update("norm(curl)", np.linalg.norm(curl_cells, axis=-1, keepdims=True))

    stats: Dict[str, Dict[str, np.ndarray]] = {}
    for key, entry in acc.items():
        n = entry["count"]
        mean = entry["sum"] / n
        var = np.maximum(entry["sumsq"] / n - mean**2, 0.0)
        stats[key] = {
            "min": entry["min"].astype(np.float32),
            "max": entry["max"].astype(np.float32),
            "mean": mean.astype(np.float32),
            "std": np.sqrt(var).astype(np.float32),
        }
        for name in ("min", "max", "mean", "std"):
            if stats[key][name].shape == (1,):
                stats[key][name] = stats[key][name][0]
    return FieldStats(stats)


def generate_synthetic_dataset(
    root: Path,
    *,
    n_train_cases: int = 2,
    n_val_cases: int = 1,
    n_test_cases: int = 1,
    n_frames: int = 16,
    cell_counts: Tuple[int, int, int] = (24, 10, 10),
    inflow: float = 20.0,
    seed: int = 0,
    format: str = "h5",
) -> Path:
    """Create ``root/{train,val,test}/case-<split>-<i>/`` (``generate_case``,
    seeds counting up from ``seed``) and ``root/stats.pickle`` over the train
    cases."""
    root = Path(root)
    train_files = []
    case_seed = seed
    for split, n_cases in (("train", n_train_cases), ("val", n_val_cases), ("test", n_test_cases)):
        for i in range(n_cases):
            file = generate_case(
                root / split / f"case-{split}-{i:02d}", cell_counts=cell_counts, n_frames=n_frames,
                inflow=inflow, seed=case_seed, format=format,
            )
            case_seed += 1
            if split == "train":
                train_files.append(file)
    compute_stats(train_files).to_file(root / "stats.pickle")
    return root
