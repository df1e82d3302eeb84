"""The on-disk case schema (``data.h5`` + ``stats.pickle``) and its host types.

numpy copy of the parts of ``generative_turbulence_tpu/data/schema.py`` that
sampling needs: cell types, boundary conditions, ``CaseMetadata`` (with the
inside mask, cell-type grid and Dirichlet table) and ``FieldStats``.  The
HDF5 layout is the same; ``h5py`` is imported only inside the functions that
read or write files, so the in-memory path runs without it.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import pickle
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.index import ravel_multi_index, unravel_index
from .variables import Variable, total_dims


class BCType(enum.Enum):
    FIXED_VALUE = "fixed-value"
    ZERO_GRADIENT = "zero-gradient"
    INLET_OUTLET = "inlet-outlet"


@dataclasses.dataclass(frozen=True)
class BoundaryCondition:
    type: BCType
    value: Optional[np.ndarray] = None  # only for FIXED_VALUE

    @staticmethod
    def from_h5(group) -> "BoundaryCondition":
        """Read from an ``h5py.Group`` holding ``@type`` and ``value``."""
        kind = group.attrs["type"]
        if isinstance(kind, bytes):
            kind = kind.decode()
        bc_type = BCType(kind)
        value = None
        if bc_type is BCType.FIXED_VALUE:
            value = np.atleast_1d(np.asarray(group["value"], dtype=np.float32))
        return BoundaryCondition(bc_type, value)

    def to_h5(self, group) -> None:
        group.attrs["type"] = self.type.value
        if self.type is BCType.FIXED_VALUE:
            group.create_dataset("value", data=np.asarray(self.value, dtype=np.float32))


# Cell types on the padded grid.  Order matters: it defines embedding indices.
CELL_TYPES = ("inside", "outside", "walls", "inlets", "outlets", "empties")
CELL_TYPE_IDS = {name: i for i, name in enumerate(CELL_TYPES)}
N_CELL_TYPES = len(CELL_TYPES)


@dataclasses.dataclass
class CaseMetadata:
    """Static geometry of one simulation case.

    ``cell_counts`` is the PADDED dense grid shape; ``cell_idx`` holds the flat
    indices (row-major over the padded grid) of the real simulation cells.
    Boundary-condition padding cells carry Dirichlet values where applicable.
    ``file`` names the case's ``data.h5``, or is None for a case built in
    memory.
    """

    file: Optional[Path]
    nu: float
    h: np.ndarray  # (3,) physical cell size
    cell_counts: np.ndarray  # (3,) padded
    cell_idx: np.ndarray  # (n_cells,) int32
    boundaries: Dict[str, Dict]  # name -> {"type": str, "idx": np.ndarray}
    boundary_conditions: Dict[Variable, Dict[str, BoundaryCondition]]
    holes: List[Tuple[np.ndarray, np.ndarray]]  # (position, size) pairs

    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n_cells(self) -> int:
        return int(len(self.cell_idx))

    @property
    def two_dimensional(self) -> bool:
        # Padding turns a single-cell axis into 3 cells.
        return int(np.min(self.cell_counts)) == 3

    @property
    def unpadded_cell_counts(self) -> np.ndarray:
        return self.cell_counts - 2

    @property
    def unpadded_cell_idx(self) -> np.ndarray:
        if "unpadded_cell_idx" not in self._cache:
            coords = unravel_index(self.cell_idx, tuple(self.cell_counts)) - 1
            self._cache["unpadded_cell_idx"] = ravel_multi_index(
                coords, tuple(self.unpadded_cell_counts)
            ).astype(np.int32)
        return self._cache["unpadded_cell_idx"]

    @property
    def inside_mask(self) -> np.ndarray:
        """(X, Y, Z) bool mask of in-domain cells on the padded grid."""
        if "inside_mask" not in self._cache:
            mask = np.zeros(int(np.prod(self.cell_counts)), dtype=bool)
            mask[self.cell_idx] = True
            self._cache["inside_mask"] = mask.reshape(tuple(self.cell_counts))
        return self._cache["inside_mask"]

    @property
    def cell_types(self) -> np.ndarray:
        """(X, Y, Z) int32 grid of CELL_TYPES ids."""
        if "cell_types" not in self._cache:
            types = np.full(
                int(np.prod(self.cell_counts)), CELL_TYPE_IDS["outside"], dtype=np.int32
            )
            types[self.cell_idx] = CELL_TYPE_IDS["inside"]
            for name, desc in self.boundaries.items():
                types[desc["idx"]] = CELL_TYPE_IDS[name]
            self._cache["cell_types"] = types.reshape(tuple(self.cell_counts))
        return self._cache["cell_types"]

    def dirichlet_table(
        self, variables: Sequence[Variable]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Combined (idx (M,), values (M, F)) arrays of all FIXED_VALUE
        boundary cells, one row block per boundary; channels of variables
        without a fixed value on that boundary hold 0."""
        key = ("dirichlet", tuple(v.key for v in variables))
        if key not in self._cache:
            F = total_dims(variables)
            idx_blocks: List[np.ndarray] = []
            val_blocks: List[np.ndarray] = []
            for name, desc in self.boundaries.items():
                start = 0
                row_vals = None
                for v in variables:
                    bc = self.boundary_conditions.get(v, {}).get(name)
                    if bc is not None and bc.type is BCType.FIXED_VALUE:
                        if row_vals is None:
                            row_vals = np.zeros((len(desc["idx"]), F), dtype=np.float32)
                        val = np.broadcast_to(bc.value, (v.dims,)).astype(np.float32)
                        row_vals[:, start : start + v.dims] = val
                    start += v.dims
                if row_vals is not None:
                    idx_blocks.append(np.asarray(desc["idx"], dtype=np.int32))
                    val_blocks.append(row_vals)
            if idx_blocks:
                idx = np.concatenate(idx_blocks)
                vals = np.concatenate(val_blocks)
            else:
                idx = np.zeros((0,), dtype=np.int32)
                vals = np.zeros((0, F), dtype=np.float32)
            self._cache[key] = (idx, vals)
        return self._cache[key]


@dataclasses.dataclass
class FieldStats:
    """Training-set statistics (``stats.pickle``): per-field min/max/mean/std,
    including derived ``norm(u)``/``norm(curl)`` entries.

    ``normalizers`` takes a mode for every variable, or per-variable modes as
    ``"u:norm-max;p:abs-max"``.  Modes: ``norm`` (std = mean of |v|),
    ``norm-std``, ``norm-max``, ``abs-max`` (std = max(|min|, |max|) per
    channel), ``mean-std`` and ``std``.
    """

    stats: Dict[str, Dict[str, np.ndarray]]

    def normalizers(
        self, variables: Sequence[Variable], mode: str
    ) -> Tuple[np.ndarray, np.ndarray]:
        if ":" in mode:
            per_var = {}
            for pair in mode.split(";"):
                name, _, m = pair.partition(":")
                per_var[Variable.from_str(name)] = m
            mode_for = per_var.__getitem__
        else:
            mode_for = lambda v: mode  # noqa: E731

        F = total_dims(variables)
        mean = np.zeros(F, dtype=np.float32)
        std = np.ones(F, dtype=np.float32)
        start = 0
        for v in variables:
            sl = slice(start, start + v.dims)
            m = mode_for(v)
            if "norm" in m:
                s = self.stats[f"norm({v.key})"]
                if m == "norm":
                    std[sl] = s["mean"]
                elif m == "norm-std":
                    mean[sl] = s["mean"]
                    std[sl] = s["std"]
                elif m == "norm-max":
                    std[sl] = s["max"]
                else:
                    raise ValueError(f"Unknown normalization mode {m!r}")
            else:
                s = self.stats[v.key]
                if m == "abs-max":
                    std[sl] = np.maximum(np.abs(s["min"]), np.abs(s["max"]))
                elif m == "mean-std":
                    mean[sl] = s["mean"]
                    std[sl] = s["std"]
                elif m == "std":
                    std[sl] = s["std"]
                else:
                    raise ValueError(f"Unknown normalization mode {m!r}")
            start += v.dims

        std = np.where(std >= 1e-8, std, 1.0).astype(np.float32)
        return mean, std

    def envelope(self, variables: Sequence[Variable]) -> Tuple[np.ndarray, np.ndarray]:
        """Channelwise training-set (min, max) envelope, physical units."""
        F = total_dims(variables)
        lo = np.empty(F, dtype=np.float32)
        hi = np.empty(F, dtype=np.float32)
        start = 0
        for v in variables:
            sl = slice(start, start + v.dims)
            s = self.stats[v.key]
            lo[sl] = np.broadcast_to(s["min"], (v.dims,))
            hi[sl] = np.broadcast_to(s["max"], (v.dims,))
            start += v.dims
        return lo, hi

    @staticmethod
    def from_file(file: Path) -> "FieldStats":
        raw = pickle.loads(Path(file).read_bytes())
        stats = {
            key: {name: np.asarray(value, dtype=np.float32) for name, value in d.items()}
            for key, d in raw.items()
        }
        return FieldStats(stats)

    def to_file(self, file: Path) -> None:
        raw = {
            key: {name: np.asarray(value) for name, value in d.items()}
            for key, d in self.stats.items()
        }
        Path(file).write_bytes(pickle.dumps(raw))


def read_metadata(file: Path) -> CaseMetadata:
    """Read the static geometry of a case from its ``data.h5``."""
    import h5py

    file = Path(file)
    with h5py.File(file, "r") as f:
        bounding_box = np.asarray(f["geometry/bounding_box"], dtype=np.float64)
        bb_cell_counts = np.asarray(f["geometry/cell_counts"], dtype=np.int64)
        nu = float(f["physical"].attrs["nu"])
        hole_pos = np.asarray(f["geometry/holes/positions"])
        hole_sizes = np.asarray(f["geometry/holes/sizes"])
        cell_counts = np.asarray(f["grid/cell_counts"], dtype=np.int64)
        cell_idx = np.asarray(f["grid/cell_idx"], dtype=np.int32)

        boundaries = {}
        for name, grp in f["grid/boundaries"].items():
            kind = grp.attrs["type"]
            if isinstance(kind, bytes):
                kind = kind.decode()
            boundaries[name] = {"type": kind, "idx": np.asarray(grp, dtype=np.int32)}

        boundary_conditions = {
            Variable.from_str(var_name): {
                bname: BoundaryCondition.from_h5(grp) for bname, grp in bcs.items()
            }
            for var_name, bcs in f["boundary-conditions"].items()
        }

    return CaseMetadata(
        file=file,
        nu=nu,
        h=(bounding_box / bb_cell_counts).astype(np.float32),
        cell_counts=cell_counts,
        cell_idx=cell_idx,
        boundaries=boundaries,
        boundary_conditions=boundary_conditions,
        holes=[(hole_pos[i], hole_sizes[i]) for i in range(len(hole_pos))],
    )


def write_case_h5(
    file: Path,
    *,
    nu: float,
    bounding_box: np.ndarray,
    unpadded_cell_counts: np.ndarray,
    cell_idx: np.ndarray,
    boundaries: Dict[str, Dict],
    boundary_conditions: Dict[Variable, Dict[str, BoundaryCondition]],
    holes: Sequence[Tuple[np.ndarray, np.ndarray]],
    times: np.ndarray,
    fields: Dict[Variable, np.ndarray],
    domain: Optional[Dict[str, np.ndarray]] = None,
) -> None:
    """Write a complete ``data.h5`` following the schema above."""
    import h5py

    file = Path(file)
    file.parent.mkdir(parents=True, exist_ok=True)
    padded = np.asarray(unpadded_cell_counts) + 2
    with h5py.File(file, "w") as f:
        f.create_group("physical").attrs["nu"] = nu

        dom = f.create_group("domain")
        for name, arr in (domain or {}).items():
            dom.create_dataset(name, data=arr)
        dom.attrs["boundaries"] = json.dumps(
            {name: desc["type"] for name, desc in boundaries.items()}
        )

        bc_group = f.create_group("boundary-conditions")
        for v, bcs in boundary_conditions.items():
            var_group = bc_group.create_group(v.key)
            for bname, bc in bcs.items():
                bc.to_h5(var_group.create_group(bname))

        data = f.create_group("data")
        data.create_dataset("times", data=np.asarray(times, dtype=np.float64))
        for v, arr in fields.items():
            arr = np.asarray(arr, dtype=np.float32)
            if arr.ndim == 3 and arr.shape[-1] == 1:
                arr = arr[..., 0]
            data.create_dataset(v.key, data=arr)

        geom = f.create_group("geometry")
        geom.create_dataset("bounding_box", data=np.asarray(bounding_box, dtype=np.float64))
        geom.create_dataset(
            "cell_counts", data=np.asarray(unpadded_cell_counts, dtype=np.int64)
        )
        holes_group = geom.create_group("holes")
        positions = [np.asarray(p) for p, _ in holes]
        sizes = [np.asarray(s) for _, s in holes]
        holes_group.create_dataset(
            "positions", data=np.stack(positions) if holes else np.zeros((0, 3))
        )
        holes_group.create_dataset(
            "sizes", data=np.stack(sizes) if holes else np.zeros((0, 3))
        )

        grid = f.create_group("grid")
        grid.create_dataset("cell_counts", data=padded.astype(np.int64))
        grid.create_dataset("cell_idx", data=np.asarray(cell_idx, dtype=np.int64))
        bgroup = grid.create_group("boundaries")
        for name, desc in boundaries.items():
            ds = bgroup.create_dataset(name, data=np.asarray(desc["idx"], dtype=np.int64))
            ds.attrs["type"] = desc["type"]
            ds.attrs["start"] = desc.get("start", 0)
            ds.attrs["n"] = len(desc["idx"])
