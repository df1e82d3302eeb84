"""The on-disk case schema (``data.h5`` + ``stats.pickle``), its readers and writers.

numpy copy of ``generative_turbulence_tpu/data/schema.py``: cell types,
boundary conditions, ``CaseMetadata`` (with the inside mask, cell-type grid
and Dirichlet table), ``FieldStats``, ``read_metadata``, ``CaseRepository``
and ``find_data_files``.  A case file is an HDF5 file or a ``.npyd``
directory of the same datasets and attributes (``data/npyd.py``): every
reader opens it with ``open_case_file``, which imports ``h5py`` only for an
HDF5 file, so a ``.npyd`` dataset reads without ``h5py``.  The layout:

- ``physical@nu``                              kinematic viscosity
- ``domain@boundaries``                        boundary name -> type (JSON)
- ``boundary-conditions/<var>/<boundary>``     @type + optional ``value`` dataset
- ``data/times``                               (T,) float
- ``data/{u,p,k,nut}``                         (T, n_cells[, dims]) float32
- ``geometry/{bounding_box,cell_counts}``      physical size / unpadded resolution
- ``geometry/holes/{positions,sizes}``         obstacles
- ``grid/cell_counts``                         PADDED grid shape (unpadded + 2)
- ``grid/cell_idx``                            flat indices of in-domain cells
- ``grid/boundaries/<name>``                   padding-cell index arrays, @type
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
from .npyd import SUFFIX, open_case_file, write_case_file
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
        """Read from a group (HDF5 or ``.npyd``) holding ``@type`` and ``value``."""
        kind = group.attrs["type"]
        if isinstance(kind, bytes):
            kind = kind.decode()
        bc_type = BCType(kind)
        value = None
        if bc_type is BCType.FIXED_VALUE:
            value = np.atleast_1d(np.asarray(group["value"], dtype=np.float32))
        return BoundaryCondition(bc_type, value)


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
    ``file`` names the case's ``data.h5`` or ``data.npyd``, or is None for a
    case built in memory.
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
    def case_name(self) -> str:
        return self.file.parent.name

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



def case_file(case_dir: Path, stem: str = "data") -> Optional[Path]:
    """A case's ``<stem>.npyd`` directory, else its ``<stem>.h5``, else None.

    One fixed rule: where a case directory holds both formats, the ``.npyd``
    is taken (it reads without ``h5py``, and a conversion writes it beside the
    ``.h5`` it came from)."""
    case_dir = Path(case_dir)
    npyd, h5 = case_dir / f"{stem}{SUFFIX}", case_dir / f"{stem}.h5"
    if npyd.is_dir():
        return npyd
    return h5 if h5.is_file() else None


def find_data_files(cases_root: Path) -> List[Path]:
    """Each case directory's data file under ``cases_root``, in name order
    (``case_file``: ``data.npyd`` where there is one, else ``data.h5``)."""
    found = (case_file(child) for child in sorted(Path(cases_root).iterdir()) if child.is_dir())
    return [file for file in found if file is not None]


def read_metadata(file: Path) -> CaseMetadata:
    """Read the static geometry of a case from its ``data.h5`` or ``data.npyd``."""
    file = Path(file)
    with open_case_file(file) as f:
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


class CaseRepository:
    """Reader over a list of case data files (``data.h5`` or ``data.npyd``).

    Per-file metadata and time arrays are cached.  Frame reads take the
    sorted unique frames (HDF5's fancy indexing needs them increasing; a
    ``.npyd`` memory map reads only those rows) and put them back in the
    asked order with the inverse index.
    """

    def __init__(self, files: Sequence[Path], variables: Sequence[Variable]):
        self.files = [Path(f) for f in files]
        self.variables = tuple(variables)
        self.reset_caches()

    def reset_caches(self) -> None:
        self._metadata: Dict[int, CaseMetadata] = {}
        self._times: Optional[List[np.ndarray]] = None

    @property
    def n_cases(self) -> int:
        return len(self.files)

    @property
    def times(self) -> List[np.ndarray]:
        if self._times is None:
            self._times = []
            for file in self.files:
                with open_case_file(file) as f:
                    self._times.append(np.array(f["data/times"]))
        return self._times

    def read_metadata(self, file_idx: int) -> CaseMetadata:
        if file_idx not in self._metadata:
            self._metadata[file_idx] = read_metadata(self.files[file_idx])
        return self._metadata[file_idx]

    def read_frames(self, file_idx: int, sample_idxs: Sequence[int]) -> Dict[Variable, np.ndarray]:
        """Read frames as {Variable: (B, n_cells, dims) float32}."""
        unique_sorted, inverse = np.unique(np.asarray(sample_idxs), return_inverse=True)
        out = {}
        with open_case_file(self.files[file_idx]) as f:
            group = f["data"]
            for v in self.variables:
                arr = np.asarray(group[v.key][unique_sorted.tolist()], dtype=np.float32)
                if arr.ndim == 2:
                    arr = arr[..., None]
                out[v] = arr[inverse]
        return out

    def read(self, file_idx: int, sample_idxs: Sequence[int]):
        from .dataset import CaseData  # local import to avoid a cycle

        return CaseData(
            metadata=self.read_metadata(file_idx),
            t=self.times[file_idx][np.asarray(sample_idxs)],
            fields=self.read_frames(file_idx, sample_idxs),
        )


def case_layout(
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
) -> Tuple[Dict[str, np.ndarray], Dict[str, Dict]]:
    """A case's datasets ({path: array}) and attributes ({path: {name:
    value}}) following the schema above, for ``write_case_file``."""
    arrays: Dict[str, np.ndarray] = {}
    attrs: Dict[str, Dict] = {"physical": {"nu": nu}}
    for name, arr in (domain or {}).items():
        arrays[f"domain/{name}"] = arr
    attrs["domain"] = {
        "boundaries": json.dumps({name: desc["type"] for name, desc in boundaries.items()})
    }
    for v, bcs in boundary_conditions.items():
        attrs[f"boundary-conditions/{v.key}"] = {}
        for bname, bc in bcs.items():
            path = f"boundary-conditions/{v.key}/{bname}"
            attrs[path] = {"type": bc.type.value}
            if bc.type is BCType.FIXED_VALUE:
                arrays[f"{path}/value"] = np.asarray(bc.value, dtype=np.float32)

    arrays["data/times"] = np.asarray(times, dtype=np.float64)
    for v, arr in fields.items():
        arr = np.asarray(arr, dtype=np.float32)
        if arr.ndim == 3 and arr.shape[-1] == 1:
            arr = arr[..., 0]
        arrays[f"data/{v.key}"] = arr

    arrays["geometry/bounding_box"] = np.asarray(bounding_box, dtype=np.float64)
    arrays["geometry/cell_counts"] = np.asarray(unpadded_cell_counts, dtype=np.int64)
    arrays["geometry/holes/positions"] = (
        np.stack([np.asarray(p) for p, _ in holes]) if holes else np.zeros((0, 3))
    )
    arrays["geometry/holes/sizes"] = (
        np.stack([np.asarray(s) for _, s in holes]) if holes else np.zeros((0, 3))
    )

    arrays["grid/cell_counts"] = (np.asarray(unpadded_cell_counts) + 2).astype(np.int64)
    arrays["grid/cell_idx"] = np.asarray(cell_idx, dtype=np.int64)
    for name, desc in boundaries.items():
        path = f"grid/boundaries/{name}"
        arrays[path] = np.asarray(desc["idx"], dtype=np.int64)
        attrs[path] = {"type": desc["type"], "start": desc.get("start", 0), "n": len(desc["idx"])}
    return arrays, attrs


def write_case_h5(file: Path, **case) -> Path:
    """Write a complete ``data.h5`` (``case_layout``'s arguments)."""
    return _write_case(Path(file), ".h5", case)


def write_case_npyd(file: Path, **case) -> Path:
    """Write a complete ``data.npyd`` (``case_layout``'s arguments): the same
    datasets and attributes as ``write_case_h5``."""
    return _write_case(Path(file), SUFFIX, case)


def _write_case(file: Path, suffix: str, case: dict) -> Path:
    if file.suffix != suffix:
        raise ValueError(f"{file} does not end in {suffix}")
    file.parent.mkdir(parents=True, exist_ok=True)
    return write_case_file(file, *case_layout(**case))
