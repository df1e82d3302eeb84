"""OpenFOAM case -> ``data.npyd`` / ``data.h5`` conversion + sparse->dense grid mapping.

``foam_case_to_h5`` is the counterpart of the reference's ``scripts/
foam2h5.py`` (mesh + per-time fields + boundary conditions -> HDF5), built on
the self-contained foam_io readers instead of fluidfoam; ``add_grid_embedding``
is the counterpart of ``scripts/grid-embedding.py`` (cell centroids -> padded
integer grid indices, boundary faces -> padding-cell indices via face
orientation).

A copy of ``generative_turbulence_tpu/toolchain/convert.py`` that writes
through the port's format layer (``data/npyd.py``): ``format="npyd"`` (the
default) writes a ``.npyd`` directory and needs no ``h5py``; ``format="h5"``
writes the same datasets and attributes as an HDF5 file, with ``h5py``
imported only there.
"""

from __future__ import annotations

import json
import re
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.npyd import SUFFIX, is_npyd, replace_groups, write_case_file
from ..utils.index import ravel_multi_index
from .foam_dicts import parse_foam_file
from .foam_io import (
    read_boundary,
    read_boundary_conditions,
    read_faces,
    read_internal_field,
    read_label_list,
    read_vector_list,
)

FIELD_NAMES = ("U", "p", "k", "nut")
FORMATS = {"npyd": SUFFIX, "h5": ".h5"}


def format_suffix(format: str) -> str:
    """The file suffix of a case file format (``"npyd"`` or ``"h5"``)."""
    if format not in FORMATS:
        raise ValueError(f"unknown format {format!r}: one of {sorted(FORMATS)}")
    return FORMATS[format]


def case_output(path: Optional[Path], default: Path, format: str) -> Path:
    """``path``, else ``default`` with the format's suffix; a path whose
    suffix names the other format is refused."""
    suffix = format_suffix(format)
    out = Path(path) if path else default.with_name(default.name + suffix)
    if is_npyd(out) != (suffix == SUFFIX):
        raise ValueError(f"{out} is not a {format} file")
    return out


def write_new_case_file(path: Path, arrays: Dict[str, np.ndarray], attrs: Dict[str, Dict]) -> Path:
    """``write_case_file`` into a fresh file: an existing ``.npyd``
    directory is removed first, as an HDF5 file opened with ``"w"`` is."""
    if is_npyd(path) and path.is_dir():
        shutil.rmtree(path)
    return write_case_file(path, arrays, attrs)


def _time_dirs(case_dir: Path) -> List[Tuple[float, Path]]:
    out = []
    for child in Path(case_dir).iterdir():
        if not child.is_dir():
            continue
        if re.fullmatch(r"\d+(\.\d+)?([eE][-+]?\d+)?", child.name):
            out.append((float(child.name), child))
    return sorted(out)


def read_mesh(case_dir: Path):
    mesh_dir = Path(case_dir) / "constant" / "polyMesh"
    points = read_vector_list(mesh_dir / "points")
    faces = read_faces(mesh_dir / "faces")
    owner = read_label_list(mesh_dir / "owner")
    neighbour = read_label_list(mesh_dir / "neighbour")
    boundary = read_boundary(mesh_dir / "boundary")
    return points, faces, owner, neighbour, boundary


def cell_face_table(faces, owner, neighbour, n_cells: int) -> List[np.ndarray]:
    """Per-cell face-id lists (owner faces first, then neighbour faces, each
    in ascending face order — the original append order), vectorized."""
    owner = np.asarray(owner, dtype=np.int64)
    neighbour = np.asarray(neighbour, dtype=np.int64)
    cf = np.concatenate([owner, neighbour])
    fi = np.concatenate(
        [np.arange(len(owner), dtype=np.int64), np.arange(len(neighbour), dtype=np.int64)]
    )
    order = np.argsort(cf, kind="stable")
    counts = np.bincount(cf, minlength=n_cells)
    return np.split(fi[order], np.cumsum(counts)[:-1])


def cell_centroids(points, faces, cells, owner=None, neighbour=None) -> np.ndarray:
    """Cell centroid, exact for our axis-aligned hexes.

    Every vertex of a hex belongs to exactly 3 of its 6 quads, so the mean
    over the 24 face-corner points (with multiplicity) equals the mean over
    the 8 unique vertices; the centroid is therefore the mean of the cell's
    face centers — computable with two vectorized scatter-adds instead of a
    per-cell ``np.unique`` loop."""
    if owner is not None:
        faces = np.asarray(faces)
        fc = points[faces].mean(axis=1)  # (F, 3) face centers
        n_cells = len(cells)
        acc = np.zeros((n_cells, 3))
        cnt = np.zeros(n_cells)
        np.add.at(acc, owner, fc)
        np.add.at(cnt, owner, 1.0)
        n_int = len(neighbour)
        np.add.at(acc, neighbour, fc[:n_int])
        np.add.at(cnt, neighbour, 1.0)
        return acc / cnt[:, None]
    # generic fallback (non-hex meshes / no owner info): unique-vertex mean
    out = np.zeros((len(cells), 3))
    for ci, face_ids in enumerate(cells):
        vids = np.unique(np.concatenate([np.asarray(faces[fi]) for fi in face_ids]))
        out[ci] = points[vids].mean(axis=0)
    return out


def read_nu(case_dir: Path) -> float:
    for name in ("physicalProperties", "transportProperties"):
        f = Path(case_dir) / "constant" / name
        if f.is_file():
            d = parse_foam_file(f)
            nu = d.get("nu")
            if nu is not None:
                value = getattr(nu, "value", nu)
                return float(value)
    raise FileNotFoundError(f"No viscosity found in {case_dir}/constant")


def boundary_dict_from_patch_table(patch_table) -> Dict[str, Dict]:
    """``build_polymesh`` patch table -> the dict ``read_boundary`` returns."""
    return {
        name: {"type": typch, "startFace": int(start), "nFaces": int(n)}
        for name, typch, start, n in patch_table
    }


def foam_case_to_h5(
    case_dir: Path,
    out_file: Optional[Path] = None,
    *,
    drop_first_time: bool = True,
    n_workers: int = 8,
    frames_override: Optional[List[Dict[str, np.ndarray]]] = None,
    times_override: Optional[List[float]] = None,
    mesh_override: Optional[tuple] = None,
    format: str = "npyd",
) -> Path:
    """Convert a solved OpenFOAM case into the ``data.h5`` schema, written as
    ``data.npyd`` or ``data.h5`` by ``format``.

    Writes: physical@nu, domain/{points,faces,face2cell,cells}@boundaries,
    boundary-conditions/<var>/<boundary>, data/times + data/{u,p,k,nut}.
    The first written time directory is dropped by default (k/nut are not yet
    initialized there, matching ``scripts/foam2h5.py:126``).
    """
    case_dir = Path(case_dir)
    out_file = case_output(out_file, case_dir / "data", format)

    if mesh_override is not None:
        # In-memory mesh from ``build_polymesh`` — skips the ASCII polyMesh
        # write + re-parse round-trip (minutes per shapes-size case).
        points, faces, owner, neighbour, patch_table, _ = mesh_override
        boundary = boundary_dict_from_patch_table(patch_table)
    else:
        points, faces, owner, neighbour, boundary = read_mesh(case_dir)
    n_cells = int(max(owner.max(), neighbour.max() if len(neighbour) else 0)) + 1
    cells = cell_face_table(faces, owner, neighbour, n_cells)

    if isinstance(faces, np.ndarray):
        assert faces.shape[1] == 4, "channel meshes must be quad-faced"
    else:
        for f in faces:
            assert len(f) == 4, "channel meshes must be quad-faced"

    if frames_override is not None:
        assert times_override is not None and len(times_override) == len(
            frames_override
        )
        times = [(t, None) for t in times_override]
    else:
        times = [(t, d) for t, d in _time_dirs(case_dir) if t > 0]
        if drop_first_time and len(times) > 1:
            times = times[1:]
        assert times, f"no solved time directories in {case_dir}"

    # Boundary conditions from the initial-condition dicts in 0/.
    zero_dir = case_dir / "0"
    bcs: Dict[str, Dict[str, Dict]] = {}
    for field in FIELD_NAMES:
        f = zero_dir / field
        if f.is_file():
            bcs[field.lower()] = read_boundary_conditions(f)

    # Read all time steps of each field (threaded: h5/file I/O bound).
    def read_time(args):
        _, tdir = args
        out = {}
        for field in FIELD_NAMES:
            f = tdir / field
            if f.is_file():
                out[field.lower()] = read_internal_field(f, n_cells)
        return out

    if frames_override is not None:
        frames = frames_override
    else:
        with ThreadPoolExecutor(max_workers=n_workers) as pool:
            frames = list(pool.map(read_time, times))

    face2cell = np.full((len(faces), 2), -1, dtype=np.int64)
    face2cell[:, 0] = owner
    face2cell[: len(neighbour), 1] = neighbour

    if isinstance(faces, np.ndarray):
        faces_arr = faces.astype(np.int64, copy=False)
    else:
        max_face_len = max(len(f) for f in faces)
        faces_arr = np.full((len(faces), max_face_len), -1, dtype=np.int64)
        for i, f in enumerate(faces):
            faces_arr[i, : len(f)] = f
    lens = np.fromiter((len(c) for c in cells), dtype=np.int64, count=n_cells)
    max_cell_faces = int(lens.max())
    cells_arr = np.full((n_cells, max_cell_faces), -1, dtype=np.int64)
    if (lens == max_cell_faces).all():
        cells_arr[:] = np.concatenate(cells).reshape(n_cells, max_cell_faces)
    else:
        for i, c in enumerate(cells):
            cells_arr[i, : len(c)] = c

    arrays: Dict[str, np.ndarray] = {}
    attrs: Dict[str, Dict] = {"physical": {"nu": read_nu(case_dir)}}

    arrays["domain/points"] = points
    arrays["domain/faces"] = faces_arr
    arrays["domain/face2cell"] = face2cell
    arrays["domain/cells"] = cells_arr
    attrs["domain"] = {"boundaries": json.dumps(
        {name: {"type": spec["type"], "startFace": spec["startFace"],
                "nFaces": spec["nFaces"]} for name, spec in boundary.items()}
    )}

    attrs["boundary-conditions"] = {}
    for var, patches in bcs.items():
        attrs[f"boundary-conditions/{var}"] = {}
        for patch, spec in patches.items():
            if spec["type"] == "empty":
                continue
            path = f"boundary-conditions/{var}/{patch}"
            attrs[path] = {"type": spec["type"]}
            if spec["type"] == "fixed-value" and spec["value"] is not None:
                value = spec["value"]
                arrays[f"{path}/value"] = value if len(value) > 1 else np.float32(value[0])

    arrays["data/times"] = np.asarray([t for t, _ in times])
    for field in FIELD_NAMES:
        key = field.lower()
        stack = np.stack([fr[key] for fr in frames if key in fr])
        if stack.shape[-1] == 1:
            stack = stack[..., 0]
        arrays[f"data/{key}"] = stack.astype(np.float32)

    return write_new_case_file(out_file, arrays, attrs)


def add_grid_embedding(
    h5_file: Path,
    case_dir: Path,
    mesh_params: Optional[dict] = None,
    mesh_override: Optional[tuple] = None,
):
    """Append the ``grid/`` and ``geometry/`` groups to a converted case
    (``data.npyd`` or ``data.h5``, by its path; the groups replaced where
    they exist).

    Maps cell centroids to integer indices on the PADDED grid (+1 offset per
    axis) and boundary faces to their adjacent padding cells via the dominant
    face-normal axis — the semantics of ``scripts/grid-embedding.py:38-90``.
    """
    case_dir = Path(case_dir)
    if mesh_params is None:
        params_file = case_dir / "mesh-params.json"
        mesh_params = json.loads(params_file.read_text())

    cell_counts = np.asarray(mesh_params["cell_counts"], dtype=np.int64)
    h = np.asarray(mesh_params["h"], dtype=np.float64)
    padded = tuple(cell_counts + 2)

    if mesh_override is not None:
        points, faces, owner, neighbour, patch_table, centroids = mesh_override
        boundary = boundary_dict_from_patch_table(patch_table)
    else:
        points, faces, owner, neighbour, boundary = read_mesh(case_dir)
        n_cells = int(max(owner.max(), neighbour.max() if len(neighbour) else 0)) + 1
        cells = cell_face_table(faces, owner, neighbour, n_cells)
        centroids = cell_centroids(points, faces, cells, owner, neighbour)
    faces = np.asarray(faces)
    owner = np.asarray(owner)

    grid_coords = np.floor(centroids / h).astype(np.int64) + 1  # +1 padding
    cell_idx = ravel_multi_index(grid_coords, padded)

    # Boundary faces -> padding cells: step from the owning cell along the
    # dominant outward normal axis (vectorized per patch).
    boundary_idx: Dict[str, np.ndarray] = {}
    for name, spec in boundary.items():
        start, n = spec["startFace"], spec["nFaces"]
        own = owner[start : start + n]
        face_centers = points[faces[start : start + n]].mean(axis=1)  # (n, 3)
        direction = (face_centers - centroids[own]) / h
        axis = np.argmax(np.abs(direction), axis=1)
        step = np.where(direction[np.arange(n), axis] > 0, 1, -1)
        coord = grid_coords[own].copy()
        coord[np.arange(n), axis] += step
        boundary_idx[name] = np.unique(ravel_multi_index(coord, padded))

    holes = mesh_params.get("holes", [])
    arrays: Dict[str, np.ndarray] = {}
    attrs: Dict[str, Dict] = {"geometry/holes": {}, "grid/boundaries": {}}
    arrays["geometry/bounding_box"] = np.asarray(mesh_params["bounding_box"])
    arrays["geometry/cell_counts"] = cell_counts
    if holes:
        arrays["geometry/holes/positions"] = np.asarray([hle["position"] for hle in holes])
        arrays["geometry/holes/sizes"] = np.asarray([hle["size"] for hle in holes])
    else:
        arrays["geometry/holes/positions"] = np.zeros((0, 3))
        arrays["geometry/holes/sizes"] = np.zeros((0, 3))

    arrays["grid/cell_counts"] = np.asarray(padded, dtype=np.int64)
    arrays["grid/cell_idx"] = cell_idx
    for name, spec in boundary.items():
        kind = {"patch": name, "wall": "walls", "empty": "empties"}.get(
            spec.get("type"), name
        )
        path = f"grid/boundaries/{name}"
        arrays[path] = boundary_idx[name]
        attrs[path] = {
            "type": kind if isinstance(kind, str) else name,
            "start": spec["startFace"],
            "n": spec["nFaces"],
        }
    return replace_groups(h5_file, ("grid", "geometry"), arrays, attrs)
