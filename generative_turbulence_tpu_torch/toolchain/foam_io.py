"""OpenFOAM polyMesh + field file I/O (ascii), numpy-backed.

Replaces the reference's dependency on the external ``fluidfoam`` reader
(``scripts/foam2h5.py:84-114``) with a self-contained implementation, and adds
a WRITER so the pure-python mesher can emit complete polyMesh directories —
i.e. a blockMesh equivalent for this framework's restricted (axis-aligned
voxel) geometries, letting the full data pipeline run without OpenFOAM.

A copy of ``generative_turbulence_tpu/toolchain/foam_io.py`` (host numpy,
no JAX): the same names, defaults and results.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from .foam_dicts import Field, FoamDict, parse_foam_file


def _foam_header(obj: str, cls: str = "dictionary", location: Optional[str] = None) -> str:
    loc = f'    location "{location}";\n' if location else ""
    return (
        "FoamFile\n{\n"
        "    version 2.0;\n"
        "    format ascii;\n"
        f"    class {cls};\n"
        f"{loc}"
        f"    object {obj};\n"
        "}\n\n"
    )


def _strip_header(text: str) -> str:
    """Remove comments and the FoamFile header block."""
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.DOTALL)
    text = re.sub(r"//[^\n]*", " ", text)
    m = re.search(r"FoamFile\s*\{[^}]*\}", text)
    if m:
        text = text[m.end():]
    return text


def read_vector_list(path: Path) -> np.ndarray:
    """Read a ``pointField``-style file: N ( (x y z) ... ) -> (N, 3)."""
    text = _strip_header(Path(path).read_text())
    m = re.search(r"(\d+)\s*\(", text)
    n = int(m.group(1))
    body = text[m.end():]
    numbers = np.fromstring(
        body.replace("(", " ").replace(")", " "), sep=" ", dtype=np.float64
    )
    return numbers[: 3 * n].reshape(n, 3)


def read_label_list(path: Path) -> np.ndarray:
    """Read a labelList file: N ( a b c ... ) -> (N,)."""
    text = _strip_header(Path(path).read_text())
    m = re.search(r"(\d+)\s*\(", text)
    n = int(m.group(1))
    body = text[m.end():]
    numbers = np.fromstring(body.replace(")", " "), sep=" ", dtype=np.int64)
    return numbers[:n]


def read_faces(path: Path) -> List[np.ndarray]:
    """Read a faceList: N ( 4(a b c d) ... ) -> list of vertex-id arrays."""
    text = _strip_header(Path(path).read_text())
    m = re.search(r"(\d+)\s*\(", text)
    n = int(m.group(1))
    body = text[m.end():]
    faces = []
    for fm in re.finditer(r"(\d+)\s*\(([^)]*)\)", body):
        count = int(fm.group(1))
        ids = np.fromstring(fm.group(2), sep=" ", dtype=np.int64)
        assert len(ids) == count
        faces.append(ids)
        if len(faces) == n:
            break
    return faces


def read_boundary(path: Path) -> Dict[str, Dict]:
    """Read the boundary file -> {patch: {type, nFaces, startFace}}."""
    text = _strip_header(Path(path).read_text())
    out: Dict[str, Dict] = {}
    for m in re.finditer(r"(\w+)\s*\{([^}]*)\}", text):
        name, body = m.group(1), m.group(2)
        entry = {}
        for em in re.finditer(r"(\w+)\s+([^;]+);", body):
            key, value = em.group(1), em.group(2).strip()
            entry[key] = int(value) if value.isdigit() else value
        if "nFaces" in entry:
            out[name] = entry
    return out


def read_internal_field(path: Path, n_cells: Optional[int] = None) -> np.ndarray:
    """Read a volField's internalField -> (n_cells, dims) float32."""
    text = _strip_header(Path(path).read_text())
    m = re.search(r"internalField\s+(uniform|nonuniform)", text)
    if m is None:
        raise ValueError(f"No internalField in {path}")
    if m.group(1) == "uniform":
        rest = text[m.end():]
        vm = re.match(r"\s*(\(([^)]*)\)|[-\d.eE+]+)\s*;", rest)
        if vm.group(2) is not None:
            value = np.fromstring(vm.group(2), sep=" ", dtype=np.float64)
        else:
            value = np.asarray([float(vm.group(1))])
        assert n_cells is not None, "uniform field needs n_cells"
        return np.tile(value, (n_cells, 1)).astype(np.float32)
    rest = text[m.end():]
    lm = re.search(r"(\d+)\s*\(", rest)
    n = int(lm.group(1))
    body = rest[lm.end():]
    end = body.find(";")
    chunk = body[:end] if end != -1 else body
    numbers = np.fromstring(
        chunk.replace("(", " ").replace(")", " "), sep=" ", dtype=np.float64
    )
    dims = len(numbers) // n
    return numbers[: n * dims].reshape(n, dims).astype(np.float32)


def read_boundary_conditions(path: Path) -> Dict[str, Dict]:
    """Parse the ``boundaryField`` of a field file -> {patch: {"type":...,
    "value": np.ndarray|None}} with OpenFOAM types normalized to the HDF5
    schema vocabulary (fixed-value / zero-gradient / inlet-outlet), mirroring
    ``scripts/foam2h5.py:134-152`` (noSlip -> fixed-value 0)."""
    d = parse_foam_file(path)
    bf = d.get("boundaryField", FoamDict())
    out = {}
    for patch, spec in bf.items():
        if not isinstance(spec, dict):
            continue
        foam_type = str(spec.get("type", "zeroGradient"))
        value = None
        if foam_type == "fixedValue":
            value = _field_value(spec.get("value"))
            kind = "fixed-value"
        elif foam_type == "noSlip":
            kind = "fixed-value"
            value = np.zeros(3, dtype=np.float32)
        elif foam_type == "inletOutlet":
            kind = "inlet-outlet"
        elif foam_type in ("zeroGradient", "empty", "calculated", "nutkWallFunction"):
            kind = "zero-gradient" if foam_type != "empty" else "empty"
        else:
            kind = "zero-gradient"
        out[patch] = {"type": kind, "value": value}
    return out


def _field_value(value) -> Optional[np.ndarray]:
    if isinstance(value, Field) and value.uniform:
        v = value.value
        if isinstance(v, (list, tuple)):
            return np.asarray(v, dtype=np.float32)
        return np.asarray([v], dtype=np.float32)
    return None


# ---- writers -----------------------------------------------------------------


def write_vector_list(path: Path, obj: str, cls: str, values: np.ndarray):
    values = np.asarray(values, dtype=np.float64)
    lines = [_foam_header(obj, cls, "constant/polyMesh"), str(len(values)), "("]
    lines += [f"({v[0]} {v[1]} {v[2]})" for v in values]
    lines += [")", ""]
    Path(path).write_text("\n".join(lines))


def write_label_list(path: Path, obj: str, values: np.ndarray):
    values = np.asarray(values, dtype=np.int64)
    lines = [_foam_header(obj, "labelList", "constant/polyMesh"), str(len(values)), "("]
    lines += [str(v) for v in values]
    lines += [")", ""]
    Path(path).write_text("\n".join(lines))


def write_faces(path: Path, faces: List[Tuple[int, ...]]):
    lines = [_foam_header("faces", "faceList", "constant/polyMesh"), str(len(faces)), "("]
    lines += ["{}({})".format(len(f), " ".join(str(i) for i in f)) for f in faces]
    lines += [")", ""]
    Path(path).write_text("\n".join(lines))


def write_boundary(path: Path, patches: List[Tuple[str, str, int, int]]):
    """patches: list of (name, type, startFace, nFaces)."""
    lines = [_foam_header("boundary", "polyBoundaryMesh", "constant/polyMesh")]
    lines += [str(len(patches)), "("]
    for name, kind, start, n in patches:
        lines += [
            f"    {name}",
            "    {",
            f"        type {kind};",
            f"        nFaces {n};",
            f"        startFace {start};",
            "    }",
        ]
    lines += [")", ""]
    Path(path).write_text("\n".join(lines))


def write_field(
    path: Path,
    name: str,
    values: np.ndarray,
    boundary_field: Dict[str, Dict],
    dimensions: str,
):
    """Write a volScalarField / volVectorField time file."""
    values = np.asarray(values)
    is_vector = values.ndim == 2 and values.shape[1] == 3
    cls = "volVectorField" if is_vector else "volScalarField"
    lines = [_foam_header(name, cls), f"dimensions {dimensions};", ""]
    n = len(values)
    kind = "vector" if is_vector else "scalar"
    lines.append(f"internalField nonuniform List<{kind}>")
    lines.append(str(n))
    lines.append("(")
    if is_vector:
        lines += [f"({v[0]} {v[1]} {v[2]})" for v in values]
    else:
        vals = values.reshape(-1)
        lines += [str(v) for v in vals]
    lines += [")", ";", "", "boundaryField", "{"]
    for patch, spec in boundary_field.items():
        lines.append(f"    {patch}")
        lines.append("    {")
        lines.append(f"        type {spec['type']};")
        if "value" in spec and spec["value"] is not None:
            v = spec["value"]
            if np.ndim(v) > 0 and len(np.atleast_1d(v)) == 3:
                v = np.atleast_1d(v)
                lines.append(f"        value uniform ({v[0]} {v[1]} {v[2]});")
            else:
                lines.append(f"        value uniform {float(np.atleast_1d(v)[0])};")
        if "inletValue" in spec and spec["inletValue"] is not None:
            v = np.atleast_1d(spec["inletValue"])
            if len(v) == 3:
                lines.append(f"        inletValue uniform ({v[0]} {v[1]} {v[2]});")
            else:
                lines.append(f"        inletValue uniform {float(v[0])};")
        lines.append("    }")
    lines += ["}", ""]
    Path(path).write_text("\n".join(lines))
