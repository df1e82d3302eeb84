"""The ``.npyd`` format: an HDF5 file's datasets as a directory of ``.npy`` files.

A ``*.npyd`` directory holds one ``.npy`` file per HDF5 dataset, at the
dataset's path (``data.npyd/data/u.npy``, ``data.npyd/grid/cell_idx.npy``),
a sub-directory per group, and every attribute in one ``attrs.json`` at its
root, keyed by the path of the group or dataset that holds it (``"physical"``:
``{"nu": 1e-5}``; ``""`` is the root).  Datasets open as read-only memory
maps, so reading a few frames of ``data/u`` touches only those frames.

``open_case_file`` opens either format by its path: a ``*.npyd`` directory
with ``NpydFile``, anything else with ``h5py`` (imported there, so the
``.npyd`` path needs no ``h5py``).  ``NpydFile`` answers the parts of
``h5py``'s interface the schema uses: ``f["data/u"]``, ``f["data/u"][idx]``,
``np.asarray(f["grid/cell_idx"])``, ``.shape``, ``.attrs``, ``.keys()``, ``.items()`` (in
name order, as ``h5py`` lists them), ``in`` and ``with``.  ``write_case_file``
writes either format from the same datasets and attributes.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Iterator, Mapping, Optional, Union

import numpy as np

ATTRS_FILE = "attrs.json"
SUFFIX = ".npyd"


def is_npyd(path: Union[str, Path]) -> bool:
    return Path(path).suffix == SUFFIX


def open_case_file(path: Union[str, Path]):
    """Open an HDF5 file or a ``.npyd`` directory for reading, by its path."""
    if is_npyd(path):
        return NpydFile(path)
    import h5py

    return h5py.File(path, "r")


def read_attrs(root: Path) -> Dict[str, dict]:
    file = Path(root) / ATTRS_FILE
    return json.loads(file.read_text()) if file.is_file() else {}


def _json_value(value):
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, bytes):
        return value.decode()
    raise TypeError(f"attribute value {value!r} is not JSON")


def write_attrs(root: Path, attrs: Mapping[str, Mapping]) -> None:
    """Replace ``root/attrs.json`` (written beside it, then renamed)."""
    file = Path(root) / ATTRS_FILE
    tmp = file.with_name(f".{ATTRS_FILE}.{os.getpid()}")
    tmp.write_text(json.dumps({k: dict(v) for k, v in attrs.items()}, default=_json_value, indent=1))
    os.replace(tmp, file)


def write_npyd(
    path: Union[str, Path],
    arrays: Mapping[str, np.ndarray],
    attrs: Optional[Mapping[str, Mapping]] = None,
) -> Path:
    """Write ``arrays`` ({"data/u": array, ...}) and ``attrs`` ({"physical":
    {"nu": 1e-5}, ...}) as a ``.npyd`` directory, replacing the files it
    names.  A path in ``attrs`` that names no array is a group: it becomes a
    directory even when it holds nothing else."""
    root = Path(path)
    root.mkdir(parents=True, exist_ok=True)
    attrs = dict(attrs or {})
    for name in attrs:
        if name and name not in arrays:
            (root / name).mkdir(parents=True, exist_ok=True)
    for name, array in arrays.items():
        file = root / f"{name}.npy"
        file.parent.mkdir(parents=True, exist_ok=True)
        np.save(file, np.asarray(array))
    write_attrs(root, attrs)
    return root


def write_case_file(
    path: Union[str, Path],
    arrays: Mapping[str, np.ndarray],
    attrs: Optional[Mapping[str, Mapping]] = None,
) -> Path:
    """Write datasets and attributes (as ``write_npyd`` takes them) as a
    ``.npyd`` directory or, for any other path, as an HDF5 file."""
    if is_npyd(path):
        return write_npyd(path, arrays, attrs)
    import h5py

    path = Path(path)
    with h5py.File(path, "w") as f:
        for name, array in arrays.items():
            f.create_dataset(name, data=np.asarray(array))
        for name, values in (attrs or {}).items():
            obj = f.require_group(name) if name and name not in f else f[name or "/"]
            for key, value in values.items():
                obj.attrs[key] = value
    return path


class NpydDataset:
    """One dataset: a read-only memory map of its ``.npy`` file."""

    def __init__(self, file: Path, attrs: dict):
        self.array = np.load(file, mmap_mode="r")
        self.attrs = attrs

    @property
    def shape(self):
        return self.array.shape

    def __getitem__(self, index) -> np.ndarray:
        return np.array(self.array[index])

    def __array__(self, dtype=None, copy=None):
        return np.array(self.array, dtype=dtype)


class NpydGroup:
    """A group: a directory of datasets and groups."""

    def __init__(self, root: Path, name: str, attrs: Dict[str, dict]):
        self._root = root
        self._name = name
        self._all_attrs = attrs
        self.attrs = attrs.get(name, {})

    def _path(self, key: str) -> str:
        return f"{self._name}/{key}" if self._name else key

    def __getitem__(self, key: str):
        name = self._path(key.strip("/"))
        base = self._root / name
        if base.with_name(base.name + ".npy").is_file():
            return NpydDataset(base.with_name(base.name + ".npy"), self._all_attrs.get(name, {}))
        if base.is_dir():
            return NpydGroup(self._root, name, self._all_attrs)
        raise KeyError(f"{name!r} is not in {self._root}")

    def __contains__(self, key: str) -> bool:
        try:
            self[key]
        except KeyError:
            return False
        return True

    def keys(self):
        here = self._root / self._name
        names = {p.stem if p.suffix == ".npy" else p.name for p in here.iterdir()
                 if p.is_dir() or p.suffix == ".npy"}
        return sorted(names)

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def items(self):
        return [(key, self[key]) for key in self.keys()]


class NpydFile(NpydGroup):
    """The root group of a ``.npyd`` directory, usable as a context manager."""

    def __init__(self, path: Union[str, Path]):
        root = Path(path)
        if not root.is_dir():
            raise FileNotFoundError(f"no .npyd directory at {root}")
        super().__init__(root, "", read_attrs(root))

    def close(self) -> None:
        pass

    def __enter__(self) -> "NpydFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
