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
writes either format from the same datasets and attributes,
``replace_groups`` swaps some top-level groups of an existing file of either
format, and ``read_tree`` reads every dataset and attribute of one.  Where
``h5py`` does not import, an ``.h5`` path raises and names the ``.npyd``
format instead.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

ATTRS_FILE = "attrs.json"
SUFFIX = ".npyd"


def is_npyd(path: Union[str, Path]) -> bool:
    return Path(path).suffix == SUFFIX


def h5py_for(path: Union[str, Path]):
    """The ``h5py`` module, to read or write the HDF5 file ``path``; where it
    does not import, an error that names the ``.npyd`` format."""
    try:
        import h5py
    except ImportError as e:
        raise ModuleNotFoundError(f"{path}: the .h5 format needs h5py, which is not installed; "
                                  "use the .npyd format (--format npyd)", name="h5py") from e
    return h5py


def open_case_file(path: Union[str, Path]):
    """Open an HDF5 file or a ``.npyd`` directory for reading, by its path."""
    if is_npyd(path):
        return NpydFile(path)
    return h5py_for(path).File(path, "r")


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
    path = Path(path)
    with h5py_for(path).File(path, "w") as f:
        _write_h5_items(f, arrays, attrs)
    return path


def _write_h5_items(f, arrays: Mapping[str, np.ndarray], attrs: Optional[Mapping[str, Mapping]]) -> None:
    for name, array in arrays.items():
        f.create_dataset(name, data=np.asarray(array))
    for name, values in (attrs or {}).items():
        obj = f.require_group(name) if name and name not in f else f[name or "/"]
        for key, value in values.items():
            obj.attrs[key] = value


def _in_groups(name: str, groups: Sequence[str]) -> bool:
    return any(name == g or name.startswith(f"{g}/") for g in groups)


def replace_groups(
    path: Union[str, Path],
    groups: Sequence[str],
    arrays: Mapping[str, np.ndarray],
    attrs: Optional[Mapping[str, Mapping]] = None,
) -> Path:
    """Replace the top-level ``groups`` of an existing case file with
    ``arrays`` and ``attrs`` (as ``write_npyd`` takes them), keeping every
    other dataset and attribute: an HDF5 file in place (mode ``"a"``), a
    ``.npyd`` directory by its group directories and their entries of
    ``attrs.json``."""
    path = Path(path)
    if not is_npyd(path):
        with h5py_for(path).File(path, "a") as f:
            for group in groups:
                if group in f:
                    del f[group]
            _write_h5_items(f, arrays, attrs)
        return path
    if not path.is_dir():
        raise FileNotFoundError(f"no .npyd directory at {path}")
    kept = {name: values for name, values in read_attrs(path).items() if not _in_groups(name, groups)}
    for group in groups:
        shutil.rmtree(path / group, ignore_errors=True)
        (path / f"{group}.npy").unlink(missing_ok=True)
    return write_npyd(path, arrays, {**kept, **dict(attrs or {})})


def read_tree(path: Union[str, Path]) -> Tuple[Dict[str, np.ndarray], Dict[str, dict]]:
    """Every dataset ({path: array}) and every group's and dataset's
    attributes ({path: {name: value}}, ``""`` the root's, each group listed)
    of a case file of either format, as ``write_case_file`` takes them."""
    arrays: Dict[str, np.ndarray] = {}
    attrs: Dict[str, dict] = {}
    with open_case_file(path) as f:
        if is_npyd(path):
            def walk(group, name):
                attrs[name] = dict(group.attrs)
                for key, obj in group.items():
                    child = f"{name}/{key}" if name else key
                    if isinstance(obj, NpydGroup):
                        walk(obj, child)
                    else:
                        arrays[child] = np.asarray(obj)
                        attrs[child] = dict(obj.attrs)

            walk(f, "")
        else:
            h5py = h5py_for(path)
            attrs[""] = dict(f.attrs)

            def visit(name, obj):
                attrs[name] = dict(obj.attrs)
                if isinstance(obj, h5py.Dataset):
                    arrays[name] = obj[()]

            f.visititems(visit)
    return arrays, attrs


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
