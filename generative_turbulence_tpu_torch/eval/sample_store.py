"""Appendable store of generated samples, grouped per case.

Port of ``generative_turbulence_tpu/eval/sample_store.py``, in two formats
with one schema, chosen by the store's file name:

- ``*.h5`` (through ``h5py``, the JAX package's file, which it reads)::

      <case_name>/data/<var>   (n, n_cells[, dims]) resizable, chunk = 1 sample
      <case_name>/data@n_samples

- ``*.npyd`` (no ``h5py``; ``data/npyd.py``): every ``add_samples`` writes
  one chunk per variable, ``<case_name>/data/<var>-<start>.npy`` holding
  samples ``start, start + 1, ...``, and ``attrs.json`` holds
  ``"<case_name>/data": {"n_samples": n}``.  A ``<var>.npy`` (a converted
  ``.h5`` store) is the chunk at 0 where no ``<var>-0.npy`` is.

An ``.h5`` store where ``h5py`` does not import (the card's machine) is
refused when the store is made, with a message that names ``.npyd``.

``reset()`` sets every ``n_samples`` to 0 without deleting data: later
samples overwrite it.  The first ``n_samples`` samples are the store's; the
``.npyd`` reader follows the chunks from 0, each starting where the last
ended, so a chunk left from before a reset is never read.  In a
multi-process ``torch.distributed`` run rank r > 0 writes its own file, with
a ``.rank<r>`` suffix.  Callers pass in-domain cell values.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from ..data.dataset import CaseData
from ..data.npyd import is_npyd, read_attrs, write_attrs
from ..data.schema import CaseMetadata
from ..data.variables import Variable, channel_slices
from ..parallel.distributed import process_rank_and_world


class SampleStore:
    def __init__(self, samples_file: Path, variables: Sequence[Variable]):
        rank, world = process_rank_and_world()
        self.rank = rank if world > 1 else 0
        samples_file = Path(samples_file)
        if self.rank > 0:
            samples_file = samples_file.with_name(f"{samples_file.stem}.rank{self.rank}{samples_file.suffix}")
        self.samples_file = samples_file
        self.variables = tuple(variables)
        self.npyd = is_npyd(samples_file)
        if not self.npyd:
            try:
                import h5py  # noqa: F401
            except ImportError as e:
                raise ModuleNotFoundError(f"{samples_file}: an .h5 sample store needs h5py, which is not "
                                          "installed; name a .npyd store instead", name="h5py") from e
        self.samples_file.parent.mkdir(parents=True, exist_ok=True)

    def add_samples(self, cells: np.ndarray, metadata: CaseMetadata) -> None:
        """cells: (B, n_cells, F) stacked channel values at in-domain cells."""
        cells = np.asarray(cells)[:, : metadata.n_cells]
        slices = channel_slices(self.variables)
        arrays = {v: cells[..., slices[v]][..., 0] if v.dims == 1 else cells[..., slices[v]]
                  for v in self.variables}
        if self.npyd:
            self._add_npyd(arrays, metadata.case_name)
        else:
            self._add_h5(arrays, metadata.case_name)

    def _add_h5(self, arrays: Dict[Variable, np.ndarray], case_name: str) -> None:
        import h5py

        with h5py.File(self.samples_file, "a") as f:
            data_group = f.require_group(case_name).require_group("data")
            n_prev = int(data_group.attrs.get("n_samples", 0))
            n_new = 0
            for v, arr in arrays.items():
                n_new = arr.shape[0]
                if v.key not in data_group:
                    data_group.create_dataset(
                        v.key, data=arr, chunks=(1, *arr.shape[1:]), maxshape=(None, *arr.shape[1:])
                    )
                else:
                    ds = data_group[v.key]
                    if ds.shape[0] < n_prev + n_new:
                        ds.resize(n_prev + n_new, axis=0)
                    ds[n_prev : n_prev + n_new] = arr
            data_group.attrs["n_samples"] = n_prev + n_new

    def _add_npyd(self, arrays: Dict[Variable, np.ndarray], case_name: str) -> None:
        attrs = read_attrs(self.samples_file)
        key = f"{case_name}/data"
        n_prev = int(attrs.get(key, {}).get("n_samples", 0))
        folder = self.samples_file / key
        folder.mkdir(parents=True, exist_ok=True)
        n_new = 0
        for v, arr in arrays.items():
            n_new = arr.shape[0]
            np.save(folder / f"{v.key}-{n_prev}.npy", arr)
        attrs[key] = {"n_samples": n_prev + n_new}
        write_attrs(self.samples_file, attrs)

    @property
    def case_names(self) -> List[str]:
        if self.npyd:
            # A converted .h5 store also lists its case groups' (empty) attributes.
            return sorted(key[: -len("/data")] for key in read_attrs(self.samples_file) if key.endswith("/data"))
        if not self.samples_file.is_file():
            return []
        import h5py

        with h5py.File(self.samples_file, "r") as f:
            return list(f.keys())

    def n_samples(self, case_name: str) -> int:
        if self.npyd:
            return int(read_attrs(self.samples_file)[f"{case_name}/data"].get("n_samples", 0))
        import h5py

        with h5py.File(self.samples_file, "r") as f:
            return int(f[case_name]["data"].attrs.get("n_samples", 0))

    def load_samples(self, metadata: CaseMetadata) -> CaseData:
        n = self.n_samples(metadata.case_name)
        if self.npyd:
            folder = self.samples_file / metadata.case_name / "data"
            raw = {v: _read_chunks(folder, v.key, n) for v in self.variables}
        else:
            import h5py

            with h5py.File(self.samples_file, "r") as f:
                group = f[metadata.case_name]["data"]
                raw = {v: np.asarray(group[v.key][:n]) for v in self.variables}
        fields = {v: (arr[..., None] if arr.ndim == 2 else arr).astype(np.float32) for v, arr in raw.items()}
        return CaseData(metadata=metadata, t=np.zeros(n), fields=fields)

    def reset(self) -> None:
        if self.npyd:
            attrs = read_attrs(self.samples_file)
            if attrs:
                write_attrs(self.samples_file, {key: {"n_samples": 0} if key.endswith("/data") else value
                                                for key, value in attrs.items()})
            return
        if not self.samples_file.is_file():
            return
        import h5py

        with h5py.File(self.samples_file, "a") as f:
            for case_name in f.keys():
                f[case_name]["data"].attrs["n_samples"] = 0


def _read_chunks(folder: Path, key: str, n: int) -> np.ndarray:
    """The first ``n`` samples of variable ``key`` from its chunks, each
    starting where the last ended."""
    chunks = {}
    for file in folder.glob(f"{key}*.npy"):
        found = re.fullmatch(rf"{re.escape(key)}(?:-(\d+))?\.npy", file.name)
        if found:
            start = int(found.group(1) or 0)
            if found.group(1) is not None or start not in chunks:
                chunks[start] = file
    parts, start = [], 0
    while start < n:
        if start not in chunks:
            raise FileNotFoundError(f"no chunk of {key} starting at sample {start} in {folder}")
        part = np.load(chunks[start])[: n - start]
        parts.append(part)
        start += len(part)
    if not parts:
        return np.zeros((0,), np.float32)
    return np.concatenate(parts)
