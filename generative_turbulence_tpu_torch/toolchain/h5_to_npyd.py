"""Convert HDF5 files to ``.npyd`` directories (``data/npyd.py``).

Every dataset becomes a ``.npy`` file at its path and every attribute goes
into ``attrs.json``, so a case file (``data.h5``), a mean flow
(``mean-flow.h5``) or a sample store converts as it is.  Datasets are copied
in slices along their first axis, so a case larger than memory converts too.
Runs where ``h5py`` imports; the result reads without it.

    python -m generative_turbulence_tpu_torch.toolchain.h5_to_npyd <root>

converts every ``*.h5`` under ``<root>`` into a ``.npyd`` beside it
(``case/data.h5`` -> ``case/data.npyd``).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..data.npyd import SUFFIX, write_attrs

ROWS_PER_COPY = 64


def convert_file(h5_file: Path, out: Optional[Path] = None) -> Path:
    """Write ``h5_file`` as a ``.npyd`` directory (by default beside it, with
    the same stem) and return its path."""
    import h5py

    h5_file = Path(h5_file)
    out = Path(out) if out is not None else h5_file.with_suffix(SUFFIX)
    out.mkdir(parents=True, exist_ok=True)
    attrs: Dict[str, dict] = {}
    with h5py.File(h5_file, "r") as f:
        if f.attrs:
            attrs[""] = dict(f.attrs)

        def visit(name: str, obj) -> None:
            if obj.attrs or isinstance(obj, h5py.Group):
                attrs[name] = dict(obj.attrs)
            if isinstance(obj, h5py.Group):
                (out / name).mkdir(parents=True, exist_ok=True)
                return
            file = out / f"{name}.npy"
            file.parent.mkdir(parents=True, exist_ok=True)
            if obj.ndim == 0 or obj.size == 0:
                np.save(file, np.asarray(obj[()]))
                return
            dst = np.lib.format.open_memmap(file, mode="w+", dtype=obj.dtype, shape=obj.shape)
            for start in range(0, obj.shape[0], ROWS_PER_COPY):
                dst[start : start + ROWS_PER_COPY] = obj[start : start + ROWS_PER_COPY]
            dst.flush()
            del dst

        f.visititems(visit)
    write_attrs(out, attrs)
    return out


def convert_tree(root: Path) -> List[Path]:
    """Convert every ``*.h5`` file under ``root``, each beside itself."""
    return [convert_file(file) for file in sorted(Path(root).rglob("*.h5"))]


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("root", type=Path, help="a dataset root (or one .h5 file) to convert")
    args = parser.parse_args(argv)
    outs = [convert_file(args.root)] if args.root.is_file() else convert_tree(args.root)
    for out in outs:
        print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
