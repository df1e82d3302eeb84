"""Split one case's file into train/val/test time ranges.

    python -m generative_turbulence_tpu_torch.scripts.split_hdf5 <data.npyd|data.h5> <out_root> \\
        [--fractions 0.8 0.1 0.1] [--format npyd|h5]

Port of ``scripts/split-hdf5.py`` (the reference's ``scripts/split-hdf5.py``),
a CLI over ``toolchain/analysis.py::split_h5``.  The module keeps the
reference's name; it reads a ``data.npyd`` or a ``data.h5`` case and writes
``<out_root>/{train,val,test}/<case>/data.npyd`` (no ``h5py`` needed), or
``data.h5`` with ``--format h5``.  Host only.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..toolchain.convert import FORMATS


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("data_file")
    ap.add_argument("out_root")
    ap.add_argument("--fractions", nargs=3, type=float, default=[0.8, 0.1, 0.1])
    ap.add_argument("--format", default="npyd", choices=sorted(FORMATS),
                    help="output case file format: npyd (no h5py needed) or h5")
    args = ap.parse_intermixed_args(argv)

    from ..toolchain.analysis import split_h5

    out = split_h5(Path(args.data_file), Path(args.out_root), fractions=tuple(args.fractions), format=args.format)
    for split, path in out.items():
        print(f"{split}: {path}")
    return out


if __name__ == "__main__":
    main()
