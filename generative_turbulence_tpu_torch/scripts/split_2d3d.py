"""Split the 2D/3D regression cases into train/val/test time ranges.

    python -m generative_turbulence_tpu_torch.scripts.split_2d3d <study_root> \\
        [--fractions 0.8 0.1 0.1] [--format npyd|h5]

Port of ``scripts/split-2d3d.py`` (the reference's
``split-2d-3d-regression.py``): the per-case time-range split of every
converted case under ``<study_root>/cases`` into ``<study_root>/{train,val,
test}/<case>/``.  Each case's file is found by ``find_data_files``'s rule,
``data.npyd`` where there is one, else ``data.h5``; the JAX script looks
for ``data.h5`` only and so finds no case of a ``.npyd`` study.  The splits
are written as ``data.npyd`` (no ``h5py`` needed), or ``data.h5`` with
``--format h5``.  Host only.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..toolchain.convert import FORMATS


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("study_root")
    ap.add_argument("--fractions", nargs=3, type=float, default=[0.8, 0.1, 0.1])
    ap.add_argument("--format", default="npyd", choices=sorted(FORMATS),
                    help="output case file format: npyd (no h5py needed) or h5")
    args = ap.parse_intermixed_args(argv)

    from ..data.schema import find_data_files
    from ..toolchain.analysis import split_h5

    root = Path(args.study_root)
    files = find_data_files(root / "cases")
    if not files:
        raise SystemExit(f"no converted cases under {root / 'cases'}")
    out = {}
    for file in files:
        out[file.parent.name] = split_h5(file, root, fractions=tuple(args.fractions), format=args.format)
        print(f"{file.parent.name}: " + ", ".join(f"{k}={v}" for k, v in out[file.parent.name].items()))
    return out


if __name__ == "__main__":
    main()
