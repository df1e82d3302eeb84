"""Convert a solved OpenFOAM case to a case file (+ optional grid embedding).

    python -m generative_turbulence_tpu_torch.scripts.foam2h5 <case_dir> \\
        [--out data.npyd] [--grid-embedding] [--format npyd|h5]

Port of ``scripts/foam2h5.py``, a CLI over ``toolchain/convert.py``
(reference: ``scripts/foam2h5.py``).  The module keeps the reference's name;
it writes ``<case_dir>/data.npyd`` (no ``h5py`` needed), or ``data.h5`` with
``--format h5``.  Host only.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..toolchain.convert import FORMATS


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("case_dir")
    ap.add_argument("--out", default=None)
    ap.add_argument("--keep-first-time", action="store_true")
    ap.add_argument("--grid-embedding", action="store_true")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--format", default="npyd", choices=sorted(FORMATS),
                    help="case file format: npyd (no h5py needed) or h5")
    args = ap.parse_intermixed_args(argv)

    from ..toolchain.convert import add_grid_embedding, foam_case_to_h5

    out = foam_case_to_h5(
        Path(args.case_dir),
        Path(args.out) if args.out else None,
        drop_first_time=not args.keep_first_time,
        n_workers=args.workers,
        format=args.format,
    )
    print(f"wrote {out}")
    if args.grid_embedding:
        add_grid_embedding(out, Path(args.case_dir))
        print("added grid embedding")
    return out


if __name__ == "__main__":
    main()
