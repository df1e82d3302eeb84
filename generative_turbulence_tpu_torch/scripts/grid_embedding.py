"""Add the sparse<->dense grid mapping (grid/ + geometry/ groups) to a
converted case.

    python -m generative_turbulence_tpu_torch.scripts.grid_embedding <data.npyd|data.h5> <case_dir>

Port of ``scripts/grid-embedding.py`` (reference:
``scripts/grid-embedding.py``); the case file's format is taken from its
path.  Host only.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("h5_file")
    ap.add_argument("case_dir")
    args = ap.parse_intermixed_args(argv)

    from ..toolchain.convert import add_grid_embedding

    out = add_grid_embedding(Path(args.h5_file), Path(args.case_dir))
    print(f"updated {args.h5_file}")
    return out


if __name__ == "__main__":
    main()
