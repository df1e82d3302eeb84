"""Compute training-set statistics -> stats.pickle.

    python -m generative_turbulence_tpu_torch.scripts.dataset_stats <data_root> [--out stats.pickle]

Port of ``scripts/dataset-stats.py`` (reference: ``scripts/dataset-stats.py``).
Each case of ``<data_root>/train`` is read from its file by
``find_data_files``'s rule: ``data.npyd`` where there is one, else
``data.h5``.  Host only.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("data_root")
    ap.add_argument("--out", default=None)
    args = ap.parse_intermixed_args(argv)

    from ..data.schema import find_data_files
    from ..toolchain.analysis import dataset_stats

    root = Path(args.data_root)
    files = find_data_files(root / "train")
    out = Path(args.out) if args.out else root / "stats.pickle"
    dataset_stats(files, out)
    print(f"wrote {out} from {len(files)} cases")
    return out


if __name__ == "__main__":
    main()
