"""Generate the solver-scaling study: the same case at several MPI
decomposition widths.

    python -m generative_turbulence_tpu_torch.scripts.generate_performance_dataset <out_root> \\
        [--widths 1 2 4 8 16] [--end-time 0.05]

Port of ``scripts/generate-performance-dataset.py`` (the reference's
``generate-performance-dataset.py``: parallel in {1, 2, 4, 8, 16}): one
OpenFOAM case per width under ``<out_root>/cases/parallel-<width>``, its
``decomposeParDict`` split into that many subdomains.  Host only.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out_root")
    ap.add_argument("--widths", nargs="+", type=int, default=[1, 2, 4, 8, 16])
    ap.add_argument("--end-time", type=float, default=0.05)
    args = ap.parse_intermixed_args(argv)

    from ..toolchain.generate import ChannelConfig, generate_case
    from ..toolchain.shapes import shape_boxes, shape_catalog

    holes = shape_boxes(shape_catalog()["square-medium"])
    cases = []
    for width in args.widths:
        config = ChannelConfig(holes=holes, n_subdomains=width, end_time=args.end_time)
        case_dir = Path(args.out_root) / "cases" / f"parallel-{width}"
        generate_case(case_dir, config)
        print(f"generated parallel-{width}")
        cases.append(case_dir)
    return cases


if __name__ == "__main__":
    main()
