"""Per-case analysis aux files: mean flow, homogeneous regions, max-mean-TKE,
first turbulent frame, autocorrelation.

    python -m generative_turbulence_tpu_torch.scripts.case_analysis <data.npyd|data.h5> \\
        [--all | --mean-flow --regions ...] [--device cuda]

Port of ``scripts/case-analysis.py``, one CLI over the analysis module
(reference scripts: mean-flow.py, homogeneous-regions.py, max-mean-tke.py,
first-turbulent-frame.py, autocorrelation.py).  The case file is read in
either format; the mean flow is written in the case file's format
(``mean-flow.npyd`` beside a ``data.npyd``, ``mean-flow.h5`` beside a
``data.h5``).  ``--first-turbulent-frame`` runs
its spectra on ``--device``: the GPU by default, and without one it stops
rather than fall back to the CPU (``--device cpu`` runs them there).  The
other analyses are host numpy.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..data.npyd import is_npyd


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("data_file")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mean-flow", action="store_true")
    ap.add_argument("--regions", action="store_true")
    ap.add_argument("--max-mean-tke", action="store_true")
    ap.add_argument("--first-turbulent-frame", action="store_true")
    ap.add_argument("--autocorrelation", action="store_true")
    ap.add_argument("--discard", type=float, default=0.025)
    ap.add_argument("--k", type=int, default=64, help="number of regions")
    ap.add_argument("--device", default="cuda",
                    help="torch device of --first-turbulent-frame's spectra (default: cuda)")
    args = ap.parse_intermixed_args(argv)

    from ..toolchain import analysis

    device = None
    if args.all or args.first_turbulent_frame:
        from ..train import resolve_device

        device = resolve_device(args.device)  # before any work: no GPU stops the run here
    f = Path(args.data_file)
    out = {}
    if args.all or args.mean_flow:
        fmt = "npyd" if is_npyd(f) else "h5"
        out["mean_flow"] = analysis.mean_flow(f, discard_first_seconds=args.discard, format=fmt)
        print(f"mean flow -> {out['mean_flow']}")
    if args.all or args.regions:
        a = analysis.homogeneous_regions(f, k=args.k, discard_first_seconds=args.discard)
        out["regions"] = int(a.max() + 1)
        print(f"regions -> {f.parent / 'regions.npz'} ({out['regions']} clusters)")
    if args.all or args.max_mean_tke:
        out["max_mean_tke"] = analysis.max_mean_tke(f, discard_first_seconds=args.discard)
        print(f"max-mean-tke position: {out['max_mean_tke']}")
    if args.all or args.first_turbulent_frame:
        out["first_turbulent_frame"] = analysis.first_turbulent_frame(f, device=device)
        print(f"first turbulent frame: {out['first_turbulent_frame']}")
    if args.all or args.autocorrelation:
        out["autocorrelation"] = analysis.autocorrelation(f, discard_first_seconds=args.discard)
        print(f"decorrelation steps: {out['autocorrelation']}")
    return out


if __name__ == "__main__":
    main()
