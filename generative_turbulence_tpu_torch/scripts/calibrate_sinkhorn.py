"""Calibrate the device's masked-Sinkhorn Wasserstein against the exact EMD.

    python -m generative_turbulence_tpu_torch.scripts.calibrate_sinkhorn <data_root> [--case val/block-pair-tall]
        [--samples 8] [--max-regions K] [--sweep 0.02:300,0.005:1200] [--out docs/runs/sinkhorn-calibration.json]

Port of ``scripts/calibrate-sinkhorn.py``.  The entropic solver is a biased
estimator of the exact transport the reference computes; this measures the
bias on a real case: the full ``WassersteinMetric`` of early-window against
late-window frames of one case (the data-floor protocol), once with the
exact host EMD and once per ``--sweep`` ``reg:iters`` pair with the
Sinkhorn on the device, over the same ``--max-regions`` subset of regions.
Writes the values, seconds and relative errors as JSON.  The case is the
directory ``--case`` under the root, its file taken by ``find_data_files``'s
rule (``data.npyd``, else ``data.h5`` where ``h5py`` imports).  Runs on the
GPU unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from ..data.schema import CaseRepository, FieldStats, case_file
from ..data.variables import Variable
from ..eval.metrics import WassersteinMetric
from ..train import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("data_root")
    ap.add_argument("--case", default="val/block-pair-tall")
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--out", default=None)
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--max-regions", type=int, default=None,
                    help="subsample this many regions (same subset for both solvers) so the exact host EMD "
                         "finishes in minutes; weights are renormalized")
    ap.add_argument("--sweep", default=None,
                    help="comma list of reg:iters pairs (e.g. 0.02:300,0.01:500): the exact EMD runs once and "
                         "every Sinkhorn config is scored against it")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_intermixed_args(argv)
    device = resolve_device(args.device)

    root = Path(args.data_root)
    stats = FieldStats.from_file(root / "stats.pickle")
    file = case_file(root / args.case)
    if file is None:
        raise FileNotFoundError(f"no data.npyd or data.h5 in {root / args.case}")
    repo = CaseRepository([file], (Variable.U, Variable.P))

    n_frames = len(repo.times[0])
    k = args.samples
    early = np.linspace(0, n_frames // 2 - 1, k).round().astype(int).tolist()
    late = np.linspace(n_frames // 2, n_frames - 1, k).round().astype(int).tolist()
    samples = repo.read(0, sorted(set(early)))
    data = repo.read(0, sorted(set(late)))

    results = {"case": args.case, "samples": k, "max_regions": args.max_regions}

    def run(solver, **kw):
        tic = time.time()
        metric = WassersteinMetric(max_workers=args.workers, solver=solver, max_regions=args.max_regions,
                                   device=device, **kw)
        out = metric(samples, data, stats)
        return out.get("wasserstein"), time.time() - tic

    configs = [(0.02, 300)]
    if args.sweep:
        configs = [(float(r), int(n)) for r, n in (pair.split(":") for pair in args.sweep.split(","))]

    ex, ex_wall = run("exact")
    results["exact"] = {"wasserstein": ex, "seconds": ex_wall}
    print(f"exact: {ex} ({ex_wall:.0f}s)", flush=True)

    results["sinkhorn"] = []
    for reg, iters in configs:
        sk, wall = run("sinkhorn", sinkhorn_reg=reg, sinkhorn_iters=iters)
        entry = {"reg": reg, "iters": iters, "wasserstein": sk, "seconds": wall,
                 "relative_error": abs(sk - ex) / abs(ex) if ex else None}
        results["sinkhorn"].append(entry)
        rel = "undefined (exact is 0)" if entry["relative_error"] is None else f"{entry['relative_error']:.4f}"
        print(f"sinkhorn reg={reg} iters={iters}: {sk} ({wall:.0f}s) rel_err={rel}", flush=True)

    out_path = Path(args.out) if args.out else Path("docs/runs/sinkhorn-calibration.json")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(results, indent=2))
    print(f"wrote {out_path}")
    return results


if __name__ == "__main__":
    main()
