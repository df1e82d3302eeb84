"""Metric-discrimination check: degenerate samplers through the real metric
stack.

    python -m generative_turbulence_tpu_torch.scripts.degenerate_baselines <data_root> [--split val] [--samples 8]

Port of ``scripts/degenerate-baselines.py``.  Three deliberately bad
"models" are scored with the validation protocol
(``SampleMetricsCollection``, the cheap metrics, ground truth from the
second half of each case), beside the floor of ``evaluate_dataset``:

- ``mean``: every sample is the case's first-half time-mean flow (a model
  that collapsed to the mean; no resolved TKE);
- ``noise``: per-variable moment-matched white noise from
  ``numpy.random.default_rng(--seed)``, drawn case by case (a model that
  learned one-point statistics but no structure);
- ``cross-case``: real frames of the next val case, its cells tiled or cut
  to this case's count (right statistics, wrong geometry).

A healthy metric stack ranks floor < trained model < cross-case < mean (and
noise far off).  Each baseline's samples go into a temporary ``.npyd``
store; the metrics are written to ``--out`` as JSON (default
``docs/runs/degenerate-baselines.json``, which ``compare_runs`` reads).
Runs on the GPU unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

import numpy as np

from ..data.schema import CaseRepository, FieldStats, find_data_files
from ..data.variables import Variable
from ..eval.metrics import SampleMetricsCollection
from ..eval.sample_store import SampleStore
from ..train import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("data_root")
    ap.add_argument("--split", default="val")
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_intermixed_args(argv)
    device = resolve_device(args.device)

    root = Path(args.data_root)
    variables = (Variable.U, Variable.P)
    stats = FieldStats.from_file(root / "stats.pickle")
    files = find_data_files(root / args.split)
    rng = np.random.default_rng(args.seed)

    # First-half frames per case: the metric protocol holds out the second
    # half as ground truth, so the baselines may only look at the first.
    firsthalf, metas = {}, {}
    for i, file in enumerate(files):
        repo = CaseRepository([file], variables)
        n = len(repo.times[0])
        idx = np.round(np.linspace(0, n // 2 - 1, args.samples)).astype(int)
        firsthalf[i] = repo.read(0, sorted(set(idx.tolist()))).stacked_cells(variables)  # (T, N, F)
        metas[i] = repo.read_metadata(0)

    def make_store(tmp, name, sample_fn):
        store = SampleStore(Path(tmp) / f"{name}.npyd", variables)
        for i in range(len(files)):
            store.add_samples(sample_fn(i), metas[i])
        return store

    def mean_samples(i):
        x = firsthalf[i]
        return np.repeat(x.mean(axis=0, keepdims=True), args.samples, axis=0)

    def noise_samples(i):
        x = firsthalf[i]
        mu = x.mean(axis=(0, 1), keepdims=True)
        sd = x.std(axis=(0, 1), keepdims=True)
        return (mu + sd * rng.standard_normal((args.samples,) + x.shape[1:])).astype(np.float32)

    def cross_case_samples(i):
        j = (i + 1) % len(files)
        x = firsthalf[j]
        n_i = firsthalf[i].shape[1]
        if x.shape[1] == n_i:
            return x[: args.samples]
        reps = -(-n_i // x.shape[1])
        return np.tile(x, (1, reps, 1))[: args.samples, :n_i]

    out = {}
    baselines = {"mean": mean_samples, "noise": noise_samples, "cross-case": cross_case_samples}
    for name, fn in baselines.items():
        with tempfile.TemporaryDirectory() as tmp:
            store = make_store(tmp, name, fn)
            collection = SampleMetricsCollection(
                name, root / args.split, SampleMetricsCollection.default_metrics(device=device)
            )
            metrics = collection.compute(store, stats, expensive_metrics=False)
        out[name] = metrics
        print(f"{name}: tke={metrics.get(name + '/tke')}", flush=True)

    path = Path(args.out) if args.out else Path("docs/runs/degenerate-baselines.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=2))
    print(f"wrote {path}")
    return out


if __name__ == "__main__":
    main()
