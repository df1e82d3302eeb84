"""The metric floor: the sample metrics with real frames as the samples.

    python -m generative_turbulence_tpu_torch.scripts.evaluate_dataset <data_root> [--split val] [--samples 8]

Port of ``scripts/evaluate-dataset.py``: for each case of the split,
``--samples`` frames evenly spaced over the early window (frames n/4 to
n/2 - 1) stand in for samples, scored against the held-out second half as
a model's samples are: what a perfect model would score.  Cases are read
through ``CaseRepository`` (``data.npyd``, or ``data.h5`` where ``h5py``
imports).  Prints the ``floor/...`` metrics as JSON.  Runs on the GPU
unless ``--device`` says otherwise.
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
    ap.add_argument("--expensive", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_intermixed_args(argv)
    device = resolve_device(args.device)

    root = Path(args.data_root)
    variables = (Variable.U, Variable.P)
    stats = FieldStats.from_file(root / "stats.pickle")
    with tempfile.TemporaryDirectory() as tmp:
        store = SampleStore(Path(tmp) / "floor-samples.npyd", variables)
        for file in find_data_files(root / args.split):
            repo = CaseRepository([file], variables)
            n = len(repo.times[0])
            idx = np.round(np.linspace(n // 4, n // 2 - 1, args.samples)).astype(int)
            store.add_samples(repo.read(0, idx).stacked_cells(variables), repo.read_metadata(0))
        collection = SampleMetricsCollection(
            "floor", root / args.split, SampleMetricsCollection.default_metrics(device=device)
        )
        metrics = collection.compute(store, stats, expensive_metrics=args.expensive)
    print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main()
