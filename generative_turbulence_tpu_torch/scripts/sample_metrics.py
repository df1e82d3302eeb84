"""Score an existing sample store.

    python -m generative_turbulence_tpu_torch.scripts.sample_metrics <samples.npyd> <data_dir> [--expensive]

Port of ``scripts/sample-metrics.py``: the metrics of
``SampleMetricsCollection.default_metrics`` of the store's u and p against
the cases under ``data_dir`` (``<case>/data.npyd`` or ``data.h5``), with the
statistics of ``--stats`` (default ``data_dir/../stats.pickle``).  The
store is a ``.npyd`` directory, or an ``.h5`` file where ``h5py`` imports.
Prints the metrics as JSON.  Runs on the GPU unless ``--device`` says
otherwise.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..data.schema import FieldStats
from ..data.variables import Variable
from ..eval.metrics import SampleMetricsCollection
from ..eval.sample_store import SampleStore
from ..train import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("samples_file")
    ap.add_argument("data_dir", help="directory of <case>/data.npyd (or data.h5), stats.pickle in its parent")
    ap.add_argument("--stats", default=None, help="stats.pickle (default: data_dir/../stats.pickle)")
    ap.add_argument("--prefix", default="eval")
    ap.add_argument("--expensive", action="store_true")
    ap.add_argument("--solver", default="exact", choices=["exact", "sinkhorn"],
                    help="point-cloud Wasserstein: exact EMD on the host, or the masked Sinkhorn on the device")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_intermixed_args(argv)
    device = resolve_device(args.device)

    samples_file, data_dir = Path(args.samples_file), Path(args.data_dir)
    if not samples_file.exists():
        raise FileNotFoundError(f"no sample store {samples_file}")
    stats = FieldStats.from_file(Path(args.stats) if args.stats else data_dir.parent / "stats.pickle")
    store = SampleStore(samples_file, (Variable.U, Variable.P))
    collection = SampleMetricsCollection(
        args.prefix, data_dir, SampleMetricsCollection.default_metrics(args.solver, device=device)
    )
    metrics = collection.compute(store, stats, expensive_metrics=args.expensive)
    print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main()
