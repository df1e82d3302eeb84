"""Evaluate a checkpoint: sample the val set into a sample store, then score it.

    python -m generative_turbulence_tpu_torch.scripts.eval_ckpt <ckpt_dir> <out.npyd> [key=value ...]

Port of ``scripts/eval_ckpt.py``.  The config is read from the checkpoint
directory (``config.json``, written beside ``last.pt`` and ``best.pt`` by
the trainer and by ``import_checkpoint``), the overrides are applied to it,
and every val batch is sampled with the restored state (the EMA parameters
where the config has one).  The store's format follows its name: ``.npyd``
needs nothing beyond the package, ``.h5`` needs ``h5py``.  Prints the
metrics of ``SampleMetricsCollection.default_metrics`` as JSON: the cheap
ones, and with ``--expensive`` the point-cloud Wasserstein on
``--wasserstein-solver``.  Runs on the GPU unless ``--device`` says
otherwise.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..eval.metrics import SampleMetricsCollection
from ..eval.sample_store import SampleStore
from ..train import resolve_device
from ..training.loop import KeyedNoise
from ._common import load_task_from_checkpoint, sample_val_set


def main(argv=None, noise_factory=None) -> dict:
    """``noise_factory("sample", i)`` gives batch i's draws; by default a
    ``KeyedNoise`` seeded with ``trainer.seed + 1``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ckpt_dir", help="checkpoint directory (last.pt, best.pt, config.json)")
    ap.add_argument("out_file", help="sample store to write (.npyd, or .h5 where h5py imports)")
    ap.add_argument("overrides", nargs="*", help="config overrides key=value")
    ap.add_argument("--which", default="best", choices=["best", "last"])
    ap.add_argument("--expensive", action="store_true", help="also run the expensive metrics")
    ap.add_argument("--wasserstein-solver", default="exact", choices=["exact", "sinkhorn"],
                    help="point-cloud Wasserstein: exact EMD on the host, or the masked Sinkhorn on the device")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_intermixed_args(argv)
    device = resolve_device(args.device)

    config, dm, task = load_task_from_checkpoint(args.ckpt_dir, args.overrides, args.which, device)
    store = SampleStore(Path(args.out_file), task.variables)
    sample_val_set(task, dm, store, noise_factory or KeyedNoise(config.trainer.seed + 1, device))

    collection = SampleMetricsCollection(
        "val", Path(config.data.root) / "val",
        SampleMetricsCollection.default_metrics(args.wasserstein_solver, device=device),
    )
    metrics = collection.compute(store, dm.stats, expensive_metrics=args.expensive)
    print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main()
