"""Baselines only: roll the model out for many steps from a noised initial context, then score.

    python -m generative_turbulence_tpu_torch.scripts.evaluate_from_initial <ckpt_dir> [key=value ...] [--steps 199]

Port of ``scripts/evaluate-from-initial.py``: for the first val batch of
each case, the context frames plus ``--noise-std`` times standard normals
from ``numpy.random.default_rng(0)`` (drawn in case order, as the JAX script
draws them, so both see the same noise), then ``unroll_samples`` to step
``--steps`` in blocks of ``--block-size``; that step's frames go into the
store (``--out``) and are scored.  Prints the ``from-initial/...`` metrics as
JSON.  Runs on the GPU unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

from ..eval.metrics import SampleMetricsCollection
from ..eval.sample_store import SampleStore
from ..train import resolve_device
from ..training.regression_task import RegressionTaskBase
from ._common import load_task_from_checkpoint


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ckpt_dir")
    ap.add_argument("overrides", nargs="*", help="config overrides key=value")
    ap.add_argument("--steps", type=int, default=199)
    ap.add_argument("--noise-std", type=float, default=1e-2)
    ap.add_argument("--block-size", type=int, default=32)
    ap.add_argument("--out", default="from-initial-samples.npyd", help="sample store (.npyd, or .h5 with h5py)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_intermixed_args(argv)
    device = resolve_device(args.device)

    config, dm, task = load_task_from_checkpoint(args.ckpt_dir, args.overrides, device=device)
    if not isinstance(task, RegressionTaskBase):
        raise ValueError(f"evaluate_from_initial unrolls the baselines (TF-Net, DilResNet), not {type(task).__name__}")

    rng = np.random.default_rng(0)
    store = SampleStore(Path(args.out), task.variables)
    store.reset()
    seen = set()
    for batch in dm.val_batches():
        if batch.metadata.case_name in seen:
            continue
        seen.add(batch.metadata.case_name)
        noise = args.noise_std * rng.normal(size=tuple(batch.cells.shape)).astype(np.float32)
        cells = torch.as_tensor(batch.cells)
        batch = dataclasses.replace(batch, cells=cells + torch.from_numpy(noise).to(cells.device))
        samples = task.unroll_samples(batch, [args.steps], block_size=args.block_size)
        store.add_samples(samples[:, -1], batch.metadata)
        print(f"unrolled {batch.metadata.case_name}", file=sys.stderr)

    collection = SampleMetricsCollection(
        "from-initial", Path(config.data.root) / "val", SampleMetricsCollection.default_metrics(device=device)
    )
    metrics = collection.compute(store, dm.stats, expensive_metrics=False)
    print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main()
