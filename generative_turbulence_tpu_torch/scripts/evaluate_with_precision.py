"""Evaluate a checkpoint under several matmul precisions (the numerical sensitivity of sampling).

    python -m generative_turbulence_tpu_torch.scripts.evaluate_with_precision <ckpt_dir> [key=value ...] \\
        [--precisions default high highest]

Port of ``scripts/evaluate-with-precision.py``.  Each precision is set as
``trainer.matmul_precision`` sets it (``train.set_matmul_precision``):
``default`` leaves torch's TF32 switches as they are, ``high`` allows TF32
in cuBLAS matmuls and cuDNN convolutions, ``highest`` forbids it.  TF32
reaches cuBLAS and cuDNN only: the Hopper kernels (the fused ResnetBlock
chain, ``flash_attention``) compute with bf16 or f32 operands and f32
accumulation under every precision.  The task is restored from the
checkpoint, the val set sampled and the cheap metrics computed under each;
the switches are restored after each precision.  Prints
``{precision: metrics}`` as JSON.  Runs on the GPU unless ``--device`` says
otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

from ..eval.metrics import SampleMetricsCollection
from ..eval.sample_store import SampleStore
from ..train import resolve_device, set_matmul_precision
from ..training.loop import KeyedNoise
from ._common import load_task_from_checkpoint, sample_val_set

TF32_SCOPE = ("TF32 reaches cuBLAS matmuls and cuDNN convolutions only; the Hopper kernels' arithmetic "
              "(bf16 or f32 operands, f32 accumulation) is the same under every precision")


def main(argv=None, noise_factory=None) -> dict:
    """``noise_factory("sample", i)`` gives batch i's draws under every
    precision; by default a ``KeyedNoise`` seeded with 0."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ckpt_dir")
    ap.add_argument("overrides", nargs="*", help="config overrides key=value")
    ap.add_argument("--precisions", nargs="+", default=["default", "high", "highest"])
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_intermixed_args(argv)
    device = resolve_device(args.device)
    noise_factory = noise_factory or KeyedNoise(0, device)
    print(TF32_SCOPE, file=sys.stderr)

    results = {}
    for precision in args.precisions:
        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        try:
            set_matmul_precision(precision)
            config, dm, task = load_task_from_checkpoint(args.ckpt_dir, args.overrides, device=device)
            with tempfile.TemporaryDirectory() as tmp:
                store = SampleStore(Path(tmp) / "samples.npyd", task.variables)
                sample_val_set(task, dm, store, noise_factory, label=f"[{precision}] ")
                collection = SampleMetricsCollection(
                    "val", Path(config.data.root) / "val", SampleMetricsCollection.default_metrics(device=device)
                )
                results[precision] = collection.compute(store, dm.stats, expensive_metrics=False)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
        print(f"{precision}: {results[precision]}", file=sys.stderr)

    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
