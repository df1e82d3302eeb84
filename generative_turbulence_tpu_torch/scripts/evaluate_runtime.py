"""Time sampling per case: the least, over repeats, of one whole ``task.sample`` call.

    python -m generative_turbulence_tpu_torch.scripts.evaluate_runtime <ckpt_dir> [key=value ...] [--repeats N]

Port of ``scripts/evaluate-runtime.py``, the reference's runtime protocol:
per val case, one warm-up call on its first batch, then ``--repeats``
timed calls; each time covers the call and the samples' copy to the host,
then ``torch.cuda.synchronize()``.  Prints ``{"sample_time": <the least
over the cases, s>, "per_case": {case: s}}``.  Runs on the GPU unless
``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..train import resolve_device
from ..training.loop import KeyedNoise
from ._common import load_task_from_checkpoint


def main(argv=None, noise_factory=None) -> dict:
    """``noise_factory("runtime", r)`` gives repeat r's draws (r = -1 the
    warm-up's); by default a ``KeyedNoise`` seeded with 0."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ckpt_dir")
    ap.add_argument("overrides", nargs="*", help="config overrides key=value")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--which", default="best", choices=["best", "last"])
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_intermixed_args(argv)
    device = resolve_device(args.device)
    if args.repeats < 1:
        raise ValueError(f"--repeats must be at least 1, got {args.repeats}")

    config, dm, task = load_task_from_checkpoint(args.ckpt_dir, args.overrides, args.which, device)
    noise_factory = noise_factory or KeyedNoise(0, device)

    def sample_seconds(batch, r: int) -> float:
        tic = time.perf_counter()
        task.sample(batch.cells, batch.grid, noise_factory("runtime", r)).float().cpu().numpy()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - tic

    times = {}
    for batch in dm.val_batches():
        case = batch.metadata.case_name
        if case in times:
            continue
        batch = batch.to(device)
        sample_seconds(batch, -1)
        times[case] = min(sample_seconds(batch, r) for r in range(args.repeats))
        print(f"{case}: {times[case]:.3f}s / batch of {batch.batch_size}", file=sys.stderr)

    result = {"sample_time": min(times.values()), "per_case": times}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
