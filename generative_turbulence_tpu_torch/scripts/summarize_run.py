"""Distill a training run directory into committable artifacts.

    python -m generative_turbulence_tpu_torch.scripts.summarize_run <run_dir> <out_dir> [--monitor val/tke]

Port of ``scripts/summarize-run.py``, on the host.  Reads the
``metrics.jsonl`` of a run of the port's ``Trainer`` and writes
``<out_dir>/metrics.jsonl`` (a copy of the stream) and
``<out_dir>/summary.json``: the validation trajectory on the monitor, the
best step, the first and last train loss, the per-case metrics of the last
validation and the run's config (``checkpoints/config.json``, as
``CheckpointManager`` writes it).
"""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("run_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--monitor", default="val/tke")
    args = ap.parse_intermixed_args(argv)

    run_dir = Path(args.run_dir)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines() if line.strip()]
    val_records = [r for r in records if args.monitor in r]
    trajectory = [
        {"step": r["step"], "epoch": r.get("epoch"), "time_s": round(r["time"], 1), args.monitor: r[args.monitor]}
        for r in val_records
    ]
    best = min(val_records, key=lambda r: r[args.monitor]) if val_records else None

    # The last validation's per-case table: every key <phase>/<case>/<name>.
    per_case = {}
    if val_records:
        per_case = {k: v for k, v in val_records[-1].items() if isinstance(k, str) and k.count("/") == 2}

    train = [r for r in records if "train/loss" in r]
    summary = {
        "run_dir": str(run_dir),
        "monitor": args.monitor,
        "n_train_steps": train[-1]["step"] if train else None,
        "wall_time_s": round(records[-1]["time"], 1) if records else None,
        "train_loss_first": train[0]["train/loss"] if train else None,
        "train_loss_last": train[-1]["train/loss"] if train else None,
        "trajectory": trajectory,
        "best": best,
        "final_per_case": per_case,
    }
    cfg_file = run_dir / "checkpoints" / "config.json"
    if cfg_file.is_file():
        summary["config"] = json.loads(cfg_file.read_text())

    shutil.copy(run_dir / "metrics.jsonl", out_dir / "metrics.jsonl")
    (out_dir / "summary.json").write_text(json.dumps(summary, indent=2))
    print(f"wrote {out_dir}/summary.json ({len(trajectory)} validations, best={best and best[args.monitor]})")
    return summary


if __name__ == "__main__":
    main()
