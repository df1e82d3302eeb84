"""Metric logging: JSONL stream + console, with optional wandb.

Port of ``generative_turbulence_tpu/training/logging.py``: the primary sink
is an append-only ``metrics.jsonl`` in the run directory, mirrored to
stderr, with wandb attached when ``use_wandb`` is set and the package
imports.  Also tracks the best-epoch summary (``summary.json``).  In a
``torch.distributed`` run only rank 0 writes.
"""

from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, Optional

from ..parallel.distributed import is_main_process


class MetricLogger:
    def __init__(self, out_dir: Path, use_wandb: bool = False, wandb_kwargs=None):
        self.out_dir = Path(out_dir)
        # Multi-process runs: metrics are replicated across processes, so only
        # rank 0 writes (JSONL, summary, wandb); other ranks stay silent.
        self.main = is_main_process()
        self.file = None
        if self.main:
            self.out_dir.mkdir(parents=True, exist_ok=True)
            self.file = open(self.out_dir / "metrics.jsonl", "a", buffering=1)
        self.start_time = time.time()

        self.wandb = None
        if use_wandb and self.main:
            try:
                import wandb

                self.wandb = wandb
                wandb.init(**(wandb_kwargs or {}))
            except Exception as e:  # offline environments
                print(f"[logging] wandb unavailable ({e}); using JSONL only", file=sys.stderr)
                self.wandb = None

        self._best: Dict[str, float] = {}
        self._best_step: Optional[int] = None

    def log(self, metrics: Dict[str, float], *, step: int, epoch: Optional[int] = None):
        record = {"step": int(step), "time": time.time() - self.start_time}
        if epoch is not None:
            record["epoch"] = int(epoch)
        for k, v in metrics.items():
            v = float(v)
            record[k] = v if math.isfinite(v) else None
        if self.file is not None:
            self.file.write(json.dumps(record) + "\n")
        if self.wandb is not None:
            self.wandb.log(metrics, step=step)

    def console(self, message: str):
        if self.main:
            print(message, file=sys.stderr, flush=True)

    def update_best(self, monitor: str, metrics: Dict[str, float], step: int) -> bool:
        """Track the best epoch on ``monitor`` (lower is better); returns True
        if this is a new best."""
        value = metrics.get(monitor)
        if value is None:
            return False
        if self._best_step is None or value < self._best.get(monitor, float("inf")):
            self._best = dict(metrics)
            self._best_step = step
            self._write_summary()
            return True
        return False

    def _write_summary(self):
        if not self.main:
            return
        summary = {"best_step": self._best_step, **self._best}
        (self.out_dir / "summary.json").write_text(json.dumps(summary, indent=2))
        if self.wandb is not None:
            for k, v in self._best.items():
                self.wandb.run.summary[k] = v

    def close(self):
        if self.file is not None:
            self.file.close()
        if self.wandb is not None:
            self.wandb.finish()
