"""Checkpoints of the train state with an embedded config.

Port of ``generative_turbulence_tpu/training/checkpoint.py`` (save-last and
top-1 on the monitored value, the resolved config beside them), with
``torch.save`` files in place of Orbax directories; the JAX package's
Orbax checkpoints are not read here.

Layout:
    <dir>/last.pt      latest state (``DiffusionTask.state_dict()``)
    <dir>/best.pt      best state on the monitor
    <dir>/config.json  resolved config
    <dir>/index.json   {step, best_step, best_value}

In a ``torch.distributed`` run every rank keeps the index and takes the
same best-on-monitor decisions, rank 0 alone writes, and each save ends at a
barrier, so that no rank reads a checkpoint before it is whole.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import torch

from ..parallel.distributed import barrier, is_main_process


class CheckpointManager:
    def __init__(self, directory: Path, config_json: Optional[str] = None):
        self.dir = Path(directory).resolve()
        self.writer = is_main_process()
        if self.writer:
            self.dir.mkdir(parents=True, exist_ok=True)
            if config_json is not None:
                (self.dir / "config.json").write_text(config_json)
        self._index = self._read_index()

    def _read_index(self) -> Dict[str, Any]:
        f = self.dir / "index.json"
        if f.is_file():
            return json.loads(f.read_text())
        return {"step": None, "best_step": None, "best_value": None}

    def _write_index(self) -> None:
        if self.writer:
            (self.dir / "index.json").write_text(json.dumps(self._index))

    def _save_to(self, name: str, state: Mapping) -> None:
        if not self.writer:
            return
        path = self.dir / f"{name}.pt"
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        torch.save(dict(state), tmp)
        os.replace(tmp, path)

    def save_last(self, state: Mapping, step: int) -> None:
        self._save_to("last", state)
        self._index["step"] = int(step)
        self._write_index()
        barrier()

    def save_best(self, state: Mapping, step: int, value: float) -> bool:
        """Save ``state`` as the best if ``value`` is below the best so far."""
        prev = self._index.get("best_value")
        is_best = prev is None or value < prev
        if is_best:
            self._save_to("best", state)
            self._index["best_step"] = int(step)
            self._index["best_value"] = float(value)
            self._write_index()
        barrier()
        return is_best

    def restore(self, which: str = "last", map_location=None) -> Dict[str, Any]:
        """The saved state ``which`` ("last" or "best"), for
        ``DiffusionTask.load_state_dict``."""
        path = self.dir / f"{which}.pt"
        if not path.is_file():
            raise FileNotFoundError(f"No checkpoint at {path}")
        return torch.load(path, map_location=map_location, weights_only=True)

    @property
    def config_json(self) -> Optional[str]:
        f = self.dir / "config.json"
        return f.read_text() if f.is_file() else None

    @property
    def last_step(self) -> Optional[int]:
        return self._index.get("step")
