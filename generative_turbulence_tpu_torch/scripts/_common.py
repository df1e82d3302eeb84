"""What the evaluation entry points share: a task restored from a
checkpoint directory, and the val set sampled into a store.

Port of ``scripts/_common.py``.  Its ``ensure_malloc_reuse`` (a re-exec
with the TPU host's malloc settings) is a TPU-host workaround the port
leaves out.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Sequence

from ..eval.sample_store import SampleStore
from ..training.checkpoint import CheckpointManager
from ..training.config import Config, parse_cli_overrides
from ..training.factory import instantiate_data_and_task


def load_task_from_checkpoint(ckpt_dir, overrides: Sequence[str] = (), which: str = "best", device="cuda"):
    """(config, datamodule, task) from a checkpoint directory of the port
    (``last.pt``, ``best.pt``, ``config.json``, as ``Trainer`` and
    ``import_checkpoint`` write it): the embedded config with ``overrides``
    applied, the task built on ``device`` and its state restored from
    ``which``, or from ``last`` where there is no ``which``."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        raise FileNotFoundError(f"no checkpoint directory {ckpt_dir}")
    mgr = CheckpointManager(ckpt_dir)
    if mgr.config_json is None:
        raise FileNotFoundError(f"no config.json in {ckpt_dir}")
    config = Config.from_json(mgr.config_json)
    if overrides:
        config = parse_cli_overrides(list(overrides), base=config)
    config = config.resolved()

    dm, task = instantiate_data_and_task(config, device)
    dm.setup("validate")
    if not (mgr.dir / f"{which}.pt").is_file():
        which = "last"
    task.load_state_dict(mgr.restore(which, map_location=device))
    return config, dm, task


def sample_val_set(task, dm, store: SampleStore, noise_factory, label: str = "") -> None:
    """Sample every val batch into ``store`` (reset first), batch ``i`` with
    the draws of ``noise_factory("sample", i)``."""
    if not hasattr(task, "sample"):
        raise ValueError(f"{type(task).__name__} does not sample; evaluate a baseline with evaluate_from_initial")
    store.reset()
    for i, batch in enumerate(dm.val_batches()):
        print(f"{label}sampling batch {i} ({batch.metadata.case_name})", file=sys.stderr)
        batch = batch.to(task.device)
        samples = task.sample(batch.cells, batch.grid, noise_factory("sample", i))
        store.add_samples(samples.float().cpu().numpy(), batch.metadata)
