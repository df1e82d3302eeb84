"""Read-side wandb helpers (gated: wandb is optional).

Port of ``generative_turbulence_tpu/utils/wandb.py`` (the counterpart of
``turbdiff/utils/wandb.py:18-72``): resolve a run, pull its config, and
download its checkpoints, for evaluation scripts when runs are tracked in
wandb.  ``wandb`` is imported inside the functions only, so the module
imports without it: ``wandb_available()`` says whether it imports, and the
other calls stop with its ImportError.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple


def wandb_available() -> bool:
    try:
        import wandb  # noqa: F401

        return True
    except ImportError:
        return False


def get_run(run_path: str):
    """run_path: 'entity/project/run_id' (or shorter, using wandb defaults)."""
    import wandb

    api = wandb.Api()
    return api.run(run_path)


def run_config(run_path: str) -> dict:
    return dict(get_run(run_path).config)


def download_checkpoint(
    run_path: str, target_dir: Path, *, which: str = "last"
) -> Path:
    """Download a run's checkpoint files matching ``which`` into target_dir."""
    run = get_run(run_path)
    target_dir = Path(target_dir)
    target_dir.mkdir(parents=True, exist_ok=True)
    matches = [f for f in run.files() if which in f.name]
    if not matches:
        raise FileNotFoundError(f"No checkpoint matching {which!r} in {run_path}")
    for f in matches:
        f.download(root=str(target_dir), replace=True)
    return target_dir


def restart_checkpoint(run_path: str, target_dir: Path) -> Tuple[dict, Path]:
    """Resolve (config, checkpoint dir) for resuming from a wandb run — the
    ``restart_from`` protocol of the reference's ``train.py:174-195``."""
    config = run_config(run_path)
    ckpt = download_checkpoint(run_path, target_dir, which="last")
    return config, ckpt
