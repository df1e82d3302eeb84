"""Build the datamodule and the task from a resolved ``Config``.

Port of ``generative_turbulence_tpu/training/factory.py``:
``model.name`` picks the diffusion task over ``DataModule`` or a regression
baseline (TF-Net, DilResNet) over ``SequenceDataModule``.  Gradient
accumulation feeds micro-batches of ``batch_size // accumulate_steps``; the
learning-rate schedule spans ``max_epochs`` epochs of optimizer updates.

The data fields of the JAX package's TPU workarounds are read by nothing
here (ROADMAP queue 1 leaves them out for good): ``cell_bucket``,
``buffer_pool``, ``device_cache_gb``, ``eval_device_cache_gb``,
``transfer_dtype`` and ``device_prefetch``.  Batches always reach the device
in the prefetch thread.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

from ..data.dataset import DataModule
from ..data.sequence import SequenceDataModule
from ..data.variables import Variable
from .config import Config
from .diffusion_task import DiffusionTask
from .regression_task import DilResNetTask, TFNetTask


def instantiate_data_and_task(config: Config, device="cuda") -> Tuple[object, object]:
    """(datamodule, task) for ``config`` on ``device``; the datamodule's
    batches arrive on that device."""
    config = config.resolved()
    mc, dc, tc = config.model, config.data, config.trainer
    variables = Variable.parse_tuple(mc.variables)
    root = Path(dc.root)

    # Gradient accumulation: feed micro-batches of batch/k; the optimizer
    # updates every k micro-batches, keeping the effective batch unchanged.
    k = max(1, mc.accumulate_steps)
    micro_batch = max(1, dc.batch_size // k)

    if mc.name == "diffusion":
        # cell_bucket, buffer_pool, device_cache_gb, transfer_dtype and
        # device_prefetch are TPU-host workarounds the port leaves out.
        dm = DataModule(
            root,
            discard_first_seconds=dc.discard_first_seconds,
            batch_size=micro_batch,
            eval_batch_size=dc.eval_batch_size,
            val_samples=dc.val_samples,
            test_samples=dc.test_samples,
            variables=variables,
            prefetch_size=dc.prefetch_size,
            seed=tc.seed,
            shard_by_host=dc.shard_by_host,
            shard_eval=dc.shard_eval,
            device=device,
        )
        task_cls = DiffusionTask
    elif mc.name in ("tfnet", "dilresnet"):
        # cell_bucket, device_cache_gb and eval_device_cache_gb are TPU-host
        # workarounds the port leaves out.
        dm = SequenceDataModule(
            root,
            discard_first_seconds=dc.discard_first_seconds,
            batch_size=micro_batch,
            seq_len=mc.context_window + mc.unroll_steps,
            eval_batch_size=dc.eval_batch_size,
            eval_seq_len=mc.context_window + mc.eval_unroll_steps,
            val_samples=dc.val_samples,
            test_samples=dc.test_samples,
            variables=variables,
            stride=dc.stride,
            prefetch_size=dc.prefetch_size,
            seed=tc.seed,
            device=device,
        )
        task_cls = TFNetTask if mc.name == "tfnet" else DilResNetTask
    else:
        raise ValueError(f"Unknown model {mc.name!r}")

    dm.setup("fit")
    # LR schedule length = epochs * optimizer updates per epoch; with
    # accumulation, updates = batches / k.
    max_train_steps = max(1, (tc.max_epochs or mc.max_epochs) * dm.n_train_batches() // k)
    task = task_cls(
        mc, dm.stats, device, max_train_steps=max_train_steps, gradient_clip_val=tc.gradient_clip_val,
        data_root=root, samples_root=Path(tc.samples_root), wasserstein_solver=tc.wasserstein_solver,
    )
    return dm, task
