"""Build the datamodule and the task from a resolved ``Config``.

Port of ``generative_turbulence_tpu/training/factory.py``:
``model.name`` picks the diffusion task over ``DataModule`` or a regression
baseline (TF-Net, DilResNet) over ``SequenceDataModule``.  Gradient
accumulation feeds micro-batches of ``batch_size // accumulate_steps``; the
learning-rate schedule spans ``max_epochs`` epochs of optimizer updates.

The data fields of the JAX package's device frame caches change the
values its training batches have, so the data modules take them for that
and nothing else: ``device_cache_gb`` and ``transfer_dtype`` (bf16 training
frames) and, for the window module, ``cell_bucket`` (only for its cache's
capacity in bucket-padded bytes).  Not read: ``eval_device_cache_gb`` (JAX's
eval caches are float32 and change no value), ``buffer_pool`` (the port's
training batches always come in the order JAX's pooled collation gives,
its default) and ``device_prefetch`` (batches always reach the device in
the prefetch thread, as they do in JAX with its default).
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
            device_cache_gb=dc.device_cache_gb,
            transfer_dtype=dc.transfer_dtype,
        )
        task_cls = DiffusionTask
    elif mc.name in ("tfnet", "dilresnet"):
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
            cell_bucket=dc.cell_bucket,
            device_cache_gb=dc.device_cache_gb,
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
