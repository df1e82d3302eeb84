"""The training loop: epochs, periodic validation, checkpointing, time limit.

Port of ``generative_turbulence_tpu/training/loop.py`` over the port's
tasks, which hold their train state (``DiffusionTask``, ``TFNetTask``,
``DilResNetTask``): check_val_every_n_epoch semantics, a wall-clock train
limit that forces a final validation before stopping, last +
best-on-monitor checkpoints, JSONL/wandb metric logging, early stopping,
resume, and optional test evaluation of the final state.

Randomness is keyed as in the JAX loop, through one injectable
``noise_factory(kind, *key) -> NoiseFn``:

    ("train", step)                 the train step's draws
    ("val", fold, case, k)          batch k of a val case; fold = 10_000 + epoch,
                                    None with trainer.deterministic_eval
    ("diagnostics", fold)           the eps-loss diagnostics of a validation
    ("test", case, k)               batch k of a test case

The default, ``KeyedNoise``, seeds a ``torch.Generator`` on the run's device
from (trainer.seed, kind, *key) by a fixed hash: a killed-and-resumed run
draws what an unkilled one draws, and a case's draws do not depend on the
order of the cases.  Tests replay the JAX loop's draws through it.

In a ``torch.distributed`` run (``parallel.distributed``) every rank runs
this loop on its dp group's rows of the global batches, with those rows of
the step's global draws (``parallel.mesh.RankRows``); the stop decisions
(time limit, max_steps, early stopping) are taken alike on every rank; only
rank 0 writes logs and checkpoints; with ``data.shard_eval`` each dp group
validates its own cases and the metrics and the diagnostics are merged.
``trainer.mesh_shape`` is None (``(world size, 1)``) or ``(dp, sp)`` with
dp x sp = world: the sp ranks of a group share each step's rows and cases
and hold x slabs of its grids (``parallel.spatial``; the diffusion task
only).
"""

from __future__ import annotations

import hashlib
import re
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..diffusion.gaussian import GeneratorNoise, NoiseFn
from ..parallel.distributed import allgather_objects, process_rank_and_world, reduce_host_value
from ..parallel.mesh import init_mesh, rank_noise
from .checkpoint import CheckpointManager
from .config import Config
from .logging import MetricLogger

NoiseFactory = Callable[..., NoiseFn]


def _mean_over_batches(outputs) -> Dict[str, float]:
    """Average per-batch eval-step metric dicts key-wise."""
    merged: Dict[str, list] = {}
    for out in outputs:
        for k, v in out.items():
            merged.setdefault(k, []).append(float(v))
    return {k: float(np.mean(v)) for k, v in merged.items()}


def parse_duration(spec: Optional[str]) -> Optional[float]:
    """'24h' / '30m' / '90s' / '1d' -> seconds."""
    if spec is None:
        return None
    m = re.fullmatch(r"(\d+(?:\.\d+)?)([dhms])", spec.strip())
    if not m:
        raise ValueError(f"Bad duration {spec!r}; use e.g. 24h, 30m, 90s")
    value, unit = float(m.group(1)), m.group(2)
    return value * {"d": 86400, "h": 3600, "m": 60, "s": 1}[unit]


def key_seed(*key) -> int:
    """A 63-bit seed from a tuple of ints, strings and None, the same in
    every process (Python's ``hash`` of a string is salted per process)."""
    digest = hashlib.blake2b(repr(tuple(key)).encode("utf-8"), digest_size=8).digest()
    return int.from_bytes(digest, "little") & (2**63 - 1)


class KeyedNoise:
    """The default noise factory: a ``GeneratorNoise`` on ``device`` whose
    generator is seeded with ``key_seed(seed, kind, *key)``."""

    def __init__(self, seed: int, device):
        self.seed, self.device = int(seed), torch.device(device)

    def __call__(self, kind: str, *key) -> GeneratorNoise:
        generator = torch.Generator(device=self.device).manual_seed(key_seed(self.seed, kind, *key))
        return GeneratorNoise(generator, self.device)


class Trainer:
    """Fits ``task`` on ``datamodule`` as ``config.trainer`` says; the task's
    device is the run's."""

    def __init__(
        self,
        config: Config,
        task,
        datamodule,
        *,
        use_wandb: Optional[bool] = None,
        noise_factory: Optional[NoiseFactory] = None,
    ):
        self.config = config.resolved()
        self.task = task
        self.dm = datamodule
        self.device = task.device
        tc = self.config.trainer
        self.rank, self.world = process_rank_and_world()
        self.mesh = init_mesh(tc.mesh_shape)
        if self.mesh.sp > 1 and not hasattr(task, "spatial_axis"):
            raise ValueError(f"trainer.mesh_shape={tuple(tc.mesh_shape)}: {type(task).__name__} has no spatial "
                             "axis (sp > 1 shards the diffusion task's grids)")
        self.out_dir = Path(tc.out_dir)
        if use_wandb is None:
            use_wandb = tc.use_wandb
        self.logger = MetricLogger(
            self.out_dir,
            use_wandb=use_wandb,
            wandb_kwargs={"project": tc.wandb_project, "name": tc.wandb_run_name, "config": self.config.to_dict()},
        )
        self.ckpt = CheckpointManager(self.out_dir / "checkpoints", self.config.to_json())
        self.time_limit = parse_duration(tc.train_limit)
        self.monitor = task.monitor
        self.noise_factory = noise_factory or KeyedNoise(tc.seed, self.device)
        self._vals_since_best = 0
        self._last_epoch_loss: Optional[float] = None
        if self.world > 1:
            m = self.mesh
            print(f"[rank {self.rank}/{self.world}] mesh ({m.dp}, {m.sp}): dp {m.dp_index}, sp {m.sp_index}",
                  file=sys.stderr, flush=True)

    def fit(self, state=None) -> Dict[str, float]:
        """Train from ``state`` (a task ``state_dict``), or from weights drawn
        from a generator seeded with ``trainer.seed`` (then restored from
        ``trainer.resume_from`` when set).  Returns the last validation's
        metrics (and the test metrics with ``trainer.eval_testset``)."""
        tc = self.config.trainer
        self.dm.setup("fit")

        if state is None:
            self.task.init_weights(torch.Generator(device=self.device).manual_seed(tc.seed))
            self.logger.console(f"initialized model with {self.task.n_params():,} parameters")
            if tc.resume_from:
                ckpt = CheckpointManager(Path(tc.resume_from)).restore("last", map_location=self.device)
                self.task.load_state_dict(ckpt)
                self.logger.console(f"resumed from {tc.resume_from} at step {self.task.step}")
        else:
            self.task.load_state_dict(state)

        start = time.time()
        stop = False
        last_val_metrics: Dict[str, float] = {}
        step = self.task.step
        profiler = None
        step_tic = time.perf_counter()

        # Epochs are GLOBAL: a resumed run starts at the epoch implied by the
        # restored step counter, so it replays the same per-epoch shuffle
        # order and validation cadence an unkilled run would have had, and
        # max_epochs bounds the TOTAL training length across restarts.
        n_batches = max(1, self.dm.n_train_batches())
        start_epoch = step // n_batches

        for epoch in range(start_epoch, tc.max_epochs):
            if stop:
                break
            epoch_losses = []
            for batch in self.dm.train_batches(epoch):
                if tc.profile_steps > 0 and step == tc.profile_start and profiler is None:
                    profiler = self._start_profile()
                batch = batch.to(self.device)
                noise = rank_noise(self.noise_factory("train", step))
                metrics = self.task.training_step(batch.cells, batch.grid, noise)
                step += 1
                if profiler is not None and step >= tc.profile_start + tc.profile_steps:
                    self._stop_profile(profiler)
                    profiler = None
                # No per-step host sync: the loss leaves the device only at
                # the log boundary; the epoch mean uses that logged subset.
                if step % tc.log_every_n_steps == 0:
                    metrics = {k: float(v) for k, v in metrics.items()}
                    epoch_losses.append(metrics["train/loss"])
                    now = time.perf_counter()
                    metrics["steps_per_sec"] = tc.log_every_n_steps / (now - step_tic)
                    step_tic = now
                    self.logger.log(metrics, step=step, epoch=epoch)
                # Each rank reads its own clock: the slowest decides for all.
                if self.time_limit is not None and reduce_host_value(time.time() - start > self.time_limit, "max"):
                    self.logger.console("train limit reached; running final validation")
                    stop = True
                    break
                if tc.max_steps is not None and step >= tc.max_steps:
                    self.logger.console(f"max_steps={tc.max_steps} reached")
                    stop = True
                    break

            if epoch_losses:
                self._last_epoch_loss = float(np.mean(epoch_losses))
                loss_str = f"{self._last_epoch_loss:.5f}"
            elif self._last_epoch_loss is not None:
                # No step hit the log boundary this epoch: show the last
                # fetched value instead of a misleading nan.
                loss_str = f"~{self._last_epoch_loss:.5f}"
            else:
                loss_str = "(pending first log step)"
            self.logger.console(f"epoch {epoch}: train/loss={loss_str} ({step} steps)")

            final_epoch = stop or epoch == tc.max_epochs - 1
            if final_epoch or (epoch + 1) % tc.check_val_every_n_epoch == 0:
                val_metrics = self.validate(expensive=final_epoch, epoch=epoch)
                last_val_metrics = val_metrics
                if self.monitor in val_metrics:
                    is_best = self.ckpt.save_best(self.task.state_dict(), step, val_metrics[self.monitor])
                    self.logger.update_best(self.monitor, val_metrics, step)
                    if is_best:
                        self._vals_since_best = 0
                    else:
                        self._vals_since_best += 1
                        patience = tc.early_stopping_patience
                        if patience is not None and self._vals_since_best >= patience:
                            self.logger.console(f"early stopping: {self.monitor} stale for {patience} validations")
                            stop = True

            if (epoch + 1) % tc.checkpoint_every_n_epochs == 0 or final_epoch:
                self.ckpt.save_last(self.task.state_dict(), step)
            stop = bool(reduce_host_value(stop, "max"))

        if profiler is not None:
            self._stop_profile(profiler)
        if tc.eval_testset:
            last_val_metrics.update(self.test())
        return last_val_metrics

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profile(self, profiler) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        trace = self.out_dir / "profile" / ("trace.json" if self.world == 1 else f"trace.rank{self.rank}.json")
        trace.parent.mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(str(trace))
        self.logger.console(f"profiler trace in {trace}")

    def validate(self, *, expensive: bool = False, epoch: int = 0) -> Dict[str, float]:
        tc = self.config.trainer
        self.dm.setup("validate")
        has_diag = hasattr(self.task, "eval_diagnostics")
        self.task.on_eval_start("val")
        step_outputs = []
        # The epoch is folded in so successive validations draw fresh noise;
        # deterministic_eval draws the same noise every validation.
        fold = None if tc.deterministic_eval else 10_000 + epoch
        batch_in_case: Dict[str, int] = {}
        diagnostics: Dict[str, float] = {}
        # Diagnostics run on ONE canonical batch: the first batch of the
        # globally-first val case, so that under shard_eval every rank ends
        # with the values of the single-process run: exactly one rank owns
        # that case, and the others receive its dict through the merge below.
        first_case = self.dm.first_val_case() if has_diag else None
        for batch in self.dm.val_batches():
            case = batch.metadata.case_name
            k = batch_in_case.get(case, 0)
            batch_in_case[case] = k + 1
            if has_diag and not diagnostics and case == first_case and k == 0:
                on_device = batch.to(self.device)
                diagnostics = self.task.eval_diagnostics(
                    on_device.cells, on_device.grid, self.noise_factory("diagnostics", fold)
                )
            out = self.task.eval_step(batch, self.noise_factory("val", fold, case, k), "val")
            if out:
                step_outputs.append(out)
        if has_diag and self.dm.shard_eval and self.world > 1:
            # Collective: every rank calls it once per validation, with an
            # empty dict where it does not own the case.
            diagnostics = next((d for d in allgather_objects(diagnostics) if d), diagnostics)
        metrics = self.task.on_eval_end(self.dm.stats, "val", expensive=expensive)
        metrics.update(diagnostics)
        metrics.update(_mean_over_batches(step_outputs))
        self.logger.log(metrics, step=self.task.step, epoch=epoch)
        if tc.render_plots and hasattr(self.task, "render_plots") and self.rank == 0:
            try:
                self.task.render_plots(self.out_dir, "val", self.task.step)
            except Exception as e:  # plots must never kill a run
                self.logger.console(f"plot rendering failed: {e}")
        summary = {k: v for k, v in metrics.items() if k.count("/") == 1}
        self.logger.console(f"validation: {summary}")
        return metrics

    def test(self) -> Dict[str, float]:
        """The test split with the task's current (final) state."""
        self.dm.setup("test")
        self.task.on_eval_start("test")
        step_outputs = []
        batch_in_case: Dict[str, int] = {}
        for batch in self.dm.test_batches():
            case = batch.metadata.case_name
            k = batch_in_case.get(case, 0)
            batch_in_case[case] = k + 1
            out = self.task.eval_step(batch, self.noise_factory("test", case, k), "test")
            if out:
                step_outputs.append(out)
        metrics = self.task.on_eval_end(self.dm.stats, "test", expensive=True)
        metrics.update(_mean_over_batches(step_outputs))
        self.logger.log(metrics, step=self.task.step)
        return metrics
