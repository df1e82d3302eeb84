"""Autoregressive baseline tasks (TF-Net, DilResNet).

Port of ``generative_turbulence_tpu/training/regression_task.py`` with the
interface of the port's ``DiffusionTask``: the train state lives in the task
(``step``, the optimizer state, and DilResNet's delta statistics
``dx_mean``, ``dx_var``, ``n_tracked``), ``training_step(cells, grid,
noise)`` takes one micro-step, ``eval_step(batch, noise, phase)`` rolls a
batch out and stores the configured sample steps, and ``state_dict`` /
``load_state_dict`` carry the state through checkpoints.

The rollout is a Python loop over forecast steps with inside-mask freezing
of boundary values.  DilResNet trains on normalized deltas whose running
statistics (momentum 0.1, the unbiased batch variance) freeze after
``N_TRACK_BATCHES`` micro-steps; until then the target is normalized by the
batch's own statistics.  TF-Net's BatchNorm statistics are parameters, as in
the JAX task (``models/tfnet.py``).

In a ``torch.distributed`` run the train step runs the net under
``DistributedDataParallel`` (``train_net``), which averages the gradients
(TF-Net's BatchNorm statistics among them) over the ranks, and DilResNet's
batch statistics are those of the global batch.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..data.dataset import Batch
from ..data.grid import GridMap, embed_cells, gather_cells
from ..data.schema import FieldStats
from ..data.variables import Variable, channel_slices, total_dims
from ..diffusion.gaussian import NoiseFn
from ..eval.metrics import SampleMetricsCollection
from ..eval.sample_store import SampleStore
from ..models.conditioning import Conditioning
from ..models.dilresnet import DilResNet
from ..models.normalization import Normalizer
from ..models.tfnet import TFNet
from ..parallel.distributed import data_parallel, mean_over_ranks, process_rank_and_world, sum_over_ranks
from ..toolchain.from_flax import torch_state_dict_from_flax
from .config import ModelConfig
from .diffusion_task import _net_dtype
from .optimizers import OptState, build_optimizer


class RegressionTaskBase:
    """Shared harness: unrolled prediction, the train state, the eval
    protocol and one sample store per configured sample step.

    ``data_root`` (the dataset root holding ``val/`` and ``test/``) and
    ``samples_root`` set up evaluation: the stores
    ``samples_root/{val,test}-<s>-samples.npyd`` and a metric collection per
    sample step ``s``, on ``device``."""

    def __init__(
        self,
        cfg: ModelConfig,
        stats: FieldStats,
        device="cuda",
        *,
        max_train_steps: int = 1,
        gradient_clip_val: Optional[float] = 0.1,
        data_root: Optional[Path] = None,
        samples_root: Optional[Path] = None,
        wasserstein_solver: str = "sinkhorn",
    ):
        self.cfg = cfg
        self.device = torch.device(device)
        self.variables = Variable.parse_tuple(cfg.variables)
        if Variable.U not in self.variables:
            raise ValueError(f"the regression tasks need u among their variables, got {cfg.variables!r}")
        self.n_features = total_dims(self.variables)
        self.normalizer = Normalizer.from_stats(stats, self.variables, cfg.normalization_mode)
        self.monitor = cfg.monitor
        self.context_window = cfg.context_window
        self.unroll_steps = cfg.unroll_steps
        self.eval_unroll_steps = cfg.eval_unroll_steps
        self.sample_steps = tuple(cfg.sample_steps)
        if self.sample_steps and self.eval_unroll_steps < max(self.sample_steps):
            raise ValueError(f"sample_steps {self.sample_steps} beyond eval_unroll_steps {self.eval_unroll_steps}")

        self.dtype = _net_dtype(cfg.compute_dtype)
        self.conditioning = None
        if cfg.cell_type_features or cfg.cell_pos_features:
            self.conditioning = Conditioning(
                cell_type_features=cfg.cell_type_features,
                cell_type_embedding=cfg.cell_type_embedding_type,
                cell_type_embedding_dim=cfg.cell_type_embedding_dim,
                cell_pos_features=cfg.cell_pos_features,
                dtype=self.dtype or torch.float32,
            )
        self.net = self._build_net().to(self.device)
        self.tx = build_optimizer(
            optimizer=cfg.optimizer,
            learning_rate=cfg.learning_rate,
            min_learning_rate=cfg.min_learning_rate,
            lr_decay=cfg.lr_decay,
            max_train_steps=max_train_steps,
            gradient_clip_val=gradient_clip_val,
            accumulate_steps=cfg.accumulate_steps,
        )
        self.step = 0
        self.opt_state: Optional[OptState] = None
        self._train_net: Optional[torch.nn.Module] = None
        self._reset_delta_stats()

        self.sample_stores: Dict[str, Dict[int, SampleStore]] = {}
        self.metrics: Dict[str, Dict[int, SampleMetricsCollection]] = {}
        if data_root is not None:
            if samples_root is None:
                raise ValueError("evaluation needs a samples_root beside the data_root")
            for phase in ("val", "test"):
                self.sample_stores[phase] = {
                    s: SampleStore(Path(samples_root) / f"{phase}-{s}-samples.npyd", self.variables)
                    for s in self.sample_steps
                }
                self.metrics[phase] = {
                    s: SampleMetricsCollection(
                        f"{phase}/{s}", Path(data_root) / phase,
                        SampleMetricsCollection.default_metrics(wasserstein_solver, device=self.device),
                    )
                    for s in self.sample_steps
                }

    def _build_net(self) -> torch.nn.Module:
        raise NotImplementedError

    # ---- state ---------------------------------------------------------------

    def _reset_delta_stats(self) -> None:
        self.dx_mean = torch.zeros(self.n_features, device=self.device)
        self.dx_var = torch.ones(self.n_features, device=self.device)
        self.n_tracked = 0

    def init_state(self) -> None:
        """A fresh train state for the current parameters: step 0, zero
        optimizer moments, the delta statistics at (0, 1)."""
        self.step = 0
        self.opt_state = self.tx.init(list(self.net.parameters()))
        self._reset_delta_stats()

    def init_weights(self, generator: Optional[torch.Generator] = None) -> "RegressionTaskBase":
        """Draw the parameters (flax's initializers) from ``generator`` and
        make a fresh train state."""
        self.net.init_weights(generator)
        self.init_state()
        return self

    def load_flax_params(self, params: Mapping) -> None:
        """Load a flax parameter tree (nested dicts of numpy arrays; TF-Net's
        with its ``batch_stats`` collection) and make a fresh train state."""
        state = torch_state_dict_from_flax(params)
        self.net.load_state_dict({k: v.to(self.device) for k, v in state.items()})
        self.init_state()

    def n_params(self) -> int:
        return sum(p.numel() for p in self.net.parameters())

    @property
    def train_net(self) -> torch.nn.Module:
        """``net`` as the train step calls it: under
        ``DistributedDataParallel`` in a process group."""
        if self._train_net is None:
            self._train_net = data_parallel(self.net)
        return self._train_net

    def state_dict(self) -> Dict:
        """The train state for a checkpoint; holds the live tensors."""
        if self.opt_state is None:
            self.init_state()
        return {"step": self.step, "net": self.net.state_dict(), "opt": dict(vars(self.opt_state)),
                "dx_mean": self.dx_mean, "dx_var": self.dx_var, "n_tracked": self.n_tracked}

    def load_state_dict(self, state: Mapping) -> None:
        move = lambda ts: None if ts is None else [t.to(self.device) for t in ts]  # noqa: E731
        self.net.load_state_dict(state["net"])
        opt = dict(state["opt"])
        opt.update(mu=move(opt["mu"]), nu=move(opt["nu"]), acc=move(opt["acc"]))
        self.opt_state = OptState(**opt)
        self.step = int(state["step"])
        self.dx_mean = state["dx_mean"].to(self.device)
        self.dx_var = state["dx_var"].to(self.device)
        self.n_tracked = int(state["n_tracked"])

    def _model_input(self, cells: torch.Tensor, grid: GridMap) -> torch.Tensor:
        """(B, T, n_cells, F) -> normalized dense (B, T, X, Y, Z, F) in f32
        (the net casts to its compute dtype itself)."""
        return self.normalizer.normalize(embed_cells(cells, grid)).float()

    # ---- rollout ---------------------------------------------------------------

    def _forecast_one(self, ctx: torch.Tensor, grid: GridMap, net: torch.nn.Module) -> torch.Tensor:
        """One-step prediction by ``net`` from context (B, W, X, Y, Z, F) ->
        (B, X, Y, Z, F)."""
        raise NotImplementedError

    def _predict_x(self, x_context: torch.Tensor, grid: GridMap, n_steps: int,
                   net: Optional[torch.nn.Module] = None) -> torch.Tensor:
        """Unroll ``n_steps`` with boundary values frozen (inside-mask select):
        (B, n_steps, X, Y, Z, F); ``net`` defaults to ``self.net``."""
        net = self.net if net is None else net
        inside = grid.inside_mask[..., None]
        ctx, xs = x_context, []
        for _ in range(n_steps):
            x_hat = torch.where(inside, self._forecast_one(ctx, grid, net), ctx[:, -1])
            ctx = torch.cat([ctx[:, 1:], x_hat[:, None]], dim=1)
            xs.append(x_hat)
        return torch.stack(xs, dim=1)

    # ---- train/eval steps --------------------------------------------------------

    def _loss(self, x: torch.Tensor, grid: GridMap, noise: NoiseFn) -> torch.Tensor:
        """The unrolled MSE against the targets after the context."""
        x_ctx, x_tgt = x[:, : self.context_window], x[:, self.context_window :]
        x_hat = self._predict_x(x_ctx, grid, x_tgt.shape[1], self.train_net)
        return torch.mean((x_hat - x_tgt) ** 2)

    def training_step(self, cells: torch.Tensor, grid: GridMap, noise: NoiseFn) -> Dict[str, torch.Tensor]:
        """One micro-step on ``cells`` (B, T, n_cells, F): the loss, its
        gradients (left in each parameter's ``.grad``) and the optimizer (an
        update on every ``cfg.accumulate_steps``-th micro-step).  ``noise``
        supplies the random draws (DilResNet's input noise).  Returns
        ``{"train/loss": loss}`` as a device tensor: no sync with the host;
        in a group of several ranks, as in ``DiffusionTask.training_step``,
        the gradients are the global batch's and the loss is the mean over
        the ranks."""
        if self.opt_state is None:
            self.init_state()
        params = list(self.net.parameters())
        for p in params:
            p.grad = None
        loss = self._loss(self._model_input(cells, grid), grid, noise)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        self.tx.step_(params, grads, self.opt_state)
        self.step += 1
        return {"train/loss": mean_over_ranks(loss.detach())}

    @torch.no_grad()
    def eval_step(self, batch: Batch, noise: NoiseFn, phase: str) -> Dict[str, float]:
        """Roll ``batch`` (moved to the task's device) out over its target
        frames: ``{phase}/loss`` over the first ``unroll_steps`` and
        ``{phase}/unroll/mse-<var>-<i>`` per step and variable (normalized
        by the true cell count, averaged over the batch); only the
        configured sample steps leave the device, into their stores."""
        batch = batch.to(self.device)
        grid = batch.grid
        x = self._model_input(batch.cells, grid)
        x_ctx, x_tgt = x[:, : self.context_window], x[:, self.context_window :]
        x_hat = self._predict_x(x_ctx, grid, x_tgt.shape[1])
        n = self.unroll_steps
        loss = torch.mean((x_hat[:, :n] - x_tgt[:, :n]) ** 2)
        s_cells = gather_cells(self.normalizer.denormalize(x_hat), grid)
        t_cells = gather_cells(self.normalizer.denormalize(x_tgt), grid)
        err2 = (s_cells - t_cells) ** 2  # (B, T, N, F)
        mse = {v.key: (err2[..., sl].sum(dim=(-2, -1)) / grid.n_cells).mean(dim=0)
               for v, sl in channel_slices(self.variables).items()}
        samples = s_cells[:, [s - 1 for s in self.sample_steps]].cpu().numpy()
        for j, store in enumerate(self.sample_stores[phase].values()):
            store.add_samples(samples[:, j], batch.metadata)
        out = {f"{phase}/loss": float(loss)}
        for key, per_step in mse.items():
            for i, value in enumerate(per_step.cpu().tolist()):
                out[f"{phase}/unroll/mse-{key}-{i + 1}"] = value
        return out

    def on_eval_start(self, phase: str) -> None:
        for store in self.sample_stores[phase].values():
            store.reset()

    def on_eval_end(self, stats: FieldStats, phase: str, *, expensive: bool) -> Dict[str, float]:
        """Each sample step's metrics over its store; those of
        ``cfg.main_sample_step`` also under the phase's own names
        (``val/<x>`` from ``val/<s>/<x>``)."""
        expensive = expensive and self.cfg.compute_expensive_sample_metrics
        metrics: Dict[str, float] = {}
        for s, collection in self.metrics[phase].items():
            step_metrics = collection.compute(self.sample_stores[phase][s], stats, expensive_metrics=expensive)
            metrics.update(step_metrics)
            if s == self.cfg.main_sample_step:
                for key, value in step_metrics.items():
                    parts = key.split("/")
                    metrics["/".join([parts[0], *parts[2:]])] = value
        return metrics

    @torch.no_grad()
    def unroll_samples(self, batch: Batch, sample_steps, block_size: int) -> np.ndarray:
        """Block-wise long rollout (memory-bounded): denormalized cell values
        (B, len(sample_steps), n_cells, F) of the given steps."""
        if block_size < self.context_window:
            raise ValueError(f"block_size {block_size} below the context window {self.context_window}")
        batch = batch.to(self.device)
        grid = batch.grid
        x_ctx = self._model_input(batch.cells, grid)[:, : self.context_window]
        outputs = []
        for i in range(0, max(sample_steps) + 1, block_size):
            x_hat = self._predict_x(x_ctx, grid, block_size)
            x_ctx = x_hat[:, -self.context_window :]
            idxs = [j - i for j in sample_steps if i <= j < i + block_size]
            if idxs:
                outputs.append(gather_cells(self.normalizer.denormalize(x_hat[:, idxs]), grid).cpu().numpy())
        return np.concatenate(outputs, axis=1)


class TFNetTask(RegressionTaskBase):
    def _build_net(self) -> TFNet:
        return TFNet(
            n_features=self.n_features,
            context_window=self.cfg.context_window,
            temporal_filtering_length=self.cfg.temporal_filtering_length,
            kernel_size=self.cfg.kernel_size,
            conditioning=self.conditioning,
            dtype=self.dtype,
        )

    def _forecast_one(self, ctx: torch.Tensor, grid: GridMap, net: torch.nn.Module) -> torch.Tensor:
        return net(ctx, grid.cell_types)


class DilResNetTask(RegressionTaskBase):
    """Delta prediction with running statistics frozen after
    ``N_TRACK_BATCHES`` micro-steps."""

    N_TRACK_BATCHES = 1000
    BN_MOMENTUM = 0.1

    def _build_net(self) -> DilResNet:
        if self.unroll_steps != 1:
            raise ValueError(f"DilResNet training uses unroll_steps=1, got {self.unroll_steps}")
        return DilResNet(
            n_features=self.n_features,
            N=self.cfg.N,
            hidden_dim=self.cfg.hidden_dim,
            conditioning=self.conditioning,
            dtype=self.dtype,
        )

    def _forecast_one(self, ctx: torch.Tensor, grid: GridMap, net: torch.nn.Module) -> torch.Tensor:
        x_last = ctx[:, -1]
        dx_normed = net(x_last, grid.cell_types)
        return x_last + (self.dx_mean + torch.sqrt(self.dx_var) * dx_normed)

    def _loss(self, x: torch.Tensor, grid: GridMap, noise: NoiseFn) -> torch.Tensor:
        """The MSE of the normalized delta at in-domain cells; updates the
        running delta statistics while they track."""
        x0 = x[:, self.context_window - 1]
        if self.cfg.training_noise_std is not None:
            x0 = x0 + self.cfg.training_noise_std * noise(x0.shape).to(x0.dtype)
        dx_cells = gather_cells(x[:, self.context_window] - x0, grid)  # (B, N, F)
        # The global batch's moments: the sums over every rank's equal rows.
        sums = sum_over_ranks(torch.stack([dx_cells.sum(dim=(0, 1)), (dx_cells**2).sum(dim=(0, 1))]))
        n = float(dx_cells.shape[0] * grid.n_cells * process_rank_and_world()[1])
        batch_mean = sums[0] / n
        batch_var = sums[1] / n - batch_mean**2

        if self.n_tracked < self.N_TRACK_BATCHES:
            m = self.BN_MOMENTUM
            # torch's running_var takes the unbiased batch variance
            unbiased = batch_var * n / max(n - 1, 1)
            norm_mean, norm_var = batch_mean, batch_var
            self.dx_mean = (1 - m) * self.dx_mean + m * batch_mean
            self.dx_var = (1 - m) * self.dx_var + m * unbiased
        else:
            norm_mean, norm_var = self.dx_mean, self.dx_var
        self.n_tracked += 1
        dx_target = (dx_cells - norm_mean) / torch.sqrt(norm_var + 1e-5)
        dx_hat_cells = gather_cells(self.train_net(x0, grid.cell_types), grid)
        return torch.mean((dx_hat_cells - dx_target) ** 2)
