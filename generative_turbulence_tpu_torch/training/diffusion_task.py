"""The diffusion task: training step, diagnostics, sampling and evaluation.

Port of ``generative_turbulence_tpu/training/diffusion_task.py``:
``DiffusionTask`` is built from a ``ModelConfig`` and the training-set
``FieldStats`` and wires the normalizer, the conditioning, the
epsilon-network (and its eval-dtype twin), ``GaussianDiffusion`` and the
optimizer together.  ``training_step`` takes one optimizer step on the
diffusion loss (with gradient accumulation, clipping and the warm-up EMA);
``eval_diagnostics`` gives the masked epsilon-loss at 8 timesteps;
``DiffusionTask.sample`` follows ``cfg.sampler`` with the EMA parameters
when ``cfg.ema_decay > 0``.  The free ``sample`` function is the sampling
step itself (``_sample_fn``): embed the cells into the dense grid,
normalize, run a sampler with the epsilon-network, denormalize, and gather
the cells back.  With a dataset root, the task also evaluates:
``eval_step`` samples a batch into the phase's sample store, and
``on_eval_end`` scores the store with the phase's metric collection
(``val/tke`` and the rest), and ``render_plots`` draws its diagnostics.

On a ``(dp, sp)`` mesh with sp > 1 (``parallel.mesh.init_mesh``; the JAX
package's ``constrain_dense`` of the model input) the train step, the
diagnostics and the samplers run on this rank's x slab of the dense grid
(``parallel.spatial``): the input is embedded whole and cut to the slab,
the draws are the whole group's cut the same way (``SlabNoise``), the loss
sums over the group, and a sampler gathers its result over the group once,
before ``gather_cells``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch.func import functional_call
from torch.profiler import record_function

from ..data.dataset import Batch
from ..data.grid import GridMap, embed_cells, gather_cells, x_slab_view
from ..data.schema import FieldStats
from ..data.variables import Variable, total_dims
from ..diffusion.gaussian import Bf16NormalLaw, GaussianDiffusion, NoiseFn
from ..eval.metrics import SampleMetricsCollection
from ..eval.sample_store import SampleStore
from ..models.conditioning import Conditioning
from ..models.normalization import Normalizer
from ..models.unet import DenoisingModel
from ..parallel.distributed import data_parallel, mean_over_ranks
from ..parallel.mesh import mesh_layout
from ..parallel.spatial import SlabNoise, SpatialAxis, gather_x, slab_of, slab_on
from ..toolchain.from_flax import torch_state_dict_from_flax
from .config import ModelConfig
from .optimizers import OptState, build_optimizer


@torch.inference_mode()
def sample(
    model: DenoisingModel,
    diffusion: GaussianDiffusion,
    normalizer: Normalizer,
    cells: torch.Tensor,
    grid: GridMap,
    *,
    sampler: str = "ddim",
    ddim_steps: int = 50,
    ddim_eta: float = 0.0,
    noise: NoiseFn,
    start_from: Optional[int] = None,
    axis: Optional[SpatialAxis] = None,
) -> torch.Tensor:
    """Sample (B, n_cells, F) cell values for the geometry of ``grid``.

    ``cells`` (B, n_cells, F) supply the boundary values (only the grid's
    non-domain cells of their embedding matter).  ``sampler`` is "ddim"
    (``ddim_steps``, ``ddim_eta``) or "ddpm" (ancestral over all steps, or
    the last ``start_from``).  ``noise`` is the sampler's normal source.
    ``model(x, t, cell_types)``; with a spatial ``axis`` of sp > 1 the
    sampler runs on this rank's x slab, ``model`` takes it as ``slab=``,
    and every rank of the group returns the whole samples.
    """
    if sampler not in ("ddim", "ddpm"):
        raise ValueError(f"Unknown sampler {sampler!r}")
    x_bcs = normalizer.normalize(embed_cells(cells, grid))
    x_bcs, step_grid, noise = x_slab_inputs(axis, x_bcs, grid, noise)
    on_slab = {} if step_grid.slab is None else {"slab": step_grid.slab}

    def eps_fn(x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return model(x_t, t, grid.cell_types, **on_slab)

    if sampler == "ddim":
        x = diffusion.ddim_sample_loop(
            eps_fn, x_bcs, step_grid, noise, num_steps=ddim_steps, eta=ddim_eta
        )
    else:
        x = diffusion.p_sample_loop(eps_fn, x_bcs, step_grid, noise, start_from=start_from)
    if step_grid.slab is not None:
        x = gather_x(x, step_grid.slab)
    return gather_cells(normalizer.denormalize(x), grid)


def x_slab_inputs(axis: Optional[SpatialAxis], x: torch.Tensor, grid: GridMap, noise):
    """``(x, grid, noise)`` as a rank of a spatial axis of sp > 1 works on
    them: its x slab of the whole dense x, the grid's view of it (which
    carries the ``Slab``), and its slabs of the group's draws; themselves
    without one."""
    slab = slab_on(axis, grid.shape[0])
    if slab is None:
        return x, grid, noise
    return slab_of(x, slab), x_slab_view(grid, slab), SlabNoise(noise, slab)


_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}


def _net_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """The config's dtype name as the modules' ``dtype`` (None = f32)."""
    if name not in _DTYPES:
        raise ValueError(f"Unknown compute dtype {name!r}")
    return _DTYPES[name]


def _share_parameters(dst: torch.nn.Module, src: torch.nn.Module) -> None:
    """Make every parameter of ``dst`` the same tensor as ``src``'s (the two
    nets differ only in their compute dtype, as flax applies one parameter
    tree through either)."""
    for name, module in dst.named_modules():
        other = src.get_submodule(name)
        for pname, _ in list(module.named_parameters(recurse=False)):
            setattr(module, pname, getattr(other, pname))


class DiffusionTask:
    """The JAX package's ``DiffusionTask``.

    ``net`` computes in ``cfg.compute_dtype`` and trains; ``eval_net`` in
    ``cfg.eval_compute_dtype`` (None = the same) and samples.  Both hold the
    same parameters, in f32, on ``device``: set them with ``init_weights``
    or ``load_flax_params``.  The train state beside them is the micro-step
    count ``step``, the optimizer state ``opt_state`` and the f32 EMA
    parameters ``ema`` (None with ``cfg.ema_decay == 0``); ``init_state``
    makes it from the current parameters (``init_weights`` and
    ``load_flax_params`` do, and so does the first ``training_step``).
    ``max_train_steps`` is the learning-rate schedule's length in optimizer
    updates, ``gradient_clip_val`` the global-norm clip.

    ``data_root`` (the dataset root holding ``val/`` and ``test/``) and
    ``samples_root`` set up evaluation: the sample stores
    ``samples_root/{val,test}-samples.npyd`` and the metric collections
    (``SampleMetricsCollection.default_metrics``, with the point-cloud
    Wasserstein on ``wasserstein_solver``), each reading the ground truth of
    its own split, on ``device``.

    In a ``torch.distributed`` run ``training_step`` runs ``net`` under
    ``DistributedDataParallel`` (``train_net``), which averages the
    gradients over the ranks; everything else uses ``net`` itself, so the
    state dict's names are the same at any world size.  On a mesh with sp >
    1 (``parallel.mesh``) each rank's gradient is sp times its share of the
    sp group's (``parallel.spatial``), so that DDP's mean over all dp x sp
    ranks is the mean over dp of each group's gradient; the steps, the
    diagnostics and the samplers run on the rank's x slab.
    """

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
            raise ValueError(f"the diffusion task needs u among its variables, got {cfg.variables!r}")
        self.normalizer = Normalizer.from_stats(stats, self.variables, cfg.normalization_mode)
        self.monitor = cfg.monitor
        n_features = total_dims(self.variables)

        def build_net(net_dtype: Optional[torch.dtype]) -> DenoisingModel:
            conditioning = None
            if cfg.cell_type_features or cfg.cell_pos_features:
                conditioning = Conditioning(
                    cell_type_features=cfg.cell_type_features,
                    cell_type_embedding=cfg.cell_type_embedding_type,
                    cell_type_embedding_dim=cfg.cell_type_embedding_dim,
                    cell_pos_features=cfg.cell_pos_features,
                    dtype=net_dtype or torch.float32,
                )
            return DenoisingModel(
                out_features=n_features * (2 if cfg.learned_variances else 1),
                timesteps=cfg.timesteps,
                dim=cfg.dim,
                u_net_levels=cfg.u_net_levels,
                actfn_name=cfg.actfn,
                norm_type=cfg.norm_type,
                time_embedding=cfg.time_embedding,
                attention_kind=cfg.attention_kind,
                with_geometry_embedding=cfg.with_geometry_embedding,
                conditioning=conditioning,
                in_features=n_features,
                dtype=net_dtype,
                remat=cfg.remat,
            ).to(device)

        dtype = _net_dtype(cfg.compute_dtype)
        eval_dtype = dtype if cfg.eval_compute_dtype is None else _net_dtype(cfg.eval_compute_dtype)
        self.net = build_net(dtype)
        if eval_dtype == dtype:
            self.eval_net = self.net
        else:
            self.eval_net = build_net(eval_dtype)
            _share_parameters(self.eval_net, self.net)
        self.eval_net.eval()

        if cfg.clip_mode not in ("unit", "envelope"):
            raise ValueError(f"Unknown clip_mode {cfg.clip_mode!r}")
        clip_bounds = None
        if cfg.clip_denoised and cfg.clip_mode == "envelope":
            lo, hi = stats.envelope(self.variables)
            mean, std = self.normalizer.mean, self.normalizer.std
            clip_bounds = (
                (lo.astype(np.float32) - mean) / std,
                (hi.astype(np.float32) - mean) / std,
            )
        self.diffusion = GaussianDiffusion.create(
            beta_schedule=cfg.beta_schedule,
            timesteps=cfg.timesteps,
            loss_type=cfg.loss,
            clip_denoised=cfg.clip_denoised,
            noise_bcs=cfg.noise_bcs,
            learned_variances=cfg.learned_variances,
            elbo_weight=cfg.elbo_weight if cfg.learned_variances else None,
            detach_elbo_mean=cfg.detach_elbo_mean,
            parameterization=cfg.parameterization,
            loss_weighting=cfg.loss_weighting,
            clip_bounds=clip_bounds,
        )
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
        self.ema: Optional[Dict[str, torch.Tensor]] = None
        self._train_net: Optional[torch.nn.Module] = None

        self.sample_stores: Dict[str, SampleStore] = {}
        self.metrics: Dict[str, SampleMetricsCollection] = {}
        if data_root is not None:
            if samples_root is None:
                raise ValueError("evaluation needs a samples_root beside the data_root")
            for phase in ("val", "test"):
                self.sample_stores[phase] = SampleStore(Path(samples_root) / f"{phase}-samples.npyd", self.variables)
                self.metrics[phase] = SampleMetricsCollection(
                    phase, Path(data_root) / phase,
                    SampleMetricsCollection.default_metrics(wasserstein_solver, device=self.device),
                )

    # ---- state ---------------------------------------------------------------

    def init_state(self) -> None:
        """A fresh train state for the current parameters: step 0, zero
        optimizer moments, the EMA a copy of the parameters."""
        self.step = 0
        self.opt_state = self.tx.init(list(self.net.parameters()))
        self.ema = None
        if self.cfg.ema_decay > 0:
            self.ema = {name: p.detach().float().clone() for name, p in self.net.named_parameters()}

    def init_weights(self, generator: Optional[torch.Generator] = None) -> "DiffusionTask":
        """Draw the parameters (flax's initializers) from ``generator`` and
        make a fresh train state."""
        self.net.init_weights(generator)
        self.init_state()
        return self

    def load_flax_params(self, params: Mapping) -> None:
        """Load a flax ``DenoisingModel`` parameter tree (nested dicts of
        numpy arrays, with or without the ``"params"`` collection) and make a
        fresh train state."""
        self.net.load_state_dict(torch_state_dict_from_flax(params))
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
        """The train state for a checkpoint: step, parameters, optimizer
        state and EMA.  Like ``nn.Module.state_dict`` it holds the live
        tensors, which the next step updates in place."""
        if self.opt_state is None:
            self.init_state()
        return {"step": self.step, "net": self.net.state_dict(),
                "opt": dict(vars(self.opt_state)), "ema": self.ema}

    def load_state_dict(self, state: Mapping) -> None:
        device = next(self.net.parameters()).device
        move = lambda ts: None if ts is None else [t.to(device) for t in ts]  # noqa: E731
        self.net.load_state_dict(state["net"])
        opt = dict(state["opt"])
        opt.update(mu=move(opt["mu"]), nu=move(opt["nu"]), acc=move(opt["acc"]))
        self.opt_state = OptState(**opt)
        self.step = int(state["step"])
        ema = state["ema"]
        self.ema = None if ema is None else {k: v.to(device) for k, v in ema.items()}

    # ---- steps -----------------------------------------------------------------

    def _model_input(self, cells: torch.Tensor, grid: GridMap) -> torch.Tensor:
        """The normalized dense grid in f32: bf16 training frames are
        embedded in bf16, Dirichlet values rounded likewise, then normalized
        as JAX's jitted step does it (``Normalizer.normalize_frames``)."""
        return self.normalizer.normalize_frames(embed_cells(cells, grid))

    @staticmethod
    def spatial_axis() -> SpatialAxis:
        """This rank's spatial axis on the process's mesh (of one rank at
        sp = 1)."""
        return mesh_layout().axis

    def _eps_fn(self, grid: GridMap, params: Optional[Mapping] = None, net: Optional[torch.nn.Module] = None):
        """``net`` (default: ``self.net``) over the grid's cell types (on
        the grid's x slab, if it has one), with its own parameters or
        ``params`` (a name -> tensor mapping) in their place."""
        net = self.net if net is None else net

        def eps_fn(x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
            if params is None:
                return net(x_t, t, grid.cell_types, slab=grid.slab)
            return functional_call(net, params, (x_t, t, grid.cell_types), {"slab": grid.slab})

        return eps_fn

    def training_step(self, cells: torch.Tensor, grid: GridMap, noise) -> Dict[str, torch.Tensor]:
        """One micro-step: the diffusion loss on ``cells`` (B, n_cells, F)
        with t and the noise drawn from ``noise`` (``noise.randint`` and
        ``noise(shape)``, as ``GaussianDiffusion.loss`` draws them), its
        gradients (left in each parameter's ``.grad``), the optimizer (an
        update on every ``cfg.accumulate_steps``-th micro-step) and the
        warm-up EMA.  Returns ``{"train/loss": loss}`` as a device tensor:
        no sync with the host; in a group of several ranks ``cells`` are the
        rank's rows of the global batch, ``noise`` gives the rank's rows of
        the global draws (``parallel.mesh.RankRows``), the gradients are the
        global batch's and the loss is the mean over the ranks.  bf16 frames
        take their noise from ``Bf16NormalLaw(noise)``, as JAX draws it at
        their dtype.  The three parts run in the profiler ranges
        ``train/loss``, ``train/backward`` (with DDP's all-reduce) and
        ``train/optimizer``."""
        if self.opt_state is None:
            self.init_state()
        if cells.dtype == torch.bfloat16:
            noise = Bf16NormalLaw(noise)
        params = list(self.net.parameters())
        for p in params:
            p.grad = None
        with record_function("train/loss"):
            x, step_grid, noise = x_slab_inputs(self.spatial_axis(), self._model_input(cells, grid), grid, noise)
            loss = self.diffusion.loss(self._eps_fn(step_grid, net=self.train_net), x, step_grid, noise)
        with record_function("train/backward"):
            loss.backward()
        with record_function("train/optimizer"):
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            updated = self.tx.step_(params, grads, self.opt_state)
            self.step += 1
            if self.ema is not None and updated:
                self._update_ema()
        return {"train/loss": mean_over_ranks(loss.detach())}

    @torch.no_grad()
    def _update_ema(self) -> None:
        """Warm-up EMA: decay min(d, (1 + t) / (10 + t)) with t the number
        of optimizer updates so far, blended in f32 (JAX's f32 arithmetic)."""
        t = np.float32(self.step // self.tx.accumulate_steps)
        decay = min(np.float32(self.cfg.ema_decay), (1 + t) / (10 + t))
        ema = list(self.ema.values())
        params = [p.detach().float() for p in self.net.parameters()]
        torch._foreach_mul_(ema, float(decay))
        torch._foreach_add_(ema, params, alpha=float(np.float32(1) - decay))

    @torch.no_grad()
    def eval_diagnostics(self, cells: torch.Tensor, grid: GridMap, noise) -> Dict[str, float]:
        """The masked epsilon-loss at 8 timesteps spread over [0, T), with
        the parameters (``val/eps-loss-t<t>``) and, with an EMA, the EMA
        parameters (``val/eps-loss-ema-t<t>``).  One noise draw per timestep,
        the same for both."""
        T = self.cfg.timesteps
        ts = np.unique(np.round(np.linspace(0, T - 1, 8)).astype(np.int64)).tolist()
        x, step_grid, noise = x_slab_inputs(self.spatial_axis(), self._model_input(cells, grid), grid, noise)
        draws = [noise(x.shape) for _ in ts]
        runs = [("val/eps-loss-t", None)]
        if self.ema is not None:
            runs.append(("val/eps-loss-ema-t", self.ema))
        out: Dict[str, float] = {}
        for prefix, params in runs:
            eps_fn = self._eps_fn(step_grid, params)
            for t, draw in zip(ts, draws):
                t_vec = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
                loss = self.diffusion.p_losses(eps_fn, x, t_vec, step_grid, lambda shape, d=draw: d)
                out[f"{prefix}{t}"] = float(loss)
        return out

    def sample(
        self,
        cells: torch.Tensor,
        grid: GridMap,
        noise: NoiseFn,
        *,
        start_from: Optional[int] = None,
    ) -> torch.Tensor:
        """Denormalized samples (B, n_cells, F) with ``eval_net`` (on the
        EMA parameters when there are any) and the sampler of
        ``cfg.sampler`` (DDIM with ``cfg.ddim_steps`` and ``cfg.ddim_eta``,
        or ancestral over all steps or the last ``start_from``)."""
        model = self.eval_net
        if self.ema is not None:
            model = lambda *args, **kwargs: functional_call(self.eval_net, self.ema, args, kwargs)  # noqa: E731
        return sample(
            model, self.diffusion, self.normalizer, cells, grid,
            sampler=self.cfg.sampler, ddim_steps=self.cfg.ddim_steps,
            ddim_eta=self.cfg.ddim_eta, noise=noise, start_from=start_from,
            axis=self.spatial_axis(),
        )

    # ---- evaluation --------------------------------------------------------------

    def eval_step(self, batch: Batch, noise: NoiseFn, phase: str) -> Dict[str, float]:
        """Sample ``batch`` (moved to the task's device) with ``noise``, add
        the samples to the phase's store, and return the samples' u std and
        max |u| (``{phase}/sample-u-std``, ``{phase}/sample-u-absmax``): an
        undertrained epsilon-network blows samples up by orders of magnitude
        through the sampler chain."""
        batch = batch.to(self.device)
        samples = self.sample(batch.cells, batch.grid, noise).float().cpu().numpy()
        self.sample_stores[phase].add_samples(samples, batch.metadata)
        u = samples[..., : Variable.U.dims]
        return {f"{phase}/sample-u-std": float(np.std(u)), f"{phase}/sample-u-absmax": float(np.abs(u).max())}

    def on_eval_start(self, phase: str) -> None:
        self.sample_stores[phase].reset()

    def on_eval_end(self, stats: FieldStats, phase: str, *, expensive: bool) -> Dict[str, float]:
        """The phase's metrics over its sample store.  ``cfg.
        compute_expensive_sample_metrics`` gates the point-cloud Wasserstein
        even when ``expensive`` asks for it."""
        expensive = expensive and self.cfg.compute_expensive_sample_metrics
        return self.metrics[phase].compute(self.sample_stores[phase], stats, expensive_metrics=expensive)

    def render_plots(self, out_dir, phase: str, step: int):
        """TKE-spectrum and slice plots of the phase's last evaluation under
        ``out_dir/plots/<phase>-<step>/`` (``eval.plots``); without
        matplotlib, one console line and no plots."""
        from ..eval.plots import render_eval_plots

        return render_eval_plots(out_dir, self.sample_stores[phase], self.metrics[phase], self.variables, phase, step)
