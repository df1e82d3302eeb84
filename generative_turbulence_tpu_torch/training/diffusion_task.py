"""The diffusion task, sampling half.

Port of the sampling parts of ``generative_turbulence_tpu/training/
diffusion_task.py``: ``DiffusionTask`` is built from a ``ModelConfig`` and
the training-set ``FieldStats`` and wires the normalizer, the conditioning,
the epsilon-network (and its eval-dtype twin) and ``GaussianDiffusion``
together; ``DiffusionTask.sample`` follows ``cfg.sampler``.  The free
``sample`` function is the sampling step itself (``_sample_fn``): embed the
cells into the dense grid, normalize, run a sampler with the
epsilon-network, denormalize, and gather the cells back.

Not ported yet: the optimizer, ``train_step``, EMA, ``eval_step``, the
sample stores and the metrics.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ..data.grid import GridMap, embed_cells, gather_cells
from ..data.schema import FieldStats
from ..data.variables import Variable, total_dims
from ..diffusion.gaussian import GaussianDiffusion, NoiseFn
from ..models.conditioning import Conditioning
from ..models.normalization import Normalizer
from ..models.unet import DenoisingModel
from ..toolchain.from_flax import torch_state_dict_from_flax
from .config import ModelConfig


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
) -> torch.Tensor:
    """Sample (B, n_cells, F) cell values for the geometry of ``grid``.

    ``cells`` (B, n_cells, F) supply the boundary values (only the grid's
    non-domain cells of their embedding matter).  ``sampler`` is "ddim"
    (``ddim_steps``, ``ddim_eta``) or "ddpm" (ancestral over all steps, or
    the last ``start_from``).  ``noise`` is the sampler's normal source.
    """
    x_bcs = normalizer.normalize(embed_cells(cells, grid))

    def eps_fn(x_t: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return model(x_t, t, grid.cell_types)

    if sampler == "ddim":
        x = diffusion.ddim_sample_loop(
            eps_fn, x_bcs, grid, noise, num_steps=ddim_steps, eta=ddim_eta
        )
    elif sampler == "ddpm":
        x = diffusion.p_sample_loop(eps_fn, x_bcs, grid, noise, start_from=start_from)
    else:
        raise ValueError(f"Unknown sampler {sampler!r}")
    return gather_cells(normalizer.denormalize(x), grid)


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
    """The sampling half of the JAX package's ``DiffusionTask``.

    ``net`` computes in ``cfg.compute_dtype``; ``eval_net`` in
    ``cfg.eval_compute_dtype`` (None = the same) and samples.  Both hold the
    same parameters, in f32, on ``device``: set them with
    ``load_flax_params``, ``net.load_state_dict`` or ``net.init_weights``.
    """

    def __init__(self, cfg: ModelConfig, stats: FieldStats, device="cuda"):
        self.cfg = cfg
        self.variables = Variable.parse_tuple(cfg.variables)
        if Variable.U not in self.variables:
            raise ValueError(f"the diffusion task needs u among its variables, got {cfg.variables!r}")
        self.normalizer = Normalizer.from_stats(stats, self.variables, cfg.normalization_mode)
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
            clip_denoised=cfg.clip_denoised,
            noise_bcs=cfg.noise_bcs,
            learned_variances=cfg.learned_variances,
            parameterization=cfg.parameterization,
            clip_bounds=clip_bounds,
        )

    def load_flax_params(self, params: Mapping) -> None:
        """Load a flax ``DenoisingModel`` parameter tree (nested dicts of
        numpy arrays, with or without the ``"params"`` collection)."""
        self.net.load_state_dict(torch_state_dict_from_flax(params))

    def sample(
        self,
        cells: torch.Tensor,
        grid: GridMap,
        noise: NoiseFn,
        *,
        start_from: Optional[int] = None,
    ) -> torch.Tensor:
        """Denormalized samples (B, n_cells, F) with ``eval_net`` and the
        sampler of ``cfg.sampler`` (DDIM with ``cfg.ddim_steps`` and
        ``cfg.ddim_eta``, or ancestral over all steps or the last
        ``start_from``)."""
        return sample(
            self.eval_net, self.diffusion, self.normalizer, cells, grid,
            sampler=self.cfg.sampler, ddim_steps=self.cfg.ddim_steps,
            ddim_eta=self.cfg.ddim_eta, noise=noise, start_from=start_from,
        )
