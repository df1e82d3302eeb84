"""Conditional sampling of the diffusion task.

Port of the sampling step of ``generative_turbulence_tpu/training/
diffusion_task.py`` (``DiffusionTask._sample_fn``): embed the cells into the
dense grid, normalize, run a sampler with the epsilon-network, denormalize,
and gather the cells back.  The ``DiffusionTask`` class (training, EMA,
validation) comes with the training port.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..data.grid import GridMap, embed_cells, gather_cells
from ..diffusion.gaussian import GaussianDiffusion, NoiseFn
from ..models.normalization import Normalizer
from ..models.unet import DenoisingModel


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
