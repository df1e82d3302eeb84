"""Field normalization for channels-last grids: (mean, std) broadcast over
the trailing feature axis.  Port of ``generative_turbulence_tpu/models/
normalization.py``."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..data.schema import FieldStats
from ..data.variables import Variable


@dataclasses.dataclass(frozen=True)
class Normalizer:
    mean: np.ndarray  # (F,)
    std: np.ndarray  # (F,)

    @staticmethod
    def from_stats(stats: FieldStats, variables: Sequence[Variable], mode: str) -> "Normalizer":
        mean, std = stats.normalizers(variables, mode)
        return Normalizer(mean=mean, std=std)

    def _as(self, v: np.ndarray, x: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(v, dtype=x.dtype, device=x.device)

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self._as(self.mean, x)) / self._as(self.std, x)

    def normalize_frames(self, x: torch.Tensor) -> torch.Tensor:
        """``normalize`` of a task's input frames, in f32, as XLA compiles
        the JAX tasks' jitted steps.  f32 frames: ``normalize``.  Frames
        rounded to bf16: the constants are rounded to bf16 too, but the
        arithmetic and its result stay f32 (XLA keeps the excess precision
        of a bf16 chain that only f32 operations consume), and the division
        by the constant std is a product with its f32 reciprocal."""
        if x.dtype == torch.float32:
            return self.normalize(x)
        mean, std = (self._as(v, x).float() for v in (self.mean, self.std))
        return (x.float() - mean) * (1.0 / std)

    def denormalize(self, x: torch.Tensor) -> torch.Tensor:
        return x * self._as(self.std, x) + self._as(self.mean, x)
