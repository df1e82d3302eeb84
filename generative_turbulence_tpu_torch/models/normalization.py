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

    def denormalize(self, x: torch.Tensor) -> torch.Tensor:
        return x * self._as(self.std, x) + self._as(self.mean, x)
