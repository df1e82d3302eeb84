"""Timestep embeddings (parameter-free; their constants are buffers).

``NyquistFrequencyEmbedding``: dim/2 geometrically spaced frequencies from
1/8 to Nyquist/(2*golden ratio), each as a sin with a 0 and a pi/2 phase.
``SinusoidalTimeEmbedding``: the classic DDPM sin/cos embedding.  Port of
``generative_turbulence_tpu/models/embeddings.py``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def nyquist_scale_bias(dim: int, timesteps: int):
    if dim % 2:
        raise ValueError(f"embedding dim must be even, got {dim}")
    k = dim // 2
    nyquist = timesteps / 2
    golden = (1 + np.sqrt(5)) / 2
    freqs = np.geomspace(1 / 8, nyquist / (2 * golden), num=k)
    scale = np.repeat(2 * np.pi * freqs / timesteps, 2).astype(np.float32)
    bias = np.tile(np.array([0.0, np.pi / 2], dtype=np.float32), k)
    return scale, bias


class NyquistFrequencyEmbedding(nn.Module):
    def __init__(self, dim: int, timesteps: int):
        super().__init__()
        scale, bias = nyquist_scale_bias(dim, timesteps)
        self.register_buffer("scale", torch.from_numpy(scale), persistent=False)
        self.register_buffer("bias", torch.from_numpy(bias), persistent=False)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return torch.sin(self.scale * t[..., None] + self.bias)


class SinusoidalTimeEmbedding(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        half = dim // 2
        freqs = np.exp(-np.log(10000.0) / (half - 1) * np.arange(half)).astype(np.float32)
        self.register_buffer("freqs", torch.from_numpy(freqs), persistent=False)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        args = t[..., None] * self.freqs
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
