"""DilResNet: dilated-CNN autoregressive baseline.

Port of ``generative_turbulence_tpu/models/dilresnet.py``: encode conv -> N
residual blocks of 7 convs with dilations [1, 2, 4, 8, 4, 2, 1] (+ local
conditioning added before each block) -> decode conv in f32.  The convs are
``blocks.Conv3d`` (replicate padding, SAME output size); channels-last
``(B, X, Y, Z, C)``; parameter names follow the flax tree.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import Conv3d
from .conditioning import Conditioning


class DilatedBlock(nn.Module):
    def __init__(self, dim: int, dilations: Sequence[int] = (1, 2, 4, 8), dtype: Optional[torch.dtype] = None):
        super().__init__()
        schedule = list(dilations) + list(reversed(dilations[:-1]))
        self.n_convs = len(schedule)
        for i, d in enumerate(schedule):
            setattr(self, f"Conv3d_{i}", Conv3d(dim, dim, 3, dilation=d, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_convs):
            x = F.relu(getattr(self, f"Conv3d_{i}")(x))
        return x


class DilResNet(nn.Module):
    def __init__(
        self,
        n_features: int,
        N: int = 4,
        hidden_dim: int = 48,
        conditioning: Optional[Conditioning] = None,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.N = N
        self.conditioning = conditioning
        if conditioning is not None:
            self.encode_c_local = Conv3d(conditioning.out_dim, hidden_dim, 3, dtype=dtype)
        self.encode = Conv3d(n_features, hidden_dim, 3, dtype=dtype)
        for i in range(N):
            setattr(self, f"block_{i}", DilatedBlock(hidden_dim, dtype=dtype))
        self.decode = Conv3d(hidden_dim, n_features, 3, dtype=torch.float32)

    def init_weights(self, generator: Optional[torch.Generator] = None) -> "DilResNet":
        """Re-draw every parameter (flax's initializers) from ``generator``."""
        for module in self.modules():
            if isinstance(module, nn.Embedding):
                with torch.no_grad():
                    nn.init.normal_(module.weight, generator=generator)
            elif isinstance(module, Conv3d):
                module.reset_parameters(generator)
        return self

    def forward(self, x: torch.Tensor, cell_types: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, X, Y, Z, F) -> (B, X, Y, Z, F) predicted (normalized) delta."""
        c_local = None
        if self.conditioning is not None and cell_types is not None:
            c_local = self.encode_c_local(self.conditioning(cell_types)[None])

        x = self.encode(x)
        for i in range(self.N):
            if c_local is not None:
                x = x + c_local
            x = x + getattr(self, f"block_{i}")(x)
        return self.decode(x.float())
