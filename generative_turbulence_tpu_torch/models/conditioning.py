"""Geometry conditioning features: a learned (or one-hot) embedding of the
6 cell types plus optional normalized cell positions, mapping the cell-type
grid (X, Y, Z) to a feature grid (X, Y, Z, C) shared across the batch.
Port of ``generative_turbulence_tpu/models/conditioning.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..data.schema import N_CELL_TYPES


class Conditioning(nn.Module):
    def __init__(
        self,
        cell_type_features: bool = True,
        cell_type_embedding: str = "learned",
        cell_type_embedding_dim: int = 4,
        cell_pos_features: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if cell_type_embedding not in ("learned", "onehot"):
            raise ValueError(f"Unknown cell type embedding {cell_type_embedding!r}")
        self.cell_type_features = cell_type_features
        self.cell_type_embedding_kind = cell_type_embedding
        self.cell_pos_features = cell_pos_features
        self.dtype = dtype
        if cell_type_features and cell_type_embedding == "learned":
            self.cell_type_embedding = nn.Embedding(N_CELL_TYPES, cell_type_embedding_dim)
        self.out_dim = (
            (cell_type_embedding_dim if cell_type_embedding == "learned" else N_CELL_TYPES)
            if cell_type_features
            else 0
        ) + (3 if cell_pos_features else 0)

    def forward(self, cell_types: torch.Tensor) -> Optional[torch.Tensor]:
        parts = []
        if self.cell_type_features:
            if self.cell_type_embedding_kind == "learned":
                parts.append(self.cell_type_embedding(cell_types).to(self.dtype))
            else:
                eye = torch.eye(N_CELL_TYPES, dtype=self.dtype, device=cell_types.device)
                parts.append(eye[cell_types])
        if self.cell_pos_features:
            X, Y, Z = cell_types.shape
            axes = [
                torch.linspace(0.0, 1.0, n, device=cell_types.device) for n in (X, Y, Z)
            ]
            pos = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
            parts.append(pos.to(self.dtype))
        if not parts:
            return None
        return torch.cat(parts, dim=-1)
