"""Attention over flattened voxel tokens.

Port of ``generative_turbulence_tpu/ops/attention.py``.  ``multihead_attention``
is the plain einsum form with the softmax in f32 below ``FLASH_MIN_TOKENS``
tokens.  From that size up, where the JAX package dispatches its Pallas
``flash_attention`` kernel, it calls ``cuda_kernels.flash_attention``: the
Hopper kernel on a CUDA tensor, its plain version on a CPU tensor (as the
JAX package runs its XLA attention off the TPU).
"""

from __future__ import annotations

import torch

from . import cuda_kernels

# The JAX package's threshold (ops/attention.py:26), kept as it is.
FLASH_MIN_TOKENS = 2048


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Scaled dot-product attention: q, k, v (B, H, N, D) -> (B, H, N, D)."""
    if q.shape[-2] >= FLASH_MIN_TOKENS:
        return cuda_kernels.flash_attention(q, k, v)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhnd,bhmd->bhnm", q, k).float() * scale
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhnm,bhmd->bhnd", weights, v)


def efficient_linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Linear attention (softmax of q over features, of k over tokens);
    q, k, v: (B, H, N, D) -> (B, H, N, D) at cost O(N * D^2)."""
    q = torch.softmax(q, dim=-1)
    k = torch.softmax(k, dim=-2)
    context = torch.einsum("bhnd,bhne->bhde", k, v)
    return torch.einsum("bhnd,bhde->bhne", q, context)
