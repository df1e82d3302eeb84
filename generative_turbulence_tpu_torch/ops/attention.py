"""Attention over flattened voxel tokens.

Port of ``generative_turbulence_tpu/ops/attention.py``.  ``multihead_attention``
is the plain einsum form with the softmax in f32.  Where the JAX package
dispatches its Pallas ``flash_attention`` kernel (N >= 2048 tokens), the
Hopper port of that kernel is still to be written (ROADMAP, kernel K3): a
CUDA tensor of that size raises instead of running the plain path silently.
"""

from __future__ import annotations

import torch

FLASH_MIN_TOKENS = 2048


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Scaled dot-product attention: q, k, v (B, H, N, D) -> (B, H, N, D)."""
    if q.is_cuda and q.shape[-2] >= FLASH_MIN_TOKENS:
        raise NotImplementedError(
            f"{q.shape[-2]} tokens take the flash_attention kernel, whose Hopper "
            "port is a ROADMAP item (K3) not yet written"
        )
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
