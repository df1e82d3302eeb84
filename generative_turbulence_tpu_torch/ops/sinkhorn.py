"""Entropy-regularized optimal transport (Sinkhorn) on a device.

Port of ``generative_turbulence_tpu/ops/sinkhorn.py``: log-domain Sinkhorn
iterations with uniform marginals, ``torch.logsumexp`` in a plain loop over
``n_iters``.  ``sinkhorn_emd2`` returns the entropic transport cost ``<P, M>``
(no debiasing): it approaches the exact EMD from above as reg -> 0.  The exact
EMD runs on the host (``eval/emd.py``).
"""

from __future__ import annotations

import math

import torch


@torch.no_grad()
def sinkhorn_emd2(M: torch.Tensor, *, reg: float = 0.05, n_iters: int = 200) -> torch.Tensor:
    """<P, M> under entropic OT with uniform marginals, for (..., n, m) cost
    matrices: (...)."""
    n, m = M.shape[-2], M.shape[-1]
    log_a = torch.full(M.shape[:-1], -math.log(n), dtype=M.dtype, device=M.device)
    log_b = torch.full((*M.shape[:-2], m), -math.log(m), dtype=M.dtype, device=M.device)
    K = -M / reg  # log kernel

    f, g = torch.zeros_like(log_a), torch.zeros_like(log_b)
    for _ in range(n_iters):
        f = reg * (log_a - torch.logsumexp(K + g[..., None, :] / reg, dim=-1))
        g = reg * (log_b - torch.logsumexp(K + f[..., :, None] / reg, dim=-2))

    P = torch.exp(K + (f[..., :, None] + g[..., None, :]) / reg)
    return (P * M).sum(dim=(-2, -1))


def sinkhorn_wasserstein2(D: torch.Tensor, **kwargs) -> torch.Tensor:
    """sqrt(sinkhorn_emd2(D^2)): entropic 2-Wasserstein from distances."""
    return torch.sqrt(sinkhorn_emd2(D**2, **kwargs))


@torch.no_grad()
def masked_sinkhorn_emd2(
    M: torch.Tensor,
    row_valid: torch.Tensor,
    col_valid: torch.Tensor,
    *,
    reg: float | torch.Tensor = 0.05,
    n_iters: int = 200,
) -> torch.Tensor:
    """Entropic transport cost between the VALID subsets of padded clouds.

    M: (..., n, m) costs (entries at padded rows/cols are ignored);
    row_valid: (..., n) and col_valid: (..., m) bool, True for real points.
    Uniform marginals over the valid points; padded points carry zero mass
    (log-domain -inf), so clouds of different sizes share one batch.
    ``reg`` is a scalar or a per-matrix (...) tensor.
    """
    dtype, device = M.dtype, M.device
    neg_inf = torch.tensor(-math.inf, dtype=dtype, device=device)
    n_a = row_valid.sum(dim=-1, keepdim=True).to(dtype)
    n_b = col_valid.sum(dim=-1, keepdim=True).to(dtype)
    log_a = torch.where(row_valid, -torch.log(n_a.clamp_min(1.0)), neg_inf)
    log_b = torch.where(col_valid, -torch.log(n_b.clamp_min(1.0)), neg_inf)

    reg = torch.as_tensor(reg, dtype=dtype, device=device)
    reg_r = reg[..., None] if reg.ndim else reg  # broadcast over rows/cols
    reg_rc = reg[..., None, None] if reg.ndim else reg

    # Padded entries get +inf cost in the kernel, so their transport mass is
    # exactly zero even before the potentials converge.
    pair_valid = row_valid[..., :, None] & col_valid[..., None, :]
    K = torch.where(pair_valid, -M / reg_rc, neg_inf)

    f = torch.where(row_valid, 0.0, neg_inf)
    g = torch.where(col_valid, 0.0, neg_inf)
    for _ in range(n_iters):
        f = reg_r * (log_a - torch.logsumexp(K + g[..., None, :] / reg_rc, dim=-1))
        f = torch.where(row_valid, f, neg_inf)
        g = reg_r * (log_b - torch.logsumexp(K + f[..., :, None] / reg_rc, dim=-2))
        g = torch.where(col_valid, g, neg_inf)

    # The plan is a distribution, so log P <= 0 up to convergence slack; the
    # clip keeps a not-yet-converged solve from overflowing exp.
    log_P = K + (f[..., :, None] + g[..., None, :]) / reg_rc
    P = torch.where(pair_valid, torch.exp(log_P.clamp_max(30.0)), 0.0)
    P = P / P.sum(dim=(-2, -1), keepdim=True).clamp_min(1e-30)  # total mass 1
    return (P * torch.where(pair_valid, M, 0.0)).sum(dim=(-2, -1))
