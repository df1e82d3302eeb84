"""Centered-difference differential operators on dense padded grids.

Port of ``generative_turbulence_tpu/ops/stencils.py``.  Fields are
channels-last ``(..., X, Y, Z, C)``: the three spatial axes are the last three
before the channel axis.  Derivatives are taken at interior cells only, so
each output is shorter by 2 along every spatial axis.  ``h`` is the physical
cell size (3,), as a numpy array, a sequence or a tensor.
"""

from __future__ import annotations

import torch


def centered_difference(x: torch.Tensor, *, dim: int, h: float) -> torch.Tensor:
    """d/dx_dim of ``x`` (..., X, Y, Z), with NO channel axis, by centered
    differences; shortens that axis by 2."""
    axis = dim - 3
    n = x.shape[axis]
    return (x.narrow(axis, 2, n - 2) - x.narrow(axis, 0, n - 2)) / (2 * h)


def unpadded_derivative(x: torch.Tensor, h, *, dim: int) -> torch.Tensor:
    """Derivative along ``dim`` with the padding cut on the other spatial
    axes: (..., X, Y, Z) -> (..., X-2, Y-2, Z-2)."""
    for other in range(3):
        if other != dim:
            x = x.narrow(other - 3, 1, x.shape[other - 3] - 2)
    return centered_difference(x, dim=dim, h=float(h[dim]))


def divergence(u: torch.Tensor, h) -> torch.Tensor:
    """Divergence of u (..., X, Y, Z, 3) at interior cells -> (..., X-2, Y-2, Z-2, 1)."""
    div = sum(unpadded_derivative(u[..., i], h, dim=i) for i in range(3))
    return div[..., None]


def curl(u: torch.Tensor, h) -> torch.Tensor:
    """Curl of u (..., X, Y, Z, 3) at interior cells -> (..., X-2, Y-2, Z-2, 3)."""
    ux, uy, uz = u[..., 0], u[..., 1], u[..., 2]
    d = unpadded_derivative
    return torch.stack(
        (d(uz, h, dim=1) - d(uy, h, dim=2), d(ux, h, dim=2) - d(uz, h, dim=0), d(uy, h, dim=0) - d(ux, h, dim=1)),
        dim=-1,
    )


def vector_gradient(u: torch.Tensor, h) -> torch.Tensor:
    """Gradient of a vector field u (..., X, Y, Z, C): (..., X-2, Y-2, Z-2, C, 3)
    with [..., i, j] = d u_i / d x_j."""
    rows = [
        torch.stack([unpadded_derivative(u[..., i], h, dim=j) for j in range(3)], dim=-1)
        for i in range(u.shape[-1])
    ]
    return torch.stack(rows, dim=-2)


def enstrophy(u: torch.Tensor, h) -> torch.Tensor:
    """|curl u|^2 * cell volume at interior cells -> (..., X-2, Y-2, Z-2, 1)."""
    dv = float(torch.as_tensor(h, dtype=torch.float32).prod())
    return (curl(u, h) ** 2).sum(dim=-1, keepdim=True) * dv
