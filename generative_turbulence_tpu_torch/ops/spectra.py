"""Turbulent-kinetic-energy spectra and the distance between them, on a device.

Port of ``generative_turbulence_tpu/ops/spectra.py``.  TKE field -> 3D FFT
(``torch.fft.fftn`` over the three spatial axes, f32) -> |.|^2 -> trilinear
interpolation onto spheres of radius k in the LOG domain -> spherical
quadrature -> times 4 pi k^2; and the pairwise L2 distance between
log-spectra by Gauss-Legendre integration over k in [1, (min_dim - 1) // 2].

Both quadratures are an elementwise product and a sum, so their result does
not depend on torch's TF32 matmul switch (the JAX package sums them at
``Precision.HIGHEST``).  ``SpectrumOps`` holds the quadrature constants on a
device; callers build it once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from .interp import interp3
from .quadrature import gauss_legendre, sphere_quadrature


def tke_field(u_perturbation: torch.Tensor) -> torch.Tensor:
    """Pointwise TKE 0.5 * sum_i u_i'^2 of (..., X, Y, Z, 3) -> (..., X, Y, Z)."""
    return 0.5 * (u_perturbation**2).sum(dim=-1)


@dataclasses.dataclass(frozen=True)
class SpectrumOps:
    """Quadrature constants for the spectrum and the distance, on one device."""

    sphere_points: torch.Tensor  # (P, 3)
    sphere_weights: torch.Tensor  # (P,)
    legendre_nodes: torch.Tensor  # (K,)
    legendre_weights: torch.Tensor  # (K,)

    @staticmethod
    def create(n_sphere: int = 5810, n_legendre: int = 64, device="cuda") -> "SpectrumOps":
        p, w = sphere_quadrature(n_sphere)
        nodes, weights = gauss_legendre(n_legendre)
        on = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        return SpectrumOps(on(p), on(w), on(nodes), on(weights))


def tke_spectrum(u_perturbation: torch.Tensor, k: torch.Tensor, ops: SpectrumOps) -> torch.Tensor:
    """Angle-integrated TKE spectrum E(k) of velocity fluctuations
    (..., X, Y, Z, 3) at wavenumbers ``k`` (K,) in FFT-bin units: (..., K)."""
    tke = tke_field(u_perturbation)
    spatial = (-3, -2, -1)
    power = torch.fft.fftshift(torch.fft.fftn(tke, dim=spatial), dim=spatial).abs() ** 2

    center = torch.tensor([s // 2 for s in tke.shape[-3:]], dtype=u_perturbation.dtype, device=tke.device)
    p_query = k[:, None, None] * ops.sphere_points[None, :, :] + center  # (K, P, 3)
    shell = torch.exp(interp3(torch.log(power), p_query))  # (..., K, P)
    E_k = (shell * ops.sphere_weights).sum(dim=-1)
    return E_k * (4 * math.pi * k**2)


def _k_range(spatial_shape: Tuple[int, int, int]) -> Tuple[float, float]:
    return 1.0, float((min(spatial_shape) - 1) // 2)


def spectrum_wavenumbers(spatial_shape: Tuple[int, int, int], ops: SpectrumOps) -> torch.Tensor:
    """Gauss-Legendre k nodes mapped from [-1, 1] to [1, (min_dim - 1) // 2]."""
    k_min, k_max = _k_range(spatial_shape)
    slope = (k_max - k_min) / 2
    return slope * ops.legendre_nodes + (slope + k_min)


def log_tke_distance_matrix(u_a: torch.Tensor, u_b: torch.Tensor, u_mean: torch.Tensor, ops: SpectrumOps):
    """Pairwise L2 distances between log-TKE spectra of two sample sets.

    u_a: (A, X, Y, Z, 3), u_b: (B, X, Y, Z, 3), u_mean: (X, Y, Z, 3) or
    broadcastable.  Returns (D (A, B), log_tke_a (A, K), log_tke_b (B, K),
    k (K,)).
    """
    if not (u_a.shape[-1] == u_b.shape[-1] == u_mean.shape[-1] == 3):
        raise ValueError("velocity fields need 3 channels")
    if not (u_a.shape[-4:-1] == u_b.shape[-4:-1] == u_mean.shape[-4:-1]):
        raise ValueError(f"spatial shapes differ: {u_a.shape}, {u_b.shape}, {u_mean.shape}")

    spatial = tuple(u_a.shape[-4:-1])
    k = spectrum_wavenumbers(spatial, ops).to(u_a.dtype)
    k_min, k_max = _k_range(spatial)
    slope = (k_max - k_min) / 2

    log_tke_a = torch.log(tke_spectrum(u_a - u_mean, k, ops))
    log_tke_b = torch.log(tke_spectrum(u_b - u_mean, k, ops))
    diff2 = (log_tke_a[:, None, :] - log_tke_b[None, :, :]) ** 2
    D = torch.sqrt(slope * (diff2 * ops.legendre_weights).sum(dim=-1))
    return D, log_tke_a, log_tke_b, k
