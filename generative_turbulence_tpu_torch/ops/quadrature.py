"""Quadrature rules of the turbulence statistics.

numpy copy of ``generative_turbulence_tpu/ops/quadrature.py``: Gauss-Legendre
nodes on [-1, 1] for the integral over wavenumbers, and a Fibonacci-lattice
rule on the unit sphere (equal weights summing to 1, near-uniform nodes) for
the integral over shells of the spectrum.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np


@functools.lru_cache(maxsize=None)
def gauss_legendre(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre nodes/weights on [-1, 1] as float32 numpy arrays."""
    from scipy.special import roots_legendre

    nodes, weights = roots_legendre(n)
    return nodes.astype(np.float32), weights.astype(np.float32)


@functools.lru_cache(maxsize=None)
def sphere_quadrature(n_points: int = 5810) -> Tuple[np.ndarray, np.ndarray]:
    """Unit-sphere quadrature with ``n_points`` nodes: (points (N, 3) float32,
    weights (N,) float32 summing to 1).  The golden-angle lattice: z descends
    uniformly while the azimuth advances by the golden angle."""
    i = np.arange(n_points, dtype=np.float64) + 0.5
    phi = np.pi * (1.0 + math.sqrt(5.0)) * i
    z = 1.0 - 2.0 * i / n_points
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))

    points = np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=-1)
    weights = np.full(n_points, 1.0 / n_points)
    return points.astype(np.float32), weights.astype(np.float32)
