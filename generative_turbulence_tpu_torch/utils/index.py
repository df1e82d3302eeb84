"""Flat <-> multi-dimensional index conversions on host numpy arrays.

numpy copy of ``generative_turbulence_tpu/utils/index.py`` (same semantics as
numpy's ``ravel_multi_index``/``unravel_index`` over a trailing coordinate
axis).
"""

from __future__ import annotations

import numpy as np


def ravel_multi_index(coords, shape) -> np.ndarray:
    """Convert (..., ndim) integer coordinates into flat indices for ``shape``."""
    coords = np.asarray(coords)
    strides = _strides(shape).astype(coords.dtype)
    return (coords * strides).sum(axis=-1)


def unravel_index(flat, shape) -> np.ndarray:
    """Convert flat indices into (..., ndim) coordinates for ``shape``."""
    flat = np.asarray(flat)
    coords = [(flat // stride) % size for stride, size in zip(_strides(shape), shape)]
    return np.stack(coords, axis=-1)


def _strides(shape) -> np.ndarray:
    shape = np.asarray(shape, dtype=np.int64)
    strides = np.ones_like(shape)
    strides[:-1] = np.cumprod(shape[::-1])[::-1][1:]
    return strides
