"""Exact earth mover's distance with uniform marginals, on the host.

numpy copy of ``generative_turbulence_tpu/eval/emd.py``, with the same solver
order:

1. Square cost matrices: the Jonker-Volgenant assignment solver
   (``scipy.optimize.linear_sum_assignment``), exact since uniform-marginal
   transport with n == m admits a permutation optimum (Birkhoff).
2. Rectangular: the native C++ min-cost flow of ``native/emd.cpp`` through
   ``ctypes``, built with ``g++`` at first use into ``build/native/``.
3. The HiGHS transportation LP (``scipy.optimize.linprog``) where the native
   library is missing or fails.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[2]
NATIVE_SOURCE = REPO_ROOT / "native" / "emd.cpp"
NATIVE_LIBRARY = REPO_ROOT / "build" / "native" / "libemd.so"


@functools.lru_cache(maxsize=1)
def _native_lib() -> Optional[ctypes.CDLL]:
    """The native library, built from ``native/emd.cpp`` into ``build/native/``
    if it is not there (into a temporary name, then renamed, so that
    processes building at once do not see half a file); None where it cannot
    be built or loaded."""
    if not NATIVE_LIBRARY.is_file():
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None or not NATIVE_SOURCE.is_file():
            return None
        NATIVE_LIBRARY.parent.mkdir(parents=True, exist_ok=True)
        tmp = NATIVE_LIBRARY.with_name(f".{NATIVE_LIBRARY.name}.{os.getpid()}")
        try:
            subprocess.run(
                [cxx, "-O3", "-std=c++17", "-fPIC", "-shared", "-o", str(tmp), str(NATIVE_SOURCE)],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, NATIVE_LIBRARY)
        except (subprocess.SubprocessError, OSError):
            tmp.unlink(missing_ok=True)
            return None
    try:
        lib = ctypes.CDLL(str(NATIVE_LIBRARY))
    except OSError:
        return None
    lib.emd_uniform.restype = ctypes.c_double
    lib.emd_uniform.argtypes = [ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int]
    return lib


def emd2_uniform(M: np.ndarray, *, use_native: bool = True) -> float:
    """min <P, M> s.t. P 1 = 1/n, P^T 1 = 1/m, P >= 0 (exact optimum)."""
    M = np.ascontiguousarray(M, dtype=np.float64)
    n, m = M.shape

    if n == m:
        from scipy.optimize import linear_sum_assignment

        rows, cols = linear_sum_assignment(M)
        return float(M[rows, cols].sum() / n)

    if use_native:
        lib = _native_lib()
        if lib is not None:
            val = lib.emd_uniform(M.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, m)
            if np.isfinite(val) and val >= 0:
                return float(val)
            # fall through to the LP on solver failure

    return _transport_lp(M)


def _transport_lp(M: np.ndarray) -> float:
    from scipy.optimize import linprog
    from scipy.sparse import coo_matrix

    n, m = M.shape
    # Row-sum and column-sum equality constraints over the flattened plan.
    row_idx = np.repeat(np.arange(n), m)
    col_idx = np.tile(np.arange(m), n)
    var_idx = np.arange(n * m)
    A = coo_matrix(
        (np.ones(2 * n * m), (np.concatenate([row_idx, n + col_idx]), np.concatenate([var_idx, var_idx]))),
        shape=(n + m, n * m),
    )
    res = linprog(
        M.reshape(-1), A_eq=A, b_eq=np.concatenate([np.full(n, 1.0 / n), np.full(m, 1.0 / m)]),
        bounds=(0, None), method="highs",
    )
    if not res.success:
        raise RuntimeError(f"transport LP failed: {res.message}")
    return float(res.fun)


def wasserstein2(D: np.ndarray, **kwargs) -> float:
    """2-Wasserstein from a pairwise-distance matrix: sqrt(EMD(D^2))."""
    return float(np.sqrt(emd2_uniform(np.asarray(D) ** 2, **kwargs)))


def emd2_sq_rows(dist_block: np.ndarray) -> np.ndarray:
    """Exact EMD of the squares of each (R, R) slice of an (m, R, R) block
    of distances (one worker task of the point-cloud Wasserstein metric)."""
    return np.array([emd2_uniform(d**2) for d in dist_block])
