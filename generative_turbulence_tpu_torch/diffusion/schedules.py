"""Beta schedules, computed on the host in float64 with numpy/scipy.

Copy of ``generative_turbulence_tpu/diffusion/schedules.py``; the bisection
schedules (``log-linear`` and the default ``log-snr-linear``) solve one root
per step.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import bisect


def linear_beta_schedule(timesteps: int) -> np.ndarray:
    scale = 1000 / timesteps
    return np.linspace(scale * 1e-4, scale * 2e-2, timesteps, dtype=np.float64)


def log_linear_beta_schedule(timesteps: int) -> np.ndarray:
    """Linear-like schedule for any T: the final alpha solves
    log(alpha_bar_T) = log(1e-6)."""
    log_acp_T = np.log(1e-6)
    T = timesteps
    one_to_T = np.arange(1, T + 1)

    def f(alpha_T):
        return np.log(T + one_to_T * (alpha_T - 1)).sum() - T * np.log(T) - log_acp_T

    alpha_T = bisect(f, 1e-10, 1.0)
    alphas = (T + one_to_T * (alpha_T - 1)) / T
    return 1.0 - alphas


def log_snr_linear_beta_schedule(
    timesteps: int, snr_1: float = 1e3, snr_T: float = 1e-5
) -> np.ndarray:
    """Log-SNR decays linearly from log(snr_1) to log(snr_T); each
    alpha_bar_t solves logit(alpha_bar_t) = target log-SNR by bisection."""
    T = timesteps
    log_snr_1, log_snr_T = np.log(snr_1), np.log(snr_T)

    acp = np.empty(T)
    for t in range(1, T + 1):
        target = ((T - t) * log_snr_1 + (t - 1) * log_snr_T) / (T - 1)

        def f(a, target=target):
            return np.log(a) - np.log1p(-a) - target

        acp[t - 1] = bisect(f, 1e-8, 1.0 - 1e-8)

    alphas = np.concatenate((acp[:1], acp[1:] / acp[:-1]))
    return 1.0 - alphas


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    t = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64) / timesteps
    acp = np.cos((t + s) / (1 + s) * np.pi * 0.5) ** 2
    acp = acp / acp[0]
    return np.clip(1 - acp[1:] / acp[:-1], 0, 0.999)


def sigmoid_beta_schedule(
    timesteps: int, start: float = -3, end: float = 3, tau: float = 1.0
) -> np.ndarray:
    def sigmoid(x):
        return 1 / (1 + np.exp(-x))

    t = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64) / timesteps
    v_start, v_end = sigmoid(start / tau), sigmoid(end / tau)
    acp = (-sigmoid((t * (end - start) + start) / tau) + v_end) / (v_end - v_start)
    acp = acp / acp[0]
    return np.clip(1 - acp[1:] / acp[:-1], 0, 0.999)


SCHEDULES = {
    "linear": linear_beta_schedule,
    "log-linear": log_linear_beta_schedule,
    "log-snr-linear": log_snr_linear_beta_schedule,
    "cosine": cosine_beta_schedule,
    "sigmoid": sigmoid_beta_schedule,
}


def beta_schedule(name: str, timesteps: int) -> np.ndarray:
    try:
        fn = SCHEDULES[name]
    except KeyError:
        raise ValueError(f"Unknown beta schedule {name!r}") from None
    return np.asarray(fn(timesteps), dtype=np.float64)
