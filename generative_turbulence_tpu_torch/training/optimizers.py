"""Optimizers and learning-rate schedules with the semantics of optax.

Port of ``generative_turbulence_tpu/training/optimizers.py``: the chain
``clip_by_global_norm`` -> ``adam`` | ``adamw`` | ``radam`` with a constant,
exponential or cosine learning rate, wrapped in ``MultiSteps`` when
gradients accumulate over several micro-steps.  ``torch.optim`` computes
other things (RAdam's eps outside the bias correction and its rectification
at rho > 5, ``clip_grad_norm_``'s 1e-6 in the divisor, AdamW's default decay
of 1e-2), so the update is written here as ``torch._foreach_*`` ops over the
parameter list: a few launches per step, not one per parameter.

The update count lives on the host (a Python int), so the schedule and the
bias corrections are host scalars and a step needs no device sync.  As in
optax, the schedule is evaluated at the count before the update, and under
accumulation only the updates made are counted.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

Schedule = Callable[[int], float]

# optax's defaults for adam, adamw and radam.
B1, B2, EPS = 0.9, 0.999, 1e-8
ADAMW_WEIGHT_DECAY = 1e-4
RADAM_THRESHOLD = 5.0  # rectify from rho >= 5


def exp_decay_schedule(learning_rate: float, min_learning_rate: float, max_train_steps: int) -> Schedule:
    """lr(step) = lr0 * exp(log(min/lr0) * min(step, T) / T)."""
    log_ratio = math.log(min_learning_rate / learning_rate)

    def schedule(step: int) -> float:
        frac = np.float32(min(step, max_train_steps)) / np.float32(max_train_steps)
        return float(np.float32(learning_rate) * np.exp(np.float32(log_ratio) * frac))

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float) -> Schedule:
    """optax.cosine_decay_schedule: init * ((1 - alpha) * (1 + cos(pi t / T)) / 2 + alpha)."""

    def schedule(step: int) -> float:
        count = np.float32(min(step, decay_steps))
        cosine = np.float32(0.5) * (1 + np.cos(np.float32(np.pi) * count / np.float32(decay_steps)))
        return float(np.float32(init_value) * ((1 - np.float32(alpha)) * cosine + np.float32(alpha)))

    return schedule


@dataclasses.dataclass
class OptState:
    """count: updates made so far (the schedule's and the bias corrections'
    step); mini_step: micro-steps accumulated since the last update; mu, nu:
    the first and second moments; acc: the running mean of the accumulated
    gradients (None without accumulation)."""

    count: int
    mini_step: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    acc: Optional[List[torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``optax.chain(clip_by_global_norm(clip), <kind>(lr))``, in
    ``optax.MultiSteps(every_k_schedule=accumulate_steps)`` when that is > 1.

    ``init(params)`` makes the state; ``step_(params, grads, state)``
    updates ``params`` in place and returns whether it made an update (False
    on the micro-steps that only accumulate)."""

    kind: str
    learning_rate: Schedule
    gradient_clip_val: Optional[float] = None
    accumulate_steps: int = 1

    def init(self, params: Sequence[torch.Tensor]) -> OptState:
        zeros = lambda: [torch.zeros_like(p) for p in params]  # noqa: E731
        acc = zeros() if self.accumulate_steps > 1 else None
        return OptState(count=0, mini_step=0, mu=zeros(), nu=zeros(), acc=acc)

    @torch.no_grad()
    def step_(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor], state: OptState) -> bool:
        params, grads = list(params), list(grads)
        if state.acc is not None:
            # MultiSteps: acc += (g - acc) / (n + 1), the running mean.
            diff = torch._foreach_sub(grads, state.acc)
            torch._foreach_div_(diff, float(state.mini_step + 1))
            torch._foreach_add_(state.acc, diff)
            state.mini_step += 1
            if state.mini_step < self.accumulate_steps:
                return False
            grads = [a.clone() for a in state.acc]
            for a in state.acc:
                a.zero_()
            state.mini_step = 0
        elif state.mini_step:
            raise ValueError("a state with accumulated micro-steps needs accumulate_steps > 1")
        if self.gradient_clip_val is not None and self.gradient_clip_val > 0:
            grads = self._clip(grads)
        updates = self._direction(params, grads, state)
        state.count += 1
        lr = self.learning_rate(state.count - 1)
        torch._foreach_add_(params, updates, alpha=-lr)
        return True

    def _clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """optax.clip_by_global_norm: g * max / ||g|| where ||g|| >= max."""
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        factor = torch.where(norm < self.gradient_clip_val, 1.0, self.gradient_clip_val / norm)
        return torch._foreach_mul(grads, factor)

    def _direction(self, params, grads, state: OptState) -> List[torch.Tensor]:
        """The update before the learning rate: Adam's m̂ / (sqrt(v̂) + eps),
        RAdam's rectified form, AdamW's plus the decayed weights."""
        b1, b2 = B1, B2
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1 - b2)
        t = np.float32(state.count + 1)
        # optax's bias corrections and rho in f32, as its compiled update
        # computes them: rho's 1 - b2**t cancels, so another rounding of
        # b2**t moves the rectified step by parts per thousand.
        bc1 = float(1 - np.float32(b1) ** t)
        b2t = np.float32(b2) ** t
        bc2 = float(1 - b2t)
        mu_hat = torch._foreach_div(state.mu, bc1)
        if self.kind == "radam":
            rho_inf = 2.0 / (1.0 - b2) - 1.0
            rho = np.float32(rho_inf) - 2 * t * b2t / (1 - b2t)
            if rho < RADAM_THRESHOLD:
                return mu_hat
            r = float(np.sqrt((rho - 4.0) * (rho - 2.0) * np.float32(rho_inf)
                              / ((np.float32(rho_inf) - 4.0) * (np.float32(rho_inf) - 2.0) * rho)))
            torch._foreach_mul_(mu_hat, r)
        denom = torch._foreach_div(state.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        torch._foreach_div_(mu_hat, denom)
        if self.kind == "adamw":
            torch._foreach_add_(mu_hat, params, alpha=ADAMW_WEIGHT_DECAY)
        return mu_hat


def build_optimizer(
    *,
    optimizer: str,
    learning_rate: float,
    min_learning_rate: float = 1e-6,
    lr_decay: Optional[str] = None,
    max_train_steps: int = 1,
    gradient_clip_val: Optional[float] = 0.1,
    accumulate_steps: int = 1,
) -> Optimizer:
    """The JAX package's ``build_optimizer`` with the same arguments."""
    if lr_decay == "exp":
        lr = exp_decay_schedule(learning_rate, min_learning_rate, max(1, max_train_steps))
    elif lr_decay == "cosine":
        lr = cosine_decay_schedule(learning_rate, max(1, max_train_steps), alpha=min_learning_rate / learning_rate)
    elif lr_decay is None:
        lr = lambda step: learning_rate  # noqa: E731
    else:
        raise ValueError(f"Unknown lr decay {lr_decay!r}")
    if optimizer not in ("adam", "adamw", "radam"):
        raise ValueError(f"Unknown optimizer {optimizer!r}")
    return Optimizer(
        kind=optimizer, learning_rate=lr, gradient_clip_val=gradient_clip_val,
        accumulate_steps=max(1, int(accumulate_steps)),
    )
