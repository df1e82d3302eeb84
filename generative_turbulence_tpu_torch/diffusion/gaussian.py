"""Gaussian diffusion: forward process, reconstructions, the training loss,
and the DDPM (ancestral) and DDIM samplers as plain Python loops over the
dense state ``(B, X, Y, Z, F)``.

Port of ``generative_turbulence_tpu/diffusion/gaussian.py``.  Boundary
conditions: with ``noise_bcs=False`` only in-domain cells are noised and the
boundary cells stay pinned to their clean values; with ``noise_bcs=True``
(the shapes default) boundary cells are re-sampled from q(x_t | x_bcs) after
every step.  Either way the final sample gets the exact boundary values.

The samplers draw standard normals from a ``noise`` source, a callable
``noise(shape) -> tensor``, in the JAX sampler's order: x_T first, then at
each step ``noise`` and then (with ``noise_bcs``) ``bc_noise``; DDIM draws
``noise`` even at eta = 0.  Replaying JAX's draws through it reproduces the
JAX samplers.

The training loss (``loss``, ``p_losses``) draws from the same kind of
source: ``loss`` draws the timesteps ``noise.randint(B, T)`` (uniform over
[0, T), one per batch element) and then the noise of ``x_start``'s shape, in
the JAX loss's order.  It is the masked mean over in-domain cells of the l2
or l1 error of the epsilon (or v) head, optionally min-SNR weighted, plus
the weighted ELBO term with learned variances.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..data.grid import GridMap, masked_mean
from .schedules import beta_schedule

EpsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
NoiseFn = Callable[[Sequence[int]], torch.Tensor]


class GeneratorNoise:
    """f32 standard normals from a ``torch.Generator`` on ``device``."""

    def __init__(self, generator: torch.Generator, device):
        self.generator, self.device = generator, torch.device(device)

    def __call__(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator, device=self.device)

    def randint(self, n: int, high: int) -> torch.Tensor:
        """``n`` int64 draws, uniform over [0, high)."""
        return torch.randint(0, high, (n,), generator=self.generator, device=self.device)


def _bcast(coefs: torch.Tensor, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Gather per-timestep coefficients and broadcast right against ``like``."""
    vals = coefs[t]
    return vals.reshape(vals.shape + (1,) * (like.dim() - vals.dim()))


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N(mean1, exp(logvar1)) || N(mean2, exp(logvar2))), elementwise."""
    return 0.5 * (
        -1.0
        + logvar2
        - logvar1
        + torch.exp(logvar1 - logvar2)
        + (mean1 - mean2) ** 2 * torch.exp(-logvar2)
    )


def normal_log_likelihood(x, mean, log_var):
    log_2pi = float(np.log(2 * np.pi))
    return -0.5 * (log_var + log_2pi + (x - mean) ** 2 * torch.exp(-log_var))


class ModelPrediction(NamedTuple):
    noise: torch.Tensor
    x_start: torch.Tensor
    mean: torch.Tensor
    log_var: torch.Tensor
    raw: torch.Tensor  # the network head (epsilon or v, per parameterization)


@dataclasses.dataclass(frozen=True)
class DiffusionConstants:
    """Process constants as f32 numpy arrays (computed in f64)."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    log_betas: np.ndarray
    posterior_log_var: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    @staticmethod
    def create(schedule: str, timesteps: int) -> "DiffusionConstants":
        betas = beta_schedule(schedule, timesteps)  # float64
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.concatenate([[1.0], acp[:-1]])

        log_betas = np.log(betas)
        # Stable log posterior variance via log1p; the t=0 entry
        # (log1p(-1) = -inf) is extrapolated so it is finite.
        with np.errstate(divide="ignore"):
            post_log_var = log_betas + np.log1p(-acp_prev) - np.log1p(-acp)
        post_log_var[0] = log_betas[0] * (post_log_var[1] / log_betas[1])

        f32 = lambda x: np.asarray(x, dtype=np.float32)  # noqa: E731
        return DiffusionConstants(
            betas=f32(betas),
            alphas_cumprod=f32(acp),
            sqrt_alphas_cumprod=f32(np.sqrt(acp)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
            sqrt_recip_alphas_cumprod=f32(1.0 / np.sqrt(acp)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / acp - 1.0)),
            log_betas=f32(log_betas),
            posterior_log_var=f32(post_log_var),
            posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
            posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
        )


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    """Diffusion process configuration + sampling math (stateless)."""

    constants: DiffusionConstants
    loss_type: str = "l2"  # or "l1"
    clip_denoised: bool = False
    noise_bcs: bool = True
    learned_variances: bool = False
    # weight of the ELBO term (with learned variances; None = no term)
    elbo_weight: Optional[float] = None
    detach_elbo_mean: bool = True
    parameterization: str = "epsilon"  # or "v"
    # None, or "min-snr-<gamma>": per-sample weight min(SNR, gamma) / SNR
    # (epsilon) or / (SNR + 1) (v)
    loss_weighting: Optional[str] = None
    # clip_denoised bounds in normalized space: None = [-1, 1]; otherwise
    # per-channel (lo, hi) arrays of shape (F,).
    clip_bounds: Optional[tuple] = None
    # device -> {constant name: tensor}; filled on first use on each device
    _on_device: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @staticmethod
    def create(
        *,
        beta_schedule: str = "log-snr-linear",
        timesteps: int = 500,
        loss_type: str = "l2",
        clip_denoised: bool = False,
        noise_bcs: bool = True,
        learned_variances: bool = False,
        elbo_weight: Optional[float] = None,
        detach_elbo_mean: bool = True,
        parameterization: str = "epsilon",
        loss_weighting: Optional[str] = None,
        clip_bounds: Optional[tuple] = None,
    ) -> "GaussianDiffusion":
        if parameterization not in ("epsilon", "v"):
            raise ValueError(f"Unknown parameterization {parameterization!r}")
        if loss_type not in ("l2", "l1"):
            raise ValueError(f"Invalid loss type {loss_type!r}")
        if loss_weighting is not None and not loss_weighting.startswith("min-snr-"):
            raise ValueError(f"Unknown loss weighting {loss_weighting!r}")
        return GaussianDiffusion(
            constants=DiffusionConstants.create(beta_schedule, timesteps),
            loss_type=loss_type,
            clip_denoised=clip_denoised,
            noise_bcs=noise_bcs,
            learned_variances=learned_variances,
            elbo_weight=elbo_weight,
            detach_elbo_mean=detach_elbo_mean,
            parameterization=parameterization,
            loss_weighting=loss_weighting,
            clip_bounds=clip_bounds,
        )

    @property
    def num_timesteps(self) -> int:
        return self.constants.num_timesteps

    def _at(self, name: str, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """Constant ``name`` at timesteps t, broadcast against ``like``."""
        table = self._on_device.setdefault(like.device, {})
        if name not in table:
            table[name] = torch.as_tensor(getattr(self.constants, name), device=like.device)
        return _bcast(table[name], t, like)

    # ---- forward process ---------------------------------------------------

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        return (
            self._at("sqrt_alphas_cumprod", t, x_start) * x_start
            + self._at("sqrt_one_minus_alphas_cumprod", t, x_start) * noise
        )

    # ---- reconstructions ---------------------------------------------------

    def predict_start_from_noise(self, x_t, t, noise):
        return (
            self._at("sqrt_recip_alphas_cumprod", t, x_t) * x_t
            - self._at("sqrt_recipm1_alphas_cumprod", t, x_t) * noise
        )

    def predict_noise_from_start(self, x_t, t, x0):
        return (
            self._at("sqrt_recip_alphas_cumprod", t, x_t) * x_t - x0
        ) / self._at("sqrt_recipm1_alphas_cumprod", t, x_t)

    def q_posterior(self, x_start, x_t, t):
        mean = (
            self._at("posterior_mean_coef1", t, x_t) * x_start
            + self._at("posterior_mean_coef2", t, x_t) * x_t
        )
        return mean, self._at("posterior_log_var", t, x_t)

    # v-parameterization: with x_t = a x0 + s eps (a = sqrt(acp),
    # s = sqrt(1 - acp)) the network predicts v = a eps - s x0, so
    # x0 = a x_t - s v and eps = s x_t + a v.

    def v_from_start_and_noise(self, x_start, t, noise):
        a = self._at("sqrt_alphas_cumprod", t, x_start)
        s = self._at("sqrt_one_minus_alphas_cumprod", t, x_start)
        return a * noise - s * x_start

    def predict_start_from_v(self, x_t, t, v):
        a = self._at("sqrt_alphas_cumprod", t, x_t)
        s = self._at("sqrt_one_minus_alphas_cumprod", t, x_t)
        return a * x_t - s * v

    def predict_noise_from_v(self, x_t, t, v):
        a = self._at("sqrt_alphas_cumprod", t, x_t)
        s = self._at("sqrt_one_minus_alphas_cumprod", t, x_t)
        return s * x_t + a * v

    def model_predictions(
        self, eps_fn: EpsFn, x_t: torch.Tensor, t: torch.Tensor, grid: GridMap
    ) -> ModelPrediction:
        inside = grid.inside_mask[..., None]
        out = eps_fn(x_t, t)
        if self.learned_variances:
            raw, var_weights = out.chunk(2, dim=-1)
            log_betas = self._at("log_betas", t, var_weights)
            post_log_var = self._at("posterior_log_var", t, var_weights)
            # sigmoid-lerp between the beta and posterior log-variances
            w = torch.sigmoid(var_weights)
            log_var = log_betas + w * (post_log_var - log_betas)
        else:
            raw = out
            log_var = self._at("log_betas", t, x_t)

        if self.parameterization == "v":
            x_start = self.predict_start_from_v(x_t, t, raw)
            pred_noise = self.predict_noise_from_v(x_t, t, raw)
        else:
            pred_noise = raw
            x_start = self.predict_start_from_noise(x_t, t, pred_noise)
        if not self.noise_bcs:
            # Pin the prediction to the (clean) BC values carried by x_t.
            x_start = torch.where(inside, x_start, x_t)
        if self.clip_denoised:
            if self.clip_bounds is not None:
                lo, hi = (torch.as_tensor(b, dtype=x_start.dtype, device=x_start.device) for b in self.clip_bounds)
                x_start = torch.clamp(x_start, lo, hi)
            else:
                x_start = torch.clamp(x_start, -1.0, 1.0)

        mean, _ = self.q_posterior(x_start, x_t, t)
        return ModelPrediction(pred_noise, x_start, mean, log_var, raw)

    # ---- training loss -----------------------------------------------------

    def p_losses(
        self, eps_fn: EpsFn, x_start: torch.Tensor, t: torch.Tensor, grid: GridMap, noise: NoiseFn
    ) -> torch.Tensor:
        """The training loss at timesteps ``t`` (B,), with one draw of
        ``noise`` of ``x_start``'s shape: a scalar tensor."""
        inside = grid.inside_mask[..., None]
        eps = noise(x_start.shape).to(x_start.dtype)
        x_t = self.q_sample(x_start, t, eps)
        if not self.noise_bcs:
            x_t = torch.where(inside, x_t, x_start)

        pred = self.model_predictions(eps_fn, x_t, t, grid)

        target = self.v_from_start_and_noise(x_start, t, eps) if self.parameterization == "v" else eps
        if self.loss_type == "l2":
            err = (pred.raw - target) ** 2
        elif self.loss_type == "l1":
            err = torch.abs(pred.raw - target)
        else:
            raise ValueError(f"Invalid loss type {self.loss_type!r}")

        # Mean over the in-domain cells of each sample.
        per_sample = masked_mean(err, grid)
        if self.loss_weighting is not None:
            gamma = float(self.loss_weighting[len("min-snr-"):])
            acp = self._at("alphas_cumprod", t, per_sample)
            snr = acp / (1.0 - acp)
            denom = snr + 1.0 if self.parameterization == "v" else snr
            per_sample = per_sample * (torch.clamp(snr, max=gamma) / denom)
        loss = per_sample.mean()

        if self.elbo_weight is not None and self.learned_variances:
            true_mean, true_log_var = self.q_posterior(x_start, x_t, t)
            model_mean = pred.mean.detach() if self.detach_elbo_mean else pred.mean
            kl = normal_kl(true_mean, true_log_var, model_mean, pred.log_var)
            log_lk = normal_log_likelihood(x_t, model_mean, pred.log_var)
            elbo = torch.where(t == 0, -masked_mean(log_lk, grid), masked_mean(kl, grid))
            loss = loss + self.elbo_weight * elbo.mean()
        return loss

    def loss(self, eps_fn: EpsFn, x_start: torch.Tensor, grid: GridMap, noise) -> torch.Tensor:
        """Draw t ~ U[0, T) per batch element (``noise.randint``), then the
        noise (``noise(shape)``), and return the training loss."""
        t = noise.randint(x_start.shape[0], self.num_timesteps).to(x_start.device)
        return self.p_losses(eps_fn, x_start, t, grid, noise)

    # ---- ancestral (DDPM) sampling ------------------------------------------

    def p_sample_loop(
        self,
        eps_fn: EpsFn,
        x_bcs: torch.Tensor,
        grid: GridMap,
        noise: NoiseFn,
        start_from: Optional[int] = None,
    ) -> torch.Tensor:
        """Ancestral sampling over all T steps, or over the last
        ``start_from`` steps from x_bcs noised to that level.

        x_bcs carries the boundary values (a grid embedding of any frame; only
        its non-domain cells matter)."""
        B = x_bcs.shape[0]
        T = self.num_timesteps if start_from is None else int(start_from)
        inside = grid.inside_mask[..., None]
        full = lambda v: torch.full((B,), v, dtype=torch.long, device=x_bcs.device)  # noqa: E731

        if start_from is None:
            x_t = noise(x_bcs.shape)
        else:
            x_t = self.q_sample(x_bcs, full(T - 1), noise(x_bcs.shape))
        if not self.noise_bcs:
            x_t = torch.where(inside, x_t, x_bcs)

        for step in range(T - 1, -1, -1):
            t = full(step)
            pred = self.model_predictions(eps_fn, x_t, t, grid)
            z = noise(x_t.shape)
            if not self.noise_bcs:
                z = torch.where(inside, z, torch.zeros_like(z))
            x_next = pred.mean + torch.exp(pred.log_var / 2) * z
            if self.noise_bcs:
                # Re-sample boundary cells from q(x_t | x_bcs) at this level.
                x_bc_t = self.q_sample(x_bcs, t, noise(x_t.shape))
                x_next = torch.where(inside, x_next, x_bc_t)
            # At t == 0 return the predicted mean instead of a sample.
            x_t = pred.mean if step == 0 else x_next

        # Impose the exact BC values regardless of the noising mode.
        return torch.where(inside, x_t, x_bcs)

    # ---- DDIM sampling ------------------------------------------------------

    def ddim_sample_loop(
        self,
        eps_fn: EpsFn,
        x_bcs: torch.Tensor,
        grid: GridMap,
        noise: NoiseFn,
        *,
        num_steps: int = 50,
        eta: float = 0.0,
    ) -> torch.Tensor:
        """DDIM over an evenly spaced timestep subsequence; eta = 0 is
        deterministic, eta = 1 recovers ancestral variance on the subsequence."""
        B = x_bcs.shape[0]
        T = self.num_timesteps
        inside = grid.inside_mask[..., None]
        full = lambda v: torch.full((B,), v, dtype=torch.long, device=x_bcs.device)  # noqa: E731

        taus = np.linspace(0, T - 1, num_steps).round().astype(np.int32)
        taus_prev = np.concatenate([[-1], taus[:-1]]).astype(np.int32)
        # acp[i + 1] = alpha_bar_i; acp[0] = 1 for the virtual step t = -1
        acp = np.concatenate([np.ones(1, np.float32), self.constants.alphas_cumprod])

        x_t = noise(x_bcs.shape)
        if not self.noise_bcs:
            x_t = torch.where(inside, x_t, x_bcs)

        for tau, tau_prev in zip(taus[::-1].tolist(), taus_prev[::-1].tolist()):
            t = full(tau)
            x0 = self.model_predictions(eps_fn, x_t, t, grid).x_start
            # Re-derive the noise consistent with the (possibly clipped or
            # pinned) x0 so the update stays on the DDIM trajectory.
            eps = self.predict_noise_from_start(x_t, t, x0)

            a_t, a_prev = acp[tau + 1], acp[tau_prev + 1]
            one = np.float32(1)
            sigma = np.float32(eta) * np.sqrt((one - a_prev) / (one - a_t)) * np.sqrt(one - a_t / a_prev)
            dir_coef = np.sqrt(np.maximum(one - a_prev - sigma**2, np.float32(0)))

            z = noise(x_t.shape)
            if not self.noise_bcs:
                z = torch.where(inside, z, torch.zeros_like(z))
            if tau_prev < 0:
                # Final step keeps the clean estimate.
                x_next = float(np.sqrt(a_prev)) * x0
            else:
                x_next = float(np.sqrt(a_prev)) * x0 + float(dir_coef) * eps + float(sigma) * z

            if self.noise_bcs:
                bc_noise = noise(x_t.shape)
                if tau_prev < 0:
                    x_bc = x_bcs
                else:
                    x_bc = self.q_sample(x_bcs, full(tau_prev), bc_noise)
                x_next = torch.where(inside, x_next, x_bc)
            else:
                x_next = torch.where(inside, x_next, x_bcs)
            x_t = x_next
        return torch.where(inside, x_t, x_bcs)
