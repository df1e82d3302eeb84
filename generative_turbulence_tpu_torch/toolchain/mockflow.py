"""Structured synthetic turbulence for mock-solved cases.

The offline stand-in for the OpenFOAM LES solve (reference protocol:
``scripts/les-template/Allrun`` -> pimpleFoam).  Rather than i.i.d. white
noise (statistically identical across geometries, flat spectra), this
produces GEOMETRY-DEPENDENT fields with the qualitative structure the
evaluation stack measures (``turbdiff/models/metrics.py:381-581`` analogues):

- a mass-consistent potential mean flow around the obstacles (sparse-CG
  Laplace solve with inlet-flux / outlet-pressure / no-penetration BCs),
- a self-similar wake velocity deficit behind each obstacle,
- divergence-free fluctuations with a von Karman energy spectrum
  (k^-5/3 inertial range), AR(1)-correlated in time,
- turbulence intensity localized in the wake shear layers, so the mean-TKE
  maximum sits a case-dependent distance behind the obstacle
  (``max-mean-tke-pos`` becomes a discriminating target),
- p/k/nut fields consistent with u (Bernoulli mean + correlated
  fluctuations; smoothed fluctuation energy; mixing-length viscosity).

None of this is a CFD solve — it is a statistical mock whose purpose is to
give the training/eval pipeline learnable geometry->statistics structure at
the full shapes resolution without the ~2 TB real dataset.

A copy of ``generative_turbulence_tpu/toolchain/mockflow.py`` (host numpy,
no JAX): the same names, defaults and results.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
from scipy import fft as sfft
from scipy import sparse
from scipy.ndimage import gaussian_filter
from scipy.sparse.linalg import cg


@dataclasses.dataclass(frozen=True)
class MockFlowParams:
    inflow: float = 20.0
    # integral length scale of the synthetic turbulence, in cells
    integral_scale: float = 12.0
    # free-stream / wake-peak turbulence intensity (fraction of inflow)
    base_intensity: float = 0.02
    wake_intensity: float = 0.30
    # wake deficit peak (fraction of inflow) and streamwise decay length
    # (multiples of the obstacle height)
    wake_deficit: float = 0.55
    wake_extent: float = 8.0
    # AR(1) frame-to-frame correlation of the fluctuation field
    temporal_rho: float = 0.6
    pressure_coeff: float = 0.35


def _laplace_potential(
    inside: np.ndarray, u0: float, h: float, tol: float = 1e-6
) -> np.ndarray:
    """Potential flow: solve div grad phi = 0 over the in-domain cells.

    Finite-volume 7-point Laplacian; inlet (x-) faces carry the inflow flux
    as a Neumann source, outlet (x+) faces are phi=0 Dirichlet (half-cell),
    every other boundary face (walls, obstacle) is zero-flux.  Returns phi on
    the dense grid (0 outside).  u_mean = grad phi.
    """
    nx, ny, nz = inside.shape
    n = int(inside.sum())
    idx = np.full(inside.shape, -1, dtype=np.int64)
    idx[inside] = np.arange(n)

    diag = np.zeros(n)
    rows, cols, vals = [], [], []
    rhs = np.zeros(n)

    for axis in range(3):
        for sign in (-1, 1):
            shifted = np.roll(inside, -sign, axis=axis)
            # roll wraps around; cells on the domain edge have no neighbor
            edge = np.zeros_like(inside)
            sl = [slice(None)] * 3
            sl[axis] = -1 if sign == 1 else 0
            edge[tuple(sl)] = True
            has_nb = inside & shifted & ~edge
            ic = idx[has_nb]
            nb = np.roll(idx, -sign, axis=axis)[has_nb]
            rows.append(ic)
            cols.append(nb)
            vals.append(np.ones(ic.size))
            diag_add = np.zeros(n)
            np.add.at(diag_add, ic, -1.0)
            diag += diag_add

            # boundary faces of this direction: domain edge or obstacle face
            bface = inside & (edge | ~shifted)
            if axis == 0 and sign == -1:
                # inlet: prescribed flux u0 into the domain
                rhs[idx[bface & edge]] += u0 * h
            elif axis == 0 and sign == 1:
                # outlet: phi = 0 at the face (half-cell Dirichlet)
                out_cells = idx[bface & edge]
                d = np.zeros(n)
                np.add.at(d, out_cells, -2.0)
                diag += d
            # walls / obstacle: zero flux -> no contribution

    rows.append(np.arange(n))
    cols.append(np.arange(n))
    vals.append(diag)
    A = sparse.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    )
    # Jacobi-preconditioned CG (A is symmetric negative definite -> negate)
    M = sparse.diags(1.0 / np.abs(diag))
    phi, info = cg(-A, -rhs, rtol=tol, maxiter=2000, M=M)
    if info != 0:  # pragma: no cover - convergence is geometric, not data-dep
        raise RuntimeError(f"potential-flow CG did not converge (info={info})")
    out = np.zeros(inside.shape, dtype=np.float64)
    out[inside] = phi
    return out


def _gradient(phi: np.ndarray, inside: np.ndarray, u0: float, h: float) -> np.ndarray:
    """Central-difference grad phi with BC-consistent ghost values."""
    g = np.zeros((*phi.shape, 3), dtype=np.float64)
    pad = np.pad(phi, 1, mode="edge")  # walls: zero normal gradient
    ins = np.pad(inside, 1, mode="constant")
    # obstacle faces: Neumann 0 -> mirror the inside value
    for axis in range(3):
        up = np.roll(pad, -1, axis=axis)
        dn = np.roll(pad, 1, axis=axis)
        up_in = np.roll(ins, -1, axis=axis)
        dn_in = np.roll(ins, 1, axis=axis)
        up = np.where(up_in, up, pad)
        dn = np.where(dn_in, dn, pad)
        g[..., axis] = (up - dn)[1:-1, 1:-1, 1:-1] / (2 * h)
    # inlet/outlet ghosts along x
    gx = g[..., 0]
    phi0, phi1 = phi[0], phi[1]
    gx[0] = ((phi1 - (phi0 - u0 * h)) / (2 * h)) * inside[0] + gx[0] * (~inside[0])
    phim, phim2 = phi[-1], phi[-2]
    gx[-1] = (((-phim) - phim2) / (2 * h)) * inside[-1] + gx[-1] * (~inside[-1])
    g[..., 0] = gx
    g[~inside] = 0.0
    return g


def _wake_fields(
    inside: np.ndarray,
    holes: np.ndarray,
    params: MockFlowParams,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-cell wake deficit W(x) in [0,1] and turbulence envelope Q(x) in [0,1].

    For each obstacle: take its cross-stream silhouette, spread it downstream
    with a growing Gaussian blur (shear-layer growth), peak the turbulence
    1-2 obstacle-heights behind the trailing face, decay the deficit over
    ``wake_extent`` heights (self-similar wake scaling ~ (dx/D)^-2/3).
    """
    nx, ny, nz = inside.shape
    deficit = np.zeros(inside.shape)
    envelope = np.zeros(inside.shape)
    for lo, hi in holes:
        sil = np.zeros((ny, nz))
        sil[lo[1] : hi[1], lo[2] : hi[2]] = 1.0
        height = max(hi[1] - lo[1], hi[2] - lo[2])
        x_back = hi[0]
        dxs = np.arange(nx - x_back)
        if dxs.size == 0:
            continue
        rel = dxs / max(height, 1)
        # deficit decays downstream; turbulence peaks slightly behind the body
        def_mag = params.wake_deficit * (1.0 + rel / 2.0) ** (-2.0 / 3.0)
        env_mag = (rel + 0.25) / 1.5 * np.exp(1.0 - (rel + 0.25) / 1.5)
        grow = 0.8 + 0.35 * rel * max(height, 1)
        for j, x in enumerate(range(x_back, nx)):
            sm = gaussian_filter(sil, sigma=float(min(grow[j], 12.0)))
            m = sm.max()
            if m > 0:
                sm = sm / m
            deficit[x] = np.maximum(deficit[x], def_mag[j] * sm)
            envelope[x] = np.maximum(envelope[x], env_mag[j] * sm)
        # shear layers alongside the body itself
        for x in range(lo[0], min(hi[0], nx)):
            edge = gaussian_filter(sil, 1.2) - 0.7 * gaussian_filter(sil, 0.4)
            edge = np.clip(edge, 0, None)
            if edge.max() > 0:
                envelope[x] = np.maximum(envelope[x], 0.35 * edge / edge.max())
    deficit[~inside] = 0.0
    envelope[~inside] = 0.0
    return deficit, envelope


class MockFlowCase:
    """Frame generator for one case: build once, then ``frame(i)`` in order.

    Fields are returned as dense (X, Y, Z[, 3]) float32 arrays; callers
    extract the in-domain cells with ``arr[inside]`` (C-order — the same
    ordering the polyMesh writer and the grid embedding use).
    """

    def __init__(
        self,
        inside: np.ndarray,
        holes: np.ndarray,
        h: float,
        *,
        params: Optional[MockFlowParams] = None,
        seed: int = 0,
        nu: float = 1e-5,
    ):
        self.params = p = params or MockFlowParams()
        self.inside = inside
        self.h = h
        self.nu = nu
        self.rng = np.random.default_rng(seed)

        phi = _laplace_potential(inside, p.inflow, h)
        u_mean = _gradient(phi, inside, p.inflow, h)
        deficit, envelope = _wake_fields(inside, np.asarray(holes), p)
        u_mean[..., 0] *= 1.0 - deficit
        # restore mass consistency: the wake deficit removes streamwise flux;
        # rescale u_x per x-slice so every slice carries the inlet flux (the
        # physical compensation — faster flow outside the wake)
        flux = u_mean[..., 0].sum(axis=(1, 2))
        target = p.inflow * inside[0].sum()
        scale = np.where(np.abs(flux) > 1e-9, target / flux, 1.0)
        u_mean[..., 0] *= scale[:, None, None]
        self.u_mean = u_mean.astype(np.float32)

        # local fluctuation intensity (std of each velocity component)
        self.q = (
            p.inflow * (p.base_intensity + p.wake_intensity * envelope)
        ).astype(np.float32) * inside

        self._spec_amp = self._spectrum_amplitude(inside.shape, p.integral_scale)
        # Precompute the divergence-free projection arrays once (float32):
        # rebuilding these complex broadcasts per frame dominated generation.
        nx, ny, nz = inside.shape
        kx = (np.fft.fftfreq(nx) * 2 * np.pi).astype(np.float32)
        ky = (np.fft.fftfreq(ny) * 2 * np.pi).astype(np.float32)
        kz = (np.fft.rfftfreq(nz) * 2 * np.pi).astype(np.float32)
        half = (nx, ny, kz.size)
        self._kvec = np.stack(
            [
                np.broadcast_to(kx[:, None, None], half),
                np.broadcast_to(ky[None, :, None], half),
                np.broadcast_to(kz[None, None, :], half),
            ]
        ).copy()
        k2 = np.sum(self._kvec**2, axis=0)
        k2[0, 0, 0] = 1.0
        self._kvec_over_k2 = (self._kvec / k2[None]).astype(np.float32)
        self._state: Optional[np.ndarray] = None

        # Bernoulli mean pressure (rho = 1): stagnation ahead, suction in the
        # accelerated passages; the wake deficit keeps p low behind the body.
        speed2 = np.sum(self.u_mean**2, axis=-1)
        self.p_mean = (0.5 * (p.inflow**2 - speed2) * inside).astype(np.float32)

    @staticmethod
    def _spectrum_amplitude(shape, integral_scale: float) -> np.ndarray:
        nx, ny, nz = shape
        kx = np.fft.fftfreq(nx) * 2 * np.pi
        ky = np.fft.fftfreq(ny) * 2 * np.pi
        kz = np.fft.rfftfreq(nz) * 2 * np.pi
        kk = np.sqrt(
            kx[:, None, None] ** 2 + ky[None, :, None] ** 2 + kz[None, None, :] ** 2
        )
        k0 = 2 * np.pi / integral_scale
        with np.errstate(divide="ignore", invalid="ignore"):
            # sqrt(E(k) / 4 pi k^2) with von Karman E(k) ~ (k/k0)^4/(1+(k/k0)^2)^(17/6)
            amp = (kk / k0) ** 2 / (1 + (kk / k0) ** 2) ** (17.0 / 12.0) / kk
        amp[kk == 0] = 0.0
        return amp.astype(np.float32)

    def _fresh_noise(self) -> np.ndarray:
        """Unit-variance divergence-free correlated noise, (X, Y, Z, 3)."""
        nx, ny, nz = self.inside.shape
        w = self.rng.standard_normal((3, nx, ny, nz)).astype(np.float32)
        wh = sfft.rfftn(w, axes=(1, 2, 3))  # complex64 (scipy preserves f32)
        wh *= self._spec_amp[None]
        # project divergence-free: u_i -= k_i (k . u) / k^2
        dot = np.sum(self._kvec * wh, axis=0)
        wh -= self._kvec_over_k2 * dot[None]
        f = sfft.irfftn(wh, s=(nx, ny, nz), axes=(1, 2, 3))
        # ONE scalar normalizer: per-component scaling would break the
        # divergence-free projection
        f /= f.std()
        return np.moveaxis(f, 0, -1)

    def frame(self, i: int) -> Dict[str, np.ndarray]:
        """Generate frame ``i`` (call with consecutive i; AR(1) in time)."""
        p = self.params
        fresh = self._fresh_noise()
        if self._state is None:
            self._state = fresh
        else:
            rho = p.temporal_rho
            self._state = rho * self._state + np.sqrt(1 - rho**2) * fresh
        fluct = self._state * self.q[..., None]

        u = self.u_mean + fluct
        u[~self.inside] = 0.0

        # pressure: Bernoulli mean + smoothed streamwise-velocity correlation
        p_f = gaussian_filter(fluct[..., 0], sigma=2.0, mode="nearest")
        pressure = self.p_mean + p.pressure_coeff * p.inflow * p_f.astype(np.float32)
        pressure[~self.inside] = 0.0

        # k: local (smoothed) fluctuation energy, mean ~ 1.5 q^2
        e = 0.5 * np.sum(fluct**2, axis=-1)
        k = gaussian_filter(e, sigma=2.0, mode="nearest").astype(np.float32)
        k[~self.inside] = 0.0

        # nut: mixing-length model on the local k
        ell = p.integral_scale * self.h
        nut = (0.09 * np.sqrt(np.maximum(k, 0.0)) * ell).astype(np.float32)
        nut[~self.inside] = 0.0

        return {
            "u": u.astype(np.float32),
            "p": pressure,
            "k": k,
            "nut": nut,
        }

    def cell_frame(self, i: int) -> Dict[str, np.ndarray]:
        """Frame ``i`` restricted to in-domain cells (C-order), the layout
        ``data/{u,p,k,nut}`` stores (``scripts/foam2h5.py:183-191``)."""
        f = self.frame(i)
        return {
            "u": f["u"][self.inside],
            "p": f["p"][self.inside],
            "k": f["k"][self.inside],
            "nut": f["nut"][self.inside],
        }
