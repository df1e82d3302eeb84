"""The port's evaluation ops against the JAX package's on the same inputs
(numpy, seeded): ``interp3``, the stencils, both quadratures, the TKE
spectrum and the log-spectrum distance at f32 rtol 2e-4 / atol 2e-5, and
the Sinkhorn solvers at rtol 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_turbulence_tpu.ops import interp as jinterp
from generative_turbulence_tpu.ops import quadrature as jquadrature
from generative_turbulence_tpu.ops import sinkhorn as jsinkhorn
from generative_turbulence_tpu.ops import spectra as jspectra
from generative_turbulence_tpu.ops import stencils as jstencils
from generative_turbulence_tpu_torch.ops import interp, quadrature, sinkhorn, spectra, stencils

F32_TOL = dict(rtol=2e-4, atol=2e-5)
SINKHORN_TOL = dict(rtol=1e-4)
H = np.array([0.1, 0.2, 0.3], dtype=np.float32)


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("points_shape", [(7, 3), (4, 9, 3)])
def test_interp3_matches_jax(points_shape):
    grid = _normal(0, 2, 7, 6, 5)
    rng = np.random.default_rng(1)
    # Inside the grid and past every face, where the indices clamp.
    points = rng.uniform(-1.5, 8.0, size=points_shape).astype(np.float32)
    points[0] = [2.0, 3.0, 4.0]  # on a grid node
    want = np.asarray(jinterp.interp3(jnp.asarray(grid), jnp.asarray(points)))
    got = interp.interp3(torch.from_numpy(grid), torch.from_numpy(points)).numpy()
    assert got.shape == want.shape == (2, *points_shape[:-1])
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("name", ["curl", "divergence", "vector_gradient", "enstrophy"])
def test_stencils_match_jax(name):
    u = _normal(2, 2, 9, 8, 7, 3)
    want = np.asarray(getattr(jstencils, name)(jnp.asarray(u), H))
    got = getattr(stencils, name)(torch.from_numpy(u), H).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_derivatives_match_jax(dim):
    x = _normal(3, 2, 9, 8, 7)
    want = np.asarray(jstencils.unpadded_derivative(jnp.asarray(x), H, dim=dim))
    got = stencils.unpadded_derivative(torch.from_numpy(x), H, dim=dim).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)
    want = np.asarray(jstencils.centered_difference(jnp.asarray(x), dim=dim, h=0.5))
    got = stencils.centered_difference(torch.from_numpy(x), dim=dim, h=0.5).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_stencils_take_a_tensor_cell_size():
    u = torch.from_numpy(_normal(4, 1, 6, 6, 6, 3))
    torch.testing.assert_close(stencils.curl(u, torch.from_numpy(H)), stencils.curl(u, H))


@pytest.mark.parametrize("n", [8, 16, 64])
def test_gauss_legendre_matches_jax(n):
    for got, want in zip(quadrature.gauss_legendre(n), jquadrature.gauss_legendre(n)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("n", [128, 512, 5810])
def test_sphere_quadrature_matches_jax(n):
    for got, want in zip(quadrature.sphere_quadrature(n), jquadrature.sphere_quadrature(n)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.fixture(scope="module")
def spectrum_ops():
    return (spectra.SpectrumOps.create(n_sphere=512, n_legendre=16, device="cpu"),
            jspectra.SpectrumOps.create(n_sphere=512, n_legendre=16))


@pytest.mark.parametrize("spatial", [(12, 10, 10), (9, 11, 8)])
def test_tke_spectrum_matches_jax(spectrum_ops, spatial):
    ops, jops = spectrum_ops
    u = _normal(5, 3, *spatial, 3)
    jk = jspectra.spectrum_wavenumbers(spatial, jops)
    k = spectra.spectrum_wavenumbers(spatial, ops)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **F32_TOL)
    want = np.asarray(jspectra.tke_spectrum(jnp.asarray(u), jk, jops))
    got = spectra.tke_spectrum(torch.from_numpy(u), k, ops).numpy()
    assert got.shape == want.shape == (3, 16)
    np.testing.assert_allclose(got, want, **F32_TOL)
    np.testing.assert_allclose(
        spectra.tke_field(torch.from_numpy(u)).numpy(), np.asarray(jspectra.tke_field(jnp.asarray(u))), **F32_TOL
    )


def test_log_tke_distance_matrix_matches_jax(spectrum_ops):
    ops, jops = spectrum_ops
    u_a, u_b, u_mean = _normal(6, 3, 10, 10, 10, 3), _normal(7, 2, 10, 10, 10, 3), _normal(8, 10, 10, 10, 3)
    want = jspectra.log_tke_distance_matrix(*(jnp.asarray(a) for a in (u_a, u_b, u_mean)), jops)
    got = spectra.log_tke_distance_matrix(*(torch.from_numpy(a) for a in (u_a, u_b, u_mean)), ops)
    assert got[0].shape == (3, 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)
    with pytest.raises(ValueError, match="spatial shapes"):
        spectra.log_tke_distance_matrix(torch.from_numpy(u_a), torch.from_numpy(u_b)[:, :9], torch.from_numpy(u_mean), ops)


@pytest.mark.parametrize("reg,n_iters", [(0.1, 100), (0.5, 200)])
def test_sinkhorn_emd2_matches_jax(reg, n_iters):
    M = np.random.default_rng(1).uniform(size=(4, 10, 12)).astype(np.float32)
    want = np.asarray(jsinkhorn.sinkhorn_emd2(jnp.asarray(M), reg=reg, n_iters=n_iters))
    got = sinkhorn.sinkhorn_emd2(torch.from_numpy(M), reg=reg, n_iters=n_iters).numpy()
    assert got.shape == (4,)
    np.testing.assert_allclose(got, want, **SINKHORN_TOL)
    want = np.asarray(jsinkhorn.sinkhorn_wasserstein2(jnp.asarray(M), reg=reg, n_iters=n_iters))
    got = sinkhorn.sinkhorn_wasserstein2(torch.from_numpy(M), reg=reg, n_iters=n_iters).numpy()
    np.testing.assert_allclose(got, want, **SINKHORN_TOL)


@pytest.mark.parametrize("per_matrix_reg", [False, True], ids=["scalar-reg", "per-matrix-reg"])
def test_masked_sinkhorn_emd2_matches_jax(per_matrix_reg):
    """Padded clouds of mixed sizes (9x7, 4x11 and 11x11 of an 11x11 pad,
    garbage in the padding), with one reg or one per matrix."""
    rng = np.random.default_rng(2)
    M = np.abs(rng.normal(size=(3, 11, 11))).astype(np.float32)
    rows = np.arange(11)[None, :] < np.array([[9], [4], [11]])
    cols = np.arange(11)[None, :] < np.array([[7], [11], [11]])
    M[~(rows[:, :, None] & cols[:, None, :])] = 123.0
    reg = np.array([0.05, 0.1, 0.2], np.float32) if per_matrix_reg else 0.1
    want = np.asarray(jsinkhorn.masked_sinkhorn_emd2(
        jnp.asarray(M), jnp.asarray(rows), jnp.asarray(cols), reg=jnp.asarray(reg), n_iters=300))
    got = sinkhorn.masked_sinkhorn_emd2(
        torch.from_numpy(M), torch.from_numpy(rows), torch.from_numpy(cols),
        reg=torch.as_tensor(reg), n_iters=300).numpy()
    assert got.shape == (3,) and np.all(got < 10)  # no mass on the padding
    np.testing.assert_allclose(got, want, **SINKHORN_TOL)
