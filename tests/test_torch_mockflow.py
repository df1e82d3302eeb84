"""The port's structured synthetic-turbulence mock solver
(``generative_turbulence_tpu_torch/toolchain/mockflow.py``): the properties
``tests/test_mockflow.py`` asserts of the JAX package's, each on the port's,
and the port's fields bit-equal to the JAX package's for the same geometry
and seed (host numpy on both sides, so the comparison is exact)."""

import math

import numpy as np
import pytest

from generative_turbulence_tpu.toolchain.mockflow import MockFlowCase as JMockFlowCase
from generative_turbulence_tpu.toolchain.mockflow import MockFlowParams as JMockFlowParams
from generative_turbulence_tpu_torch.toolchain.mockflow import MockFlowCase, MockFlowParams

FIN = [[[24, 8, 0], [30, 20, 24]]]


def _case(holes, shape=(96, 24, 24), seed=1, cls=MockFlowCase, **kw):
    inside = np.ones(shape, bool)
    holes = np.asarray(holes).reshape(-1, 2, 3)
    for lo, hi in holes:
        inside[lo[0] : hi[0], lo[1] : hi[1], lo[2] : hi[2]] = False
    return cls(inside, holes, h=0.002, seed=seed, **kw)


@pytest.fixture(scope="module")
def fin_case():
    return _case(FIN)


def test_mean_flow_mass_conserving(fin_case):
    flux = fin_case.u_mean[..., 0].sum(axis=(1, 2))
    assert flux.std() / flux.mean() < 1e-5
    # inlet plane carries the plug inflow
    np.testing.assert_allclose(fin_case.u_mean[0, :, :, 0], 20.0, rtol=5e-3)


def test_no_flow_in_obstacle(fin_case):
    assert np.all(fin_case.u_mean[~fin_case.inside] == 0.0)
    f = fin_case.frame(0)
    assert np.all(f["u"][~fin_case.inside] == 0.0)
    assert np.all(f["k"][~fin_case.inside] == 0.0)


def test_wake_tke_peaks_behind_obstacle(fin_case):
    # the max of the mean TKE proxy sits downstream of the trailing face (x=30)
    prof = (fin_case.q**2).sum(axis=(1, 2))
    peak = int(prof.argmax())
    assert 30 < peak < 90


def test_geometry_dependence():
    a = _case(FIN)
    b = _case([[[48, 4, 4], [56, 20, 20]]])  # bigger body, further downstream
    pa = int((a.q**2).sum(axis=(1, 2)).argmax())
    pb = int((b.q**2).sum(axis=(1, 2)).argmax())
    assert pb > pa  # TKE maximum tracks the obstacle position
    assert a.u_mean[34, 14, 12, 0] < 0.8 * 20.0


def test_spectrum_von_karman_slope(fin_case):
    g = fin_case._fresh_noise()[..., 0]
    nx, ny, nz = g.shape
    F = np.abs(np.fft.rfftn(g)) ** 2
    kx = np.fft.fftfreq(nx) * 2 * np.pi
    ky = np.fft.fftfreq(ny) * 2 * np.pi
    kz = np.fft.rfftfreq(nz) * 2 * np.pi
    k = np.sqrt(kx[:, None, None] ** 2 + ky[None, :, None] ** 2 + kz[None, None, :] ** 2)

    def ek(lo, hi):
        sel = (k >= lo) & (k < hi)
        return F[sel].mean() * ((lo + hi) / 2) ** 2

    slope = math.log(ek(2.5, 3.1) / ek(1.7, 2.3)) / math.log(2.8 / 2.0)
    assert -2.2 < slope < -0.9
    assert ek(0.15, 0.3) < ek(0.4, 0.7)


def test_temporal_ar1():
    case = _case(FIN, seed=7)
    m = case.inside
    a = case.frame(0)["u"] - case.u_mean
    b = case.frame(1)["u"] - case.u_mean
    r = (a[m] * b[m]).sum() / np.sqrt((a[m] ** 2).sum() * (b[m] ** 2).sum())
    assert 0.4 < r < 0.8  # temporal_rho = 0.6
    assert np.abs(a - b).max() > 0.1


def test_seed_determinism():
    a = _case(FIN, seed=3).frame(0)["u"]
    b = _case(FIN, seed=3).frame(0)["u"]
    np.testing.assert_array_equal(a, b)


def test_k_consistent_with_fluctuations(fin_case):
    f = fin_case.frame(0)
    m = fin_case.inside
    k_mean = f["k"][m].mean()
    expected = 1.5 * (fin_case.q[m] ** 2).mean()
    assert 0.5 * expected < k_mean < 2.0 * expected
    assert np.all(f["nut"][m] >= 0.0)


@pytest.mark.parametrize(
    "holes, shape, seed, inflow",
    [
        (FIN, (96, 24, 24), 3, 20.0),
        ([[[8, 2, 2], [12, 6, 6]], [[20, 1, 3], [23, 5, 8]]], (48, 12, 12), 1234567, 10.0),
    ],
    ids=["fin", "two-blocks"],
)
def test_fields_match_jax(holes, shape, seed, inflow):
    """The mean flow, the intensity and three AR(1) frames in both
    representations (dense and per cell) bit-equal to the JAX package's."""
    got = _case(holes, shape, seed, nu=1e-5, params=MockFlowParams(inflow=inflow))
    want = _case(holes, shape, seed, cls=JMockFlowCase, nu=1e-5, params=JMockFlowParams(inflow=inflow))
    for name in ("u_mean", "p_mean", "q", "inside"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    for i in range(3):
        frames = (got.frame(i), want.frame(i)), (got.cell_frame(i), want.cell_frame(i))
        for g, w in frames:
            assert g.keys() == w.keys()
            for key in w:
                assert g[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(g[key], w[key], err_msg=f"frame {i} {key}")
