"""The port's evaluation against the JAX package's: the host EMD copy (the
cases of ``tests/test_eval.py``), the sample store in both formats (and a
port-written ``.h5`` read by the JAX store), and each metric and the
collection on the same frames of the JAX-written ``synthetic_root``, at
rtol 1e-3."""

import dataclasses
import math
import shutil

import numpy as np
import pytest

from generative_turbulence_tpu.data import CaseRepository as JCaseRepository
from generative_turbulence_tpu.data import Variable as JVariable
from generative_turbulence_tpu.data import find_data_files as j_find_data_files
from generative_turbulence_tpu.data.schema import FieldStats as JFieldStats
from generative_turbulence_tpu.eval import metrics as jmetrics
from generative_turbulence_tpu.eval.sample_store import SampleStore as JSampleStore
from generative_turbulence_tpu_torch.data.schema import CaseRepository, FieldStats, find_data_files
from generative_turbulence_tpu_torch.data.variables import Variable
from generative_turbulence_tpu_torch.eval import (
    MaxMeanTKEPositionMetric,
    SampleMetricsCollection,
    SampleStore,
    WassersteinMetric,
    WassersteinTKE,
    emd,
    emd2_uniform,
    wasserstein2,
)
from generative_turbulence_tpu_torch.eval import metrics as tmetrics
from generative_turbulence_tpu_torch.toolchain.h5_to_npyd import convert_file, convert_tree

METRIC_TOL = dict(rtol=1e-3)
UP = (Variable.U, Variable.P)


class TestEMD:
    def test_square_matches_assignment(self):
        from scipy.optimize import linear_sum_assignment

        M = np.random.default_rng(0).uniform(size=(6, 6))
        r, c = linear_sum_assignment(M)
        assert emd2_uniform(M, use_native=False) == pytest.approx(M[r, c].sum() / 6)

    def test_identity_zero(self):
        assert emd2_uniform(1.0 - np.eye(5), use_native=False) == pytest.approx(0.0)

    @pytest.mark.parametrize("use_native", [False, True], ids=["lp", "native"])
    def test_rectangular(self, use_native):
        # transport 2 sources to 4 sinks: cost 0 pairs exist for a perfect split
        M = np.array([[0.0, 0.0, 1.0, 1.0], [1.0, 1.0, 0.0, 0.0]])
        assert emd2_uniform(M, use_native=use_native) == pytest.approx(0.0)
        assert emd2_uniform(np.ones((2, 4)), use_native=use_native) == pytest.approx(1.0)
        M = np.random.default_rng(1).uniform(size=(5, 8))
        assert emd2_uniform(M, use_native=use_native) == pytest.approx(emd._transport_lp(M), rel=1e-9)

    def test_native_library_builds_outside_the_source_tree(self):
        assert emd._native_lib() is not None
        assert emd.NATIVE_LIBRARY.is_file() and emd.NATIVE_LIBRARY.parent.name == "native"
        assert emd.NATIVE_LIBRARY.parent.parent.name == "build"

    def test_wasserstein2(self):
        D = np.full((3, 3), 2.0)
        np.fill_diagonal(D, 0.0)
        assert wasserstein2(D, use_native=False) == pytest.approx(0.0)


@pytest.fixture(scope="module")
def val_case(synthetic_root):
    repo = CaseRepository(find_data_files(synthetic_root / "val"), UP)
    jrepo = JCaseRepository(j_find_data_files(synthetic_root / "val"), (JVariable.U, JVariable.P))
    stats = FieldStats.from_file(synthetic_root / "stats.pickle")
    jstats = JFieldStats.from_file(synthetic_root / "stats.pickle")
    return repo, jrepo, stats, jstats


@pytest.mark.parametrize("suffix", [".h5", ".npyd"])
def test_sample_store_round_trip_and_reset(val_case, tmp_path, suffix):
    repo = val_case[0]
    meta = repo.read_metadata(0)
    store = SampleStore(tmp_path / f"samples{suffix}", UP)
    assert store.case_names == []
    cells = np.random.default_rng(0).normal(size=(3, meta.n_cells, 4)).astype(np.float32)
    store.add_samples(cells[:2], meta)
    store.add_samples(cells[2:], meta)
    assert store.case_names == [meta.case_name] and store.n_samples(meta.case_name) == 3
    loaded = store.load_samples(meta)
    assert loaded.n_samples == 3
    np.testing.assert_array_equal(loaded.fields[Variable.U], cells[..., :3])
    np.testing.assert_array_equal(loaded.fields[Variable.P], cells[..., 3:])

    store.reset()
    assert store.n_samples(meta.case_name) == 0
    # Data is not deleted; appending after a reset overwrites it, and no
    # sample from before the reset comes back.
    store.add_samples(cells[2:], meta)
    store.add_samples(cells[:1], meta)
    assert store.n_samples(meta.case_name) == 2
    np.testing.assert_array_equal(store.load_samples(meta).fields[Variable.U], cells[[2, 0], :, :3])


def test_port_h5_store_reads_in_the_jax_store(val_case, tmp_path):
    repo, jrepo = val_case[:2]
    cells = np.random.default_rng(1).normal(size=(4, repo.read_metadata(0).n_cells, 4)).astype(np.float32)
    store = SampleStore(tmp_path / "samples.h5", UP)
    store.add_samples(cells[:3], repo.read_metadata(0))
    store.add_samples(cells[3:], repo.read_metadata(0))
    jstore = JSampleStore(tmp_path / "samples.h5", (JVariable.U, JVariable.P))
    jmeta = jrepo.read_metadata(0)
    assert jstore.case_names == [jmeta.case_name] and jstore.n_samples(jmeta.case_name) == 4
    loaded = jstore.load_samples(jmeta)
    np.testing.assert_array_equal(loaded.fields[JVariable.U], cells[..., :3])
    np.testing.assert_array_equal(loaded.fields[JVariable.P], cells[..., 3:])
    # ... and the JAX store's file, converted to .npyd, in the port's store.
    jstore.add_samples(cells[:1], jmeta)
    converted = SampleStore(convert_file(tmp_path / "samples.h5"), UP)
    assert converted.n_samples(jmeta.case_name) == 5
    np.testing.assert_array_equal(converted.load_samples(repo.read_metadata(0)).fields[Variable.U],
                                  np.concatenate([cells, cells[:1]])[..., :3])


def _frames(val_case, samples_idx, data_idx):
    repo, jrepo, stats, jstats = val_case
    return ((repo.read(0, samples_idx), repo.read(0, data_idx), stats),
            (jrepo.read(0, samples_idx), jrepo.read(0, data_idx), jstats))


def _assert_metric_close(got, want):
    assert sorted(got) == sorted(want) and got
    for name in want:
        np.testing.assert_allclose(got[name], float(want[name]), err_msg=name, **METRIC_TOL)


@pytest.mark.parametrize("quadrature", [dict(n_sphere=512, n_legendre=16), dict()], ids=["512-16", "5810-64"])
def test_wasserstein_tke_matches_jax(val_case, quadrature):
    port, jax_args = _frames(val_case, [2, 5, 8], [3, 6, 9])
    got = WassersteinTKE(device="cpu", **quadrature)(*port)
    _assert_metric_close(got, jmetrics.WassersteinTKE(**quadrature)(*jax_args))
    assert {"tke", "tke-middle", "tke-back"} <= set(got)  # 24 cells long: no front region


def test_wasserstein_tke_real_frames_beat_noise(val_case):
    (samples, data, stats), _ = _frames(val_case, [2, 5, 8], [3, 6, 9])
    metric = WassersteinTKE(n_sphere=512, n_legendre=16, device="cpu")
    real = metric(samples, data, stats)["tke"]
    for v in samples.fields:
        samples.fields[v] = (np.random.default_rng(0).normal(size=samples.fields[v].shape).astype(np.float32)
                             * np.abs(samples.fields[v]).mean())
    assert metric(samples, data, stats)["tke"] > real >= 0


@pytest.mark.parametrize("kw", [dict(), dict(max_regions=2)], ids=["exact", "exact-2-regions"])
def test_wasserstein_metric_matches_jax(val_case, kw):
    port, jax_args = _frames(val_case, [2, 5], [3, 6])
    got = WassersteinMetric(max_workers=1, device="cpu", **kw)(*port)
    _assert_metric_close(got, jmetrics.WassersteinMetric(max_workers=1, **kw)(*jax_args))


@pytest.fixture(scope="module")
def fine_regions_case(synthetic_root, tmp_path_factory, val_case):
    """The val case again, its cells cut into contiguous 128-cell regions."""
    case = tmp_path_factory.mktemp("fine") / "case-val-00"
    shutil.copytree(synthetic_root / "val" / "case-val-00", case)
    n_cells = val_case[0].read_metadata(0).n_cells
    np.savez(case / "regions.npz", assignments=np.arange(n_cells) // 128)
    return (CaseRepository([case / "data.h5"], UP), JCaseRepository([case / "data.h5"], (JVariable.U, JVariable.P)),
            *val_case[2:])


def test_wasserstein_metric_sinkhorn_matches_jax(fine_regions_case, monkeypatch):
    """Sinkhorn over 2 of the 128-cell regions.  The JAX metric pads its
    last chunk of regions to the chunk size (2^25 cost elements) to keep one
    compiled program; the padding changes no value, so here the JAX solver
    gets the 2 regions alone."""
    solver = jmetrics._masked_region_solver(reg=0.005, n_iters=300)
    monkeypatch.setattr(jmetrics, "_masked_region_solver",
                        lambda **kw: lambda s, d, mask: solver(s[:, :2], d[:, :2], mask[:2]))
    port, jax_args = _frames(fine_regions_case, [2, 5], [3, 6])
    kw = dict(solver="sinkhorn", max_regions=2, sinkhorn_iters=300)
    got = WassersteinMetric(device="cpu", **kw)(*port)
    _assert_metric_close(got, jmetrics.WassersteinMetric(**kw)(*jax_args))
    exact = WassersteinMetric(max_workers=1, max_regions=2, device="cpu")(*port)
    assert got["wasserstein"] == pytest.approx(exact["wasserstein"], rel=0.15)


def test_wasserstein_metric_features_match_jax(val_case):
    (data, _, stats), (jdata, _, jstats) = _frames(val_case, [2, 5], [3, 6])
    got = WassersteinMetric(device="cpu").features(data, stats).numpy()
    np.testing.assert_allclose(got, np.asarray(jmetrics.WassersteinMetric().features(jdata, jstats)),
                               rtol=2e-4, atol=2e-5)
    with pytest.raises(ValueError, match="solver"):
        WassersteinMetric(solver="greedy")


def test_max_mean_tke_position_matches_jax(val_case):
    port, jax_args = _frames(val_case, [2, 5, 8], [3, 6, 9])
    _assert_metric_close(MaxMeanTKEPositionMetric(device="cpu")(*port),
                         jmetrics.MaxMeanTKEPositionMetric()(*jax_args))


def _with_u(data, u):
    """``data`` (either package's ``CaseData``) with ``u`` as its velocity."""
    return dataclasses.replace(data, fields={**data.fields, next(v for v in data.fields if v.key == "u"): u})


@pytest.mark.parametrize("spread", [1e-4, 1e-2, 1.0], ids=["near-repeated", "small", "frames"])
def test_max_mean_tke_position_matches_jax_on_fluctuating_samples(val_case, spread):
    """Samples that fluctuate, even little (one frame plus ``spread`` times
    the differences to two others), get the JAX package's value."""
    port, jax_args = _frames(val_case, [2, 5, 8], [3, 6, 9])
    u = port[0].fields[Variable.U]
    u = (u[:1] + spread * (u - u[:1])).astype(np.float32)
    got = MaxMeanTKEPositionMetric(device="cpu")(_with_u(port[0], u), *port[1:])
    want = jmetrics.MaxMeanTKEPositionMetric()(_with_u(jax_args[0], u), *jax_args[1:])
    assert np.isfinite(got["max-mean-tke-pos"])
    _assert_metric_close(got, want)


def test_max_mean_tke_position_undefined_on_repeated_samples(val_case, synthetic_root, tmp_path):
    """One frame repeated: the TKE profile is 0 in exact arithmetic, so the
    port reports the metric as undefined (NaN) where the JAX package takes
    the argmax of rounding noise, and the collection's mean leaves that case
    out (a deviation from the JAX package)."""
    port, jax_args = _frames(val_case, [5, 5, 5, 5], [3, 6, 9])
    assert math.isnan(MaxMeanTKEPositionMetric(device="cpu")(*port)["max-mean-tke-pos"])
    assert np.isfinite(jmetrics.MaxMeanTKEPositionMetric()(*jax_args)["max-mean-tke-pos"])

    root = tmp_path / "root"
    for name in ("case-val-00", "case-val-01"):
        shutil.copytree(synthetic_root / "val" / "case-val-00", root / "val" / name)
    store = SampleStore(tmp_path / "samples.npyd", UP)
    meta = val_case[0].read_metadata(0)
    frames = val_case[0].read(0, [2, 5, 8, 11]).stacked_cells(UP)
    store.add_samples(frames[[1, 1, 1, 1]], dataclasses.replace(meta, file=root / "val" / "case-val-00" / "x"))
    store.add_samples(frames, dataclasses.replace(meta, file=root / "val" / "case-val-01" / "x"))
    got = SampleMetricsCollection("val", root / "val", [MaxMeanTKEPositionMetric("cpu")]).compute(store, val_case[2])
    assert math.isnan(got["val/case-val-00/max-mean-tke-pos"])
    assert np.isfinite(got["val/case-val-01/max-mean-tke-pos"])
    assert got["val/max-mean-tke-pos"] == got["val/case-val-01/max-mean-tke-pos"]


def _metrics(package, **kw):
    return [package.WassersteinTKE(n_sphere=512, n_legendre=16, **kw),
            package.WassersteinMetric(max_workers=1, **kw), package.MaxMeanTKEPositionMetric(**kw)]


@pytest.fixture(scope="module")
def jax_collection(val_case, synthetic_root, tmp_path_factory):
    """Frames 2, 5, 8, 11 of the val case as samples, and the JAX
    collection's values for them."""
    repo, jrepo, _, jstats = val_case
    frames = repo.read(0, [2, 5, 8, 11]).stacked_cells(UP)
    jstore = JSampleStore(tmp_path_factory.mktemp("jax") / "val-samples.h5", (JVariable.U, JVariable.P))
    jstore.add_samples(frames, jrepo.read_metadata(0))
    return frames, jmetrics.SampleMetricsCollection("val", synthetic_root / "val", _metrics(jmetrics)).compute(
        jstore, jstats)


@pytest.mark.parametrize("fmt", ["h5", "npyd"])
def test_collection_matches_jax(val_case, jax_collection, synthetic_root, tmp_path, fmt):
    """Store the same frames in both packages' stores and score them with
    every metric: the per-case and the averaged values agree."""
    repo, _, stats, _ = val_case
    frames, want = jax_collection
    root = synthetic_root
    if fmt == "npyd":
        root = tmp_path / "root"
        shutil.copytree(synthetic_root / "val", root / "val")
        convert_tree(root)
    store = SampleStore(tmp_path / f"val-samples.{fmt}", UP)
    store.add_samples(frames, repo.read_metadata(0))
    collection = SampleMetricsCollection("val", root / "val", _metrics(tmetrics, device="cpu"))
    got = collection.compute(store, stats)
    _assert_metric_close(got, want)
    assert {"val/tke", "val/wasserstein", "val/max-mean-tke-pos", "val/case-val-00/tke"} <= set(got)
    assert "val/wasserstein" not in collection.compute(store, stats, expensive_metrics=False)


def test_collection_raises_after_the_case_loop(val_case, tmp_path):
    store = SampleStore(tmp_path / "samples.npyd", UP)
    meta = val_case[0].read_metadata(0)
    store.add_samples(np.zeros((1, meta.n_cells, 4), np.float32), meta)
    collection = SampleMetricsCollection("val", tmp_path / "no-such-split", [MaxMeanTKEPositionMetric("cpu")])
    with pytest.raises(RuntimeError, match="FileNotFoundError"):
        collection.compute(store, val_case[2])
