"""The study entry points (``generative_turbulence_tpu_torch.scripts``:
profile_fwd, trivial_baselines, degenerate_baselines, calibrate_sinkhorn,
diagnose_trajectory, summarize_run, compare_runs and sweep) against the JAX
package's scripts on the same inputs, on the CPU at the tests' size (the
26x12x12 synthetic dataset; a 12x8x8 one for a port Trainer run).
``tke_profile`` is held against JAX in ``test_torch_scripts.py``, beside
the JAX task it reuses.

Tolerances: the mean forecast rtol 1e-5 and the smoothing rtol 1e-4 (f64
sums against numpy's f32 ones); the sample metrics rtol 1e-3 (``METRIC_TOL``
of ``test_torch_eval.py``, which also holds the Sinkhorn to it); the exact
EMD rtol 1e-5; the U-Net forward f32 rtol 2e-4 / atol 2e-5, bf16 rtol 0.06 /
atol 0.03 in units of the output's scale with corr > 0.999
(``test_torch_model.py``).  The host tools' JSON and markdown are equal.
"""

import json
import math
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from generative_turbulence_tpu.data import GridMap as JGridMap
from generative_turbulence_tpu.data import Variable as JVariable
from generative_turbulence_tpu.data.schema import read_metadata as j_read_metadata
from generative_turbulence_tpu.data.synthetic import generate_case as j_generate_case
from generative_turbulence_tpu.eval import metrics as jmetrics
from generative_turbulence_tpu.eval.sample_store import SampleStore as JSampleStore
from generative_turbulence_tpu.models import Conditioning as JConditioning
from generative_turbulence_tpu.models import DenoisingModel as JDenoisingModel
from generative_turbulence_tpu_torch.data.schema import CaseRepository, find_data_files
from generative_turbulence_tpu_torch.data.synthetic import generate_synthetic_dataset
from generative_turbulence_tpu_torch.data.variables import Variable
from generative_turbulence_tpu_torch.eval.sample_store import SampleStore
from generative_turbulence_tpu_torch.scripts import (
    calibrate_sinkhorn, compare_runs, degenerate_baselines, diagnose_trajectory, profile_fwd, summarize_run, sweep,
    tke_profile, trivial_baselines,
)
from generative_turbulence_tpu_torch.toolchain.from_flax import torch_state_dict_from_flax
from generative_turbulence_tpu_torch.toolchain.h5_to_npyd import convert_tree
from generative_turbulence_tpu_torch.train import main as train_main
from test_torch_scripts import METRIC_TOL, REPO, assert_metrics_close, jax_script

F32_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=0.06, atol=0.03)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads while this file runs: the suite runs files in
    parallel processes, where torch's default of one thread per core
    oversubscribes the host."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def run_jax(name, argv, monkeypatch):
    """The JAX script ``name`` run as from the command line with ``argv``."""
    module = jax_script(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *map(str, argv)])
    return module.main()


# ---- trivial_baselines -------------------------------------------------------------------


@pytest.mark.parametrize("sigma", [1.0, 3.0])
def test_trivial_baselines_match_jax(synthetic_root, sigma, monkeypatch, capsys):
    """At sigma 3 the radius (12 cells) reaches past the 12-cell y and z axes."""
    run_jax("trivial-baselines", [synthetic_root, "--sigma", sigma], monkeypatch)
    want = json.loads(capsys.readouterr().out)
    got = trivial_baselines.main([str(synthetic_root), "--sigma", str(sigma), "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == got
    assert got.keys() == want.keys() and got["per_case"].keys() == want["per_case"].keys()
    for part in ("summary", "per_case"):
        for baseline, rtol in (("mean-forecast", 1e-5), ("gaussian-smoothing", 1e-4)):
            g, w = got[part][baseline], want[part][baseline]
            assert g.keys() == w.keys() == {"u", "p"}
            for v in w:
                if part == "summary":
                    np.testing.assert_allclose(g[v], w[v], rtol=rtol, err_msg=f"{baseline}/{v}")
                else:
                    assert g[v].keys() == w[v].keys() == {"case-val-00"}
                    np.testing.assert_allclose(g[v]["case-val-00"], w[v]["case-val-00"], rtol=rtol)


@pytest.mark.parametrize("shape, sigma", [((2, 5, 7, 3, 2), 3.0), ((1, 13, 12, 9, 3), 1.0), ((2, 4, 1, 2, 1), 2.5),
                                          ((1, 9, 6, 11, 1), 0.6)])
def test_gaussian_smooth_matches_scipy(shape, sigma):
    """Odd and even axes, radii past the axis (12 cells over 5, 3 and 1):
    scipy's reflected extension, repeated."""
    a = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got = trivial_baselines.gaussian_smooth(torch.from_numpy(a), sigma)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), gaussian_filter(a, sigma=(0, sigma, sigma, sigma, 0)), rtol=1e-6,
                               atol=1e-7)


def test_reflect_index_is_scipys_extension():
    assert trivial_baselines.reflect_index(3, 4).tolist() == [2, 2, 1, 0, 0, 1, 2, 2, 1, 0, 0]
    assert trivial_baselines.reflect_index(1, 2).tolist() == [0] * 5


# ---- degenerate_baselines ----------------------------------------------------------------


def _recording(monkeypatch, store_class):
    """The samples each ``add_samples`` of ``store_class`` receives."""
    seen = []
    add = store_class.add_samples

    def record(self, cells, metadata):
        seen.append(np.array(cells))
        return add(self, cells, metadata)

    monkeypatch.setattr(store_class, "add_samples", record)
    return seen


def test_degenerate_baselines_match_jax(synthetic_root, tmp_path, monkeypatch, capsys):
    jseen = _recording(monkeypatch, JSampleStore)
    run_jax("degenerate-baselines", [synthetic_root, "--samples", 3, "--seed", 5, "--out", tmp_path / "jax.json"],
            monkeypatch)
    want = json.loads((tmp_path / "jax.json").read_text())
    seen = _recording(monkeypatch, SampleStore)
    got = degenerate_baselines.main([str(synthetic_root), "--samples", "3", "--seed", "5", "--out",
                                     str(tmp_path / "port.json"), "--device", "cpu"])
    assert "wrote" in capsys.readouterr().out
    written = json.loads((tmp_path / "port.json").read_text())
    assert list(got) == list(want) == ["mean", "noise", "cross-case"]
    # The mean baseline's samples are one flow repeated: the port reports its
    # max-mean-tke-pos as undefined (NaN, in the case and in the mean), where
    # the JAX script takes the argmax of rounding noise.
    undefined = [k for k in want["mean"] if k.endswith("max-mean-tke-pos")]
    assert undefined == ["mean/case-val-00/max-mean-tke-pos", "mean/max-mean-tke-pos"]
    for key in undefined:
        assert math.isnan(got["mean"].pop(key)) and math.isnan(written["mean"].pop(key))
        want["mean"].pop(key)
    assert written == got
    for name in want:
        assert {f"{name}/tke", f"{name}/max-mean-tke-pos"} <= set(got[name]) | set(undefined)
        assert_metrics_close(got[name], want[name], METRIC_TOL)
    assert len(seen) == len(jseen) == 3  # one case, three baselines
    for got_samples, want_samples in zip(seen, jseen):
        assert got_samples.dtype == want_samples.dtype == np.float32
        np.testing.assert_array_equal(got_samples, want_samples)


# ---- calibrate_sinkhorn -------------------------------------------------------------------


@pytest.fixture(scope="module")
def fine_regions_root(synthetic_root, tmp_path_factory):
    """The dataset's stats and val case, the case's cells cut into contiguous
    128-cell regions (4 of them cover 512 cells, as a shapes region holds)."""
    root = tmp_path_factory.mktemp("fine") / "root"
    (root / "val").mkdir(parents=True)
    shutil.copy(synthetic_root / "stats.pickle", root / "stats.pickle")
    case = root / "val" / "case-val-00"
    shutil.copytree(synthetic_root / "val" / "case-val-00", case)
    n_cells = len(CaseRepository([case / "data.h5"], (Variable.U,)).read_metadata(0).cell_idx)
    np.savez(case / "regions.npz", assignments=np.arange(n_cells) // 128)
    return root


CALIBRATION = ["--case", "val/case-val-00", "--max-regions", "4", "--samples", "2", "--workers", "1",
               "--sweep", "0.02:100,0.005:300"]


def test_calibrate_sinkhorn_matches_jax(fine_regions_root, tmp_path, monkeypatch):
    """The JAX metric pads its last chunk of regions to the chunk size (2^25
    cost elements) to keep one compiled program; the padding changes no
    value, so here the JAX solver gets the 4 regions alone (as in
    ``test_wasserstein_metric_sinkhorn_matches_jax``)."""
    solver = jmetrics._masked_region_solver
    monkeypatch.setattr(jmetrics, "_masked_region_solver",
                        lambda **kw: lambda s, d, mask, f=solver(**kw): f(s[:, :4], d[:, :4], mask[:4]))
    run_jax("calibrate-sinkhorn", [fine_regions_root, *CALIBRATION, "--out", tmp_path / "jax.json"], monkeypatch)
    want = json.loads((tmp_path / "jax.json").read_text())
    got = calibrate_sinkhorn.main([str(fine_regions_root), *CALIBRATION, "--out", str(tmp_path / "port.json"),
                                   "--device", "cpu"])
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert {k: got[k] for k in ("case", "samples", "max_regions")} == {
        k: want[k] for k in ("case", "samples", "max_regions")} == {"case": "val/case-val-00", "samples": 2,
                                                                    "max_regions": 4}
    np.testing.assert_allclose(got["exact"]["wasserstein"], want["exact"]["wasserstein"], rtol=1e-5)
    assert [(e["reg"], e["iters"]) for e in got["sinkhorn"]] == [(e["reg"], e["iters"]) for e in want["sinkhorn"]] \
        == [(0.02, 100), (0.005, 300)]
    for g, w in zip(got["sinkhorn"], want["sinkhorn"]):
        np.testing.assert_allclose(g["wasserstein"], w["wasserstein"], **METRIC_TOL)
        np.testing.assert_allclose(g["relative_error"], abs(g["wasserstein"] - got["exact"]["wasserstein"])
                                   / got["exact"]["wasserstein"], rtol=1e-12)
        assert g["seconds"] > 0


_WITHOUT_H5PY = """
import json, sys
sys.modules["matplotlib"] = None  # not installed, as on the card
from generative_turbulence_tpu_torch.scripts import calibrate_sinkhorn, tke_profile
root, store, out = sys.argv[1:4]
cal = calibrate_sinkhorn.main([root, "--case", "val/case-val-00", "--max-regions", "4", "--samples", "2",
                               "--workers", "1", "--out", out + "/cal.json", "--device", "cpu"])
tke = tke_profile.main([store, root + "/val", "--out", out + "/tke", "--device", "cpu"])
print(json.dumps({"cal": cal, "tke": tke, "h5py": "h5py" in sys.modules}))
"""


def test_study_scripts_on_a_npyd_dataset_without_h5py(fine_regions_root, tmp_path):
    """``calibrate_sinkhorn`` and ``tke_profile`` on a dataset of ``.npyd``
    files only, in a process where ``import h5py`` and ``import matplotlib``
    fail (the card's), give what they give on its ``.h5`` files; the plot is
    skipped with one line."""
    root = tmp_path / "npyd"
    shutil.copytree(fine_regions_root, root)
    convert_tree(root)
    for h5 in root.rglob("*.h5"):
        h5.unlink()
    repo = CaseRepository(find_data_files(root / "val"), (Variable.U, Variable.P))
    store = SampleStore(tmp_path / "frames.npyd", (Variable.U, Variable.P))
    store.add_samples(repo.read(0, [0, 2, 4]).stacked_cells((Variable.U, Variable.P)), repo.read_metadata(0))
    blocker = tmp_path / "noh5py"
    blocker.mkdir()
    (blocker / "h5py.py").write_text("raise ModuleNotFoundError(\"No module named 'h5py'\", name='h5py')\n")
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "HOME": os.environ.get("HOME", "/tmp"),
           "OMP_NUM_THREADS": "2", "PYTHONPATH": str(blocker)}
    res = subprocess.run([sys.executable, "-c", _WITHOUT_H5PY, str(root), str(tmp_path / "frames.npyd"),
                          str(tmp_path)], cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["h5py"] is False and "plot skipped: matplotlib is not installed" in res.stderr
    assert (tmp_path / "tke.json").is_file() and not (tmp_path / "tke.png").exists()
    want_cal = calibrate_sinkhorn.main([str(fine_regions_root), "--case", "val/case-val-00", "--max-regions", "4",
                                        "--samples", "2", "--workers", "1", "--out", str(tmp_path / "h5-cal.json"),
                                        "--device", "cpu"])
    assert got["cal"]["exact"]["wasserstein"] == want_cal["exact"]["wasserstein"]
    assert got["cal"]["sinkhorn"][0]["wasserstein"] == pytest.approx(want_cal["sinkhorn"][0]["wasserstein"],
                                                                      rel=1e-6)
    want_tke = tke_profile.main([str(tmp_path / "frames.npyd"), str(fine_regions_root / "val"), "--out",
                                 str(tmp_path / "h5-tke"), "--device", "cpu"])
    assert got["tke"] == json.loads(json.dumps(want_tke))


# ---- profile_fwd ---------------------------------------------------------------------------


PROFILE_CELLS = (12, 6, 6)  # padded 14x8x8


def _jax_model(dtype=None):
    return JDenoisingModel(out_features=4, timesteps=profile_fwd.TIMESTEPS, dim=8, u_net_levels=2,
                           conditioning=JConditioning(cell_type_embedding_dim=4)).clone(dtype=dtype)


@pytest.fixture(scope="module")
def jax_workload(tmp_path_factory):
    """The JAX script's grid at 14x8x8 (its ``generate_case``), and flax
    parameters of its model at dim 8, 2 levels (f32 parameters in either
    compute dtype)."""
    tmp = tmp_path_factory.mktemp("bench")
    jmeta = j_read_metadata(j_generate_case(tmp / "bench-case", cell_counts=PROFILE_CELLS, n_frames=1, seed=0))
    grid = JGridMap.from_metadata(jmeta, (JVariable.U, JVariable.P))
    x = np.zeros((1, *grid.shape, 4), np.float32)
    params = jax.jit(_jax_model().init)(jax.random.PRNGKey(0), x, np.zeros(1, np.int32), grid.cell_types)
    return grid, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_profile_fwd_workload_matches_jax(dtype, jax_workload):
    """``build_workload`` at 14x8x8, dim 8, 2 levels: its grid is the one the
    JAX script builds from its ``generate_case``, and its model with the
    flax parameters converted by ``from_flax`` computes JAX's
    ``model.apply`` on the same inputs."""
    tdtype, jdtype = (torch.float32, None) if dtype == "float32" else (torch.bfloat16, jnp.bfloat16)
    jgrid, params = jax_workload
    w = profile_fwd.build_workload(PROFILE_CELLS, dim=8, levels=2, batch=2, dtype=tdtype, device=torch.device("cpu"))
    assert w.grid.shape == tuple(jgrid.shape) == (14, 8, 8)
    cell_types = w.grid.cell_types.numpy()
    np.testing.assert_array_equal(cell_types, np.asarray(jgrid.cell_types))
    assert w.x.shape == (2, 14, 8, 8, 4) and w.t.tolist() == [0, 0]

    w.model.load_state_dict(torch_state_dict_from_flax(params))
    x, t = w.x.numpy(), np.zeros(2, np.int32)
    want = np.asarray(jax.jit(_jax_model(jdtype).apply)(params, x, t, cell_types))
    fn, n_unet = w.runner("fwd", 8)
    with torch.inference_mode():
        got = w.forward().float().numpy()
        value = fn()
    assert n_unet == 1 and value == pytest.approx(float(got[..., :1].sum()), rel=1e-6)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, **BF16_TOL)
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999


def test_profile_fwd_ddim_runner_repeats_its_draws():
    """The ddim runner: ``probe`` U-Net evaluations per call, the same draws
    (a generator seeded 1) every call, as the JAX script's fixed key."""
    w = profile_fwd.build_workload(PROFILE_CELLS, dim=8, levels=1, batch=1, dtype=torch.float32,
                                   device=torch.device("cpu"))
    calls = []
    forward = w.model.forward
    w.model.forward = lambda *a: calls.append(1) or forward(*a)
    fn, n_unet = w.runner("ddim", 3)
    with torch.inference_mode():
        first, second = fn(), fn()
    assert n_unet == 3 and len(calls) == 6 and first == second and np.isfinite(first)


@pytest.mark.parametrize("name, group", [
    ("void conv3x3x3_kernel<__nv_bfloat16, true, true, __nv_bfloat16>(ConvArgs)", "chain convs"),
    ("void affine_silu_kernel<__nv_bfloat16>(float const*, float const*, long)", "affine_silu"),
    ("void flash_attn_bf16_kernel<32>(FlashArgs)", "flash_attention"),
    ("void flash_attn_f32_kernel<64>(FlashArgs)", "flash_attention"),
    ("void at::native::(anonymous namespace)::upsample_trilinear3d_out_frame<c10::BFloat16, float>(...)",
     "upsample_trilinear3d"),
    ("void at::native::(anonymous namespace)::replication_pad_forward_kernel3d<c10::BFloat16>(...)",
     "replicate pad"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_ndhwc_kndhwc_tilesize128x64x64", "cuDNN/CUTLASS convs and GEMMs"),
    ("nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_TNN", "cuDNN/CUTLASS convs and GEMMs"),
    ("void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16_16x16_128x2_tn_align8>(...)",
     "cuDNN/CUTLASS convs and GEMMs"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, ...>(...)",
     profile_fwd.OTHER),
    ("void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<float, float>(...)", profile_fwd.OTHER),
])
def test_categorize_groups_the_ports_kernels(name, group):
    assert profile_fwd.categorize(name) == group


def test_kernel_table_adds_up():
    """Categories and top events from device events (ms per evaluation over
    ``n_unet`` evaluations); the categories sum to ``total_ms``."""
    ev = lambda name, start, end: SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end))  # noqa
    events = [ev("void conv3x3x3_kernel<1>", 0, 3000), ev("void conv3x3x3_kernel<2>", 3000, 4000),
              ev("void affine_silu_kernel<f>", 4000, 4500), ev("elementwise", 5000, 5500)]
    table = profile_fwd.kernel_table(events, n_unet=2)
    assert table["total_ms"] == pytest.approx(5.0)
    assert [(c["category"], c["ms_per_eval"], c["pct"]) for c in table["categories"]] == [
        ("chain convs", 2.0, 80.0), ("affine_silu", 0.25, 10.0), (profile_fwd.OTHER, 0.25, 10.0)]
    assert sum(c["ms_per_eval"] for c in table["categories"]) * 2 == pytest.approx(table["total_ms"])
    assert [e["name"] for e in table["top_events"]][0] == "void conv3x3x3_kernel<1>"
    summary = profile_fwd.device_summary(events, wall=6.0, n=1)
    assert summary["busy_ms"] == pytest.approx(5.0) and summary["idle_share"] == pytest.approx(1 / 6)
    assert summary["kernel_ms"]["chain convs"] == pytest.approx(4.0)


# ---- the host tools on a run of the port's Trainer -------------------------------------------


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A run directory of the port's Trainer: 3 epochs of 2 steps, a
    validation after each, every step logged."""
    tmp = tmp_path_factory.mktemp("run")
    root = generate_synthetic_dataset(tmp / "data", n_train_cases=1, n_val_cases=1, n_test_cases=0, n_frames=8,
                                      cell_counts=(10, 6, 6), seed=2, format="npyd")
    train_main(["--device", "cpu", "model=diffusion", f"data.root={root}", "data.discard_first_seconds=-1",
                "data.val_samples=2", "data.eval_batch_size=2", "model.batch_size=4", "model.dim=8",
                "model.u_net_levels=1", "model.timesteps=4", "model.sampler=ddim", "model.ddim_steps=2",
                f"trainer.out_dir={tmp / 'run'}", "trainer.max_epochs=3", "trainer.check_val_every_n_epoch=1",
                "trainer.render_plots=false", "model.compute_expensive_sample_metrics=false",
                "trainer.log_every_n_steps=1"])
    return tmp / "run"


def test_diagnose_trajectory_matches_jax(port_run, tmp_path, monkeypatch):
    run_jax("diagnose-trajectory", [port_run, "--out", tmp_path / "jax" / "trajectory"], monkeypatch)
    got = diagnose_trajectory.main([str(port_run), "--out", str(tmp_path / "port" / "trajectory")])
    text = (tmp_path / "port" / "trajectory.json").read_text()
    assert text == (tmp_path / "jax" / "trajectory.json").read_text() and json.loads(text) == got
    assert len(got["validations"]) == 3 and [t["step"] for t in got["train"]] == [1, 2, 3, 4, 5, 6]
    assert {"val/eps-loss-t0", "val/eps-loss-t3", "val/sample-u-std"} <= set(got["validations"][0])
    assert set(got["verdict"]) == {"val_eps_loss_slope_2nd_half", "train_loss_slope_2nd_half", "val_tke_best_step",
                                   "val_tke_last_over_best", "overfitting_signature"}
    assert np.isfinite(got["verdict"]["train_loss_slope_2nd_half"])
    assert (tmp_path / "port" / "trajectory.png").is_file()


def test_diagnose_trajectory_without_matplotlib(port_run, tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # find_spec gives None, import fails
    diagnose_trajectory.main([str(port_run), "--out", str(tmp_path / "trajectory")])
    assert "plot skipped: matplotlib is not installed" in capsys.readouterr().err
    assert (tmp_path / "trajectory.json").is_file() and not (tmp_path / "trajectory.png").exists()


def _without_run_dir(value):
    if isinstance(value, dict):
        return {k: _without_run_dir(v) for k, v in value.items() if k != "run_dir"}
    if isinstance(value, list):
        return [_without_run_dir(v) for v in value]
    return value


def test_summarize_and_compare_runs_match_jax(port_run, tmp_path, monkeypatch, capsys):
    """summarize_run of the port's run, then compare_runs over it under
    three names with a degenerate-baselines file: the JAX scripts' files."""
    run_jax("summarize-run", [port_run, tmp_path / "jax" / "summary"], monkeypatch)
    summarize_run.main([str(port_run), str(tmp_path / "port" / "summary")])
    want = json.loads((tmp_path / "jax" / "summary" / "summary.json").read_text())
    got = json.loads((tmp_path / "port" / "summary" / "summary.json").read_text())
    assert _without_run_dir(got) == _without_run_dir(want)
    assert len(got["trajectory"]) == 3 and got["n_train_steps"] == 6 and got["config"]["model"]["dim"] == 8
    assert (tmp_path / "port" / "summary" / "metrics.jsonl").read_text() == (port_run / "metrics.jsonl").read_text()

    baselines = tmp_path / "degenerate-baselines.json"
    baselines.write_text(json.dumps({"mean": {"mean/tke": 12.5, "mean/case-val-00/tke": 12.5},
                                     "noise": {"noise/tke": 3.25}, "note": "not a sampler"}))
    args = {side: [*(f"{name}={tmp_path / side / 'summary'}" for name in ("diffusion", "tfnet", "dilresnet")),
                   "--out", str(tmp_path / side / "comparison"), "--baselines", str(baselines)]
            for side in ("jax", "port")}
    run_jax("compare-runs", args["jax"], monkeypatch)
    result = compare_runs.main(args["port"])
    assert "(3 models)" in capsys.readouterr().out
    want = json.loads((tmp_path / "jax" / "comparison.json").read_text())
    assert _without_run_dir(result) == _without_run_dir(want)
    assert [r["model"] for r in result["models"]] == ["diffusion", "tfnet", "dilresnet"]
    assert result["degenerate_baselines_mean_val_tke"] == {"mean": 12.5, "noise": 3.25}
    assert (tmp_path / "port" / "comparison.md").read_text() == (tmp_path / "jax" / "comparison.md").read_text()


# ---- sweep -----------------------------------------------------------------------------------


SWEEP_ARGS = ["--sweep", "model=diffusion,tfnet", "--sweep", "data.stride=1,4",
              "--derive", "model.eval_unroll_steps=max(int(100/{data.stride}),1)"]


def test_sweep_runs_the_same_overrides_as_jax(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: calls.append((list(cmd), kw)))
    run_jax("sweep", [*SWEEP_ARGS, "--out", tmp_path / "sweep", "--", "data.root=data/shapes"], monkeypatch)
    jax_runs = [cmd[2:] for cmd, _ in calls]
    assert all(cmd[1] == str(REPO / "scripts/train.py") for cmd, _ in calls)
    calls.clear()
    runs = sweep.main([*SWEEP_ARGS, "--out", str(tmp_path / "sweep"), "--device", "cpu", "--", "data.root=data/shapes"])
    prefix = [sys.executable, "-m", "generative_turbulence_tpu_torch.train", "--device", "cpu"]
    assert [cmd[:5] for cmd, _ in calls] == [prefix] * 4
    assert [cmd[5:] for cmd, _ in calls] == runs == jax_runs
    assert runs[1] == ["model=diffusion", "data.stride=4", "model.eval_unroll_steps=25", "data.root=data/shapes",
                       f"trainer.out_dir={tmp_path / 'sweep' / 'diffusion-4'}"]
    for _, kw in calls:
        assert kw["check"] is True and kw["env"]["PYTHONPATH"].split(os.pathsep)[0] == str(REPO)
        assert "cwd" not in kw  # relative paths in the overrides keep their meaning


def test_sweep_slurm_writes_the_same_array_as_jax(tmp_path, monkeypatch, capsys):
    """Without ``sbatch`` on the path both write their files and say so."""
    monkeypatch.setenv("PATH", str(tmp_path))
    run_jax("sweep", ["--slurm", *SWEEP_ARGS, "--partition", "gpu", "--out", tmp_path / "jax"], monkeypatch)
    sweep.main(["--slurm", *SWEEP_ARGS, "--partition", "gpu", "--out", str(tmp_path / "port")])
    printed = capsys.readouterr().out
    assert printed.count("sbatch not available here; submit the file on the cluster") == 2
    assert "wrote" in printed and "(4 runs)" in printed
    jax_lines = (tmp_path / "jax" / "sweep-cmds.txt").read_text().splitlines()
    lines = (tmp_path / "port" / "sweep-cmds.txt").read_text().splitlines()
    head = f"PYTHONPATH={REPO}${{PYTHONPATH:+:$PYTHONPATH}} {sys.executable} -m generative_turbulence_tpu_torch.train " \
           "--device cuda "
    assert len(lines) == len(jax_lines) == 4 and all(line.startswith(head) for line in lines)
    jax_head = f"{sys.executable} {REPO / 'scripts/train.py'} "
    assert [line[len(head):].replace(str(tmp_path / "port"), "OUT") for line in lines] == \
        [line[len(jax_head):].replace(str(tmp_path / "jax"), "OUT") for line in jax_lines]
    script = (tmp_path / "port" / "sweep.sbatch").read_text()
    assert script == (tmp_path / "jax" / "sweep.sbatch").read_text().replace(str((tmp_path / "jax").resolve()),
                                                                             str((tmp_path / "port").resolve()))
    assert "#SBATCH --array=1-4" in script and "#SBATCH --partition=gpu" in script
