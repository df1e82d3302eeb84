"""The evaluation entry points (``generative_turbulence_tpu_torch.scripts``)
against the JAX package's scripts, on the CPU at the tests' size (the
26x12x12 synthetic dataset, dim 8, 2 U-Net levels, T = 20, DDIM-4, val
batches of 2; DilResNet with N 2 and 8 channels).

The JAX scripts read Orbax checkpoints, so the JAX side runs what each
script runs on the same flax parameters: ``task.sample`` per val batch
with ``fold_in(PRNGKey(seed + 1), i)`` (``eval_ckpt``), and the noised
``unroll_samples`` (``evaluate-from-initial``); the port runs its entry
points on a port checkpoint directory holding those parameters, with JAX's
draws replayed through ``noise_factory``.  Tolerances: samples rtol 1e-3 /
atol 1e-4 of their scale (``test_torch_task.py``), metrics rtol 1e-3
(``test_torch_eval_task.py``), the metric floor of real frames rtol 1e-5.
"""

import dataclasses
import functools
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_turbulence_tpu.data import dataset as jdataset
from generative_turbulence_tpu.data import sequence as jsequence
from generative_turbulence_tpu.eval.metrics import SampleMetricsCollection as JCollection
from generative_turbulence_tpu.eval.sample_store import SampleStore as JSampleStore
from generative_turbulence_tpu.training import config as jconfig
from generative_turbulence_tpu.training import regression_task as jregression
from generative_turbulence_tpu.training.diffusion_task import DiffusionTask as JDiffusionTask
from generative_turbulence_tpu_torch.data.schema import FieldStats, read_metadata
from generative_turbulence_tpu_torch.data.variables import Variable
from generative_turbulence_tpu_torch.diffusion.schedules import beta_schedule
from generative_turbulence_tpu_torch.eval.sample_store import SampleStore
from generative_turbulence_tpu_torch.scripts import (
    calibrate_sinkhorn, degenerate_baselines, eval_ckpt, evaluate_dataset, evaluate_from_initial, evaluate_runtime,
    evaluate_with_precision, import_checkpoint, profile_fwd, sample_metrics, sampler_sweep, tke_profile,
    trivial_baselines,
)
from generative_turbulence_tpu_torch.toolchain.from_flax import torch_state_dict_from_flax
from generative_turbulence_tpu_torch.toolchain.h5_to_npyd import convert_file, convert_tree
from generative_turbulence_tpu_torch.toolchain.import_ckpt import to_reference_state_dict
from generative_turbulence_tpu_torch.training import config as tconfig
from generative_turbulence_tpu_torch.training.checkpoint import CheckpointManager
from generative_turbulence_tpu_torch.training.factory import instantiate_data_and_task
from test_torch_diffusion import Replay, jax_normals
from test_torch_regression import _jax_state, flax_variables

REPO = Path(__file__).resolve().parents[1]
VARIABLES = (Variable.U, Variable.P)
METRIC_TOL = dict(rtol=1e-3)
MODEL = ["model.dim=8", "model.u_net_levels=2", "model.timesteps=20", "model.sampler=ddim", "model.ddim_steps=4"]
EVAL_DATA = ["data.discard_first_seconds=-1", "data.val_samples=2", "data.eval_batch_size=2", "model.batch_size=2"]
DILRESNET = ["model=dilresnet", "model.N=2", "model.hidden_dim=8", "model.eval_unroll_steps=4",
             "model.sample_steps=[4]", "model.main_sample_step=4"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads while this file runs: the suite runs files in
    parallel processes, where torch's default of one thread per core
    oversubscribes the host."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def jax_script(name):
    """A script of ``scripts/``, loaded by its path (its ``_common`` beside it)."""
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        spec = importlib.util.spec_from_file_location(f"jax_{name.replace('-', '_')}", REPO / "scripts" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(str(REPO / "scripts"))
    return module


def write_checkpoint(directory, config, task):
    """A port checkpoint directory of ``task``'s state, as the Trainer writes it."""
    mgr = CheckpointManager(directory, config.to_json())
    mgr.save_last(task.state_dict(), step=0)
    mgr.save_best(task.state_dict(), step=0, value=1.0)
    return directory


class JaxSampleDraws:
    """``noise_factory`` replaying the draws of JAX's ``task.sample`` with
    ``fold_in(PRNGKey(seed), i)`` for batch i."""

    def __init__(self, seed, shape, cfg):
        self.key, self.shape, self.cfg = jax.random.PRNGKey(seed), shape, cfg

    def __call__(self, kind, i):
        assert kind == "sample"
        return Replay(jax_normals(jax.random.fold_in(self.key, i), self.shape, self.cfg.ddim_steps, self.cfg.noise_bcs))


def stored(store_file, case):
    """{variable key: samples} of one case of a store (.h5 or .npyd)."""
    data = SampleStore(store_file, VARIABLES).load_samples(read_metadata(Path(case)))
    return {v.key: values for v, values in data.fields.items()}


def assert_samples_close(got, want):
    assert got.keys() == want.keys()
    for key in want:
        scale = np.abs(want[key]).max()
        np.testing.assert_allclose(got[key] / scale, want[key] / scale, rtol=1e-3, atol=1e-4, err_msg=key)


def assert_metrics_close(got, want, tol=METRIC_TOL):
    assert sorted(got) == sorted(want)
    for key in want:
        assert np.isfinite(got[key]), key
        np.testing.assert_allclose(got[key], want[key], **tol, err_msg=key)


# ---- eval_ckpt, sample_metrics and import_checkpoint against JAX ---------------------


@pytest.fixture(scope="module")
def diffusion(synthetic_root, tmp_path_factory):
    """The JAX side of ``eval_ckpt`` (samples in an .h5 store and the cheap
    metrics), and a port checkpoint directory with the same parameters."""
    tmp = tmp_path_factory.mktemp("scripts")
    args = ["model=diffusion", f"data.root={synthetic_root}", *EVAL_DATA, *MODEL, f"trainer.out_dir={tmp / 'run'}"]
    jcfg = jconfig.parse_cli_overrides(args).resolved()
    jdm = jdataset.DataModule(synthetic_root, cell_bucket=0, buffer_pool=False, device_prefetch=False,
                              eval_batch_size=2, val_samples=2, discard_first_seconds=-1.0)
    jdm.setup("validate")
    jtask = JDiffusionTask(jcfg.model, jdm.stats, synthetic_root, tmp / "jax-samples")
    batches = list(jdm.val_batches())
    x0 = jnp.zeros((1, *batches[0].grid.shape, 4))
    params = jax.jit(jtask.net.init)(jax.random.PRNGKey(0), x0, jnp.zeros((1,), jnp.int32),
                                     batches[0].grid.cell_types)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = SimpleNamespace(params=params, ema_params=None)
    jstore = JSampleStore(tmp / "jax-samples.h5", jtask.variables)
    rng = jax.random.PRNGKey(jcfg.trainer.seed + 1)
    for i, batch in enumerate(batches):
        jstore.add_samples(jtask.sample(state, batch, jax.random.fold_in(rng, i)), batch.metadata)
    collection = JCollection("val", synthetic_root / "val", JCollection.default_metrics())
    jmetrics = collection.compute(jstore, jdm.stats, expensive_metrics=False)

    tcfg = tconfig.parse_cli_overrides(args).resolved()
    _, task = instantiate_data_and_task(tcfg, "cpu")
    task.load_flax_params(params)
    ckpt_dir = write_checkpoint(tmp / "run" / "checkpoints", tcfg, task)
    draws = JaxSampleDraws(tcfg.trainer.seed + 1, (2, *batches[0].grid.shape, 4), tcfg.model)
    metrics = eval_ckpt.main([str(ckpt_dir), str(tmp / "port-samples.npyd"), "--device", "cpu"], noise_factory=draws)
    return SimpleNamespace(root=synthetic_root, tmp=tmp, args=args, params=params, jstore=tmp / "jax-samples.h5",
                           jmetrics=jmetrics, ckpt_dir=ckpt_dir, store=tmp / "port-samples.npyd", metrics=metrics,
                           draws=draws, case=batches[0].metadata.file, stats=FieldStats.from_file(
                               synthetic_root / "stats.pickle"))


def test_eval_ckpt_samples_match_jax(diffusion):
    store = SampleStore(diffusion.store, VARIABLES)
    assert store.case_names == ["case-val-00"] and store.n_samples("case-val-00") == 2
    assert_samples_close(stored(diffusion.store, diffusion.case), stored(diffusion.jstore, diffusion.case))


def test_eval_ckpt_metrics_match_jax(diffusion):
    assert {"val/tke", "val/tke-back", "val/max-mean-tke-pos"} <= set(diffusion.metrics)
    assert_metrics_close(diffusion.metrics, diffusion.jmetrics)


@pytest.mark.parametrize("fmt", ["h5", "npyd"])
def test_sample_metrics_on_a_jax_store(diffusion, fmt, tmp_path):
    """A store the JAX package wrote, as it is and converted to .npyd: the
    same numbers from both, JAX's collection's within the metric
    tolerance."""
    store = diffusion.jstore if fmt == "h5" else convert_file(diffusion.jstore, tmp_path / "jax-samples.npyd")
    got = sample_metrics.main([str(store), str(diffusion.root / "val"), "--prefix", "val", "--device", "cpu"])
    assert_metrics_close(got, diffusion.jmetrics)
    if fmt == "npyd":
        h5 = sample_metrics.main([str(diffusion.jstore), str(diffusion.root / "val"), "--prefix", "val",
                                  "--device", "cpu"])
        assert got == h5


def test_sample_metrics_of_eval_ckpt_store(diffusion):
    got = sample_metrics.main([str(diffusion.store), str(diffusion.root / "val"), "--prefix", "val",
                               "--device", "cpu"])
    assert got == diffusion.metrics


def test_import_checkpoint_then_eval_ckpt(diffusion, tmp_path, capsys):
    """A Lightning-style ``turbdiff.ckpt`` of the same parameters under the
    reference's keys, imported and evaluated end to end: the imported
    tensors and the schedule are the source's, and ``eval_ckpt`` on the
    imported directory gives what it gave on the source's."""
    cfg = tconfig.parse_cli_overrides(diffusion.args).resolved().model
    source = torch_state_dict_from_flax(diffusion.params)
    state_dict = to_reference_state_dict(source, cfg.u_net_levels)
    state_dict["model.betas"] = torch.from_numpy(beta_schedule(cfg.beta_schedule, cfg.timesteps))
    hparams = {"dim": cfg.dim, "timesteps": cfg.timesteps, "beta_schedule": cfg.beta_schedule, "norm_type": "group",
               "cell_type_embedding_dim": cfg.cell_type_embedding_dim, "variables": ("U", "P")}
    torch.save({"state_dict": state_dict, "hyper_parameters": hparams}, tmp_path / "turbdiff.ckpt")

    out = tmp_path / "imported"
    user = [f"data.root={diffusion.root}", *EVAL_DATA, "model.u_net_levels=2", "model.sampler=ddim",
            "model.ddim_steps=4", f"trainer.out_dir={tmp_path / 'run'}"]
    result = import_checkpoint.main([str(tmp_path / "turbdiff.ckpt"), str(out), "--device", "cpu", *user])
    printed = capsys.readouterr().out
    assert "schedule check: max |betas_ours - betas_ckpt| = 0.000e+00" in printed and "imported" in printed
    assert result["max_abs_betas_diff"] == 0.0
    assert {p.name for p in out.iterdir()} == {"last.pt", "best.pt", "config.json", "index.json"}
    restored = CheckpointManager(out).restore("best")["net"]
    assert restored.keys() == source.keys()
    assert all(torch.equal(restored[k], source[k]) for k in source)

    metrics = eval_ckpt.main([str(out), str(tmp_path / "samples.npyd"), "--device", "cpu"],
                             noise_factory=diffusion.draws)
    assert metrics == diffusion.metrics
    for key, values in stored(tmp_path / "samples.npyd", diffusion.case).items():
        np.testing.assert_array_equal(values, stored(diffusion.store, diffusion.case)[key])


def test_import_checkpoint_copies_the_parameters_into_the_ema(diffusion, tmp_path):
    cfg = tconfig.parse_cli_overrides(diffusion.args).resolved().model
    source = torch_state_dict_from_flax(diffusion.params)
    torch.save({"state_dict": to_reference_state_dict(source, 2), "hyper_parameters": {"dim": 8, "timesteps": 20}},
               tmp_path / "turbdiff.ckpt")
    import_checkpoint.main([str(tmp_path / "turbdiff.ckpt"), str(tmp_path / "out"), "--device", "cpu",
                            f"data.root={diffusion.root}", "model.u_net_levels=2", "model.ema_decay=0.999"])
    state = CheckpointManager(tmp_path / "out").restore("last")
    assert cfg.ema_decay == 0 and state["step"] == 0
    assert state["ema"].keys() == source.keys() and all(torch.equal(state["ema"][k], source[k]) for k in source)


@pytest.fixture(scope="module")
def npyd_root(synthetic_root, tmp_path_factory):
    """The synthetic dataset converted to .npyd (beside its .h5 files)."""
    root = tmp_path_factory.mktemp("npyd") / "root"
    shutil.copytree(synthetic_root, root)
    convert_tree(root)
    return root


def test_eval_ckpt_refuses_an_h5_store_without_h5py(diffusion, npyd_root, tmp_path, monkeypatch):
    """Where ``h5py`` does not import, an ``.h5`` store stops the run on a
    .npyd dataset with one message that names ``.npyd``, before any batch
    is sampled."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ModuleNotFoundError, match=r"name a \.npyd store instead"):
        eval_ckpt.main([str(diffusion.ckpt_dir), str(tmp_path / "samples.h5"), f"data.root={npyd_root}",
                        "--device", "cpu"], noise_factory=lambda *key: pytest.fail("sampled"))


# ---- the other entry points on that checkpoint --------------------------------------


def test_evaluate_runtime(diffusion, capsys):
    result = evaluate_runtime.main([str(diffusion.ckpt_dir), "--repeats", "2", "--device", "cpu"])
    assert list(result["per_case"]) == ["case-val-00"]
    assert result["sample_time"] == result["per_case"]["case-val-00"] > 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == result


def test_evaluate_with_precision_restores_tf32(diffusion, monkeypatch):
    """Each precision sets the TF32 switches while its task samples, and the
    switches are as they were afterwards; on the CPU, where TF32 does not
    exist, every precision gives the same metrics."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    seen = []
    load = evaluate_with_precision.load_task_from_checkpoint

    def recording(*args, **kwargs):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return load(*args, **kwargs)

    monkeypatch.setattr(evaluate_with_precision, "load_task_from_checkpoint", recording)
    results = evaluate_with_precision.main([str(diffusion.ckpt_dir), "model.ddim_steps=2", "--device", "cpu"])
    assert seen == [(True, False), (True, True), (False, False)]
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (True, False)
    assert list(results) == ["default", "high", "highest"]
    assert np.isfinite(results["default"]["val/tke"]) and results["default"] == results["high"] == results["highest"]


def test_evaluate_with_precision_restores_tf32_after_a_failure(diffusion, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with pytest.raises(FileNotFoundError):
        evaluate_with_precision.main([str(diffusion.tmp / "missing"), "--precisions", "high", "--device", "cpu"])
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (False, True)


def test_sampler_sweep_default_configs():
    assert [c["name"] for c in sampler_sweep.DEFAULT_CONFIGS] == [
        "ddim50-bf16", "ddim50-bf16-clip", "ddim50-f32", "ddim50-f32-clip", "ddpm500-bf16", "ddpm500-f32-clip"]


def test_sampler_sweep_runs(diffusion, tmp_path):
    """Two configurations, the expensive pass asked of one but bounded to 0
    cases: a record each, finite, with the fluctuation diagnostics and no
    Wasserstein."""
    configs = [{"name": "ddim2", "overrides": ["model.ddim_steps=2"]},
               {"name": "ddim2-clip", "overrides": ["model.ddim_steps=2", "model.clip_denoised=true"]}]
    (tmp_path / "configs.json").write_text(json.dumps(configs))
    records = sampler_sweep.main([str(diffusion.ckpt_dir), "--configs", str(tmp_path / "configs.json"),
                                  "--expensive-config", "ddim2", "--expensive-cases", "0",
                                  "--out", str(tmp_path / "out.json"), "--device", "cpu"])
    assert [r["name"] for r in records] == ["ddim2", "ddim2-clip"]
    assert json.loads((tmp_path / "out.json").read_text()) == records
    for record in records:
        assert {"val/tke", "fluct-ratio-back", "mean-err-rms"} <= set(record) and "val/wasserstein" not in record
        assert all(np.isfinite(v) for k, v in record.items() if k not in ("name", "which"))
    assert (diffusion.tmp / "run" / "sweep-ddim2.npyd").is_dir()


@pytest.mark.parametrize("k_cases, n_cases", [(0, 0), (1, 1), (None, 1)])
def test_expensive_pass_takes_the_first_k_cases(diffusion, k_cases, n_cases, monkeypatch):
    """``--expensive-cases 0`` evaluates no case (the JAX script's
    ``[:k or None]`` took all).  The Sinkhorn over one region for 100
    iterations: the cases taken, not the values, are under test."""
    monkeypatch.setattr(sampler_sweep, "WassersteinMetric",
                        functools.partial(sampler_sweep.WassersteinMetric, max_regions=1, sinkhorn_iters=100))
    store = SampleStore(diffusion.store, VARIABLES)
    out = sampler_sweep.expensive_pass(store, diffusion.stats, diffusion.root, k_cases, device="cpu")
    assert out.get("val/wasserstein-cases", 0.0) == n_cases
    if n_cases:
        assert np.isfinite(out["val/wasserstein"]) and out["val/wasserstein"] >= 0


def test_expensive_pass_skips_a_case_without_samples(diffusion, tmp_path):
    """A case whose store holds no samples is skipped (the JAX script read
    0 frames and failed in the metric)."""
    shutil.copytree(diffusion.store, tmp_path / "store.npyd")
    store = SampleStore(tmp_path / "store.npyd", VARIABLES)
    store.reset()
    assert store.case_names == ["case-val-00"] and store.n_samples("case-val-00") == 0
    assert sampler_sweep.expensive_pass(store, diffusion.stats, diffusion.root, device="cpu") == {}


_FLUCT = """
import json, sys
from generative_turbulence_tpu_torch.scripts.sampler_sweep import fluct_diagnostics
print(json.dumps(fluct_diagnostics(sys.argv[1], sys.argv[2])))
"""


def test_fluct_diagnostics_without_h5py_match_jax(diffusion, npyd_root, tmp_path):
    """The port's ``fluct_diagnostics`` on the .npyd conversions of the
    store and of the dataset, in a process where ``import h5py`` fails,
    against the JAX script's on the .h5 files."""
    want = jax_script("sampler-sweep").fluct_diagnostics(diffusion.jstore, diffusion.root)
    store = convert_file(diffusion.jstore, tmp_path / "samples.npyd")
    blocker = tmp_path / "noh5py"
    blocker.mkdir()
    (blocker / "h5py.py").write_text("raise ModuleNotFoundError(\"No module named 'h5py'\", name='h5py')\n")
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "HOME": os.environ.get("HOME", "/tmp"),
           "OMP_NUM_THREADS": "2", "PYTHONPATH": str(blocker)}
    res = subprocess.run([sys.executable, "-c", _FLUCT, str(store), str(npyd_root)], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout)
    assert sorted(got) == sorted(want) and "fluct-ratio-back" in got
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)


@pytest.mark.parametrize("fmt", ["h5", "npyd"])
def test_tke_profile_matches_jax(diffusion, fmt, tmp_path, monkeypatch):
    """The JAX script on its own ``.h5`` store, and the port on that store
    and on its ``.npyd`` conversion: the profiles at rtol 1e-5, the same
    argmaxes (past cell 24) and ``gt_pos``, and a JSON file each."""
    monkeypatch.setattr(sys, "argv", ["tke-profile.py", str(diffusion.jstore), str(diffusion.root / "val"),
                                      "--out", str(tmp_path / "jax" / "profile"), "--n-data", "4"])
    jax_script("tke-profile").main()
    want = json.loads((tmp_path / "jax" / "profile.json").read_text())
    store = diffusion.jstore if fmt == "h5" else convert_file(diffusion.jstore, tmp_path / "jax-samples.npyd")
    got = tke_profile.main([str(store), str(diffusion.root / "val"), "--out", str(tmp_path / "port" / "profile"),
                            "--n-data", "4", "--device", "cpu"])
    assert json.loads((tmp_path / "port" / "profile.json").read_text()) == got
    assert list(got) == list(want) == ["case-val-00"]
    for case, w in want.items():
        g = got[case]
        assert len(g["samples"]) == len(g["data"]) == 26
        np.testing.assert_allclose(g["samples"], w["samples"], rtol=1e-5)
        np.testing.assert_allclose(g["data"], w["data"], rtol=1e-5)
        assert (g["argmax_samples"], g["argmax_data"], g["gt_pos"]) == (w["argmax_samples"], w["argmax_data"],
                                                                        w["gt_pos"])
        assert g["argmax_samples"] >= 24 and g["gt_pos"] is not None


# ---- evaluate_dataset and evaluate_from_initial against JAX ----------------------------


def test_evaluate_dataset_matches_jax(synthetic_root, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["evaluate-dataset.py", str(synthetic_root), "--samples", "3"])
    jax_script("evaluate-dataset").main()
    want = json.loads(capsys.readouterr().out)
    got = evaluate_dataset.main([str(synthetic_root), "--samples", "3", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == got
    assert {"floor/tke", "floor/max-mean-tke-pos"} <= set(got)
    assert_metrics_close(got, want, tol=dict(rtol=1e-5))


def test_evaluate_from_initial_matches_jax(synthetic_root, tmp_path):
    """DilResNet from the same parameters: the JAX script's protocol (the
    first val batch of each case noised with ``default_rng(0)``, unrolled 3
    steps in a block of 4) on the JAX task, and the port's entry point on a
    checkpoint: the stored step-3 frames and the ``from-initial`` metrics."""
    args = [*DILRESNET, f"data.root={synthetic_root}", *EVAL_DATA, f"trainer.out_dir={tmp_path / 'run'}"]
    jcfg = jconfig.parse_cli_overrides(args).resolved().model
    jdm = jsequence.SequenceDataModule(synthetic_root, eval_batch_size=2, eval_seq_len=1 + 4, val_samples=2,
                                       cell_bucket=0, discard_first_seconds=-1.0)
    jdm.setup("validate")
    jtask = jregression.DilResNetTask(jcfg, jdm.stats, synthetic_root, tmp_path / "jax")
    batch = next(iter(jdm.val_batches()))
    x0 = jnp.zeros((1, *batch.grid.shape, 4))
    variables = flax_variables(jtask.net, (x0, batch.grid.cell_types), seed=3)
    state = _jax_state(jtask, variables)
    rng = np.random.default_rng(0)
    cells = batch.cells + 1e-2 * rng.normal(size=batch.cells.shape).astype(batch.cells.dtype)
    samples = jtask.unroll_samples(state, dataclasses.replace(batch, cells=cells), [3], block_size=4)
    jstore = JSampleStore(tmp_path / "jax.h5", jtask.variables)
    jstore.add_samples(samples[:, -1], batch.metadata)
    want = JCollection("from-initial", synthetic_root / "val", JCollection.default_metrics()).compute(
        jstore, jdm.stats, expensive_metrics=False)

    tcfg = tconfig.parse_cli_overrides(args).resolved()
    _, task = instantiate_data_and_task(tcfg, "cpu")
    task.load_flax_params(variables)
    ckpt_dir = write_checkpoint(tmp_path / "ckpt", tcfg, task)
    got = evaluate_from_initial.main([str(ckpt_dir), "--steps", "3", "--block-size", "4",
                                      "--out", str(tmp_path / "port.npyd"), "--device", "cpu"])
    assert {"from-initial/tke", "from-initial/max-mean-tke-pos"} <= set(got)
    assert_metrics_close(got, want)
    assert_samples_close(stored(tmp_path / "port.npyd", batch.metadata.file), stored(tmp_path / "jax.h5",
                                                                                      batch.metadata.file))


def test_evaluate_from_initial_is_for_baselines(diffusion):
    with pytest.raises(ValueError, match="baselines"):
        evaluate_from_initial.main([str(diffusion.ckpt_dir), "--device", "cpu"])


# ---- the device ----------------------------------------------------------------------


ENTRY_POINTS = {
    "eval_ckpt": (eval_ckpt, ["ckpt", "out.npyd"]),
    "evaluate_runtime": (evaluate_runtime, ["ckpt"]),
    "sample_metrics": (sample_metrics, ["samples.npyd", "data/val"]),
    "evaluate_dataset": (evaluate_dataset, ["data"]),
    "evaluate_from_initial": (evaluate_from_initial, ["ckpt"]),
    "evaluate_with_precision": (evaluate_with_precision, ["ckpt"]),
    "sampler_sweep": (sampler_sweep, ["ckpt"]),
    "import_checkpoint": (import_checkpoint, ["turbdiff.ckpt", "out"]),
    "profile_fwd": (profile_fwd, ["--out", "profile.json"]),
    "trivial_baselines": (trivial_baselines, ["data"]),
    "degenerate_baselines": (degenerate_baselines, ["data", "--out", "baselines.json"]),
    "calibrate_sinkhorn": (calibrate_sinkhorn, ["data", "--out", "calibration.json"]),
    "tke_profile": (tke_profile, ["samples.npyd", "data/val", "--out", "profile"]),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_needs_a_gpu_unless_told(name, tmp_path, monkeypatch):
    """Without ``--device`` each entry point runs on ``cuda``, and where
    there is none it stops before reading or writing anything rather than
    run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    module, args = ENTRY_POINTS[name]
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match=r"torch.cuda.is_available\(\) is False"):
        module.main(args)
    assert list(tmp_path.iterdir()) == []


def test_entry_point_runs_as_a_module(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "HOME": os.environ.get("HOME", "/tmp"),
           "OMP_NUM_THREADS": "2"}
    res = subprocess.run([sys.executable, "-m", "generative_turbulence_tpu_torch.scripts.eval_ckpt",
                          str(tmp_path / "ckpt"), str(tmp_path / "out.npyd")], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode != 0 and "torch.cuda.is_available() is False" in res.stderr
