"""The training entry point: the port's ``Trainer``, ``instantiate_data_and_task``
and ``python -m generative_turbulence_tpu_torch.train`` against the JAX
package's, on the CPU at the tests' size (dim 8, 1 U-Net level, T = 4,
DDIM-2; the 26x12x12 synthetic dataset against JAX, a 12x8x8 one for the
port alone).

The whole-loop comparison runs the JAX ``Trainer.fit`` and the port's from
the same parameters over 2 epochs of 2 steps, validating after each
(``trainer.wasserstein_solver=exact``), with JAX's step, validation and
diagnostics draws replayed through the port's ``noise_factory``.  RAdam at
learning rate 0.5 decaying to 5e-3 over the 4 updates moves every parameter
far above its f32 rounding (its first 5 updates follow the gradient).
Tolerances: losses and the diagnostics f32 rtol 2e-4 / atol 2e-5;
parameters and EMA by ``test_torch_train.py``'s rule; the sample metrics
rtol 1e-3 (``test_torch_eval_task.py``).  The rest is the port alone:
resume bit for bit, early stopping, the time limit, the EMA and gradient
accumulation through the factory, case-order-free validation draws, the
logger and the command line."""

import copy
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from generative_turbulence_tpu.training import config as jconfig
from generative_turbulence_tpu.training import loop as jloop
from generative_turbulence_tpu.training.diffusion_task import DiffusionState
from generative_turbulence_tpu.training.factory import instantiate_data_and_task as j_instantiate
from generative_turbulence_tpu_torch.data import dataset as tdataset
from generative_turbulence_tpu_torch.data.synthetic import generate_synthetic_dataset
from generative_turbulence_tpu_torch.toolchain.from_flax import torch_state_dict_from_flax
from generative_turbulence_tpu_torch.training import config as tconfig
from generative_turbulence_tpu_torch.training.diffusion_task import sample
from generative_turbulence_tpu_torch.training.factory import instantiate_data_and_task
from generative_turbulence_tpu_torch.training.logging import MetricLogger
from generative_turbulence_tpu_torch.training.loop import KeyedNoise, Trainer, key_seed, parse_duration
from test_torch_diffusion import Replay, jax_normals
from test_torch_losses import ReplayDraws, jax_loss_draws
from test_torch_train import F32, _assert_changes_close

REPO = Path(__file__).resolve().parents[1]
F32_TOL = dict(rtol=2e-4, atol=2e-5)


def base_overrides(root, out_dir, *extra):
    return [
        "model=diffusion", f"data.root={root}", "data.discard_first_seconds=-1", "data.val_samples=2",
        "data.eval_batch_size=2", "model.batch_size=4", "model.dim=8", "model.u_net_levels=1",
        "model.timesteps=4", "model.sampler=ddim", "model.ddim_steps=2", f"trainer.out_dir={out_dir}",
        "trainer.max_epochs=1", "trainer.check_val_every_n_epoch=1", "trainer.render_plots=false",
        "model.compute_expensive_sample_metrics=false", *extra,
    ]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads while this file runs: the suite runs files in
    parallel processes, where torch's default of one thread per core
    oversubscribes the host."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """The port-only runs' dataset: one case per split of 8 frames at 10x6x6
    cells (12x8x8 padded), 2 train batches of 4 per epoch."""
    return generate_synthetic_dataset(tmp_path_factory.mktemp("tiny") / "data", n_train_cases=1, n_val_cases=1,
                                      n_test_cases=1, n_frames=8, cell_counts=(10, 6, 6), seed=2, format="npyd")


def fit(root, out_dir, *extra, noise_factory=None, state=None):
    config = tconfig.parse_cli_overrides(base_overrides(root, out_dir, *extra)).resolved()
    dm, task = instantiate_data_and_task(config, "cpu")
    trainer = Trainer(config, task, dm, noise_factory=noise_factory)
    return trainer, trainer.fit(state)


def logged(run_dir, key):
    """{step: value} of ``key`` in a run's metrics.jsonl."""
    out = {}
    for line in (Path(run_dir) / "metrics.jsonl").read_text().splitlines():
        record = json.loads(line)
        if key in record:
            out[record["step"]] = record[key]
    return out


# ---- the pieces -----------------------------------------------------------------


@pytest.mark.parametrize("spec, seconds", [("24h", 86400.0), ("30m", 1800.0), ("90s", 90.0), ("1.5d", 129600.0),
                                           (None, None)])
def test_parse_duration(spec, seconds):
    assert parse_duration(spec) == seconds == jloop.parse_duration(spec)


def test_parse_duration_refuses_other_units():
    with pytest.raises(ValueError, match="Bad duration"):
        parse_duration("10 minutes")


def test_metric_logger_jsonl_and_summary(tmp_path):
    """One JSONL record per ``log`` (non-finite values as null) and the
    best-epoch summary on the monitor (lower is better)."""
    logger = MetricLogger(tmp_path)
    logger.log({"train/loss": 1.5}, step=1, epoch=0)
    logger.log({"val/tke": float("nan")}, step=2)
    assert logger.update_best("val/tke", {"val/tke": 3.0, "val/x": 1.0}, step=2)
    assert not logger.update_best("val/tke", {"val/tke": 4.0}, step=3)
    assert logger.update_best("val/tke", {"val/tke": 2.0}, step=4)
    assert not logger.update_best("val/other", {}, step=5)
    logger.close()
    records = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2] and records[0]["epoch"] == 0
    assert records[0]["train/loss"] == 1.5 and records[1]["val/tke"] is None
    assert json.loads((tmp_path / "summary.json").read_text()) == {"best_step": 4, "val/tke": 2.0}


def test_key_seed_is_the_same_in_every_process():
    """The default noise keys do not use Python's salted ``hash``."""
    code = "from generative_turbulence_tpu_torch.training.loop import key_seed; print(key_seed(0, 'val', 10000, 'case-a', 1))"
    runs = {subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, timeout=120,
                           env={**os.environ, "PYTHONHASHSEED": seed}).stdout.strip() for seed in ("1", "2")}
    assert runs == {str(key_seed(0, "val", 10000, "case-a", 1))}
    assert key_seed(0, "val", 10000, "case-a", 1) != key_seed(0, "val", 10000, "case-a", 2)
    a, b = KeyedNoise(3, "cpu")("train", 5), KeyedNoise(3, "cpu")("train", 5)
    assert torch.equal(a((4,)), b((4,))) and not torch.equal(a((4,)), KeyedNoise(3, "cpu")("train", 6)((4,)))


# ---- the whole loop against JAX ------------------------------------------------------


class JaxDraws:
    """A ``noise_factory`` replaying the draws of the JAX ``Trainer.fit``
    started from a given state (its key is ``PRNGKey(seed)``): the step's
    t and noise from ``fold_in(key, step)``, the sampler's normals from
    ``eval_rng_for(base, case, k)`` and the diagnostics' from
    ``split(fold_in(base, 777), n_timesteps)``."""

    def __init__(self, seed, train_shape, eval_shape, cfg):
        self.key, self.cfg = jax.random.PRNGKey(seed), cfg
        self.train_shape, self.eval_shape = train_shape, eval_shape
        self.kinds = []

    def _base(self, fold):
        return self.key if fold is None else jax.random.fold_in(self.key, fold)

    def __call__(self, kind, *key):
        self.kinds.append(kind)
        cfg = self.cfg
        if kind == "train":
            (step,) = key
            return ReplayDraws(jax_loss_draws(jax.random.fold_in(self.key, step), self.train_shape, cfg.timesteps))
        if kind == "val":
            fold, case, k = key
            rng = jloop.eval_rng_for(self._base(fold), case, k)
            return Replay(jax_normals(rng, self.eval_shape, cfg.ddim_steps, cfg.noise_bcs))
        if kind == "diagnostics":
            (fold,) = key
            n_ts = len(np.unique(np.round(np.linspace(0, cfg.timesteps - 1, 8)).astype(np.int32)))
            rngs = jax.random.split(jax.random.fold_in(self._base(fold), 777), n_ts)
            return Replay([np.asarray(jax.random.normal(r, self.eval_shape)) for r in rngs])
        raise AssertionError(f"unexpected noise kind {kind!r}")


LOOP = [
    "model.batch_size=12", "model.ema_decay=0.9", "model.learning_rate=0.5", "model.min_learning_rate=5e-3",
    "trainer.max_epochs=2", "trainer.log_every_n_steps=1", "trainer.wasserstein_solver=exact",
    "model.compute_expensive_sample_metrics=true",
    # JAX-side TPU workarounds off, so both packages see the same arrays;
    # its pooled collation (default) stays on: it sorts a batch's frames, as
    # the port does.
    "data.cell_bucket=0", "data.device_prefetch=false",
]


def _one_worker(task_metrics):
    for metric in task_metrics:
        if hasattr(metric, "max_workers"):
            metric.max_workers = 1


@pytest.fixture(scope="module")
def loop_runs(synthetic_root, tmp_path_factory):
    """The JAX Trainer.fit and the port's, from the same parameters and
    draws: (JAX trainer, its metrics, port trainer, its metrics, start)."""
    out = tmp_path_factory.mktemp("loop")
    args = base_overrides(synthetic_root, out / "jax", *LOOP)
    jcfg = jconfig.parse_cli_overrides(args).resolved()
    jdm, jtask = j_instantiate(jcfg)
    _one_worker(jtask.val_metrics.metrics)
    batch = next(iter(jdm.val_batches()))
    x0 = jnp.zeros((1, *batch.grid.shape, 4))
    params = jax.jit(jtask.net.init)(jax.random.PRNGKey(0), x0, jnp.zeros((1,), jnp.int32), batch.grid.cell_types)
    state = DiffusionState.create(apply_fn=jtask.net.apply, params=params, tx=jtask.tx,
                                  ema_params=jax.tree_util.tree_map(jnp.copy, params))
    params = jax.tree_util.tree_map(np.asarray, params)
    jtrainer = jloop.Trainer(jcfg, jtask, jdm, use_wandb=False)
    jmetrics = jtrainer.fit(state)

    tcfg = tconfig.parse_cli_overrides([a.replace(str(out / "jax"), str(out / "port")) for a in args]).resolved()
    tdm, ttask = instantiate_data_and_task(tcfg, "cpu")
    _one_worker(ttask.metrics["val"].metrics)
    ttask.load_flax_params(params)
    grid_shape = batch.grid.shape
    draws = JaxDraws(tcfg.trainer.seed, (12, *grid_shape, 4), (2, *grid_shape, 4), tcfg.model)
    ttrainer = Trainer(tcfg, ttask, tdm, noise_factory=draws)
    start = copy.deepcopy(ttask.state_dict())
    tmetrics_ = ttrainer.fit(copy.deepcopy(start))
    return dict(jtrainer=jtrainer, jmetrics=jmetrics, ttrainer=ttrainer, tmetrics=tmetrics_, draws=draws,
                start={k: v.numpy() for k, v in start["net"].items()}, out=out)


def test_fit_runs_the_same_schedule(loop_runs):
    """2 epochs of 2 steps, a validation (with diagnostics) after each."""
    draws, ttrainer = loop_runs["draws"], loop_runs["ttrainer"]
    assert ttrainer.task.step == int(loop_runs["jtrainer"].state.step) == 4
    assert draws.kinds == ["train", "train", "diagnostics", "val", "train", "train", "diagnostics", "val"]
    out = loop_runs["out"]
    assert sorted(logged(out / "port", "train/loss")) == sorted(logged(out / "jax", "train/loss")) == [1, 2, 3, 4]
    assert sorted(logged(out / "port", "val/tke")) == sorted(logged(out / "jax", "val/tke")) == [2, 4]


def test_fit_losses_match_jax(loop_runs):
    out = loop_runs["out"]
    got, want = logged(out / "port", "train/loss"), logged(out / "jax", "train/loss")
    for step in want:
        np.testing.assert_allclose(got[step], want[step], **F32_TOL, err_msg=f"step {step}")


@pytest.mark.parametrize("which", ["params", "ema"])
def test_fit_final_parameters_match_jax(loop_runs, which):
    state = loop_runs["jtrainer"].state
    tree = state.params if which == "params" else state.ema_params
    want = {k: v.numpy() for k, v in torch_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, tree)).items()}
    task = loop_runs["ttrainer"].task
    got = task.net.state_dict() if which == "params" else task.ema
    _assert_changes_close({k: v.numpy() for k, v in got.items()}, want, loop_runs["start"], F32, which)


def test_fit_validation_matches_jax(loop_runs):
    """Both validations' ``val/tke`` (and the final one's Wasserstein, by
    exact EMD) at rtol 1e-3; the eps-loss diagnostics at the f32 rule."""
    out = loop_runs["out"]
    for key, tol in (("val/tke", dict(rtol=1e-3)), ("val/tke-back", dict(rtol=1e-3)),
                     ("val/eps-loss-t0", F32_TOL), ("val/eps-loss-ema-t3", F32_TOL)):
        got, want = logged(out / "port", key), logged(out / "jax", key)
        assert got.keys() == want.keys() == {2, 4}, key
        for step in want:
            np.testing.assert_allclose(got[step], want[step], **tol, err_msg=f"{key} at step {step}")
    jm, tm = loop_runs["jmetrics"], loop_runs["tmetrics"]
    np.testing.assert_allclose(tm["val/wasserstein"], jm["val/wasserstein"], rtol=1e-3)
    assert {k for k in jm if k.count("/") == 1} == {k for k in tm if k.count("/") == 1}


def test_fit_checkpoints_match_jax(loop_runs):
    """last and best, the config beside them, and the same index."""
    out = loop_runs["out"]
    jdir, tdir = out / "jax" / "checkpoints", out / "port" / "checkpoints"
    assert {p.name for p in jdir.iterdir()} >= {"last", "best", "config.json", "index.json"}
    assert {p.name for p in tdir.iterdir()} == {"last.pt", "best.pt", "config.json", "index.json"}
    jindex, tindex = (json.loads((d / "index.json").read_text()) for d in (jdir, tdir))
    assert tindex["step"] == jindex["step"] == 4 and tindex["best_step"] == jindex["best_step"]
    np.testing.assert_allclose(tindex["best_value"], jindex["best_value"], rtol=1e-3)
    assert json.loads((tdir / "config.json").read_text())["model"]["ema_decay"] == 0.9
    assert json.loads((out / "port" / "summary.json").read_text())["best_step"] == tindex["best_step"]


# ---- the port alone: resume, early stopping, the time limit ---------------------------


def test_resume_replays_the_unkilled_run_bit_for_bit(tiny_root, tmp_path):
    """Control: 2 epochs straight.  Killed: stopped at the epoch boundary by
    max_steps (same schedule horizon), then resumed from its checkpoint in a
    fresh task.  The resumed steps' losses, the final parameters, EMA and
    optimizer state, and the final validation are bit-equal."""
    per_step = ["trainer.log_every_n_steps=1", "trainer.check_val_every_n_epoch=10", "trainer.max_epochs=2",
                "model.ema_decay=0.9"]
    control, control_metrics = fit(tiny_root, tmp_path / "a", *per_step)
    n_batches = control.dm.n_train_batches()
    killed, _ = fit(tiny_root, tmp_path / "b1", *per_step, f"trainer.max_steps={n_batches}")
    assert killed.task.step == n_batches
    resumed, resumed_metrics = fit(tiny_root, tmp_path / "b2", *per_step,
                                   f"trainer.resume_from={tmp_path}/b1/checkpoints")
    assert resumed.task.step == control.task.step == 2 * n_batches

    want, got = logged(tmp_path / "a", "train/loss"), logged(tmp_path / "b2", "train/loss")
    tail = {s: v for s, v in want.items() if s > n_batches}
    assert tail and got == tail
    a, b = control.task.state_dict(), resumed.task.state_dict()
    assert all(torch.equal(a["net"][k], b["net"][k]) for k in a["net"])
    assert all(torch.equal(a["ema"][k], b["ema"][k]) for k in a["ema"])
    assert all(torch.equal(x, y) for x, y in zip(a["opt"]["mu"] + a["opt"]["nu"], b["opt"]["mu"] + b["opt"]["nu"]))
    assert resumed_metrics["val/tke"] == control_metrics["val/tke"]


def test_early_stopping(tiny_root, tmp_path):
    """No learning -> the same samples every validation -> the monitor
    cannot improve; with patience 1 training stops after the 2nd."""
    trainer, _ = fit(tiny_root, tmp_path, "trainer.max_epochs=4", "trainer.early_stopping_patience=1",
                     "model.learning_rate=1e-30", "model.lr_decay=null", "trainer.deterministic_eval=true")
    assert trainer.task.step // trainer.dm.n_train_batches() == 2
    assert len(logged(tmp_path, "val/tke")) == 2


def test_train_limit_forces_a_final_validation(tiny_root, tmp_path, capsys):
    """A limit of 0 s stops after the first step, then validates (the final
    epoch's expensive metrics asked for) and checkpoints."""
    trainer, metrics = fit(tiny_root, tmp_path, "trainer.max_epochs=3", "trainer.train_limit=0s",
                           "trainer.check_val_every_n_epoch=100")
    assert trainer.task.step == 1
    assert "train limit reached" in capsys.readouterr().err
    assert np.isfinite(metrics["val/tke"]) and logged(tmp_path, "val/tke").keys() == {1}
    assert json.loads((tmp_path / "checkpoints" / "index.json").read_text())["step"] == 1


def test_eval_testset_scores_the_final_state(tiny_root, tmp_path):
    _, metrics = fit(tiny_root, tmp_path, "trainer.eval_testset=true", "data.test_samples=2")
    assert np.isfinite(metrics["test/tke"]) and np.isfinite(metrics["val/tke"])
    assert logged(tmp_path, "test/tke")


def test_profile_steps_write_a_trace(tiny_root, tmp_path):
    """``trainer.profile_steps`` steps from ``trainer.profile_start`` under
    torch.profiler, its trace in ``out_dir/profile``."""
    fit(tiny_root, tmp_path, "trainer.profile_steps=1", "trainer.profile_start=1")
    trace = json.loads((tmp_path / "profile" / "trace.json").read_text())
    assert any(e.get("name") == "train/loss" for e in trace["traceEvents"])


def test_sharded_validation_over_ranks_is_refused(tiny_root, tmp_path):
    """No longer refused: a validation with ``data.shard_eval`` on 2 gloo
    ranks, where rank 0 owns the one val case and rank 1 none, returns on
    both ranks the merged metrics of the 1-process validation, the
    diagnostics (computed on rank 0) among them."""
    from _torch_dist_worker import JOBS, run_ranks

    extra = ("model.ema_decay=0.9",)
    spec = dict(overrides=base_overrides(tiny_root, tmp_path / "run", *extra, "data.shard_eval=true"))
    results = run_ranks("validate", spec, tmp_path)
    assert all(code == 0 for code, _, _ in results), [log[-3000:] for _, _, log in results]
    (_, r0, _), (_, r1, _) = results
    one = JOBS["validate"](dict(overrides=base_overrides(tiny_root, tmp_path / "one", *extra)))["metrics"]
    assert r0["store_cases"] == ["case-val-00"] and r1["store_cases"] == []
    merged = {k: v for k, v in one.items() if not k.startswith("val/sample-")}
    assert "val/eps-loss-ema-t3" in merged and "val/case-val-00/tke" in merged
    for metrics in (r0["metrics"], r1["metrics"]):
        assert {k for k in metrics if not k.startswith("val/sample-")} == merged.keys()
        for k, v in merged.items():
            if k.endswith("max-mean-tke-pos"):
                # 10 cells along x: the TKE profile behind x = 24 is the outlet's
                # padding plane alone, 0 everywhere, so the metric is undefined.
                assert math.isnan(metrics[k]) and math.isnan(v), k
                continue
            assert metrics[k] == pytest.approx(v, rel=1e-5, abs=1e-8), k


@pytest.mark.parametrize("precision, tf32", [("high", True), ("highest", False)])
def test_matmul_precision_sets_tf32(precision, tf32, monkeypatch):
    from generative_turbulence_tpu_torch.train import set_matmul_precision

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", not tf32)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", not tf32)
    set_matmul_precision(precision)
    assert torch.backends.cuda.matmul.allow_tf32 is tf32 and torch.backends.cudnn.allow_tf32 is tf32
    set_matmul_precision("default")
    assert torch.backends.cuda.matmul.allow_tf32 is tf32
    with pytest.raises(ValueError, match="matmul precision"):
        set_matmul_precision("medium")


def test_validation_draws_do_not_depend_on_case_order(tmp_path, monkeypatch):
    """Two val cases validated in both orders under the default noise
    factory: each case's metrics are bit-equal."""
    root = generate_synthetic_dataset(tmp_path / "data", n_train_cases=1, n_val_cases=2, n_test_cases=0,
                                      n_frames=6, cell_counts=(10, 6, 6), seed=1, format="npyd")
    values = []
    for order in (1, -1):
        files = tdataset.find_data_files
        monkeypatch.setattr(tdataset, "find_data_files", lambda d, files=files, order=order: files(d)[::order])
        trainer, metrics = fit(root, tmp_path / f"run{order}", "model.batch_size=2")
        monkeypatch.undo()
        assert [b.metadata.case_name for b in trainer.dm.val_batches()] == ["case-val-00", "case-val-01"][::order]
        values.append({k: v for k, v in metrics.items() if "/case-val-" in k})
    assert values[0] and values[0] == values[1]


# ---- the EMA and gradient accumulation through the factory ---------------------------


def _factory_task(root, tmp_path, *extra):
    config = tconfig.parse_cli_overrides(base_overrides(root, tmp_path, *extra)).resolved()
    dm, task = instantiate_data_and_task(config, "cpu")
    task.init_weights(torch.Generator().manual_seed(0))
    return dm, task


def _step(task, batch, seed):
    batch = batch.to("cpu")
    return task.training_step(batch.cells, batch.grid, KeyedNoise(seed, "cpu")("train", 0))


def _first_leaf(tensors):
    return next(iter(tensors.values())).clone()


def test_ema_tracks_params(synthetic_root, tmp_path):
    """After one step the warm-up EMA is d p0 + (1 - d) p1, d = min(0.5,
    2/11), and sampling runs on it."""
    dm, task = _factory_task(synthetic_root, tmp_path, "model.ema_decay=0.5")
    p0 = _first_leaf(task.net.state_dict())
    _step(task, next(iter(dm.train_batches(0))), 1)
    p1, e1 = _first_leaf(task.net.state_dict()), _first_leaf(task.ema)
    d = min(0.5, 2.0 / 11.0)
    np.testing.assert_allclose(e1.numpy(), (d * p0 + (1 - d) * p1).numpy(), rtol=1e-5, atol=1e-7)
    batch = next(iter(dm.val_batches())).to("cpu")
    noise = lambda: KeyedNoise(0, "cpu")("val", None, "c", 0)  # noqa: E731
    got = task.sample(batch.cells, batch.grid, noise())
    on_ema = sample(lambda *a: functional_call(task.eval_net, task.ema, a), task.diffusion, task.normalizer,
                    batch.cells, batch.grid, sampler="ddim", ddim_steps=2, noise=noise())
    assert torch.equal(got, on_ema)


def test_ema_off_by_default(synthetic_root, tmp_path):
    dm, task = _factory_task(synthetic_root, tmp_path)
    _step(task, next(iter(dm.train_batches(0))), 1)
    assert task.ema is None and "ema" in task.state_dict() and task.state_dict()["ema"] is None


def test_ema_with_accumulation_counts_real_updates(synthetic_root, tmp_path):
    """Under accumulation the EMA does not move on the micro-steps that only
    accumulate, and its warm-up counts real updates."""
    dm, task = _factory_task(synthetic_root, tmp_path, "model.ema_decay=0.5", "model.accumulate_steps=2")
    p0, e0 = _first_leaf(task.net.state_dict()), _first_leaf(task.ema)
    assert torch.equal(p0, e0)
    batches = iter(dm.train_batches(0))
    _step(task, next(batches), 1)
    assert torch.equal(_first_leaf(task.net.state_dict()), p0) and torch.equal(_first_leaf(task.ema), e0)
    _step(task, next(batches), 2)
    p2, e2 = _first_leaf(task.net.state_dict()), _first_leaf(task.ema)
    assert (p2 - p0).abs().max() > 0
    d = min(0.5, 2.0 / 11.0)
    np.testing.assert_allclose(e2.numpy(), (d * p0 + (1 - d) * p2).numpy(), rtol=1e-5, atol=1e-7)


def test_factory_with_accumulation(synthetic_root, tmp_path):
    """Micro-batches of batch / k; the first micro-step leaves every
    parameter as it was, the second moves them; the schedule spans the
    updates."""
    dm, task = _factory_task(synthetic_root, tmp_path, "model.accumulate_steps=2", "trainer.max_epochs=3")
    assert dm.batch_size == 2 and dm.device == "cpu"
    assert task.tx.learning_rate(3 * dm.n_train_batches() // 2) == pytest.approx(1e-6)
    batch = next(iter(dm.train_batches(0)))
    assert batch.cells.shape[0] == 2 and isinstance(batch.cells, torch.Tensor)
    p0 = {k: v.clone() for k, v in task.net.state_dict().items()}
    _step(task, batch, 1)
    assert all(torch.equal(p0[k], v) for k, v in task.net.state_dict().items())
    _step(task, next(iter(dm.train_batches(1))), 2)
    assert any(not torch.equal(p0[k], v) for k, v in task.net.state_dict().items())


def test_factory_cache_fields_give_jax_train_frames(synthetic_root, tmp_path):
    """The data fields of the JAX package's TPU workarounds are accepted;
    those of its device frame caches give the training frames the dtype JAX's
    have (``tests/test_torch_frame_cache.py`` holds them against JAX): each
    batch rounded to bf16 in the same sorted order, and nothing else
    changed; the eval batches stay f32."""
    plain, _ = _factory_task(synthetic_root, tmp_path / "a")
    fields = ["data.cell_bucket=0", "data.buffer_pool=false", "data.device_cache_gb=2",
              "data.eval_device_cache_gb=1", "data.transfer_dtype=bfloat16", "data.device_prefetch=false"]
    other, _ = _factory_task(synthetic_root, tmp_path / "b", *fields)
    for a, b in zip(plain.train_batches(0), other.train_batches(0), strict=True):
        assert a.cells.dtype == torch.float32 and b.cells.dtype == torch.bfloat16
        assert np.array_equal(b.t, a.t) and np.all(np.diff(a.t) > 0)
        assert torch.equal(b.cells, a.cells.to(torch.bfloat16))
    for a, b in zip(plain.val_batches(), other.val_batches(), strict=True):
        assert torch.equal(a.cells, b.cells) and a.cells.dtype == torch.float32


def test_factory_rejects_an_unknown_model(synthetic_root, tmp_path):
    config = tconfig.parse_cli_overrides(base_overrides(synthetic_root, tmp_path)).resolved()
    config.model.name = "unet-gan"
    with pytest.raises(ValueError, match="Unknown model"):
        instantiate_data_and_task(config, "cpu")


def test_render_plots_after_validation(tiny_root, tmp_path):
    """With ``trainer.render_plots`` the validation writes the spectra and
    slices of its samples (where matplotlib imports)."""
    pytest.importorskip("matplotlib")
    trainer, _ = fit(tiny_root, tmp_path, "trainer.render_plots=true")
    pngs = sorted(p.name for p in (tmp_path / "plots" / f"val-{trainer.task.step}").iterdir())
    assert "case-val-00-z-slice.png" in pngs and any(p.startswith("tke-") for p in pngs)


def test_render_plots_without_matplotlib(tiny_root, tmp_path, monkeypatch, capsys):
    """Where matplotlib does not import (the card), a validation with
    ``trainer.render_plots`` says so in one line and draws nothing."""
    import importlib.util

    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None if name == "matplotlib" else find_spec(name, *a))
    trainer, metrics = fit(tiny_root, tmp_path, "trainer.render_plots=true")
    assert capsys.readouterr().err.count("plots skipped: matplotlib is not installed") == 1
    assert np.isfinite(metrics["val/tke"]) and not (tmp_path / "plots").exists()


# ---- the command line -------------------------------------------------------------


def _cli(*args, timeout=300):
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "HOME": os.environ.get("HOME", "/tmp"),
           "OMP_NUM_THREADS": "2"}
    return subprocess.run([sys.executable, "-m", "generative_turbulence_tpu_torch.train", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout, env=env)


# Small configurations of the baselines for the command line (TF-Net's
# widths are the model's own).
CLI_MODELS = {
    "diffusion": [],
    "tfnet": ["model=tfnet", "model.context_window=4", "model.temporal_filtering_length=2", "model.unroll_steps=2"],
    "dilresnet": ["model=dilresnet", "model.N=1", "model.hidden_dim=8"],
}


@pytest.mark.parametrize("model", list(CLI_MODELS))
def test_train_cli_produces_artifacts(tiny_root, tmp_path, model):
    """``python -m generative_turbulence_tpu_torch.train --device cpu``: the
    metrics, the summary, the checkpoints and the final monitor, for each
    family the factory builds."""
    regression = ["model.eval_unroll_steps=2", "model.sample_steps=[2]", "model.main_sample_step=2",
                  "model.monitor=val/tke"] if model != "diffusion" else []
    res = _cli("--device", "cpu", *base_overrides(tiny_root, tmp_path), *CLI_MODELS[model], *regression)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "final val/tke: " in res.stderr and "device: cpu" in res.stderr
    score = float(res.stderr.split("final val/tke: ")[1].split()[0])
    assert np.isfinite(score)
    assert (tmp_path / "metrics.jsonl").is_file()
    assert json.loads((tmp_path / "summary.json").read_text())["val/tke"] == score
    assert {"last.pt", "best.pt", "config.json"} <= {p.name for p in (tmp_path / "checkpoints").iterdir()}
    assert json.loads((tmp_path / "checkpoints" / "config.json").read_text())["model"]["name"] == model


def test_train_cli_names_the_missing_yaml_module(tiny_root, tmp_path):
    """Where PyYAML does not import, ``config=<file>.yaml`` stops with a
    message naming it; the overrides alone still run (above)."""
    blocker = tmp_path / "noyaml"
    blocker.mkdir()
    (blocker / "yaml.py").write_text("raise ModuleNotFoundError(\"No module named 'yaml'\", name='yaml')\n")
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "HOME": os.environ.get("HOME", "/tmp"),
           "OMP_NUM_THREADS": "2", "PYTHONPATH": str(blocker)}
    res = subprocess.run([sys.executable, "-m", "generative_turbulence_tpu_torch.train", "--device", "cpu",
                          f"config={REPO / 'config' / 'shapes_diffusion.yaml'}"], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode != 0 and "the 'yaml' module, which is not installed" in res.stderr


def test_train_cli_needs_a_gpu_unless_told(tiny_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    res = _cli(*base_overrides(tiny_root, tmp_path))
    assert res.returncode != 0 and "torch.cuda.is_available() is False" in res.stderr
    assert not (tmp_path / "metrics.jsonl").exists()
