"""Data-parallel training and sharded validation over ``torch.distributed``:
2 gloo ranks on the CPU (``tests/_torch_dist_worker.py``, a ``file://``
rendezvous in the test's directory, 2 threads a rank, collectives bounded at
60 s and every rank killed past the test's deadline) against the port in one
process and against the JAX package's single-process ``train_step`` and
``Trainer.validate``, at the JAX multi-process tests' sizes (dim 8, 1
U-Net level, T <= 10, grids of at most 24x10x10).

Tolerances: the all-reduced losses equal on both ranks at rel 1e-6, and
against the 1-process port and JAX's at rel 1e-5; parameters by
``test_torch_train.py``'s f32 rule on the change from the start (rtol 2e-4,
atol 2e-5 x the leaf's largest change, tests/test_pallas_kernels.py:29); the
two ranks' parameters bit-equal.  The merged validation metrics: equal on
both ranks at rel 1e-6 / abs 1e-9, and to the 1-process port's and JAX's at
rel 1e-5 / abs 1e-8 (tests/test_distributed.py:185-203, ``val/sample-*``
excepted there as here: those are each rank's own batch means)."""

import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_turbulence_tpu.data import grid as jgrid
from generative_turbulence_tpu.data.schema import FieldStats as JFieldStats
from generative_turbulence_tpu.data.schema import read_metadata as j_read_metadata
from generative_turbulence_tpu.data.synthetic import generate_case as j_generate_case
from generative_turbulence_tpu.data.synthetic import generate_synthetic_dataset as j_generate_dataset
from generative_turbulence_tpu.data.variables import Variable as JVariable
from generative_turbulence_tpu.training import config as jconfig
from generative_turbulence_tpu.training import loop as jloop
from generative_turbulence_tpu.training.diffusion_task import DiffusionState
from generative_turbulence_tpu.training.diffusion_task import DiffusionTask as JDiffusionTask
from generative_turbulence_tpu.training.factory import instantiate_data_and_task as j_instantiate
from generative_turbulence_tpu_torch.data.synthetic import build_case, generate_synthetic_dataset
from generative_turbulence_tpu_torch.data.variables import Variable, stack_channels
from generative_turbulence_tpu_torch.parallel import distributed as tdist
from generative_turbulence_tpu_torch.parallel.mesh import RankRows, check_mesh_shape, local_rows
from generative_turbulence_tpu_torch.toolchain.from_flax import torch_state_dict_from_flax
from generative_turbulence_tpu_torch.training import config as tconfig
from generative_turbulence_tpu_torch.training.checkpoint import CheckpointManager
from generative_turbulence_tpu_torch.training.factory import instantiate_data_and_task
from generative_turbulence_tpu_torch.training.loop import Trainer
from generative_turbulence_tpu_torch.training.optimizers import build_optimizer
from _torch_dist_worker import REPO, JOBS, run_ranks
from test_torch_loop import JaxDraws, base_overrides, tiny_root  # noqa: F401  (the module's tiny_root fixture)
from test_torch_losses import jax_loss_draws
from test_torch_task import field_stats
from test_torch_train import F32, _assert_changes_close

CASE = dict(cell_counts=(16, 8, 8), seed=3)  # padded 18x10x10
BATCH = 4
T = 10
STEP = ["model.dim=8", "model.u_net_levels=1", f"model.timesteps={T}", "model.ema_decay=0.9",
        "model.learning_rate=0.5", "model.min_learning_rate=5e-3"]
MAX_TRAIN_STEPS = 10
N_STEPS = 2
STEP_VARIANTS = {"plain": [], "accumulate-2": ["model.accumulate_steps=2"]}
RANK_REL = dict(rel=1e-6, abs=1e-9)
ONE_PROCESS_REL = dict(rel=1e-5, abs=1e-8)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _ok(results):
    """The ranks' outputs, each rank having exited 0."""
    for rank, (code, out, log) in enumerate(results):
        assert code == 0 and out is not None and "error" not in out, f"rank {rank} exited {code}:\n{log[-4000:]}"
    return [out for _, out, _ in results]


def _rank0_only(metrics):
    return {k: v for k, v in metrics.items() if not k.startswith("val/sample-")}


# ---- the pieces -------------------------------------------------------------------


def test_local_rows_and_rank_rows_cut_the_global_draws():
    """Rank r keeps rows [r*B/W, (r+1)*B/W); RankRows hands each rank its
    rows of one global draw, so the ranks' rows make up the 1-rank draw."""
    rows = torch.arange(12).reshape(6, 2)
    assert torch.equal(local_rows(rows, 1, 3), rows[2:4]) and local_rows(list(range(6)), 2, 3) == [4, 5]
    with pytest.raises(ValueError, match="does not split"):
        local_rows(rows, 0, 4)

    class Source:
        def __init__(self):
            self.gen = torch.Generator().manual_seed(0)

        def __call__(self, shape):
            return torch.randn(shape, generator=self.gen)

        def randint(self, n, high):
            return torch.randint(0, high, (n,), generator=self.gen)

    whole = Source()
    t, eps = whole.randint(4, 10), whole((4, 3))
    parts = [RankRows(Source(), r, 2) for r in range(2)]
    got = [(p.randint(2, 10), p((2, 3))) for p in parts]
    assert torch.equal(torch.cat([g[0] for g in got]), t) and torch.equal(torch.cat([g[1] for g in got]), eps)


@pytest.mark.parametrize("mesh_shape, world, message", [
    ((1, 2), 1, "dp x sp = 2 but the run has 1 rank"), ((2, 2), 2, "dp x sp = 4 but the run has 2 rank"),
    ((2, 1), 1, "dp x sp = 2"), ((1, 1), 2, "dp x sp = 1"), ((4, 1), 2, "dp x sp = 4"),
    ((0, 2), 0, "at least 1"),
])
def test_mesh_shape_outside_the_ported_dp_axis_raises(mesh_shape, world, message):
    """A mesh whose dp x sp is not the world size, or an axis below 1."""
    with pytest.raises(ValueError, match=message):
        check_mesh_shape(mesh_shape, world)


def test_mesh_shape_of_the_whole_world_is_accepted(tiny_root, tmp_path):  # noqa: F811
    """None, (world, 1) or any (dp, sp) of dp x sp = world pass; the Trainer
    checks ``trainer.mesh_shape``."""
    for mesh_shape, world in ((None, 1), (None, 4), ((1, 1), 1), ((4, 1), 4), ((2, 2), 4), ((1, 2), 2)):
        check_mesh_shape(mesh_shape, world)
    config = tconfig.parse_cli_overrides(base_overrides(tiny_root, tmp_path, "trainer.mesh_shape=[2,1]")).resolved()
    dm, task = instantiate_data_and_task(config, "cpu")
    with pytest.raises(ValueError, match="dp x sp = 2 but the run has 1 rank"):
        Trainer(config, task, dm)


def test_single_process_needs_no_group(monkeypatch):
    """Without the environment nothing starts; the collectives' helpers
    return their input and ``allgather_objects`` a one-element list."""
    for name in ("GT_DIST_NUM_PROCESSES", "GT_DISTRIBUTED"):
        monkeypatch.delenv(name, raising=False)
    assert tdist.initialize_distributed("cpu") is False
    monkeypatch.setenv("GT_DIST_NUM_PROCESSES", "1")
    assert tdist.initialize_distributed("cpu") is False
    assert tdist.process_rank_and_world() == (0, 1) and tdist.is_main_process()
    t = torch.ones(2)
    assert tdist.mean_over_ranks(t) is t and tdist.sum_over_ranks(t) is t
    assert tdist.reduce_host_value(3.0, "min") == 3.0 and tdist.allgather_objects({"a": 1}) == [{"a": 1}]
    net = torch.nn.Linear(2, 2)
    assert tdist.data_parallel(net) is net


# ---- one train step: 2 ranks, 1 process, JAX --------------------------------------


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    """JAX's 2 train steps (batch 4), and per variant the port's in one
    process and on 2 ranks, from the same parameters and JAX's draws."""
    tmp = tmp_path_factory.mktemp("dist-step")
    case_file = j_generate_case(tmp / "case", n_frames=BATCH, **CASE)
    jgm = jgrid.GridMap.from_metadata(j_read_metadata(case_file), (JVariable.U, JVariable.P), cached=False)
    _, fields = build_case(n_frames=BATCH, **CASE)
    cells = stack_channels(fields, (Variable.U, Variable.P))
    stats = field_stats(fields)
    task = JDiffusionTask(jconfig.parse_cli_overrides(STEP).model, JFieldStats(stats), tmp, tmp / "samples",
                          max_train_steps=MAX_TRAIN_STEPS)
    params = jax.jit(task.net.init)(jax.random.PRNGKey(0), jnp.zeros((1, *jgm.shape, 4)),
                                    jnp.zeros((1,), jnp.int32), jgm.cell_types)
    flat = lambda tree: {k: v.numpy() for k, v in  # noqa: E731
                         torch_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, tree)).items()}
    start = flat(params)
    state = DiffusionState.create(apply_fn=task.net.apply, params=params, tx=task.tx,
                                  ema_params=jax.tree_util.tree_map(jnp.copy, params))
    losses, draws = [], []
    for i in range(N_STEPS):
        rng = jax.random.PRNGKey(100 + i)
        draws.append(jax_loss_draws(rng, (BATCH, *jgm.shape, 4), T))
        state, metrics = task.train_step(state, jnp.asarray(cells), jgm, rng)
        losses.append(float(metrics["train/loss"]))
    spec = dict(case_file=str(case_file), cells=cells, stats=stats, max_train_steps=MAX_TRAIN_STEPS, start=start,
                variants={name: dict(overrides=STEP + extra, draws=draws) for name, extra in STEP_VARIANTS.items()})
    one = JOBS["diffusion_steps"](spec)
    ranks = _ok(run_ranks("diffusion_steps", spec, tmp))
    return dict(jax=dict(losses=losses, params=flat(state.params), ema=flat(state.ema_params)), one=one,
                ranks=ranks, start=start)


@pytest.mark.parametrize("variant", list(STEP_VARIANTS))
def test_two_rank_train_steps_equal_one_process_and_jax(step_runs, variant):
    """Each rank trains on 2 of the 4 rows under DDP; the loss is the mean
    over the ranks; losses, parameters and EMA as in one process, and
    without accumulation as in JAX.  With accumulate_steps=2 every
    micro-step's gradients are all-reduced before they enter the optimizer's
    accumulator (no ``no_sync``), so the one update is the 1-process one."""
    one = step_runs["one"][variant]
    r0, r1 = (r[variant] for r in step_runs["ranks"])
    assert r0["rows"] == r1["rows"] == BATCH // 2 and one["rows"] == BATCH
    assert r0["train_net"] == "DistributedDataParallel" and one["train_net"] == "DenoisingModel"
    want = step_runs["jax"]["losses"] if variant == "plain" else [None] * N_STEPS
    for i, (a, b, c, w) in enumerate(zip(r0["losses"], r1["losses"], one["losses"], want)):
        assert a == pytest.approx(b, rel=1e-6), f"step {i}: the ranks' losses differ"
        assert a == pytest.approx(c, rel=1e-5), f"step {i}: 2 ranks vs 1 process"
        if w is not None:
            assert a == pytest.approx(w, rel=1e-5), f"step {i}: 2 ranks vs JAX"
    start = step_runs["start"]
    for which in ("params", "ema"):
        # The same all-reduced gradients on the same parameters: bit-equal.
        assert all(np.array_equal(r1[which][k], v) for k, v in r0[which].items()), which
        _assert_changes_close(r0[which], one[which], start, F32, f"{variant} {which}: 2 ranks vs 1 process")
        if variant == "plain":
            _assert_changes_close(r0[which], step_runs["jax"][which], start, F32, f"{which}: 2 ranks vs JAX")
    if variant != "plain":
        assert not np.array_equal(r0["params"]["decode_out.weight"], start["decode_out.weight"])


# ---- the baselines' steps ------------------------------------------------------------

# RAdam at learning rate 0.5: its first updates follow the gradient, so a
# step moves every parameter far above its f32 rounding (Adam's would
# normalise a vanishing gradient's rounding up to the learning rate).
FAMILIES = {
    "dilresnet": ["model=dilresnet", "model.N=1", "model.hidden_dim=8", "model.training_noise_std=1e-2"],
    "tfnet": ["model=tfnet", "model.context_window=2", "model.temporal_filtering_length=2",
              "model.unroll_steps=2", "model.batch_size=2"],
}
RADAM = ["model.optimizer=radam", "model.learning_rate=0.5", "model.lr_decay=exp", "model.min_learning_rate=5e-3"]


@pytest.fixture(scope="module")
def family_runs(tiny_root, tmp_path_factory):  # noqa: F811
    """Both baselines' 2 steps in one process and on 2 ranks."""
    tmp = tmp_path_factory.mktemp("dist-families")
    spec = dict(runs={family: base_overrides(tiny_root, tmp / family, *extra, *RADAM)
                      for family, extra in FAMILIES.items()}, steps=2)
    return JOBS["family_steps"](spec), _ok(run_ranks("family_steps", spec, tmp))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_two_rank_baseline_steps_equal_one_process(family_runs, family):
    """Two steps from the factory's batches (2 or 4 rows, half a rank) with
    the input noise cut from one global draw: losses and parameters as in
    one process; DilResNet's delta statistics are the global batch's.
    TF-Net's net runs twice a step under DDP (its 2-step unroll) and its
    BatchNorm statistics, trained parameters, are averaged like the rest."""
    one, (r0, r1) = family_runs[0][family], (r[family] for r in family_runs[1])
    batch = one["batch_size"]
    assert one["rows"] == [batch, batch] and r0["rows"] == r1["rows"] == [batch // 2, batch // 2]
    assert r1["losses"] == pytest.approx(r0["losses"], rel=1e-6)
    assert r0["losses"] == pytest.approx(one["losses"], rel=1e-5)
    # The same all-reduced gradients on the same parameters: bit-equal.
    assert all(np.array_equal(r1["params"][k], v) for k, v in r0["params"].items())
    _assert_changes_close(r0["params"], one["params"], one["start"], F32, family)
    if family == "dilresnet":
        np.testing.assert_allclose(r0["dx_mean"], one["dx_mean"], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(r0["dx_var"], one["dx_var"], rtol=1e-5)
        assert np.array_equal(r1["dx_var"], r0["dx_var"])


# ---- sharded validation ------------------------------------------------------------------

VAL = ["model.ema_decay=0.9", "data.val_samples=2", "data.eval_batch_size=2", "trainer.use_wandb=false",
       "data.cell_bucket=0", "data.buffer_pool=false", "data.device_prefetch=false"]


@pytest.fixture(scope="module")
def val_root(tmp_path_factory):
    """3 val cases (and 1 train case) of 8 frames at 16x8x8 cells, written
    by the JAX package."""
    root = tmp_path_factory.mktemp("dist-val") / "data"
    j_generate_dataset(root, n_train_cases=1, n_val_cases=3, n_test_cases=0, n_frames=8, cell_counts=(16, 8, 8),
                       seed=0)
    return root


@pytest.fixture(scope="module")
def val_runs(val_root, tmp_path_factory):
    """JAX's single-process ``Trainer.validate``, the port's in one process
    and on 2 ranks with ``data.shard_eval=true``, from the same parameters
    and JAX's draws."""
    tmp = tmp_path_factory.mktemp("dist-val-runs")
    args = base_overrides(val_root, tmp / "jax", *VAL)
    jcfg = jconfig.parse_cli_overrides(args).resolved()
    jdm, jtask = j_instantiate(jcfg)
    batches = list(jdm.val_batches())
    params = jax.jit(jtask.net.init)(jax.random.PRNGKey(0), jnp.zeros((1, *batches[0].grid.shape, 4)),
                                     jnp.zeros((1,), jnp.int32), batches[0].grid.cell_types)
    state = DiffusionState.create(apply_fn=jtask.net.apply, params=params, tx=jtask.tx,
                                  ema_params=jax.tree_util.tree_map(jnp.copy, params))
    jmetrics = jloop.Trainer(jcfg, jtask, jdm, use_wandb=False).validate(
        state, jax.random.PRNGKey(jcfg.trainer.seed), expensive=False)

    cfg = tconfig.parse_cli_overrides(args).resolved()
    shapes = {b.grid.shape for b in batches}
    assert len(shapes) == 1
    eval_shape = (2, *shapes.pop(), 4)
    replay = JaxDraws(cfg.trainer.seed, None, eval_shape, cfg.model)
    keys = [("diagnostics", 10_000)] + [("val", 10_000, b.metadata.case_name, 0) for b in batches]
    draws = {key: replay(*key).draws for key in keys}
    start = {k: v.numpy() for k, v in torch_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params)).items()}
    spec = dict(start=start, draws=draws,
                overrides=base_overrides(val_root, tmp / "port", *VAL, "data.shard_eval=true",
                                         f"trainer.samples_root={tmp / 'samples'}"))
    ranks = _ok(run_ranks("validate", spec, tmp))
    one = JOBS["validate"](dict(spec, overrides=base_overrides(val_root, tmp / "one", *VAL)))
    return dict(jax=jmetrics, one=one, ranks=ranks, cases={b.metadata.case_name for b in batches})


def test_sharded_validation_splits_the_cases(val_runs):
    """Each rank samples its own cases into its own store file; together
    they cover the 3 val cases once."""
    r0, r1 = val_runs["ranks"]
    assert (r0["store_file"], r1["store_file"]) == ("val-samples.npyd", "val-samples.rank1.npyd")
    cases0, cases1 = set(r0["store_cases"]), set(r1["store_cases"])
    assert cases0 and cases1 and not cases0 & cases1
    assert cases0 | cases1 == val_runs["cases"] == set(val_runs["one"]["store_cases"])


def test_sharded_validation_merges_to_the_single_process_metrics(val_runs):
    """Both ranks end with the same merged metrics (the per-case values and
    the diagnostics of the one rank that owns the first case), equal to the
    port's single-process validation and to JAX's."""
    r0, r1 = (r["metrics"] for r in val_runs["ranks"])
    one, jm = val_runs["one"]["metrics"], val_runs["jax"]
    m0, m1 = _rank0_only(r0), _rank0_only(r1)
    assert m0.keys() == m1.keys() == _rank0_only(one).keys()
    assert {f"val/{case}/tke" for case in val_runs["cases"]} <= m0.keys() and "val/eps-loss-ema-t3" in m0
    # 16 cells along x: the TKE profile behind x = 24 is the outlet's padding
    # plane alone, 0 everywhere, so the port reports max-mean-tke-pos as
    # undefined (NaN) on every rank, where JAX takes the argmax of zeros.
    undefined = {k for k in m0 if k.endswith("max-mean-tke-pos")}
    assert len(undefined) == len(val_runs["cases"]) + 1
    for k in m0:
        if k in undefined:
            assert math.isnan(m0[k]) and math.isnan(m1[k]) and math.isnan(one[k]) and math.isfinite(jm[k]), k
            continue
        assert m1[k] == pytest.approx(m0[k], **RANK_REL), k
        assert m0[k] == pytest.approx(one[k], **ONE_PROCESS_REL), k
    assert _rank0_only(jm).keys() == m0.keys()
    for k in m0.keys() - undefined:
        assert m0[k] == pytest.approx(jm[k], **ONE_PROCESS_REL), k


def test_a_failing_rank_fails_every_rank(val_root, tmp_path):
    """Rank 1's ground truth is missing: its error travels through the
    merge, so both ranks raise (rank 0 naming another rank) and neither
    waits for the other."""
    spec = dict(overrides=base_overrides(val_root, tmp_path / "run", *VAL, "data.shard_eval=true"),
                fail_rank=1, missing_dir=str(tmp_path / "missing"))
    (c0, out0, log0), (c1, out1, log1) = run_ranks("validate", spec, tmp_path, timeout_s=120)
    assert c0 == 1 and c1 == 1, (log0[-3000:], log1[-3000:])
    assert "failed on another rank" in out0["error"]
    assert "no data.npyd or data.h5" in out1["error"] and "another rank" not in out1["error"]


# ---- the entry point and host sharding ---------------------------------------------------


def _train_cli(args, env_extra, tmp_path, name):
    env = {k: v for k, v in os.environ.items() if not k.startswith("GT_DIST")}
    env.update(OMP_NUM_THREADS="2", **env_extra)
    log = open(tmp_path / f"{name}.log", "w+")
    proc = subprocess.Popen([sys.executable, "-m", "generative_turbulence_tpu_torch.train", "--device", "cpu", *args],
                            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
    return proc, log


def test_train_entry_point_on_two_ranks(tiny_root, tmp_path):  # noqa: F811
    """``python -m generative_turbulence_tpu_torch.train`` on 2 ranks
    (``GT_DIST_*``), 1 epoch with ``data.shard_eval=true`` (rank 1 owns no
    val case): rank 0 alone writes the run files (rank 1 is given its own
    out_dir, which stays empty of them), its checkpoint names the bare
    net's parameters and loads into a 1-process task, and the parameters
    equal a 1-process run's."""
    common = ["trainer.log_every_n_steps=1", "data.shard_eval=true"]
    shared = f"trainer.samples_root={tmp_path / 'samples'}"
    runs = {"rank0": base_overrides(tiny_root, tmp_path / "rank0", *common, shared),
            "rank1": base_overrides(tiny_root, tmp_path / "rank1", *common, shared),
            "one": base_overrides(tiny_root, tmp_path / "one", *common)}
    dist_env = dict(GT_DIST_NUM_PROCESSES="2", GT_DIST_COORDINATOR=f"file://{tmp_path / 'rendezvous'}")
    procs = [_train_cli(runs["rank0"], dict(dist_env, GT_DIST_PROCESS_ID="0"), tmp_path, "rank0"),
             _train_cli(runs["rank1"], dict(dist_env, GT_DIST_PROCESS_ID="1"), tmp_path, "rank1"),
             _train_cli(runs["one"], {}, tmp_path, "one")]
    logs = []
    try:
        for proc, log in procs:
            code = proc.wait(timeout=150)
            log.seek(0)
            logs.append(log.read())
            assert code == 0, logs[-1][-4000:]
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    assert "[rank 0/2] device cpu, backend gloo" in logs[0] and "[rank 1/2]" in logs[1]
    assert "final val/tke: " in logs[0]
    rank1 = tmp_path / "rank1"
    assert not (rank1 / "metrics.jsonl").exists() and not (rank1 / "summary.json").exists()
    assert not (rank1 / "checkpoints").exists()
    # The one val case is rank 0's: rank 1 samples nothing.
    assert sorted(p.name for p in (tmp_path / "samples").iterdir()) == ["val-samples.npyd"]
    lines = {name: (tmp_path / name / "metrics.jsonl").read_text().splitlines() for name in ("rank0", "one")}
    assert len(lines["rank0"]) == len(lines["one"]) == 3  # 2 steps and the validation
    loss = lambda line: json.loads(line)["train/loss"]  # noqa: E731
    for a, b in zip(lines["rank0"][:2], lines["one"][:2]):
        assert loss(a) == pytest.approx(loss(b), rel=1e-5)

    got = CheckpointManager(tmp_path / "rank0" / "checkpoints").restore("last")
    want = CheckpointManager(tmp_path / "one" / "checkpoints").restore("last")
    assert got["step"] == want["step"] == 2 and not any(k.startswith("module.") for k in got["net"])
    config = tconfig.parse_cli_overrides(runs["one"]).resolved()
    _, task = instantiate_data_and_task(config, "cpu")
    task.init_weights(torch.Generator().manual_seed(config.trainer.seed))
    start = {k: v.numpy().copy() for k, v in task.net.state_dict().items()}
    numpy = lambda sd: {k: v.numpy() for k, v in sd.items()}  # noqa: E731
    _assert_changes_close(numpy(got["net"]), numpy(want["net"]), start, F32, "2-rank entry point vs 1 process")
    task.load_state_dict(got)
    assert task.step == 2 and all(torch.equal(task.net.state_dict()[k], v) for k, v in got["net"].items())


def test_host_sharding_takes_the_shortest_shard(tmp_path):
    """``data.shard_by_host`` over 2 ranks with 3 train cases: rank 0 reads
    2 cases (4 batches of 4), rank 1 one (2 batches).  Both take 2 steps
    per epoch, and the learning-rate schedule spans 2 updates on both; a
    rank that took 4 would wait in the all-reduce past the deadline."""
    root = generate_synthetic_dataset(tmp_path / "data", n_train_cases=3, n_val_cases=1, n_test_cases=0,
                                      n_frames=8, cell_counts=(10, 6, 6), seed=4, format="npyd")
    spec = dict(overrides=base_overrides(root, tmp_path / "run", "data.shard_by_host=true", "data.val_samples=1",
                                         "data.eval_batch_size=1"))
    r0, r1 = _ok(run_ranks("fit", spec, tmp_path))
    assert len(r0["train_files"]) == 2 and len(r1["train_files"]) == 1
    assert not set(r0["train_files"]) & set(r1["train_files"])
    assert r0["n_train_batches"] == r1["n_train_batches"] == 2 and r0["step"] == r1["step"] == 2
    m = tconfig.parse_cli_overrides(spec["overrides"]).resolved().model
    want = build_optimizer(optimizer=m.optimizer, learning_rate=m.learning_rate, min_learning_rate=m.min_learning_rate,
                           lr_decay=m.lr_decay, max_train_steps=2).learning_rate
    assert r0["learning_rates"] == r1["learning_rates"] == [want(i) for i in range(4)]
