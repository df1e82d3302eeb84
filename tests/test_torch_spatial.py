"""The spatial axis: ``trainer.mesh_shape=(dp, sp)`` with each grid's x
sharded over groups of sp ranks, against the port in one process and the
JAX package's single-device task, at the sizes of tests/test_parallel.py
(dim 8, 1 U-Net level, T = 5, batch 4, 24x10x10 cells padded 26x12x12).

One module-scoped gloo group of 4 ranks on the CPU (``tests/_torch_spatial_worker.py``,
one thread a rank) runs every job, at the meshes (2, 2) (two sp groups of
2) and (1, 4) (three halo boundaries, as in JAX's (2, 4)); the inputs and
the draws are seeded numpy arrays, the weights JAX's, carried by
``toolchain/from_flax.py``.

Tolerances: the modules sharded against unsharded in f32 at rtol 2e-4 /
atol 2e-5 (tests/test_pallas_kernels.py:29), forward and gradients; a train
step's loss within rel 2e-4 of JAX's single-device ``training_step`` and its
first leaf within rtol 2e-4 / atol 2e-6 (tests/test_parallel.py:78-83), its
gradients against the 1-process port's by test_torch_train.py's f32 rule;
samples against the 1-process port at rtol 2e-4 / atol 2e-5 and against
JAX's at test_torch_task.py's sampler tolerance, both in units of the
output's normalized scale."""

import json
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
from generative_turbulence_tpu.data.variables import Variable as JVariable
from generative_turbulence_tpu.training import config as jconfig
from generative_turbulence_tpu.training.diffusion_task import DiffusionState
from generative_turbulence_tpu.training.diffusion_task import DiffusionTask as JDiffusionTask
from generative_turbulence_tpu_torch import graft_entry
from generative_turbulence_tpu_torch.data import grid as tgrid
from generative_turbulence_tpu_torch.data.schema import FieldStats
from generative_turbulence_tpu_torch.data.schema import read_metadata
from generative_turbulence_tpu_torch.data.synthetic import build_case
from generative_turbulence_tpu_torch.data.variables import Variable, stack_channels
from generative_turbulence_tpu_torch.models.blocks import Conv3d, GroupNorm, VoxelAttention
from generative_turbulence_tpu_torch.ops import cuda_kernels as ck
from generative_turbulence_tpu_torch.ops.interp import resize_trilinear
from generative_turbulence_tpu_torch.parallel.spatial import x_slab
from generative_turbulence_tpu_torch.toolchain.from_flax import torch_state_dict_from_flax
from generative_turbulence_tpu_torch.training import config as tconfig
from generative_turbulence_tpu_torch.training.checkpoint import CheckpointManager
from generative_turbulence_tpu_torch.training.diffusion_task import DiffusionTask
from generative_turbulence_tpu_torch.training.factory import instantiate_data_and_task
from _torch_spatial_worker import REPO, SpatialPool
from test_torch_diffusion import Replay, jax_normals
from test_torch_loop import base_overrides, tiny_root  # noqa: F401  (the module's tiny_root fixture)
from test_torch_losses import ReplayDraws, jax_loss_draws
from test_torch_task import field_stats
from test_torch_train import F32, _assert_changes_close

MESHES = [(2, 2), (1, 4)]
CASE = dict(cell_counts=(24, 10, 10), seed=0)  # tests/conftest.py's synthetic_root, padded 26x12x12
BATCH = 4
STEP = ["model=diffusion", "model.dim=8", "model.u_net_levels=1", "model.timesteps=5"]
SAMPLE = ["model=diffusion", "model.dim=8", "model.u_net_levels=1", "model.timesteps=4", "model.sampler=ddim",
          "model.ddim_steps=2"]
TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    ranks = SpatialPool(tmp_path_factory.mktemp("spatial_pool"), world=4)
    yield ranks
    ranks.close()


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX case file and grid map, the port's grid map, the 4 frames as
    one batch of cells, their stats."""
    file = j_generate_case(tmp_path_factory.mktemp("spatial") / "case", n_frames=BATCH, **CASE)
    jgm = jgrid.GridMap.from_metadata(j_read_metadata(file), (JVariable.U, JVariable.P), cached=False)
    tgm = tgrid.GridMap.from_metadata(read_metadata(file), (Variable.U, Variable.P), device="cpu")
    _, fields = build_case(n_frames=BATCH, **CASE)
    cells = stack_channels(fields, (Variable.U, Variable.P))
    return file, jgm, tgm, cells, field_stats(fields)


def _jax_task(overrides, stats, jgm, root):
    cfg = jconfig.parse_cli_overrides(overrides).model
    task = JDiffusionTask(cfg, JFieldStats(stats), root, root / "samples")
    params = task.net.init(jax.random.PRNGKey(0), jnp.zeros((1, *jgm.shape, 4)), jnp.zeros((1,), jnp.int32),
                           jgm.cell_types)
    return task, jax.tree_util.tree_map(np.asarray, params)


def _port_start(params):
    return {k: v.numpy().copy() for k, v in torch_state_dict_from_flax(params).items()}


def _rng(seed=0):
    return np.random.default_rng(seed)


# ---- the layout and the collectives ----------------------------------------------------------


def test_x_slab_is_contiguous_and_uneven():
    assert [x_slab(97, j, 2) for j in range(2)] == [(0, 49), (49, 97)]
    assert [x_slab(13, j, 4) for j in range(4)] == [(0, 4), (4, 7), (7, 10), (10, 13)]
    assert [x_slab(13, j, 2) for j in range(2)] == [(0, 7), (7, 13)]


@pytest.mark.parametrize("mesh", MESHES)
def test_round_trip_and_halo_exchange_preserve_values(pool, mesh):
    """The counterpart of test_constrain_dense_preserves_values at X = 13
    over 2 and over 4: ``slab_of`` -> ``gather_x`` gives x back on every
    rank; the halo planes are the neighbours' edge planes (none at the
    global edges); the exchange's gradient lands on the planes' owners."""
    x = _rng(1).normal(size=(2, 13, 5, 4, 3)).astype(np.float32)
    weights = _rng(2).normal(size=(4, 2, 2, 5, 4, 3)).astype(np.float32)  # per sp rank: (B, lo|hi, Y, Z, C)
    results = pool.run("exchange", {"mesh": mesh, "x": x, "weights": weights})
    sp = mesh[1]
    for rank, r in enumerate(results):
        j = r["sp_index"]
        assert (r["dp_index"], j) == (rank // sp, rank % sp)
        np.testing.assert_array_equal(r["whole"], x)
        s, e = r["slab"]
        assert (s, e) == x_slab(13, j, sp)
        np.testing.assert_array_equal(r["lo"], x[:, s - 1 : s] if s > 0 else x[:, :0])
        np.testing.assert_array_equal(r["hi"], x[:, e : e + 1] if e < 13 else x[:, :0])
        want = np.zeros((2, e - s, 5, 4, 3), np.float32)
        if j + 1 < sp:  # the right neighbour's lo halo is this slab's last plane
            want[:, -1] += weights[j + 1, :, 0]
        if j > 0:  # the left neighbour's hi halo is this slab's first plane
            want[:, 0] += weights[j - 1, :, 1]
        np.testing.assert_allclose(r["grad"], want, rtol=1e-6, atol=1e-6)


def _module_case(kind, rng):
    """(case spec for the worker, unsharded fn, its parameter leaves)."""
    C = 6
    x = rng.normal(size=(2, 13, 5, 4, C)).astype(np.float32) + 0.5
    if kind == "conv3d":
        module = Conv3d(C, 5)
        module.reset_parameters(torch.Generator().manual_seed(0))
        return dict(kind=kind, x=x, features=5, params=_state(module)), module, module.named_parameters()
    if kind == "groupnorm":
        module = GroupNorm(C, 2)
        with torch.no_grad():
            module.weight.copy_(torch.from_numpy(1 + 0.3 * rng.normal(size=C).astype(np.float32)))
            module.bias.copy_(torch.from_numpy(0.3 * rng.normal(size=C).astype(np.float32)))
        return dict(kind=kind, x=x, groups=2, params=_state(module)), module, module.named_parameters()
    if kind == "attention":
        module = VoxelAttention(C, heads=2, dim_head=8, kind="full")
        for m in (module.to_qkv, module.to_out):
            m.reset_parameters(torch.Generator().manual_seed(1))
        return dict(kind=kind, x=x, params=_state(module)), module, module.named_parameters()
    if kind in ("chain", "kernel-chain"):
        Fo = 8
        shapes = [((3, 3, 3, C, Fo), 0.2), ((Fo,), 0.1), ((Fo,), 0.1), ((Fo,), 0.1), ((2, Fo), 0.2), ((2, Fo), 0.2),
                  ((3, 3, 3, Fo, Fo), 0.2), ((Fo,), 0.1), ((Fo,), 0.1), ((Fo,), 0.1)]
        args = [(rng.normal(size=s) * sc).astype(np.float32) for s, sc in shapes]
        args[2] += 1
        args[8] += 1
        if kind == "kernel-chain":
            fn = lambda t: ck.kernel_chain(t, *map(torch.from_numpy, args), num_groups=2, eps=1e-5)  # noqa: E731
            return dict(kind=kind, x=x, groups=2, args=args), fn, []
        tensors = [torch.from_numpy(a).requires_grad_() for a in args]
        fn = lambda t: ck.fused_double_conv_block(t, *tensors, 2, 1e-5)  # noqa: E731
        return dict(kind=kind, x=x, groups=2, args=args), fn, [(f"arg{i}", t) for i, t in enumerate(tensors)]
    if kind in ("resize", "resize-97"):
        sizes = [(6, 3, 3), (13, 5, 4)] if kind == "resize" else [(48, 3, 3), (97, 5, 4)]
        if kind == "resize-97":
            x = rng.normal(size=(1, 97, 5, 4, 2)).astype(np.float32)

        def fn(t):
            for size in sizes:
                t = resize_trilinear(t, size)
            return t

        return dict(kind="resize", x=x, sizes=sizes), fn, []
    raise ValueError(kind)


def _state(module):
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


@pytest.mark.parametrize("kind", ["conv3d", "groupnorm", "chain", "kernel-chain", "resize", "resize-97", "attention"])
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_module_equals_unsharded(pool, mesh, kind):
    """Each module on x slabs (sp = 2, 4) against the unsharded module: the
    gathered output, the gathered input gradient and each parameter's
    gradient summed over the sp group, of sum(out * cotangent).  The chain
    is the plain chain with halos (a CPU tensor); the kernel chain its three
    kernels' plain steps with the halo planes exchanged between them and the
    moments summed (forward only, bf16); the resizes are
    13 -> 6 -> 13 and 97 -> 48 -> 97 along x (uneven splits, more than one
    fetched plane)."""
    rng = _rng(3)
    spec, fn, leaves = _module_case(kind, rng)
    if kind == "kernel-chain":
        # The kernels' plain steps (no autograd): bf16 outputs, where a sum
        # taken in another order may round one unit the other way, twice.
        want = fn(torch.from_numpy(spec["x"])).float().numpy()
        for r in pool.run("modules", {"mesh": mesh, "cases": {kind: spec}}):
            np.testing.assert_allclose(r[kind]["out"], want, rtol=1e-2, atol=1e-2)
        return
    xt = torch.from_numpy(spec["x"]).requires_grad_()
    out = fn(xt)
    spec["cotangent"] = rng.normal(size=out.shape).astype(np.float32)
    (out * torch.from_numpy(spec["cotangent"])).sum().backward()
    want_params = {name: p.grad.numpy() for name, p in leaves}
    results = pool.run("modules", {"mesh": mesh, "cases": {kind: spec}})
    for r in results:
        got = r[kind]
        np.testing.assert_allclose(got["out"], out.detach().numpy(), **TOL)
        np.testing.assert_allclose(got["grad"], xt.grad.numpy(), **TOL)
        assert got["params"].keys() == want_params.keys()
        for name, want in want_params.items():
            np.testing.assert_allclose(got["params"][name], want, **TOL, err_msg=name)


# ---- the train step and the sampler ----------------------------------------------------------


@pytest.fixture(scope="module")
def jax_step(case, tmp_path_factory):
    """JAX's single-device ``training_step`` from its init at PRNGKey(0),
    with PRNGKey(7): the start, the loss, the new parameters; and the
    1-process port's step from the same start and draws."""
    file, jgm, tgm, cells, stats = case
    jtask, params = _jax_task(STEP, stats, jgm, tmp_path_factory.mktemp("jax_step"))
    state = DiffusionState.create(apply_fn=jtask.net.apply, params=params, tx=jtask.tx, ema_params=None)
    rng = jax.random.PRNGKey(7)
    batch = type("Batch", (), {"cells": jnp.asarray(cells), "grid": jgm})()
    state, metrics = jtask.training_step(state, batch, rng)
    draws = jax_loss_draws(rng, (BATCH, *tgm.shape, 4), jtask.cfg.timesteps)
    task = DiffusionTask(tconfig.parse_cli_overrides(STEP).model, FieldStats(stats), "cpu")
    task.load_flax_params(params)
    one_loss = float(task.training_step(torch.from_numpy(cells), tgm, ReplayDraws(draws))["train/loss"])
    return dict(start=params, loss=float(metrics["train/loss"]), params=jax.tree_util.tree_map(np.asarray, state.params),
                draws=draws, one_loss=one_loss,
                one_grads={n: p.grad.numpy().copy() for n, p in task.net.named_parameters()})


def _first_leaf_name(params):
    """The port's name of ``jax.tree_util.tree_leaves(params)[0]``."""
    marked = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [np.full(np.shape(leaf), i, np.float32) for i, leaf in enumerate(jax.tree_util.tree_leaves(params))])
    return next(k for k, v in torch_state_dict_from_flax(marked).items() if not v.any())


@pytest.mark.parametrize("mesh", MESHES)
def test_train_step_matches_jax_single_device(pool, case, jax_step, mesh):
    """One ``training_step`` at (2, 2) and (1, 4): the all-reduced loss on
    every rank within rel 2e-4 of JAX's single-device step, the first leaf
    within rtol 2e-4 / atol 2e-6; every rank's gradient (DDP's mean over
    the world of sp x each rank's share) equal to the 1-process port's, so
    no factor of sp is lost or gained; the parameters equal on every rank."""
    file, _, _, cells, stats = case
    spec = dict(mesh=mesh, overrides=STEP, stats=stats, start=_port_start(jax_step["start"]), case_file=str(file),
                cells=cells, draws=jax_step["draws"])
    results = pool.run("train_step", spec)
    first = _first_leaf_name(jax_step["params"])
    want_first = torch_state_dict_from_flax(jax_step["params"])[first].numpy()
    zeros = {k: np.zeros_like(v) for k, v in jax_step["one_grads"].items()}
    for r in results:
        assert r["train_net"] == "DistributedDataParallel"
        assert r["loss"] == pytest.approx(jax_step["loss"], rel=2e-4)
        assert r["loss"] == pytest.approx(jax_step["one_loss"], rel=2e-4)
        np.testing.assert_allclose(r["params"][first], want_first, rtol=2e-4, atol=2e-6)
        _assert_changes_close(r["grads"], jax_step["one_grads"], zeros, F32, f"gradients at {mesh}")
        for name, value in r["params"].items():
            np.testing.assert_array_equal(value, results[0]["params"][name], err_msg=name)


def test_ddim_sampling_matches_one_process_and_jax(pool, case, tmp_path):
    """DDIM-2 at (2, 2): each dp group samples its 2 rows on x slabs and
    gathers; the samples equal the 1-process port's and JAX's ``sample``
    with the same draws."""
    file, jgm, tgm, cells, stats = case
    jtask, params = _jax_task(SAMPLE, stats, jgm, tmp_path)
    rng = jax.random.PRNGKey(11)
    want = np.asarray(jtask._sample_fn(params, jnp.asarray(cells), jgm, rng))
    draws = jax_normals(rng, (BATCH, *tgm.shape, 4), 2, True)
    task = DiffusionTask(tconfig.parse_cli_overrides(SAMPLE).model, FieldStats(stats), "cpu")
    task.load_flax_params(params)
    one = task.sample(torch.from_numpy(cells), tgm, Replay(draws)).numpy()
    results = pool.run("sample", dict(mesh=(2, 2), overrides=SAMPLE, stats=stats, start=_port_start(params),
                                      case_file=str(file), cells=cells, draws=draws))
    rows = {}
    for r in results:
        d = r["dp_index"]
        if d in rows:
            np.testing.assert_array_equal(r["samples"], rows[d])  # the sp ranks of a group agree
        rows[d] = r["samples"]
    got = np.concatenate([rows[0], rows[1]])
    std = task.normalizer.std
    scale = np.abs(want / std).max()
    np.testing.assert_allclose(got / std / scale, one / std / scale, **TOL)
    np.testing.assert_allclose(got / std / scale, want / std / scale, rtol=1e-3, atol=1e-4)


# ---- the Trainer through the entry point --------------------------------------------------


def _train_cli(args, env_extra, tmp_path, name):
    env = {k: v for k, v in os.environ.items() if not k.startswith("GT_DIST")}
    env.update(OMP_NUM_THREADS="1", **env_extra)
    log = open(tmp_path / f"{name}.log", "w+")
    proc = subprocess.Popen([sys.executable, "-m", "generative_turbulence_tpu_torch.train", "--device", "cpu", *args],
                            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
    return proc, log


def test_trainer_at_mesh_1x2_matches_one_process(tiny_root, tmp_path):  # noqa: F811
    """``python -m generative_turbulence_tpu_torch.train`` with
    ``trainer.mesh_shape=[1,2]`` on 2 ranks: one epoch (2 steps) and a
    DDIM-2 validation with the grid's x over the two ranks; the losses, the
    validation metrics and the parameters equal a 1-process run's."""
    common = ["trainer.log_every_n_steps=1"]
    runs = {"rank0": base_overrides(tiny_root, tmp_path / "rank0", *common, "trainer.mesh_shape=[1,2]"),
            "rank1": base_overrides(tiny_root, tmp_path / "rank1", *common, "trainer.mesh_shape=[1,2]"),
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
    assert "[rank 0/2] mesh (1, 2): dp 0, sp 0" in logs[0] and "[rank 1/2] mesh (1, 2): dp 0, sp 1" in logs[1]
    lines = {name: [json.loads(line) for line in (tmp_path / name / "metrics.jsonl").read_text().splitlines()]
             for name in ("rank0", "one")}
    assert len(lines["rank0"]) == len(lines["one"]) == 3  # 2 steps and the validation
    for a, b in zip(lines["rank0"][:2], lines["one"][:2]):
        assert a["train/loss"] == pytest.approx(b["train/loss"], rel=2e-4)
    val, val_one = lines["rank0"][2], lines["one"][2]
    assert val.keys() == val_one.keys()
    for k, v in val_one.items():
        if isinstance(v, float) and k.startswith("val/") and not k.endswith("max-mean-tke-pos"):
            assert val[k] == pytest.approx(v, rel=1e-3, abs=1e-6), k
    got = CheckpointManager(tmp_path / "rank0" / "checkpoints").restore("last")
    want = CheckpointManager(tmp_path / "one" / "checkpoints").restore("last")
    config = tconfig.parse_cli_overrides(runs["one"]).resolved()
    _, task = instantiate_data_and_task(config, "cpu")
    task.init_weights(torch.Generator().manual_seed(config.trainer.seed))
    start = {k: v.numpy().copy() for k, v in task.net.state_dict().items()}
    numpy = lambda sd: {k: v.numpy() for k, v in sd.items()}  # noqa: E731
    _assert_changes_close(numpy(got["net"]), numpy(want["net"]), start, F32, "mesh (1, 2) vs 1 process")


# ---- the check entry points -----------------------------------------------------------------


def test_graft_entry_matches_jax_entry():
    """``graft_entry.entry()``: the epsilon-network at ``__graft_entry__``'s
    shapes, with JAX ``entry()``'s parameters carried over, gives its
    forward (last axis 4) on the same inputs."""
    sys.path.insert(0, str(REPO))
    import __graft_entry__ as jentry

    jfn, (params, x, t) = jentry.entry()
    want = np.asarray(jax.jit(jfn)(params, x, t))
    fn, (x_t, t_t) = graft_entry.entry("cpu", params=jax.tree_util.tree_map(np.asarray, params))
    assert x_t.shape == x.shape and t_t.shape == t.shape
    got = fn(torch.from_numpy(np.array(x)), torch.from_numpy(np.array(t)).long()).numpy()
    assert got.shape[-1] == 4 and got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_dryrun_multichip_runs_at_the_jax_mesh(capfd):
    """``dryrun_multichip(4)`` on the CPU: 4 gloo ranks at (2, 2), one
    training step, rank 0's line as the JAX package prints it."""
    graft_entry.dryrun_multichip(4, device="cpu")
    out = capfd.readouterr().out
    assert "dryrun_multichip ok: mesh=(2x2) devices=4 loss=" in out, out
