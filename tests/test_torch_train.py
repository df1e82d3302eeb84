"""The training slice as a whole: the JAX package's ``DiffusionTask.train_step``
and the port's ``DiffusionTask.training_step``, built from the same
``ModelConfig`` (2 U-Net levels, dim 8, T = 20, RAdam with exp decay, clip
0.1, EMA 0.9), started from the same converted parameters and fed the same
draws (JAX's t and noise, replayed), over 3 steps with and without gradient
accumulation, in f32 and bf16.  Then ``eval_diagnostics`` and the EMA
``sample`` against JAX's after those steps, remat against no remat, and a
checkpoint round trip.

The learning rate is raised to 0.5 (exp decay to 5e-3 over 10 updates), so
that a step moves every parameter far above its f32 rounding.  Tolerances,
per leaf, on the change from the starting parameters and on gradients:
f32 rtol 2e-4 with atol 2e-5 x the leaf's max |change| (the JAX tests' f32
tolerance); bf16 rtol 0.06 with atol 0.03 x the leaf's max |change|, and a
correlation > 0.999 over all leaves (ROADMAP's bf16 rule).  A leaf whose
gradient vanishes analytically (a conv bias before a GroupNorm of one
channel per group) holds rounding noise only; every leaf's atol therefore
also has a floor of 1e-6 (f32) or 0.03 (bf16, the rule's atol) x the
largest |change| of all leaves, plus the f32 rounding of the updated
parameter (one unit in the last place of the leaf's largest value per
step).  In bf16 each element's atol also takes the reference's own bf16
error there, |JAX bf16 change - JAX f32 change|: JAX's bf16 gradient of
``encode_x.bias`` (a sum over every voxel) moves one element by -0.00139
where the port's bf16 and f32 steps both move it by -0.00204.  Losses: f32 rtol 2e-4 / atol 2e-5; bf16 rtol 0.06 / atol 0.03."""

import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_turbulence_tpu.data.schema import FieldStats as JFieldStats
from generative_turbulence_tpu.training import config as jconfig
from generative_turbulence_tpu.training.diffusion_task import DiffusionState
from generative_turbulence_tpu.training.diffusion_task import DiffusionTask as JDiffusionTask
from generative_turbulence_tpu_torch.data.schema import FieldStats
from generative_turbulence_tpu_torch.diffusion.gaussian import GeneratorNoise
from generative_turbulence_tpu_torch.toolchain.from_flax import torch_state_dict_from_flax
from generative_turbulence_tpu_torch.training import config as tconfig
from generative_turbulence_tpu_torch.training.checkpoint import CheckpointManager
from generative_turbulence_tpu_torch.training.diffusion_task import DiffusionTask
from test_torch_diffusion import Replay, jax_normals
from test_torch_losses import ReplayDraws, jax_loss_draws
from test_torch_task import OVERRIDES, case  # noqa: F401  (the module's case fixture)

TRAIN = OVERRIDES + [
    "model.ema_decay=0.9", "model.sampler=ddim", "model.learning_rate=0.5", "model.min_learning_rate=5e-3",
]
MAX_TRAIN_STEPS = 10
N_STEPS = 3
F32 = dict(rtol=2e-4, atol_rel=2e-5, floor_rel=1e-6, loss=dict(rtol=2e-4, atol=2e-5))
BF16 = dict(rtol=0.06, atol_rel=0.03, floor_rel=0.03, loss=dict(rtol=0.06, atol=0.03))
VARIANTS = {
    "f32": ([], F32),
    "f32-accumulate-2": (["model.accumulate_steps=2"], F32),
    "bf16": (["model.compute_dtype=bfloat16"], BF16),
}


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _step_rng(i):
    return jax.random.PRNGKey(100 + i)


@pytest.fixture(scope="module")
def jax_runs(case, tmp_path_factory):  # noqa: F811
    """The JAX runs, each made once: per variant the task, its starting
    parameters and, after each of the 3 steps, the loss, parameters and EMA
    (as numpy trees) and the state."""
    jgm, _, cells, stats = case
    runs = {}

    def run(variant):
        if variant in runs:
            return runs[variant]
        extra, _ = VARIANTS[variant]
        cfg = jconfig.parse_cli_overrides(TRAIN + extra).model
        root = tmp_path_factory.mktemp(variant)
        task = JDiffusionTask(cfg, JFieldStats(stats), root, root / "samples", max_train_steps=MAX_TRAIN_STEPS)
        x0 = jnp.zeros((1, *jgm.shape, 4))
        params = task.net.init(jax.random.PRNGKey(0), x0, jnp.zeros((1,), jnp.int32), jgm.cell_types)
        start = _numpy_tree(params)
        state = DiffusionState.create(
            apply_fn=task.net.apply, params=params, tx=task.tx,
            ema_params=jax.tree_util.tree_map(jnp.copy, params),
        )
        steps = []
        for i in range(N_STEPS):
            state, metrics = task.train_step(state, jnp.asarray(cells), jgm, _step_rng(i))
            steps.append(dict(loss=float(metrics["train/loss"]), params=_numpy_tree(state.params),
                              ema=_numpy_tree(state.ema_params)))
        runs[variant] = dict(task=task, start=start, steps=steps, state=state)
        return runs[variant]

    return run


def _port_task(variant, stats, start=None, extra=()):
    cfg = tconfig.parse_cli_overrides(TRAIN + VARIANTS[variant][0] + list(extra)).model
    task = DiffusionTask(cfg, FieldStats(stats), "cpu", max_train_steps=MAX_TRAIN_STEPS)
    if start is not None:
        task.load_flax_params(start)
    return task


def _jax_draws(i, grid_shape, cells):
    return ReplayDraws(jax_loss_draws(_step_rng(i), (cells.shape[0], *grid_shape, 4), 20))


def _assert_changes_close(got, want, start, tol, what, slack=None):
    """Per leaf: got - start against want - start, atol relative to the
    leaf's max |want - start| plus the floor (plus, per element, ``slack``
    [name] - start); with bf16 tolerances also a correlation > 0.999 over
    all leaves."""
    assert got.keys() == want.keys()
    changes = {name: (np.asarray(got[name], np.float64) - np.asarray(start[name], np.float64),
                      np.asarray(want[name], np.float64) - np.asarray(start[name], np.float64))
               for name in want}
    floor = tol["floor_rel"] * max(np.abs(w).max() for _, w in changes.values())
    all_got, all_want = [], []
    for name, (g, w) in changes.items():
        # The rounding of start + change to f32, once per step.
        ulps = N_STEPS * np.spacing(np.float32(np.abs(start[name]).max()))
        atol = tol["atol_rel"] * np.abs(w).max() + floor + ulps
        if slack is not None:
            atol = atol + np.abs(np.asarray(slack[name], np.float64) - np.asarray(start[name], np.float64) - w)
        bad = np.abs(g - w) > atol + tol["rtol"] * np.abs(w)
        assert not bad.any(), f"{what}: {name}: {bad.sum()} of {bad.size} outside, got {g[bad]}, want {w[bad]}"
        all_got.append(g.ravel())
        all_want.append(w.ravel())
    if tol is BF16:
        g, w = np.concatenate(all_got), np.concatenate(all_want)
        assert np.corrcoef(g, w)[0, 1] > 0.999, what


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_steps_match_jax(case, jax_runs, variant):  # noqa: F811
    """Loss, parameters and EMA after each of 3 steps.  With accumulation
    the first and third micro-steps only accumulate: the parameters and the
    EMA stay as they were (bit for bit in the port)."""
    _, tgm, cells, stats = case
    jrun = jax_runs(variant)
    tol = VARIANTS[variant][1]
    # bf16: the JAX f32 run from the same start gives the reference's own
    # bf16 error, per element.
    f32_steps = jax_runs("f32")["steps"] if tol is BF16 else [None] * N_STEPS
    task = _port_task(variant, stats, jrun["start"])
    start = {k: v.clone() for k, v in task.net.state_dict().items()}
    flat = lambda tree: {k: v.numpy() for k, v in torch_state_dict_from_flax(tree).items()}  # noqa: E731
    accumulate = task.cfg.accumulate_steps
    for i, (want, f32_want) in enumerate(zip(jrun["steps"], f32_steps)):
        before = {k: v.clone() for k, v in task.net.state_dict().items()}
        ema_before = {k: v.clone() for k, v in task.ema.items()}
        metrics = task.training_step(torch.from_numpy(cells), tgm, _jax_draws(i, tgm.shape, cells))
        loss = metrics["train/loss"]
        assert isinstance(loss, torch.Tensor) and loss.dim() == 0
        np.testing.assert_allclose(float(loss), want["loss"], **tol["loss"])
        got = {k: v.numpy() for k, v in task.net.state_dict().items()}
        slack = {key: flat(f32_want[key]) for key in ("params", "ema")} if f32_want else {}
        _assert_changes_close(got, flat(want["params"]), start, tol, f"params after step {i + 1}",
                              slack.get("params"))
        _assert_changes_close({k: v.numpy() for k, v in task.ema.items()}, flat(want["ema"]), start, tol,
                              f"EMA after step {i + 1}", slack.get("ema"))
        if (i + 1) % accumulate:
            assert all(torch.equal(task.net.state_dict()[k], before[k]) for k in before)
            assert all(torch.equal(task.ema[k], ema_before[k]) for k in ema_before)
        else:
            assert not torch.equal(task.net.state_dict()["decode_out.weight"], before["decode_out.weight"])
    assert task.step == N_STEPS and task.opt_state.count == N_STEPS // accumulate


def test_gradients_match_jax(case, jax_runs):  # noqa: F811
    """The first step's gradients (left in ``.grad``), against
    ``jax.value_and_grad`` of the JAX task's own loss at the same draws."""
    jgm, tgm, cells, stats = case
    jrun = jax_runs("f32")
    jtask = jrun["task"]

    @jax.jit
    def value_and_grad(params, rng):
        x = jtask._model_input(jnp.asarray(cells), jgm)
        return jax.value_and_grad(lambda p: jtask.diffusion.loss(jtask._eps_fn(p, jgm), x, jgm, rng))(params)

    want_loss, want_grads = value_and_grad(jrun["start"], _step_rng(0))
    task = _port_task("f32", stats, jrun["start"])
    loss = task.training_step(torch.from_numpy(cells), tgm, _jax_draws(0, tgm.shape, cells))["train/loss"]
    np.testing.assert_allclose(float(loss), float(want_loss), **F32["loss"])
    want = {k: v.numpy() for k, v in torch_state_dict_from_flax(_numpy_tree(want_grads)).items()}
    got = {name: p.grad.numpy() for name, p in task.net.named_parameters()}
    zeros = {k: np.zeros_like(v) for k, v in want.items()}
    _assert_changes_close(got, want, zeros, F32, "gradients")
    assert task.n_params() == sum(v.size for v in want.values())


def test_eval_diagnostics_and_ema_sample_match_jax(case, jax_runs):  # noqa: F811
    """After the 3 f32 steps: the masked eps-loss at 8 timesteps with the
    parameters and with the EMA (JAX's draws replayed), and DDIM samples
    with the EMA parameters (tests/test_torch_task.py's sampler tolerance,
    in units of the output's normalized scale)."""
    jgm, tgm, cells, stats = case
    jrun = jax_runs("f32")
    jtask, state = jrun["task"], jrun["state"]
    task = _port_task("f32", stats, jrun["start"])
    for i in range(N_STEPS):
        task.training_step(torch.from_numpy(cells), tgm, _jax_draws(i, tgm.shape, cells))

    rng = jax.random.PRNGKey(7)
    batch = SimpleNamespace(cells=cells, grid=jgm, metadata=SimpleNamespace(n_cells=tgm.n_cells))
    want = jtask.eval_diagnostics(state, batch, rng)
    shape = (cells.shape[0], *tgm.shape, 4)
    draws = [np.asarray(jax.random.normal(r, shape)) for r in jax.random.split(rng, 8)]
    got = task.eval_diagnostics(torch.from_numpy(cells), tgm, Replay(draws))
    assert got.keys() == want.keys() and len(got) == 16
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **F32["loss"], err_msg=key)
    assert got["val/eps-loss-t0"] != got["val/eps-loss-ema-t0"]

    want = jtask.sample(state, batch, rng)
    noise = Replay(jax_normals(rng, shape, task.cfg.ddim_steps, True))
    got = task.sample(torch.from_numpy(cells), tgm, noise).numpy()
    assert not noise.draws
    std = task.normalizer.std
    scale = np.abs(want / std).max()
    np.testing.assert_allclose(got / std / scale, want / std / scale, rtol=1e-3, atol=1e-4)


def test_remat_gives_the_same_gradients(case):  # noqa: F811
    """remat on and off: bit-equal gradients on the CPU; with remat the
    first conv of each U-Net ResnetBlock runs twice per step (the
    recompute; checkpoint stops recomputing a block once it has every
    tensor the backward needs, so the count is taken inside the block), that
    of decode_resnet once, and once each without gradients."""
    _, tgm, cells, stats = case
    grads, calls = {}, {}
    for remat in (True, False):
        task = _port_task("f32", stats, extra=[f"model.remat={str(remat).lower()}"])
        task.init_weights(torch.Generator().manual_seed(3))
        assert task.net.u_net.remat is remat
        counts = {"down_0": 0, "decode_resnet": 0}
        for name, block in (("down_0", task.net.u_net.down_0), ("decode_resnet", task.net.decode_resnet)):
            block.block1.conv.register_forward_hook(lambda *_, name=name: counts.__setitem__(name, counts[name] + 1))
        task.training_step(torch.from_numpy(cells), tgm, GeneratorNoise(torch.Generator().manual_seed(4), "cpu"))
        grads[remat] = {n: p.grad.clone() for n, p in task.net.named_parameters()}
        calls[remat] = dict(counts)
        with torch.no_grad():
            x = torch.zeros(1, *tgm.shape, 4)
            task.net(x, torch.zeros(1, dtype=torch.long), tgm.cell_types)
        calls[remat, "no_grad"] = dict(counts)
    assert calls[True] == {"down_0": 2, "decode_resnet": 1}
    assert calls[False] == {"down_0": 1, "decode_resnet": 1}
    assert calls[True, "no_grad"] == {"down_0": 3, "decode_resnet": 2}
    assert all(torch.equal(grads[True][n], grads[False][n]) for n in grads[False])


@pytest.mark.parametrize("variant, n_saved", [("f32", 2), ("f32-accumulate-2", 3)])
def test_checkpoint_round_trip(case, tmp_path, variant, n_saved):  # noqa: F811
    """Save after ``n_saved`` micro-steps, restore into a fresh task, take
    1 more: bit-equal to ``n_saved + 1`` steps without the restore.  With
    accumulation 2 the third micro-step leaves a half-filled accumulator in
    the saved state, which the fourth completes.  ``save_best`` keeps the
    lowest value."""
    _, tgm, cells, stats = case
    x = torch.from_numpy(cells)

    def noise(i):
        return GeneratorNoise(torch.Generator().manual_seed(10 + i), "cpu")

    ref = _port_task(variant, stats)
    ref.init_weights(torch.Generator().manual_seed(5))
    start = copy.deepcopy(ref.state_dict())  # state_dict() holds the live tensors
    for i in range(n_saved + 1):
        ref.training_step(x, tgm, noise(i))

    task = _port_task(variant, stats)
    task.load_state_dict(start)
    for i in range(n_saved):
        task.training_step(x, tgm, noise(i))
    cfg_json = tconfig.parse_cli_overrides(TRAIN).to_json()
    manager = CheckpointManager(tmp_path / "ckpt", config_json=cfg_json)
    manager.save_last(task.state_dict(), step=task.step)
    assert manager.save_best(task.state_dict(), step=task.step, value=1.5)
    assert not manager.save_best(ref.state_dict(), step=ref.step, value=2.0)

    manager = CheckpointManager(tmp_path / "ckpt")
    assert manager.last_step == n_saved and manager.config_json == cfg_json
    restored = _port_task(variant, stats)
    restored.load_state_dict(manager.restore("last"))
    assert restored.step == n_saved
    assert restored.opt_state.mini_step == n_saved % restored.cfg.accumulate_steps
    restored.training_step(x, tgm, noise(n_saved))
    got, want = restored.state_dict(), ref.state_dict()
    assert got["step"] == want["step"] == n_saved + 1
    assert got["opt"]["count"] == want["opt"]["count"] > 0
    for key in ("net", "ema"):
        assert all(torch.equal(got[key][k], want[key][k]) for k in want[key])
    for key in ("mu", "nu", "acc"):
        assert all(torch.equal(a, b) for a, b in zip(got["opt"][key] or [], want["opt"][key] or []))
    assert manager.restore("best")["step"] == n_saved
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore("last")
