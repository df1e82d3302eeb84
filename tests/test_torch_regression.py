"""The regression baselines: the JAX package's ``SequenceDataModule``,
``TFNet``, ``DilResNet``, ``TFNetTask`` and ``DilResNetTask`` against the
port's, from the same data, the same flax parameters (``load_flax_params``)
and the same draws.

Tolerances: f32 rtol 2e-4 / atol 2e-5 (the JAX tests' f32 tolerance);
bf16 rtol 0.06 / atol 0.03 and a correlation > 0.999 (ROADMAP's bf16 rule).
Train steps compare, per leaf, the change from the starting parameters with
atol 2e-5 x the leaf's largest change (``test_torch_train.py``'s rule).  The
train-step tests use RAdam, whose first updates follow the gradient (its
rectification is off for rho < 5), where Adam's would be the gradient's
sign, which rounding decides for the elements whose gradient vanishes; the
optimizers are held against optax in ``test_torch_optimizers.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from generative_turbulence_tpu.data import grid as jgrid
from generative_turbulence_tpu.data import sequence as jsequence
from generative_turbulence_tpu.data.schema import FieldStats as JFieldStats
from generative_turbulence_tpu.data.schema import read_metadata as j_read_metadata
from generative_turbulence_tpu.data.synthetic import generate_case as j_generate_case
from generative_turbulence_tpu.data.variables import Variable as JVariable
from generative_turbulence_tpu.models import Conditioning as JConditioning
from generative_turbulence_tpu.models import DilResNet as JDilResNet
from generative_turbulence_tpu.models import TFNet as JTFNet
from generative_turbulence_tpu.training import config as jconfig
from generative_turbulence_tpu.training import regression_task as jregression
from generative_turbulence_tpu_torch.data import grid as tgrid
from generative_turbulence_tpu_torch.data import sequence as tsequence
from generative_turbulence_tpu_torch.data.schema import FieldStats, read_metadata
from generative_turbulence_tpu_torch.data.synthetic import build_case, generate_synthetic_dataset
from generative_turbulence_tpu_torch.data.variables import Variable, stack_channels
from generative_turbulence_tpu_torch.models.conditioning import Conditioning
from generative_turbulence_tpu_torch.models.dilresnet import DilResNet
from generative_turbulence_tpu_torch.models.tfnet import TFNet, _ConvTranspose, same_pads
from generative_turbulence_tpu_torch.toolchain.from_flax import torch_state_dict_from_flax
from generative_turbulence_tpu_torch.training import config as tconfig
from generative_turbulence_tpu_torch.training import regression_task as tregression
from generative_turbulence_tpu_torch.training.factory import instantiate_data_and_task
from generative_turbulence_tpu_torch.training.loop import Trainer
from test_torch_task import field_stats

F32 = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=0.06, atol=0.03)
DTYPES = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}
GRIDS = {"odd": (11, 9, 7), "even": (12, 8, 8)}
# Small configurations of the two baselines (TF-Net's widths are fixed by
# the model: 64 -> 512 channels).
TFNET = ["model=tfnet", "model.context_window=4", "model.temporal_filtering_length=2", "model.unroll_steps=2"]
DILRESNET = ["model=dilresnet", "model.N=2", "model.hidden_dim=8"]
MODELS = {"tfnet": TFNET, "dilresnet": DILRESNET}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads while this file runs: the suite runs files in
    parallel processes, where torch's default of one thread per core
    oversubscribes the host."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def flax_variables(net, inputs, seed):
    """Variables of ``net`` with its init's shapes, drawn from numpy: kernels
    N(0, 1/fan-in), biases and BatchNorm offsets 0.1 N(0, 1), scales 1 +
    0.1 N(0, 1), running variances 1 + 0.2 U(0, 1); the JAX init of TF-Net
    draws 25M truncated normals, seconds on the CPU."""
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), *inputs)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        normal = rng.standard_normal(shape).astype(np.float32)
        if name == "kernel":
            return normal / np.sqrt(np.prod(shape[:-1]))
        if name in ("bias", "mean"):
            return 0.1 * normal
        if name == "scale":
            return 1 + 0.1 * normal
        if name == "var":
            return (1 + 0.2 * rng.uniform(size=shape)).astype(np.float32)
        if name == "temporal_filter":
            return normal / np.sqrt(shape[0])
        return normal  # embedding

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _assert_close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, **tol, err_msg=what)
    if tol is BF16:
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999, what


def _nets(model, dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    jc = JConditioning(cell_type_embedding_dim=8, dtype=jdt)
    tc = Conditioning(cell_type_embedding_dim=8, dtype=tdt or torch.float32)
    if model == "tfnet":
        return (JTFNet(n_features=4, context_window=6, conditioning=jc, dtype=jdt),
                TFNet(4, 6, conditioning=tc, dtype=tdt))
    return JDilResNet(n_features=4, N=2, hidden_dim=8, conditioning=jc, dtype=jdt), DilResNet(4, 2, 8, tc, tdt)


# ---- SequenceDataModule --------------------------------------------------------


@pytest.mark.parametrize("split, epoch", [("train", 0), ("train", 1), ("val", None), ("test", None)])
def test_sequence_batches_are_bit_equal(synthetic_root, split, epoch):
    """Train batches of two epochs, the val and test windows: cells, times
    and cases bit-equal to the JAX module's (seed 3, windows of 3 and 5)."""
    kw = dict(discard_first_seconds=-1.0, batch_size=2, seq_len=3, eval_batch_size=2, eval_seq_len=5,
              val_samples=3, test_samples=2, seed=3)
    jdm = jsequence.SequenceDataModule(synthetic_root, cell_bucket=0, **kw)
    tdm = tsequence.SequenceDataModule(synthetic_root, **kw)
    stage = "test" if split == "test" else "fit"
    jdm.setup(stage)
    tdm.setup(stage)
    if split == "train":
        assert tdm.n_train_batches() == jdm.n_train_batches() == 10  # 2 cases x 10 windows / 2
        want, got = list(jdm.train_batches(epoch)), list(tdm.train_batches(epoch))
    else:
        want = list(getattr(jdm, f"{split}_batches")())
        got = list(getattr(tdm, f"{split}_batches")())
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert isinstance(g, tsequence.SequenceBatch) and g.seq_len == w.seq_len
        assert g.metadata.case_name == w.metadata.case_name
        assert g.cells.dtype == w.cells.dtype and np.array_equal(g.cells, w.cells)
        assert np.array_equal(g.t, w.t)


def test_sequence_window_starts(synthetic_root):
    dataset = tsequence.SequenceDataModule(synthetic_root, seq_len=4, eval_seq_len=12).setup("fit").val_dataset
    assert [len(s) for s in dataset.valid_steps] == [1]  # 12 frames, one window of 12
    with pytest.raises(ValueError, match="sequence_length"):
        tsequence.SequenceDataset(dataset.repo, dataset.stats, sequence_length=0)


# ---- the models ----------------------------------------------------------------


@pytest.mark.parametrize("n", range(1, 10))
def test_same_pads_are_flax_padding(n):
    """flax's SAME at stride 2 (even extents (0, 1), odd (1, 1)) and 1."""
    for stride in (1, 2):
        want = jax.lax.padtype_to_pads((n,), (3,), (stride,), "SAME")[0]
        assert same_pads(n, 3, stride) == tuple(want)


@pytest.mark.parametrize("extent", [(1, 1, 1), (3, 2, 5)], ids=["1x1x1", "3x2x5"])
def test_conv_transpose_matches_flax(extent):
    """flax's ConvTranspose(k=4, s=2, SAME) with a kernel of no symmetry,
    through ``from_flax``'s flip and in/out swap: exact in f32; an unflipped
    kernel is refused."""
    layer = fnn.ConvTranspose(5, (4, 4, 4), strides=(2, 2, 2), padding="SAME")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, *extent, 3)).astype(np.float32)
    kernel = rng.standard_normal((4, 4, 4, 3, 5)).astype(np.float32)
    bias = rng.standard_normal(5).astype(np.float32)
    want = np.asarray(layer.apply({"params": {"kernel": kernel, "bias": bias}}, x))
    assert want.shape == (2, *(2 * e for e in extent), 5)
    port = _ConvTranspose(3, 5)
    state = torch_state_dict_from_flax({"ConvTranspose_0": {"kernel": kernel, "bias": bias}})
    port.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()})
    with torch.no_grad():
        _assert_close(port(torch.tensor(x)), want, F32, "ConvTranspose")
        port.weight.copy_(torch.tensor(kernel.transpose(3, 4, 0, 1, 2)))
        assert np.abs(port(torch.tensor(x)).numpy() - want).max() > 0.1


@pytest.fixture(scope="module")
def forward_params():
    """One parameter set per model, shared by both dtypes and grids (the
    shapes do not depend on them)."""
    x = jnp.zeros((1, 6, 8, 6, 6, 4))
    ct = jnp.zeros((8, 6, 6), jnp.int32)
    out = {}
    for model in ("tfnet", "dilresnet"):
        jnet, _ = _nets(model, "f32")
        inputs = (x, ct) if model == "tfnet" else (x[:, 0], ct)
        out[model] = flax_variables(jnet, inputs, seed=2)
    return out


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("model", ["tfnet", "dilresnet"])
def test_forward_matches_flax(forward_params, model, dtype, grid):
    """One forward of each model, f32 and bf16, on an odd and an even grid
    (TF-Net's stride-2 SAME padding differs at even extents, its decoder
    clips at odd ones), from the same parameters, BatchNorm statistics
    included."""
    jnet, tnet = _nets(model, dtype)
    variables = forward_params[model]
    tnet.load_state_dict(torch_state_dict_from_flax(variables))
    shape = GRIDS[grid]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, *shape, 4)).astype(np.float32)
    ct = rng.integers(0, 6, size=shape)
    if model == "dilresnet":
        x = x[:, 0]
    want = np.asarray(jax.jit(jnet.apply)(variables, jnp.asarray(x), jnp.asarray(ct, jnp.int32)))
    with torch.no_grad():
        got = tnet(torch.tensor(x), torch.tensor(ct))
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, *shape, 4)
    _assert_close(got, want, F32 if dtype == "f32" else BF16, f"{model} {dtype} {grid}")


# ---- train steps ------------------------------------------------------------------


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """A 10x6x6-cell case (12x8x8 padded) of 12 frames: both grids, the
    frames (12, n_cells, 4) and the stats."""
    kw = dict(cell_counts=(10, 6, 6), seed=6)
    file = j_generate_case(tmp_path_factory.mktemp("regression") / "case", n_frames=12, **kw)
    jvars, tvars = (JVariable.U, JVariable.P), (Variable.U, Variable.P)
    jgm = jgrid.GridMap.from_metadata(j_read_metadata(file), jvars, cached=False)
    tgm = tgrid.GridMap.from_metadata(read_metadata(file), tvars, device="cpu")
    _, fields = build_case(n_frames=12, **kw)
    return jgm, tgm, stack_channels(fields, tvars), field_stats(fields)


def _configs(model, extra=()):
    args = MODELS[model] + ["model.optimizer=radam", "model.learning_rate=0.05", "model.lr_decay=null"] + list(extra)
    jcfg, tcfg = jconfig.parse_cli_overrides(args).model, tconfig.parse_cli_overrides(args).model
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return jcfg, tcfg


def _jax_task(model, cfg, stats, root):
    cls = jregression.TFNetTask if model == "tfnet" else jregression.DilResNetTask
    return cls(cfg, JFieldStats(stats), root, root / "samples", max_train_steps=10)


def _port_task(model, cfg, stats):
    cls = tregression.TFNetTask if model == "tfnet" else tregression.DilResNetTask
    return cls(cfg, FieldStats(stats), "cpu", max_train_steps=10)


def _jax_state(task, variables):
    F = task.n_features
    return jregression.RegressionState.create(
        apply_fn=task.net.apply, params=variables, tx=task.tx,
        dx_mean=jnp.zeros((F,)), dx_var=jnp.ones((F,)), n_tracked=jnp.zeros((), jnp.int32),
    )


def _windows(cells, seq_len, batch, i):
    """Micro-batch i: ``batch`` windows of ``seq_len`` frames."""
    return np.stack([cells[i + b : i + b + seq_len] for b in range(batch)])


def _noise_draw(i, shape):
    """The DilResNet step's input-noise draw, as JAX draws it from the step key."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(200 + i), shape))


class Replay:
    def __init__(self, draws):
        self.draws = list(draws)

    def __call__(self, shape):
        draw = self.draws.pop(0)
        assert tuple(shape) == draw.shape
        return torch.tensor(draw)


def _run_both(model, case, tmp_path, n_steps, extra=(), batch=1):
    """n_steps train steps of the JAX task and the port's from the same
    parameters and draws: per step the losses, and the final states."""
    jgm, tgm, cells, stats = case
    jcfg, tcfg = _configs(model, extra)
    jtask, ttask = _jax_task(model, jcfg, stats, tmp_path), _port_task(model, tcfg, stats)
    seq_len = tcfg.context_window + tcfg.unroll_steps
    x0 = jnp.zeros((1, tcfg.context_window, *jgm.shape, 4))
    inputs = (x0, jgm.cell_types) if model == "tfnet" else (x0[:, -1], jgm.cell_types)
    variables = flax_variables(jtask.net, inputs, seed=4)
    state = _jax_state(jtask, variables)
    ttask.load_flax_params(variables)
    start = {k: v.clone() for k, v in ttask.net.state_dict().items()}
    losses = []
    for i in range(n_steps):
        window = _windows(cells, seq_len, batch, i)
        state, metrics = jtask.train_step(state, jnp.asarray(window), jgm, jax.random.PRNGKey(200 + i))
        shape = (batch, *tgm.shape, 4)
        got = ttask.training_step(torch.tensor(window), tgm, Replay([_noise_draw(i, shape)]))
        losses.append((float(got["train/loss"]), float(metrics["train/loss"])))
    return jtask, state, ttask, start, losses


def _assert_params_close(ttask, state, start, what):
    """Every leaf's change against JAX's; returns the names of the leaves
    that moved in both."""
    want = {k: v.numpy() for k, v in torch_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, state.params)).items()}
    got = {k: v.numpy() for k, v in ttask.net.state_dict().items()}
    assert got.keys() == want.keys()
    changes = {k: (got[k] - start[k].numpy(), want[k] - start[k].numpy()) for k in want}
    floor = 1e-6 * max(np.abs(w).max() for _, w in changes.values())
    moved = set()
    for name, (g, w) in changes.items():
        ulps = 3 * np.spacing(np.float32(np.abs(start[name].numpy()).max()))
        atol = 2e-5 * np.abs(w).max() + floor + ulps
        bad = np.abs(g - w) > atol + 2e-4 * np.abs(w)
        assert not bad.any(), f"{what}: {name}: {bad.sum()} of {bad.size} outside, got {g[bad][:4]}, want {w[bad][:4]}"
        if np.abs(w).max() > 0 and np.abs(g).max() > 0:
            moved.add(name)
    return moved


@pytest.mark.parametrize("model", ["tfnet", "dilresnet"])
def test_train_steps_match_jax(case, tmp_path, model):
    """3 micro-steps against JAX's ``train_step``: TF-Net with accumulation
    3 (one update, of every parameter, BatchNorm mean and var included),
    DilResNet with its input noise replayed; the losses, the parameters'
    changes, and DilResNet's delta statistics and tracked-batch count."""
    extra = ["model.accumulate_steps=3"] if model == "tfnet" else []
    jtask, state, ttask, start, losses = _run_both(model, case, tmp_path, 3, extra)
    for got, want in losses:
        np.testing.assert_allclose(got, want, **F32)
    assert ttask.step == 3 and ttask.opt_state.count == (1 if model == "tfnet" else 3)
    moved = _assert_params_close(ttask, state, start, f"{model} after 3 steps")
    if model == "tfnet":
        # The statistics train: the first two levels' BatchNorm mean and var
        # move (the deepest levels' gradients, below 1e-7 on a 1x1x1 grid,
        # round away in both packages).
        stats = {k for k in start if k.endswith(("_bn.mean", "_bn.var")) and (".conv1" in k or ".conv2_bn" in k)}
        assert len(stats) == 18 and stats <= moved
    else:
        assert moved == set(start)
    assert ttask.n_tracked == int(state.n_tracked) == (0 if model == "tfnet" else 3)
    np.testing.assert_allclose(ttask.dx_mean.numpy(), np.asarray(state.dx_mean), **F32)
    np.testing.assert_allclose(ttask.dx_var.numpy(), np.asarray(state.dx_var), **F32)


def test_dilresnet_delta_statistics_freeze(case, tmp_path, monkeypatch):
    """Across the freeze of the running delta statistics (here after 2
    micro-steps, on both packages' class attribute): 4 steps against JAX;
    the statistics stop moving after the 2nd, and the 3rd and 4th normalize
    by them."""
    monkeypatch.setattr(jregression.DilResNetTask, "N_TRACK_BATCHES", 2)
    monkeypatch.setattr(tregression.DilResNetTask, "N_TRACK_BATCHES", 2)
    jtask, state, ttask, start, losses = _run_both("dilresnet", case, tmp_path, 4, batch=2)
    for got, want in losses:
        np.testing.assert_allclose(got, want, **F32)
    assert _assert_params_close(ttask, state, start, "dilresnet after 4 steps") == set(start)
    assert ttask.n_tracked == int(state.n_tracked) == 4
    np.testing.assert_allclose(ttask.dx_mean.numpy(), np.asarray(state.dx_mean), **F32)
    np.testing.assert_allclose(ttask.dx_var.numpy(), np.asarray(state.dx_var), **F32)
    frozen = (ttask.dx_mean.clone(), ttask.dx_var.clone())
    ttask.training_step(torch.tensor(_windows(case[2], 2, 2, 5)), case[1], Replay([_noise_draw(5, (2, *case[1].shape, 4))]))
    assert torch.equal(ttask.dx_mean, frozen[0]) and torch.equal(ttask.dx_var, frozen[1])


# ---- evaluation -------------------------------------------------------------------


EVAL = ["model.eval_unroll_steps=4", "model.sample_steps=[2,4]", "model.main_sample_step=4",
        "model.monitor=val/tke"]


@pytest.mark.parametrize("model", ["dilresnet", "tfnet"])
def test_eval_step_matches_jax(synthetic_root, tmp_path, model):
    """``eval_step`` on the first val batch (4 rollout steps) and
    ``on_eval_end`` (cheap metrics): ``val/loss``, every
    ``val/unroll/mse-<var>-<i>``, the per-step metrics and the main step's
    promoted ``val/<x>`` against the JAX task's (metrics at rtol 1e-3)."""
    args = MODELS[model] + EVAL
    jcfg, tcfg = jconfig.parse_cli_overrides(args).model, tconfig.parse_cli_overrides(args).model
    seq = tcfg.context_window + tcfg.eval_unroll_steps
    jdm = jsequence.SequenceDataModule(synthetic_root, eval_batch_size=2, eval_seq_len=seq, val_samples=2,
                                       cell_bucket=0, discard_first_seconds=-1.0)
    jdm.setup("validate")
    tdm = tsequence.SequenceDataModule(synthetic_root, eval_batch_size=2, eval_seq_len=seq, val_samples=2,
                                       discard_first_seconds=-1.0).setup("validate")
    jbatch, tbatch = next(iter(jdm.val_batches())), next(iter(tdm.val_batches()))
    jtask = (jregression.TFNetTask if model == "tfnet" else jregression.DilResNetTask)(
        jcfg, jdm.stats, synthetic_root, tmp_path / "jax")
    ttask = (tregression.TFNetTask if model == "tfnet" else tregression.DilResNetTask)(
        tcfg, tdm.stats, "cpu", data_root=synthetic_root, samples_root=tmp_path / "port")
    x0 = jnp.zeros((1, tcfg.context_window, *jbatch.grid.shape, 4))
    inputs = (x0, jbatch.grid.cell_types) if model == "tfnet" else (x0[:, -1], jbatch.grid.cell_types)
    variables = flax_variables(jtask.net, inputs, seed=8)
    state = _jax_state(jtask, variables)
    if model == "dilresnet":  # delta statistics away from (0, 1)
        state = state.replace(dx_mean=jnp.full((4,), 0.01), dx_var=jnp.full((4,), 0.04))
    ttask.load_flax_params(variables)
    ttask.dx_mean, ttask.dx_var = torch.tensor(np.asarray(state.dx_mean)), torch.tensor(np.asarray(state.dx_var))
    for task in (jtask, ttask):
        task.on_eval_start("val")
    want = jtask.eval_step(state, jbatch, jax.random.PRNGKey(0), "val")
    got = ttask.eval_step(tbatch, None, "val")
    assert got.keys() == want.keys() and len(got) == 1 + 2 * 4
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, atol=1e-6, err_msg=key)
    want = jtask.on_eval_end(jdm.stats, "val", expensive=False)
    got = ttask.on_eval_end(tdm.stats, "val", expensive=False)
    assert got.keys() == want.keys()
    assert {"val/tke", "val/2/tke", "val/4/tke", "val/max-mean-tke-pos"} <= set(got)
    assert got["val/tke"] == got["val/4/tke"]
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, err_msg=key)
    store = ttask.sample_stores["val"][4]
    assert store.n_samples(tbatch.metadata.case_name) == 2
    samples = ttask.unroll_samples(tbatch, [1, 3], block_size=max(2, tcfg.context_window))
    assert samples.shape == (2, 2, tbatch.metadata.n_cells, 4) and np.isfinite(samples).all()


# ---- the factory ------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """One case per split of 8 frames at 10x6x6 cells (12x8x8 padded)."""
    return generate_synthetic_dataset(tmp_path_factory.mktemp("tiny") / "data", n_train_cases=1, n_val_cases=1,
                                      n_test_cases=0, n_frames=8, cell_counts=(10, 6, 6), seed=2, format="npyd")


@pytest.mark.parametrize("model", ["tfnet", "dilresnet"])
def test_factory_trains_end_to_end(tiny_root, tmp_path, model):
    """``instantiate_data_and_task`` + ``Trainer.fit`` on the CPU: the
    micro-batch and windows from the config, one epoch, a validation with
    the promoted monitor, the checkpoints, and a restore into a fresh
    task."""
    args = MODELS[model] + EVAL + [
        f"data.root={tiny_root}", "data.discard_first_seconds=-1", "data.val_samples=2",
        "data.eval_batch_size=2", "model.batch_size=4", "model.accumulate_steps=2",
        "model.compute_expensive_sample_metrics=false", f"trainer.out_dir={tmp_path}",
        "trainer.max_epochs=1", "trainer.log_every_n_steps=1", "trainer.render_plots=false",
    ]
    config = tconfig.parse_cli_overrides(args).resolved()
    dm, task = instantiate_data_and_task(config, "cpu")
    assert isinstance(dm, tsequence.SequenceDataModule) and dm.batch_size == 2 and dm.device == "cpu"
    assert dm.seq_len == task.context_window + task.unroll_steps
    assert dm.eval_seq_len == task.context_window + 4
    batch = next(iter(dm.train_batches(0)))
    assert isinstance(batch.cells, torch.Tensor) and batch.cells.shape[:2] == (2, dm.seq_len)
    metrics = Trainer(config, task, dm).fit()
    assert np.isfinite(metrics["val/tke"]) and np.isfinite(metrics["val/loss"])
    n_steps = dm.n_train_batches()
    assert task.step == n_steps and task.opt_state.count == n_steps // 2
    ckpt = tmp_path / "checkpoints"
    assert {"last.pt", "best.pt", "config.json", "index.json"} <= {p.name for p in ckpt.iterdir()}
    assert (tmp_path / "metrics.jsonl").read_text().count("train/loss") == n_steps
    from generative_turbulence_tpu_torch.training.checkpoint import CheckpointManager

    fresh = type(task)(task.cfg, dm.stats, "cpu")
    fresh.load_state_dict(CheckpointManager(ckpt).restore("last"))
    assert fresh.step == n_steps and fresh.n_tracked == task.n_tracked
    assert all(torch.equal(a, b) for a, b in zip(fresh.net.state_dict().values(), task.net.state_dict().values()))
