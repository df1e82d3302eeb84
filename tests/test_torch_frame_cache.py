"""Training frames as the JAX package's device frame caches give them: the
port's ``DataModule`` and ``SequenceDataModule`` against the JAX modules on
the same dataset (``synthetic_root``: 2 train cases of 12 frames at 24x10x10
cells), with the caches' keys set as the paper's recipes set them.

Each training batch of two epochs is compared bit for bit as float32: its
dtype (bf16 where JAX's cache or its bf16 transfer rounds the frames), its
values (JAX's bucket padding zero), its frame order and times.  Settings: a
capacity that holds the whole train split, one that holds only the first
case used (the JAX cache's own bookkeeping shows it), and, for the frame
module, ``transfer_dtype="bfloat16"`` with no cache; each at a batch size
without repeated frames (sorted, as JAX's pooled collation and its cache
read them) and one whose top-up repeats them (kept in the sampler's order).

Then the tasks' input, bit for bit against the value JAX's jitted step
computes: bf16 frames embedded in bf16 (Dirichlet values rounded too) and
normalised with bf16 constants, but in f32 (XLA keeps the excess precision
of a bf16 chain that only f32 operations consume, and divides by the
constant std as a product with its reciprocal), for the diffusion task and
for TF-Net's windows.  The loss's noise on bf16 frames: JAX draws it at
their dtype, 128 levels under jit (``Bf16NormalLaw``), against the values
of JAX's jitted draw.  And one f32-compute train step of the diffusion task
under ``data.device_cache_gb`` through both factories, with the draws of
JAX's jitted step replayed (the noise as its levels), loss rtol 2e-4 / atol
2e-5, parameters by the f32 rule of ``tests/test_torch_train.py``.  Before
the port read these keys, its batches were f32 and unsorted, and that step
missed JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_turbulence_tpu.data import dataset as jdataset
from generative_turbulence_tpu.data import sequence as jsequence
from generative_turbulence_tpu.training import config as jconfig
from generative_turbulence_tpu.training.factory import instantiate_data_and_task as j_instantiate
from generative_turbulence_tpu_torch.data import dataset, sequence
from generative_turbulence_tpu_torch.data.grid import embed_cells
from generative_turbulence_tpu_torch.data.npyd import open_case_file
from generative_turbulence_tpu_torch.diffusion.gaussian import Bf16NormalLaw, GeneratorNoise, bf16_normal_levels
from generative_turbulence_tpu_torch.toolchain.from_flax import torch_state_dict_from_flax
from generative_turbulence_tpu_torch.training import config as tconfig
from generative_turbulence_tpu_torch.training.factory import instantiate_data_and_task
from test_torch_losses import ReplayDraws
from test_torch_train import F32, _assert_changes_close

BUCKET = 512
FRAMES = 12  # per case of synthetic_root
KW = dict(discard_first_seconds=-1.0, eval_batch_size=2, val_samples=2, seed=7)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def case_bytes(root) -> int:
    """The first train case's bytes in the JAX cache, reckoned here: its 12
    frames x cells padded to the bucket x 4 channels x 2 bytes."""
    with open_case_file(sorted((root / "train").glob("*/data.h5"))[0]) as f:
        n = f["data/u"].shape[1]
    return FRAMES * -(-n // BUCKET) * BUCKET * 4 * 2


def settings(root, frames=True):
    first = 1.5 * case_bytes(root) / 1e9  # one case fits, two do not
    out = {"whole-split": dict(device_cache_gb=1.0), "first-case": dict(device_cache_gb=first)}
    if frames:
        out["bf16-no-cache"] = dict(transfer_dtype="bfloat16")
    return out


def snapshot(batches):
    """(case, t, dtype, f32 cells) of each batch as it comes: JAX's pooled
    buffers are reused, so each is copied at once."""
    out = []
    for b in batches:
        cells = b.cells.float().numpy() if isinstance(b.cells, torch.Tensor) else np.array(b.cells, np.float32)
        out.append((b.metadata.case_name, np.asarray(b.t).tolist(), str(b.cells.dtype).split(".")[-1], cells))
    return out


def assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for (case, t, dtype, cells), (jcase, jt, jdtype, jcells) in zip(got, want):
        assert (case, t, dtype) == (jcase, jt, jdtype)
        n = cells.shape[-2]
        np.testing.assert_array_equal(cells, jcells[..., :n, :])
        assert not jcells[..., n:, :].any()  # JAX's bucket padding


@pytest.mark.parametrize("batch_size", [3, 16])
@pytest.mark.parametrize("setting", ["whole-split", "first-case", "bf16-no-cache"])
def test_frame_batches_match_jax(synthetic_root, setting, batch_size):
    """Batches of 3 repeat no frame and come sorted; batches of 16 top a
    case's 12 frames up with 4 of them again (JAX's cache and pooled
    collation refuse those: the sampler's order, f32 read, then the bf16
    transfer)."""
    kw = dict(KW, batch_size=batch_size, **settings(synthetic_root)[setting])
    jdm = jdataset.DataModule(synthetic_root, device_prefetch=True, cell_bucket=BUCKET, **kw)
    jdm.setup("fit")
    dm = dataset.DataModule(synthetic_root, **kw).setup("fit")
    for epoch in (0, 1):
        want = snapshot(jdm.train_batches(epoch))
        got = snapshot(dm.train_batches(epoch))
        assert_batches_equal(got, want)
        assert {b[2] for b in got} == {"bfloat16"}
        assert all(b[1] == sorted(b[1]) for b in got) == (batch_size == 3)
    # The settings do what they say in JAX: the cache holds both cases, the
    # first only (and is full), or is off; no batch of 16 is served by it.
    cache = jdm.device_cache
    if setting == "bf16-no-cache":
        assert cache is None
    else:
        held = 2 if setting == "whole-split" and batch_size == 3 else int(batch_size == 3)
        assert len(cache._frames) == held and cache.full == (setting == "first-case" and batch_size == 3)
    # Validation batches stay f32 and as they were.
    assert_batches_equal(snapshot(dm.val_batches()), snapshot(jdm.val_batches()))
    assert all(isinstance(b.cells, np.ndarray) and b.cells.dtype == np.float32 for b in dm.val_batches())


def test_transfer_dtype_is_checked_as_in_jax(synthetic_root):
    with pytest.raises(ValueError, match="transfer_dtype must be"):
        dataset.DataModule(synthetic_root, transfer_dtype="float16")
    with pytest.raises(ValueError, match="transfer_dtype must be"):
        jdataset.DataModule(synthetic_root, transfer_dtype="float16")
    assert dataset.DataModule(synthetic_root, transfer_dtype="float32").transfer_dtype is None
    assert dataset.DataModule(synthetic_root, device_cache_gb=0.5).transfer_dtype == "bfloat16"
    assert dataset.DataModule(synthetic_root, device_cache_gb=0.5, transfer_dtype="float32").transfer_dtype is None


SEQ_KW = dict(KW, batch_size=2, seq_len=3, eval_seq_len=4, cell_bucket=BUCKET)


@pytest.mark.parametrize("setting", ["whole-split", "first-case", "eval-cache"])
def test_sequence_batches_match_jax(synthetic_root, setting):
    """Windows of two epochs in the sampler's order: bf16 for the cases the
    JAX cache holds, f32 for the rest; JAX's ``eval_device_cache_gb``, which
    the port does not take, changes no value, train or eval."""
    extra = settings(synthetic_root, frames=False).get(setting, {})
    jextra = extra or dict(eval_device_cache_gb=1.0)
    jdm = jsequence.SequenceDataModule(synthetic_root, **SEQ_KW, **jextra)
    jdm.setup("fit")
    dm = sequence.SequenceDataModule(synthetic_root, **SEQ_KW, **extra).setup("fit")
    for epoch in (0, 1):
        got = snapshot(dm.train_batches(epoch))
        assert_batches_equal(got, snapshot(jdm.train_batches(epoch)))
        dtypes = {b[0]: b[2] for b in got}
        if setting == "whole-split":
            assert set(dtypes.values()) == {"bfloat16"}
        elif setting == "first-case":
            assert sorted(dtypes.values()) == ["bfloat16", "float32"] and dtypes[got[0][0]] == "bfloat16"
        else:
            assert set(dtypes.values()) == {"float32"}
    if setting != "eval-cache":
        held = 2 if setting == "whole-split" else 1
        # The window cache holds every frame a window reaches: all 12 here.
        assert jdm.train_cache.used == dm.train_cache.used == held * case_bytes(synthetic_root)
    assert_batches_equal(snapshot(dm.val_batches()), snapshot(jdm.val_batches()))


STEP_OVERRIDES = [
    "model=diffusion", "data.discard_first_seconds=-1", "data.val_samples=2", "data.eval_batch_size=2",
    f"data.cell_bucket={BUCKET}", "data.device_cache_gb=1", "model.batch_size=3", "model.dim=8",
    "model.u_net_levels=1", "model.timesteps=20", "model.learning_rate=0.5", "model.min_learning_rate=5e-3",
    "model.ema_decay=0.9",
]


@pytest.fixture(scope="module")
def jax_step(synthetic_root, tmp_path_factory):
    """The JAX factory's task on its first cached batch: the batch, the
    starting parameters, the step's loss and parameters and its rng."""
    out = tmp_path_factory.mktemp("jax-step")
    config = jconfig.parse_cli_overrides(
        STEP_OVERRIDES + [f"data.root={synthetic_root}", f"trainer.out_dir={out}"]).resolved()
    jdm, jtask = j_instantiate(config)
    jbatch = next(iter(jdm.train_batches(0)))
    assert jbatch.cells.dtype == jnp.bfloat16
    state = jtask.init_state(jax.random.PRNGKey(0), jbatch)
    start = jax.tree_util.tree_map(np.array, state.params)
    rng = jax.random.PRNGKey(11)
    model_input = np.asarray(jax.jit(lambda c, g: jtask._model_input(c, g).astype(jnp.float32))(
        jbatch.cells, jbatch.grid))
    state, metrics = jtask.training_step(state, jbatch, rng)
    return dict(task=jtask, batch=jbatch, start=start, rng=rng, model_input=model_input,
                loss=float(metrics["train/loss"]), params=jax.tree_util.tree_map(np.array, state.params))


def port_task(root, tmp_path):
    config = tconfig.parse_cli_overrides(
        STEP_OVERRIDES + [f"data.root={root}", f"trainer.out_dir={tmp_path}"]).resolved()
    return instantiate_data_and_task(config, "cpu")


def test_bf16_frames_enter_the_task_as_in_jax(synthetic_root, jax_step, tmp_path):
    """The diffusion task's input from the bf16 batch, as JAX's jitted step
    computes it, bit for bit; the normalisation in bf16 would miss it."""
    dm, task = port_task(synthetic_root, tmp_path)
    batch = next(iter(dm.train_batches(0)))
    assert batch.cells.dtype == torch.bfloat16 and batch.grid.dirichlet_idx.numel()
    x = task._model_input(batch.cells, batch.grid)
    assert x.dtype == torch.float32
    np.testing.assert_array_equal(x.numpy(), jax_step["model_input"])
    per_op = task.normalizer.normalize(embed_cells(batch.cells, batch.grid)).float().numpy()
    assert not np.array_equal(per_op, jax_step["model_input"])


def test_bf16_windows_enter_the_regression_task_as_in_jax(synthetic_root, tmp_path):
    """TF-Net's input from a bf16 window batch under ``data.device_cache_gb``
    (f32 after JAX's cast, ``regression_task.py:150``), bit for bit."""
    overrides = ["model=tfnet", f"data.root={synthetic_root}", "data.discard_first_seconds=-1",
                 f"data.cell_bucket={BUCKET}", "data.device_cache_gb=1", "data.val_samples=2",
                 "data.eval_batch_size=2", "model.batch_size=2", "model.context_window=4", "model.unroll_steps=1",
                 "model.eval_unroll_steps=2", "model.temporal_filtering_length=2"]
    jdm, jtask = j_instantiate(jconfig.parse_cli_overrides(overrides + [f"trainer.out_dir={tmp_path}/j"]).resolved())
    dm, task = instantiate_data_and_task(
        tconfig.parse_cli_overrides(overrides + [f"trainer.out_dir={tmp_path}/t"]).resolved(), "cpu")
    jbatch, batch = next(iter(jdm.train_batches(0))), next(iter(dm.train_batches(0)))
    assert jbatch.cells.dtype == jnp.bfloat16 and batch.cells.dtype == torch.bfloat16
    want = np.asarray(jax.jit(jtask._model_input)(jbatch.cells, jbatch.grid))
    got = task._model_input(batch.cells, batch.grid)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def jax_bf16_noise(key, shape) -> np.ndarray:
    """JAX's loss noise on bf16 frames, as its jitted step computes it: the
    bf16 normal, kept in f32."""
    return np.asarray(jax.jit(lambda k: jax.random.normal(k, shape, dtype=jnp.bfloat16).astype(jnp.float32))(key))


def test_bf16_normal_levels_match_jax():
    """The 128 values of the law, bit for bit, are those of JAX's jitted
    bf16 draw, each about as frequent there (8 random bits, halved) and in
    the port's draw."""
    levels = bf16_normal_levels(torch.device("cpu")).numpy()
    values, counts = np.unique(jax_bf16_noise(jax.random.PRNGKey(3), (256 * 1024,)), return_counts=True)
    np.testing.assert_array_equal(values, levels)
    assert np.all(np.diff(levels) > 0) and counts.min() > 0.85 * 2048 and counts.max() < 1.15 * 2048
    law = Bf16NormalLaw(GeneratorNoise(torch.Generator().manual_seed(3), "cpu"))
    draws = law((4, 256, 256))
    assert draws.shape == (4, 256, 256) and draws.dtype == torch.float32
    got, counts = np.unique(draws.numpy(), return_counts=True)
    np.testing.assert_array_equal(got, levels)
    assert counts.min() > 0.85 * 2048 and counts.max() < 1.15 * 2048
    assert law.randint(5, 20).shape == (5,)


class RecordedDraws:
    """A noise source that records what the task asks of it."""

    def __init__(self):
        self.noise, self.calls = GeneratorNoise(torch.Generator().manual_seed(0), "cpu"), []

    def __call__(self, shape):
        self.calls.append(("normal", tuple(shape)))
        return self.noise(shape)

    def randint(self, n, high):
        self.calls.append(("randint", n, high))
        return self.noise.randint(n, high)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_train_step_draws_noise_at_the_frames_dtype(synthetic_root, tmp_path, dtype):
    """bf16 frames draw their noise as 128 levels (one ``randint`` over the
    elements, after the timesteps'); f32 frames draw f32 normals."""
    dm, task = port_task(synthetic_root, tmp_path)
    batch = next(iter(dm.train_batches(0)))
    task.init_weights(torch.Generator().manual_seed(0))
    draws = RecordedDraws()
    task.training_step(batch.cells.to(getattr(torch, dtype)), batch.grid, draws)
    shape = (batch.cells.shape[0], *batch.grid.shape, 4)
    noise = ("randint", int(np.prod(shape)), 128) if dtype == "bfloat16" else ("normal", shape)
    assert draws.calls == [("randint", shape[0], 20), noise]


def test_train_step_on_cached_frames_matches_jax(synthetic_root, jax_step, tmp_path):
    """One f32-compute step under ``data.device_cache_gb=1`` through both
    factories from the same parameters and draws (JAX's bf16 noise, handed
    to the port as its levels)."""
    dm, task = port_task(synthetic_root, tmp_path)
    batch = next(iter(dm.train_batches(0)))
    jbatch = jax_step["batch"]
    np.testing.assert_array_equal(batch.t, jbatch.t)
    task.load_flax_params(jax_step["start"])
    start = {k: v.numpy().copy() for k, v in task.net.state_dict().items()}
    rng_t, rng_noise = jax.random.split(jax_step["rng"])
    shape = (batch.cells.shape[0], *batch.grid.shape, 4)
    noise = jax_bf16_noise(rng_noise, shape).reshape(-1)
    levels = bf16_normal_levels(torch.device("cpu")).numpy()
    k = np.searchsorted(levels, noise)
    np.testing.assert_array_equal(levels[k], noise)
    draws = [np.asarray(jax.random.randint(rng_t, (shape[0],), 0, 20, dtype=jnp.int32)), k]
    loss = task.training_step(batch.cells, batch.grid, ReplayDraws(draws))["train/loss"]
    np.testing.assert_allclose(float(loss), jax_step["loss"], **F32["loss"])
    want = {k: v.numpy() for k, v in torch_state_dict_from_flax(jax_step["params"]).items()}
    got = {k: v.numpy() for k, v in task.net.state_dict().items()}
    _assert_changes_close(got, want, start, F32, "parameters after the step")
