"""The slice as a whole: a JAX ``DiffusionTask`` and the port's
``DiffusionTask`` built from the same ``ModelConfig`` (2 U-Net levels) and
``FieldStats``, the port loaded with the JAX parameters through
``load_flax_params``, both sampling with the same noise (the JAX key
schedule replayed).  Plus the 2-level net at the shapes grid: which blocks
take the fused chain, and the bottleneck's token count."""

import dataclasses

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
from generative_turbulence_tpu.training.diffusion_task import DiffusionTask as JDiffusionTask
from generative_turbulence_tpu_torch.data import grid as tgrid
from generative_turbulence_tpu_torch.data.schema import FieldStats, read_metadata
from generative_turbulence_tpu_torch.data.synthetic import build_case
from generative_turbulence_tpu_torch.data.variables import Variable, stack_channels
from generative_turbulence_tpu_torch.models import blocks as tblocks
from generative_turbulence_tpu_torch.ops import attention as tattention
from generative_turbulence_tpu_torch.ops import cuda_kernels as ck
from generative_turbulence_tpu_torch.ops.interp import downsample_size
from generative_turbulence_tpu_torch.training import config as tconfig
from generative_turbulence_tpu_torch.training.diffusion_task import DiffusionTask
from test_torch_diffusion import Replay, jax_normals

CASE = dict(cell_counts=(16, 8, 8), seed=3)  # padded 18x10x10
OVERRIDES = ["model.dim=8", "model.u_net_levels=2", "model.timesteps=20", "model.ddim_steps=4"]


def field_stats(fields):
    """stats.pickle entries of u, p and norm(u) over in-memory frames."""
    stats = {}
    u = fields[Variable.U].reshape(-1, 3)
    for key, values in (("u", u), ("p", fields[Variable.P].reshape(-1, 1)),
                        ("norm(u)", np.linalg.norm(u, axis=-1, keepdims=True))):
        stats[key] = {name: fn(values, axis=0).astype(np.float32) for name, fn in
                      (("min", np.min), ("max", np.max), ("mean", np.mean), ("std", np.std))}
    return stats


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    file = j_generate_case(tmp_path_factory.mktemp("task") / "case", n_frames=2, **CASE)
    jvars, tvars = (JVariable.U, JVariable.P), (Variable.U, Variable.P)
    jgm = jgrid.GridMap.from_metadata(j_read_metadata(file), jvars, cached=False)
    tgm = tgrid.GridMap.from_metadata(read_metadata(file), tvars, device="cpu")
    _, fields = build_case(n_frames=2, **CASE)
    cells = stack_channels(fields, tvars)  # (2, n_cells, 4): two frames as a batch
    return jgm, tgm, cells, field_stats(fields)


@pytest.mark.parametrize(
    "extra",
    [["model.sampler=ddim"], ["model.sampler=ddpm"],
     ["model.sampler=ddim", "model.clip_denoised=true", "model.clip_mode=envelope"]],
    ids=["ddim", "ddpm", "ddim-envelope-clip"],
)
def test_task_sample_matches_jax(case, extra, tmp_path):
    jgm, tgm, cells, stats = case
    args = OVERRIDES + extra
    jcfg = jconfig.parse_cli_overrides(args).model
    tcfg = tconfig.parse_cli_overrides(args).model
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)

    jtask = JDiffusionTask(jcfg, JFieldStats(stats), tmp_path, tmp_path / "samples")
    x0 = jnp.zeros((1, *jgm.shape, 4))
    params = jtask.net.init(jax.random.PRNGKey(0), x0, jnp.zeros((1,), jnp.int32), jgm.cell_types)
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = jax.random.PRNGKey(11)
    want = np.asarray(jtask._sample_fn(params, jnp.asarray(cells), jgm, rng))

    task = DiffusionTask(tcfg, FieldStats(stats), "cpu")
    task.load_flax_params(params)
    np.testing.assert_array_equal(task.normalizer.std, np.asarray(jtask.normalizer.std))
    if tcfg.clip_denoised:
        for got_b, want_b in zip(task.diffusion.clip_bounds, jtask.diffusion.clip_bounds):
            np.testing.assert_array_equal(got_b, np.asarray(want_b))
    n_steps = tcfg.ddim_steps if tcfg.sampler == "ddim" else tcfg.timesteps
    noise = Replay(jax_normals(rng, (2, *tgm.shape, 4), n_steps, True))
    got = task.sample(torch.from_numpy(cells), tgm, noise).numpy()
    assert not noise.draws
    assert got.shape == want.shape == (2, tgm.n_cells, 4)
    # tests/test_torch_sample.py's sampler tolerance, in units of the
    # output's normalized scale.
    std = task.normalizer.std
    got_n, want_n = got / std, want / std
    scale = np.abs(want_n).max()
    np.testing.assert_allclose(got_n / scale, want_n / scale, rtol=1e-3, atol=1e-4)


def test_eval_net_shares_the_parameters(case):
    """bf16 training with f32 sampling: two nets, one set of parameters."""
    _, _, _, stats = case
    cfg = tconfig.parse_cli_overrides(
        OVERRIDES + ["model.compute_dtype=bfloat16", "model.eval_compute_dtype=float32"]
    ).model
    task = DiffusionTask(cfg, FieldStats(stats), "cpu")
    assert task.eval_net is not task.net
    assert task.net.dtype == torch.bfloat16 and task.eval_net.dtype is None
    pairs = list(zip(task.net.named_parameters(), task.eval_net.named_parameters()))
    assert len(pairs) == len(list(task.net.parameters())) > 0
    assert all(na == nb and pa is pb for (na, pa), (nb, pb) in pairs)
    task.net.init_weights(torch.Generator().manual_seed(1))
    w = task.eval_net.u_net.down_0.block1.conv.weight
    assert w is task.net.u_net.down_0.block1.conv.weight and float(w.detach().abs().sum()) > 0


def test_unknown_clip_mode_and_dtype_raise(case):
    stats = FieldStats(case[3])
    with pytest.raises(ValueError, match="clip_mode"):
        DiffusionTask(tconfig.parse_cli_overrides(OVERRIDES + ["model.clip_mode=box"]).model, stats, "cpu")
    with pytest.raises(ValueError, match="compute dtype"):
        DiffusionTask(
            tconfig.parse_cli_overrides(OVERRIDES + ["model.compute_dtype=float16"]).model, stats, "cpu"
        )


def test_task_defaults_to_the_card(case):
    """With no device named, the nets go to the card; without CUDA that
    raises torch's own error instead of falling back to the CPU."""
    cfg = tconfig.parse_cli_overrides(OVERRIDES).model
    if torch.cuda.is_available():
        assert next(DiffusionTask(cfg, FieldStats(case[3])).net.parameters()).is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            DiffusionTask(cfg, FieldStats(case[3]))


def test_two_level_shapes_grid_path():
    """``model.u_net_levels=2`` at the shapes grid (194x50x50, dim 32): the
    bottleneck holds 48x12x12 = 6912 tokens, so its full attention takes
    flash_attention, and the gate engages down_0, down_1, up_0 and
    decode_resnet (up_1 sees 128 + 128 = 256 input channels, above the
    160-channel envelope; the centre blocks are below the size floor)."""
    cfg = tconfig.parse_cli_overrides(["model.u_net_levels=2"]).model
    with torch.device("meta"):
        task = DiffusionTask(cfg, FieldStats(field_stats(build_case(cell_counts=(8, 6, 6))[1])), "meta")
    model = task.net
    sizes = [(194, 50, 50)]
    for _ in range(cfg.u_net_levels):
        sizes.append(downsample_size(sizes[-1]))
    assert sizes[-1] == (48, 12, 12)
    assert int(np.prod(sizes[-1])) == 6912 >= tattention.FLASH_MIN_TOKENS
    engaged = {}
    for name, module in model.named_modules():
        if not isinstance(module, tblocks.ResnetBlock):
            continue
        leaf = name.rsplit(".", 1)[-1]
        level = int(leaf.split("_")[1]) if leaf[:3] in ("dow", "up_") else (
            cfg.u_net_levels if leaf.startswith("center") else 0
        )
        c_in = module.block1.conv.weight.shape[1]
        x = torch.empty((8, *sizes[level], c_in), device="meta")
        if ck.fused_block_applicable(x, c_in, module.features):
            engaged[name] = (sizes[level], c_in, module.features)
    assert engaged == {
        "u_net.down_0": ((194, 50, 50), 64, 64),
        "u_net.down_1": ((97, 25, 25), 64, 128),
        "u_net.up_0": ((194, 50, 50), 128, 32),
        "decode_resnet": ((194, 50, 50), 32, 32),
    }
    attention = model.u_net.center_attention
    assert (attention.kind, attention.heads, attention.dim_head) == ("full", 4, 32)
