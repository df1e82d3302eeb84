"""The whole slice: cells -> embed -> normalize -> sampler with the
epsilon-network -> denormalize -> gather, in the JAX package and in the port
(``training.diffusion_task.sample``), with the same weights and noise; and
the port's in-memory synthetic case against the JAX file-based one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_turbulence_tpu.data import grid as jgrid
from generative_turbulence_tpu.data.schema import read_metadata as j_read_metadata
from generative_turbulence_tpu.data.synthetic import generate_case as j_generate_case
from generative_turbulence_tpu.data.variables import Variable as JVariable
from generative_turbulence_tpu.diffusion import GaussianDiffusion as JGaussianDiffusion
from generative_turbulence_tpu.models import Conditioning as JConditioning
from generative_turbulence_tpu.models import DenoisingModel as JDenoisingModel
from generative_turbulence_tpu.models import Normalizer as JNormalizer
from generative_turbulence_tpu_torch.data import grid as tgrid
from generative_turbulence_tpu_torch.data.schema import read_metadata
from generative_turbulence_tpu_torch.data.synthetic import build_case, generate_case
from generative_turbulence_tpu_torch.data.variables import Variable, stack_channels
from generative_turbulence_tpu_torch.diffusion.gaussian import GaussianDiffusion
from generative_turbulence_tpu_torch.models.conditioning import Conditioning
from generative_turbulence_tpu_torch.models.normalization import Normalizer
from generative_turbulence_tpu_torch.models.unet import DenoisingModel
from generative_turbulence_tpu_torch.toolchain.from_flax import torch_state_dict_from_flax
from generative_turbulence_tpu_torch.training.diffusion_task import sample
from test_torch_diffusion import Replay, jax_normals

CASE = dict(cell_counts=(16, 8, 8), seed=3)  # padded 18x10x10
T = 20
VARIABLES = ("u", "p")


@pytest.fixture(scope="module")
def case_file(tmp_path_factory):
    return j_generate_case(tmp_path_factory.mktemp("slice") / "case", n_frames=2, **CASE)


@pytest.mark.parametrize("sampler", ["ddim", "ddpm"])
def test_sample_slice_matches_jax(case_file, sampler):
    jvars = tuple(JVariable(n) for n in VARIABLES)
    tvars = tuple(Variable(n) for n in VARIABLES)
    jgm = jgrid.GridMap.from_metadata(j_read_metadata(case_file), jvars, cached=False)
    tgm = tgrid.GridMap.from_metadata(read_metadata(case_file), tvars, device="cpu")

    _, fields = build_case(n_frames=2, **CASE)
    cells = stack_channels(fields, tvars)  # (2, n_cells, 4): two frames as a batch
    mean, std = cells.mean(axis=(0, 1)), cells.std(axis=(0, 1))

    config = dict(out_features=4, timesteps=T, dim=8, u_net_levels=2)
    jm = JDenoisingModel(**config, conditioning=JConditioning())
    x0 = jnp.zeros((1, *jgm.shape, 4))
    params = jm.init(jax.random.PRNGKey(0), x0, jnp.zeros((1,), jnp.int32), jgm.cell_types)
    params = jax.tree_util.tree_map(np.asarray, params)
    jd = JGaussianDiffusion.create(timesteps=T, noise_bcs=True)
    jn = JNormalizer(mean=mean, std=std)
    rng = jax.random.PRNGKey(11)

    def eps_fn(x_t, t):
        return jm.apply(params, x_t, t, jgm.cell_types)

    x_bcs = jn.normalize(jgrid.embed_cells(jnp.asarray(cells), jgm))
    if sampler == "ddim":
        x = jd.ddim_sample_loop(eps_fn, x_bcs, jgm, rng, num_steps=4, eta=0.0)
        draws = jax_normals(rng, x_bcs.shape, 4, True)
    else:
        x = jd.p_sample_loop(eps_fn, x_bcs, jgm, rng, start_from=3)
        draws = jax_normals(rng, x_bcs.shape, 3, True)
    want = np.asarray(jgrid.gather_cells(jn.denormalize(x), jgm))

    tm = DenoisingModel(**config, conditioning=Conditioning())
    tm.load_state_dict(torch_state_dict_from_flax(params))
    td = GaussianDiffusion.create(timesteps=T, noise_bcs=True)
    noise = Replay(draws)
    got = sample(
        tm, td, Normalizer(mean=mean, std=std), torch.from_numpy(cells), tgm,
        sampler=sampler, ddim_steps=4, ddim_eta=0.0, noise=noise, start_from=3,
    ).numpy()
    assert not noise.draws
    assert got.shape == want.shape == (2, tgm.n_cells, 4)
    # The sampler tolerance in units of the output's scale (normalized):
    # DDIM from pure noise through an untrained net reaches |x| ~ 3.6e3, with
    # a measured max abs error of 5.4e-3 (1.5e-6 of the scale); the 3-step
    # ancestral run stays at |x| ~ 78 with a max abs error of 7.6e-6.
    got_n, want_n = got / std, want / std
    scale = np.abs(want_n).max()
    np.testing.assert_allclose(got_n / scale, want_n / scale, rtol=1e-3, atol=1e-4)


def test_in_memory_case_matches_jax_file(case_file):
    jmeta = j_read_metadata(case_file)
    meta, fields = build_case(n_frames=2, **CASE)
    assert meta.file is None
    for name in ("cell_counts", "cell_idx", "h", "inside_mask", "cell_types", "unpadded_cell_idx"):
        np.testing.assert_array_equal(getattr(meta, name), getattr(jmeta, name), err_msg=name)
    assert meta.nu == jmeta.nu
    assert sorted(meta.boundaries) == sorted(jmeta.boundaries)
    for name, desc in meta.boundaries.items():
        np.testing.assert_array_equal(desc["idx"], jmeta.boundaries[name]["idx"])
    for tv, jv in zip(tuple(Variable(n) for n in ("u", "p", "k")), (JVariable.U, JVariable.P, JVariable.K)):
        d_idx, d_vals = meta.dirichlet_table([tv])
        j_idx, j_vals = jmeta.dirichlet_table([jv])
        np.testing.assert_array_equal(d_idx, j_idx)
        np.testing.assert_array_equal(d_vals, j_vals)
    for (p, s), (jp, js) in zip(meta.holes, jmeta.holes):
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(s, js)

    import h5py

    with h5py.File(case_file, "r") as f:
        for v in (Variable.U, Variable.P, Variable.K, Variable.NUT):
            stored = np.asarray(f["data"][v.key])
            np.testing.assert_array_equal(fields[v].reshape(stored.shape), stored)


def test_port_file_roundtrip(case_file, tmp_path):
    file = generate_case(tmp_path / "case", n_frames=2, **CASE)
    meta, jmeta = read_metadata(file), j_read_metadata(case_file)
    for name in ("cell_counts", "cell_idx", "h", "cell_types"):
        np.testing.assert_array_equal(getattr(meta, name), getattr(jmeta, name), err_msg=name)
    np.testing.assert_array_equal(
        meta.dirichlet_table([Variable.U, Variable.P])[1],
        jmeta.dirichlet_table([JVariable.U, JVariable.P])[1],
    )
