"""The port's GridMap / embed_cells / gather_cells / masked_mean against the
JAX package on a small synthetic case."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from generative_turbulence_tpu.data import grid as jgrid
from generative_turbulence_tpu.data.schema import read_metadata as j_read_metadata
from generative_turbulence_tpu.data.synthetic import generate_case as j_generate_case
from generative_turbulence_tpu.data.variables import Variable as JVariable
from generative_turbulence_tpu_torch.data import grid as tgrid
from generative_turbulence_tpu_torch.data.schema import read_metadata
from generative_turbulence_tpu_torch.data.variables import Variable

VARIABLE_SETS = [("u", "p"), ("u", "p", "k", "nut")]


@pytest.fixture(scope="module")
def case_file(tmp_path_factory):
    return j_generate_case(
        tmp_path_factory.mktemp("grid") / "case", cell_counts=(16, 8, 8), n_frames=2, seed=4
    )


def _grids(case_file, names):
    jgm = jgrid.GridMap.from_metadata(
        j_read_metadata(case_file), tuple(JVariable(n) for n in names), cached=False
    )
    tgm = tgrid.GridMap.from_metadata(
        read_metadata(case_file), tuple(Variable(n) for n in names), device="cpu"
    )
    return jgm, tgm


@pytest.mark.parametrize("names", VARIABLE_SETS)
def test_gridmap_fields_match(case_file, names):
    jgm, tgm = _grids(case_file, names)
    assert tgm.shape == jgm.shape == (18, 10, 10)
    assert tgm.n_features == jgm.n_features
    assert tgm.n_cells == jgm.n_cells
    for field in ("cell_idx", "dirichlet_idx", "dirichlet_vals", "cell_types", "inside_mask", "h"):
        np.testing.assert_array_equal(
            getattr(tgm, field).numpy(), np.asarray(getattr(jgm, field)), err_msg=field
        )


@pytest.mark.parametrize("names", VARIABLE_SETS)
def test_embed_gather_roundtrip_and_dirichlet(case_file, names):
    jgm, tgm = _grids(case_file, names)
    rng = np.random.default_rng(0)
    values = rng.normal(size=(3, tgm.n_cells, tgm.n_features)).astype(np.float32)
    want = np.asarray(jgrid.embed_cells(jnp.asarray(values), jgm))
    dense = tgrid.embed_cells(torch.from_numpy(values), tgm)
    np.testing.assert_array_equal(dense.numpy(), want)
    np.testing.assert_array_equal(tgrid.gather_cells(dense, tgm).numpy(), values)
    np.testing.assert_array_equal(
        tgrid.gather_cells(dense, tgm).numpy(), np.asarray(jgrid.gather_cells(jnp.asarray(want), jgm))
    )
    # The inlet plane carries the prescribed inflow u_x = 20 at its cells.
    inlet = tgm.cell_types.numpy() == 3
    assert inlet.any()
    np.testing.assert_array_equal(dense.numpy()[:, inlet, 0], 20.0)


def test_gridmap_defaults_to_the_card(case_file):
    """With no device named, the grid's tensors go to the card; without
    CUDA that raises torch's own error instead of falling back to the CPU."""
    meta, variables = read_metadata(case_file), (Variable.U, Variable.P)
    if torch.cuda.is_available():
        assert tgrid.GridMap.from_metadata(meta, variables).cell_idx.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tgrid.GridMap.from_metadata(meta, variables)


def test_masked_mean_and_apply_inside(case_file):
    jgm, tgm = _grids(case_file, ("u", "p"))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, *tgm.shape, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tgrid.masked_mean(torch.from_numpy(x), tgm).numpy(),
        np.asarray(jgrid.masked_mean(jnp.asarray(x), jgm)),
        rtol=2e-4, atol=2e-5,
    )
    np.testing.assert_array_equal(
        tgrid.apply_inside(torch.from_numpy(x), tgm).numpy(),
        np.asarray(jgrid.apply_inside(jnp.asarray(x), jgm)),
    )
