"""The validation slice as a whole: the JAX package's ``DiffusionTask`` and
the port's, built from one 2-level ``ModelConfig`` (dim 8, T = 20, DDIM-4)
with the same flax parameters (``load_flax_params``), each given the same
val batch by its own ``DataModule`` (the port's from the ``.h5`` dataset and
from its ``.npyd`` conversion), each sampling with the same noise (JAX's
draws replayed).  ``eval_step`` and ``on_eval_end(expensive=True)`` with the
exact Wasserstein solver: ``val/sample-u-std`` at rtol 2e-4 and the metrics
at rtol 1e-3."""

import dataclasses
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from generative_turbulence_tpu.data import dataset as jdataset
from generative_turbulence_tpu.data.schema import FieldStats as JFieldStats
from generative_turbulence_tpu.eval import metrics as jmetrics
from generative_turbulence_tpu.training import config as jconfig
from generative_turbulence_tpu.training.diffusion_task import DiffusionTask as JDiffusionTask
from generative_turbulence_tpu_torch.data.dataset import DataModule
from generative_turbulence_tpu_torch.data.schema import FieldStats
from generative_turbulence_tpu_torch.eval import metrics as tmetrics
from generative_turbulence_tpu_torch.toolchain.h5_to_npyd import convert_tree
from generative_turbulence_tpu_torch.training import config as tconfig
from generative_turbulence_tpu_torch.training.diffusion_task import DiffusionTask
from test_torch_diffusion import Replay, jax_normals
from test_torch_task import OVERRIDES

EVAL = dict(eval_batch_size=2, val_samples=2)  # 2 frames: 16 exact EMDs per metric call
METRICS = ["val/tke", "val/tke-middle", "val/tke-back", "val/wasserstein", "val/max-mean-tke-pos"]


def _one_worker(metrics):
    """The exact Wasserstein on this process (no pool at this size)."""
    for metric in metrics:
        if isinstance(metric, (jmetrics.WassersteinMetric, tmetrics.WassersteinMetric)):
            metric.max_workers = 1


@pytest.fixture(scope="module")
def setup(synthetic_root, tmp_path_factory):
    """The JAX run (task, parameters, key, its eval_step and on_eval_end
    outputs) and the config shared by both packages."""
    args = OVERRIDES + ["model.sampler=ddim"]
    jcfg, tcfg = jconfig.parse_cli_overrides(args).model, tconfig.parse_cli_overrides(args).model
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jstats = JFieldStats.from_file(synthetic_root / "stats.pickle")
    jtask = JDiffusionTask(jcfg, jstats, synthetic_root, tmp_path_factory.mktemp("jax-samples"),
                           wasserstein_solver="exact")
    _one_worker(jtask.val_metrics.metrics)
    jdm = jdataset.DataModule(synthetic_root, cell_bucket=0, buffer_pool=False, device_prefetch=False, **EVAL)
    jdm.setup("validate")
    jbatch = next(iter(jdm.val_batches()))
    x0 = jnp.zeros((1, *jbatch.grid.shape, 4))
    params = jax.jit(jtask.net.init)(jax.random.PRNGKey(0), x0, jnp.zeros((1,), jnp.int32), jbatch.grid.cell_types)
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = jax.random.PRNGKey(5)
    jtask.on_eval_start("val")
    step = jtask.eval_step(SimpleNamespace(params=params, ema_params=None), jbatch, rng, "val")
    values = jtask.on_eval_end(jstats, "val", expensive=True)
    npyd_root = tmp_path_factory.mktemp("npyd") / "root"
    shutil.copytree(synthetic_root, npyd_root)
    convert_tree(npyd_root)
    return SimpleNamespace(cfg=tcfg, params=params, rng=rng, step=step, values=values, jbatch=jbatch,
                           roots={"h5": synthetic_root, "npyd": npyd_root})


@pytest.fixture(scope="module", params=["h5", "npyd"])
def port_run(setup, request, tmp_path_factory):
    root = setup.roots[request.param]
    dm = DataModule(root, **EVAL).setup("validate")
    task = DiffusionTask(setup.cfg, dm.stats, "cpu", data_root=root,
                         samples_root=tmp_path_factory.mktemp("samples"), wasserstein_solver="exact")
    _one_worker(task.metrics["val"].metrics)
    task.load_flax_params(setup.params)
    batch = next(iter(dm.val_batches()))
    steps = setup.cfg.ddim_steps

    def run():
        noise = Replay(jax_normals(setup.rng, (batch.batch_size, *batch.grid.shape, 4), steps, setup.cfg.noise_bcs))
        task.on_eval_start("val")
        step = task.eval_step(batch, noise, "val")
        assert not noise.draws
        return step

    step = run()
    values = task.on_eval_end(dm.stats, "val", expensive=True)
    return SimpleNamespace(task=task, dm=dm, batch=batch, step=step, values=values, run=run)


def test_the_same_val_batch(setup, port_run):
    np.testing.assert_array_equal(port_run.batch.cells, np.asarray(setup.jbatch.cells))
    assert port_run.batch.metadata.case_name == setup.jbatch.metadata.case_name


@pytest.mark.parametrize("name", ["val/sample-u-std", "val/sample-u-absmax"])
def test_eval_step_matches_jax(setup, port_run, name):
    assert sorted(port_run.step) == sorted(setup.step)
    np.testing.assert_allclose(port_run.step[name], setup.step[name], rtol=2e-4)


@pytest.mark.parametrize("name", METRICS)
def test_on_eval_end_matches_jax(setup, port_run, name):
    assert sorted(port_run.values) == sorted(setup.values)
    assert np.isfinite(port_run.values[name]) and port_run.values[name] >= 0
    np.testing.assert_allclose(port_run.values[name], setup.values[name], rtol=1e-3)


def test_samples_land_in_the_store(port_run):
    store = port_run.task.sample_stores["val"]
    assert store.samples_file.name == "val-samples.npyd"
    assert store.case_names == ["case-val-00"] and store.n_samples("case-val-00") == 2


def test_on_eval_start_resets_the_store(port_run):
    """A second evaluation replaces the first one's samples instead of
    adding to them."""
    store = port_run.task.sample_stores["val"]
    first = store.load_samples(port_run.batch.metadata).fields
    assert port_run.run() == port_run.step
    assert store.n_samples("case-val-00") == 2
    for v, values in store.load_samples(port_run.batch.metadata).fields.items():
        np.testing.assert_array_equal(values, first[v])


def test_expensive_metrics_follow_the_config(port_run, monkeypatch):
    """``expensive=False`` and ``cfg.compute_expensive_sample_metrics`` each
    leave out the point-cloud Wasserstein (the metrics at a small
    quadrature here: the gate, not the values, is under test)."""
    task = port_run.task
    monkeypatch.setattr(task.metrics["val"], "metrics", [
        tmetrics.WassersteinTKE(n_sphere=128, n_legendre=8, device="cpu"),
        tmetrics.WassersteinMetric(max_workers=1, device="cpu"),
    ])
    cheap = task.on_eval_end(port_run.dm.stats, "val", expensive=False)
    assert "val/wasserstein" not in cheap and "val/tke" in cheap
    assert "val/wasserstein" in task.on_eval_end(port_run.dm.stats, "val", expensive=True)
    monkeypatch.setattr(task, "cfg", dataclasses.replace(task.cfg, compute_expensive_sample_metrics=False))
    assert "val/wasserstein" not in task.on_eval_end(port_run.dm.stats, "val", expensive=True)


def test_evaluation_needs_a_samples_root(setup):
    stats = FieldStats.from_file(setup.roots["h5"] / "stats.pickle")
    with pytest.raises(ValueError, match="samples_root"):
        DiffusionTask(setup.cfg, stats, "cpu", data_root=setup.roots["h5"])
    task = DiffusionTask(setup.cfg, stats, "cpu")  # sampling and training only
    assert task.sample_stores == {} and task.metrics == {}
