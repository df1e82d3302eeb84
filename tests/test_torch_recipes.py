"""The paper's run recipes in the port: ``configs/shapes_*.json`` against
``load_config`` of the JAX package's ``config/shapes_*.yaml``, each recipe of
``scripts/run_shapes.py`` against the ``Config`` that JAX's
``parse_cli_overrides`` makes of its script's argument list (read from
``scripts/run-shapes-*.sh``), and the r5 recipe and the TF-Net one run end
to end on the CPU through ``run_shapes.main`` on a tiny dataset: bf16
training frames in JAX's order, 2 optimizer updates of 2 micro-steps, one
validation whose sampler clips to the training envelope."""

import json
import math
import shlex
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from generative_turbulence_tpu.training import config as jconfig
from generative_turbulence_tpu_torch.data.schema import FieldStats
from generative_turbulence_tpu_torch.data.synthetic import generate_synthetic_dataset
from generative_turbulence_tpu_torch.scripts import run_shapes
from generative_turbulence_tpu_torch.training import config as tconfig
from generative_turbulence_tpu_torch.training.diffusion_task import DiffusionTask
from generative_turbulence_tpu_torch.training.regression_task import TFNetTask

REPO = Path(__file__).resolve().parent.parent
FAMILIES = ("diffusion", "tfnet", "dilresnet")
# Each recipe's JAX argument list: its script's, or (``diffusion``) the config
# the paper's diffusion run names, which no script runs.
SCRIPTS = {"diffusion-r4": "run-shapes-diffusion-r4.sh", "diffusion-r5": "run-shapes-diffusion-r5.sh",
           "tfnet": "run-shapes-tfnet.sh", "dilresnet": "run-shapes-dilresnet.sh"}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def script_argv(name: str) -> list:
    """The arguments a ``run-shapes-*.sh`` script passes ``scripts/train.py``
    (before its ``"$@"``), config paths made absolute as its ``cd`` makes
    them."""
    if name == "diffusion":
        return [f"config={REPO / 'config' / 'shapes_diffusion.yaml'}"]
    text = (REPO / "scripts" / SCRIPTS[name]).read_text().replace("\\\n", " ")
    (line,) = [line for line in text.splitlines() if line.startswith("exec python scripts/train.py")]
    args = shlex.split(line)[3:]
    assert args[-1] == "$@"
    return [f"config={REPO / a[7:]}" if a.startswith("config=") else a for a in args[:-1]]


@pytest.mark.parametrize("family", FAMILIES)
def test_json_configs_equal_the_yaml(family):
    """The JSON file is the YAML's mapping after the numeric coercion, and
    loads to the same ``Config`` in the port as the YAML in JAX."""
    json_file = run_shapes.CONFIGS / f"shapes_{family}.json"
    yaml_file = REPO / "config" / f"shapes_{family}.yaml"
    assert json.loads(json_file.read_text()) == jconfig._coerce_numeric_strings(yaml.safe_load(yaml_file.read_text()))
    want = jconfig.load_config(str(yaml_file)).to_dict()
    assert tconfig.load_config(str(json_file)).to_dict() == want
    assert tconfig.load_config(str(yaml_file)).to_dict() == want


@pytest.mark.parametrize("extra", [[], ["trainer.max_steps=4", "data.root=elsewhere", "model.ddim_steps=10"]])
@pytest.mark.parametrize("name", list(run_shapes.RECIPES))
def test_recipes_resolve_to_the_jax_configs(name, extra):
    """Each recipe, with and without the caller's overrides after it, is
    the ``Config`` JAX's ``parse_cli_overrides`` gives its script's
    arguments (and the same overrides)."""
    want = jconfig.parse_cli_overrides(script_argv(name) + extra).resolved().to_dict()
    got = tconfig.parse_cli_overrides(run_shapes.recipe_argv(name, extra)).resolved().to_dict()
    assert got == want
    assert list(run_shapes.RECIPES) == [*SCRIPTS, "diffusion"]


def test_recipe_needs_a_gpu_unless_told(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match=r"torch.cuda.is_available\(\) is False"):
        run_shapes.main(["diffusion-r5"])
    assert list(tmp_path.iterdir()) == []


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """1 train and 1 val case of 8 frames at 10x6x6 cells, ``.npyd``."""
    return generate_synthetic_dataset(tmp_path_factory.mktemp("recipes") / "data", n_train_cases=1, n_val_cases=1,
                                      n_test_cases=0, n_frames=8, cell_counts=(10, 6, 6), seed=2, format="npyd")


CUTS = ["data.discard_first_seconds=-1", "model.compute_expensive_sample_metrics=false", "trainer.render_plots=false"]


def test_r5_recipe_runs_on_bf16_frames(tiny_root, tmp_path, monkeypatch):
    """``run_shapes diffusion-r5`` at dim 8, 1 level, T = 50 (the recipe's
    DDIM-50 walks every step), ``trainer.max_steps=4``: micro-batches of 3
    (batch 6, accumulation 2) of bf16 frames, 2 optimizer
    updates, then one validation that samples in f32 with x0 clipped to the
    training envelope's normalised bounds; a finite ``val/tke``."""
    seen, sampled = [], []
    step, sample = DiffusionTask.training_step, DiffusionTask.sample

    def recorded_step(task, cells, grid, noise):
        seen.append((task, cells.clone()))
        return step(task, cells, grid, noise)

    def recorded_sample(task, *args, **kwargs):
        sampled.append(task)
        return sample(task, *args, **kwargs)

    monkeypatch.setattr(DiffusionTask, "training_step", recorded_step)
    monkeypatch.setattr(DiffusionTask, "sample", recorded_sample)
    overrides = [f"data.root={tiny_root}", f"trainer.out_dir={tmp_path / 'run'}", "model.dim=8",
                 "model.u_net_levels=1", "model.timesteps=50", "trainer.max_steps=4", *CUTS]
    score = run_shapes.main(["diffusion-r5", "--device", "cpu", *overrides])
    assert math.isfinite(score)
    task = seen[0][0]
    assert [cells.shape[0] for _, cells in seen] == [3] * 4 and all(c.dtype == torch.bfloat16 for _, c in seen)
    assert task.opt_state.count == 2 and task.step == 4
    assert task.cfg.eval_compute_dtype == "float32" and task.cfg.ddim_steps == 50 and sampled == [task] * 2
    lo, hi = FieldStats.from_file(tiny_root / "stats.pickle").envelope(task.variables)
    mean, std = task.normalizer.mean, task.normalizer.std
    assert task.diffusion.clip_denoised
    for got, want in zip(task.diffusion.clip_bounds, ((lo - mean) / std, (hi - mean) / std)):
        np.testing.assert_array_equal(got, want.astype(np.float32))


def test_tfnet_recipe_runs_on_bf16_windows(tiny_root, tmp_path, monkeypatch):
    """``run_shapes tfnet`` (the JSON config; ``data.device_cache_gb: 3``)
    for 2 micro-steps at a small window: bf16 training windows in the
    sampler's order, a finite loss."""
    seen = []
    step = TFNetTask.training_step

    def recorded_step(task, cells, grid, noise):
        seen.append(cells.dtype)
        return step(task, cells, grid, noise)

    monkeypatch.setattr(TFNetTask, "training_step", recorded_step)
    overrides = [f"data.root={tiny_root}", f"trainer.out_dir={tmp_path / 'run'}", "model.context_window=2",
                 "model.unroll_steps=1", "model.eval_unroll_steps=2", "model.temporal_filtering_length=2",
                 "model.sample_steps=[1,2]", "model.main_sample_step=2", "model.batch_size=2",
                 "model.accumulate_steps=1", "trainer.max_steps=2", *CUTS]
    score = run_shapes.main(["tfnet", "--device", "cpu", *overrides])
    assert seen == [torch.bfloat16] * 2 and math.isfinite(score)
