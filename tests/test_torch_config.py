"""The port's ``training/config.py`` against the JAX package's: the same
dataclasses, defaults and presets, a JAX ``config.json`` read back equal,
the same overrides giving the same config, and the YAML-free scalar parser
giving what PyYAML gives."""

import json

import numpy as np
import pytest
import yaml

from generative_turbulence_tpu.training import config as jconfig
from generative_turbulence_tpu_torch.training import config as tconfig

OVERRIDES = [
    ["model.u_net_levels=2", "model.sampler=ddim", "model.eval_compute_dtype=float32",
     "data.root=data/synth"],
    ["model.u_net_levels=2", "model.compute_dtype=bfloat16", "model.sampler=ddim",
     "model.ddim_steps=10"],
    ["model=tfnet", "model.dim=48", "model.learning_rate=1e-4", "model.lr_decay=",
     "data.batch_size=4", "data.device_cache_gb=0.5", "trainer.mesh_shape=[4,2]"],
    ["model.clip_denoised=true", "model.clip_mode=envelope", "model.sample_steps=[1, 5]",
     "trainer.max_steps=null", "data.shard_eval=yes", "model.min_learning_rate=1.0e-6"],
]

YAML_PROBES = [
    "1", "-3", "0", "1_000", "010", "0x1F", "0b101", "+5", "1.5", "1.", ".5", "-.5",
    "+1.5", "1e-4", "1.0e-4", "1.0e4", "1E+3", ".inf", "-.inf", "inf", "true", "True",
    "yes", "no", "off", "ON", "null", "~", "Null", "ddim", "float32",
    "u:norm-max;p:abs-max", "[4,2]", "[4, 2]", "[]", "[1, [2, 3]]", "24h",
    "data/shapes", "'quoted'", '"double"', "runs/x-1",
]


@pytest.mark.parametrize("preset", [None, *sorted(jconfig.MODEL_PRESETS)])
def test_jax_config_json_reads_equal(preset):
    model = jconfig.ModelConfig(**jconfig.MODEL_PRESETS[preset]) if preset else jconfig.ModelConfig()
    cfg = jconfig.Config(model=model).resolved()
    text = cfg.to_json()
    assert tconfig.Config.from_json(text).to_dict() == jconfig.Config.from_json(text).to_dict()
    port = tconfig.Config(
        model=tconfig.ModelConfig(**tconfig.MODEL_PRESETS[preset]) if preset else tconfig.ModelConfig()
    )
    assert port.resolved().to_dict() == cfg.to_dict()
    assert port.to_json() == jconfig.Config(model=model).to_json()


@pytest.mark.parametrize("args", OVERRIDES, ids=lambda a: a[0])
def test_parse_cli_overrides_matches_jax(args):
    got = tconfig.parse_cli_overrides(args).to_dict()
    assert got == jconfig.parse_cli_overrides(args).to_dict()


def test_two_level_sampling_overrides():
    cfg = tconfig.parse_cli_overrides(OVERRIDES[1])
    m = cfg.model
    assert (m.u_net_levels, m.compute_dtype, m.sampler, m.ddim_steps) == (2, "bfloat16", "ddim", 10)
    assert m.dim == 32 and m.timesteps == 500 and m.eval_compute_dtype is None


def test_unknown_field_and_preset_raise():
    with pytest.raises(AttributeError, match="u_net_level"):
        tconfig.parse_cli_overrides(["model.u_net_level=2"])
    with pytest.raises(ValueError, match="Unknown model"):
        tconfig.parse_cli_overrides(["model=unet"])


@pytest.mark.parametrize("raw", YAML_PROBES)
def test_scalar_parser_matches_pyyaml(raw):
    got, want = tconfig._yaml_scalar(raw), yaml.safe_load(raw)
    assert type(got) is type(want) and got == want
    jgot = jconfig._parse_scalar(raw)
    tgot = tconfig._parse_scalar(raw)
    assert type(tgot) is type(jgot) and tgot == jgot


def test_scalar_parser_nan():
    assert np.isnan(tconfig._parse_scalar(".nan")) and np.isnan(jconfig._parse_scalar(".nan"))


@pytest.mark.parametrize("suffix", [".yaml", ".json"])
def test_load_config_matches_jax(tmp_path, suffix):
    d = {"model": {"name": "dilresnet", "u_net_levels": 2, "min_learning_rate": "1e-06"},
         "data": {"root": "data/synth"}}
    path = tmp_path / f"cfg{suffix}"
    path.write_text(yaml.safe_dump(d) if suffix == ".yaml" else json.dumps(d))
    assert tconfig.load_config(str(path)).to_dict() == jconfig.load_config(str(path)).to_dict()
