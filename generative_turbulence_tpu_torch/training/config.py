"""Typed configuration with model presets and hydra-style CLI overrides.

Port of ``generative_turbulence_tpu/training/config.py``, with the same
dataclasses, field names, defaults and presets, so a ``config.json``
embedded in a JAX checkpoint reads the same here.  The config tree has three
groups:

    model=diffusion|tfnet|dilresnet   selects a preset
    data.root=...  model.dim=48      dotted-path overrides
    trainer.max_epochs=10

Override values are parsed as YAML 1.1 scalars (``1e-4``, ``true``,
``[1,2]``, ``null``) by a small parser of its own: PyYAML is imported only by
``load_config`` for ``.yaml`` files, so the overrides work where it is not
installed.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class ModelConfig:
    name: str = "diffusion"
    batch_size: int = 6
    eval_batch_size: int = 8
    monitor: str = "val/tke"
    variables: str = "u,p"
    normalization_mode: str = "u:norm-max;p:abs-max"

    # conditioning
    cell_type_features: bool = True
    cell_type_embedding_type: str = "learned"
    cell_type_embedding_dim: int = 4
    cell_pos_features: bool = False

    # optimization
    learning_rate: float = 1e-4
    min_learning_rate: float = 1e-6
    lr_decay: Optional[str] = "exp"
    max_epochs: int = 10
    optimizer: str = "radam"

    # --- diffusion specific -------------------------------------------------
    dim: int = 32
    u_net_levels: int = 4
    beta_schedule: str = "log-snr-linear"
    timesteps: int = 500
    loss: str = "l2"
    parameterization: str = "epsilon"  # or "v"
    # per-timestep loss weighting: None (reference) or "min-snr-<gamma>"
    loss_weighting: Optional[str] = None
    # clip_denoised bounds: "unit" = the reference's [-1, 1]; "envelope" =
    # the training set's per-channel normalized min/max (required for
    # normalizations like mean-std that don't map data into [-1, 1])
    clip_mode: str = "unit"
    learned_variances: bool = False
    elbo_weight: Optional[float] = 0.1
    detach_elbo_mean: bool = True
    clip_denoised: bool = False
    noise_bcs: bool = True
    time_embedding: str = "nyquist"
    actfn: str = "silu"
    norm_type: str = "group"
    with_geometry_embedding: bool = False
    attention_kind: str = "full"
    remat: bool = True  # rematerialize U-Net blocks in the backward pass
    sampler: str = "ddpm"  # or "ddim"
    ddim_steps: int = 50
    ddim_eta: float = 0.0
    # DDPM scan chunking: dispatch the ancestral scan in spans of this many
    # steps (0 = one scan).  A full 500-step scan is a single ~100 s device
    # dispatch, which remote-dispatch runtimes kill; chunks are RNG-exact
    # equal to the single scan (see GaussianDiffusion.p_sample_span).
    sampler_chunk: int = 125

    # --- regression specific --------------------------------------------------
    context_window: int = 6
    unroll_steps: int = 4
    eval_unroll_steps: int = 30
    sample_steps: Tuple[int, ...] = ()
    main_sample_step: int = -1
    compute_expensive_sample_metrics: bool = True
    # tfnet
    temporal_filtering_length: int = 4
    dropout_rate: float = 0.0
    kernel_size: int = 3
    # dilresnet
    N: int = 4
    hidden_dim: int = 48
    training_noise_std: Optional[float] = 1e-3

    # exponential moving average of parameters for sampling/eval (0 = off).
    # An addition over the reference; standard practice for diffusion quality.
    ema_decay: float = 0.0

    # numerics
    compute_dtype: str = "float32"  # or "bfloat16"
    # compute dtype for SAMPLING/eval only (None = compute_dtype).  bf16
    # training with float32 in-run validation sampling: the 500-step chain
    # amplifies bf16 rounding, and the sampler-config sweep measured f32(+
    # clip) samplers scoring consistently better on val/tke at the same
    # checkpoint (docs/runs/overfit-4case-r4/summary.json sampler_sweep).
    eval_compute_dtype: Optional[str] = None
    # gradient accumulation: optimizer updates every k micro-batches; the
    # factory divides the data batch size by k so the effective batch (and LR
    # schedule) is unchanged.  The OOM remedy for big grids on small chips.
    accumulate_steps: int = 1


MODEL_PRESETS: Dict[str, Dict[str, Any]] = {
    # config/model/diffusion.yaml
    "diffusion": {},
    # config/model/tfnet.yaml
    "tfnet": {
        "name": "tfnet",
        "batch_size": 6,
        "eval_batch_size": 4,
        "monitor": "val/loss",
        "cell_type_embedding_dim": 8,
        "learning_rate": 1e-3,
        "lr_decay": None,
        "optimizer": "adam",
        "max_epochs": 2,
        "context_window": 6,
        "unroll_steps": 4,
        "eval_unroll_steps": 30,
    },
    # config/model/dilresnet.yaml
    "dilresnet": {
        "name": "dilresnet",
        "batch_size": 3,
        "eval_batch_size": 4,
        "monitor": "val/loss",
        "cell_type_embedding_dim": 8,
        "learning_rate": 1e-3,
        "min_learning_rate": 1e-6,
        "lr_decay": "exp",
        "optimizer": "adam",
        "max_epochs": 4,
        "context_window": 1,
        "unroll_steps": 1,
        "eval_unroll_steps": 30,
    },
}


@dataclasses.dataclass
class DataConfig:
    root: str = "data/shapes"
    discard_first_seconds: float = 0.025
    batch_size: Optional[int] = None  # defaults to model.batch_size
    eval_batch_size: Optional[int] = None
    val_samples: int = 8
    test_samples: int = 16
    stride: int = 1  # sequence datasets only
    prefetch_size: int = 2
    # double-buffer the host-to-device transfer in the prefetch thread
    # (single-device runs; mesh runs re-place with their NamedSharding)
    device_prefetch: bool = True
    # pad cell/dirichlet tables up to this granularity so cases with nearby
    # cell counts share ONE compiled program (0 = off); scatter drops the
    # sentinel rows, gather fills zeros, losses normalize by the true count
    cell_bucket: int = 16384
    # serve batches from cycled warm host buffers (read_direct + in-place
    # bucket pad) instead of fresh allocations; see data.HostBufferPool
    buffer_pool: bool = True
    # keep up to this many GB of TRAINING frames device-resident in bfloat16
    # (uploaded once, then every batch is an on-device gather); 0 = off.
    # Pays off when the host->device link is slower than the device step.
    device_cache_gb: float = 0.0
    # sequence datamodule only: ALSO keep EVAL windows device-resident
    # (bfloat16); rollout context/targets quantize, metric ground truth does
    # not (it reads the HDF5 files directly).  A 30-step eval window streams
    # ~250 MB per batch without it.
    eval_device_cache_gb: float = 0.0
    # cast streamed TRAIN batches to this dtype before the H2D transfer
    # (halves bytes on slow links); eval batches always transfer float32.
    # None = float32; implied bfloat16 when device_cache_gb > 0.
    transfer_dtype: Optional[str] = None
    # multi-host runs: round-robin whole TRAIN cases across hosts
    shard_by_host: bool = False
    # multi-host runs: also shard EVAL cases across hosts (per-rank sample
    # stores + all-gathered metric merge; bit-identical to single-process)
    shard_eval: bool = False


@dataclasses.dataclass
class TrainerConfig:
    max_epochs: Optional[int] = None  # defaults to model.max_epochs
    # Global step cap, independent of max_epochs.  Unlike lowering
    # max_epochs, stopping via max_steps does NOT change the LR-decay
    # horizon (which is max_epochs * n_batches), so a run stopped at
    # max_steps and resumed with the cap lifted replays the exact
    # trajectory of an uninterrupted run (the soak kill/resume protocol).
    max_steps: Optional[int] = None
    # Point-cloud Wasserstein backend for IN-TRAINING expensive validations.
    # "sinkhorn" (calibrated on-device, minutes) by default: the exact host
    # EMD takes hours at shapes scale on a small host and once silently ate
    # a run's final validation window; use scripts/eval_ckpt.py for offline
    # exact-EMD evaluation.
    wasserstein_solver: str = "sinkhorn"
    check_val_every_n_epoch: int = 100
    gradient_clip_val: float = 0.1
    log_every_n_steps: int = 5
    train_limit: Optional[str] = "24h"
    eval_testset: bool = False
    out_dir: str = "runs/default"
    samples_root: Optional[str] = None  # defaults to out_dir/samples
    seed: int = 0
    checkpoint_every_n_epochs: int = 1
    # parallelism: data-parallel and spatial axes of the device mesh
    mesh_shape: Optional[Tuple[int, int]] = None  # (dp, sp); None = single device
    matmul_precision: str = "default"  # default | high | highest
    # observability: capture a profiler trace for steps [profile_start,
    # profile_start + profile_steps) into out_dir/profile
    profile_steps: int = 0
    profile_start: int = 10
    render_plots: bool = True
    # experiment tracking: wandb sink in addition to the JSONL stream
    # (reference: train.py:141 wandb.init's every run; here it is opt-in)
    use_wandb: bool = False
    wandb_project: str = "generative-turbulence-tpu"
    wandb_run_name: Optional[str] = None
    # resume: checkpoint dir (containing last/ + config.json) to restore from
    resume_from: Optional[str] = None
    # stop when the monitor hasn't improved for N validations (None = off)
    early_stopping_patience: Optional[int] = None
    # draw the SAME eval noise every validation (for A/B comparisons); by
    # default each validation epoch folds the epoch index into the eval RNG
    deterministic_eval: bool = False


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    trainer: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)

    def resolved(self) -> "Config":
        """Fill cross-group defaults (data batch sizes from model, etc.)."""
        cfg = dataclasses.replace(self)
        if cfg.data.batch_size is None:
            cfg.data = dataclasses.replace(cfg.data, batch_size=cfg.model.batch_size)
        if cfg.data.eval_batch_size is None:
            cfg.data = dataclasses.replace(
                cfg.data, eval_batch_size=cfg.model.eval_batch_size
            )
        if cfg.trainer.max_epochs is None:
            cfg.trainer = dataclasses.replace(
                cfg.trainer, max_epochs=cfg.model.max_epochs
            )
        if cfg.trainer.samples_root is None:
            cfg.trainer = dataclasses.replace(
                cfg.trainer, samples_root=str(Path(cfg.trainer.out_dir) / "samples")
            )
        return cfg

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Config":
        model = d.get("model", {})
        data = d.get("data", {})
        trainer = d.get("trainer", {})
        if isinstance(model.get("sample_steps"), list):
            model["sample_steps"] = tuple(model["sample_steps"])
        if isinstance(trainer.get("mesh_shape"), list):
            trainer["mesh_shape"] = tuple(trainer["mesh_shape"])
        return Config(
            model=ModelConfig(**model),
            data=DataConfig(**data),
            trainer=TrainerConfig(**trainer),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @staticmethod
    def from_json(s: str) -> "Config":
        return Config.from_dict(json.loads(s))


def _set_dotted(obj: Any, path: List[str], value: Any):
    field = path[0]
    if len(path) == 1:
        if not hasattr(obj, field):
            raise AttributeError(f"Unknown config field {field!r} on {type(obj).__name__}")
        current = getattr(obj, field)
        if isinstance(current, tuple) and isinstance(value, list):
            value = tuple(value)
        setattr(obj, field, value)
    else:
        _set_dotted(getattr(obj, field), path[1:], value)


def parse_cli_overrides(args: Sequence[str], base: Optional[Config] = None) -> Config:
    """Parse ``model=diffusion data.root=... model.dim=48``-style overrides."""
    cfg = base if base is not None else Config()
    # First pass: group selectors (model=..., which swap in presets).
    rest = []
    for arg in args:
        key, _, raw = arg.partition("=")
        if key == "model":
            preset = MODEL_PRESETS.get(raw)
            if preset is None:
                raise ValueError(
                    f"Unknown model {raw!r}; options: {sorted(MODEL_PRESETS)}"
                )
            cfg.model = ModelConfig(**preset)
        elif key == "config":
            cfg = load_config(raw, base=cfg)
        else:
            rest.append(arg)
    # Second pass: dotted overrides with YAML-typed values.
    for arg in rest:
        key, _, raw = arg.partition("=")
        _set_dotted(cfg, key.split("."), _parse_scalar(raw))
    return cfg


# The plain scalars of YAML 1.1 as PyYAML resolves them (its resolver's
# int, float, bool and null patterns; sexagesimal numbers left out).
_YAML_NULL = {"~", "null", "Null", "NULL"}
_YAML_BOOL = {
    **dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
    **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"), False),
}
_YAML_INT = re.compile(
    r"[-+]?(?:0b(?P<bin>[0-1_]+)|0x(?P<hex>[0-9a-fA-F_]+)|0(?P<oct>[0-7_]+)|(?P<dec>0|[1-9][0-9_]*))"
)
_YAML_FLOAT = re.compile(
    r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
)
_YAML_SPECIAL_FLOAT = {
    **dict.fromkeys((".inf", ".Inf", ".INF", "+.inf", "+.Inf", "+.INF"), float("inf")),
    **dict.fromkeys(("-.inf", "-.Inf", "-.INF"), float("-inf")),
    **dict.fromkeys((".nan", ".NaN", ".NAN"), float("nan")),
}


def _split_flow(inner: str) -> List[str]:
    """Split the inside of a YAML flow sequence at its top-level commas."""
    parts, depth, start = [], 0, 0
    for i, ch in enumerate(inner):
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(inner[start:i])
            start = i + 1
    parts.append(inner[start:])
    return [p.strip() for p in parts]


def _yaml_scalar(raw: str) -> Any:
    """``yaml.safe_load`` of a one-line scalar or flow sequence."""
    s = raw.strip()
    if s in _YAML_NULL or s == "":
        return None
    if s in _YAML_BOOL:
        return _YAML_BOOL[s]
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    if s.startswith("[") and s.endswith("]"):
        inner = s[1:-1].strip()
        return [_yaml_scalar(p) for p in _split_flow(inner)] if inner else []
    m = _YAML_INT.fullmatch(s)
    if m:
        sign = -1 if s.startswith("-") else 1
        for group, base in (("dec", 10), ("hex", 16), ("oct", 8), ("bin", 2)):
            if m.group(group) is not None:
                return sign * int(m.group(group).replace("_", ""), base)
    if s in _YAML_SPECIAL_FLOAT:
        return _YAML_SPECIAL_FLOAT[s]
    if _YAML_FLOAT.fullmatch(s):
        return float(s.replace("_", ""))
    return s


def _parse_scalar(raw: str) -> Any:
    if raw == "":
        return None
    value = _yaml_scalar(raw)
    # YAML 1.1 treats "1e-5" (no dot) as a string; coerce numeric-looking strings.
    if isinstance(value, str):
        try:
            return int(value)
        except ValueError:
            pass
        try:
            return float(value)
        except ValueError:
            pass
    return value


def _coerce_numeric_strings(value: Any) -> Any:
    """Recursively apply ``_parse_scalar``'s numeric coercion to str leaves.

    YAML 1.1 resolves dotless exponents ("1e-06") as strings, so a checkpoint
    config round-tripped through ``yaml.safe_load`` would hand
    ``min_learning_rate='1e-06'`` to the LR schedule.
    """
    if isinstance(value, dict):
        return {k: _coerce_numeric_strings(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_coerce_numeric_strings(v) for v in value]
    if isinstance(value, str):
        return _parse_scalar(value)
    return value


def load_config(path: str, base: Optional[Config] = None) -> Config:
    """Load a config from a YAML/JSON file, merged over ``base``."""
    raw = Path(path).read_text()
    if str(path).endswith(".json"):
        d = json.loads(raw)
    else:
        import yaml

        d = _coerce_numeric_strings(yaml.safe_load(raw))
    cfg = (base or Config()).to_dict()
    for group, values in d.items():
        if group == "model" and "name" in values:
            cfg["model"].update(MODEL_PRESETS.get(values["name"], {}))
        cfg.setdefault(group, {}).update(values or {})
    return Config.from_dict(cfg)
