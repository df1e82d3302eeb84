"""Import the reference's (turbdiff's) pretrained checkpoint into a port checkpoint directory.

    python -m generative_turbulence_tpu_torch.scripts.import_checkpoint turbdiff.ckpt <out_ckpt_dir> \\
        data.root=/path/to/shapes [key=value ...] [--trust-pickle]

Port of ``scripts/import-checkpoint.py``.  Reads the PyTorch-Lightning
``.ckpt`` the reference distributes, maps its hyper-parameters onto the
config (``hparams_to_overrides``; then the overrides given here), renames
its ``state_dict`` onto the port's ``DenoisingModel``
(``toolchain/import_ckpt.py``), checks it against the built network and the
diffusion schedule against the checkpoint's ``model.betas``, copies the
parameters into the EMA where the config has one, and writes ``last.pt``,
``best.pt``, ``config.json`` and ``index.json`` to ``out_ckpt_dir``, which
``eval_ckpt`` and the other entry points read as they are.

The checkpoint is downloaded content, and a full unpickle runs code from
it.  It is first loaded with ``weights_only=True`` (tensors and containers
only).  A checkpoint whose pickle names more (the reference's classes,
such as its ``Variable`` enum in the hyper-parameters, or Lightning's
``AttributeDict``) loads only with ``--trust-pickle``, as the JAX script's
does; even then no code of the file runs: the loader resolves only the
globals that torch's ``weights_only`` loader allows (tensor rebuilding,
storages, dtypes, ``OrderedDict``, ``set``) and turns every other global
into an inert stand-in (``_StandIn``) that keeps what it is built with, so
no reference source is needed.  Runs on the GPU unless ``--device`` says
otherwise.
"""

from __future__ import annotations

import _compat_pickle
import argparse
import pickle
import sys
import types
from pathlib import Path

import numpy as np
import torch

from ..data.variables import Variable
from ..diffusion.schedules import beta_schedule
from ..toolchain.import_ckpt import check_against, convert_state_dict
from ..train import resolve_device
from ..training.checkpoint import CheckpointManager
from ..training.config import Config, parse_cli_overrides
from ..training.factory import instantiate_data_and_task

HPARAM_MAP = {
    # the reference's DiffusionTraining.__init__ arguments -> ModelConfig fields
    "dim": "dim",
    "timesteps": "timesteps",
    "beta_schedule": "beta_schedule",
    "loss": "loss",
    "norm_type": "norm_type",
    "time_embedding": "time_embedding",
    "actfn": "actfn",
    "optimizer": "optimizer",
    "learning_rate": "learning_rate",
    "min_learning_rate": "min_learning_rate",
    "learned_variances": "learned_variances",
    "elbo_weight": "elbo_weight",
    "detach_elbo_mean": "detach_elbo_mean",
    "clip_denoised": "clip_denoised",
    "noise_bcs": "noise_bcs",
    "cell_type_features": "cell_type_features",
    "cell_type_embedding_type": "cell_type_embedding_type",
    "cell_type_embedding_dim": "cell_type_embedding_dim",
    "cell_pos_features": "cell_pos_features",
    "normalization_mode": "normalization_mode",
    "with_geometry_embedding": "with_geometry_embedding",
}
TRUST_NEEDED = ("checkpoint's pickle names classes beyond tensors and containers; it is downloaded content, so "
                "loading it requires the explicit --trust-pickle opt-in (those classes then load as inert stand-ins)")

# The globals that resolve for real, as torch's weights_only loader allows
# them; the dtypes and quantisation schemes of ``torch`` are added by type.
_REAL_GLOBALS = {
    "builtins": {"set", "frozenset", "complex", "bytearray"},
    "_codecs": {"encode"},
    "collections": {"OrderedDict", "Counter"},
    "torch": {"Size", "device", "Tensor"},
    "torch._utils": {"_rebuild_tensor", "_rebuild_tensor_v2", "_rebuild_tensor_v3", "_rebuild_parameter",
                     "_rebuild_parameter_with_state", "_rebuild_sparse_tensor", "_rebuild_qtensor",
                     "_rebuild_meta_tensor_no_storage", "_rebuild_nested_tensor"},
    "torch._tensor": {"_rebuild_from_type_v2"},
    "torch.nn.parameter": {"Parameter"},
    "torch.storage": {"TypedStorage", "UntypedStorage"},
    "torch.serialization": {"_get_layout"},
}


def _resolves_for_real(module: str, name: str) -> bool:
    if name in _REAL_GLOBALS.get(module, ()):
        return True
    return module == "torch" and isinstance(getattr(torch, name, None), (torch.dtype, torch.qscheme))


class _StandIn(dict):
    """Stands in for a global the checkpoint names but this loader does not
    resolve: keeps the arguments it is called with (``args``,
    ``kwargs``), its pickled state (``state``) and any items, and does
    nothing else."""

    args, kwargs, state = (), {}, None

    def __init__(self, *args, **kwargs):
        super().__init__()
        self.args, self.kwargs = args, kwargs

    def __setstate__(self, state):
        self.state = state


class _ReferenceVariable(_StandIn):
    """A member of the reference's ``Variable`` enum, which pickles as
    ``Variable(value)``; its ``name`` is that of the port's ``Variable`` of
    the same value."""

    @property
    def name(self) -> str:
        value = self.args[0] if self.args else None
        try:
            return Variable(value).name
        except ValueError:
            known = ", ".join(repr(v.value) for v in Variable)
            raise ValueError(f"the checkpoint's Variable {value!r} is none of the port's ({known})") from None


def _stand_in(module: str, name: str) -> type:
    base = _ReferenceVariable if name == "Variable" else _StandIn
    return type(name, (base,), {"__module__": module})


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        # Python 2 names, as torch's protocol-2 pickles write them (__builtin__.set)
        if (module, name) in _compat_pickle.NAME_MAPPING:
            module, name = _compat_pickle.NAME_MAPPING[(module, name)]
        module = _compat_pickle.IMPORT_MAPPING.get(module, module)
        if _resolves_for_real(module, name):
            return super().find_class(module, name)
        return _stand_in(module, name)


# torch.load(pickle_module=...) takes the module's Unpickler (and load).
_STAND_IN_PICKLE = types.SimpleNamespace(Unpickler=_Unpickler, load=pickle.load, __name__="stand_in_pickle")


def load_lightning_ckpt(path: Path, trust_pickle: bool = False) -> dict:
    """The checkpoint's contents: ``weights_only`` first; with
    ``trust_pickle``, a load that turns every other global into a stand-in."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        if not trust_pickle:
            raise SystemExit(TRUST_NEEDED) from None
    return torch.load(path, map_location="cpu", weights_only=False, pickle_module=_STAND_IN_PICKLE)


def hparams_to_overrides(hparams: dict) -> list:
    overrides = []
    for ref_key, our_key in HPARAM_MAP.items():
        if ref_key not in hparams or hparams[ref_key] is None:
            continue
        overrides.append(f"model.{our_key}={hparams[ref_key]}")
    if "variables" in hparams:
        names = [getattr(v, "name", str(v)).lower() for v in hparams["variables"]]
        overrides.append(f"model.variables={','.join(names)}")
    return overrides


def main(argv=None) -> dict:
    """Returns the port state_dict written and the schedule's largest
    difference (``max_abs_betas_diff``, None without ``model.betas``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ckpt", help="the reference's .ckpt file (PyTorch Lightning)")
    ap.add_argument("out_dir", help="checkpoint directory to write")
    ap.add_argument("overrides", nargs="*", help="config overrides key=value")
    ap.add_argument("--trust-pickle", action="store_true",
                    help="load a checkpoint whose pickle names classes beyond tensors and containers; they load as "
                         "inert stand-ins")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_intermixed_args(argv)
    device = resolve_device(args.device)

    ckpt = load_lightning_ckpt(Path(args.ckpt), trust_pickle=args.trust_pickle)
    hparams = dict(ckpt.get("hyper_parameters", {}))
    overrides = ["model=diffusion", *hparams_to_overrides(hparams), *args.overrides]
    config = parse_cli_overrides(overrides, base=Config()).resolved()
    _, task = instantiate_data_and_task(config, device)

    state_dict, buffers = convert_state_dict(ckpt["state_dict"], u_net_levels=config.model.u_net_levels)
    check_against(state_dict, task.net)
    task.net.load_state_dict(state_dict)

    # The diffusion schedule against the checkpoint's buffers.
    err = None
    if "model.betas" in buffers:
        ours = beta_schedule(config.model.beta_schedule, config.model.timesteps)
        err = float(np.max(np.abs(ours - buffers["model.betas"].double().numpy())))
        print(f"schedule check: max |betas_ours - betas_ckpt| = {err:.3e}")
        if err > 1e-6:
            print("WARNING: schedule mismatch - check beta_schedule/timesteps", file=sys.stderr)

    task.init_state()  # step 0, zero optimizer moments, the EMA a copy of the parameters
    mgr = CheckpointManager(Path(args.out_dir), config_json=config.to_json())
    mgr.save_last(task.state_dict(), step=0)
    mgr.save_best(task.state_dict(), step=0, value=float("inf"))
    print(f"imported {task.n_params():,} parameters -> {args.out_dir}")
    return {"state_dict": state_dict, "max_abs_betas_diff": err}


if __name__ == "__main__":
    main()
