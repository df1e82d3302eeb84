"""Convert a flax parameter tree (``DenoisingModel``, ``TFNet``,
``DilResNet``) into the port's state_dict.

The inverse of the kind table of ``generative_turbulence_tpu/toolchain/
import_ckpt.py``, plus the baselines' leaves:

- conv (3x3x3, 5x5x5 and 1x1x1) ``kernel (kx, ky, kz, I, O)`` -> ``weight (O, I, kx, ky, kz)``
- ConvTranspose ``kernel (kx, ky, kz, I, O)``           -> ``weight (I, O, kx, ky, kz)``,
  flipped on the spatial axes (flax's ``transpose_kernel=False`` against
  ``F.conv_transpose3d``; ``models/tfnet.py``)
- Dense ``kernel (I, O)``                               -> ``weight (O, I)``
- GroupNorm / BatchNorm ``scale`` / ``bias``            -> ``weight`` / ``bias``
- BatchNorm ``batch_stats`` ``mean`` / ``var``          -> ``mean`` / ``var``
- Embed ``embedding``                                   -> ``weight``
- TF-Net's ``temporal_filter (L, 1)``                   -> ``temporal_filter`` as it is

Module paths keep the flax names joined with dots
(``u_net/down_0/block1/conv/kernel`` -> ``u_net.down_0.block1.conv.weight``).
Everything here is numpy in, torch out; nothing imports JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def _convert(path: str, value: np.ndarray):
    module, _, leaf = path.rpartition(".")
    if leaf == "kernel" and module.rpartition(".")[2].startswith("ConvTranspose"):
        value = value[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)
        leaf = "weight"
    elif leaf == "kernel":
        if value.ndim == 5:
            value = value.transpose(4, 3, 0, 1, 2)
        elif value.ndim == 2:
            value = value.T
        else:
            raise ValueError(f"{path}: unexpected kernel rank {value.ndim}")
        leaf = "weight"
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    elif leaf not in ("bias", "mean", "var", "temporal_filter"):
        raise ValueError(f"{path}: unknown parameter kind {leaf!r}")
    return (f"{module}.{leaf}" if module else leaf), value


def torch_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``params``: the flax variables as nested dicts of numpy arrays, either
    one tree of parameters or the collections (``"params"`` and, for
    TF-Net's BatchNorms, ``"batch_stats"``), which are merged."""
    trees = [params]
    if "params" in params and isinstance(params["params"], Mapping):
        trees = [params[c] for c in ("params", "batch_stats") if c in params]
    state = {}
    for tree in trees:
        for path, value in _flatten(tree).items():
            name, arr = _convert(path, value)
            state[name] = torch.tensor(np.ascontiguousarray(arr), dtype=torch.float32)
    return state
