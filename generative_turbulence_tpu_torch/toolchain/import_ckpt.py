"""Import a reference (turbdiff) PyTorch-Lightning checkpoint into the port.

Port of ``generative_turbulence_tpu/toolchain/import_ckpt.py``.  The
reference's checkpoint (``turbdiff.ckpt``) holds the ``state_dict`` of its
``DiffusionTraining`` module: ``model.model.*`` is the ``DenoisingModel``,
``model.*`` the ``GaussianDiffusion`` schedule buffers, and
``conditioning.cell_type_embedding.*`` the learned cell-type embedding.  The
reference is torch, in the layouts the port's modules keep (Conv3d
``(O, I, kx, ky, kz)``, Linear ``(O, I)``, GroupNorm ``weight``/``bias``,
Embedding ``(n, d)``), so the conversion is a rename of the keys:
``map_reference_key`` gives each key's name in the port's
``DenoisingModel.state_dict()`` and the tensors pass through as they are.
``to_reference_state_dict`` is the inverse rename.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# ResnetBlock fields: the reference's name -> the port's (and the kind).
_RESNET_FIELDS = {
    "project_onto_scale_shift": ("film", "linear"),
    "block1.conv": ("block1.conv", "conv"),
    "block1.norm": ("block1.norm", "norm"),
    "block2.conv": ("block2.conv", "conv"),
    "block2.norm": ("block2.norm", "norm"),
    "conv": ("skip", "conv"),
}
_RESNET_NAMES = {port: ref for ref, (port, _) in _RESNET_FIELDS.items()}
# The rank of a weight of each kind (every bias is a vector).
_WEIGHT_RANK = {"conv": 5, "linear": 2, "norm": 1, "embed": 2}
_GEOMETRY_CONVS = ("0", "2", "4")  # extract_features.{0,2,4}: the convs between activations
_PROCESS_C = ("0", "2")


def _map_resnet(rest: str) -> Tuple[str, str]:
    field, leaf = rest.rsplit(".", 1)
    if field not in _RESNET_FIELDS:
        raise KeyError(f"unknown ResnetBlock field {field!r}")
    name, kind = _RESNET_FIELDS[field]
    return f"{name}.{leaf}", kind


def map_reference_key(key: str, u_net_levels: int) -> Optional[Tuple[str, str]]:
    """Map one reference state_dict key to (the port's state_dict name,
    tensor kind).  None for keys with no parameter here (the diffusion
    schedule buffers, the normalization statistics, the sample stores'
    state): the port computes those from the config and the data."""
    if key == "conditioning.cell_type_embedding.embedding.weight":
        return "conditioning.cell_type_embedding.weight", "embed"
    if key.startswith(("normalization.", "val_sample", "test_sample")):
        return None
    if not key.startswith("model.model."):
        return None  # GaussianDiffusion buffers (model.betas, model.alphas_cumprod, ...)
    k = key[len("model.model."):]
    leaf = k.rsplit(".", 1)[-1]

    if k.startswith(("encode_x.", "encode_c_local.")):
        return k, "conv"
    if k.startswith("encode_c_global."):
        return k, "linear"
    m = re.match(r"geometry_embedding\.extract_features\.(\d+)\.(\w+)$", k)
    if m and m.group(1) in _GEOMETRY_CONVS:
        return f"geometry_embedding.conv{_GEOMETRY_CONVS.index(m.group(1))}.{m.group(2)}", "conv"
    m = re.match(r"process_c\.(\d+)\.(\w+)$", k)
    if m and m.group(1) in _PROCESS_C:
        return f"process_c_{_PROCESS_C.index(m.group(1))}.{leaf}", "linear"
    if k.startswith("decode.0."):
        rest, kind = _map_resnet(k[len("decode.0."):])
        return f"decode_resnet.{rest}", kind
    if k.startswith("decode.1."):
        return f"decode_out.{leaf}", "conv"
    m = re.match(r"u_net\.downsampling_blocks\.(\d+)\.(.*)$", k)
    if m:
        rest, kind = _map_resnet(m.group(2))
        return f"u_net.down_{m.group(1)}.{rest}", kind
    m = re.match(r"u_net\.upsampling_blocks\.(\d+)\.(.*)$", k)
    if m:
        # The reference applies upsampling_blocks in list order, deepest
        # first; the port names them up_{level}, the deepest levels - 1.
        rest, kind = _map_resnet(m.group(2))
        return f"u_net.up_{u_net_levels - 1 - int(m.group(1))}.{rest}", kind
    m = re.match(r"u_net\.center_block\.(\d+)\.(.*)$", k)
    if m:
        idx, rest = m.groups()
        if idx == "0":
            sub, kind = _map_resnet(rest)
            return f"u_net.center_in.{sub}", kind
        if idx == "2":
            sub, kind = _map_resnet(rest)
            return f"u_net.center_out.{sub}", kind
        if idx == "1":
            # Residual(PreNorm(norm, Attention)); to_qkv and to_out are 1x1x1 convs.
            if rest.startswith("fn.norm."):
                return f"u_net.center_norm.{leaf}", "norm"
            if rest.startswith("fn.fn.to_qkv."):
                return f"u_net.center_attention.to_qkv.{leaf}", "conv"
            if rest.startswith("fn.fn.to_out."):
                return f"u_net.center_attention.to_out.{leaf}", "conv"
    raise KeyError(f"unmapped reference key {key!r}")


def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach()
    return torch.from_numpy(np.ascontiguousarray(value))


def convert_state_dict(
    state_dict: Mapping[str, object], u_net_levels: int = 4
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """A reference task state_dict as ``(port state_dict, buffers)``: the
    network's tensors under the port's names, in their own layout and
    dtype, and the unmapped tensors (the schedule buffers ``model.betas``
    and the rest, the normalization statistics) under their own keys."""
    params: Dict[str, torch.Tensor] = {}
    buffers: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        tensor = _as_tensor(value)
        mapped = map_reference_key(key, u_net_levels)
        if mapped is None:
            buffers[key] = tensor
            continue
        name, kind = mapped
        rank = 1 if name.endswith(".bias") else _WEIGHT_RANK[kind]
        if tensor.dim() != rank:
            raise ValueError(f"{key}: a {kind} {name.rsplit('.', 1)[1]} of rank {tensor.dim()}, expected {rank}")
        params[name] = tensor
    return params, buffers


def reference_key(name: str, u_net_levels: int) -> str:
    """The reference's state_dict key of the port's ``DenoisingModel``
    parameter ``name`` (the ``conditioning.*`` embedding is a task-level key
    there); the inverse of ``map_reference_key``."""
    if name == "conditioning.cell_type_embedding.weight":
        return "conditioning.cell_type_embedding.embedding.weight"
    module, leaf = name.rsplit(".", 1)

    def resnet(prefix: str, rest: str) -> str:
        field = rest.rsplit(".", 1)[0]
        if field not in _RESNET_NAMES:
            raise KeyError(f"unknown ResnetBlock field {field!r} in {name!r}")
        return f"{prefix}.{_RESNET_NAMES[field]}.{leaf}"

    if module in ("encode_x", "encode_c_local", "encode_c_global"):
        k = name
    elif m := re.fullmatch(r"geometry_embedding\.conv(\d)", module):
        k = f"geometry_embedding.extract_features.{_GEOMETRY_CONVS[int(m.group(1))]}.{leaf}"
    elif m := re.fullmatch(r"process_c_(\d)", module):
        k = f"process_c.{_PROCESS_C[int(m.group(1))]}.{leaf}"
    elif name.startswith("decode_resnet."):
        k = resnet("decode.0", name[len("decode_resnet."):])
    elif module == "decode_out":
        k = f"decode.1.{leaf}"
    elif m := re.fullmatch(r"u_net\.down_(\d+)\.(.*)", name):
        k = resnet(f"u_net.downsampling_blocks.{m.group(1)}", m.group(2))
    elif m := re.fullmatch(r"u_net\.up_(\d+)\.(.*)", name):
        k = resnet(f"u_net.upsampling_blocks.{u_net_levels - 1 - int(m.group(1))}", m.group(2))
    elif m := re.fullmatch(r"u_net\.center_(in|out)\.(.*)", name):
        k = resnet(f"u_net.center_block.{'0' if m.group(1) == 'in' else '2'}", m.group(2))
    elif module == "u_net.center_norm":
        k = f"u_net.center_block.1.fn.norm.{leaf}"
    elif m := re.fullmatch(r"u_net\.center_attention\.(to_qkv|to_out)", module):
        k = f"u_net.center_block.1.fn.fn.{m.group(1)}.{leaf}"
    else:
        raise KeyError(f"no reference key for {name!r}")
    return f"model.model.{k}"


def to_reference_state_dict(state_dict: Mapping[str, torch.Tensor], u_net_levels: int) -> Dict[str, torch.Tensor]:
    """A port ``DenoisingModel`` state_dict under the reference's keys, the
    tensors as they are (``convert_state_dict`` maps it back)."""
    return {reference_key(name, u_net_levels): value for name, value in state_dict.items()}


def check_against(state_dict: Mapping[str, torch.Tensor], model: torch.nn.Module) -> None:
    """Raise with the whole difference if ``state_dict`` does not have the
    names and shapes of ``model.state_dict()``."""
    got = {k: tuple(v.shape) for k, v in state_dict.items()}
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    mismatched = sorted(k for k in set(got) & set(want) if got[k] != want[k])
    lines = []
    if missing:
        lines.append("missing (in checkpoint): " + ", ".join(missing))
    if extra:
        lines.append("unexpected (no model parameter): " + ", ".join(extra))
    if mismatched:
        lines.append("shape mismatch: " + ", ".join(f"{k} ckpt{got[k]} != model{want[k]}" for k in mismatched))
    if lines:
        raise ValueError("checkpoint does not match the model:\n" + "\n".join(lines))
