"""The epsilon-network: a FiLM-conditioned 3D U-Net over voxel grids.

Port of ``generative_turbulence_tpu/models/unet.py``: a 1x1 input encoding to
``dim`` channels, the encoded local (cell-type) conditioning concatenated to
it, a timestep (+ optional global/geometry) embedding processed by an MLP
that feeds every ResnetBlock as FiLM, the interpolation U-Net, and a
resnet + 1x1 decode head computed in f32.

Unlike flax, torch modules fix their input widths at construction, so the
model takes ``in_features`` and ``c_global_features``, and a model with
``conditioning`` must be called with ``cell_types``.  ``remat`` (flax's
``nn.remat`` of the U-Net's ResnetBlocks) takes effect only while gradients
are recorded.  On the spatial axis (``parallel.spatial``) x is this rank's
x ``slab`` of the grid whose whole cell-type map ``cell_types`` is: the
local conditioning and the geometry embedding are computed from the whole
map, and the slab of the conditioning joins the slab of x.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.spatial import Slab
from .blocks import Conv, Conv3d, Dense, GroupNorm, ResnetBlock, UNet
from .conditioning import Conditioning
from .embeddings import NyquistFrequencyEmbedding, SinusoidalTimeEmbedding

ACTIVATIONS = {
    "silu": F.silu,
    "gelu": functools.partial(F.gelu, approximate="tanh"),  # flax nn.gelu default
    "relu": F.relu,
    "softplus": F.softplus,
    "tanh": torch.tanh,
}


class GeometryEmbedding(nn.Module):
    """Global conditioning vector from the front slice (first 50 x-planes)
    of the local conditioning: three VALID 5^3 convs, then a spatial mean."""

    def __init__(self, in_features: int, features: int, actfn: Callable, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.actfn = actfn
        self.conv0 = Conv(in_features, features, 5, stride=5, dtype=dtype)
        self.conv1 = Conv(features, features, 5, stride=1, dtype=dtype)
        self.conv2 = Conv(features, features, 5, stride=5, dtype=dtype)

    def forward(self, c_local: torch.Tensor) -> torch.Tensor:
        n = min(50, c_local.shape[-4])
        x = c_local[..., :n, :, :, :]
        if x.dim() == 4:
            x = x[None]
        x = self.actfn(self.conv0(x))
        x = self.actfn(self.conv1(x))
        return self.conv2(x).mean(dim=(-4, -3, -2))


class DenoisingModel(nn.Module):
    def __init__(
        self,
        out_features: int,
        timesteps: int,
        dim: int = 32,
        u_net_levels: int = 4,
        actfn_name: str = "silu",
        norm_type: str = "group",
        time_embedding: str = "nyquist",
        attention_kind: str = "full",
        with_geometry_embedding: bool = False,
        conditioning: Optional[Conditioning] = None,
        in_features: Optional[int] = None,
        c_global_features: int = 0,
        dtype: Optional[torch.dtype] = None,
        remat: bool = False,
    ):
        super().__init__()
        actfn = ACTIVATIONS[actfn_name]
        self.actfn = actfn
        self.dtype = dtype
        in_features = out_features if in_features is None else in_features

        self.conditioning = conditioning
        if time_embedding == "nyquist":
            self.time_embedding = NyquistFrequencyEmbedding(dim, timesteps)
        elif time_embedding == "sinusoidal":
            self.time_embedding = SinusoidalTimeEmbedding(dim)
        else:
            raise ValueError(f"Unknown time embedding {time_embedding!r}")

        c_dim = dim
        self.encode_c_global = None
        if c_global_features:
            self.encode_c_global = Dense(c_global_features, dim, dtype)
            c_dim += dim
        self.geometry_embedding = None
        if with_geometry_embedding and conditioning is not None:
            self.geometry_embedding = GeometryEmbedding(conditioning.out_dim, dim, actfn, dtype)
            c_dim += dim
        self.process_c_0 = Dense(c_dim, 4 * c_dim, dtype)
        self.process_c_1 = Dense(4 * c_dim, c_dim, dtype)

        self.encode_x = Conv(in_features, dim, 1, dtype=dtype)
        unet_in = dim
        self.encode_c_local = None
        if conditioning is not None:
            self.encode_c_local = Conv(conditioning.out_dim, dim, 1, dtype=dtype)
            unet_in += dim
        # As in flax, remat covers the U-Net's blocks, not decode_resnet.
        self.u_net = UNet(
            unet_in, dim, u_net_levels, c_dim, actfn, norm_type, attention_kind, dtype, remat
        )
        self.decode_resnet = ResnetBlock(dim, dim, c_dim, actfn, norm_type, dtype)
        self.decode_out = Conv(dim, out_features, 1, dtype=torch.float32)

    def init_weights(self, generator: Optional[torch.Generator] = None) -> "DenoisingModel":
        """Re-draw every parameter (flax's initializers) from ``generator``."""
        for module in self.modules():
            if isinstance(module, nn.Embedding):
                with torch.no_grad():
                    nn.init.normal_(module.weight, generator=generator)
            elif isinstance(module, (Dense, Conv, Conv3d, GroupNorm)):
                module.reset_parameters(generator)
        return self

    def forward(
        self,
        x: torch.Tensor,
        t: torch.Tensor,
        cell_types: Optional[torch.Tensor] = None,
        c_global: Optional[torch.Tensor] = None,
        *,
        slab: Optional[Slab] = None,
    ) -> torch.Tensor:
        """
        x:          (B, X, Y, Z, F) noisy normalized fields
        t:          (B,) integer timesteps
        cell_types: (X, Y, Z) integer cell types (shared across the batch)
        c_global:   optional (B, G) global features
        slab:       None, or x's x slab of the spatial axis (x then holds
                    those planes of the grid of ``cell_types``)
        """
        B = x.shape[0]
        if slab is not None and (cell_types is None or cell_types.shape[-3] != slab.X):
            raise ValueError(f"an x slab of {slab.X} planes needs the whole grid's cell_types, got "
                             f"{None if cell_types is None else tuple(cell_types.shape)}")
        c_local = None
        if self.conditioning is not None:
            if cell_types is None:
                raise ValueError("a model with conditioning needs cell_types")
            c_local = self.conditioning(cell_types)

        t_emb = self.time_embedding(t.float())
        if self.dtype is not None:
            t_emb = t_emb.to(self.dtype)
        c_parts = [t_emb]
        if self.encode_c_global is not None:
            c_parts.append(self.encode_c_global(c_global))
        if self.geometry_embedding is not None:
            g = self.geometry_embedding(c_local)
            c_parts.append(g.expand(B, g.shape[-1]))
        c = torch.cat(c_parts, dim=-1)
        c = self.actfn(self.process_c_0(c))
        c = self.actfn(self.process_c_1(c))

        h = self.encode_x(x)
        if c_local is not None:
            if slab is not None:
                c_local = c_local[slice(*slab.planes)]
            enc = self.encode_c_local(c_local)
            h = torch.cat([h, enc[None].expand(B, *enc.shape)], dim=-1)

        h = self.u_net(h, c, slab)
        h = self.decode_resnet(h, c, slab)
        return self.decode_out(h.float())
