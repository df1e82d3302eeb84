"""The spatial axis ``sp``: grid-x slabs over the ranks of an sp group.

Port of the ``sp`` axis of ``generative_turbulence_tpu/parallel/mesh.py``
(``grid_partition``: dense ``(B, X, Y, Z, F)`` grids sharded over grid-x),
where XLA's SPMD partitioner inserts the halo exchanges and reductions.
Here the modules ask for them: a module on the spatial axis is given its
input's ``Slab`` (the sp group's ``SpatialAxis`` and the grid's global x
extent X) beside the tensor, which holds the contiguous planes
``x_slab(X, j, sp)`` of sp-rank j, and

- ``halo_exchange`` gives a conv its neighbours' edge planes
  (``replicate_pad`` puts them in place of the replicated ones),
- ``fetch_planes`` gives a resize the input planes its output planes need,
- ``gather_x`` / ``slab_of`` make a whole grid of a slab and back,
- ``sp_all_reduce_sum`` sums loss sums, ``sp_var_mean`` GroupNorm's moments.

Each collective is an autograd ``Function`` over ``all_gather`` and
``all_reduce`` only, which gloo also takes for CUDA tensors (two ranks
sharing one card): ``send``/``recv`` are not used, so nothing is staged
through the host by hand.  The gradient convention: the backward of every
collective sums over the group (an exchanged plane's gradient goes back to
the rank that owns it and is added to its own), so each rank seeds its
backward with the replicated loss and a parameter's gradient, summed over
the sp group, is sp times the loss's; ``DistributedDataParallel`` over the
whole world (``training/diffusion_task.py``) divides by dp x sp, which
leaves the mean over dp of each sp group's gradient.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F


def x_slab(X: int, j: int, sp: int) -> Tuple[int, int]:
    """The planes ``[start, stop)`` of global extent X that sp-rank j of sp
    holds: contiguous, the first ``X % sp`` ranks one plane more (X = 97
    over 2: 49 and 48)."""
    q, r = divmod(int(X), int(sp))
    start = j * q + min(j, r)
    return start, start + q + (1 if j < r else 0)


@dataclasses.dataclass(frozen=True)
class SpatialAxis:
    """sp-rank ``index`` of an sp group of ``size`` ranks (``group``: its
    process group, None for the default group)."""

    index: int
    size: int
    group: Optional[object] = None

    def slab(self, X: int) -> Tuple[int, int]:
        return x_slab(X, self.index, self.size)


@dataclasses.dataclass(frozen=True)
class Slab:
    """This rank's x slab of a grid of global x extent ``X`` on ``axis``:
    what a module on the spatial axis is given beside the slab's tensor."""

    axis: SpatialAxis
    X: int

    def __post_init__(self):
        if self.X < self.axis.size:
            raise ValueError(f"{self.X} x-planes do not split over {self.axis.size} ranks")

    @property
    def planes(self) -> Tuple[int, int]:
        """This rank's planes ``[start, stop)``."""
        return self.axis.slab(self.X)

    def at(self, X: int) -> "Slab":
        """The same rank's slab of a grid of global x extent X (another
        level of the U-Net)."""
        return Slab(self.axis, int(X))


def slab_on(axis: Optional[SpatialAxis], X: int) -> Optional[Slab]:
    """The slab of a grid of global x extent X on ``axis``; None without
    an axis of more than one rank."""
    return None if axis is None or axis.size == 1 else Slab(axis, int(X))


def _all_gather(t: torch.Tensor, axis: SpatialAxis) -> List[torch.Tensor]:
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(out, t, group=axis.group)
    return out


def _all_reduce_f32(t: torch.Tensor, axis: SpatialAxis) -> torch.Tensor:
    """The sum of ``t`` over the group, taken in f32 (a new tensor in t's
    type)."""
    out = t.float().clone() if t.dtype != torch.float64 else t.clone()
    dist.all_reduce(out, group=axis.group)
    return out.to(t.dtype)


# ---- plane exchange ------------------------------------------------------------


class _Exchange(torch.autograd.Function):
    """Every rank contributes its first and last K planes (zero-padded to K
    where its slab is shorter) to one all-gather; ``left_idx`` and
    ``right_idx`` pick this rank's planes from the gathered
    ``(B, sp * 2K, ...)`` buffer.  Backward: the planes' gradients are put
    back into a buffer of that shape, summed over the group, and each rank
    adds its own rows to its first and last planes."""

    @staticmethod
    def forward(ctx, x, axis, K, left_idx, right_idx):
        ctx.axis, ctx.K, ctx.L = axis, K, x.shape[1]
        ctx.shape, ctx.dtype = x.shape, x.dtype
        L, n = x.shape[1], min(K, x.shape[1])
        pad = x.new_zeros((x.shape[0], K - n, *x.shape[2:]))
        buf = torch.cat([x[:, :n], pad, pad, x[:, L - n:]], dim=1)
        gathered = torch.cat(_all_gather(buf, axis), dim=1)
        ctx.idx = left_idx, right_idx
        pick = lambda idx: gathered.index_select(1, torch.tensor(idx, dtype=torch.long, device=x.device))  # noqa: E731
        return pick(left_idx), pick(right_idx)

    @staticmethod
    def backward(ctx, g_left, g_right):
        axis, K, L = ctx.axis, ctx.K, ctx.L
        B, rest = ctx.shape[0], ctx.shape[2:]
        device = g_left.device
        buf = torch.zeros((B, axis.size * 2 * K, *rest), dtype=torch.float32, device=device)
        for idx, g in zip(ctx.idx, (g_left, g_right)):
            buf.index_add_(1, torch.tensor(idx, dtype=torch.long, device=device), g.float())
        dist.all_reduce(buf, group=axis.group)
        mine = buf[:, axis.index * 2 * K : (axis.index + 1) * 2 * K]
        n = min(K, L)
        grad = torch.zeros((B, L, *rest), dtype=torch.float32, device=device)
        grad[:, :n] += mine[:, :n]
        grad[:, L - n:] += mine[:, 2 * K - n:]
        return grad.to(ctx.dtype), None, None, None, None


def _plane_index(p: int, slabs: Sequence[Tuple[int, int]], K: int) -> int:
    """Where global plane p lies in the gathered buffer."""
    for r, (s, e) in enumerate(slabs):
        if s <= p < e:
            return r * 2 * K + (p - s if p - s < K else 2 * K - (e - p))
    raise IndexError(f"plane {p} is on no rank")


def fetch_planes(x: torch.Tensor, X: int, needs: Sequence[Tuple[int, int]], axis: SpatialAxis):
    """The planes beyond its slab that each rank needs: ``needs[r] = (lo, hi)``
    is rank r's range of global planes (around its own slab), the same list
    on every rank.  Returns this rank's ``(planes [lo, start), planes
    [stop, hi))``, each (B, n, Y, Z, C), n possibly 0."""
    slabs = [x_slab(X, r, axis.size) for r in range(axis.size)]
    if x.shape[1] != slabs[axis.index][1] - slabs[axis.index][0]:
        raise ValueError(f"an x slab of {x.shape[1]} planes is not sp-rank {axis.index}'s of {X}")
    K = max(max(s - lo, hi - e, 0) for (s, e), (lo, hi) in zip(slabs, needs))
    if K == 0:
        empty = x[:, :0]
        return empty, empty
    (s, e), (lo, hi) = slabs[axis.index], needs[axis.index]
    left = [_plane_index(p, slabs, K) for p in range(lo, s)]
    right = [_plane_index(p, slabs, K) for p in range(e, hi)]
    return _Exchange.apply(x, axis, K, left, right)


def halo_exchange(x: torch.Tensor, width: int, axis: SpatialAxis):
    """``(lo, hi)``: the ``width`` planes before this rank's slab (the left
    neighbour's last) and after it (the right neighbour's first), each (B,
    width, Y, Z, C), with 0 planes at the global x edges.  Every slab must
    hold at least ``width`` planes.  Differentiable: a halo plane's gradient
    is added to its owner's."""
    if x.shape[1] < width:
        raise ValueError(f"an x slab of {x.shape[1]} planes is thinner than its halo of {width}")
    j, sp, w = axis.index, axis.size, width
    left = [(j - 1) * 2 * w + w + i for i in range(w)] if j > 0 else []
    right = [(j + 1) * 2 * w + i for i in range(w)] if j < sp - 1 else []
    return _Exchange.apply(x, axis, w, left, right)


def replicate_pad(x: torch.Tensor, pad: int, halo: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """x (B, X, Y, Z, C) channels first, replicate-padded by ``pad`` on
    both sides of x, y and z: (B, C, X + 2 pad, Y + 2 pad, Z + 2 pad).
    ``halo``: x's halo planes ``(lo, hi)`` (``halo_exchange``), each (B,
    pad or 0, Y, Z, C) or None, which take the place of the replicated x
    planes on their side (a side of 0 planes, a global x edge, or None
    keeps them)."""
    h = x.permute(0, 4, 1, 2, 3)
    if pad == 0:
        return h
    h = F.pad(h, (pad,) * 6, mode="replicate")
    for plane, side in zip(halo or (), (slice(0, pad), slice(h.shape[2] - pad, None))):
        if plane is not None and plane.shape[1]:
            h[:, :, side] = F.pad(plane.permute(0, 4, 1, 2, 3), (pad,) * 4 + (0, 0), mode="replicate")
    return h


# ---- whole grids and sums ----------------------------------------------------------


class _GatherX(torch.autograd.Function):
    """Forward: the whole grid from every rank's slab (each padded to the
    largest slab for the all-gather).  Backward: the whole grid's gradient
    summed over the group, this rank's slab of it."""

    @staticmethod
    def forward(ctx, x, X, axis):
        ctx.axis, ctx.X = axis, X
        P = -(-X // axis.size)
        pad = x.new_zeros((x.shape[0], P - x.shape[1], *x.shape[2:]))
        parts = _all_gather(torch.cat([x, pad], dim=1), axis)
        sizes = [e - s for s, e in (x_slab(X, r, axis.size) for r in range(axis.size))]
        return torch.cat([part[:, :n] for part, n in zip(parts, sizes)], dim=1)

    @staticmethod
    def backward(ctx, grad):
        s, e = ctx.axis.slab(ctx.X)
        return _all_reduce_f32(grad, ctx.axis)[:, s:e].contiguous(), None, None


def gather_x(x: torch.Tensor, slab: Slab) -> torch.Tensor:
    """The whole (B, X, ...) grid from this rank's x slab (B, n, ...)."""
    s, e = slab.planes
    if x.shape[1] != e - s:
        raise ValueError(f"an x slab of {x.shape[1]} planes is not sp-rank {slab.axis.index}'s of {slab.X}")
    return _GatherX.apply(x, slab.X, slab.axis)


def slab_of(x: torch.Tensor, slab: Slab) -> torch.Tensor:
    """This rank's x slab of a whole (B, X, ...) grid: a slice, whose
    gradient is the slab's and zero elsewhere, the rank's share of the sum
    the collectives take."""
    if x.shape[1] != slab.X:
        raise ValueError(f"a grid of {x.shape[1]} x-planes is not the slab's {slab.X}")
    return x[:, slice(*slab.planes)]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        out = t.clone()
        dist.all_reduce(out, group=axis.group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone()
        dist.all_reduce(out, group=ctx.axis.group)
        return out, None


def sp_all_reduce_sum(t: torch.Tensor, axis: SpatialAxis) -> torch.Tensor:
    """The sum of ``t`` over the sp group, on every rank; its backward sums
    the gradients over the group too."""
    return _AllReduceSum.apply(t, axis)


def sp_var_mean(t: torch.Tensor, dim, n: int, axis: SpatialAxis):
    """``(var, mean)`` over ``dim`` (kept) of the whole grid whose slabs the
    group's ranks hold, ``n`` elements per reduced group in all: two passes,
    each summed over the group (``torch.var_mean(..., correction=0)`` of
    the whole grid, differentiable)."""
    mean = sp_all_reduce_sum(t.sum(dim=dim, keepdim=True), axis) / n
    var = sp_all_reduce_sum(((t - mean) ** 2).sum(dim=dim, keepdim=True), axis) / n
    return var, mean


# ---- draws -------------------------------------------------------------------------


class SlabNoise:
    """A noise source (``noise(shape)``, ``noise.randint(n, high)``) for
    one rank of an sp group: it draws the whole grid of global x extent X,
    as every rank of the group does alike, and keeps this rank's slab; the
    group's slabs make up the 1-process draw."""

    def __init__(self, noise, slab: Slab):
        self.noise, self.slab = noise, slab

    def __call__(self, shape: Sequence[int]) -> torch.Tensor:
        shape = tuple(shape)
        s, e = self.slab.planes
        if shape[1] != e - s:
            raise ValueError(f"a draw of {shape} is not sp-rank {self.slab.axis.index}'s slab of {self.slab.X} planes")
        return self.noise((shape[0], self.slab.X, *shape[2:]))[:, s:e].contiguous()

    def randint(self, n: int, high: int) -> torch.Tensor:
        return self.noise.randint(n, high)
