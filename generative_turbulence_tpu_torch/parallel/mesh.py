"""The ``(dp, sp)`` layout of a run: which rows of a batch and of its draws
a rank keeps, and which ranks share one grid along x.

Port of ``generative_turbulence_tpu/parallel/mesh.py``: the JAX package
arranges its devices as ``devices[:dp*sp].reshape(dp, sp)`` and places the
cells of a global batch with ``P("dp")`` and dense grids with ``P("dp",
"sp")``.  Here rank r sits at ``(r // sp, r % sp)``: its dp index d picks
the contiguous rows ``[d*B/dp, (d+1)*B/dp)`` of the global batch
(``local_rows``) and of its draws (``RankRows``), alike for the sp ranks of
one group, which hold x slabs of the same rows (``parallel.spatial``).  A
(dp, sp) step then sees the draws of the 1-process step, and no two dp
groups share a draw.  ``init_mesh`` builds the sp groups' process groups
and makes the layout the process's; without one, every rank is its own dp
group (sp = 1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from .distributed import process_rank_and_world
from .spatial import SpatialAxis, x_slab  # noqa: F401  (x_slab: a rank's planes)


def check_mesh_shape(mesh_shape: Optional[Tuple[int, int]], world: int) -> None:
    """``trainer.mesh_shape`` against the run's world size: None (data
    parallel over every rank) or ``(dp, sp)`` with dp x sp = world;
    anything else raises."""
    if mesh_shape is None:
        return
    dp, sp = (int(v) for v in mesh_shape)
    if dp < 1 or sp < 1:
        raise ValueError(f"trainer.mesh_shape={tuple(mesh_shape)}: dp and sp must be at least 1")
    if dp * sp != world:
        raise ValueError(f"trainer.mesh_shape={tuple(mesh_shape)}: dp x sp = {dp * sp} but the run has "
                         f"{world} rank(s)")


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """Rank ``rank`` at ``(dp_index, sp_index)`` of a ``(dp, sp)`` mesh;
    ``axis`` is its sp group's spatial axis."""

    dp: int
    sp: int
    rank: int
    axis: SpatialAxis

    @property
    def dp_index(self) -> int:
        return self.rank // self.sp

    @property
    def sp_index(self) -> int:
        return self.rank % self.sp


_LAYOUT: Optional[MeshLayout] = None
_GROUPS: dict = {}  # (dp, sp) -> this rank's sp process group


def init_mesh(mesh_shape: Optional[Tuple[int, int]]) -> MeshLayout:
    """Make ``mesh_shape`` (None: ``(world, 1)``) the process's layout and
    return it.  With sp > 1 a collective: every rank calls it, in the same
    order, and each sp group gets a process group of its own (made once per
    shape)."""
    global _LAYOUT
    rank, world = process_rank_and_world()
    check_mesh_shape(mesh_shape, world)
    dp, sp = (world, 1) if mesh_shape is None else (int(v) for v in mesh_shape)
    if sp > 1 and (dp, sp) not in _GROUPS:
        import torch.distributed as dist

        for d in range(dp):
            members = dist.new_group([d * sp + j for j in range(sp)])
            if d == rank // sp:
                _GROUPS[dp, sp] = members
    _LAYOUT = MeshLayout(dp=dp, sp=sp, rank=rank, axis=SpatialAxis(rank % sp, sp, _GROUPS.get((dp, sp))))
    return _LAYOUT


def mesh_layout() -> MeshLayout:
    """The process's layout: ``init_mesh``'s, else every rank a dp group of
    its own."""
    rank, world = process_rank_and_world()
    if _LAYOUT is not None and _LAYOUT.dp * _LAYOUT.sp == world and _LAYOUT.rank == rank:
        return _LAYOUT
    return MeshLayout(dp=world, sp=1, rank=rank, axis=SpatialAxis(0, 1))


def dp_rank_and_size() -> Tuple[int, int]:
    """(dp index, dp) of this process: what its rows and its share of the
    evaluation cases are keyed on."""
    layout = mesh_layout()
    return layout.dp_index, layout.dp


def local_rows(rows, rank: int, world: int):
    """Rank ``rank``'s contiguous rows ``[rank*B/world, (rank+1)*B/world)``
    of ``rows`` (a tensor, array or list of B rows); B must divide by
    ``world``.  Called with (dp index, dp)."""
    n = len(rows)
    if n % world:
        raise ValueError(f"a global batch of {n} rows does not split over {world} ranks")
    per = n // world
    return rows[rank * per : (rank + 1) * per]


class RankRows:
    """A noise source (``noise(shape)``, ``noise.randint(n, high)``) that
    draws for the whole global batch of ``world`` equal local batches and
    hands out rank ``rank``'s rows."""

    def __init__(self, noise, rank: int, world: int):
        self.noise, self.rank, self.world = noise, rank, world

    def __call__(self, shape: Sequence[int]) -> torch.Tensor:
        shape = tuple(shape)
        return local_rows(self.noise((shape[0] * self.world, *shape[1:])), self.rank, self.world)

    def randint(self, n: int, high: int) -> torch.Tensor:
        return local_rows(self.noise.randint(n * self.world, high), self.rank, self.world)


def rank_noise(noise):
    """``noise`` as this dp group's rows of the global draws (``noise``
    itself with one dp group)."""
    d, dp = dp_rank_and_size()
    return noise if dp <= 1 else RankRows(noise, d, dp)
