"""The data-parallel layout: which rows of a batch and of its draws a rank
keeps.

Port of the ``dp`` axis of ``generative_turbulence_tpu/parallel/mesh.py``
(a ``(dp, sp)`` mesh with ``sp = 1``): the JAX package places the cells of a
global batch with ``P("dp")`` (``shard_batch_arrays``), so device r holds
the contiguous rows ``[r*B/W, (r+1)*B/W)``, and its ``jax.random`` draws are
global arrays cut the same way.  Here each rank keeps those rows of the
global batch (``local_rows``) and draws the whole batch's t and noise,
keeping its own rows (``RankRows``): a W-rank step then sees the draws of
the 1-rank step, and no two ranks share a draw.

The spatial axis (``sp > 1``, grid-x over ranks) is not ported: it needs a
halo exchange between ranks in the chain kernel's x-edge staging
(ROADMAP).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .distributed import process_rank_and_world


def check_mesh_shape(mesh_shape: Optional[Tuple[int, int]], world: int) -> None:
    """``trainer.mesh_shape`` against the run's world size: None (data
    parallel over every rank) or ``(world, 1)``; anything else raises."""
    if mesh_shape is None:
        return
    dp, sp = (int(v) for v in mesh_shape)
    if sp != 1:
        raise ValueError(f"trainer.mesh_shape={tuple(mesh_shape)}: the spatial axis sp > 1 is not ported "
                         "(ROADMAP: the halo exchange between ranks); use (world size, 1) or leave it unset")
    if dp != world:
        raise ValueError(f"trainer.mesh_shape={tuple(mesh_shape)}: dp = {dp} but the run has {world} rank(s); "
                         "the port's dp axis spans every rank (ROADMAP)")


def local_rows(rows, rank: int, world: int):
    """Rank ``rank``'s contiguous rows ``[rank*B/world, (rank+1)*B/world)``
    of ``rows`` (a tensor, array or list of B rows); B must divide by
    ``world``."""
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
    """``noise`` as this rank's rows of the global draws (``noise`` itself
    in a single process)."""
    rank, world = process_rank_and_world()
    return noise if world <= 1 else RankRows(noise, rank, world)
