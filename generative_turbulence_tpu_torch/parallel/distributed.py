"""The multi-process runtime over ``torch.distributed``.

Port of ``generative_turbulence_tpu/parallel/distributed.py``: one process
per rank, brought up from the environment, so that the same training entry
point runs on one card or on several, with rank-0-gated writers downstream
and the per-case metric merge of distributed evaluation.

Activation (checked in order), with the JAX package's variable names:

- ``GT_DIST_NUM_PROCESSES`` above 1: an explicit cluster.  Also reads
  ``GT_DIST_PROCESS_ID`` (required) and ``GT_DIST_COORDINATOR`` (default
  ``localhost:12321``; ``host:port`` means ``tcp://host:port``, and a URL
  such as ``file:///shared/rendezvous`` is taken as it is).
- ``GT_DISTRIBUTED=1``: the ``env://`` variables ``torch.distributed.run``
  sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
  ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``).
- otherwise: nothing (a single-process run).

A rank on ``cuda`` takes the card ``LOCAL_RANK % device_count`` (the rank
itself in the explicit form).  The backend is ``nccl`` where each rank of
the host has a card of its own, and ``gloo`` on the CPU or where ranks share
a card (NCCL refuses two ranks on one card; gloo all-reduces CUDA tensors
through the host).
"""

from __future__ import annotations

import datetime
import os
import sys
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist


def process_rank_and_world() -> Tuple[int, int]:
    """(rank, world size) of an initialised ``torch.distributed`` group,
    else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main_process() -> bool:
    """Rank 0 of an initialised group, or a single process."""
    return process_rank_and_world()[0] == 0


def _cluster_from_env() -> Optional[dict]:
    """The cluster the environment asks for, or None."""
    n = os.environ.get("GT_DIST_NUM_PROCESSES")
    if n is not None:
        world = int(n)
        if world <= 1:
            return None
        if "GT_DIST_PROCESS_ID" not in os.environ:
            raise RuntimeError("GT_DIST_NUM_PROCESSES is set but GT_DIST_PROCESS_ID is not")
        rank = int(os.environ["GT_DIST_PROCESS_ID"])
        coordinator = os.environ.get("GT_DIST_COORDINATOR", "localhost:12321")
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        return dict(init_method=init_method, rank=rank, world=world, local_rank=rank, local_world=world)
    if os.environ.get("GT_DISTRIBUTED") == "1":
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        return dict(init_method="env://", rank=rank, world=world,
                    local_rank=int(os.environ.get("LOCAL_RANK", rank)),
                    local_world=int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    return None


def initialize_distributed(device: str = "cuda", timeout_s: float = 1800.0) -> bool:
    """Join the process group the environment describes.  Idempotent.

    ``device`` is the run's device type: on ``cuda`` the rank's card becomes
    the current device, and a rank without one stops the run rather than
    train on the CPU.  ``timeout_s`` bounds each collective.  Returns True
    iff the process is in a group.
    """
    if dist.is_available() and dist.is_initialized():
        return True
    cluster = _cluster_from_env()
    if cluster is None:
        return False
    device_type = torch.device(device).type
    shared_card = False
    card = "cpu"
    if device_type == "cuda":
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_cards == 0:
            raise RuntimeError(f"rank {cluster['rank']}: no CUDA device: torch.cuda.is_available() is False "
                               "(pass --device cpu to run on the CPU)")
        index = cluster["local_rank"] % n_cards
        torch.cuda.set_device(index)
        shared_card = cluster["local_world"] > n_cards
        card = f"cuda:{index} ({torch.cuda.get_device_name(index)})"
    backend = "nccl" if device_type == "cuda" and not shared_card else "gloo"
    dist.init_process_group(backend, init_method=cluster["init_method"], rank=cluster["rank"],
                            world_size=cluster["world"], timeout=datetime.timedelta(seconds=timeout_s))
    print(f"[rank {cluster['rank']}/{cluster['world']}] device {card}, backend {backend}"
          f"{', card shared by the host ranks' if shared_card else ''}", file=sys.stderr, flush=True)
    return True


def _collective_device() -> torch.device:
    """Where a host value travels: NCCL moves CUDA tensors only."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def reduce_host_value(value: float, op: str) -> float:
    """``value`` reduced over the ranks by ``op`` ("sum", "min" or "max");
    the value itself outside a process group."""
    if not _in_group():
        return value
    t = torch.tensor([float(value)], dtype=torch.float64, device=_collective_device())
    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}[op])
    return float(t.item())


def sum_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a new tensor; ``t`` outside a
    process group)."""
    if not _in_group():
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


def mean_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the ranks (``t`` outside a process group)."""
    if not _in_group():
        return t
    return sum_over_ranks(t) / dist.get_world_size()


def barrier() -> None:
    """Wait for every rank (nothing outside a process group)."""
    if _in_group():
        dist.barrier()


def allgather_objects(obj) -> List:
    """``[obj_from_rank0, obj_from_rank1, ...]`` on every rank (``[obj]`` in
    a single process).  Collective: every rank calls it the same number of
    times.  The objects travel pickled between the ranks of one run."""
    rank, world = process_rank_and_world()
    if world <= 1:
        return [obj]
    out = [None] * world
    dist.all_gather_object(out, obj)
    return out


def data_parallel(module: torch.nn.Module) -> torch.nn.Module:
    """``module`` under ``DistributedDataParallel`` in a process group (its
    gradients averaged over the ranks in the backward), else ``module``
    itself.  Every parameter of the port's nets gets a gradient
    on every step, so unused parameters are not searched for."""
    if not _in_group():
        return module
    from torch.nn.parallel import DistributedDataParallel

    device = next(module.parameters()).device
    device_ids = [device.index] if device.type == "cuda" else None
    return DistributedDataParallel(module, device_ids=device_ids)
