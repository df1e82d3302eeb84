"""The port's check entry points (the repository root's
``__graft_entry__.py`` for the JAX package).

- ``entry()``: the epsilon-network's forward at a small fixed shape and its
  example arguments, for a single-card check.
- ``dryrun_multichip(n)``: one full diffusion training step on ``n`` ranks
  at the mesh ``(n/2, 2)`` (``(n, 1)`` for odd n): the batch over dp, the
  grid's x over sp, halo exchanges and all.

Both build what ``__graft_entry__.py:_build`` builds: a synthetic case of
24x12x12 cells (26x14x14 padded, seed 0), the learned cell-type embedding of
dimension 4, dim 16, 2 U-Net levels, T = 10 and batch 2.  They run on the
card unless asked for the CPU (``device="cpu"``).  ``dryrun_multichip``
starts its ranks as processes of its own (a ``tcp://localhost`` rendezvous
on a free port): NCCL where each rank has a card of its own, gloo on the CPU
or where the ranks share the cards.

    python -m generative_turbulence_tpu_torch.graft_entry [--device cpu] [n]
"""

from __future__ import annotations

import argparse
import os
import socket
import tempfile
from pathlib import Path
from typing import Mapping, Optional

import torch


def _build(grid_shape=(26, 14, 14), dim=16, levels=2, timesteps=10, batch=2, device="cuda",
           params: Optional[Mapping] = None, seed: int = 0):
    """(model, grid, x, t): the model's weights drawn from ``seed``, or
    ``params`` (a flax parameter tree); x standard normals of the grid."""
    from .data.grid import GridMap
    from .data.schema import read_metadata
    from .data.synthetic import generate_case
    from .data.variables import Variable
    from .models.conditioning import Conditioning
    from .models.unet import DenoisingModel
    from .toolchain.from_flax import torch_state_dict_from_flax

    with tempfile.TemporaryDirectory() as tmp:
        file = generate_case(Path(tmp) / "case", cell_counts=tuple(s - 2 for s in grid_shape), n_frames=1,
                             seed=0, format="npyd")
        meta = read_metadata(file)
    grid = GridMap.from_metadata(meta, (Variable.U, Variable.P), device=device)
    model = DenoisingModel(out_features=4, timesteps=timesteps, dim=dim, u_net_levels=levels,
                           conditioning=Conditioning(cell_type_embedding_dim=4))
    gen = torch.Generator().manual_seed(seed)
    if params is None:
        model.init_weights(gen)
    else:
        model.load_state_dict(torch_state_dict_from_flax(params))
    x = torch.randn((batch, *grid.shape, 4), generator=gen)
    return model.to(device), grid, x.to(device), torch.zeros((batch,), dtype=torch.long, device=device)


def entry(device="cuda", params: Optional[Mapping] = None):
    """``(fn, example_args)``: ``fn(x, t)`` is the epsilon-network's forward
    over the case's cell types (weights from seed 0, or the flax tree
    ``params``), ``example_args`` its (x, t)."""
    model, grid, x, t = _build(device=device, params=params)
    cell_types = grid.cell_types

    def forward(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return model(x, t, cell_types)

    return forward, (x, t)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dryrun_rank(rank: int, n: int, port: int, device: str) -> None:
    """One rank of ``dryrun_multichip``: the training step of
    ``__graft_entry__.dryrun_multichip`` (clip 0.1, RAdam 1e-4,
    log-snr-linear, T = 10) on this rank's rows and x slab."""
    os.environ.update(GT_DIST_NUM_PROCESSES=str(n), GT_DIST_PROCESS_ID=str(rank),
                      GT_DIST_COORDINATOR=f"localhost:{port}")
    os.environ.pop("GT_DISTRIBUTED", None)
    if device == "cpu":
        torch.set_num_threads(1)
    from .diffusion.gaussian import GaussianDiffusion, GeneratorNoise
    from .parallel.distributed import data_parallel, initialize_distributed, mean_over_ranks
    from .parallel.mesh import RankRows, init_mesh, local_rows
    from .training.diffusion_task import x_slab_inputs
    from .training.optimizers import build_optimizer

    initialize_distributed(device, timeout_s=300.0)
    sp = 2 if n % 2 == 0 and n > 1 else 1
    dp = n // sp
    layout = init_mesh((dp, sp))
    dev = torch.device(device, torch.cuda.current_device()) if device == "cuda" else torch.device(device)
    model, grid, x, _ = _build(batch=max(2, dp), device=dev)
    gd = GaussianDiffusion.create(beta_schedule="log-snr-linear", timesteps=10)
    tx = build_optimizer(optimizer="radam", learning_rate=1e-4, gradient_clip_val=0.1)
    params = list(model.parameters())
    state = tx.init(params)
    net = data_parallel(model)
    noise = RankRows(GeneratorNoise(torch.Generator(device=dev).manual_seed(0), dev), layout.dp_index, dp)
    x = local_rows(x, layout.dp_index, dp)
    x, step_grid, noise = x_slab_inputs(layout.axis, x, grid, noise)
    loss = gd.loss(lambda x_t, t: net(x_t, t, grid.cell_types, slab=step_grid.slab), x, step_grid, noise)
    loss.backward()
    tx.step_(params, [p.grad for p in params], state)
    loss = float(mean_over_ranks(loss.detach()))
    if not torch.isfinite(torch.tensor(loss)):
        raise RuntimeError(f"loss not finite: {loss}")
    if rank == 0:
        print(f"dryrun_multichip ok: mesh=({dp}x{sp}) devices={n} loss={loss:.4f}", flush=True)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """One sharded diffusion training step over ``n_devices`` ranks at the
    mesh ``(n/2, 2)``, or ``(n, 1)`` for odd n; rank 0 prints
    ``dryrun_multichip ok: mesh=(dp x sp) devices=n loss=...``.  A rank
    that fails raises here."""
    import torch.multiprocessing as mp

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is False (pass device='cpu' for the CPU)")
    mp.start_processes(_dryrun_rank, args=(n_devices, _free_port(), device), nprocs=n_devices, join=True,
                       start_method="spawn")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="entry()'s forward, then dryrun_multichip(n)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("n", type=int, nargs="?", default=2, help="ranks of dryrun_multichip")
    args = parser.parse_args(argv)
    fn, example = entry(args.device)
    print("entry forward:", tuple(fn(*example).shape))
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
