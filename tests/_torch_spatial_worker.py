"""A pool of ranks for the spatial-axis tests, and the jobs they run.

Run as ``python tests/_torch_spatial_worker.py <dir>`` with ``GT_DIST_*``
set: the rank joins a gloo group on the CPU (one thread, collectives bounded
at 60 s) and then runs job after job: it waits for ``<dir>/job<k>.pt`` (a
spec naming the job, the mesh shape and its inputs), runs it on the mesh,
writes ``<dir>/job<k>.rank<r>.pt`` and waits for job k + 1; the job "stop"
ends it.  ``SpatialPool`` starts the ranks and hands them jobs, so that a
test module pays for starting the group once.  It imports neither JAX nor
the JAX package: a test that compares with JAX hands over arrays.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from generative_turbulence_tpu_torch.data.grid import GridMap  # noqa: E402
from generative_turbulence_tpu_torch.data.schema import FieldStats, read_metadata  # noqa: E402
from generative_turbulence_tpu_torch.data.variables import Variable  # noqa: E402
from generative_turbulence_tpu_torch.models.blocks import Conv3d, GroupNorm, VoxelAttention  # noqa: E402
from generative_turbulence_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from generative_turbulence_tpu_torch.ops.interp import resize_trilinear  # noqa: E402
from generative_turbulence_tpu_torch.parallel.distributed import process_rank_and_world  # noqa: E402
from generative_turbulence_tpu_torch.parallel.mesh import init_mesh, local_rows, rank_noise  # noqa: E402
from generative_turbulence_tpu_torch.parallel.spatial import (  # noqa: E402
    Slab, gather_x, halo_exchange, slab_of, sp_all_reduce_sum,
)
from generative_turbulence_tpu_torch.training.config import parse_cli_overrides  # noqa: E402
from generative_turbulence_tpu_torch.training.diffusion_task import DiffusionTask  # noqa: E402
from _torch_dist_worker import Draws  # noqa: E402

WORKER = Path(__file__).resolve()
COLLECTIVE_TIMEOUT_S = 60.0


def _numpy(t):
    return t.detach().float().numpy().copy()


def _slab_run(layout, fn, x, cotangent, X):
    """fn on this rank's slab of x on the mesh's axis; returns the whole
    output (gathered) and the whole input gradient of sum(out * cotangent)
    (gathered)."""
    slab = Slab(layout.axis, X)
    xs = slab_of(torch.from_numpy(x), slab).clone().requires_grad_()
    out = fn(xs)
    out_slab = slab  # the output's: x's, or the cotangent's
    if cotangent is not None:
        cot = torch.from_numpy(cotangent)
        out_slab = slab.at(cot.shape[1])
        (out * slab_of(cot, out_slab)).sum().backward()
    whole = gather_x(out.detach(), out_slab)
    grad = None if cotangent is None else gather_x(xs.grad, slab)
    return whole, grad


def modules(spec) -> dict:
    """Each module of ``spec["cases"]`` on the mesh's x slabs: the whole
    output, input gradient and parameter gradients (summed over the sp
    group)."""
    layout = init_mesh(tuple(spec["mesh"]))
    out = {}
    for name, case in spec["cases"].items():
        torch.manual_seed(0)
        kind = case["kind"]
        slab = Slab(layout.axis, case["x"].shape[1])
        if kind == "conv3d":
            module = Conv3d(case["x"].shape[-1], case["features"])
            module.load_state_dict({k: torch.from_numpy(v) for k, v in case["params"].items()})
            fn = lambda t, m=module: m(t, slab)  # noqa: E731
        elif kind == "groupnorm":
            module = GroupNorm(case["x"].shape[-1], case["groups"])
            module.load_state_dict({k: torch.from_numpy(v) for k, v in case["params"].items()})
            fn = lambda t, m=module: m(t, slab)  # noqa: E731
        elif kind == "attention":
            module = VoxelAttention(case["x"].shape[-1], heads=2, dim_head=8, kind="full")
            module.load_state_dict({k: torch.from_numpy(v) for k, v in case["params"].items()})
            fn = lambda t, m=module: m(t, slab)  # noqa: E731
        elif kind == "kernel-chain":
            module = None
            tensors = [None if a is None else torch.from_numpy(a) for a in case["args"]]

            def fn(t, a=tensors):
                halo = halo_exchange(t.detach(), 1, layout.axis)
                return ck.kernel_chain(t.detach(), *a, num_groups=case["groups"], eps=1e-5, slab=slab, halo=halo)
        elif kind == "chain":
            module = None
            tensors = [None if a is None else torch.from_numpy(a).requires_grad_() for a in case["args"]]
            fn = lambda t, a=tensors: ck.fused_double_conv_block(t, *a, case["groups"], 1e-5, slab)  # noqa: E731
        elif kind == "resize":
            module = None
            sizes = case["sizes"]

            def fn(t, sizes=sizes):
                at = slab
                for size in sizes:
                    t, at = resize_trilinear(t, size, slab=at), at.at(size[0])
                return t
        else:
            raise ValueError(kind)
        whole, grad = _slab_run(layout, fn, case["x"], case.get("cotangent"), slab.X)
        params = {}
        leaves = {}
        if module is not None:
            leaves = dict(module.named_parameters())
        elif kind == "chain":
            leaves = {f"arg{i}": t for i, t in enumerate(tensors) if t is not None}
        for pname, p in leaves.items():
            params[pname] = _numpy(sp_all_reduce_sum(p.grad, layout.axis)) if p.grad is not None else None
        out[name] = dict(out=_numpy(whole), grad=None if grad is None else _numpy(grad), params=params)
    return out


def exchange(spec) -> dict:
    """The x round trip (``slab_of`` -> ``gather_x``) and ``halo_exchange``
    of ``spec["x"]`` on the mesh, with the exchange's gradient of
    sum(lo * a) + sum(hi * b) for this rank's own a, b."""
    layout = init_mesh(tuple(spec["mesh"]))
    axis = layout.axis
    x = torch.from_numpy(spec["x"])
    slab = Slab(axis, x.shape[1])
    xs = slab_of(x, slab).clone().requires_grad_()
    whole = gather_x(xs, slab)
    lo, hi = halo_exchange(xs, 1, axis)
    weights = torch.from_numpy(spec["weights"])[axis.index]
    ((lo * weights[:, : lo.shape[1]]).sum() + (hi * weights[:, 1:][:, : hi.shape[1]]).sum()).backward()
    return dict(whole=_numpy(whole), lo=_numpy(lo), hi=_numpy(hi), grad=_numpy(xs.grad),
                slab=slab.planes, sp_index=axis.index, dp_index=layout.dp_index)


def _task(spec):
    cfg = parse_cli_overrides(spec["overrides"]).model
    task = DiffusionTask(cfg, FieldStats(spec["stats"]), "cpu", max_train_steps=spec.get("max_train_steps", 1))
    task.net.load_state_dict({k: torch.from_numpy(v) for k, v in spec["start"].items()})
    task.init_state()
    return task


def train_step(spec) -> dict:
    """One ``DiffusionTask.training_step`` on the mesh from the spec's
    parameters, on this dp group's rows of the global batch and of the
    replayed global draws (t, noise): loss, gradients, parameters."""
    layout = init_mesh(tuple(spec["mesh"]))
    grid = GridMap.from_metadata(read_metadata(Path(spec["case_file"])), (Variable.U, Variable.P), device="cpu")
    cells = local_rows(torch.from_numpy(spec["cells"]), layout.dp_index, layout.dp)
    task = _task(spec)
    loss = float(task.training_step(cells, grid, rank_noise(Draws(spec["draws"])))["train/loss"])
    grads = {n: _numpy(p.grad) for n, p in task.net.named_parameters()}
    return dict(loss=loss, grads=grads, params={k: _numpy(v) for k, v in task.net.state_dict().items()},
                train_net=type(task.train_net).__name__, sp_index=layout.sp_index, dp_index=layout.dp_index)


def sample(spec) -> dict:
    """``DiffusionTask.sample`` (DDIM) on the mesh from the spec's
    parameters, on this dp group's rows, with the replayed global normals."""
    layout = init_mesh(tuple(spec["mesh"]))
    grid = GridMap.from_metadata(read_metadata(Path(spec["case_file"])), (Variable.U, Variable.P), device="cpu")
    cells = local_rows(torch.from_numpy(spec["cells"]), layout.dp_index, layout.dp)
    task = _task(spec)
    samples = task.sample(cells, grid, rank_noise(Draws(spec["draws"])))
    return dict(samples=_numpy(samples), dp_index=layout.dp_index)


JOBS = {"modules": modules, "exchange": exchange, "train_step": train_step, "sample": sample}


class SpatialPool:
    """``world`` ranks of this worker over a ``file://`` rendezvous in
    ``tmp_path``; ``run(job, spec)`` hands every rank one job and returns
    their outputs, and a rank that fails or outlives ``timeout_s`` fails the
    job (and, on a timeout, ends the pool)."""

    def __init__(self, tmp_path: Path, world: int = 4):
        self.dir, self.world, self.k = Path(tmp_path), world, 0
        env = {k: v for k, v in os.environ.items() if not k.startswith("GT_DIST")}
        env.update(OMP_NUM_THREADS="1", GT_DIST_NUM_PROCESSES=str(world),
                   GT_DIST_COORDINATOR=f"file://{self.dir / 'rendezvous'}")
        self.procs = []
        for rank in range(world):
            log = open(self.dir / f"rank{rank}.log", "w+")
            self.procs.append((subprocess.Popen([sys.executable, str(WORKER), str(self.dir)],
                                                env={**env, "GT_DIST_PROCESS_ID": str(rank)}, cwd=REPO,
                                                stdout=log, stderr=subprocess.STDOUT), log))

    def _logs(self) -> str:
        text = []
        for rank, (_, log) in enumerate(self.procs):
            log.seek(0)
            text.append(f"--- rank {rank}:\n{log.read()[-4000:]}")
        return "\n".join(text)

    def run(self, job: str, spec: dict, timeout_s: float = 120.0):
        k, self.k = self.k, self.k + 1
        tmp = self.dir / f"job{k}.tmp"
        torch.save({"job": job, **spec}, tmp)
        os.replace(tmp, self.dir / f"job{k}.pt")
        outs = [self.dir / f"job{k}.rank{r}.pt" for r in range(self.world)]
        deadline = time.monotonic() + timeout_s
        while not all(out.is_file() for out in outs):
            if time.monotonic() > deadline or any(proc.poll() is not None for proc, _ in self.procs):
                self.close(kill=True)
                raise AssertionError(f"{job}: the ranks did not finish within {timeout_s} s:\n{self._logs()}")
            time.sleep(0.05)
        results = [torch.load(out, weights_only=False) for out in outs]
        failed = [r for r, res in enumerate(results) if "error" in res]
        assert not failed, f"{job}: ranks {failed} failed: {[results[r]['error'] for r in failed]}\n{self._logs()}"
        return results

    def close(self, kill: bool = False):
        if not kill:
            torch.save({"job": "stop"}, self.dir / f"job{self.k}.tmp")
            os.replace(self.dir / f"job{self.k}.tmp", self.dir / f"job{self.k}.pt")
        for proc, log in self.procs:
            try:
                proc.wait(timeout=0 if kill else 30)
            except subprocess.TimeoutExpired:
                pass
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()


def main(job_dir: str) -> int:
    from generative_turbulence_tpu_torch.parallel.distributed import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed("cpu", timeout_s=COLLECTIVE_TIMEOUT_S)
    rank, _ = process_rank_and_world()
    job_dir = Path(job_dir)
    k = 0
    while True:
        spec_file = job_dir / f"job{k}.pt"
        while not spec_file.is_file():
            time.sleep(0.02)
        spec = torch.load(spec_file, weights_only=False)  # written by the test that started this pool
        if spec["job"] == "stop":
            return 0
        try:
            out = JOBS[spec["job"]](spec)
        except Exception as e:  # reported to the test through the output file
            traceback.print_exc()
            out = {"error": f"{type(e).__name__}: {e}"}
        tmp = job_dir / f"job{k}.rank{rank}.tmp"
        torch.save(out, tmp)
        os.replace(tmp, job_dir / f"job{k}.rank{rank}.pt")
        sys.stdout.flush()
        k += 1


if __name__ == "__main__":
    np.seterr(all="ignore")
    sys.exit(main(*sys.argv[1:]))
