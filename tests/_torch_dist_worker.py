"""One rank of the port's multi-process tests, and the launcher that starts
the ranks.

Run as ``python tests/_torch_dist_worker.py <job> <spec.pt> <out>``.  With
``GT_DIST_*`` set it joins the process group on the spec's ``device`` (the
CPU by default; gloo there and where the ranks share a card; collectives
bounded at 60 s) and writes ``<out>.rank<r>.pt``; a test runs the same job
in its own process for the 1-process reference.  It imports neither JAX nor
the JAX package (the card-only tests use it too): a test that compares with
JAX hands over JAX's draws as arrays in the spec.

``run_ranks`` starts the ranks with a ``file://`` rendezvous in the test's
temporary directory (no ports to race for under xdist) and kills every rank
when one outlives the deadline, so that a hang fails one test.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from generative_turbulence_tpu_torch.data.grid import GridMap  # noqa: E402
from generative_turbulence_tpu_torch.data.schema import FieldStats, read_metadata  # noqa: E402
from generative_turbulence_tpu_torch.data.variables import Variable  # noqa: E402
from generative_turbulence_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from generative_turbulence_tpu_torch.parallel.distributed import process_rank_and_world  # noqa: E402
from generative_turbulence_tpu_torch.parallel.mesh import local_rows, rank_noise  # noqa: E402
from generative_turbulence_tpu_torch.training.config import parse_cli_overrides  # noqa: E402
from generative_turbulence_tpu_torch.training.diffusion_task import DiffusionTask  # noqa: E402
from generative_turbulence_tpu_torch.training.factory import instantiate_data_and_task  # noqa: E402
from generative_turbulence_tpu_torch.training.loop import KeyedNoise, Trainer  # noqa: E402

WORKER = Path(__file__).resolve()
COLLECTIVE_TIMEOUT_S = 60.0


class Draws:
    """A noise source replaying a fixed list of arrays: ``noise(shape)``
    and ``noise.randint(n, high)`` take the next one, of that shape."""

    def __init__(self, draws):
        self.draws = list(draws)

    def __call__(self, shape):
        draw = self.draws.pop(0)
        assert tuple(shape) == draw.shape, (tuple(shape), draw.shape)
        return torch.tensor(draw)

    def randint(self, n, high):
        draw = self.draws.pop(0)
        assert draw.shape == (n,) and 0 <= draw.min() and draw.max() < high
        return torch.tensor(draw, dtype=torch.long)


def _numpy(tensors):
    return {k: v.detach().float().cpu().numpy().copy() for k, v in tensors.items()}


def diffusion_steps(spec) -> dict:
    """Per variant: ``DiffusionTask.training_step`` from the spec's
    parameters on this rank's rows of the global batch ``cells``, with this
    rank's rows of each step's global draws (t, noise)."""
    rank, world = process_rank_and_world()
    grid = GridMap.from_metadata(read_metadata(Path(spec["case_file"])), (Variable.U, Variable.P), device="cpu")
    cells = local_rows(torch.from_numpy(spec["cells"]), rank, world)
    out = {}
    for name, variant in spec["variants"].items():
        cfg = parse_cli_overrides(variant["overrides"]).model
        task = DiffusionTask(cfg, FieldStats(spec["stats"]), "cpu", max_train_steps=spec["max_train_steps"])
        task.net.load_state_dict({k: torch.from_numpy(v) for k, v in spec["start"].items()})
        task.init_state()
        losses = [float(task.training_step(cells, grid, rank_noise(Draws(d)))["train/loss"])
                  for d in variant["draws"]]
        out[name] = dict(losses=losses, params=_numpy(task.net.state_dict()), ema=_numpy(task.ema),
                         rows=cells.shape[0], train_net=type(task.train_net).__name__)
    return out


def family_steps(spec) -> dict:
    """Per entry of ``spec["runs"]`` (overrides): ``spec["steps"]`` train
    steps of the factory's task (weights from ``trainer.seed``) on the
    first train batches of epoch 0, each with this rank's rows of
    ``KeyedNoise``'s draws for the step; in one process also the starting
    parameters."""
    device = spec.get("device", "cpu")
    out = {}
    for name, overrides in spec["runs"].items():
        config = parse_cli_overrides(overrides).resolved()
        dm, task = instantiate_data_and_task(config, device)
        task.init_weights(torch.Generator(device=task.device).manual_seed(config.trainer.seed))
        start = _numpy(task.net.state_dict()) if process_rank_and_world()[1] == 1 else None
        noise_factory = KeyedNoise(config.trainer.seed, task.device)
        losses, rows = [], []
        ck.reset_launch_counts()
        for i, batch in zip(range(spec["steps"]), dm.train_batches(0)):
            rows.append(batch.cells.shape[0])
            metrics = task.training_step(batch.cells, batch.grid, rank_noise(noise_factory("train", i)))
            losses.append(float(metrics["train/loss"]))
        out[name] = dict(losses=losses, rows=rows, params=_numpy(task.net.state_dict()), start=start,
                         batch_size=config.data.batch_size, launches=dict(ck.LAUNCH_COUNTS),
                         device=str(next(task.net.parameters()).device))
        if hasattr(task, "dx_mean"):
            out[name].update(dx_mean=task.dx_mean.cpu().numpy().copy(), dx_var=task.dx_var.cpu().numpy().copy())
    return out


def validate(spec) -> dict:
    """``Trainer.validate`` with the spec's parameters, its draws (a dict
    keyed by the noise key, or None for ``KeyedNoise``) and, on rank
    ``spec["fail_rank"]``, the ground truth of every val case missing."""
    rank, _ = process_rank_and_world()
    config = parse_cli_overrides(spec["overrides"]).resolved()
    dm, task = instantiate_data_and_task(config, "cpu")
    draws = spec.get("draws")
    noise_factory = None if draws is None else (lambda kind, *key: Draws(draws[(kind, *key)]))
    trainer = Trainer(config, task, dm, noise_factory=noise_factory)
    if spec.get("start") is not None:
        task.net.load_state_dict({k: torch.from_numpy(v) for k, v in spec["start"].items()})
        task.init_state()
    else:
        task.init_weights(torch.Generator().manual_seed(config.trainer.seed))
    if spec.get("fail_rank") == rank:
        task.metrics["val"].data_dir = Path(spec["missing_dir"])
    metrics = trainer.validate(expensive=False)
    trainer.logger.close()
    store = task.sample_stores["val"]
    return dict(metrics=metrics, store_file=store.samples_file.name, store_cases=sorted(store.case_names))


def fit(spec) -> dict:
    """``Trainer.fit`` from the factory: steps taken, batches per epoch, the
    train files of this rank and the learning-rate schedule's first values."""
    config = parse_cli_overrides(spec["overrides"]).resolved()
    dm, task = instantiate_data_and_task(config, "cpu")
    trainer = Trainer(config, task, dm)
    trainer.fit()
    trainer.logger.close()
    return dict(step=task.step, n_train_batches=dm.n_train_batches(),
                train_files=[f.parent.name for f in dm.train_dataset.repo.files],
                learning_rates=[task.tx.learning_rate(i) for i in range(4)])


JOBS = {"diffusion_steps": diffusion_steps, "family_steps": family_steps, "validate": validate, "fit": fit}


def run_ranks(job: str, spec: dict, tmp_path: Path, world: int = 2, timeout_s: float = 150.0, env=None):
    """Run ``job`` on ``world`` ranks (``env``: more environment variables):
    a list of (exit code, its output dict or None, its stderr) per rank."""
    tmp_path = Path(tmp_path)
    spec_file = tmp_path / f"{job}.spec.pt"
    torch.save(spec, spec_file)
    rendezvous = tmp_path / f"{job}.rendezvous"
    env = {**{k: v for k, v in os.environ.items() if not k.startswith("GT_DIST")}, **(env or {})}
    env.update(OMP_NUM_THREADS="2", GT_DIST_NUM_PROCESSES=str(world), GT_DIST_COORDINATOR=f"file://{rendezvous}")
    procs = []
    for rank in range(world):
        log = open(tmp_path / f"{job}.rank{rank}.log", "w+")
        procs.append((subprocess.Popen([sys.executable, str(WORKER), job, str(spec_file), str(tmp_path / job)],
                                       env={**env, "GT_DIST_PROCESS_ID": str(rank)}, cwd=REPO,
                                       stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + timeout_s
    results = []
    try:
        for rank, (proc, log) in enumerate(procs):
            try:
                code = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                code = None
            log.seek(0)
            out_file = tmp_path / f"{job}.rank{rank}.pt"
            out = torch.load(out_file, weights_only=False) if out_file.is_file() else None
            results.append((code, out, log.read()))
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    hung = [rank for rank, (code, _, _) in enumerate(results) if code is None]
    assert not hung, f"{job}: ranks {hung} still running after {timeout_s} s:\n" + "\n".join(r[2] for r in results)
    return results


def main(job: str, spec_file: str, out_prefix: str) -> int:
    from generative_turbulence_tpu_torch.parallel.distributed import initialize_distributed

    torch.set_num_threads(2)
    spec = torch.load(spec_file, weights_only=False)  # written by the test that started this rank
    if spec.get("device", "cpu") == "cuda":  # the card-only tests compare with f32 references
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed(spec.get("device", "cpu"), timeout_s=COLLECTIVE_TIMEOUT_S)
    rank, _ = process_rank_and_world()
    try:
        out, code = JOBS[job](spec), 0
    except Exception as e:  # reported to the test through the output file
        traceback.print_exc()
        out, code = {"error": f"{type(e).__name__}: {e}"}, 1
    torch.save(out, f"{out_prefix}.rank{rank}.pt")
    return code


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
