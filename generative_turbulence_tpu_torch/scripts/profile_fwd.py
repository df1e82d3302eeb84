"""Attribute device time of the flagship U-Net forward / DDIM step.

    python -m generative_turbulence_tpu_torch.scripts.profile_fwd [--mode fwd|ddim] [--iters 10] [--probe 8]

Port of ``scripts/profile-fwd.py``: the bench workload (the synthetic
shapes case, 192x48x48 cells padded to 194x50x50, seed 0; dim 32, 4 levels,
T = 500, batch 8, bf16) profiled with ``torch.profiler`` over the CUDA
kernels, and per-category device time (the port's kernel groups,
``PROFILE_GROUPS``) plus the top kernels by time.  ``--mode ddim`` profiles
``GaussianDiffusion.ddim_sample_loop`` (log-snr-linear, ``noise_bcs``,
eta 0) over ``--probe`` steps per call.  Prints the table on stderr and the
result as JSON (written to ``--out`` too where given).  Runs on the GPU
unless ``--device`` says otherwise; on the CPU only the wall time is
measured.

The JAX script's ``--hlo`` (a dump of the compiled program) has no
counterpart: eager PyTorch compiles no program.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Tuple

import torch

from ..data.grid import GridMap
from ..data.schema import read_metadata
from ..data.synthetic import generate_case
from ..data.variables import Variable
from ..diffusion.gaussian import GaussianDiffusion, GeneratorNoise
from ..models.conditioning import Conditioning
from ..models.unet import DenoisingModel
from ..train import resolve_device

SHAPES_CELLS = (192, 48, 48)
TIMESTEPS = 500
# Kernel groups of a profile, by the first name fragment that matches; any
# other kernel is OTHER.
PROFILE_GROUPS = [
    ("chain convs", ("conv3x3x3_kernel",)),
    ("affine_silu", ("affine_silu_kernel",)),
    ("flash_attention", ("flash_attn_",)),
    ("upsample_trilinear3d", ("upsample",)),
    ("replicate pad", ("replication_pad",)),
    ("cuDNN/CUTLASS convs and GEMMs", ("conv", "gemm", "cutlass", "xmma", "cudnn", "nvjet", "sm90_")),
]
OTHER = "other elementwise, copies, norms"
TOP_EVENTS = 20


def categorize(name: str) -> str:
    """The group of ``PROFILE_GROUPS`` a kernel's name falls in, else ``OTHER``."""
    return next((group for group, keys in PROFILE_GROUPS if any(k in name for k in keys)), OTHER)


def device_summary(events, wall: float, n: int) -> dict:
    """Per call: device busy time (the union of the kernels' intervals), its
    idle share of ``wall`` (ms per call), and kernel time by group."""
    busy, end = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: e.time_range.start):
        start = max(e.time_range.start, end)
        if e.time_range.end > start:
            busy += e.time_range.end - start
        end = max(end, e.time_range.end)
    groups = {name: 0.0 for name, _ in PROFILE_GROUPS}
    groups[OTHER] = 0.0
    for e in events:
        groups[categorize(e.name)] += (e.time_range.end - e.time_range.start) / 1e3 / n
    return {"busy_ms": busy / 1e3 / n, "idle_share": 1 - busy / 1e3 / n / wall, "kernel_ms": groups}


@dataclasses.dataclass
class Workload:
    """The seeded model, the case's grid and the inputs of one profile."""

    model: DenoisingModel
    grid: GridMap
    x: torch.Tensor  # (B, X, Y, Z, 4) f32 standard normals
    t: torch.Tensor  # (B,) zeros

    def forward(self) -> torch.Tensor:
        return self.model(self.x, self.t, self.grid.cell_types)

    def runner(self, mode: str, probe: int) -> Tuple[Callable[[], float], int]:
        """(fn, U-Net evaluations per call): one forward, or a DDIM loop of
        ``probe`` steps from the same draws each call; fn waits for the
        device and returns the sum of the first output channel."""
        if mode == "fwd":
            return lambda: float(self.forward()[..., :1].sum()), 1
        diffusion = GaussianDiffusion.create(beta_schedule="log-snr-linear", timesteps=TIMESTEPS, noise_bcs=True)
        eps_fn = lambda x, t: self.model(x, t, self.grid.cell_types)  # noqa: E731

        def run() -> float:
            noise = GeneratorNoise(torch.Generator(device=self.x.device).manual_seed(1), self.x.device)
            out = diffusion.ddim_sample_loop(eps_fn, self.x, self.grid, noise, num_steps=probe, eta=0.0)
            return float(out[..., :1].sum())

        return run, probe


def build_workload(cell_counts, dim: int, levels: int, batch: int, dtype, device, seed: int = 0) -> Workload:
    """The synthetic case of ``cell_counts`` (``generate_case`` with ``seed``,
    written to a temporary directory and read back), ``DenoisingModel(4,
    T=500, dim, levels, Conditioning(cell_type_embedding_dim=4))`` in
    ``dtype`` with weights from ``torch.Generator().manual_seed(seed)``, and
    x ~ N(0, 1) of the padded grid (a generator seeded ``seed + 1``), t = 0."""
    with tempfile.TemporaryDirectory() as tmp:
        meta = read_metadata(generate_case(Path(tmp) / "bench-case", cell_counts=tuple(cell_counts), n_frames=1,
                                           seed=seed, format="npyd"))
        grid = GridMap.from_metadata(meta, (Variable.U, Variable.P), device=device)
    model = DenoisingModel(out_features=4, timesteps=TIMESTEPS, dim=dim, u_net_levels=levels,
                           conditioning=Conditioning(cell_type_embedding_dim=4), dtype=dtype)
    model = model.init_weights(torch.Generator().manual_seed(seed)).to(device).eval()
    x = torch.randn(batch, *grid.shape, 4, generator=torch.Generator().manual_seed(seed + 1)).to(device)
    return Workload(model, grid, x, torch.zeros(batch, dtype=torch.long, device=device))


def kernel_table(events, n_unet: int) -> dict:
    """``total_ms`` (the kernels' summed durations), the ``categories``
    (``category``, ``pct``, ``ms_per_eval``) and the ``top_events`` by
    summed time of a profile's device events."""
    sums = defaultdict(float)
    for e in events:
        sums[e.name] += (e.time_range.end - e.time_range.start) / 1e3
    total = sum(sums.values())
    cats = defaultdict(float)
    for name, ms in sums.items():
        cats[categorize(name)] += ms
    row = lambda ms: {"pct": 100 * ms / max(total, 1e-9), "ms_per_eval": ms / n_unet}  # noqa: E731
    return {
        "total_ms": total,
        "categories": [{"category": c, **row(ms)} for c, ms in sorted(cats.items(), key=lambda kv: -kv[1])],
        "top_events": [{"name": n[:200], **row(ms)}
                       for n, ms in sorted(sums.items(), key=lambda kv: -kv[1])[:TOP_EVENTS]],
    }


def profile(fn: Callable[[], float], iters: int, n_unet: int, device: torch.device) -> dict:
    """``iters`` calls of fn (warm already) under torch.profiler: the wall
    time, ms per U-Net evaluation on the host clock, and on a CUDA device
    one entry named by the device with ``kernel_table``'s keys, the device
    name, its busy time and idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with torch.inference_mode(), torch.profiler.profile(activities=activities) as prof:
        tic = time.perf_counter()
        for _ in range(iters):
            fn()
        wall = time.perf_counter() - tic
    total_unet = iters * n_unet
    result = {"wall_s": wall, "ms_per_unet_incl_host": wall / total_unet * 1e3}
    if device.type != "cuda":
        return result
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        result[str(device)] = "not measured (the profiler recorded no device activity)"
        return result
    summary = device_summary(events, wall * 1e3 / iters, iters)
    result[str(device)] = {"name": torch.cuda.get_device_name(device), **kernel_table(events, total_unet),
                           "busy_ms_per_eval": summary["busy_ms"] / n_unet, "idle_share": summary["idle_share"]}
    return result


def print_table(result: dict, device: torch.device) -> None:
    entry = result.get(str(device))
    print(f"wall {result['wall_s']:.3f}s for {result['iters']} iters "
          f"({result['ms_per_unet_incl_host']:.1f} ms/UNet-eval incl host)", file=sys.stderr)
    if not isinstance(entry, dict):
        print(f"{device}: {entry or 'device time not measured (no CUDA device)'}", file=sys.stderr)
        return
    n_unet = result["iters"] * (result["probe"] if result["mode"] == "ddim" else 1)
    print(f"\n== {device} ({entry['name']}): {entry['total_ms']:.1f} ms total, "
          f"{entry['total_ms'] / n_unet:.2f} ms/UNet-eval", file=sys.stderr)
    for c in entry["categories"]:
        print(f"  {c['pct']:5.1f}%  {c['ms_per_eval']:7.2f} ms/eval  {c['category']}", file=sys.stderr)
    print("  top events:", file=sys.stderr)
    for e in entry["top_events"]:
        print(f"    {e['pct']:5.1f}%  {e['ms_per_eval']:7.2f} ms/eval  {e['name'][:100]}", file=sys.stderr)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", default="fwd", choices=["fwd", "ddim"])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--out", default=None, help="write the category table JSON here")
    ap.add_argument("--probe", type=int, default=8, help="ddim: steps per sampler call")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_intermixed_args(argv)
    device = resolve_device(args.device)

    print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else device}", file=sys.stderr)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    workload = build_workload(SHAPES_CELLS, dim=32, levels=4, batch=args.batch, dtype=dtype, device=device)
    fn, n_unet = workload.runner(args.mode, args.probe)
    with torch.inference_mode():
        fn()  # warm-up: cuDNN plans, the allocator
    result = {"mode": args.mode, "dtype": args.dtype, "batch": args.batch, "iters": args.iters, "probe": args.probe,
              **profile(fn, args.iters, n_unet, device)}
    print_table(result, device)
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=2) + "\n")
        print(f"\nwrote {args.out}", file=sys.stderr)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
