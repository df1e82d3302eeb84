#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA Hopper GPU (H100).

Run from the repository root:  python3 chip_smoke.py

1. Device: prints the card (nvidia-smi name and power limit) and the
   torch/CUDA versions; fails without CUDA.  TF32 is switched off for
   cuDNN convolutions and matmuls so f32 references are full f32.
2. Build: compiles the Hopper kernels from ``generative_turbulence_tpu_torch/
   csrc`` with nvcc (one process per source, in parallel, into
   build/kernels/) and prints the seconds it took.
3. Kernel vs plain: the fused ResnetBlock chain against its plain torch
   version at the four block shapes the shapes-grid U-Net sends through it
   (batch 8, FiLM on, 8 groups) and one small ragged shape (1 group, no
   FiLM); each of its three kernels against its own plain version at the
   four block shapes, timed beside it and, for the convs, beside cuDNN's
   bf16 pad + conv + bias, and where both convs have one shape, the silu
   conv against the plain one timed in turns; the kernels again at a shape
   whose bricks overhang every axis (silu prologue on); one backward.  And
   what the conv's clamped addressing saves: a standalone replicate pad at
   the down_0 input (its bytes' bound, ``F.pad(mode="replicate")`` timed),
   the ``pad_flatten`` entry of ``conv3x3x3_stats``.
3b. flash_attention against its plain version at the 2-level bottleneck's
   shape (8, 4, 6912, 32), as the U-Net's strided qkv views, in bf16 and
   f32, and at a ragged (2, 2, 2100, 16), bf16 held to the output's scale
   (atol relative to max |out|, relative L2 error <= 1e-2, since outputs
   over thousands of keys are far below the plain atol; the path output
   times 0.9 and 1.1 must be refused); second runs bit-equal; the bf16
   bound beside its tensor-FLOP floor; times, beside torch's ``scaled_dot_product_attention`` on the same views under
   each backend that runs (the yardstick; the port never calls it).  Then
   the edge cases of the card-only tests: flash_attention over N in {1, 63,
   64, 127, 128, 129, 2100} x D in {8, 16, 32, 64, 128} x bf16/f32 x
   contiguous/strided, and at 66,000 heads; affine_silu at F = 20, 32, 64,
   128 with bf16 and f32 output on odd and ragged voxel counts.
3c. conv3d_3x3 against its plain version at the u_net.down_0 shape
   (8x194x50x50, 64->64), bf16 and f32 inputs; one backward; times beside
   the plain version and cuDNN's bf16 pad + conv + bias.
4. Main path, 4 levels: a synthetic shapes case (192x48x48 cells, padded
   194x50x50) built in memory, a seeded dim-32 4-level DenoisingModel in
   bf16, DDIM with 10 steps and a 4-step ancestral run at batch 8 through
   ``training.diffusion_task.sample``.  Checks shapes, finiteness, agreement
   of one U-Net evaluation with the plain path, that every chain counter
   rose by exactly (U-Net evaluations x engaged blocks), and that
   flash_attention did not launch (108 bottleneck tokens).
4b. Main path, 2 levels: the run configuration ``model.u_net_levels=2``
   (bf16, DDIM-10) from ``parse_cli_overrides`` and the presets, a seeded
   ``DiffusionTask`` on the same case; one DDIM-10 and one 4-step ancestral
   call through ``DiffusionTask.sample``.  Checks shapes, finiteness, one
   flash_attention launch per U-Net evaluation (6912 bottleneck tokens),
   the chain counters, and one U-Net evaluation in bf16 and one with
   ``eval_compute_dtype=float32`` against the same net with plain attention.
   Each path then profiles three U-Net forwards (4 levels bf16; 2 levels
   bf16 and f32) with torch.profiler: wall and device-busy time, idle
   share, kernel time by group, launches and peak memory per forward, one
   JSON line each (after the launch counts are read).
6. Train steps: the paper's run (``model.compute_dtype=bfloat16
   model.ema_decay=0.999`` over the defaults: dim 32, 4 levels, T=500,
   batch 6, remat, RAdam with exp decay, clip 0.1) from
   ``parse_cli_overrides`` through ``DiffusionTask.training_step`` on 6
   frames of the shapes case, draws from a ``torch.Generator``: 2 warm-up
   and 5 timed steps (CUDA events), losses, peak memory, launches per step
   (checked), one profiled step (device time by kernel group and by phase:
   forward, remat recompute, the chain's and the attention's plain
   backward, other backward, optimizer + EMA).  Checks: finite losses, a
   gradient for every parameter, every parameter and EMA leaf changed, and
   one step's gradients against the plain path (the chain's gate closed)
   from the same parameters and draws: cosine >= 0.999 and each leaf's
   relative L2 error <= 3e-2 (or 3x two plain runs' difference), the
   gradients x 1.1 refused.  Then the same at 2 levels (4 timed steps),
   where flash_attention launches, its gradients held against the plain
   attention's.
6b. Eval path: a synthetic dataset on disk in the ``.npyd`` format (1 train
   and 1 val case of the shapes grid, 16 frames, seed 0; ``compute_stats``),
   the val case's regions rewritten as 512-cell runs; ``DataModule`` ->
   the val batch of 8 frames ``to("cuda")`` -> ``DiffusionTask.eval_step``
   (4 levels bf16 DDIM-50, then 2 levels DDIM-10) -> the sample store ->
   ``on_eval_end`` (after a cold first ``eval_step`` of one DDIM step and
   ``on_eval_start``; ``val/tke`` and its regions, ``val/max-mean-tke-pos``,
   ``val/wasserstein`` by Sinkhorn on the card over 32 regions).  Checks:
   the chain counters rose by (U-Net evaluations x engaged blocks) in
   ``eval_step`` and flash_attention once per evaluation at 2 levels; the
   store holds the 8 samples; the values are finite and >= 0; the log-TKE
   distance matrix on the card within rtol 1e-3 of the CPU's; and once:
   real frames closer to the data than noise in ``val/tke``, and the
   Sinkhorn Wasserstein within 15% of the exact host EMD over 4 regions.
   Prints one ``eval_path`` JSON line (seconds of each part, values, peak
   memory, launches).
6c. Training entry point: a ``.npyd`` dataset of the shapes grid (1 train
   and 1 val case, 36 frames), then ``instantiate_data_and_task`` and
   ``Trainer.fit`` on the card from overrides that mirror
   ``config/shapes_*.yaml``: the paper's diffusion run for 2 epochs with a
   DDIM-10 validation after each, then a second run resumed from its
   checkpoint for a third; TF-Net (micro-batch 2 x accumulation 3) and
   DilResNet (batch 3, N 4, hidden 48) for 6 micro-steps and a validation
   each (TF-Net's 27-step rollout; DilResNet's cut to 4 steps).  Checks:
   finite losses, the run files and the monitor, the chain counters at 7
   per train step and 4 x 26 U-Net evaluations per validation, resume at
   the saved step and epoch, every parameter changed (TF-Net's BatchNorm
   statistics among them), DilResNet's tracked batches, no launch on the
   baselines' paths, and each baseline's f32 forward on the card against
   the CPU.  Prints one ``trainer`` JSON line (ms per step, validation and
   checkpoint seconds, peak memory, launches).
6d. Checkpoint evaluation, in 6c's directory on its checkpoints: the
   port's entry points (``generative_turbulence_tpu_torch/scripts``) through
   their ``main`` on the card.  ``eval_ckpt`` on the paper run's best
   checkpoint at DDIM-50 into a ``.npyd`` store (checked: 4 engaged blocks x
   50 launches per chain kernel per val batch, no flash_attention or
   conv3d_3x3, finite metrics); ``sample_metrics`` on that store (equal to
   eval_ckpt's); the import round trip: the EMA weights under turbdiff's
   keys in a Lightning-style ``turbdiff.ckpt`` (hyper-parameters from the
   config, ``model.betas``, the variables as an enum pickled as
   ``turbdiff.data.ofles.Variable``), ``import_checkpoint --trust-pickle``
   (checked: every tensor bit-equal, max |dbetas| = 0, DDIM-10 samples of
   the imported and the source checkpoint bit-equal with the same draws);
   ``evaluate_runtime`` (DDIM-50, 3 repeats: ``sample_time`` and samples
   per minute); ``evaluate_with_precision`` (DDIM-10; finite, the TF32
   switches as they were set before it: matmul on, cuDNN off); ``sampler_sweep`` over DDIM-10 bf16 and f32 with
   any import of h5py made to fail (finite records); ``evaluate_from_initial``
   on 6c's DilResNet run (4 steps, no launch); ``evaluate_dataset`` (the
   floor's ``floor/tke``).  Prints one ``checkpoint_eval`` JSON line first
   among the result lines (seconds, peak memory and launches of each step,
   the values).
6e. Data parallel, on 6c's dataset with its val case copied to a second:
   the paper's run (``trainer.max_steps=4``, one DDIM-10 validation,
   ``data.shard_eval=true``) through the training entry point's ``main`` in
   processes of their own (``chip_smoke.py --rank-worker``): twice in one
   process and once as one NCCL rank under ``torch.distributed.run`` side by
   side on the card, then two ranks sharing the card over gloo under
   ``torch.distributed.run``.  The card's compute mode is checked first
   (exclusive-process fails the phase).  Checks: the backends, worlds and
   devices; 7 launches per chain kernel per step on every rank; the gloo
   ranks' first-step all-reduced gradients against the single run's
   (cosine >= 0.999, worst leaf's rel L2 <= 3e-2 or 3x the two single runs'
   difference; x 1.1 refused), their losses (the bf16 tolerance), the merged
   ``val/tke`` (rel 1e-4), each rank's store holding its own case, rank 1
   writing no run files, the 2-rank checkpoint restored in one process; the
   NCCL rank's parameters within 3x the single runs' spread, its first loss
   equal to theirs where theirs agree, the rest at the bf16 tolerance.
   Prints one ``distributed`` JSON line first among the result lines (per
   rank: backend, device, step ms, all-reduce ms of the gradients' bytes,
   peak memory; ``shared_card``: two ranks on one card are no scaling
   figure).
6f. Study scripts, on what 6c-6e leave behind, through the entry points'
   ``main`` (each timed, its peak memory and launches kept):
   ``profile_fwd`` at the bench workload (its own shapes case, dim 32, 4
   levels, batch 8, bf16) in ``--mode fwd --iters 3`` and ``--mode ddim
   --probe 2 --iters 1`` (checked: 4 launches of each chain kernel per U-Net
   evaluation, the warm-up call's included; the categories add up to the
   kernels' total within 1%; chain conv time above 0; its ms per evaluation
   printed beside phase 4's); ``trivial_baselines`` on 6e's two val cases
   (8 frames each), the card against ``--device cpu`` (rtol 1e-4) and its
   smoothing of one frame against scipy's ``gaussian_filter`` (rtol 1e-4);
   ``degenerate_baselines`` at 4 samples, the card against the CPU (rtol
   1e-3; the mean baseline's ``max-mean-tke-pos``, whose TKE profile is 0
   in exact arithmetic, undefined (NaN) on both);
   ``calibrate_sinkhorn`` over 4 regions of 4 samples at reg 0.02 x 300 and
   0.005 x 1200 (each within 15% of the exact EMD); ``tke_profile`` on 6d's
   ``eval_ckpt`` store, the card against the CPU (rtol 1e-4, equal
   argmaxes); ``summarize_run`` of 6c's three runs, ``diagnose_trajectory``
   of its diffusion run, ``compare_runs`` over the three (3 model rows,
   the degenerate baselines' line); ``sweep --slurm`` (its command lines
   name the port's module); one real ``sweep`` combination in a process of
   its own: the paper's run for 2 steps and a DDIM-2 validation, which
   leaves its ``metrics.jsonl``.  Prints one ``study_scripts`` JSON line
   after 6g's.
6g. OpenFOAM data toolchain, at the full shapes grid: ``generate_shapes
   <tmp>/shapes --mock-direct --overfit 1 --frames 8`` through its ``main``
   (the first train shape, 192x48x48 cells at scale 1, every analysis, in
   ``.npyd``; each of its steps timed: case generation, polyMesh, mock
   solve and conversion, grid embedding, mean flow, homogeneous regions,
   max-mean-TKE, statistics; checked: ``data.npyd``, ``mean-flow.npyd``,
   ``regions.npz``, ``max-mean-tke.npy`` and ``stats.pickle``, no ``.h5``,
   ``train/`` and ``val/`` linking the same case, the 194x50x50 padded
   grid); ``validate_dataset --deep`` (``{"n_cases": 1, "failed": {}}``);
   ``case_analysis --first-turbulent-frame`` on the card and with ``--device
   cpu`` (the index equal; both log-TKE distance matrices at rtol 2e-4 /
   atol 2e-5); the paper's run through the training entry point's ``main``
   on the generated dataset for 2 steps and one validation (DDIM-10,
   ``data.discard_first_seconds=-1`` keeping the mock frames, no plots;
   checked: finite losses, finite validation metrics, among them
   ``val/tke`` from ``mean-flow.npyd`` and ``val/max-mean-tke-pos`` from
   ``max-mean-tke.npy``, each chain kernel 7 times per step and 4 x 26
   times in the validation, as in 6c); then ``val/wasserstein`` by Sinkhorn
   on the card over 8 seeded regions of the generated ``regions.npz`` on the
   validation's stored samples (finite).  Prints one ``toolchain`` JSON line
   first among the result lines.
6h. The spatial axis (``trainer.mesh_shape=[dp,sp]``), after 6e on its
   dataset.  The chain conv's halo variant (``conv3x3x3_stats_halo`` and
   ``conv3x3x3_stats_silu_in_halo``) at u_net.down_0's slab at sp = 2 (6 x
   97 x 50 x 50, 64 -> 64, bf16; one slab with the neighbour's plane after
   it, the other before it) against its plain twin (rtol 0.06, atol 0.03,
   corr > 0.999; moments within 1e-3; a second run bit-equal), the two
   slabs' outputs against the whole grid's conv without a halo (bit-equal),
   timed beside the conv without a halo on the same slab (in turns), the
   plain twin, cuDNN's bf16 pad + conv + bias and the bound (the FLOPs plus
   the halo plane's bytes).  Then the paper's run through the training
   entry point on 2 gloo ranks sharing the card at ``trainer.mesh_shape=
   [1,2]`` (``torch.distributed.run``, the rank worker of 6e): the backend,
   the mesh, 7 launches per rank per step of each halo conv and of
   ``affine_silu`` and none of the convs without a halo, the losses and the
   first step's gradients and ``val/tke`` held against 6e's single run by
   6e's bound (the x 1.1 gradients refused), every step's gradients each
   within that bound (or 3x two single runs' difference at that step), the
   parameters within the first step's bound (3x the single runs' spread,
   6e's rule for its NCCL rank, reported beside), their change over the 4
   steps reported beside the single runs' with its worst leaf's steps (each
   step's difference, how far the steps cancel in their sum, the change in
   units of the weights' f32 spacing); the same pair of runs in f32 (one process
   and mesh (1, 2) side by side): losses within rel 2e-4 and every leaf's
   change over the 4 steps within 3e-2 of the one process's; peak memory
   per rank below the single run's, a DDIM-10 sample of
   seeded weights and draws on the val batch against the single run's (the
   bf16 tolerance at the output's scale, as for ``flash_attention``), and one halo exchange at down_0's slab timed (host clock,
   synced, forward and backward) with the exchanges per step counted.  Then
   ``graft_entry.dryrun_multichip(2)`` on the card in a process of its own
   (mesh (1x2)).  Prints one ``spatial`` JSON line first among the result
   lines.
6i. The paper's run recipes (``scripts/run_shapes.py``), after 6b on its
   dataset, through ``run_shapes.main`` in this process with 6c's cuts:
   ``diffusion-r5`` (bf16 + remat, micro-batches of 3 at accumulation 2,
   training frames rounded to bf16 by ``data.device_cache_gb=2``, EMA
   0.999) for ``trainer.max_steps=4`` micro-steps (2 updates) and the one
   validation the stop brings (f32 DDIM-50 with x0 clipped to the training
   envelope, 2 val batches).  Checks: the first training batch on the card
   is bf16 and the bf16 rounding of the host's f32 frames of the sampler's
   first batch in sorted order, bit for bit; each micro-step draws its noise
   as 128 levels (JAX's bf16 law), whose values on the card are the CPU
   table's, each about as frequent; 7 launches per chain kernel per
   micro-step and 4 x (16 + 50 x 2) per validation; the task's clip bounds
   are ``stats.envelope``'s in normalised units; finite losses, samples and
   ``val/tke``.  Then ``tfnet`` and ``dilresnet`` for 2 micro-steps each
   (validation rollouts cut to 4 steps: the case has 16 frames): bf16
   training windows, no kernel launched.  After them, in this process, the
   host tools one by one, timed: ``generate_2d3d regression --inflows 20
   --mock-solve --frames 4`` (192x48x48 and 192x48x1, ``.npyd``),
   ``split_2d3d`` (each split the case's frames in order),
   ``validate_dataset --deep`` (only the analyses missing, which a 2D/3D
   study has none of), ``generate_performance_dataset`` (widths 1-16) and
   ``solve_slurm --dry-run`` (``--array=1-5``, ``--cpus-per-task=16``), with
   no ``h5py``.  Prints one ``recipes`` JSON line first among the result
   lines (ms per micro-step and per update,
   peak memory, the validation's seconds, the host tools' seconds).
7. Prints the kernels' JSON line and, last, ``{"ok": true, "device": ...}``.
   Every kernel's entry has its time, its bound (``bound_ms``: the larger of
   its bytes over the memory rate and its operations over the peak rate of
   their kind, from this run's shapes; ``bound_by``, ``bound_kind``), the
   plain version's time, the library call's (``library_ms``, or null where
   no one torch call computes the same function) and its launches on each
   main path (``launches_by_path``: per sampler run, per train step on
   the train paths, per ``eval_step`` on the eval paths, per Trainer step
   and validation on the Trainer's, and per val batch of ``eval_ckpt`` and
   per entry point of phase 6d, per rank per step of phase 6e, per
   mode and per U-Net evaluation of phase 6f's ``profile_fwd``, per
   step and per validation of phase 6g's Trainer, per rank per step of
   phase 6h's mesh (1, 2), where the halo variants launch, and per
   micro-step and per validation of phase 6i's r5 recipe).

Any failure exits non-zero before the last line.

``python3 chip_smoke.py --multi-card``, on a machine with several cards,
runs phase 6e's comparison at world = the card count over NCCL (batch 2 x
cards, one card per rank) against one process and, with four cards, the
meshes (2, 2) and (1, 4) (the halo variants' launches checked), and prints
one ``multi_card`` JSON line.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
PALLAS = "generative_turbulence_tpu/ops/pallas_kernels.py"
BF16_RTOL, BF16_ATOL, MIN_CORR = 0.06, 0.03, 0.999
MAX_REL_L2 = 1e-2  # bf16 flash_attention: a 1.1x output is off by 0.1
F32_RTOL, F32_ATOL = 2e-4, 2e-5
CHAIN_KERNELS = ("conv3x3x3_stats", "conv3x3x3_stats_silu_in", "affine_silu")
# The chain's kernels on the spatial axis: the convs' halo variant.
HALO_KERNELS = ("conv3x3x3_stats_halo", "conv3x3x3_stats_silu_in_halo")
SP_CHAIN_KERNELS = (*HALO_KERNELS, "affine_silu")
NO_HALO = {name: 0 for name in HALO_KERNELS}
# (name, X, Y, Z, C_in, F) of the blocks the gate engages at the shapes grid.
# The 2-level net engages the same four (tests/test_torch_task.py): up_1 sees
# 256 input channels and the centre blocks 48x12x12 voxels, outside the gate.
ENGAGED_BLOCKS = [
    ("u_net.down_0", 194, 50, 50, 64, 64),
    ("u_net.down_1", 97, 25, 25, 64, 128),
    ("u_net.up_0", 194, 50, 50, 128, 32),
    ("decode_resnet", 194, 50, 50, 32, 32),
]
BATCH = 8
DDIM_STEPS = 10
DDPM_STEPS = 4
# The bottleneck attention of the 2-level net at the shapes grid.
FLASH_PATH_SHAPE = (BATCH, 4, 48 * 12 * 12, 32)
# Peak rates of one H100 SXM at its 700 W limit: the dense bf16 tensor-core
# and f32 FMA rates and the memory rate from NVIDIA's data sheet, and the
# MUFU's ex2 rate as the FlashAttention-3 paper gives it.
PEAK = {"bf16 tensor FLOP": 989e12, "f32 FMA FLOP": 67e12, "MUFU ex2": 3.9e12, "bytes": 3.35e12}
TWO_LEVEL_OVERRIDES = [
    "model.u_net_levels=2", "model.compute_dtype=bfloat16", "model.sampler=ddim",
    f"model.ddim_steps={DDIM_STEPS}",
]


class SmokeFailure(RuntimeError):
    pass


def bound(bytes_moved: float, **ops: float) -> dict:
    """The least time the card could take for a kernel's work: the larger of
    ``bytes_moved`` (each input read once, each output written once) over
    the memory rate and each operation count in ``ops`` (keyed by a name of
    ``PEAK``) over its peak rate.  Returns ``bound_ms``, ``bound_by``
    ("bytes" or "operations") and ``bound_kind`` (which rate binds)."""
    times = {"bytes": bytes_moved / PEAK["bytes"]}
    times.update({kind: n / PEAK[kind] for kind, n in ops.items()})
    kind = max(times, key=times.get)
    return {"bound_ms": times[kind] * 1e3, "bound_by": "bytes" if kind == "bytes" else "operations",
            "bound_kind": kind}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return proc.stdout.strip() or f"unavailable ({proc.stderr.strip()})"


def ptxas_summary(text: str) -> list:
    """One line per kernel of nvcc's ``-Xptxas -v`` output: its (mangled,
    shortened) name, registers and spills."""
    lines, name, spill = [], "?", ""
    for line in text.splitlines():
        found = re.search(r"Compiling entry function '_Z\w*?(\d+)(conv3x3x3_kernel|flash_attn_\w+?_kernel|"
                          r"affine_silu_kernel)(I[^']*)'", line)
        if found:
            name = found.group(2) + found.group(3)[:40]
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            lines.append(f"{name}: {line.split(':', 1)[-1].strip()}; {spill}")
    return lines


def cuda_ms(torch, fn, reps: int) -> float:
    """Median device time of fn() in ms over ``reps`` runs (after a warm-up)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_forwards(torch, label: str, fn, n: int = 3) -> dict:
    """torch.profiler over ``n`` calls of fn (one U-Net forward each, after a
    warm-up): wall time per forward (host clock, synchronised), device busy
    time (the union of the kernels' intervals) and idle share, kernel time
    by group, launches and peak memory per forward.  Logged and returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from generative_turbulence_tpu_torch.scripts.profile_fwd import device_summary

    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - tic) * 1e3 / n
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    row = {"profile": label, "wall_ms": wall, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": len(events) / n}
    if not events:
        row["device"] = "not measured (the profiler recorded no device activity)"
        log(f"  profile {label}: {row}")
        return row
    row.update(device_summary(events, wall, n))
    log(f"  profile {label}: {json.dumps(row)}")
    return row


def paired_ratio(torch, fn_a, fn_b, rounds: int) -> float:
    """Median over ``rounds`` of (device time of fn_b) / (that of fn_a), each
    round timing them in turns a, b, b, a, so that drifts of the card's
    clocks fall on both sides (after a warm-up of each)."""
    fn_a()
    fn_b()
    ratios = []
    for _ in range(rounds):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
        for k, fn in enumerate((fn_a, fn_b, fn_b, fn_a)):
            events[2 * k].record()
            fn()
            events[2 * k + 1].record()
        events[-1].synchronize()
        t = [events[2 * k].elapsed_time(events[2 * k + 1]) for k in range(4)]
        ratios.append((t[1] + t[2]) / (t[0] + t[3]))
    return statistics.median(ratios)


def compare(torch, got, want, what: str, quiet: bool = False, scaled: bool = False) -> float:
    """bf16 agreement: allclose(rtol 0.06, atol 0.03) and correlation > 0.999.

    With ``scaled`` the atol is taken relative to max |want| and the
    relative L2 error ||got - want|| / ||want|| must stay within
    ``MAX_REL_L2``: attention over thousands of keys gives outputs far below
    0.03, where neither the plain atol nor the correlation sees a wrong
    scale.  Returns the (unscaled) max abs error."""
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite kernel output")
    err = (got - want).abs()
    max_err = float(err.max())
    atol = BF16_ATOL * float(want.abs().max()) if scaled else BF16_ATOL
    bad = int((err > atol + BF16_RTOL * want.abs()).sum())
    corr = float(torch.corrcoef(torch.stack([got.flatten(), want.flatten()]))[0, 1])
    rel_l2 = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
    if not quiet:
        log(f"  {what}: max_abs_err {max_err!r} outside tol {bad} (atol {atol!r}) corr {corr!r} "
            f"rel_l2 {rel_l2!r}")
    check(bad == 0, f"{what}: {bad} elements outside rtol {BF16_RTOL} / atol {atol}")
    check(corr > MIN_CORR, f"{what}: correlation {corr} <= {MIN_CORR}")
    if scaled:
        check(rel_l2 <= MAX_REL_L2, f"{what}: relative L2 error {rel_l2} > {MAX_REL_L2}")
    return max_err


def compare_f32(torch, got, want, what: str, quiet: bool = False) -> float:
    """f32 agreement: allclose(rtol 2e-4, atol 2e-5)."""
    check(got.dtype == want.dtype == torch.float32, f"{what}: {got.dtype}, {want.dtype}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite kernel output")
    err = (got - want).abs()
    max_err = float(err.max())
    bad = int((err > F32_ATOL + F32_RTOL * want.abs()).sum())
    if not quiet:
        log(f"  {what}: max_abs_err {max_err!r} outside tol {bad}")
    check(bad == 0, f"{what}: {bad} elements outside rtol {F32_RTOL} / atol {F32_ATOL}")
    return max_err


def block_args(torch, gen, B, X, Y, Z, C, F, film: bool):
    dev = "cuda"

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    x = rnd(B, X, Y, Z, C).to(torch.bfloat16)
    w1 = rnd(3, 3, 3, C, F, scale=(27 * C) ** -0.5)
    w2 = rnd(3, 3, 3, F, F, scale=(27 * F) ** -0.5)
    scale = rnd(B, F, scale=0.2).to(torch.bfloat16) if film else None
    shift = rnd(B, F, scale=0.2).to(torch.bfloat16) if film else None
    return [
        x, w1, rnd(F, scale=0.1), 1 + rnd(F, scale=0.1), rnd(F, scale=0.1),
        scale, shift, w2, rnd(F, scale=0.1), 1 + rnd(F, scale=0.1), rnd(F, scale=0.1),
    ]


def single_kernel_rows(torch, ck, gen, block, B, X, Y, Z, C, F, timed=True):
    """The chain's three kernels at one block shape, each against its plain
    version (output, channel moments within 1e-3, second run bit-equal);
    with ``timed``, each launch's time beside its plain version's and, for
    the convs, cuDNN's bf16 pad + conv + bias and TFLOP/s; where C == F, the
    silu_in conv's time over the plain conv's, the two timed in turns."""
    bf = torch.bfloat16
    x = (torch.randn(B, X, Y, Z, C, generator=gen)).to("cuda", bf)
    h_in = (torch.randn(B, X, Y, Z, F, generator=gen)).to("cuda", bf)
    w1 = (torch.randn(3, 3, 3, C, F, generator=gen) * (27 * C) ** -0.5).to("cuda", bf)
    w2 = (torch.randn(3, 3, 3, F, F, generator=gen) * (27 * F) ** -0.5).to("cuda", bf)
    b1, b2 = ((0.1 * torch.randn(F, generator=gen)).cuda() for _ in range(2))
    act = ((1 + 0.2 * torch.randn(B, F, generator=gen)).cuda(),
           (0.2 * torch.randn(B, F, generator=gen)).cuda())
    a2 = (1 + 0.2 * torch.randn(B, F, generator=gen)).cuda()
    c2 = (0.2 * torch.randn(B, F, generator=gen)).cuda()
    n = X * Y * Z
    launches = [
        ("conv3x3x3_stats", x, w1, b1, None),
        ("conv3x3x3_stats_silu_in", h_in, w2, b2, act),
    ]
    rows, runs = [], {}
    for name, xi, w, b, a in launches:
        run = runs[name] = functools.partial(ck._conv3x3x3_stats_kernel, xi, w, b, a)
        run_plain = functools.partial(ck._conv3x3x3_stats_plain, xi, w, b, a)
        (got, part), (want, want_part) = run(), run_plain()
        torch.cuda.synchronize()
        label = f"{name} {block} B={B} {X}x{Y}x{Z} {xi.shape[-1]}->{F}"
        err = compare(torch, got, want, label)
        sums, want_sums = part.sum(1), want_part.sum(1)
        # The moments as GroupNorm reads them: per-channel mean and variance
        # over the X*Y*Z voxels of each batch element.
        mean, want_mean = sums[:, 0] / n, want_sums[:, 0] / n
        var = sums[:, 1] / n - mean**2
        want_var = want_sums[:, 1] / n - want_mean**2
        err_mean = float(((mean - want_mean).abs() / want_var.sqrt()).max())
        err_var = float(((var - want_var).abs() / want_var).max())
        log(f"    channel moments: max |mean err|/std {err_mean!r}, max |var err|/var {err_var!r}")
        check(max(err_mean, err_var) < 1e-3, f"{label}: channel moments off")
        again, again_part = run()
        check(torch.equal(got, again) and torch.equal(part, again_part), f"{label}: a second run differs")
        del got, want, again, part, want_part, again_part
        if not timed:
            continue
        cudnn = lambda: ck._conv3d_replicate(xi, w) + b.to(bf)
        ms, plain, cudnn_ms = cuda_ms(torch, run, 20), cuda_ms(torch, run_plain, 5), cuda_ms(torch, cudnn, 20)
        cin = xi.shape[-1]
        flop = 2 * B * n * 27 * cin * F
        tflops, cudnn_tflops = flop / ms / 1e9, flop / cudnn_ms / 1e9
        # x, w, bias, (a, b,) y and the per-brick moments.
        n_bricks = ck.conv_n_bricks(X, Y, Z, ck.conv_brick(ck.conv_tiling(cin, F)[0]))
        moved = (2 * B * n * (cin + F) + 2 * 27 * cin * F + 4 * F + 8 * B * n_bricks * F
                 + (8 * B * cin if a is not None else 0))
        bnd = bound(moved, **{"bf16 tensor FLOP": flop})
        log(f"    kernel {ms!r} ms ({tflops!r} TFLOP/s; bound {bnd['bound_ms']!r} ms, "
            f"{bnd['bound_kind']}), plain (f32 products) {plain!r} ms, "
            f"cuDNN bf16 pad+conv+bias {cudnn_ms!r} ms ({cudnn_tflops!r} TFLOP/s)")
        rows.append({"name": name, "block": block, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     **bnd, "library_ms": cudnn_ms, "library": "cuDNN bf16 replicate pad + conv3d + bias",
                     "cudnn_bf16_ms": cudnn_ms, "tflops": tflops, "cudnn_tflops": cudnn_tflops})
    if timed and C == F:
        # The prologue's cost: the two convs differ only in it here.
        ratio = paired_ratio(torch, runs["conv3x3x3_stats"], runs["conv3x3x3_stats_silu_in"], 10)
        log(f"    conv3x3x3_stats_silu_in / conv3x3x3_stats, timed in turns: {ratio!r}")
        rows[1]["over_core_in_turns"] = ratio
    h = ck._conv3x3x3_stats_kernel(h_in, w2, b2, act)[0]
    run = lambda: ck.affine_silu(h, a2, c2, bf)
    run_plain = lambda: ck._affine_silu_plain(h, a2, c2, bf)
    got, want = run(), run_plain()
    torch.cuda.synchronize()
    err = compare(torch, got, want, f"affine_silu {block} B={B} {X}x{Y}x{Z}x{F}")
    check(torch.equal(got, run()), f"affine_silu {block}: a second run differs")
    if timed:
        ms, plain = cuda_ms(torch, run, 20), cuda_ms(torch, run_plain, 10)
        moved = 2 * h.numel() * 2 + 2 * a2.numel() * 4  # h in, bf16 out; a, c
        gbs = moved / ms / 1e6
        bnd = bound(moved, **{"MUFU ex2": h.numel()})
        log(f"    affine_silu kernel {ms!r} ms ({gbs!r} GB/s; bound {bnd['bound_ms']!r} ms, "
            f"{bnd['bound_kind']}), plain {plain!r} ms")
        rows.append({"name": "affine_silu", "block": block, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain, **bnd, "library_ms": None, "gb_per_s": gbs})
    return rows


def pad_flatten_row(torch, gen) -> dict:
    """``_pad_flatten`` (the replicate pad by 1 of a conv's input) has no
    launch in the port: the conv kernel's clamped halo addressing is the
    pad.  What a standalone pad would cost at the ``u_net.down_0`` input
    (batch 8, bf16): its bytes over the memory rate (the input read once,
    the padded tensor written once) and torch's replicate pad."""
    import torch.nn.functional as F

    _, X, Y, Z, C, _ = ENGAGED_BLOCKS[0]
    x = torch.randn(BATCH, C, X, Y, Z, generator=gen).to("cuda", torch.bfloat16)
    padded = BATCH * C * (X + 2) * (Y + 2) * (Z + 2)
    got = F.pad(x, (1,) * 6, mode="replicate")
    check(tuple(got.shape) == (BATCH, C, X + 2, Y + 2, Z + 2) and torch.equal(got[:, :, 1:-1, 1:-1, 1:-1], x),
          "replicate pad")
    row = {"shape": [BATCH, X, Y, Z, C], "dtype": "bfloat16", **bound(2 * (x.numel() + padded)),
           "library": "torch.nn.functional.pad(mode='replicate')",
           "library_ms": cuda_ms(torch, lambda: F.pad(x, (1,) * 6, mode="replicate"), 10)}
    log(f"[3] _pad_flatten at the down_0 input {row['shape']} bf16 (no launch of its own in the port): "
        f"a standalone pad's bound {row['bound_ms']!r} ms, F.pad(mode='replicate') {row['library_ms']!r} ms")
    return row


def kernel_phase(torch, ck):
    gen = torch.Generator().manual_seed(0)
    log("[3] fused block: kernel chain vs reference_double_conv (bf16); second run bit-equal")
    cases = [(name, BATCH, *shape, True, 8) for name, *shape in ENGAGED_BLOCKS]
    cases.append(("ragged", 2, 13, 11, 9, 12, 20, False, 1))
    block_rows = []
    with torch.inference_mode():
        for name, B, X, Y, Z, C, F, film, G in cases:
            args = block_args(torch, gen, B, X, Y, Z, C, F, film)
            got = ck.fused_double_conv_block(*args, G, 1e-5)
            want = ck.reference_double_conv(*args, num_groups=G, eps=1e-5)
            torch.cuda.synchronize()
            err = compare(torch, got, want, f"{name} B={B} {X}x{Y}x{Z} {C}->{F} G={G}")
            again = ck.fused_double_conv_block(*args, G, 1e-5)
            check(torch.equal(got, again), f"{name}: a second run differs (not deterministic)")
            if name == "ragged":
                continue
            ms = cuda_ms(torch, lambda: ck.fused_double_conv_block(*args, G, 1e-5), 10)
            plain = cuda_ms(torch, lambda: ck.reference_double_conv(*args, num_groups=G, eps=1e-5), 10)
            log(f"    kernel chain {ms!r} ms, plain chain {plain!r} ms")
            block_rows.append({"block": name, "max_abs_err": err, "ms": ms, "plain_ms": plain})

        # Each kernel of the chain against its own plain version at every
        # engaged block shape, beside cuDNN's bf16 pad + conv + bias (the
        # same bf16-operand, f32-accumulation arithmetic) for each conv.
        log("[3] single kernels vs their plain versions at the engaged blocks (B=8)")
        kernels = {
            name: {
                "name": name, "route": "cuda",
                "source": "generative_turbulence_tpu_torch/csrc/fused_double_conv.cu",
                "replaces": replaces, "launches": 0, "blocks": [],
                **({"also_replaces": also} if also else {}),
            }
            for name, replaces, also in (
                ("conv3x3x3_stats", f"{PALLAS}:463", f"{PALLAS}:251"),
                ("conv3x3x3_stats_silu_in", f"{PALLAS}:562", f"{PALLAS}:463"),
                ("affine_silu", f"{PALLAS}:588", None),
            )
        }
        for block, X, Y, Z, C, F in ENGAGED_BLOCKS:
            for row in single_kernel_rows(torch, ck, gen, block, BATCH, X, Y, Z, C, F):
                kernels[row.pop("name")]["blocks"].append(row)
        log("[3] single kernels at a shape whose bricks overhang every axis (silu_in on)")
        single_kernel_rows(torch, ck, gen, "overhang", 2, 7, 6, 13, 64, 64, timed=False)
        # The conv redesign's targets at batch 8, reported beside each other
        # (not checked): at down_0 the conv core against cuDNN's bf16 pad +
        # conv and the silu_in conv against the core; the down_1 chain
        # against the plain chain.
        core, silu = (kernels[n]["blocks"][0] for n in ("conv3x3x3_stats", "conv3x3x3_stats_silu_in"))
        down_1 = block_rows[1]
        log(f"[3] down_0: conv core {core['ms']!r} ms vs cuDNN bf16 pad+conv+bias "
            f"{core['cudnn_bf16_ms']!r} ms; silu_in / core {silu['ms'] / core['ms']!r} "
            f"(timed in turns {silu['over_core_in_turns']!r}); "
            f"down_1 chain {down_1['ms']!r} ms vs plain chain {down_1['plain_ms']!r} ms")
        silu_rows = kernels["affine_silu"]["blocks"]
        log(f"[3] affine_silu over the four engaged blocks (one U-Net evaluation): "
            f"{sum(r['ms'] for r in silu_rows)!r} ms, bound {sum(r['bound_ms'] for r in silu_rows)!r} ms")
        # The top-level numbers of each entry are those at down_0.
        for entry in kernels.values():
            entry.update({k: v for k, v in entry["blocks"][0].items() if k != "block"})
        kernels["conv3x3x3_stats"]["pad_flatten"] = pad_flatten_row(torch, gen)
        kernels = list(kernels.values())

    log("[3] backward (autograd of the plain chain) at a small shape")
    args = block_args(torch, gen, 1, 64, 24, 24, 16, 16, True)
    leaves = [a.float().requires_grad_() if a is not None else None for a in args]
    out = ck.fused_double_conv_block(*leaves, 8, 1e-5)
    (out.float() ** 2).mean().backward()
    grads = [a.grad for a in leaves if a is not None]
    check(all(g is not None and bool(torch.isfinite(g).all()) for g in grads), "non-finite gradient")
    check(float(leaves[0].grad.abs().max()) > 0, "zero input gradient")
    log("  gradients finite")
    return block_rows, kernels


def flash_phase(torch, ck):
    log("[3b] flash_attention vs its plain version (TF32 off); second run bit-equal")
    gen = torch.Generator().manual_seed(2)
    B, H, N, D = FLASH_PATH_SHAPE
    # The U-Net hands the kernel strided views of its (B, N, 3, H, D) qkv.
    qkv = torch.randn(B, N, 3, H, D, generator=gen).cuda()
    rows = {}
    with torch.inference_mode():
        cases = [
            ("path bf16", torch.bfloat16, qkv.to(torch.bfloat16)),
            ("path f32", torch.float32, qkv),
        ]
        for what, dtype, packed in cases:
            q, k, v = (packed[:, :, i].transpose(1, 2) for i in range(3))
            got = ck.flash_attention(q, k, v)
            want = ck._flash_attention_plain(q, k, v)
            torch.cuda.synchronize()
            check(got.dtype == dtype and tuple(got.shape) == FLASH_PATH_SHAPE, f"{what}: {got.dtype} {tuple(got.shape)}")
            label = f"flash_attention {what} {FLASH_PATH_SHAPE}"
            if dtype == torch.bfloat16:
                err = compare(torch, got, want, label, scaled=True)
                scale_guard(torch, got, want, label)
            else:
                err = compare_f32(torch, got, want, label)
            check(torch.equal(got, ck.flash_attention(q, k, v)), f"{what}: a second run differs")
            ms = cuda_ms(torch, lambda: ck.flash_attention(q, k, v), 20)
            plain = cuda_ms(torch, lambda: ck._flash_attention_plain(q, k, v), 5)
            flop = 4 * B * H * N * N * D
            ops = ({"bf16 tensor FLOP": flop, "MUFU ex2": B * H * N * N} if dtype == torch.bfloat16
                   else {"f32 FMA FLOP": flop})
            bnd = bound(4 * q.numel() * q.element_size(), **ops)
            if dtype == torch.bfloat16:
                # The MUFU bound is the floor of a kernel that takes every
                # exponential on the MUFU; the function's own floor lies
                # between it and the tensor cores' time for the products
                # (exponentials can also run as polynomials on the FMA units).
                bnd["tensor_flop_floor_ms"] = flop / PEAK["bf16 tensor FLOP"] * 1e3
            lib_ms, lib_name = sdpa_times(torch, q, k, v)
            floor = (f", tensor-FLOP floor {bnd['tensor_flop_floor_ms']!r} ms"
                     if "tensor_flop_floor_ms" in bnd else "")
            log(f"    kernel {ms!r} ms ({flop / ms / 1e9!r} TFLOP/s; bound {bnd['bound_ms']!r} ms, "
                f"{bnd['bound_kind']}{floor}), plain {plain!r} ms; kernel / fastest SDPA ({lib_name}) "
                f"{ms / lib_ms!r}")
            rows[dtype] = {"max_abs_err": err, "ms": ms, "plain_ms": plain, **bnd,
                           "library_ms": lib_ms, "library": f"scaled_dot_product_attention {lib_name}",
                           "over_library": ms / lib_ms}
            del got, want
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(2, 2, 2100, 16, generator=gen).to("cuda", dtype) for _ in range(3))
            got = ck.flash_attention(q, k, v)
            want = ck._flash_attention_plain(q, k, v)
            torch.cuda.synchronize()
            label = f"flash_attention ragged {dtype} (2, 2, 2100, 16)"
            if dtype == torch.bfloat16:
                compare(torch, got, want, label, scaled=True)
            else:
                compare_f32(torch, got, want, label)
            check(torch.equal(got, ck.flash_attention(q, k, v)), f"{label}: a second run differs")
        edge_cases(torch, ck, gen)
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "generative_turbulence_tpu_torch/csrc/flash_attention.cu",
        "replaces": f"{PALLAS}:132", "launches": 0, **rows[torch.bfloat16],
        "shape": list(FLASH_PATH_SHAPE), "dtype": "bfloat16",
        **{f"f32_{key}": value for key, value in rows[torch.float32].items()},
    }


def scale_guard(torch, got, want, label: str) -> None:
    """The scaled check has teeth at this shape: the kernel's output times
    0.9 and 1.1 is refused by it (logged beside what the plain check says)."""
    for factor in (0.9, 1.1):
        wrong = got.float() * factor
        verdicts = []
        for scaled in (False, True):
            try:
                compare(torch, wrong, want, label, quiet=True, scaled=scaled)
                verdicts.append("passes")
            except SmokeFailure as e:
                verdicts.append(f"refuses ({str(e).split(': ', 1)[-1]})")
        log(f"    output x {factor}: the plain check {verdicts[0]}, the scaled check {verdicts[1]}")
        check(verdicts[1] != "passes", f"{label}: the scaled check passes the output x {factor}")


def edge_cases(torch, ck, gen):
    """The card-only edge cases of tests/test_torch_gpu.py, each against its
    plain version with a bit-equal second run: flash_attention over token
    counts around its key tiles (64, 128) and work items (128, 192 queries),
    every head width it rounds D to, bf16 and f32, contiguous and as the
    U-Net's strided qkv views, and past 65,535 heads; affine_silu at F = 20
    (the scalar path), 32, 64, 128, bf16 and f32 output, at an odd voxel
    count and at one whose elements no block's share divides."""
    worst, n_cases = {}, 0
    flash = [(2, 3, N, D, dtype, strided) for dtype in (torch.bfloat16, torch.float32)
             for N in (1, 63, 64, 127, 128, 129, 2100) for D in (8, 16, 32, 64, 128)
             for strided in (False, True)]
    flash += [(3, 22000, 5, 8, dtype, False) for dtype in (torch.bfloat16, torch.float32)]
    for B, H, N, D, dtype, strided in flash:
        if strided:
            qkv = torch.randn(B, N, 3, H, D, generator=gen).to("cuda", dtype)
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        else:
            q, k, v = (torch.randn(B, H, N, D, generator=gen).to("cuda", dtype) for _ in range(3))
        got = ck.flash_attention(q, k, v)
        want = ck._flash_attention_plain(q, k, v)
        label = f"flash_attention edge {(B, H, N, D)} {dtype} {'strided' if strided else 'contiguous'}"
        check(got.dtype == dtype and got.shape == q.shape and got.is_contiguous(), f"{label}: layout")
        if dtype == torch.bfloat16:
            err = compare(torch, got, want, label, quiet=True, scaled=True)
        else:
            err = compare_f32(torch, got, want, label, quiet=True)
        worst[f"flash {dtype}"] = max(worst.get(f"flash {dtype}", 0.0), err)
        check(torch.equal(got, ck.flash_attention(q, k, v)), f"{label}: a second run differs")
        n_cases += 1
    for F in (20, 32, 64, 128):
        for spatial in ((3, 5, 7), (17, 33, 31)):
            h = torch.randn(3, *spatial, F, generator=gen).to("cuda", torch.bfloat16)
            a = (1 + 0.3 * torch.randn(3, F, generator=gen)).cuda()
            c = (0.3 * torch.randn(3, F, generator=gen)).cuda()
            for out_dtype in (torch.bfloat16, torch.float32):
                got = ck.affine_silu(h, a, c, out_dtype)
                want = ck._affine_silu_plain(h, a, c, out_dtype)
                label = f"affine_silu edge (3, {spatial}, {F}) -> {out_dtype}"
                agree = compare if out_dtype == torch.bfloat16 else compare_f32
                err = agree(torch, got, want, label, quiet=True)
                worst[f"affine_silu {out_dtype}"] = max(worst.get(f"affine_silu {out_dtype}", 0.0), err)
                check(torch.equal(got, ck.affine_silu(h, a, c, out_dtype)), f"{label}: a second run differs")
                n_cases += 1
    log(f"  {n_cases} edge cases agree, second runs bit-equal; max_abs_err {worst}")


def sdpa_times(torch, q, k, v):
    """torch's scaled_dot_product_attention on the kernel's own q, k, v
    under each backend that takes them: prints each time and returns the
    fastest (ms, backend name)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    times = {}
    warnings.filterwarnings("ignore", message=".*(kernel not used|runtime disabled|Expected query).*")
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        call = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)  # noqa: E731
        try:
            with sdpa_kernel(backend):
                call()
                torch.cuda.synchronize()
                times[backend.name] = cuda_ms(torch, call, 10)
        except RuntimeError as e:
            log(f"    SDPA {backend.name}: does not run ({str(e).splitlines()[0][:120]})")
            continue
        log(f"    SDPA {backend.name}: {times[backend.name]!r} ms")
    check(bool(times), "no SDPA backend ran")
    name = min(times, key=times.get)
    return times[name], name


def conv3d_phase(torch, ck):
    log("[3c] conv3d_3x3 vs its plain version at u_net.down_0 (B=8, 194x50x50, 64->64)")
    gen = torch.Generator().manual_seed(3)
    _, X, Y, Z, C, F = ENGAGED_BLOCKS[0]
    w = (torch.randn(3, 3, 3, C, F, generator=gen) * (27 * C) ** -0.5).cuda()
    b = (0.1 * torch.randn(F, generator=gen)).cuda()
    x32 = torch.randn(BATCH, X, Y, Z, C, generator=gen).cuda()
    flop = 2 * BATCH * X * Y * Z * 27 * C * F
    rows = {}
    ck.reset_launch_counts()
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            x = x32.to(dtype)
            got = ck.conv3d_3x3(x, w, b)
            want = ck._conv3d_3x3_plain(x, w, b)
            torch.cuda.synchronize()
            check(got.dtype == dtype, f"conv3d_3x3: output {got.dtype} for {dtype} input")
            # f32 output: the same bf16 products summed in f32 in another
            # order; judged at the bf16 tolerance like the chain.
            err = compare(torch, got, want, f"conv3d_3x3 {dtype}")
            check(torch.equal(got, ck.conv3d_3x3(x, w, b)), f"conv3d_3x3 {dtype}: a second run differs")
            ms = cuda_ms(torch, lambda: ck.conv3d_3x3(x, w, b), 10)
            plain = cuda_ms(torch, lambda: ck._conv3d_3x3_plain(x, w, b), 10)
            log(f"    kernel {ms!r} ms ({flop / ms / 1e9!r} TFLOP/s), plain {plain!r} ms")
            rows[dtype] = (err, ms, plain)
            del got, want
        xb, wb, bb = x32.to(torch.bfloat16), w.to(torch.bfloat16), b.to(torch.bfloat16)
        cudnn = cuda_ms(torch, lambda: ck._conv3d_replicate(xb, wb) + bb, 10)
        log(f"    cuDNN bf16 pad+conv+bias {cudnn!r} ms ({flop / cudnn / 1e9!r} TFLOP/s)")
    phase_launches = ck.LAUNCH_COUNTS["conv3d_3x3"]
    check(phase_launches > 0, "conv3d_3x3 did not launch")
    log("[3c] backward (autograd of the plain conv) at a small shape")
    leaves = [t.requires_grad_() for t in (
        torch.randn(1, 16, 12, 12, 8, generator=gen).cuda(),
        (0.1 * torch.randn(3, 3, 3, 8, 8, generator=gen)).cuda(),
        torch.randn(8, generator=gen).cuda(),
    )]
    (ck.conv3d_3x3(*leaves) ** 2).mean().backward()
    for name, leaf in zip("xwb", leaves):
        check(leaf.grad is not None and bool(torch.isfinite(leaf.grad).all()), f"conv3d_3x3: non-finite d{name}")
        check(float(leaf.grad.abs().max()) > 0, f"conv3d_3x3: zero d{name}")
    log("  gradients for x, w, b finite and non-zero")
    err, ms, plain = rows[torch.bfloat16]
    f32_err, f32_ms, f32_plain = rows[torch.float32]
    n = BATCH * X * Y * Z
    bnd = bound(2 * n * (C + F) + 2 * 27 * C * F + 4 * F, **{"bf16 tensor FLOP": flop})
    return {
        "name": "conv3d_3x3", "route": "cuda",
        "source": "generative_turbulence_tpu_torch/csrc/fused_double_conv.cu",
        "replaces": f"{PALLAS}:294", "also_replaces": f"{PALLAS}:251",
        "launches": 0, "on_main_path": False, "kernel_phase_launches": phase_launches,
        "max_abs_err": err, "ms": ms, "plain_ms": plain, "dtype": "bfloat16", **bnd,
        "library_ms": cudnn, "library": "cuDNN bf16 replicate pad + conv3d + bias", "cudnn_bf16_ms": cudnn, "tflops": flop / ms / 1e9, "cudnn_tflops": flop / cudnn / 1e9,
        "f32_max_abs_err": f32_err, "f32_ms": f32_ms, "f32_plain_ms": f32_plain,
    }


def shapes_case(torch, n_frames: int = 1):
    """The in-memory shapes case: metadata, its first frame of u, p as cells
    (n_cells, 4), and its FieldStats (u, p, norm(u) over the frames); with
    ``n_frames`` > 1 the frames (n_frames, n_cells, 4) in place of the
    first."""
    import numpy as np

    from generative_turbulence_tpu_torch.data.schema import FieldStats
    from generative_turbulence_tpu_torch.data.synthetic import build_case
    from generative_turbulence_tpu_torch.data.variables import Variable, stack_channels

    meta, fields = build_case(cell_counts=(192, 48, 48), n_frames=n_frames, seed=0)
    frames = stack_channels(fields, (Variable.U, Variable.P))
    frame = frames[0] if n_frames == 1 else frames
    u = fields[Variable.U].reshape(-1, 3)
    stats = {}
    for key, values in (("u", u), ("p", fields[Variable.P].reshape(-1, 1)),
                        ("norm(u)", np.linalg.norm(u, axis=-1, keepdims=True))):
        stats[key] = {name: fn(values, axis=0).astype(np.float32) for name, fn in
                      (("min", np.min), ("max", np.max), ("mean", np.mean), ("std", np.std))}
    return meta, frame, FieldStats(stats)


def main_path_phase(torch, ck, profiles):
    from generative_turbulence_tpu_torch.data.grid import GridMap
    from generative_turbulence_tpu_torch.data.variables import Variable
    from generative_turbulence_tpu_torch.diffusion.gaussian import GaussianDiffusion, GeneratorNoise
    from generative_turbulence_tpu_torch.models.conditioning import Conditioning
    from generative_turbulence_tpu_torch.models.normalization import Normalizer
    from generative_turbulence_tpu_torch.models.unet import DenoisingModel
    from generative_turbulence_tpu_torch.training.diffusion_task import sample

    log("[4] main path: shapes case 192x48x48 (padded 194x50x50), dim 32, 4 levels, T=500, bf16")
    tic = time.perf_counter()
    variables = (Variable.U, Variable.P)
    meta, frame, _ = shapes_case(torch)  # frame: (n_cells, 4)
    normalizer = Normalizer(mean=frame.mean(axis=0), std=frame.std(axis=0))
    grid = GridMap.from_metadata(meta, variables, device="cuda")
    cells = torch.as_tensor(frame, device="cuda").expand(BATCH, *frame.shape).contiguous()
    model = DenoisingModel(
        out_features=4, timesteps=500, dim=32, u_net_levels=4,
        conditioning=Conditioning(cell_type_embedding_dim=4), dtype=torch.bfloat16,
    ).init_weights(torch.Generator().manual_seed(0)).cuda().eval()
    diffusion = GaussianDiffusion.create(beta_schedule="log-snr-linear", timesteps=500, noise_bcs=True)
    log(f"  set-up {time.perf_counter() - tic!r} s, {grid.n_cells} cells, grid {grid.shape}")

    x = torch.randn(BATCH, *grid.shape, 4, generator=torch.Generator().manual_seed(1)).cuda()
    t = torch.full((BATCH,), 250, dtype=torch.long, device="cuda")
    with torch.inference_mode():
        model(x, t, grid.cell_types)  # warm-up: cuDNN plans, allocator
        torch.cuda.synchronize()

    ck.reset_launch_counts()
    timings = {}
    runs = [
        ("ddim", dict(sampler="ddim", ddim_steps=DDIM_STEPS, ddim_eta=0.0), DDIM_STEPS),
        ("ddpm", dict(sampler="ddpm", start_from=DDPM_STEPS), DDPM_STEPS),
    ]
    outputs = {}
    for name, kw, n_evals in runs:
        noise = GeneratorNoise(torch.Generator(device="cuda").manual_seed(0), "cuda")
        torch.cuda.synchronize()
        tic = time.perf_counter()
        outputs[name] = sample(model, diffusion, normalizer, cells, grid, noise=noise, **kw)
        torch.cuda.synchronize()
        timings[name] = time.perf_counter() - tic
    launches = dict(ck.LAUNCH_COUNTS)
    n_evals = DDIM_STEPS + DDPM_STEPS
    for name, s in timings.items():
        steps = dict((r[0], r[2]) for r in runs)[name]
        log(f"  {name}: {s!r} s per sampler call ({steps} U-Net evaluations, {s / steps!r} s each)")
    for name, out in outputs.items():
        check(tuple(out.shape) == (BATCH, grid.n_cells, 4), f"{name}: shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite samples")
        log(f"  {name} samples: shape {tuple(out.shape)}, finite, mean {out.mean(dim=(0, 1)).tolist()}")
    expected = n_evals * len(ENGAGED_BLOCKS)
    log(f"  launches over the sampler calls: {launches} (expect {expected} for each chain "
        f"kernel, {3 * expected} in all = 3 x {len(ENGAGED_BLOCKS)} blocks x {n_evals} U-Net "
        "evaluations; no flash_attention at 108 bottleneck tokens, no conv3d_3x3)")
    for name in CHAIN_KERNELS:
        check(launches[name] == expected, f"{name}: {launches[name]} launches, expected {expected}")
    for name in ("flash_attention", "conv3d_3x3"):
        check(launches[name] == 0, f"{name}: {launches[name]} launches on the 4-level path")

    # One U-Net evaluation: timing, and agreement with the plain (unfused) path.
    with torch.inference_mode():
        fwd_ms = cuda_ms(torch, lambda: model(x, t, grid.cell_types), 5)
        got = model(x, t, grid.cell_types)
        saved = ck.MIN_SPATIAL_FOR_FUSED_BLOCK
        ck.MIN_SPATIAL_FOR_FUSED_BLOCK = 1 << 62  # close the gate: plain ConvBlocks
        try:
            plain_ms = cuda_ms(torch, lambda: model(x, t, grid.cell_types), 5)
            want = model(x, t, grid.cell_types)
        finally:
            ck.MIN_SPATIAL_FOR_FUSED_BLOCK = saved
    log(f"  U-Net evaluation (B={BATCH}, bf16): {fwd_ms!r} ms with the kernels, {plain_ms!r} ms plain")
    scale = float(want.abs().max())
    log(f"  U-Net output vs plain path (scaled by max |out| = {scale!r}):")
    compare(torch, got / scale, want / scale, "U-Net forward")
    with torch.inference_mode():
        profiles.append(profile_forwards(torch, "4 levels bf16", lambda: model(x, t, grid.cell_types)))
    return launches, {"fwd_ms": fwd_ms, "plain_fwd_ms": plain_ms, **timings}


def two_level_phase(torch, ck, profiles):
    from generative_turbulence_tpu_torch.data.grid import GridMap
    from generative_turbulence_tpu_torch.diffusion.gaussian import GeneratorNoise
    from generative_turbulence_tpu_torch.ops import attention
    from generative_turbulence_tpu_torch.training.config import parse_cli_overrides
    from generative_turbulence_tpu_torch.training.diffusion_task import DiffusionTask

    log(f"[4b] main path, 2 levels: {' '.join(TWO_LEVEL_OVERRIDES)}; shapes case, batch {BATCH}")
    tic = time.perf_counter()
    cfg = parse_cli_overrides(TWO_LEVEL_OVERRIDES).resolved()
    meta, frame, stats = shapes_case(torch)
    task = DiffusionTask(cfg.model, stats, "cuda")
    task.net.init_weights(torch.Generator(device="cuda").manual_seed(0))
    grid = GridMap.from_metadata(meta, task.variables, device="cuda")
    cells = torch.as_tensor(frame, device="cuda").expand(BATCH, *frame.shape).contiguous()
    model = task.eval_net
    log(f"  set-up {time.perf_counter() - tic!r} s; dim {cfg.model.dim}, {cfg.model.u_net_levels} "
        f"levels, T={cfg.model.timesteps}, compute {cfg.model.compute_dtype}")
    x = torch.randn(BATCH, *grid.shape, 4, generator=torch.Generator().manual_seed(1)).cuda()
    t = torch.full((BATCH,), 250, dtype=torch.long, device="cuda")
    with torch.inference_mode():
        model(x, t, grid.cell_types)  # warm-up: cuDNN plans, allocator
        torch.cuda.synchronize()

    ck.reset_launch_counts()
    timings, outputs = {}, {}
    runs = [("ddim", None, DDIM_STEPS), ("ddpm", DDPM_STEPS, DDPM_STEPS)]
    for sampler, start_from, _ in runs:
        task.cfg.sampler = sampler  # the task follows cfg.sampler at call time
        noise = GeneratorNoise(torch.Generator(device="cuda").manual_seed(0), "cuda")
        torch.cuda.synchronize()
        tic = time.perf_counter()
        outputs[sampler] = task.sample(cells, grid, noise, start_from=start_from)
        torch.cuda.synchronize()
        timings[f"two_level_{sampler}"] = time.perf_counter() - tic
    task.cfg.sampler = cfg.model.sampler
    launches = dict(ck.LAUNCH_COUNTS)
    n_evals = sum(r[2] for r in runs)
    for sampler, _, steps in runs:
        s = timings[f"two_level_{sampler}"]
        log(f"  {sampler}: {s!r} s per sampler call ({steps} U-Net evaluations, {s / steps!r} s each)")
    for name, out in outputs.items():
        check(tuple(out.shape) == (BATCH, grid.n_cells, 4), f"{name}: shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite samples")
        log(f"  {name} samples: shape {tuple(out.shape)}, finite, mean {out.mean(dim=(0, 1)).tolist()}")
    expected = n_evals * len(ENGAGED_BLOCKS)
    log(f"  launches over the sampler calls: {launches} (expect flash_attention {n_evals} = 1 per "
        f"U-Net evaluation, {expected} for each chain kernel = {len(ENGAGED_BLOCKS)} blocks x {n_evals})")
    check(launches["flash_attention"] == n_evals,
          f"flash_attention: {launches['flash_attention']} launches, expected {n_evals}")
    for name in CHAIN_KERNELS:
        check(launches[name] == expected, f"{name}: {launches[name]} launches, expected {expected}")
    check(launches["conv3d_3x3"] == 0, "conv3d_3x3 launched on the 2-level path")

    # One U-Net evaluation in bf16 and one with eval_compute_dtype=float32,
    # each against the same net with the plain attention.
    f32_cfg = parse_cli_overrides(TWO_LEVEL_OVERRIDES + ["model.eval_compute_dtype=float32"])
    f32_task = DiffusionTask(f32_cfg.model, stats, "cuda")
    f32_task.net.load_state_dict(task.net.state_dict())
    for label, net in (("bf16", model), ("f32", f32_task.eval_net)):
        with torch.inference_mode():
            fwd_ms = cuda_ms(torch, lambda: net(x, t, grid.cell_types), 5)
            got = net(x, t, grid.cell_types)
            saved = attention.FLASH_MIN_TOKENS
            attention.FLASH_MIN_TOKENS = 1 << 62  # the plain einsum attention
            try:
                plain_ms = cuda_ms(torch, lambda: net(x, t, grid.cell_types), 5)
                want = net(x, t, grid.cell_types)
            finally:
                attention.FLASH_MIN_TOKENS = saved
        log(f"  U-Net evaluation (B={BATCH}, {label}): {fwd_ms!r} ms with flash_attention, "
            f"{plain_ms!r} ms with the plain attention")
        scale = float(want.abs().max())
        compare(torch, got / scale, want / scale, f"2-level U-Net {label} vs plain attention (scaled by {scale!r})")
        timings[f"two_level_fwd_ms_{label}"] = fwd_ms
        timings[f"two_level_plain_attention_fwd_ms_{label}"] = plain_ms
        del got, want
        with torch.inference_mode():
            profiles.append(profile_forwards(torch, f"2 levels {label}", lambda: net(x, t, grid.cell_types)))
    return launches, timings


# The paper's run (config/shapes_diffusion.yaml): the defaults of
# ModelConfig (dim 32, 4 levels, T = 500, batch 6, remat, RAdam with exp
# decay) and TrainerConfig (clip 0.1), in bf16, with the EMA on.
TRAIN_OVERRIDES = ["model.compute_dtype=bfloat16", "model.ema_decay=0.999"]
TRAIN_WARMUP, TRAIN_TIMED = 2, 5
TRAIN_MAX_STEPS = 10_000  # the LR schedule's length (a few epochs of the shapes data)
# Chain launches per train step: the 4 engaged blocks' forwards, plus the
# recompute of the three inside the U-Net's remat (down_0, down_1, up_0);
# decode_resnet is outside it, as in flax.  (A custom Function packs what
# it saves only after its forward, so checkpoint's early stop comes after
# the kernels.)
TRAIN_CHAIN_LAUNCHES = 7
TRAIN_FLASH_LAUNCHES = {4: 0, 2: 1}  # the centre attention is not remat'd
MAX_GRAD_REL_L2, MIN_GRAD_COS = 3e-2, 0.999
# Where the device time of a train step goes, by the innermost profiler
# range or autograd node that launched each kernel (first match wins).
TRAIN_PHASES = [
    ("optimizer + EMA", ("train/optimizer",)),
    ("remat recompute", ("remat recompute",)),
    ("chain backward (plain)", ("_FusedDoubleConvBackward",)),
    ("attention backward (plain)", ("_FlashAttentionBackward",)),
    ("other backward", ("autograd::engine::evaluate_function", "train/backward")),
    ("forward", ("train/loss",)),
]


def phase_of(event) -> str:
    """The phase of a profiler CPU event: the first of ``TRAIN_PHASES``
    whose name fragment any of its ancestors (itself included) carries."""
    names = []
    while event is not None:
        names.append(event.name)
        event = event.cpu_parent
    for phase, keys in TRAIN_PHASES:
        if any(k in name for name in names for k in keys):
            return phase
    return "unattributed"


def device_time_by_phase(events) -> dict:
    """ms of each phase: the device kernels each CPU event launched (its
    ``kernels``) attributed to ``phase_of`` that event."""
    from torch.autograd import DeviceType

    out = {phase: 0.0 for phase, _ in TRAIN_PHASES}
    out["unattributed"] = 0.0
    for e in events:
        if e.device_type == DeviceType.CPU and e.kernels:
            out[phase_of(e)] += sum(k.duration for k in e.kernels) / 1e3
    return out


def train_task(torch, levels: int):
    """The paper's training configuration at ``levels`` U-Net levels, its
    seeded task on the card, the shapes grid and one batch of its frames."""
    from generative_turbulence_tpu_torch.data.grid import GridMap
    from generative_turbulence_tpu_torch.training.config import parse_cli_overrides
    from generative_turbulence_tpu_torch.training.diffusion_task import DiffusionTask

    overrides = TRAIN_OVERRIDES + ([f"model.u_net_levels={levels}"] if levels != 4 else [])
    cfg = parse_cli_overrides(overrides).resolved()
    meta, frames, stats = shapes_case(torch, n_frames=cfg.model.batch_size)
    task = DiffusionTask(cfg.model, stats, "cuda", max_train_steps=TRAIN_MAX_STEPS,
                         gradient_clip_val=cfg.trainer.gradient_clip_val)
    task.init_weights(torch.Generator(device="cuda").manual_seed(0))
    grid = GridMap.from_metadata(meta, task.variables, device="cuda")
    return cfg, task, grid, torch.as_tensor(frames, device="cuda")


def step_gradients(torch, task, cells, grid, seed: int) -> list:
    """One step's gradients (no update) from the task's current parameters
    and the draws of ``seed``."""
    from generative_turbulence_tpu_torch.diffusion.gaussian import GeneratorNoise

    noise = GeneratorNoise(torch.Generator(device=cells.device).manual_seed(seed), cells.device)
    params = list(task.net.parameters())
    loss = task.diffusion.loss(task._eps_fn(grid), task._model_input(cells, grid), grid, noise)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    check(all(g is not None for g in grads), "a parameter got no gradient")
    return [g.float() for g in grads]


def grad_agreement(torch, got, want, names) -> dict:
    """Cosine similarity over all leaves and each leaf's relative L2 error:
    the worst leaf and its error."""
    flat_g, flat_w = torch.cat([g.flatten() for g in got]), torch.cat([w.flatten() for w in want])
    cos = float(torch.nn.functional.cosine_similarity(flat_g, flat_w, dim=0))
    errs = [float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w).clamp_min(1e-30))
            for g, w in zip(got, want)]
    worst = max(range(len(errs)), key=errs.__getitem__)
    return {"cos": cos, "worst_rel_l2": errs[worst], "worst_leaf": names[worst]}


def hold_gradients(torch, task, cells, grid, label: str, plain_path) -> dict:
    """The kernels' gradients against the plain path's (``plain_path``: a
    context that closes the kernels' gate), same parameters and draws:
    cosine >= 0.999 and every leaf's relative L2 error <= 3e-2, or 3x the
    worst leaf's difference between two plain runs where that is larger;
    the kernels' gradients x 1.1 must be refused."""
    names = [n for n, _ in task.net.named_parameters()]
    got = step_gradients(torch, task, cells, grid, seed=7)
    with plain_path():
        want = step_gradients(torch, task, cells, grid, seed=7)
        again = step_gradients(torch, task, cells, grid, seed=7)
    noise = grad_agreement(torch, again, want, names)
    bound = max(MAX_GRAD_REL_L2, 3 * noise["worst_rel_l2"])
    row = grad_agreement(torch, got, want, names)
    scaled = grad_agreement(torch, [1.1 * g for g in got], want, names)
    log(f"  {label} gradients vs the plain path: cos {row['cos']!r}, worst leaf {row['worst_leaf']} "
        f"rel_l2 {row['worst_rel_l2']!r} (bound {bound!r}; two plain runs: worst {noise['worst_leaf']} "
        f"{noise['worst_rel_l2']!r}, cos {noise['cos']!r}); gradients x 1.1: rel_l2 {scaled['worst_rel_l2']!r}")
    check(row["cos"] >= MIN_GRAD_COS, f"{label}: gradient cosine {row['cos']} < {MIN_GRAD_COS}")
    check(row["worst_rel_l2"] <= bound, f"{label}: {row['worst_leaf']} gradient rel_l2 {row['worst_rel_l2']} > {bound}")
    check(scaled["worst_rel_l2"] > bound, f"{label}: the gradients x 1.1 pass the bound {bound}")
    return {**row, "bound": bound, "plain_vs_plain": noise, "x1.1_worst_rel_l2": scaled["worst_rel_l2"]}


@contextlib.contextmanager
def patched(obj, name: str, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def train_phase(torch, ck, levels: int, timed: int) -> tuple:
    """``timed`` train steps (after 2 warm-up steps) of the paper's run at
    ``levels`` U-Net levels on 6 frames of the shapes case: times, losses,
    peak memory, launches per step, one profiled step, and the gradients
    against the plain path."""
    from generative_turbulence_tpu_torch.diffusion.gaussian import GeneratorNoise
    from generative_turbulence_tpu_torch.ops import attention

    tic = time.perf_counter()
    cfg, task, grid, cells = train_task(torch, levels)
    m = cfg.model
    log(f"[6] train step, {levels} levels: {' '.join(TRAIN_OVERRIDES)}; dim {m.dim}, T={m.timesteps}, batch "
        f"{cells.shape[0]}, {m.compute_dtype}, remat {m.remat}, {m.optimizer} lr {m.learning_rate} "
        f"({m.lr_decay}), clip {cfg.trainer.gradient_clip_val}, EMA {m.ema_decay}; {task.n_params()} "
        f"parameters; set-up {time.perf_counter() - tic!r} s")
    before = {n: p.detach().clone() for n, p in task.net.named_parameters()}
    noise = GeneratorNoise(torch.Generator(device="cuda").manual_seed(1), "cuda")
    losses = [task.training_step(cells, grid, noise)["train/loss"] for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    ema_before = {n: e.clone() for n, e in task.ema.items()}
    ck.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(timed + 1)]
    events[0].record()
    for i in range(timed):
        losses.append(task.training_step(cells, grid, noise)["train/loss"])
        events[i + 1].record()
    torch.cuda.synchronize()
    launches = dict(ck.LAUNCH_COUNTS)
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(v) for v in losses]
    log(f"  step ms {step_ms!r} (median {statistics.median(step_ms)!r}); peak memory {peak!r} GiB; "
        f"losses {losses!r}; launches over {timed} steps {launches}")
    check(all(math.isfinite(v) for v in losses), f"{levels} levels: non-finite loss")
    missing = [n for n, p in task.net.named_parameters() if p.grad is None]
    check(not missing, f"{levels} levels: no gradient for {missing[:5]}")
    same = [n for n, p in task.net.named_parameters() if torch.equal(p.detach(), before[n])]
    check(not same, f"{levels} levels: parameters unchanged by the steps: {same[:5]}")
    same = [n for n, e in task.ema.items() if torch.equal(e, ema_before[n])]
    check(not same, f"{levels} levels: EMA leaves unchanged by the timed steps: {same[:5]}")
    log(f"  every parameter got a gradient and changed; every EMA leaf changed")
    expected = {name: TRAIN_CHAIN_LAUNCHES * timed for name in CHAIN_KERNELS}
    expected.update(flash_attention=TRAIN_FLASH_LAUNCHES[levels] * timed, conv3d_3x3=0)
    for name, n in expected.items():
        check(launches[name] == n, f"{levels}-level train: {name} launched {launches[name]} times, expected {n}")
    log(f"  launches per step: {({k: v / timed for k, v in launches.items()})} (as expected)")

    profile = profile_train_step(torch, f"train step {levels} levels", lambda: task.training_step(cells, grid, noise))
    if levels == 4:
        plain = lambda: patched(ck, "MIN_SPATIAL_FOR_FUSED_BLOCK", 1 << 62)  # noqa: E731
    else:
        plain = lambda: patched(attention, "FLASH_MIN_TOKENS", 1 << 62)  # noqa: E731
    grads = hold_gradients(torch, task, cells, grid, f"{levels}-level step", plain)
    row = {"levels": levels, "step_ms": step_ms, "median_step_ms": statistics.median(step_ms),
           "peak_gib": peak, "losses": losses, "launches_per_step": {k: v / timed for k, v in launches.items()},
           "gradients": grads, "n_params": task.n_params()}
    return launches, row, profile


def profile_train_step(torch, label: str, fn) -> dict:
    """torch.profiler over one train step (after the timed ones): wall, device
    busy time and idle share, kernel time by group and by phase (forward,
    backward, remat recompute, the chain's and the attention's plain
    backward, optimizer + EMA), launches and peak memory.  Logged and
    returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from generative_turbulence_tpu_torch.scripts.profile_fwd import device_summary

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - tic) * 1e3
    events = prof.events()
    row = {"profile": label, "wall_ms": wall, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    row["launches"] = len(device)
    if not device:
        row["device"] = "not measured (the profiler recorded no device activity)"
        log(f"  profile {label}: {row}")
        return row
    row.update(device_summary(device, wall, 1))
    row["kernel_ms_by_phase"] = device_time_by_phase(events)
    log(f"  profile {label}: {json.dumps(row)}")
    return row


# The eval path: the shapes grid as a dataset on disk (1 train and 1 val
# case, 16 frames, seed 0) in the .npyd format, which reads without h5py.
EVAL_FRAMES = 16
EVAL_BATCH = 8
# The val case's homogeneous regions for the point-cloud Wasserstein: the
# shapes data's regions hold at most 512 cells (the JAX package's
# eval/metrics.py:246-248); the Sinkhorn solve runs over 32 of them, and the
# calibration against the exact host EMD over 4.
EVAL_REGION_CELLS = 512
EVAL_MAX_REGIONS, CALIBRATION_REGIONS = 32, 4
SINKHORN_REL_TOL = 0.15  # the JAX package's calibration bound (tests/test_eval.py:150-158)
SPECTRA_RTOL = 1e-3  # cuFFT against pocketfft, f32
EVAL_RUNS = [
    # (label, overrides, U-Net evaluations per eval_step, flash_attention launches per evaluation)
    ("4_levels", ["model.compute_dtype=bfloat16", "model.sampler=ddim", "model.ddim_steps=50"], 50, 0),
    ("2_levels", ["model.u_net_levels=2", "model.compute_dtype=bfloat16", "model.sampler=ddim",
                  "model.ddim_steps=10"], 10, 1),
]


class TimedMetric:
    """A metric of a SampleMetricsCollection, with the seconds its calls took."""

    def __init__(self, torch, metric):
        self.torch, self.metric, self.seconds = torch, metric, 0.0

    def is_expensive(self) -> bool:
        return self.metric.is_expensive()

    def __call__(self, *args):
        tic = time.perf_counter()
        out = self.metric(*args)
        self.torch.cuda.synchronize()
        self.seconds += time.perf_counter() - tic
        return out


def timed_call(torch, fn, seconds: dict, key: str):
    """``fn``, adding the seconds each call takes (the card synchronised) to
    ``seconds[key]``."""

    def run(*args, **kwargs):
        tic = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - tic
        return out

    return run


def write_eval_dataset(root: Path, n_frames: int = EVAL_FRAMES, label: str = "6b") -> float:
    """The shapes grid as a dataset under ``root`` (1 train and 1 val case
    of ``n_frames`` frames); returns the seconds it took (the cases, their
    side files and ``compute_stats``)."""
    import numpy as np

    from generative_turbulence_tpu_torch.data.schema import read_metadata
    from generative_turbulence_tpu_torch.data.synthetic import generate_synthetic_dataset

    tic = time.perf_counter()
    generate_synthetic_dataset(root, n_train_cases=1, n_val_cases=1, n_test_cases=0, n_frames=n_frames,
                               cell_counts=(192, 48, 48), seed=0, format="npyd")
    seconds = time.perf_counter() - tic
    # Test-data preparation: the generator cuts a case into 4 regions, about
    # 110k cells each at this grid, where the Sinkhorn's (n, chunk, m, R, R)
    # cost tensor would need 8 * 8 * (1.1e5)^2 floats.  Contiguous regions of
    # 512 cells, as large as the real data's, take their place.
    case = root / "val" / "case-val-00"
    n_cells = read_metadata(case / "data.npyd").n_cells
    np.savez(case / "regions.npz", assignments=np.arange(n_cells) // EVAL_REGION_CELLS)
    log(f"[{label}] dataset: 1 train + 1 val case of 192x48x48 cells, {n_frames} frames, .npyd, "
        f"stats computed, in {seconds!r} s; val regions of {EVAL_REGION_CELLS} cells")
    return seconds


def spectra_check(samples, data) -> float:
    """The log-TKE distance matrix of ``samples`` against ``data`` over the
    back region, on the card against the same function on the CPU; returns
    the largest relative error."""
    import numpy as np

    from generative_turbulence_tpu_torch.eval.metrics import _embed_u
    from generative_turbulence_tpu_torch.ops.spectra import SpectrumOps, log_tke_distance_matrix

    distances = {}
    for device in ("cuda", "cpu"):
        u_s, u_d = (_embed_u(x, device)[:, 1:-1, 1:-1, 1:-1] for x in (samples, data))
        L, W = u_s.shape[1], min(u_s.shape[2], u_s.shape[3])
        back = slice(L - W, L)
        D = log_tke_distance_matrix(u_s[:, back], u_d[:, back], u_d.mean(dim=0)[back],
                                    SpectrumOps.create(device=device))[0]
        distances[device] = D.double().cpu().numpy()
    got, want = distances["cuda"], distances["cpu"]
    err = float(np.max(np.abs(got - want) / np.abs(want)))
    log(f"    log-TKE distance matrix {got.shape}, card vs CPU: max relative error {err!r} (rtol {SPECTRA_RTOL})")
    check(bool(np.isfinite(got).all()) and err <= SPECTRA_RTOL, f"log-TKE distances: card vs CPU {err}")
    return err


def metric_checks(torch, root: Path, stats, data) -> dict:
    """The metrics' own checks on the card, against ``data`` (the val frames
    the samples are scored against), with real frames from the first half of
    the case in place of samples: real frames closer to the data than noise
    in ``val/tke``, and the Sinkhorn Wasserstein within 15% of the exact
    host EMD on the same 4 regions.  They do not depend on the network, so
    they run once."""
    import numpy as np

    from generative_turbulence_tpu_torch.data.schema import CaseRepository, find_data_files
    from generative_turbulence_tpu_torch.eval.metrics import WassersteinMetric, WassersteinTKE

    out = {}
    repo = CaseRepository(find_data_files(root / "val"), tuple(data.fields))
    n = data.n_samples
    real = repo.read(0, np.round(np.linspace(0, EVAL_FRAMES // 2 - 1, n)).astype(int))
    tke = WassersteinTKE(device="cuda")
    real_tke = tke(real, data, stats)["tke"]
    rng = np.random.default_rng(0)
    noise = repo.read(0, np.round(np.linspace(0, EVAL_FRAMES // 2 - 1, n)).astype(int))
    for v in noise.fields:
        noise.fields[v] = rng.normal(size=noise.fields[v].shape).astype(np.float32) * np.abs(noise.fields[v]).mean()
    noise_tke = tke(noise, data, stats)["tke"]
    log(f"    val/tke of real frames {real_tke!r} < of noise {noise_tke!r}")
    check(0 <= real_tke < noise_tke, f"real frames' tke {real_tke} not below noise's {noise_tke}")
    out.update(real_frames_tke=real_tke, noise_tke=noise_tke)

    w = {}
    for solver in ("sinkhorn", "exact"):
        metric = WassersteinMetric(max_workers=1, solver=solver, max_regions=CALIBRATION_REGIONS, region_seed=0)
        tic = time.perf_counter()
        w[solver] = metric(real, data, stats)["wasserstein"]
        torch.cuda.synchronize()
        out[f"calibration_{solver}_s"] = time.perf_counter() - tic
    rel = abs(w["sinkhorn"] - w["exact"]) / w["exact"]
    log(f"    Wasserstein over {CALIBRATION_REGIONS} regions, real frames vs data: Sinkhorn on the card "
        f"{w['sinkhorn']!r} ({out['calibration_sinkhorn_s']!r} s), exact host EMD {w['exact']!r} "
        f"({out['calibration_exact_s']!r} s): relative difference {rel!r} (bound {SINKHORN_REL_TOL})")
    check(rel <= SINKHORN_REL_TOL, f"Sinkhorn Wasserstein off the exact one by {rel}")
    out.update(calibration_sinkhorn=w["sinkhorn"], calibration_exact=w["exact"], calibration_rel_diff=rel)
    return out


def eval_phase(torch, ck, root: Path, label: str, overrides: list, n_evals: int, flash_per_eval: int) -> tuple:
    """One pass of the validation path: DataModule -> val batch on the card
    -> DiffusionTask.eval_step -> the sample store -> on_eval_end (val/tke,
    the regions, max-mean-tke-pos, the Sinkhorn Wasserstein over 32 regions),
    with the launch counts of eval_step, ``spectra_check`` on the stored
    samples and, in the first run, ``metric_checks``."""
    import numpy as np

    from generative_turbulence_tpu_torch.data.dataset import DataModule
    from generative_turbulence_tpu_torch.diffusion.gaussian import GeneratorNoise
    from generative_turbulence_tpu_torch.eval.metrics import WassersteinMetric
    from generative_turbulence_tpu_torch.training.config import parse_cli_overrides
    from generative_turbulence_tpu_torch.training.diffusion_task import DiffusionTask

    log(f"[6b] eval path, {label}: {' '.join(overrides)}; val batch {EVAL_BATCH}")
    dm = DataModule(root, eval_batch_size=EVAL_BATCH, val_samples=EVAL_BATCH).setup("validate")
    torch.cuda.synchronize()
    tic = time.perf_counter()
    batch = next(iter(dm.val_batches())).to("cuda")
    torch.cuda.synchronize()
    read_ms = (time.perf_counter() - tic) * 1e3
    cfg = parse_cli_overrides(overrides).resolved()
    task = DiffusionTask(cfg.model, dm.stats, "cuda", data_root=root, samples_root=root / "samples" / label,
                         wasserstein_solver="sinkhorn")
    task.net.init_weights(torch.Generator(device="cuda").manual_seed(0))
    collection = task.metrics["val"]
    for metric in collection.metrics:
        if isinstance(metric, WassersteinMetric):
            metric.max_regions, metric.region_seed = EVAL_MAX_REGIONS, 0
    collection.metrics = [TimedMetric(torch, m) for m in collection.metrics]
    log(f"  batch {tuple(batch.cells.shape)} of {batch.metadata.case_name} read and on the card in {read_ms!r} ms")

    # A first eval_step of one DDIM step meets the cold start (cuDNN plans,
    # the allocator) that a validation pays once; on_eval_start then drops
    # its samples.  The task reads cfg.ddim_steps at call time.
    torch.cuda.reset_peak_memory_stats()
    steps, task.cfg.ddim_steps = task.cfg.ddim_steps, 1
    tic = time.perf_counter()
    task.eval_step(batch, GeneratorNoise(torch.Generator(device="cuda").manual_seed(1), "cuda"), "val")
    cold_s = time.perf_counter() - tic
    task.cfg.ddim_steps = steps
    task.on_eval_start("val")
    noise = GeneratorNoise(torch.Generator(device="cuda").manual_seed(0), "cuda")
    store = task.sample_stores["val"]
    parts = {}  # eval_step split: the sampler, the store's write, the rest (copy to the host, statistics)
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    tic = time.perf_counter()
    with patched(task, "sample", timed_call(torch, task.sample, parts, "sampler_s")), \
            patched(store, "add_samples", timed_call(torch, store.add_samples, parts, "store_write_s")):
        step = task.eval_step(batch, noise, "val")  # ends by copying the samples to the host
    step_s = time.perf_counter() - tic
    launches = dict(ck.LAUNCH_COUNTS)
    parts["host_copy_and_statistics_s"] = step_s - parts["sampler_s"] - parts["store_write_s"]
    log(f"  first eval_step (1 DDIM step, cold) {cold_s!r} s; eval_step {step_s!r} s: sampler "
        f"{parts['sampler_s']!r} s ({n_evals} U-Net evaluations, {parts['sampler_s'] / n_evals * 1e3!r} ms each), "
        f"store write {parts['store_write_s']!r} s, the rest {parts['host_copy_and_statistics_s']!r} s; {step}; "
        f"launches {launches}")
    expected = dict({name: n_evals * len(ENGAGED_BLOCKS) for name in CHAIN_KERNELS},
                    flash_attention=n_evals * flash_per_eval, conv3d_3x3=0)
    for name, n in expected.items():
        check(launches[name] == n, f"eval {label}: {name} launched {launches[name]} times, expected {n}")
    case = batch.metadata.case_name
    check(store.case_names == [case] and store.n_samples(case) == EVAL_BATCH,
          f"eval {label}: the store holds {store.case_names} / {store.n_samples(case)} samples")

    tic = time.perf_counter()
    values = task.on_eval_end(dm.stats, "val", expensive=True)
    end_s = time.perf_counter() - tic
    peak = torch.cuda.max_memory_allocated() / 2**30
    seconds = {type(m.metric).__name__: m.seconds for m in collection.metrics}
    log(f"  on_eval_end {end_s!r} s ({seconds}); peak memory {peak!r} GiB")
    log(f"  {json.dumps(values)}")
    for name in ("val/tke", "val/tke-front", "val/tke-middle", "val/tke-back", "val/max-mean-tke-pos",
                 "val/wasserstein"):
        check(name in values and math.isfinite(values[name]) and values[name] >= 0, f"eval {label}: {name} = "
              f"{values.get(name)}")

    samples = store.load_samples(batch.metadata)
    n_data = len(dm.val_dataset.repo.times[0])
    data = dm.val_dataset.repo.read(0, np.round(np.linspace(n_data // 2, n_data - 1, EVAL_BATCH)).astype(int))
    checks = {"spectra_card_vs_cpu_max_rel_err": spectra_check(samples, data)}
    if label == EVAL_RUNS[0][0]:
        checks.update(metric_checks(torch, root, dm.stats, data))
    row = {"read_batch_ms": read_ms, "cold_eval_step_1_ddim_step_s": cold_s, "eval_step_s": step_s, **parts,
           "sampler_ms_per_evaluation": parts["sampler_s"] / n_evals * 1e3,
           "on_eval_end_s": end_s, "spectra_s": seconds["WassersteinTKE"], "sinkhorn_s": seconds["WassersteinMetric"],
           "max_mean_tke_s": seconds["MaxMeanTKEPositionMetric"], "peak_gib": peak, "launches": launches,
           "values": {**step, **values}, "checks": checks}
    return launches, row


# Phase 6c, the training entry point: the shapes grid as a .npyd dataset of 1
# train and 1 val case with enough consecutive frames for TF-Net's eval
# window (context 6 + 27 unroll steps = 33).
TRAINER_FRAMES = 36
# Each family's config/shapes_*.yaml as overrides (the card has no PyYAML),
# with the smoke run's cuts: every frame kept (the diffusion file drops the
# first 0.025 s), no point-cloud Wasserstein (phase 6b times it) and no
# plots (the card has no matplotlib).
TRAINER_DDIM_STEPS = 10
TRAINER_CUTS = ["data.discard_first_seconds=-1", "model.compute_expensive_sample_metrics=false",
                "trainer.render_plots=false"]
TRAINER_RUNS = {
    # The paper's run; 2 epochs (trainer.max_steps, set from the data) with
    # a validation after each at DDIM-10, then a resumed third.
    "diffusion": ["model=diffusion", "model.compute_dtype=bfloat16", "model.remat=true", "model.ema_decay=0.999",
                  "model.sampler=ddim", f"model.ddim_steps={TRAINER_DDIM_STEPS}", "data.val_samples=8",
                  "trainer.max_epochs=10",
                  "trainer.check_val_every_n_epoch=1"],
    # Micro-batch 2 x accumulate_steps 3 (the effective batch 6 the file's
    # comment means; its batch_size 2 would give micro-batches of 1), the
    # reference's eval batch 4 (the file's 1 was for a 16 GB chip).
    "tfnet": ["model=tfnet", "model.batch_size=6", "model.accumulate_steps=3", "model.eval_batch_size=4",
              "model.context_window=6", "model.unroll_steps=4", "model.eval_unroll_steps=27",
              "model.sample_steps=[21,25,26]", "model.main_sample_step=25", "model.temporal_filtering_length=4",
              "model.learning_rate=1e-3", "model.max_epochs=20", "model.monitor=val/tke",
              "model.compute_dtype=bfloat16", "data.val_samples=4", "trainer.max_epochs=20", "trainer.max_steps=6"],
    # The rollout cut from 27 steps to 4 (the sample steps with it): a
    # DilResNet trained for 6 steps adds ~sqrt(dx_var) x 4 per step and grows
    # with its input, so by step 27 the spectra overflow f32 and the TKE
    # distance's assignment fails, as the JAX task's would.
    "dilresnet": ["model=dilresnet", "model.batch_size=3", "model.eval_batch_size=4", "model.context_window=1",
                  "model.unroll_steps=1", "model.eval_unroll_steps=4", "model.sample_steps=[2,3,4]",
                  "model.main_sample_step=4", "model.N=4", "model.hidden_dim=48", "model.training_noise_std=1e-3",
                  "model.learning_rate=1e-3", "model.min_learning_rate=1e-6", "model.lr_decay=exp",
                  "model.max_epochs=8", "model.monitor=val/tke", "model.compute_dtype=bfloat16",
                  "data.val_samples=4", "trainer.max_epochs=8", "trainer.max_steps=6"],
}
# U-Net evaluations of one diffusion validation: the eps-loss diagnostics at
# 8 timesteps with the parameters and with the EMA, and DDIM-10 on the one
# val batch of 8.
DIAGNOSTIC_EVALS = 2 * 8
# The baselines' forwards on the card against the CPU: f32, a cut of the
# grid with odd and even extents (TF-Net's stride-2 padding and clipping).
FORWARD_CHECK_GRID = (26, 20, 15)


class TrainerMeter:
    """Wraps a Trainer's task and checkpoint manager: CUDA events around each
    train step, the kernel launches of the steps and of the validations
    apart, the steps' losses and the host seconds of each validation and
    checkpoint save (the card synchronised)."""

    def __init__(self, torch, ck):
        self.torch, self.ck = torch, ck
        self.events, self.losses, self.first_step = [], [], None
        self.launches = {"step": {}, "validation": []}
        self.seconds = {"validation_s": [], "checkpoint_save_s": []}

    def _launches_since(self, before) -> dict:
        return {k: v - before.get(k, 0) for k, v in self.ck.LAUNCH_COUNTS.items()}

    def step(self, task, fn):
        def run(*args, **kwargs):
            if self.first_step is None:
                self.first_step = task.step
            before = dict(self.ck.LAUNCH_COUNTS)
            start, end = (self.torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events.append((start, end))
            self.losses.append(out["train/loss"])
            for k, v in self._launches_since(before).items():
                self.launches["step"][k] = self.launches["step"].get(k, 0) + v
            return out

        return run

    def timed(self, fn, key: str, count: bool = False):
        def run(*args, **kwargs):
            before = dict(self.ck.LAUNCH_COUNTS)
            self.torch.cuda.synchronize()
            tic = time.perf_counter()
            out = fn(*args, **kwargs)
            self.torch.cuda.synchronize()
            self.seconds[key].append(time.perf_counter() - tic)
            if count:
                self.launches["validation"].append(self._launches_since(before))
            return out

        return run

    def step_ms(self) -> list:
        """ms of each step after the first (CUDA events)."""
        self.torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events[1:]]

    def interval_ms(self, n_batches: int) -> list:
        """ms from one step's end to the next's within an epoch (the step and
        any wait for its batch), after the first step."""
        ends = [e for _, e in self.events]
        return [a.elapsed_time(b) for i, (a, b) in enumerate(zip(ends, ends[1:]), start=1)
                if (self.first_step + i) % n_batches]


def run_trainer(torch, ck, family: str, root: Path, out_dir: Path, extra=(), epochs_cap: int = 0) -> dict:
    """``instantiate_data_and_task`` + ``Trainer.fit`` on the card for one
    family's overrides (``epochs_cap``: trainer.max_steps set to that many
    epochs of the data), measured by a ``TrainerMeter``; the checks common
    to the families: finite losses, the files of a run, the monitor."""
    from generative_turbulence_tpu_torch.training.checkpoint import CheckpointManager
    from generative_turbulence_tpu_torch.training.config import parse_cli_overrides
    from generative_turbulence_tpu_torch.training.factory import instantiate_data_and_task
    from generative_turbulence_tpu_torch.training.loop import Trainer

    overrides = TRAINER_RUNS[family] + TRAINER_CUTS + [f"data.root={root}", f"trainer.out_dir={out_dir}", *extra]
    config = parse_cli_overrides(overrides).resolved()
    tic = time.perf_counter()
    dm, task = instantiate_data_and_task(config, "cuda")
    n_batches = dm.n_train_batches()
    if epochs_cap:
        config.trainer.max_steps = epochs_cap * n_batches
    trainer = Trainer(config, task, dm)
    setup_s = time.perf_counter() - tic
    meter, start, epochs, restore_s = TrainerMeter(torch, ck), {}, [], []

    def init_and_keep(init):
        def run(generator):
            out = init(generator)
            start.update({n: p.detach().clone() for n, p in task.net.named_parameters()})
            if getattr(task, "ema", None) is not None:
                start.update({f"ema.{n}": e.clone() for n, e in task.ema.items()})
            return out
        return run

    def train_batches(epoch=0):
        epochs.append(epoch)
        return batches_of(epoch)

    def restore(self, *args, **kwargs):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        out = restore_of(self, *args, **kwargs)
        torch.cuda.synchronize()
        restore_s.append(time.perf_counter() - tic)
        return out

    batches_of, restore_of = dm.train_batches, CheckpointManager.restore
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    tic = time.perf_counter()
    with patched(task, "init_weights", init_and_keep(task.init_weights)), \
            patched(task, "training_step", meter.step(task, task.training_step)), \
            patched(trainer, "validate", meter.timed(trainer.validate, "validation_s", count=True)), \
            patched(trainer.ckpt, "save_last", meter.timed(trainer.ckpt.save_last, "checkpoint_save_s")), \
            patched(trainer.ckpt, "save_best", meter.timed(trainer.ckpt.save_best, "checkpoint_save_s")), \
            patched(dm, "train_batches", train_batches), patched(CheckpointManager, "restore", restore):
        metrics = trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - tic
    trainer.logger.close()
    launches = dict(ck.LAUNCH_COUNTS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [float(v) for v in meter.losses]
    step_ms, interval_ms = meter.step_ms(), meter.interval_ms(n_batches)
    first_step_ms = meter.events[0][0].elapsed_time(meter.events[0][1])
    other_s = (fit_s - (first_step_ms + sum(interval_ms)) / 1e3 - sum(meter.seconds["validation_s"])
               - sum(meter.seconds["checkpoint_save_s"]))

    label = f"{family}{' (resumed)' if any('resume_from' in e for e in extra) else ''}"
    check(all(math.isfinite(v) for v in losses), f"trainer {label}: non-finite loss in {losses}")
    summary = json.loads((out_dir / "summary.json").read_text())
    files = {p.name for p in (out_dir / "checkpoints").iterdir()}
    check((out_dir / "metrics.jsonl").is_file() and {"last.pt", "best.pt", "config.json"} <= files,
          f"trainer {label}: run files {files}")
    check(task.monitor in summary and math.isfinite(metrics.get(task.monitor, math.nan)),
          f"trainer {label}: {task.monitor} = {metrics.get(task.monitor)}, summary {summary}")
    row = {"setup_s": setup_s, "fit_s": fit_s, "n_train_batches": n_batches, "micro_steps": len(losses),
           "first_step": meter.first_step, "epochs": epochs, "final_step": task.step,
           "step_ms": step_ms, "median_step_ms": statistics.median(step_ms) if step_ms else None,
           "first_step_ms": first_step_ms, "step_interval_ms": interval_ms,
           "median_step_interval_ms": statistics.median(interval_ms) if interval_ms else None,
           "other_s": other_s,
           "losses": losses, "validation_s": meter.seconds["validation_s"],
           "checkpoint_save_s": meter.seconds["checkpoint_save_s"], "restore_s": restore_s, "peak_gib": peak,
           "launches": launches, "launches_in_steps": meter.launches["step"],
           "launches_per_validation": meter.launches["validation"],
           "monitor": {task.monitor: metrics[task.monitor]}, "n_params": task.n_params()}
    log(f"  {label}: {len(losses)} micro-steps in {fit_s!r} s (set-up {setup_s!r} s, {n_batches} batches per "
        f"epoch, epochs {epochs}, steps {meter.first_step}..{task.step}); step ms {step_ms!r} (first, cold: "
        f"{first_step_ms!r}; end to end within an epoch {interval_ms!r}); validations "
        f"{row['validation_s']!r} s; checkpoint saves {row['checkpoint_save_s']!r} s; restore {restore_s!r} s; "
        f"the rest of the fit (set-up, restore, waits at epoch ends) {other_s!r} s; "
        f"peak {peak!r} GiB; losses {losses!r}; {task.monitor} {metrics[task.monitor]!r}; launches {launches}")
    return {"row": row, "task": task, "dm": dm, "start": start, "n_batches": n_batches}


def changed_parameters(torch, run: dict, label: str) -> None:
    """Every parameter (and EMA leaf) moved from where the run started."""
    task, start = run["task"], run["start"]
    now = dict(task.net.named_parameters())
    if getattr(task, "ema", None) is not None:
        now.update({f"ema.{n}": e for n, e in task.ema.items()})
    same = [n for n, v in start.items() if torch.equal(now[n].detach(), v)]
    check(len(start) == len(now) and not same, f"trainer {label}: unchanged by training: {same[:8]}")
    log(f"    every one of {len(start)} parameters{' and EMA leaves' if 'ema' in ''.join(start) else ''} changed")


def forward_card_vs_cpu(torch, run: dict, family: str) -> float:
    """The trained baseline in f32 on the card against the same module on
    the CPU (TF32 off), on ``FORWARD_CHECK_GRID`` with the data's cell types
    there; returns the largest absolute difference."""
    import dataclasses

    from generative_turbulence_tpu_torch.data.grid import GridMap

    task = run["task"]
    cfg = dataclasses.replace(task.cfg, compute_dtype="float32")
    nets = {d: type(task)(cfg, run["dm"].stats, d).net for d in ("cpu", "cuda")}
    weights = {k: v.float().cpu() for k, v in task.net.state_dict().items()}
    for net in nets.values():
        net.load_state_dict(weights)
    X, Y, Z = FORWARD_CHECK_GRID
    repo = run["dm"].val_dataset.repo
    grid = GridMap.from_metadata(repo.read_metadata(0), task.variables, device="cpu")
    cell_types = grid.cell_types[:X, :Y, :Z]
    gen = torch.Generator().manual_seed(5)
    shape = (2, cfg.context_window, X, Y, Z, task.n_features) if family == "tfnet" else (2, X, Y, Z, task.n_features)
    x = torch.randn(shape, generator=gen)
    with torch.no_grad():
        want = nets["cpu"](x, cell_types)
        got = nets["cuda"](x.cuda(), cell_types.cuda())
    check(tuple(got.shape) == (2, X, Y, Z, task.n_features), f"{family} forward shape {tuple(got.shape)}")
    return compare_f32(torch, got.cpu(), want, f"{family} forward (f32) on the card vs the CPU at {X}x{Y}x{Z}")


def trainer_phase(torch, ck, root: Path) -> tuple:
    """Phase 6c: the three families through the factory and ``Trainer.fit``
    on the card; the diffusion run killed after 2 epochs and resumed for a
    third.  Returns the launch counts of the diffusion runs and the
    ``trainer`` JSON row."""
    rows = {}
    log(f"[6c] training entry point: instantiate_data_and_task + Trainer.fit; {' '.join(TRAINER_CUTS)}")
    out = root / "runs"

    log(f"  diffusion: {' '.join(TRAINER_RUNS['diffusion'])}")
    first = run_trainer(torch, ck, "diffusion", root, out / "diffusion", epochs_cap=2)
    n = first["n_batches"]
    changed_parameters(torch, first, "diffusion")
    resumed = run_trainer(torch, ck, "diffusion", root, out / "diffusion-resumed", epochs_cap=3,
                          extra=[f"trainer.resume_from={out / 'diffusion' / 'checkpoints'}"])
    r0, r1 = first["row"], resumed["row"]
    check(r0["final_step"] == 2 * n and r0["epochs"] == [0, 1] and len(r0["launches_per_validation"]) == 2,
          f"diffusion: steps {r0['final_step']}, epochs {r0['epochs']}, validations {len(r0['launches_per_validation'])}")
    check(r1["first_step"] == 2 * n and r1["epochs"] == [2] and r1["final_step"] == 3 * n and r1["restore_s"],
          f"diffusion resumed at step {r1['first_step']} (saved {2 * n}), epochs {r1['epochs']}, "
          f"final step {r1['final_step']}")
    log(f"    resumed at the saved step {r1['first_step']} = epoch {r1['first_step'] // n} x {n} batches")
    val_evals = DIAGNOSTIC_EVALS + TRAINER_DDIM_STEPS
    for row in (r0, r1):
        for name in CHAIN_KERNELS:
            want = TRAIN_CHAIN_LAUNCHES * row["micro_steps"]
            check(row["launches_in_steps"][name] == want,
                  f"trainer steps: {name} launched {row['launches_in_steps'][name]} times, expected {want}")
            for counts in row["launches_per_validation"]:
                check(counts[name] == len(ENGAGED_BLOCKS) * val_evals,
                      f"trainer validation: {name} launched {counts[name]} times, expected "
                      f"{len(ENGAGED_BLOCKS) * val_evals}")
        check(row["launches"]["flash_attention"] == 0 and row["launches"]["conv3d_3x3"] == 0,
              f"trainer: flash_attention / conv3d_3x3 launched at 4 levels: {row['launches']}")
    log(f"    launches: {TRAIN_CHAIN_LAUNCHES} per train step and {len(ENGAGED_BLOCKS)} x {val_evals} U-Net "
        f"evaluations per validation for each chain kernel (as expected)")
    rows["diffusion"], rows["diffusion_resumed"] = r0, r1

    for family in ("tfnet", "dilresnet"):
        log(f"  {family}: {' '.join(TRAINER_RUNS[family])}")
        if family == "dilresnet":
            log("    cut: the eval rollout of 27 steps to 4 (an untrained DilResNet's 27-step rollout overflows f32)")
        run = run_trainer(torch, ck, family, root, out / family)
        row, task = run["row"], run["task"]
        changed_parameters(torch, run, family)
        check(not any(row["launches"].values()), f"{family}: a kernel launched on the regression path: "
              f"{row['launches']}")
        if family == "tfnet":
            n_stats = sum(1 for name in run["start"] if name.endswith(("_bn.mean", "_bn.var")))
            check(n_stats == 30 and task.opt_state.count == row["micro_steps"] // 3,
                  f"tfnet: {n_stats} BatchNorm statistics, {task.opt_state.count} updates")
            log(f"    the 30 BatchNorm means and variances among them; {task.opt_state.count} optimizer updates")
        else:
            check(task.n_tracked == row["micro_steps"] and bool(torch.isfinite(task.dx_var).all()),
                  f"dilresnet: n_tracked {task.n_tracked} after {row['micro_steps']} micro-steps")
            row["dx_mean"], row["dx_var"] = task.dx_mean.tolist(), task.dx_var.tolist()
            log(f"    n_tracked {task.n_tracked} = micro-steps; dx_mean {row['dx_mean']}, dx_var {row['dx_var']}")
        row["forward_card_vs_cpu_max_abs_err"] = forward_card_vs_cpu(torch, run, family)
        rows[family] = row
        del run, task
        torch.cuda.empty_cache()
    launches = {k: r0["launches"][k] + r1["launches"][k] for k in r0["launches"]}
    return launches, rows


# Phase 6d, checkpoint evaluation: the port's entry points of
# generative_turbulence_tpu_torch/scripts on the checkpoints phase 6c's runs
# wrote, at full width (the paper's 4-level model, dim 32, val batch 8).
CKPT_EVAL_DDIM_STEPS = 50  # eval_ckpt and evaluate_runtime (the serving setting)
CKPT_EVAL_SHORT_STEPS = 10  # the import round trip, the precisions, the sweep
RUNTIME_REPEATS = 3
FROM_INITIAL_STEPS, FROM_INITIAL_BLOCK = 4, 8  # the cut of 6c's DilResNet validation
SWEEP_CONFIGS = [
    {"name": f"ddim{CKPT_EVAL_SHORT_STEPS}-bf16", "overrides": [f"model.ddim_steps={CKPT_EVAL_SHORT_STEPS}"]},
    {"name": f"ddim{CKPT_EVAL_SHORT_STEPS}-f32",
     "overrides": [f"model.ddim_steps={CKPT_EVAL_SHORT_STEPS}", "model.compute_dtype=float32"]},
]


def turbdiff_checkpoint(torch, ckpt_dir: Path, path: Path) -> dict:
    """A Lightning-style ``turbdiff.ckpt`` at ``path`` of the weights a port
    checkpoint samples with (its EMA where it has one): the ``state_dict``
    under the reference's keys (``to_reference_state_dict``), its
    ``model.betas`` and ``hyper_parameters`` from the embedded config, the
    variables as members of an enum pickled as the reference's
    ``turbdiff.data.ofles.Variable``, so the import needs ``--trust-pickle``
    and no reference source.  Returns the weights written (port names)."""
    import enum
    import types

    from generative_turbulence_tpu_torch.diffusion.schedules import beta_schedule
    from generative_turbulence_tpu_torch.scripts.import_checkpoint import HPARAM_MAP
    from generative_turbulence_tpu_torch.toolchain.import_ckpt import to_reference_state_dict
    from generative_turbulence_tpu_torch.training.checkpoint import CheckpointManager
    from generative_turbulence_tpu_torch.training.config import Config

    mgr = CheckpointManager(ckpt_dir)
    mc = Config.from_json(mgr.config_json).model
    state = mgr.restore("best", map_location="cpu")
    weights = state["ema"] if state["ema"] is not None else state["net"]
    state_dict = to_reference_state_dict(weights, mc.u_net_levels)
    state_dict["model.betas"] = torch.from_numpy(beta_schedule(mc.beta_schedule, mc.timesteps))
    variable = enum.Enum("Variable", {name.strip().upper(): name.strip() for name in mc.variables.split(",")},
                         module="turbdiff.data.ofles")
    hparams = {ref: getattr(mc, ours) for ref, ours in HPARAM_MAP.items()}
    hparams["variables"] = tuple(variable)
    modules = {name: types.ModuleType(name) for name in ("turbdiff", "turbdiff.data", "turbdiff.data.ofles")}
    modules["turbdiff.data.ofles"].Variable = variable
    with mock.patch.dict(sys.modules, modules):
        torch.save({"state_dict": state_dict, "hyper_parameters": hparams}, path)
    return weights


def entry_point_step(torch, ck, row: dict, name: str, main, argv, device="cuda", **kwargs):
    """``main(argv)`` of an entry point (with ``--device`` where ``device`` is
    given) with its standard output kept (the scripts print their JSON
    there), timed on the host clock with the card synchronised; its seconds,
    peak memory and launches go into ``row``."""
    import gc
    import io

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    tic = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        result = main([*map(str, argv), *(["--device", device] if device else [])], **kwargs)
    torch.cuda.synchronize()
    row["seconds"][name] = time.perf_counter() - tic
    row["peak_gib"][name] = torch.cuda.max_memory_allocated() / 2**30
    row["launches"][name] = dict(ck.LAUNCH_COUNTS)
    log(f"  {name}: {row['seconds'][name]!r} s, peak {row['peak_gib'][name]!r} GiB, launches "
        f"{row['launches'][name]}")
    return result


def checkpoint_eval_phase(torch, ck, root: Path, smi: str) -> tuple:
    """Phase 6d: eval_ckpt, sample_metrics, the import round trip,
    evaluate_runtime, evaluate_with_precision, sampler_sweep,
    evaluate_from_initial and evaluate_dataset through their ``main`` on the
    card.  Returns the launches of each step that launches and the
    ``checkpoint_eval`` JSON row."""
    import numpy as np

    from generative_turbulence_tpu_torch.data.schema import read_metadata
    from generative_turbulence_tpu_torch.data.variables import Variable
    from generative_turbulence_tpu_torch.eval.sample_store import SampleStore
    from generative_turbulence_tpu_torch.scripts import (
        eval_ckpt, evaluate_dataset, evaluate_from_initial, evaluate_runtime, evaluate_with_precision,
        import_checkpoint, sample_metrics, sampler_sweep,
    )
    from generative_turbulence_tpu_torch.training.checkpoint import CheckpointManager

    ckpt = root / "runs" / "diffusion" / "checkpoints"
    out = root / "checkpoint_eval"
    out.mkdir()
    row = {"ddim_steps": CKPT_EVAL_DDIM_STEPS, "short_ddim_steps": CKPT_EVAL_SHORT_STEPS, "seconds": {},
           "peak_gib": {}, "launches": {}, "values": {}}
    log(f"[6d] checkpoint evaluation on {ckpt} (phase 6c's paper run, EMA), DDIM-{CKPT_EVAL_DDIM_STEPS} for "
        f"eval_ckpt and evaluate_runtime, DDIM-{CKPT_EVAL_SHORT_STEPS} for the rest")

    step = functools.partial(entry_point_step, torch, ck, row)

    def finite(values: dict, what: str, keys=None) -> None:
        bad = {k: v for k, v in values.items() if (keys is None or k in keys) and not math.isfinite(v)}
        check(not bad and (keys is None or set(keys) <= set(values)), f"{what}: not finite or missing: {bad}")

    def chain_launches(name: str, evaluations: int) -> None:
        counts = row["launches"][name]
        want = dict({k: evaluations * len(ENGAGED_BLOCKS) for k in CHAIN_KERNELS}, flash_attention=0, conv3d_3x3=0,
                    **NO_HALO)
        check(counts == want, f"{name}: launches {counts}, expected {want}")

    cheap = ("val/tke", "val/max-mean-tke-pos")
    # 1. eval_ckpt at DDIM-50 into a .npyd store.
    store_file = out / "samples.npyd"
    metrics = step("eval_ckpt", eval_ckpt.main, [ckpt, store_file, "--which", "best",
                                                 f"model.ddim_steps={CKPT_EVAL_DDIM_STEPS}"])
    store = SampleStore(store_file, (Variable.U, Variable.P))
    n_samples = sum(store.n_samples(case) for case in store.case_names)
    n_batches = n_samples // EVAL_BATCH
    check(n_samples == n_batches * EVAL_BATCH > 0, f"eval_ckpt: {n_samples} samples in the store")
    chain_launches("eval_ckpt", CKPT_EVAL_DDIM_STEPS * n_batches)
    finite(metrics, "eval_ckpt", cheap)
    log(f"    {n_batches} val batch(es) of {EVAL_BATCH}; {CKPT_EVAL_DDIM_STEPS} x {len(ENGAGED_BLOCKS)} launches "
        f"of each chain kernel per batch (as expected); {json.dumps({k: metrics[k] for k in cheap})}")
    row["values"]["eval_ckpt"] = metrics
    row["val_batches"] = n_batches

    # 2. sample_metrics on that store.
    again = step("sample_metrics", sample_metrics.main, [store_file, root / "val", "--prefix", "val"])
    rel = max(abs(again[k] - metrics[k]) / max(abs(metrics[k]), 1e-30) for k in metrics)
    check(again.keys() == metrics.keys() and rel <= 1e-6, f"sample_metrics vs eval_ckpt: {again} vs {metrics}")
    log(f"    sample_metrics equals eval_ckpt's metrics (largest relative difference {rel!r})")
    row["values"]["sample_metrics_max_rel_diff"] = rel

    # 3. The import round trip.
    tic = time.perf_counter()
    weights = turbdiff_checkpoint(torch, ckpt, out / "turbdiff.ckpt")
    row["seconds"]["write_turbdiff_ckpt"] = time.perf_counter() - tic
    imported_dir = out / "imported"
    # The reference's hyper-parameters do not name the U-Net's depth.
    levels = json.loads((ckpt / "config.json").read_text())["model"]["u_net_levels"]
    user = [f"data.root={root}", f"model.u_net_levels={levels}", "data.discard_first_seconds=-1", "data.val_samples=8",
            "model.compute_dtype=bfloat16", "model.sampler=ddim", f"model.ddim_steps={CKPT_EVAL_SHORT_STEPS}",
            f"trainer.out_dir={out / 'imported-run'}"]
    result = step("import_checkpoint", import_checkpoint.main,
                  [out / "turbdiff.ckpt", imported_dir, "--trust-pickle", *user])
    restored = CheckpointManager(imported_dir).restore("best", map_location="cpu")["net"]
    unequal = [k for k in weights if not torch.equal(restored[k], weights[k].cpu())]
    check(restored.keys() == weights.keys() and not unequal, f"import: {len(unequal)} tensors differ: {unequal[:4]}")
    check(result["max_abs_betas_diff"] == 0.0, f"import: max |dbetas| = {result['max_abs_betas_diff']}")
    short = f"model.ddim_steps={CKPT_EVAL_SHORT_STEPS}"
    step("sample_imported", eval_ckpt.main, [imported_dir, out / "imported.npyd"])
    step("sample_source", eval_ckpt.main, [ckpt, out / "source.npyd", short])
    differ = []
    for case in store.case_names:
        meta = read_metadata(root / "val" / case / "data.npyd")
        a, b = (SampleStore(out / f"{n}.npyd", (Variable.U, Variable.P)).load_samples(meta).fields
                for n in ("imported", "source"))
        differ += [f"{case}/{v.key}" for v in a if not np.array_equal(a[v], b[v])]
    check(not differ, f"import: DDIM-{CKPT_EVAL_SHORT_STEPS} samples of the imported and the source checkpoints "
          f"differ: {differ}")
    log(f"    import round trip: {len(weights)} tensors bit-equal, max |dbetas| = 0, "
        f"DDIM-{CKPT_EVAL_SHORT_STEPS} samples bit-equal to the source checkpoint's with the same draws")
    row["values"]["import_tensors"] = len(weights)

    # 4. evaluate_runtime at DDIM-50.
    runtime = step("evaluate_runtime", evaluate_runtime.main,
                   [ckpt, f"model.ddim_steps={CKPT_EVAL_DDIM_STEPS}", "--repeats", RUNTIME_REPEATS])
    chain_launches("evaluate_runtime", CKPT_EVAL_DDIM_STEPS * (1 + RUNTIME_REPEATS) * len(runtime["per_case"]))
    sample_time = runtime["sample_time"]
    row.update(sample_time_s=sample_time, per_case_s=runtime["per_case"],
               samples_per_min=EVAL_BATCH / sample_time * 60)
    log(f"    sample_time (DDIM-{CKPT_EVAL_DDIM_STEPS}, batch {EVAL_BATCH}, bf16, min of {RUNTIME_REPEATS}) "
        f"{sample_time!r} s = {row['samples_per_min']!r} samples/min on {smi}")

    # 5. evaluate_with_precision at DDIM-10, from TF32 switches that no
    # precision leaves behind (matmul on, cuDNN off), which must hold again after.
    before = (True, False)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
    try:
        precisions = step("evaluate_with_precision", evaluate_with_precision.main, [ckpt, short])
        switches = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for precision, values in precisions.items():
        finite(values, f"evaluate_with_precision {precision}", cheap)
    check(list(precisions) == ["default", "high", "highest"] and switches == before,
          f"evaluate_with_precision: {list(precisions)}, TF32 switches {before} before, {switches} afterwards")
    log(f"    val/tke by precision {json.dumps({p: v['val/tke'] for p, v in precisions.items()})}; "
        f"TF32 switches (matmul, cudnn) {before} before and afterwards")
    row["values"]["evaluate_with_precision"] = {p: v["val/tke"] for p, v in precisions.items()}

    # 6. sampler_sweep over two configurations, h5py blocked.
    (out / "sweep.json").write_text(json.dumps(SWEEP_CONFIGS))
    with mock.patch.dict(sys.modules, {"h5py": None}):  # any import of h5py fails inside the sweep
        records = step("sampler_sweep", sampler_sweep.main, [ckpt, "--configs", out / "sweep.json"])
    for record in records:
        finite({k: v for k, v in record.items() if k not in ("name", "which")}, f"sampler_sweep {record['name']}",
               ("val/tke", "fluct-ratio-back", "mean-err-rms"))
    log(f"    sweep (h5py blocked): {json.dumps(records)}")
    row["values"]["sampler_sweep"] = records

    # 7. evaluate_from_initial on phase 6c's DilResNet run.
    from_initial = step("evaluate_from_initial", evaluate_from_initial.main,
                        [root / "runs" / "dilresnet" / "checkpoints", "--steps", FROM_INITIAL_STEPS,
                         "--block-size", FROM_INITIAL_BLOCK, "--out", out / "from-initial.npyd"])
    check(not any(row["launches"]["evaluate_from_initial"].values()),
          f"evaluate_from_initial: a kernel launched: {row['launches']['evaluate_from_initial']}")
    finite(from_initial, "evaluate_from_initial", ("from-initial/tke",))
    log(f"    cut: DilResNet unrolled {FROM_INITIAL_STEPS} steps in a block of {FROM_INITIAL_BLOCK} (6c's "
        f"validation cut); from-initial/tke {from_initial['from-initial/tke']!r}; no launch")
    row["values"]["evaluate_from_initial"] = from_initial

    # 8. evaluate_dataset: the metric floor of real frames.
    floor = step("evaluate_dataset", evaluate_dataset.main, [root, "--samples", EVAL_BATCH])
    finite(floor, "evaluate_dataset", ("floor/tke",))
    log(f"    the floor: floor/tke {floor['floor/tke']!r} (real frames) against val/tke {metrics['val/tke']!r} "
        "(the 2-epoch model)")
    row["values"]["evaluate_dataset"] = floor
    launches = {name: row["launches"][name] for name in ("eval_ckpt", "sample_imported", "sample_source",
                                                         "evaluate_runtime", "evaluate_with_precision",
                                                         "sampler_sweep")}
    return launches, row


# Phase 6e, data parallel: phase 6c's paper run through the training entry
# point (generative_turbulence_tpu_torch.train.main) in processes of their
# own, on 6c's dataset with its val case copied to a second one.  Two
# non-distributed runs (side by side: their spread), two ranks sharing the
# card over gloo under torch.distributed.run, then one rank over NCCL.
DP_STEPS = 4
DP_RUN = TRAINER_RUNS["diffusion"] + TRAINER_CUTS + [
    f"trainer.max_steps={DP_STEPS}", "trainer.max_epochs=1", "trainer.log_every_n_steps=1", "data.shard_eval=true"]
DP_VAL_CASES = ("case-val-00", "case-val-01")
DP_LOSS_TOL = dict(rel=0.06, abs=0.03)  # the bf16 loss tolerance (tests/test_torch_train.py)
# The merged val/tke against the single run's: 2.2e-6 apart in the first card
# run (H100 80GB HBM3, 700 W), two single runs 8.5e-7 apart.
DP_TKE_RTOL = 1e-4
DP_TIMEOUT_S = 300
DP_ALLREDUCE_REPS = 5
# The seeded DDIM-10 sample every rank worker takes after its run (weights
# and draws from these seeds, the first val batch), and the halo exchanges
# timed on the spatial axis, at u_net.down_0's slab.
SAMPLE_SEED, SAMPLE_NOISE_SEED = 5, 6
HALO_REPS = 5
# u_net.down_0's input at the paper's batch (B, X, Y, Z, C): on the spatial
# axis each rank holds an x slab of it.
SP_SLAB = (6, 194, 50, 50, 64)


def rank_worker(out_dir: Path, overrides: list) -> int:
    """``python chip_smoke.py --rank-worker <out_dir> <override> ...``: one
    rank of phase 6e or 6h (or its single process).  Runs the training entry
    point's ``main`` with ``trainer.out_dir=<out_dir>/rank<r>`` and the
    samples in ``<out_dir>/samples``, measuring each train step (CUDA
    events, launches, loss, halo exchanges) and keeping the starting
    parameters (``start.pt``), the first step's all-reduced gradients
    (``grads.pt``; with ``SMOKE_STEP_GRADS=1`` every step's, stacked per
    leaf, in ``step_grads.pt``) and the final parameters (``params.pt``) on
    rank 0; then
    samples the first val batch at DDIM-10 from seeded weights and draws
    (``samples.rank<r>.pt``), times an all-reduce of the gradients' bytes
    (``dp/all_reduce``) and, on a spatial axis, one halo exchange at
    down_0's slab, and writes ``<out_dir>/rank<r>.json``."""
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist
    from torch.profiler import record_function

    from generative_turbulence_tpu_torch import train
    from generative_turbulence_tpu_torch.data.dataset import DataModule
    from generative_turbulence_tpu_torch.diffusion.gaussian import GeneratorNoise
    from generative_turbulence_tpu_torch.ops import cuda_kernels as ck
    from generative_turbulence_tpu_torch.parallel import spatial
    from generative_turbulence_tpu_torch.parallel.distributed import process_rank_and_world
    from generative_turbulence_tpu_torch.parallel.mesh import mesh_layout
    from generative_turbulence_tpu_torch.training.diffusion_task import DiffusionTask

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = int(os.environ.get("RANK", "0"))
    steps = {"events": [], "launches": [], "losses": [], "exchanges": []}
    tasks = []
    training_step = DiffusionTask.training_step
    exchange_apply = spatial._Exchange.apply
    exchanges = [0]
    step_grads = [] if rank == 0 and os.environ.get("SMOKE_STEP_GRADS") == "1" else None

    def counted_exchange(*args):
        exchanges[0] += 1
        return exchange_apply(*args)

    def measured_step(task, cells, grid, noise):
        if not tasks:
            tasks.append(task)
            if rank == 0:
                torch.save({k: v.cpu() for k, v in task.net.state_dict().items()}, out_dir / "start.pt")
        before, exchanges_before = dict(ck.LAUNCH_COUNTS), exchanges[0]
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = training_step(task, cells, grid, noise)
        end.record()
        steps["events"].append((start, end))
        steps["exchanges"].append(exchanges[0] - exchanges_before)
        steps["launches"].append({k: v - before[k] for k, v in ck.LAUNCH_COUNTS.items()})
        steps["losses"].append(out["train/loss"])
        if len(steps["events"]) == 1 and rank == 0:
            torch.save({n: p.grad.float().cpu() for n, p in task.net.named_parameters()}, out_dir / "grads.pt")
        if step_grads is not None:
            step_grads.append({n: p.grad.float().cpu() for n, p in task.net.named_parameters()})
        return out

    ck.reset_launch_counts()
    tic = time.perf_counter()
    with patched(DiffusionTask, "training_step", measured_step), patched(spatial._Exchange, "apply", counted_exchange):
        score = train.main([*overrides, f"trainer.out_dir={out_dir / f'rank{rank}'}",
                            f"trainer.samples_root={out_dir / 'samples'}"])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - tic
    task = tasks[0]
    _, world = process_rank_and_world()
    layout = mesh_layout()
    row = {"rank": rank, "world": world, "backend": dist.get_backend() if dist.is_initialized() else None,
           "mesh": [layout.dp, layout.sp], "dp_index": layout.dp_index, "sp_index": layout.sp_index,
           "device": str(task.device), "card": torch.cuda.get_device_name(task.device),
           "train_net": type(task.train_net).__name__, "fit_s": fit_s,
           "step_ms": [a.elapsed_time(b) for a, b in steps["events"]],
           "launches_per_step": steps["launches"], "launches": dict(ck.LAUNCH_COUNTS),
           "exchanges_per_step": steps["exchanges"],
           "losses": [float(v) for v in steps["losses"]], "monitor": score,
           "peak_gib": torch.cuda.max_memory_allocated(task.device) / 2**30, "n_params": task.n_params(),
           "store_file": task.sample_stores["val"].samples_file.name,
           "store_cases": sorted(task.sample_stores["val"].case_names)}
    if rank == 0:
        torch.save({k: v.cpu() for k, v in task.net.state_dict().items()}, out_dir / "params.pt")
    if step_grads is not None:
        torch.save({n: torch.stack([g[n] for g in step_grads]) for n in step_grads[0]}, out_dir / "step_grads.pt")
        del step_grads
    # The seeded sample: the same weights and draws in every run, so a
    # spatial run's samples are held against one process's.
    root = next(Path(o.split("=", 1)[1]) for o in overrides if o.startswith("data.root="))
    batch = next(iter(DataModule(root, discard_first_seconds=-1, eval_batch_size=8, val_samples=8)
                      .setup("validate").val_batches())).to(task.device)
    task.init_weights(torch.Generator(device=task.device).manual_seed(SAMPLE_SEED))
    task.ema = None
    noise = GeneratorNoise(torch.Generator(device=task.device).manual_seed(SAMPLE_NOISE_SEED), task.device)
    torch.save(task.sample(batch.cells, batch.grid, noise).float().cpu(), out_dir / f"samples.rank{rank}.pt")
    if layout.sp > 1:
        # One halo exchange of u_net.down_0's input slab, forward and backward.
        s, e = layout.axis.slab(SP_SLAB[1])
        x = torch.randn(SP_SLAB[0], e - s, *SP_SLAB[2:5], device=task.device, dtype=torch.bfloat16,
                        requires_grad=True)
        times = {"forward_ms": [], "backward_ms": []}
        for _ in range(HALO_REPS + 1):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            lo, hi = spatial.halo_exchange(x, 1, layout.axis)
            torch.cuda.synchronize()
            mid = time.perf_counter()
            torch.autograd.backward((lo, hi), (torch.ones_like(lo), torch.ones_like(hi)))
            torch.cuda.synchronize()
            times["forward_ms"].append((mid - tic) * 1e3)
            times["backward_ms"].append((time.perf_counter() - mid) * 1e3)
        row["halo_exchange_down_0"] = {k: v[1:] for k, v in times.items()}  # the first is the warm-up
    if dist.is_initialized():
        grads = torch.zeros(task.n_params(), device=task.device)
        dist.all_reduce(grads)
        times = []
        for _ in range(DP_ALLREDUCE_REPS):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            with record_function("dp/all_reduce"):
                dist.all_reduce(grads)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - tic) * 1e3)
        row["allreduce_ms"] = times
        dist.destroy_process_group()
    (out_dir / f"rank{rank}.json").write_text(json.dumps(row))
    return 0


def compute_mode() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60)
    return proc.stdout.strip() or f"unknown ({proc.stderr.strip()})"


def start_runs(root: Path, runs: dict, extra=()) -> dict:
    """Start each run (name -> (launcher arguments, environment)) of the
    rank worker on ``DP_RUN`` and ``extra`` in a session of its own; returns
    name -> (process, log)."""
    started = {}
    for name, (launcher, env) in runs.items():
        out = root / "dp" / name
        out.mkdir(parents=True)
        log_file = open(out / "log.txt", "w+")
        cmd = [sys.executable, *launcher, str(ROOT / "chip_smoke.py"), "--rank-worker", str(out), *DP_RUN,
               f"data.root={root}", *extra]
        started[name] = (subprocess.Popen(cmd, cwd=ROOT, env={**os.environ, **env}, stdout=log_file,
                                          stderr=subprocess.STDOUT, start_new_session=True), log_file)
    return started


def finish_runs(started: dict) -> dict:
    """Wait for the runs (each within ``DP_TIMEOUT_S``), ending every
    process of a run's session that outlives it; a run that fails fails the
    phase.  Returns name -> its output directory."""
    deadline = time.monotonic() + DP_TIMEOUT_S
    failed = []
    try:
        for name, (proc, log_file) in started.items():
            try:
                code = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                code = "timeout"
            if code != 0:
                log_file.seek(0)
                failed.append(f"{name} exited {code}:\n{log_file.read()[-6000:]}")
    finally:
        for proc, log_file in started.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            log_file.close()
    check(not failed, "\n".join(failed))
    return {name: Path(log_file.name).parent for name, (_, log_file) in started.items()}


def rank_rows(out: Path, world: int) -> list:
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]


def param_diffs(torch, a: Path, b: Path) -> dict:
    """Each parameter leaf's relative L2 difference between the final
    parameters of two runs."""
    a, b = (torch.load(out / "params.pt") for out in (a, b))
    return {k: float(torch.linalg.vector_norm(a[k].float() - b[k].float())
                     / torch.linalg.vector_norm(b[k].float()).clamp_min(1e-30)) for k in b}


def param_spread(torch, a: Path, b: Path) -> float:
    """The largest relative L2 difference of a parameter leaf between the
    final parameters of two runs."""
    return max(param_diffs(torch, a, b).values())


def check_rank_steps(rows: list, kernels=CHAIN_KERNELS) -> None:
    """``DP_STEPS`` steps in each run and rank, each launching every chain
    kernel of the path (``kernels``: ``SP_CHAIN_KERNELS`` on a spatial
    axis) ``TRAIN_CHAIN_LAUNCHES`` times and no other kernel."""
    for row in rows:
        check(len(row["losses"]) == DP_STEPS, f"rank {row['rank']}: {len(row['losses'])} steps, not {DP_STEPS}")
        for counts in row["launches_per_step"]:
            for name, n in counts.items():
                want = TRAIN_CHAIN_LAUNCHES if name in kernels else 0
                check(n == want, f"{row['backend']} rank {row['rank']}: {name} launched {n} times in a step, "
                                 f"expected {want}")


def hold_ranks(torch, single: dict, single_out: Path, ranks: list, ranks_out: Path, bound: float, label: str) -> dict:
    """The ranks of a data-parallel run against the single run: the ranks'
    all-reduced losses and merged ``val/tke`` equal; each loss within the
    bf16 loss tolerance of the single run's; the first step's all-reduced
    gradients (cosine >= ``MIN_GRAD_COS``, worst leaf's rel L2 <= ``bound``,
    the gradients x 1.1 refused); ``val/tke`` within ``DP_TKE_RTOL``."""
    r0 = ranks[0]
    check(all(r["losses"] == r0["losses"] and r["monitor"] == r0["monitor"] for r in ranks),
          f"{label}: the ranks' losses or val/tke differ: {[(r['losses'], r['monitor']) for r in ranks]}")
    loss_diff = [abs(x - y) / abs(y) for x, y in zip(r0["losses"], single["losses"])]
    check(all(math.isclose(x, y, rel_tol=DP_LOSS_TOL["rel"], abs_tol=DP_LOSS_TOL["abs"])
              for x, y in zip(r0["losses"], single["losses"])),
          f"{label}: losses {r0['losses']} vs 1 process {single['losses']}")
    want, got = torch.load(single_out / "grads.pt"), torch.load(ranks_out / "grads.pt")
    names = list(want)
    want, got = ([tensors[k].cuda() for k in names] for tensors in (want, got))
    held = grad_agreement(torch, got, want, names)
    scaled = grad_agreement(torch, [1.1 * g for g in got], want, names)
    tke_rel = abs(r0["monitor"] - single["monitor"]) / abs(single["monitor"])
    log(f"  {label} vs 1 process: losses {r0['losses']!r} vs {single['losses']!r} (rel diff {loss_diff!r}); "
        f"first step's all-reduced gradients cos {held['cos']!r}, worst leaf {held['worst_leaf']} rel_l2 "
        f"{held['worst_rel_l2']!r} (bound {bound!r}); x 1.1: {scaled['worst_rel_l2']!r}; merged val/tke "
        f"{r0['monitor']!r} vs {single['monitor']!r}: rel diff {tke_rel!r} (tolerance {DP_TKE_RTOL})")
    check(held["cos"] >= MIN_GRAD_COS, f"{label}: gradient cosine {held['cos']} < {MIN_GRAD_COS}")
    check(held["worst_rel_l2"] <= bound,
          f"{label}: {held['worst_leaf']} gradient rel_l2 {held['worst_rel_l2']} > {bound}")
    check(scaled["worst_rel_l2"] > bound, f"{label}: the gradients x 1.1 pass the bound {bound}")
    check(tke_rel <= DP_TKE_RTOL, f"{label}: val/tke {r0['monitor']} vs 1 process {single['monitor']}")
    return {"gradients": {**held, "bound": bound, "x1.1_worst_rel_l2": scaled["worst_rel_l2"]},
            "loss_rel_diff": loss_diff, "tke_rel_diff": tke_rel}


def data_parallel_phase(torch, ck, root: Path, smi: str) -> tuple:
    """Phase 6e.  Returns the ranks' launches (name -> per rank) and the
    ``distributed`` JSON row."""
    from generative_turbulence_tpu_torch.data.schema import FieldStats
    from generative_turbulence_tpu_torch.training.checkpoint import CheckpointManager
    from generative_turbulence_tpu_torch.training.config import parse_cli_overrides
    from generative_turbulence_tpu_torch.training.diffusion_task import DiffusionTask

    tic = time.perf_counter()
    mode = compute_mode()
    log(f"[6e] data parallel through the entry point (trainer.max_steps={DP_STEPS}, data.shard_eval=true); "
        f"compute mode {mode}")
    check(mode.lower() not in ("exclusive_process", "prohibited"),
          f"the card's compute mode is {mode}: two processes cannot share it")
    shutil.copytree(root / "val" / DP_VAL_CASES[0], root / "val" / DP_VAL_CASES[1])
    torchrun = ["-m", "torch.distributed.run", "--standalone"]
    dist_env = {"GT_DISTRIBUTED": "1"}
    # The single runs and the NCCL rank side by side (their steps share the
    # card), then the two gloo ranks alone (their step times and all-reduce).
    step_grads = {"SMOKE_STEP_GRADS": "1"}  # for phase 6h
    outs = finish_runs(start_runs(root, {"single_a": ([], step_grads), "single_b": ([], step_grads),
                                         "nccl_1": ([*torchrun, "--nproc-per-node", "1"], dist_env)}))
    outs.update(finish_runs(start_runs(root, {"gloo_2": ([*torchrun, "--nproc-per-node", "2"], dist_env)})))
    (a,), (b,), (g0, g1), (n0,) = (rank_rows(outs[name], w) for name, w in
                                   (("single_a", 1), ("single_b", 1), ("gloo_2", 2), ("nccl_1", 1)))

    check(a["backend"] is None and b["backend"] is None and a["train_net"] == "DenoisingModel",
          f"the single runs are in a process group: {a['backend']}, {b['backend']}")
    check(g0["backend"] == g1["backend"] == "gloo" and g0["world"] == g1["world"] == 2
          and g0["device"] == g1["device"] == "cuda:0" and g0["train_net"] == "DistributedDataParallel",
          f"gloo run: {[(r['backend'], r['world'], r['device'], r['train_net']) for r in (g0, g1)]}")
    check(n0["backend"] == "nccl" and n0["world"] == 1 and n0["train_net"] == "DistributedDataParallel",
          f"nccl run: {n0['backend']}, world {n0['world']}, {n0['train_net']}")
    check_rank_steps([a, b, g0, g1, n0])
    log(f"  every run and rank: {TRAIN_CHAIN_LAUNCHES} launches per chain kernel per step (as expected)")

    # Two ranks against one process: losses, gradients (bound: the larger of
    # MAX_GRAD_REL_L2 and 3x the two single runs' difference), the merged
    # val/tke, the stores, the writers, the checkpoint.
    names = list(torch.load(outs["single_a"] / "grads.pt"))
    noise = grad_agreement(torch, *([g[k].cuda() for k in names] for g in
                                    (torch.load(outs[n] / "grads.pt") for n in ("single_b", "single_a"))), names)
    bound = max(MAX_GRAD_REL_L2, 3 * noise["worst_rel_l2"])
    log(f"  two single runs' first-step gradients: cos {noise['cos']!r}, worst leaf {noise['worst_leaf']} rel_l2 "
        f"{noise['worst_rel_l2']!r}")
    held = hold_ranks(torch, a, outs["single_a"], [g0, g1], outs["gloo_2"], bound, "2 ranks (gloo)")
    check((g0["store_file"], g0["store_cases"], g1["store_file"], g1["store_cases"])
          == ("val-samples.npyd", [DP_VAL_CASES[0]], "val-samples.rank1.npyd", [DP_VAL_CASES[1]])
          and a["store_cases"] == list(DP_VAL_CASES),
          f"stores: rank 0 {g0['store_file']} {g0['store_cases']}, rank 1 {g1['store_file']} {g1['store_cases']}")
    rank1_files = sorted(p.name for p in (outs["gloo_2"] / "rank1").glob("*"))
    check(not rank1_files, f"rank 1 wrote {rank1_files}")
    ckpt = CheckpointManager(outs["gloo_2"] / "rank0" / "checkpoints").restore("last")
    cfg = parse_cli_overrides(DP_RUN + [f"data.root={root}"]).resolved()
    task = DiffusionTask(cfg.model, FieldStats.from_file(root / "stats.pickle"), "cuda")
    task.load_state_dict(ckpt)
    check(task.step == DP_STEPS and not any(k.startswith("module.") for k in ckpt["net"])
          and all(torch.equal(task.net.state_dict()[k], v.cuda()) for k, v in ckpt["net"].items()),
          "the 2-rank checkpoint does not restore in one process")
    log(f"  each rank's store holds its own case; rank 1 wrote no run files; the 2-rank checkpoint (step "
        f"{task.step}, no module. prefix) restores in one process")
    del task, ckpt

    # One rank over NCCL against the single runs' own spread (the backward
    # is not deterministic): the parameters within 3x the spread, a figure
    # over 55 M values; the first step's loss, of the same parameters and
    # draws through a deterministic forward, equal where the single runs'
    # are; each later loss, one sample of the run-to-run noise (a two-run
    # spread of 4.4e-5 and of 1.7e-4 in two card runs), at the bf16 loss
    # tolerance.
    spread = {"loss": max(abs(x - y) for x, y in zip(b["losses"], a["losses"])),
              "param_rel_l2": param_spread(torch, outs["single_b"], outs["single_a"])}
    nccl_diff = {"loss": max(abs(x - y) for x, y in zip(n0["losses"], a["losses"])),
                 "param_rel_l2": param_spread(torch, outs["nccl_1"], outs["single_a"])}
    log(f"  1 rank over NCCL vs the single run: {nccl_diff} (the single runs' spread {spread}); first losses "
        f"{n0['losses'][0]!r}, {a['losses'][0]!r}, {b['losses'][0]!r}")
    check(nccl_diff["param_rel_l2"] <= 3 * spread["param_rel_l2"],
          f"the NCCL run's parameters differ from the single run's by {nccl_diff['param_rel_l2']}, beyond 3x the "
          f"spread {spread['param_rel_l2']}")
    check(a["losses"][0] != b["losses"][0] or n0["losses"][0] == a["losses"][0],
          f"the NCCL run's first loss {n0['losses'][0]} differs from the single runs' {a['losses'][0]}")
    check(all(math.isclose(x, y, rel_tol=DP_LOSS_TOL["rel"], abs_tol=DP_LOSS_TOL["abs"])
              for x, y in zip(n0["losses"], a["losses"])), f"NCCL losses {n0['losses']} vs {a['losses']}")

    ranks = {"single": [a], "gloo_2": [g0, g1], "nccl_1": [n0]}
    for name, rows in ranks.items():
        log(f"  {name}: step ms after the first (cold) {[r['step_ms'][1:] for r in rows]!r}, first "
            f"{[r['step_ms'][0] for r in rows]!r}; peak {[r['peak_gib'] for r in rows]!r} GiB; all-reduce of the "
            f"{a['n_params']} gradients {[r.get('allreduce_ms') for r in rows]!r} ms")
    row = {"shared_card": True,
           "note": "two ranks share one card: their step times are no scaling figure; the single runs and the "
                   "NCCL rank ran side by side, the gloo ranks alone",
           "steps": DP_STEPS, "val_cases": list(DP_VAL_CASES),
           "ranks": {name: [{k: r[k] for k in ("rank", "world", "backend", "device", "card", "step_ms", "peak_gib",
                                                "fit_s", "allreduce_ms", "losses", "monitor") if k in r}
                            for r in rows] for name, rows in ranks.items()},
           "single_b": {k: b[k] for k in ("step_ms", "peak_gib", "losses", "monitor")},
           "n_params": a["n_params"], **held, "single_vs_single_gradients": noise, "nccl_vs_single": nccl_diff,
           "single_spread": spread, "card": smi, "phase_s": time.perf_counter() - tic}
    launches = {"gloo_2": [r["launches"] for r in (g0, g1)], "nccl_1": [n0["launches"]],
                "per_step": {name: [r["launches_per_step"] for r in rows] for name, rows in ranks.items()}}
    return launches, row


# Phase 6h, the spatial axis: 6e's paper run at trainer.mesh_shape=[1,2] on two
# gloo ranks sharing the card, held against 6e's single run; the chain conv's
# halo variant at u_net.down_0's slab; graft_entry's dry run on the card.
SP_RUN = ["trainer.mesh_shape=[1,2]"]
SP_KERNEL_REPS = 20
# The same pair of runs, one process and mesh (1, 2), in f32: each leaf's
# change over the DP_STEPS steps held within SP_F32_CHANGE_BOUND of the one
# process's (in bf16 the change is reported beside the single runs').
SP_F32 = ["model.compute_dtype=float32"]
SP_F32_CHANGE_BOUND = 3e-2


def step_agreement(torch, got: dict, want: dict) -> list:
    """Each step's gradients of two runs (``step_grads.pt``: leaf -> steps
    stacked) compared as ``grad_agreement`` does the first step's."""
    names = list(want)
    return [grad_agreement(torch, [got[k][t].cuda() for k in names], [want[k][t].cuda() for k in names], names)
            for t in range(len(want[names[0]]))]


def leaf_steps(torch, got: dict, want: dict, leaf: str) -> dict:
    """One leaf over the steps: each step's gradient relative L2
    difference, and how far ``want``'s steps cancel in their sum (the sum
    of their norms over the norm of their sum; the first DP_STEPS RAdam
    updates are positive combinations of the steps' clipped gradients, so
    a difference of e in each step's gradient may show as up to about e
    times this in the leaf's change)."""
    g, w = got[leaf].double(), want[leaf].double()
    norm = torch.linalg.vector_norm
    return {"leaf": leaf, "step_rel_l2": [float(norm(g[t] - w[t]) / norm(w[t])) for t in range(len(w))],
            "cancellation": float(sum(norm(w[t]) for t in range(len(w))) / norm(w.sum(0)))}


def change_in_ulps(torch, got_out: Path, want_out: Path, leaf: str) -> dict:
    """One leaf's change over each of two runs from the same start in units
    of the f32 spacing (ulp) of its starting values: the share of elements
    left unchanged, the share changed by at most one ulp and the median;
    and the share of elements whose final values differ between the runs
    (a change of a few ulps rounds the optimizer's update to the weights'
    grid, so a small difference in the update can move it by a whole ulp)."""
    start = torch.load(want_out / "start.pt")[leaf].float()
    ends = [torch.load(out / "params.pt")[leaf].float() for out in (got_out, want_out)]
    a = start.abs()
    ulp = (torch.nextafter(a, torch.full_like(a, math.inf)) - a).double()
    out = {"differ": float((ends[0] != ends[1]).double().mean())}
    for name, end in zip(("got", "want"), ends):
        ulps = (end.double() - start.double()).abs() / ulp
        out[name] = {"unchanged": float((ulps == 0).double().mean()), "within_1_ulp": float((ulps <= 1).double().mean()),
                     "median_ulps": float(ulps.median())}
    return out


def change_agreement(torch, got_out: Path, want_out: Path) -> dict:
    """The parameters' change over a run (``params.pt`` less ``start.pt``,
    in f64: the changes are small) against another run's from the same
    start, as ``grad_agreement`` compares gradients, with each leaf's
    relative L2 difference (``leaves``)."""
    start = torch.load(want_out / "start.pt")
    check(all(torch.equal(v, start[k]) for k, v in torch.load(got_out / "start.pt").items()),
          f"{got_out.name} and {want_out.name} start from different parameters")
    got, want = (torch.load(out / "params.pt") for out in (got_out, want_out))
    names = list(want)
    got, want = ([t[k].double() - start[k].double() for k in names] for t in (got, want))
    norm = torch.linalg.vector_norm
    return {**grad_agreement(torch, got, want, names),
            "leaves": {k: float(norm(g - w) / norm(w).clamp_min(1e-30)) for k, g, w in zip(names, got, want)}}


def halo_kernel_rows(torch, ck) -> list:
    """The halo variant of each chain conv at u_net.down_0's slab at sp = 2
    (rank 0's slab has the neighbour's plane after it, rank 1's before it),
    each against its plain twin and the two slabs' outputs against the whole
    grid's conv without a halo (bit-equal); rank 0's slab timed beside the
    conv without a halo on the same slab (in turns), the plain twin, cuDNN's
    bf16 pad + conv + bias over the slab and its halo, and the bound."""
    B, X, Y, Z, C = SP_SLAB
    F = C
    gen = torch.Generator().manual_seed(12)
    bf = torch.bfloat16
    whole = torch.randn(B, X, Y, Z, C, generator=gen).to("cuda", bf)
    w = (torch.randn(3, 3, 3, C, F, generator=gen) * (27 * C) ** -0.5).to("cuda", bf)
    bias = (0.1 * torch.randn(F, generator=gen)).cuda()
    act = ((1 + 0.2 * torch.randn(B, C, generator=gen)).cuda(), (0.2 * torch.randn(B, C, generator=gen)).cuda())
    m = X // 2
    slabs = [(whole[:, :m].contiguous(), (whole[:, :0], whole[:, m : m + 1].contiguous())),
             (whole[:, m:].contiguous(), (whole[:, m - 1 : m].contiguous(), whole[:, :0]))]
    n = m * Y * Z
    rows = []
    for name, a in (("conv3x3x3_stats_halo", None), ("conv3x3x3_stats_silu_in_halo", act)):
        errs = []
        for j, (xs, halo) in enumerate(slabs):
            got, part = ck._conv3x3x3_stats_kernel(xs, w, bias, a, halo)
            want, want_part = ck._conv3x3x3_stats_plain(xs, w, bias, a, halo)
            torch.cuda.synchronize()
            label = f"{name} sp-rank {j} of 2 at down_0's slab B={B} {xs.shape[1]}x{Y}x{Z} {C}->{F}"
            errs.append(compare(torch, got, want, label))
            sums, want_sums = part.sum(1), want_part.sum(1)
            count = xs.shape[1] * Y * Z
            mean, want_mean = sums[:, 0] / count, want_sums[:, 0] / count
            var, want_var = sums[:, 1] / count - mean**2, want_sums[:, 1] / count - want_mean**2
            err = max(float(((mean - want_mean).abs() / want_var.sqrt()).max()),
                      float(((var - want_var).abs() / want_var).max()))
            check(err < 1e-3, f"{label}: channel moments off by {err}")
            again, again_part = ck._conv3x3x3_stats_kernel(xs, w, bias, a, halo)
            check(torch.equal(got, again) and torch.equal(part, again_part), f"{label}: a second run differs")
            del want, want_part, again, again_part
        parts = [ck._conv3x3x3_stats_kernel(xs, w, bias, a, halo)[0] for xs, halo in slabs]
        full = ck._conv3x3x3_stats_kernel(whole, w, bias, a)[0]
        check(torch.equal(torch.cat(parts, dim=1), full), f"{name}: the slabs' outputs differ from the whole grid's")
        del parts, full
        xs, halo = slabs[0]
        run = functools.partial(ck._conv3x3x3_stats_kernel, xs, w, bias, a, halo)
        no_halo = functools.partial(ck._conv3x3x3_stats_kernel, xs, w, bias, a)
        run_plain = functools.partial(ck._conv3x3x3_stats_plain, xs, w, bias, a, halo)
        cudnn = lambda: ck._conv3d_replicate(xs, w, halo) + bias.to(bf)  # noqa: E731
        ms, plain, cudnn_ms = cuda_ms(torch, run, SP_KERNEL_REPS), cuda_ms(torch, run_plain, 5), cuda_ms(torch, cudnn, 10)
        over_no_halo = paired_ratio(torch, no_halo, run, 10)
        no_halo_ms = cuda_ms(torch, no_halo, SP_KERNEL_REPS)
        flop = 2 * B * n * 27 * C * F
        n_bricks = ck.conv_n_bricks(m, Y, Z, ck.conv_brick(ck.conv_tiling(C, F)[0]))
        # As the conv without a halo, plus the neighbour's plane read once.
        moved = (2 * B * n * (C + F) + 2 * 27 * C * F + 4 * F + 8 * B * n_bricks * F
                 + (8 * B * C if a is not None else 0) + 2 * B * Y * Z * C)
        bnd = bound(moved, **{"bf16 tensor FLOP": flop})
        log(f"    {name}: kernel {ms!r} ms ({flop / ms / 1e9!r} TFLOP/s; bound {bnd['bound_ms']!r} ms, "
            f"{bnd['bound_kind']}), without a halo on the same slab {no_halo_ms!r} ms (halo / none in turns "
            f"{over_no_halo!r}), plain twin {plain!r} ms, cuDNN bf16 pad+conv+bias {cudnn_ms!r} ms")
        rows.append({"name": name, "route": "cuda", "source": "generative_turbulence_tpu_torch/csrc/fused_double_conv.cu",
                     "replaces": f"{PALLAS}:463" if a is None else f"{PALLAS}:562",
                     "also_replaces": f"{PALLAS}:251", "launches": 0, "max_abs_err": max(errs), "ms": ms,
                     "plain_ms": plain, **bnd, "library_ms": cudnn_ms,
                     "library": "cuDNN bf16 replicate pad + conv3d + bias over the slab and its halo plane",
                     "shape": [B, m, Y, Z, C, F], "no_halo_ms": no_halo_ms, "halo_over_no_halo_in_turns": over_no_halo})
    del whole, slabs
    return rows


def spatial_phase(torch, ck, root: Path, smi: str, dp_row: dict) -> tuple:
    """Phase 6h, on 6e's dataset and beside 6e's single run.  Returns the
    halo variants' kernel entries, the ranks' launches and the ``spatial``
    JSON row."""
    tic = time.perf_counter()
    log("[6h] the chain conv's halo variant at u_net.down_0's slab at sp = 2, against its plain twin")
    kernel_rows = halo_kernel_rows(torch, ck)
    log(f"[6h] the paper's run at trainer.mesh_shape=[1,2]: 2 gloo ranks sharing the card "
        f"(trainer.max_steps={DP_STEPS})")
    torchrun = ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2"]
    outs = finish_runs(start_runs(root, {"sp_1x2": (torchrun, {"GT_DISTRIBUTED": "1", "SMOKE_STEP_GRADS": "1"})},
                                  SP_RUN))
    single_out, sp_out = root / "dp" / "single_a", outs["sp_1x2"]
    (a,), ranks = rank_rows(single_out, 1), rank_rows(sp_out, 2)
    check(all(r["backend"] == "gloo" and r["world"] == 2 and r["device"] == "cuda:0" and r["mesh"] == [1, 2]
              and r["train_net"] == "DistributedDataParallel" for r in ranks)
          and [r["sp_index"] for r in ranks] == [0, 1],
          f"sp run: {[(r['backend'], r['world'], r['device'], r['mesh'], r['sp_index']) for r in ranks]}")
    check_rank_steps(ranks, SP_CHAIN_KERNELS)
    log(f"  both ranks: {TRAIN_CHAIN_LAUNCHES} launches per step of {', '.join(SP_CHAIN_KERNELS)} and none of the "
        f"convs without a halo (as expected)")
    held = hold_ranks(torch, a, single_out, ranks, sp_out, dp_row["gradients"]["bound"], "mesh (1, 2)")

    # Every step's gradients, not only the first, against the single run's:
    # each step within the gradient bound (the larger of 3e-2 and 3x two
    # single runs' worst leaf at that step).  The parameters within the
    # first step's gradient bound: the runs start equal, so a leaf's
    # difference after the steps is that of its updates, positive
    # combinations of the steps' clipped gradients, and it shows in full in
    # a leaf that starts at zero (a bias).  6e's rule for its NCCL rank, 3x
    # the single runs' spread, holds a rank that computes what one process
    # computes; the sp path rounds elsewhere (an f32 resize, moments summed
    # over the group), and its parameters stood at 2.3-3.0x that spread in
    # five card runs (PERF.md, PR 12), so that figure is reported.
    grads = {name: torch.load(root / "dp" / name / "step_grads.pt") for name in ("single_a", "single_b")}
    grads["sp"] = torch.load(sp_out / "step_grads.pt")
    steps_held, steps_noise = (step_agreement(torch, grads[n], grads["single_a"]) for n in ("sp", "single_b"))
    step_bounds = [max(MAX_GRAD_REL_L2, 3 * n["worst_rel_l2"]) for n in steps_noise]
    log(f"  each step's gradients vs the single run's: cos {[h['cos'] for h in steps_held]!r}, worst leaf "
        f"{[(h['worst_leaf'], h['worst_rel_l2']) for h in steps_held]!r} (bounds {step_bounds!r}; two single runs "
        f"{[(n['worst_leaf'], n['worst_rel_l2']) for n in steps_noise]!r})")
    for t, (h, b) in enumerate(zip(steps_held, step_bounds)):
        check(h["cos"] >= MIN_GRAD_COS and h["worst_rel_l2"] <= b,
              f"mesh (1, 2) step {t + 1}: gradient cos {h['cos']}, {h['worst_leaf']} rel_l2 {h['worst_rel_l2']} > {b}")
    diffs = param_diffs(torch, sp_out, single_out)
    param_leaf = max(diffs, key=diffs.get)
    param_diff, param_bound = diffs[param_leaf], dp_row["gradients"]["bound"]
    start_norm = float(torch.linalg.vector_norm(torch.load(single_out / "start.pt")[param_leaf].float()))
    log(f"  parameters vs the single run's: worst leaf {param_leaf} rel_l2 {param_diff!r} (its starting norm "
        f"{start_norm!r}; bound {param_bound!r}; 3x the single runs' spread "
        f"{3 * dp_row['single_spread']['param_rel_l2']!r})")

    # The parameters' change over the steps: in bf16 reported, with its worst
    # leaf's steps; in f32 (one process and mesh (1, 2) side by side) each
    # leaf held within SP_F32_CHANGE_BOUND.
    change = change_agreement(torch, sp_out, single_out)
    change_noise = change_agreement(torch, root / "dp" / "single_b", single_out)
    worst = change["worst_leaf"]
    worst_steps = {n: leaf_steps(torch, grads[n], grads["single_a"], worst) for n in ("sp", "single_b")}
    worst_steps["ulps"] = change_in_ulps(torch, sp_out, single_out, worst)
    del grads
    log(f"  their change over {DP_STEPS} bf16 steps: cos {change['cos']!r}, worst leaf {worst} rel_l2 "
        f"{change['worst_rel_l2']!r} (two single runs: cos {change_noise['cos']!r}, worst leaf "
        f"{change_noise['worst_leaf']} {change_noise['worst_rel_l2']!r}; {worst} {change_noise['leaves'][worst]!r}); "
        f"{worst}'s steps: {worst_steps!r}")
    check(param_diff <= param_bound, f"mesh (1, 2): {param_leaf} {param_diff} from the single run's, beyond {param_bound}")
    log(f"[6h] the same pair at {' '.join(SP_F32)}: one process and mesh (1, 2) side by side")
    f32_env = {"SMOKE_STEP_GRADS": "1"}
    f32_outs = finish_runs({**start_runs(root, {"single_f32": ([], f32_env)}, SP_F32),
                            **start_runs(root, {"sp_f32": (torchrun, {**f32_env, "GT_DISTRIBUTED": "1"})},
                                         [*SP_RUN, *SP_F32])})
    (f1,), f_ranks = rank_rows(f32_outs["single_f32"], 1), rank_rows(f32_outs["sp_f32"], 2)
    check([r["mesh"] for r in (f1, *f_ranks)] == [[1, 1], [1, 2], [1, 2]], "the f32 runs' meshes")
    check_rank_steps([f1])
    check_rank_steps(f_ranks, SP_CHAIN_KERNELS)
    f32_grads = {n: torch.load(f32_outs[n] / "step_grads.pt") for n in ("single_f32", "sp_f32")}
    f32 = {"losses": [f1["losses"], f_ranks[0]["losses"]],
           "steps": step_agreement(torch, f32_grads["sp_f32"], f32_grads["single_f32"]),
           "change": change_agreement(torch, f32_outs["sp_f32"], f32_outs["single_f32"]),
           "bf16_worst_leaf_steps": leaf_steps(torch, f32_grads["sp_f32"], f32_grads["single_f32"], worst),
           "bf16_worst_leaf_ulps": change_in_ulps(torch, f32_outs["sp_f32"], f32_outs["single_f32"], worst)}
    del f32_grads
    f32["bf16_worst_leaf_change_rel_l2"] = f32["change"]["leaves"][worst]
    log(f"  f32 losses {f32['losses'][1]!r} vs one process {f32['losses'][0]!r}; each step's gradients: worst leaf "
        f"{[(h['worst_leaf'], h['worst_rel_l2']) for h in f32['steps']]!r}; the change over {DP_STEPS} steps: cos "
        f"{f32['change']['cos']!r}, worst leaf {f32['change']['worst_leaf']} rel_l2 "
        f"{f32['change']['worst_rel_l2']!r} (bound {SP_F32_CHANGE_BOUND}), {worst} "
        f"{f32['bf16_worst_leaf_change_rel_l2']!r}, its steps {f32['bf16_worst_leaf_steps']!r}, its change in ulps "
        f"{f32['bf16_worst_leaf_ulps']!r}")
    check(all(math.isclose(x, y, rel_tol=2e-4) for x, y in zip(*f32["losses"])),
          f"f32 mesh (1, 2) losses {f32['losses'][1]} vs one process {f32['losses'][0]}")
    check(f32["change"]["worst_rel_l2"] <= SP_F32_CHANGE_BOUND,
          f"f32 mesh (1, 2): {f32['change']['worst_leaf']}'s change over {DP_STEPS} steps differs from one "
          f"process's by {f32['change']['worst_rel_l2']} > {SP_F32_CHANGE_BOUND}")
    for c in (change, change_noise, f32["change"]):
        del c["leaves"]

    peaks = [r["peak_gib"] for r in ranks]
    log(f"  peak per rank {peaks!r} GiB against the single run's {a['peak_gib']!r} GiB")
    check(max(peaks) < a["peak_gib"], f"peak per rank {peaks} GiB is not below one process's {a['peak_gib']} GiB")

    want = torch.load(single_out / "samples.rank0.pt").cuda()
    got = [torch.load(sp_out / f"samples.rank{r}.pt").cuda() for r in range(2)]
    check(torch.equal(got[0], got[1]), "the sp ranks' samples differ")
    # Held to the output's scale: the seeded net is untrained, and its samples
    # grow far beyond the plain atol through the sampler.
    sample_err = compare(torch, got[0], want, f"DDIM-{TRAINER_DDIM_STEPS} samples at mesh (1, 2) vs one process",
                         scaled=True)

    exchange = {k: [r["halo_exchange_down_0"][k] for r in ranks] for k in ("forward_ms", "backward_ms")}
    per_step = [sorted(set(r["exchanges_per_step"])) for r in ranks]
    log(f"  step ms per rank after the first (cold) {[r['step_ms'][1:] for r in ranks]!r} (6e's single run "
        f"{a['step_ms'][1:]!r}); one halo exchange at down_0's slab, forward {exchange['forward_ms']!r} ms, backward "
        f"{exchange['backward_ms']!r} ms; exchanges per step {per_step}")

    log("[6h] graft_entry.dryrun_multichip(2) on the card")
    dry_tic = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", "from generative_turbulence_tpu_torch import graft_entry as g; "
                           "g.dryrun_multichip(2)"], cwd=ROOT, capture_output=True, text=True, timeout=DP_TIMEOUT_S)
    dry_s = time.perf_counter() - dry_tic
    dry = next((line for line in proc.stdout.splitlines() if line.startswith("dryrun_multichip ok:")), None)
    check(proc.returncode == 0 and dry is not None and "mesh=(1x2) devices=2" in dry,
          f"dryrun_multichip(2) exited {proc.returncode}: {proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    log(f"  {dry} ({dry_s!r} s)")

    row = {"mesh": [1, 2], "shared_card": True, "steps": DP_STEPS,
           "note": "two ranks share one card: their step times are no scaling figure",
           "ranks": [{k: r[k] for k in ("rank", "sp_index", "backend", "device", "step_ms", "peak_gib", "fit_s",
                                        "losses", "monitor", "exchanges_per_step", "halo_exchange_down_0")}
                     for r in ranks],
           "single": {k: a[k] for k in ("step_ms", "peak_gib", "losses", "monitor")},
           **held, "step_gradients": steps_held, "step_gradients_single_vs_single": steps_noise,
           "step_gradient_bounds": step_bounds, "param_rel_l2": param_diff, "param_leaf": param_leaf,
           "param_leaf_start_norm": start_norm, "param_bound": param_bound,
           "param_change": {**change, "single_vs_single": change_noise, "worst_leaf_steps": worst_steps},
           "f32": {**f32, "change_bound": SP_F32_CHANGE_BOUND},
           "samples_max_abs_err": sample_err, "dryrun": dry, "dryrun_s": dry_s,
           "kernels": [{k: r[k] for k in ("name", "ms", "no_halo_ms", "halo_over_no_halo_in_turns", "plain_ms",
                                          "bound_ms", "library_ms", "max_abs_err")} for r in kernel_rows],
           "card": smi, "phase_s": time.perf_counter() - tic}
    launches = {"ranks": [r["launches"] for r in ranks], "per_step": [r["launches_per_step"] for r in ranks]}
    return kernel_rows, launches, row


# Phase 6f, the study scripts: the port's study entry points of
# generative_turbulence_tpu_torch/scripts on what phases 6c-6e leave behind
# (6e's dataset with its two val cases, 6c's runs, 6d's eval_ckpt store).
# profile_fwd at the bench workload (its own shapes case, batch 8, bf16):
# 3 forwards, and one DDIM call of 2 steps, each after one warm-up call.
PROFILE_RUNS = {"fwd": ["--mode", "fwd", "--iters", "3"], "ddim": ["--mode", "ddim", "--probe", "2", "--iters", "1"]}
TRIVIAL_RTOL = 1e-4  # the card against the CPU, and against scipy's gaussian_filter
TRIVIAL_FRAMES = 8
DEGENERATE_RTOL = 1e-3  # the sample metrics' tolerance (tests/test_torch_eval.py)
DEGENERATE_SAMPLES = 4
# The mean baseline's samples are one flow repeated, so its TKE profile is 0
# in exact arithmetic: the port reports its max-mean-tke-pos as undefined
# (NaN), where the argmax of rounding noise once gave 7225.0 on the card and
# 900.0 on the CPU.  It must be NaN on both; the rest is compared.
UNDEFINED = ("mean", "max-mean-tke-pos")
TKE_PROFILE_RTOL = 1e-4
CALIBRATION_SWEEP = "0.02:300,0.005:1200"  # the JAX script's default, then the metric's own setting
STUDY_FAMILIES = ("diffusion", "tfnet", "dilresnet")
# One real sweep combination: the paper's run for 2 steps and one validation
# (its sampler cut to DDIM-2), in a process of its own.
STUDY_SWEEP_RUN = TRAINER_RUNS["diffusion"] + TRAINER_CUTS + [
    "trainer.max_steps=2", "trainer.max_epochs=1", "trainer.log_every_n_steps=1", "model.ddim_steps=2"]
STUDY_SWEEP_TIMEOUT_S = 300


def worst_rel_diff(got, want) -> float:
    """The largest relative difference between the numbers of two nested
    dicts/lists of one structure (0 where both are 0)."""
    if isinstance(want, dict):
        check(isinstance(got, dict) and got.keys() == want.keys(), f"keys {sorted(got)} vs {sorted(want)}")
        return max((worst_rel_diff(got[k], want[k]) for k in want), default=0.0)
    if isinstance(want, list):
        check(isinstance(got, list) and len(got) == len(want), f"lengths {len(got)} vs {len(want)}")
        return max((worst_rel_diff(a, b) for a, b in zip(got, want)), default=0.0)
    if want is None or isinstance(want, (str, bool)):
        check(got == want, f"{got!r} vs {want!r}")
        return 0.0
    check(math.isfinite(got) and math.isfinite(want), f"not finite: {got!r} vs {want!r}")
    return abs(got - want) / abs(want) if want else abs(got)


def study_scripts_phase(torch, ck, root: Path, smi: str, unet_fwd_ms: float) -> tuple:
    """Phase 6f: profile_fwd, trivial_baselines, degenerate_baselines,
    calibrate_sinkhorn, tke_profile, summarize_run, diagnose_trajectory,
    compare_runs and sweep through their entry points on the card.  Returns
    profile_fwd's launches by mode and the ``study_scripts`` JSON row."""
    import numpy as np
    from scipy.ndimage import gaussian_filter

    from generative_turbulence_tpu_torch.data.schema import CaseRepository
    from generative_turbulence_tpu_torch.data.variables import Variable
    from generative_turbulence_tpu_torch.scripts import (
        calibrate_sinkhorn, compare_runs, degenerate_baselines, diagnose_trajectory, profile_fwd, summarize_run,
        sweep, tke_profile, trivial_baselines,
    )

    tic = time.perf_counter()
    out = root / "study"
    out.mkdir()
    row = {"seconds": {}, "peak_gib": {}, "launches": {}, "profile_fwd": {}, "values": {},
           "phase_4_unet_evaluation_ms": unet_fwd_ms}
    log(f"[6f] study scripts on phases 6c-6e's dataset ({', '.join(p.name for p in sorted((root / 'val').iterdir()))}), "
        "runs and store")
    step = functools.partial(entry_point_step, torch, ck, row)

    # 1. profile_fwd: the chain kernels 4 times per U-Net evaluation, the
    # categories adding up to the kernels' total.
    launches = {}
    for mode, argv in PROFILE_RUNS.items():
        name = f"profile_fwd_{mode}"
        result = step(name, profile_fwd.main, [*argv, "--batch", BATCH, "--dtype", "bfloat16",
                                              "--out", out / f"profile-{mode}.json"])
        per_call = result["probe"] if mode == "ddim" else 1
        n_unet = result["iters"] * per_call
        evaluations = n_unet + per_call  # the warm-up call counts too
        counts = launches[mode] = row["launches"][name]
        want = dict({k: evaluations * len(ENGAGED_BLOCKS) for k in CHAIN_KERNELS}, flash_attention=0, conv3d_3x3=0,
                    **NO_HALO)
        check(counts == want, f"{name}: launches {counts}, expected {want} ({evaluations} U-Net evaluations)")
        entry = next((v for v in result.values() if isinstance(v, dict)), None)
        check(entry is not None, f"{name}: no device entry in {result}")
        total = sum(c["ms_per_eval"] for c in entry["categories"]) * n_unet
        groups = {c["category"]: c["ms_per_eval"] for c in entry["categories"]}
        check(abs(total - entry["total_ms"]) <= 0.01 * entry["total_ms"],
              f"{name}: the categories add up to {total} ms, the kernels to {entry['total_ms']} ms")
        check(groups.get("chain convs", 0.0) > 0, f"{name}: no chain conv time in {groups}")
        row["profile_fwd"][mode] = {
            "iters": result["iters"], "unet_evaluations": n_unet, "wall_s": result["wall_s"],
            "ms_per_unet_incl_host": result["ms_per_unet_incl_host"],
            "device_ms_per_eval": entry["total_ms"] / n_unet, "busy_ms_per_eval": entry["busy_ms_per_eval"],
            "idle_share": entry["idle_share"], "categories": entry["categories"], "top_events": entry["top_events"][:8],
            "launches_per_unet_evaluation": {k: v / evaluations for k, v in counts.items()}}
        log(f"    {mode}: {len(ENGAGED_BLOCKS)} launches per chain kernel per U-Net evaluation ({evaluations} evaluations, as expected); "
            f"{entry['total_ms'] / n_unet!r} ms of kernels and {result['ms_per_unet_incl_host']!r} ms of wall per "
            f"evaluation (phase 4: {unet_fwd_ms!r} ms by CUDA events); idle share {entry['idle_share']!r}; "
            f"{json.dumps(groups)}")

    # 2. trivial_baselines, the card against the CPU and its smoothing
    # against scipy on one frame.
    card = step("trivial_baselines", trivial_baselines.main, [root, "--frames", TRIVIAL_FRAMES])
    cpu = step("trivial_baselines_cpu", trivial_baselines.main, [root, "--frames", TRIVIAL_FRAMES], device="cpu")
    rel = worst_rel_diff(card, cpu)
    check(rel <= TRIVIAL_RTOL, f"trivial_baselines: the card off the CPU by {rel} (rtol {TRIVIAL_RTOL})")
    repo = CaseRepository([root / "val" / "case-val-00" / "data.npyd"], (Variable.U,))
    meta = repo.read_metadata(0)
    X, Y, Z = (int(c) for c in meta.cell_counts)
    dense = np.zeros((1, X * Y * Z, 3), np.float32)
    dense[:, meta.cell_idx] = repo.read(0, [0]).fields[Variable.U]
    dense = dense.reshape(1, X, Y, Z, 3)
    got = trivial_baselines.gaussian_smooth(torch.as_tensor(dense, device="cuda"), 1.0).cpu().numpy()
    want = gaussian_filter(dense, sigma=(0, 1.0, 1.0, 1.0, 0))
    scipy_err = float(np.abs(got - want).max())
    check(np.allclose(got, want, rtol=TRIVIAL_RTOL, atol=0), f"gaussian_smooth on the card off scipy by {scipy_err}")
    log(f"    the card within {rel!r} of the CPU (rtol {TRIVIAL_RTOL}); the smoothing of one frame "
        f"({X}x{Y}x{Z}x3) against scipy's gaussian_filter: max abs error {scipy_err!r}; {json.dumps(card['summary'])}")
    row["values"].update(trivial_baselines=card["summary"], trivial_card_vs_cpu=rel, smoothing_vs_scipy=scipy_err)

    # 3. degenerate_baselines, the card against the CPU.
    baselines_json = out / "degenerate-baselines.json"
    argv = [root, "--samples", DEGENERATE_SAMPLES]
    card = step("degenerate_baselines", degenerate_baselines.main, [*argv, "--out", baselines_json])
    cpu = step("degenerate_baselines_cpu", degenerate_baselines.main, [*argv, "--out", out / "degenerate-cpu.json"],
               device="cpu")

    def defined(metrics: dict) -> dict:
        return {name: {k: v for k, v in values.items() if not (name == UNDEFINED[0] and k.endswith(UNDEFINED[1]))}
                for name, values in metrics.items()}

    rel = worst_rel_diff(defined(card), defined(cpu))
    check(rel <= DEGENERATE_RTOL, f"degenerate_baselines: the card off the CPU by {rel} (rtol {DEGENERATE_RTOL})")
    undefined = {k: [v, cpu[UNDEFINED[0]][k]] for k, v in card[UNDEFINED[0]].items() if k.endswith(UNDEFINED[1])}
    check(len(undefined) >= 2 and all(math.isnan(v) for pair in undefined.values() for v in pair),
          f"the mean baseline's {UNDEFINED[1]} (card, CPU): {undefined}, expected NaN (undefined) on both")
    tkes = {name: card[name][f"{name}/tke"] for name in card}
    log(f"    the card within {rel!r} of the CPU (rtol {DEGENERATE_RTOL}), {UNDEFINED[1]} among them; the mean "
        f"baseline's (one flow repeated) undefined on both (card, CPU): {json.dumps(undefined)}; "
        f"tke {json.dumps(tkes)}")
    row["values"].update(degenerate_baselines_tke=tkes, degenerate_card_vs_cpu=rel,
                         degenerate_mean_max_mean_tke_pos_card_cpu={k: [None, None] for k in undefined})

    # 4. calibrate_sinkhorn over 4 regions of 4 samples.
    cal = step("calibrate_sinkhorn", calibrate_sinkhorn.main,
               [root, "--case", "val/case-val-00", "--max-regions", 4, "--samples", 4, "--workers", 1,
                "--sweep", CALIBRATION_SWEEP, "--out", out / "sinkhorn-calibration.json"])
    for entry in cal["sinkhorn"]:
        check(entry["relative_error"] is not None and entry["relative_error"] <= SINKHORN_REL_TOL,
              f"calibrate_sinkhorn: reg {entry['reg']} iters {entry['iters']} off the exact EMD by "
              f"{entry['relative_error']} (bound {SINKHORN_REL_TOL})")
    log(f"    exact {cal['exact']['wasserstein']!r} ({cal['exact']['seconds']!r} s); "
        + "; ".join(f"reg {e['reg']} x {e['iters']}: {e['wasserstein']!r}, relative error {e['relative_error']!r} "
                    f"({e['seconds']!r} s)" for e in cal["sinkhorn"]) + f" (bound {SINKHORN_REL_TOL})")
    row["values"]["calibrate_sinkhorn"] = cal

    # 5. tke_profile on 6d's eval_ckpt store, the card against the CPU.
    store = root / "checkpoint_eval" / "samples.npyd"
    card = step("tke_profile", tke_profile.main, [store, root / "val", "--out", out / "tke-profile"])
    cpu = step("tke_profile_cpu", tke_profile.main, [store, root / "val", "--out", out / "tke-profile-cpu"],
               device="cpu")
    rel = worst_rel_diff({c: {k: v for k, v in d.items() if k in ("samples", "data")} for c, d in card.items()},
                         {c: {k: v for k, v in d.items() if k in ("samples", "data")} for c, d in cpu.items()})
    argmaxes = {c: [d["argmax_samples"], d["argmax_data"], d["gt_pos"]] for c, d in card.items()}
    check(card and rel <= TKE_PROFILE_RTOL and argmaxes == {c: [d["argmax_samples"], d["argmax_data"], d["gt_pos"]]
                                                             for c, d in cpu.items()},
          f"tke_profile: the card off the CPU by {rel}, argmaxes {argmaxes} vs the CPU's")
    log(f"    the profiles within {rel!r} of the CPU's, equal argmaxes (samples, data, gt): {argmaxes}")
    row["values"].update(tke_profile_argmaxes=argmaxes, tke_profile_card_vs_cpu=rel)

    # 6. The host tools on 6c's runs.
    summaries = {}
    for family in STUDY_FAMILIES:
        summaries[family] = step(f"summarize_run_{family}", summarize_run.main,
                                 [root / "runs" / family, out / "summaries" / family], device=None)
    trajectory = step("diagnose_trajectory", diagnose_trajectory.main,
                      [root / "runs" / "diffusion", "--out", out / "trajectory"], device=None)
    check(len(trajectory["validations"]) == len(summaries["diffusion"]["trajectory"]) > 0
          and (out / "trajectory.json").is_file(), f"diagnose_trajectory: {len(trajectory['validations'])} validations")
    comparison = step("compare_runs", compare_runs.main,
                      [*(f"{f}={out / 'summaries' / f}" for f in STUDY_FAMILIES), "--out", out / "comparison",
                       "--baselines", baselines_json], device=None)
    models = [r["model"] for r in comparison["models"]]
    check(models == list(STUDY_FAMILIES) and set(comparison["degenerate_baselines_mean_val_tke"]) == set(tkes)
          and (out / "comparison.md").is_file(), f"compare_runs: models {models}, baselines "
          f"{comparison['degenerate_baselines_mean_val_tke']}")
    log(f"    compare_runs: {len(models)} model rows, best val/tke "
        f"{json.dumps({r['model']: r['best_val_tke'] for r in comparison['models']})}")
    step("sweep_slurm", sweep.main, ["--slurm", "--sweep", "trainer.seed=0,1", "--out", out / "slurm",
                                     f"data.root={root}"])
    lines = (out / "slurm" / "sweep-cmds.txt").read_text().splitlines()
    check(len(lines) == 2 and all(f"-m {sweep.MODULE} --device cuda" in line for line in lines)
          and (out / "slurm" / "sweep.sbatch").is_file(), f"sweep --slurm wrote {lines}")

    # 7. One real sweep combination: a Trainer run of 2 steps on the card.
    cmd = [sys.executable, "-m", "generative_turbulence_tpu_torch.scripts.sweep", "--sweep", "trainer.seed=0",
           "--out", str(out / "sweep"), "--device", "cuda", *STUDY_SWEEP_RUN, f"data.root={root}"]
    t0 = time.perf_counter()
    with open(out / "sweep-log.txt", "w+") as log_file:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=log_file, stderr=subprocess.STDOUT, start_new_session=True)
        try:
            code = proc.wait(timeout=STUDY_SWEEP_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            code = "timeout"
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        log_file.seek(0)
        check(code == 0, f"sweep exited {code}:\n{log_file.read()[-6000:]}")
    row["seconds"]["sweep_run"] = time.perf_counter() - t0
    metrics_file = out / "sweep" / "0" / "metrics.jsonl"
    records = [json.loads(line) for line in metrics_file.read_text().splitlines()] if metrics_file.is_file() else []
    steps = [r["step"] for r in records if "train/loss" in r]
    check(steps == [1, 2] and any("val/tke" in r for r in records), f"sweep run: train steps {steps} in {metrics_file}")
    log(f"  sweep_run: {row['seconds']['sweep_run']!r} s (a process of its own); {metrics_file.relative_to(root)} "
        f"holds train steps {steps} and a validation")
    row["phase_s"] = time.perf_counter() - tic
    return launches, row


# Phase 6g, the OpenFOAM data toolchain: the port's generate_shapes at the
# full shapes grid (scale 1: 192x48x48 cells, the first train shape with
# train/ and val/ linking it, every analysis, .npyd), validate_dataset, the
# first turbulent frame on the card against the CPU, and the paper's run
# trained and validated on the generated case through the training entry
# point.  Cuts: 8 mock frames; the Trainer's validation without the region
# Wasserstein (the generated regions.npz holds ~1,500 regions, minutes of
# Sinkhorn), which is computed instead over a seeded subset of its regions
# on the Trainer's stored samples.
TOOLCHAIN_FRAMES = 8
TOOLCHAIN_REGIONS = 8
TOOLCHAIN_STEPS = 2
TOOLCHAIN_RUN = TRAINER_RUNS["diffusion"] + TRAINER_CUTS + [
    f"trainer.max_steps={TOOLCHAIN_STEPS}", "trainer.check_val_every_n_epoch=1000"]
TOOLCHAIN_STEPS_TIMED = (  # (module, function) of generate_shapes' steps
    ("generate", "generate_case"), ("boxmesh", "build_polymesh"), ("generate", "mock_solve_direct"),
    ("convert", "add_grid_embedding"), ("analysis", "mean_flow"), ("analysis", "homogeneous_regions"),
    ("analysis", "max_mean_tke"), ("analysis", "dataset_stats"))
F32_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_torch_eval_ops.py


def toolchain_phase(torch, ck, root: Path, smi: str) -> tuple:
    """Phase 6g: ``generate_shapes --mock-direct --overfit 1 --frames 8``,
    ``validate_dataset --deep``, ``case_analysis --first-turbulent-frame``
    on the card and on the CPU, then the training entry point's ``main``
    for 2 steps and one validation on the generated dataset.  Returns the
    launch counts of the Trainer's run and the ``toolchain`` JSON row."""
    import importlib

    import numpy as np

    from generative_turbulence_tpu_torch import train
    from generative_turbulence_tpu_torch.data.schema import FieldStats
    from generative_turbulence_tpu_torch.eval.metrics import SampleMetricsCollection, WassersteinMetric
    from generative_turbulence_tpu_torch.scripts import case_analysis, generate_shapes, validate_dataset
    from generative_turbulence_tpu_torch.toolchain import analysis
    from generative_turbulence_tpu_torch.training.diffusion_task import DiffusionTask
    from generative_turbulence_tpu_torch.training.loop import Trainer

    tic = time.perf_counter()
    data_root = root / "shapes"
    row = {"seconds": {}, "generate_shapes_s": {}, "peak_gib": {}, "launches": {}, "values": {},
           "frames": TOOLCHAIN_FRAMES}
    log(f"[6g] OpenFOAM data toolchain at the full shapes grid: generate_shapes --mock-direct --overfit 1 "
        f"--frames {TOOLCHAIN_FRAMES} (.npyd), validate_dataset, the first turbulent frame card vs CPU, "
        f"{TOOLCHAIN_STEPS} Trainer steps and one validation on it")
    step = functools.partial(entry_point_step, torch, ck, row)

    # 1. generate_shapes, each of its steps timed on the host clock.
    timers = []
    for module, name in TOOLCHAIN_STEPS_TIMED:
        mod = importlib.import_module(f"generative_turbulence_tpu_torch.toolchain.{module}")

        def timed(*args, _fn=getattr(mod, name), _name=name, **kwargs):
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            row["generate_shapes_s"][_name] = row["generate_shapes_s"].get(_name, 0.0) + time.perf_counter() - t0
            return out

        timers.append(patched(mod, name, timed))
    with contextlib.ExitStack() as stack:
        for timer in timers:
            stack.enter_context(timer)
        result = step("generate_shapes", generate_shapes.main,
                      [data_root, "--mock-direct", "--overfit", 1, "--frames", TOOLCHAIN_FRAMES], device=None)
    (name,) = result["cases"]
    case = data_root / "cases" / name
    files = {p.name for p in case.iterdir()}
    want = {"data.npyd", "mean-flow.npyd", "regions.npz", "max-mean-tke.npy"}
    check(want <= files and not any(f.endswith(".h5") for f in files) and (data_root / "stats.pickle").is_file(),
          f"generate_shapes: {sorted(files)} in {case}")
    links = {split: (data_root / split / name).resolve() for split in ("train", "val")}
    check(result["splits"] == {"train": [name], "val": [name]} and set(links.values()) == {case.resolve()},
          f"generate_shapes --overfit 1: splits {result['splits']}, links {links}")
    data = case / "data.npyd"
    with open(data / "attrs.json") as f:
        attrs = json.load(f)
    u = np.load(data / "data" / "u.npy", mmap_mode="r")
    counts = np.load(data / "grid" / "cell_counts.npy").tolist()
    n_regions = int(np.load(case / "regions.npz")["assignments"].max() + 1)
    check(u.shape[0] == TOOLCHAIN_FRAMES and counts == [194, 50, 50] and "physical" in attrs,
          f"generate_shapes: u {u.shape}, padded grid {counts}")
    row["values"].update(case=name, n_cells=int(u.shape[1]), padded_grid=counts, n_regions=n_regions,
                         max_mean_tke=float(np.load(case / "max-mean-tke.npy")),
                         data_npyd_bytes=sum(p.stat().st_size for p in data.rglob("*") if p.is_file()))
    log(f"    {name}: {u.shape[1]} cells, {u.shape[0]} frames, padded grid {counts}, {n_regions} regions, "
        f"max-mean-tke at x = {row['values']['max_mean_tke']!r}; train/ and val/ link the case; "
        f"steps {json.dumps(row['generate_shapes_s'])}")

    # 2. validate_dataset --deep.
    result = step("validate_dataset", validate_dataset.main, [data_root, "--deep"], device=None)
    check(result == {"n_cases": 1, "failed": {}} and validate_dataset.exit_code(result) == 0,
          f"validate_dataset: {result}")

    # 3. The first turbulent frame on the card and on the CPU: the index
    # equal, both distance matrices at the f32 tolerance.
    distances = {}
    for device in ("cuda", "cpu"):
        def recorded(*args, _fn=analysis.turbulent_frame_distances, _device=device, **kwargs):
            distances[_device] = _fn(*args, **kwargs)
            return distances[_device]

        with patched(analysis, "turbulent_frame_distances", recorded):
            frame = step(f"first_turbulent_frame_{device}", case_analysis.main, [data, "--first-turbulent-frame"],
                         device=device)["first_turbulent_frame"]
        check(frame == distances[device]["first"], f"case_analysis on {device}: {frame}, {distances[device]['first']}")
    card, cpu = distances["cuda"], distances["cpu"]
    errs = {}
    for key in ("late", "all"):
        finite = np.isfinite(cpu[key])
        check(np.array_equal(finite, np.isfinite(card[key])) and card[key].shape == cpu[key].shape,
              f"first_turbulent_frame: {key} shapes or infinities differ")
        errs[key] = float(np.abs(card[key][finite] - cpu[key][finite]).max())
        check(np.allclose(card[key][finite], cpu[key][finite], **F32_TOL),
              f"first_turbulent_frame: the card's {key} distances off the CPU's by {errs[key]} ({F32_TOL})")
    check(card["first"] == cpu["first"], f"first turbulent frame: {card['first']} on the card, {cpu['first']} on the CPU")
    row["values"].update(first_turbulent_frame=card["first"], first_turbulent_frame_max_abs_err=errs,
                         first_turbulent_frame_limit=[card["limit"], cpu["limit"]])
    log(f"    first turbulent frame {card['first']} on the card and the CPU; distances' max abs error {errs} "
        f"(at {F32_TOL})")

    # 4. The paper's run on the generated dataset through the training entry
    # point: launches per step and per validation as in phase 6c.
    out = root / "toolchain-run"
    steps, validations, tasks = [], [], []
    training_step, validate = DiffusionTask.training_step, Trainer.validate

    def measured_step(task, *args, **kwargs):
        tasks[:] = [task]
        before = dict(ck.LAUNCH_COUNTS)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        result = training_step(task, *args, **kwargs)
        end.record()
        steps.append({"events": (start, end), "loss": result["train/loss"],
                      "launches": {k: v - before[k] for k, v in ck.LAUNCH_COUNTS.items()}})
        return result

    def measured_validate(self, *args, **kwargs):
        before = dict(ck.LAUNCH_COUNTS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = validate(self, *args, **kwargs)
        torch.cuda.synchronize()
        validations.append({"s": time.perf_counter() - t0, "metrics": dict(result),
                            "launches": {k: v - before[k] for k, v in ck.LAUNCH_COUNTS.items()}})
        return result

    overrides = [*TOOLCHAIN_RUN, f"data.root={data_root}", f"trainer.out_dir={out}",
                 f"trainer.samples_root={out / 'samples'}"]
    log(f"  train: {' '.join(TOOLCHAIN_RUN)}")
    with patched(DiffusionTask, "training_step", measured_step), patched(Trainer, "validate", measured_validate):
        score = step("train", train.main, overrides, device=None)
    launches = row["launches"]["train"]
    losses = [float(s["loss"]) for s in steps]
    check(len(steps) == TOOLCHAIN_STEPS and all(math.isfinite(v) for v in losses), f"train: losses {losses}")
    check(len(validations) == 1, f"train: {len(validations)} validations")
    metrics = validations[0]["metrics"]
    check({"val/tke", "val/max-mean-tke-pos"} <= set(metrics) and all(math.isfinite(v) for v in metrics.values()),
          f"train: validation metrics {metrics}")
    val_evals = DIAGNOSTIC_EVALS + TRAINER_DDIM_STEPS
    for kernel in CHAIN_KERNELS:
        per_step = [s["launches"][kernel] for s in steps]
        check(per_step == [TRAIN_CHAIN_LAUNCHES] * TOOLCHAIN_STEPS,
              f"train: {kernel} launched {per_step} per step, expected {TRAIN_CHAIN_LAUNCHES}")
        check(validations[0]["launches"][kernel] == len(ENGAGED_BLOCKS) * val_evals,
              f"train: {kernel} launched {validations[0]['launches'][kernel]} times in the validation, expected "
              f"{len(ENGAGED_BLOCKS) * val_evals}")
    check(launches["flash_attention"] == 0 and launches["conv3d_3x3"] == 0, f"train: launches {launches}")
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in (s["events"] for s in steps)]

    # The region Wasserstein over a seeded subset of the generated regions,
    # on the validation's stored samples.
    store = tasks[0].sample_stores["val"]
    stats = FieldStats.from_file(data_root / "stats.pickle")
    t0 = time.perf_counter()
    wasserstein = SampleMetricsCollection("val", data_root / "val", [WassersteinMetric(
        solver="sinkhorn", max_regions=TOOLCHAIN_REGIONS, device="cuda")]).compute(store, stats)
    torch.cuda.synchronize()
    row["seconds"]["wasserstein_sinkhorn"] = time.perf_counter() - t0
    check(math.isfinite(wasserstein.get("val/wasserstein", math.nan)), f"wasserstein: {wasserstein}")
    row.update(step_ms=step_ms, losses=losses, monitor=score, validation_s=validations[0]["s"],
               validation=metrics, launches_per_step=[s["launches"] for s in steps],
               launches_per_validation=validations[0]["launches"], n_params=tasks[0].n_params())
    row["values"]["wasserstein_over_regions"] = {"regions": TOOLCHAIN_REGIONS, **wasserstein}
    log(f"    steps {step_ms!r} ms, losses {losses!r}; validation {validations[0]['s']!r} s: "
        f"{json.dumps({k: v for k, v in metrics.items() if k in ('val/tke', 'val/max-mean-tke-pos')})}; "
        f"{TRAIN_CHAIN_LAUNCHES} launches per step and {len(ENGAGED_BLOCKS)} x {val_evals} per validation for each "
        f"chain kernel (as in phase 6c); val/wasserstein over {TOOLCHAIN_REGIONS} of {n_regions} regions "
        f"{wasserstein['val/wasserstein']!r} in {row['seconds']['wasserstein_sinkhorn']!r} s")
    row.update(card=smi, phase_s=time.perf_counter() - tic)
    return launches, row


# Phase 6i, the paper's run recipes: ``scripts/run_shapes.py`` on phase 6b's
# dataset (the shapes grid, 1 train and 1 val case of 16 frames), each run
# through the entry point's ``main`` in this process with 6c's cuts; then the
# host tools one by one (they use no card, and run after the timed card work
# so that the host's cores are free while it runs).
RECIPE_STEPS = 4  # trainer.max_steps counts micro-steps: 2 updates at accumulate 2
RECIPE_MICRO_BATCH = 3  # the r5 recipe's batch 6 over accumulate 2
RECIPE_VAL_BATCHES = 2  # 8 val frames at the recipe's eval batch 6
RECIPE_DDIM_STEPS = 50
RECIPE_CUTS = TRAINER_CUTS + [f"trainer.max_steps={RECIPE_STEPS}"]
# The baselines' validation rollout cut to 4 steps (6c's DilResNet cut): a
# 16-frame case holds no window of the configs' 6 + 27 or 1 + 27 frames.
BASELINE_RECIPE_CUTS = TRAINER_CUTS + ["trainer.max_steps=2", "model.eval_unroll_steps=4",
                                       "model.sample_steps=[2,3,4]", "model.main_sample_step=4", "data.val_samples=2"]
PERFORMANCE_WIDTHS = [1, 2, 4, 8, 16]  # generate_performance_dataset's default
ANALYSES = ["missing mean-flow.npyd or mean-flow.h5", "missing regions.npz", "missing max-mean-tke.npy"]


def run_host_tools(out: Path) -> dict:
    """Phase 6i's host tools through their ``main``, one after another,
    each timed on the host clock: their results and seconds."""
    import importlib.util
    import io

    from generative_turbulence_tpu_torch.scripts import (
        generate_2d3d, generate_performance_dataset, solve_slurm, split_2d3d, validate_dataset)

    study, perf = out / "study", out / "performance"
    steps = [
        ("generate_2d3d", generate_2d3d.main, ["regression", study, "--inflows", "20", "--mock-solve", "--frames", 4]),
        ("split_2d3d", split_2d3d.main, [study]),
        ("validate_dataset", validate_dataset.main, [study, "--deep"]),
        ("generate_performance_dataset", generate_performance_dataset.main, [perf]),
        ("solve_slurm", solve_slurm.main, [perf / "cases", "--dry-run"]),
    ]
    row = {"seconds": {}, "results": {}, "h5py_importable": importlib.util.find_spec("h5py") is not None}
    for name, main, argv in steps:
        tic = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            result = main([str(a) for a in argv])
        row["seconds"][name] = time.perf_counter() - tic
        row["results"][name] = json.loads(json.dumps(result, default=str))
    return row


def check_host_tools(out: Path, row: dict) -> dict:
    """Phase 6i's checks of the host tools' outputs; returns their row."""
    import numpy as np

    from generative_turbulence_tpu_torch.data.npyd import read_tree

    res, study = row["results"], out / "study"
    cases = res["generate_2d3d"]
    check(cases == ["inflow-20.0-2d", "inflow-20.0-3d"], f"generate_2d3d: {cases}")
    counts = {c: json.loads((study / "cases" / c / "mesh-params.json").read_text())["cell_counts"] for c in cases}
    check(counts == {"inflow-20.0-2d": [192, 48, 1], "inflow-20.0-3d": [192, 48, 48]}, f"generate_2d3d: {counts}")
    check(not list(out.rglob("*.h5")) and not row["h5py_importable"], "host tools: an .h5 file or h5py on the card")
    frames = {}
    for case in cases:
        whole = read_tree(study / "cases" / case / "data.npyd")[0]
        parts = [read_tree(study / split / case / "data.npyd")[0] for split in ("train", "val", "test")]
        frames[case] = [len(part["data/times"]) for part in parts]
        for key in ("data/times", "data/u", "data/p"):
            check(np.array_equal(np.concatenate([part[key] for part in parts]), whole[key]),
                  f"split_2d3d: {case} {key} is not the case's frames in order")
    check(all(f == [2, 0, 1] for f in frames.values()), f"split_2d3d: frames per split {frames}")
    check(res["validate_dataset"] == {"n_cases": 2, "failed": {c: ANALYSES for c in cases}},
          f"validate_dataset: {res['validate_dataset']} (a 2D/3D study has no analyses, nothing else may fail)")
    perf = out / "performance" / "cases"
    check([Path(p).name for p in res["generate_performance_dataset"]] == [f"parallel-{w}" for w in PERFORMANCE_WIDTHS],
          f"generate_performance_dataset: {res['generate_performance_dataset']}")
    for width in PERFORMANCE_WIDTHS:
        text = (perf / f"parallel-{width}" / "system" / "decomposeParDict").read_text()
        check(f"numberOfSubdomains {width};" in text, f"parallel-{width}: decomposeParDict")
    sbatch = (perf / "solve.sbatch").read_text()
    listed = (perf / "slurm-cases.txt").read_text().split()
    check(res["solve_slurm"] == 0 and "#SBATCH --array=1-5\n" in sbatch and "#SBATCH --cpus-per-task=16\n" in sbatch
          and len(listed) == 5, f"solve_slurm: {res['solve_slurm']}, {len(listed)} cases listed, sbatch:\n{sbatch}")
    row["split_frames"] = frames
    log(f"    host tools (one by one, host clock): {json.dumps(row['seconds'])}; study {counts}, split frames "
        f"(train, val, test) {frames}, validate_dataset: only the analyses missing; performance widths "
        f"{PERFORMANCE_WIDTHS}; solve.sbatch --array=1-5 --cpus-per-task=16")
    return row


class RecordedNoise:
    """A noise source that records what a training step asks of it."""

    def __init__(self, noise):
        self.noise, self.calls = noise, []

    def __call__(self, shape):
        self.calls.append(("normal", tuple(shape)))
        return self.noise(shape)

    def randint(self, n, high):
        self.calls.append(("randint", n, high))
        return self.noise.randint(n, high)


def recipes_phase(torch, ck, root: Path, smi: str) -> tuple:
    """Phase 6i: ``run_shapes diffusion-r5`` for 2 updates and one
    validation, ``run_shapes tfnet`` and ``run_shapes dilresnet`` for 2
    micro-steps each, on the dataset under ``root``; the host tools after
    them.  Returns the r5 run's launches and the ``recipes`` JSON row."""
    import numpy as np

    from generative_turbulence_tpu_torch.data.dataset import CaseDataset, GeometryPureBatches
    from generative_turbulence_tpu_torch.data.npyd import open_case_file
    from generative_turbulence_tpu_torch.data.schema import CaseRepository, FieldStats, find_data_files, read_metadata
    from generative_turbulence_tpu_torch.diffusion.gaussian import Bf16NormalLaw, GeneratorNoise, bf16_normal_levels
    from generative_turbulence_tpu_torch.scripts import run_shapes
    from generative_turbulence_tpu_torch.training.diffusion_task import DiffusionTask
    from generative_turbulence_tpu_torch.training.loop import Trainer
    from generative_turbulence_tpu_torch.training.regression_task import DilResNetTask, TFNetTask

    tic = time.perf_counter()
    row = {"seconds": {}, "peak_gib": {}, "launches": {}}
    log(f"[6i] the paper's run recipes through run_shapes.main on 6b's dataset; {' '.join(RECIPE_CUTS)}; then the "
        f"host tools")
    step = functools.partial(entry_point_step, torch, ck, row)
    # (a) diffusion-r5: 2 updates of 2 micro-steps of 3, one validation.
    steps, validations, tasks = [], [], []
    training_step, validate = DiffusionTask.training_step, Trainer.validate

    def measured_step(task, cells, grid, noise):
        tasks[:] = [task]
        if not steps:
            row["first_batch"] = {"dtype": str(cells.dtype), "device": str(cells.device),
                                  "cells": cells.detach().cpu()}
        before = dict(ck.LAUNCH_COUNTS)
        recorded = RecordedNoise(noise)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        result = training_step(task, cells, grid, recorded)
        end.record()
        steps.append({"events": (start, end), "loss": result["train/loss"], "draws": recorded.calls,
                      "shape": (cells.shape[0], *grid.shape, cells.shape[-1]),
                      "launches": {k: v - before[k] for k, v in ck.LAUNCH_COUNTS.items()}})
        return result

    def measured_validate(self, *args, **kwargs):
        before = dict(ck.LAUNCH_COUNTS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = validate(self, *args, **kwargs)
        torch.cuda.synchronize()
        validations.append({"s": time.perf_counter() - t0, "metrics": dict(result),
                            "launches": {k: v - before[k] for k, v in ck.LAUNCH_COUNTS.items()}})
        return result

    out = root / "recipes"
    overrides = [*RECIPE_CUTS, f"data.root={root}", f"trainer.out_dir={out / 'r5'}",
                 f"trainer.samples_root={out / 'r5' / 'samples'}"]
    log(f"  run_shapes diffusion-r5: {' '.join(run_shapes.RECIPES['diffusion-r5'])}")
    with patched(DiffusionTask, "training_step", measured_step), patched(Trainer, "validate", measured_validate):
        score = step("diffusion-r5", run_shapes.main, ["diffusion-r5", *overrides])
    task = tasks[0]
    torch.cuda.synchronize()
    micro_ms = [a.elapsed_time(b) for a, b in (s["events"] for s in steps)]
    losses = [float(s["loss"]) for s in steps]
    check(len(steps) == RECIPE_STEPS and all(math.isfinite(v) for v in losses), f"r5: losses {losses}")
    check(task.opt_state.count == RECIPE_STEPS // 2 and task.cfg.accumulate_steps == 2,
          f"r5: {task.opt_state.count} updates in {len(steps)} micro-steps")

    # The first batch: bf16 on the card, the bf16 rounding of the host's
    # f32 frames of the sampler's first batch in sorted order.
    first = row.pop("first_batch")
    stats = FieldStats.from_file(root / "stats.pickle")
    train = CaseDataset(CaseRepository(find_data_files(root / "train"), task.variables), stats,
                        discard_first_seconds=-1)
    sampler = GeometryPureBatches(train, batch_size=RECIPE_MICRO_BATCH, shuffle=True, seed=0, epoch=0)
    idxs = sorted(next(iter(sampler)))
    with open_case_file(find_data_files(root / "train")[0]) as f:
        frames = np.concatenate([np.asarray(f["data/u"][idxs]), np.asarray(f["data/p"][idxs])[..., None]], -1)
    want = torch.from_numpy(frames.astype(np.float32)).to(torch.bfloat16)
    check(first["dtype"] == "torch.bfloat16" and first["device"].startswith("cuda")
          and torch.equal(first["cells"], want),
          f"r5: first batch {first['dtype']} on {first['device']}, frames {idxs} rounded to bf16 "
          f"{'equal' if torch.equal(first['cells'], want) else 'differ'}")
    log(f"    first batch: bf16 on {first['device']}, frames {idxs} (sorted) of the host's f32 frames rounded "
        f"to bf16, bit for bit")

    # The noise: JAX draws it at the bf16 frames' dtype, so each micro-step
    # draws 128 levels (Bf16NormalLaw), whose values on the card are the CPU
    # table's, each about as frequent.
    shape = steps[0]["shape"]
    n = math.prod(shape)
    want = [("randint", RECIPE_MICRO_BATCH, task.cfg.timesteps), ("randint", n, 128)]
    check(all(s["draws"] == want for s in steps), f"r5: draws {[s['draws'] for s in steps]}, expected {want}")
    law = Bf16NormalLaw(GeneratorNoise(torch.Generator(device="cuda").manual_seed(0), "cuda"))
    values, counts = torch.unique(law(shape), return_counts=True)
    spread = (counts.min().item() / (n / 128), counts.max().item() / (n / 128))
    check(torch.equal(values.cpu(), bf16_normal_levels(torch.device("cpu"))) and 0.97 < spread[0] <= spread[1] < 1.03,
          f"r5: the card's noise takes {values.numel()} values, counts / expected in {spread}")
    row["noise_levels_spread"] = spread
    log(f"    noise: each micro-step drew {n} levels of the bf16 law; on the card its values are the CPU table's, "
        f"counts / expected in {spread!r}")

    # Launches: 7 per micro-step (remat), 4 x (16 + 50 x 2) per validation.
    check(len(validations) == 1, f"r5: {len(validations)} validations")
    val_evals = DIAGNOSTIC_EVALS + RECIPE_DDIM_STEPS * RECIPE_VAL_BATCHES
    for kernel in CHAIN_KERNELS:
        per_step = [s["launches"][kernel] for s in steps]
        check(per_step == [TRAIN_CHAIN_LAUNCHES] * RECIPE_STEPS,
              f"r5: {kernel} launched {per_step} per micro-step, expected {TRAIN_CHAIN_LAUNCHES}")
        check(validations[0]["launches"][kernel] == len(ENGAGED_BLOCKS) * val_evals,
              f"r5: {kernel} launched {validations[0]['launches'][kernel]} times in the validation, expected "
              f"{len(ENGAGED_BLOCKS) * val_evals}")
    launches = row["launches"]["diffusion-r5"]
    check(launches["flash_attention"] == 0 and launches["conv3d_3x3"] == 0
          and not any(launches[k] for k in HALO_KERNELS), f"r5: launches {launches}")

    # The validation: f32, DDIM-50, x0 clipped to stats.envelope's bounds
    # in normalised units, finite samples, a finite val/tke.
    lo, hi = stats.envelope(task.variables)
    mean, std = task.normalizer.mean, task.normalizer.std
    bounds = ((lo.astype(np.float32) - mean) / std, (hi.astype(np.float32) - mean) / std)
    cfg = task.cfg
    check(cfg.eval_compute_dtype == "float32" and cfg.ddim_steps == RECIPE_DDIM_STEPS and cfg.sampler == "ddim"
          and cfg.clip_denoised and cfg.clip_mode == "envelope" and task.diffusion.clip_denoised
          and all(np.array_equal(g, w) for g, w in zip(task.diffusion.clip_bounds, bounds)),
          f"r5: validation settings {cfg.eval_compute_dtype}, DDIM-{cfg.ddim_steps}, clip {cfg.clip_mode}, "
          f"bounds {task.diffusion.clip_bounds} against {bounds}")
    store = task.sample_stores["val"]
    samples = np.concatenate([store.load_samples(read_metadata(f)).stacked_cells(task.variables)
                              for f in find_data_files(root / "val")])
    inside = float(np.mean((samples >= lo - 1e-3 * np.abs(lo)) & (samples <= hi + 1e-3 * np.abs(hi))))
    metrics = validations[0]["metrics"]
    check(samples.shape[0] == 8 and np.isfinite(samples).all() and math.isfinite(metrics.get("val/tke", math.nan))
          and math.isfinite(score), f"r5: samples {samples.shape}, finite {np.isfinite(samples).all()}, "
          f"val/tke {metrics.get('val/tke')}, score {score}")
    row["r5"] = {"micro_step_ms": micro_ms, "update_ms": [a + b for a, b in zip(micro_ms[::2], micro_ms[1::2])],
                 "losses": losses, "validation_s": validations[0]["s"], "validation": metrics,
                 "peak_gib": row["peak_gib"]["diffusion-r5"], "launches_per_micro_step": [s["launches"] for s in steps],
                 "launches_per_validation": validations[0]["launches"], "unet_evaluations_per_validation": val_evals,
                 "samples": list(samples.shape), "samples_inside_envelope": inside, "n_params": task.n_params()}
    log(f"    micro-steps {micro_ms!r} ms (updates {row['r5']['update_ms']!r} ms); losses {losses!r}; peak "
        f"{row['peak_gib']['diffusion-r5']!r} GiB; validation {validations[0]['s']!r} s (f32 DDIM-50 clipped to "
        f"the envelope, {samples.shape[0]} samples, {inside!r} of their values inside it; val/tke "
        f"{metrics['val/tke']!r}); {TRAIN_CHAIN_LAUNCHES} launches per micro-step and {len(ENGAGED_BLOCKS)} x "
        f"{val_evals} per validation for each chain kernel")
    del task, tasks, store
    torch.cuda.empty_cache()

    # (b) The baselines' recipes: bf16 windows, no Hopper kernel.
    for name, cls in (("tfnet", TFNetTask), ("dilresnet", DilResNetTask)):
        dtypes = []
        train = cls.training_step

        def recorded(task, cells, grid, noise, _train=train):
            dtypes.append(str(cells.dtype))
            return _train(task, cells, grid, noise)

        with patched(cls, "training_step", recorded):
            step(name, run_shapes.main, [name, *BASELINE_RECIPE_CUTS, f"data.root={root}",
                                         f"trainer.out_dir={out / name}"])
        check(dtypes == ["torch.bfloat16"] * 2, f"{name}: training windows {dtypes}")
        check(not any(row["launches"][name].values()), f"{name}: launches {row['launches'][name]}")
        log(f"    {name}: 2 micro-steps on bf16 windows, no kernel launched")

    # (c) The host tools, after the card's work.
    tools_out = root / "host-tools"
    row["host_tools"] = check_host_tools(tools_out, run_host_tools(tools_out))
    row.update(card=smi, phase_s=time.perf_counter() - tic)
    return row["launches"]["diffusion-r5"], row


def multi_card_main() -> int:
    """``python3 chip_smoke.py --multi-card``, on a machine with several
    cards: phase 6e's paper run at batch 2 x cards, in one process and on
    one NCCL rank per card under ``torch.distributed.run``: the backend and
    a card per rank, 7 chain launches per rank per step, the first step's
    all-reduced gradients held against the single run's (the x 1.1
    gradients refused), the losses and the merged ``val/tke``; with four
    cards the same at ``trainer.mesh_shape`` (2, 2) and (1, 4), where the
    halo variants launch, with peak memory per rank; prints one
    ``multi_card`` JSON line and the card's name and power limit."""
    if not (ROOT / "generative_turbulence_tpu_torch").is_dir():
        log("error: run from a checkout of the repository (generative_turbulence_tpu_torch/ missing)")
        return 1
    sys.path.insert(0, str(ROOT))
    import torch

    smi = nvidia_smi()
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    log(f"[multi-card] cards: {n_cards}; {smi}")
    if n_cards < 2:
        log("error: --multi-card needs at least two cards")
        return 1
    from generative_turbulence_tpu_torch.ops import cuda_kernels as ck

    ck.build_library()
    tic = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            write_eval_dataset(root, TRAINER_FRAMES, "multi-card")
            shutil.copytree(root / "val" / DP_VAL_CASES[0], root / "val" / DP_VAL_CASES[1])
            extra = [f"model.batch_size={2 * n_cards}"]
            runs = {"single": ([], {}),
                    "nccl": (["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(n_cards)],
                             {"GT_DISTRIBUTED": "1"})}
            outs = {}
            for name, run in runs.items():
                outs.update(finish_runs(start_runs(root, {name: run}, extra)))
            (a,), ranks = rank_rows(outs["single"], 1), rank_rows(outs["nccl"], n_cards)
            check(all(r["backend"] == "nccl" and r["world"] == n_cards for r in ranks)
                  and sorted(r["device"] for r in ranks) == [f"cuda:{i}" for i in range(n_cards)],
                  f"ranks: {[(r['backend'], r['world'], r['device']) for r in ranks]}")
            check_rank_steps([a, *ranks])
            held = hold_ranks(torch, a, outs["single"], ranks, outs["nccl"], MAX_GRAD_REL_L2, f"{n_cards} NCCL ranks")
            meshes = {}
            for mesh in ([(2, 2), (1, 4)] if n_cards >= 4 else []):
                name = f"mesh_{mesh[0]}x{mesh[1]}"
                launcher = (["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4"],
                            {"GT_DISTRIBUTED": "1"})
                out = finish_runs(start_runs(root, {name: launcher},
                                             [*extra, f"trainer.mesh_shape=[{mesh[0]},{mesh[1]}]"]))[name]
                mesh_ranks = rank_rows(out, 4)
                check(all(r["backend"] == "nccl" and r["mesh"] == list(mesh) for r in mesh_ranks),
                      f"{name}: {[(r['backend'], r['mesh']) for r in mesh_ranks]}")
                check_rank_steps(mesh_ranks, SP_CHAIN_KERNELS)
                meshes[name] = {
                    **hold_ranks(torch, a, outs["single"], mesh_ranks, out, MAX_GRAD_REL_L2, f"{name} over NCCL"),
                    "ranks": [{k: r[k] for k in ("rank", "dp_index", "sp_index", "device", "step_ms", "peak_gib",
                                                 "losses", "exchanges_per_step", "halo_exchange_down_0")}
                              for r in mesh_ranks]}
                log(f"  {name}: step ms per rank {[r['step_ms'][1:] for r in mesh_ranks]!r}, peak "
                    f"{[r['peak_gib'] for r in mesh_ranks]!r} GiB (one process {a['peak_gib']!r} GiB)")
    except SmokeFailure as e:
        log(f"FAILED: {e}")
        return 1
    row = {"cards": n_cards, "batch": 2 * n_cards, "steps": DP_STEPS,
           "ranks": [{k: r[k] for k in ("rank", "world", "backend", "device", "step_ms", "peak_gib", "fit_s",
                                         "allreduce_ms", "losses", "monitor")} for r in ranks],
           "single": {k: a[k] for k in ("device", "step_ms", "peak_gib", "fit_s", "losses", "monitor")},
           **held, "meshes": meshes, "n_params": a["n_params"], "seconds": time.perf_counter() - tic}
    print(smi)
    print(json.dumps({"multi_card": row, "card": smi}))
    return 0


def main() -> int:
    if not (ROOT / "generative_turbulence_tpu_torch").is_dir():
        log("error: run from a checkout of the repository (generative_turbulence_tpu_torch/ missing)")
        return 1
    sys.path.insert(0, str(ROOT))
    import torch

    smi = nvidia_smi()
    log(f"[1] card: {smi}")
    log(f"    python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        log("error: torch.cuda.is_available() is False; this smoke run needs a GPU")
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"    device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
        f"capability {torch.cuda.get_device_capability(0)}")

    from generative_turbulence_tpu_torch.ops import cuda_kernels as ck

    tic = time.perf_counter()
    lib = ck.build_library()
    ck._library()
    log(f"[2] built {lib.name} in {time.perf_counter() - tic!r} s")
    for line in ptxas_summary(lib.with_suffix(".log").read_text()):
        log(f"    ptxas: {line}")

    try:
        block_rows, kernels = kernel_phase(torch, ck)
        kernels.append(flash_phase(torch, ck))
        kernels.append(conv3d_phase(torch, ck))
        profiles = []
        launches4, timings = main_path_phase(torch, ck, profiles)
        launches2, timings2 = two_level_phase(torch, ck, profiles)
        train_launches4, train4, train_profile4 = train_phase(torch, ck, 4, TRAIN_TIMED)
        train_launches2, train2, train_profile2 = train_phase(torch, ck, 2, 4)
        with tempfile.TemporaryDirectory() as tmp:
            eval_rows = {"dataset_write_s": write_eval_dataset(Path(tmp))}
            eval_launches = {}
            for label, overrides, n_evals, flash_per_eval in EVAL_RUNS:
                eval_launches[label], eval_rows[label] = eval_phase(
                    torch, ck, Path(tmp), label, overrides, n_evals, flash_per_eval)
            recipe_launches, recipe_rows = recipes_phase(torch, ck, Path(tmp), smi)
            log(f"  phase 6i took {recipe_rows['phase_s']!r} s")
        with tempfile.TemporaryDirectory() as tmp:
            tic = time.perf_counter()
            trainer_rows = {"dataset_frames": TRAINER_FRAMES,
                            "dataset_write_s": write_eval_dataset(Path(tmp), TRAINER_FRAMES, "6c")}
            trainer_launches, runs = trainer_phase(torch, ck, Path(tmp))
            trainer_rows.update(runs, phase_s=time.perf_counter() - tic)
            log(f"  phase 6c took {trainer_rows['phase_s']!r} s")
            tic = time.perf_counter()
            ckpt_launches, ckpt_rows = checkpoint_eval_phase(torch, ck, Path(tmp), smi)
            ckpt_rows["phase_s"] = time.perf_counter() - tic
            log(f"  phase 6d took {ckpt_rows['phase_s']!r} s")
            dp_launches, dp_rows = data_parallel_phase(torch, ck, Path(tmp), smi)
            log(f"  phase 6e took {dp_rows['phase_s']!r} s")
            halo_rows, sp_launches, sp_rows = spatial_phase(torch, ck, Path(tmp), smi, dp_rows)
            kernels += halo_rows
            log(f"  phase 6h took {sp_rows['phase_s']!r} s")
            profile_launches, study_rows = study_scripts_phase(torch, ck, Path(tmp), smi, timings["fwd_ms"])
            log(f"  phase 6f took {study_rows['phase_s']!r} s")
        with tempfile.TemporaryDirectory() as tmp:
            toolchain_launches, toolchain_rows = toolchain_phase(torch, ck, Path(tmp), smi)
            log(f"  phase 6g took {toolchain_rows['phase_s']!r} s")
    except SmokeFailure as e:
        log(f"FAILED: {e}")
        return 1
    timings.update(timings2)
    profiles += [train_profile4, train_profile2]
    # Launches on the main paths (the 4-level and the 2-level sampler runs,
    # train steps, eval steps, the Trainer's runs, the checkpoint
    # evaluation's entry points, profile_fwd and the Trainer on the
    # toolchain's case), each counted from 0 just before the path runs; the train paths per step, the eval paths per eval_step, the
    # Trainer per train step and per validation, eval_ckpt per val batch.
    diffusion = trainer_rows["diffusion"]
    for entry in kernels:
        name = entry["name"]
        entry["launches"] = (launches4[name] + launches2[name] + train_launches4[name] + train_launches2[name]
                             + sum(counts[name] for counts in eval_launches.values()) + trainer_launches[name]
                             + sum(counts[name] for counts in ckpt_launches.values())
                             + sum(counts[name] for counts in dp_launches["gloo_2"] + dp_launches["nccl_1"])
                             + sum(counts[name] for counts in profile_launches.values())
                             + toolchain_launches[name]
                             + sum(counts[name] for counts in sp_launches["ranks"])
                             + recipe_launches[name])
        entry["launches_by_path"] = {
            "4_levels": launches4[name], "2_levels": launches2[name],
            "train_4_levels": train4["launches_per_step"][name],
            "train_2_levels": train2["launches_per_step"][name],
            **{f"eval_{label}": counts[name] for label, counts in eval_launches.items()},
            "trainer_diffusion_per_step": diffusion["launches_in_steps"][name] / diffusion["micro_steps"],
            "trainer_diffusion_per_validation": diffusion["launches_per_validation"][0][name],
            "trainer_tfnet": trainer_rows["tfnet"]["launches"][name],
            "trainer_dilresnet": trainer_rows["dilresnet"]["launches"][name],
            "checkpoint_eval_per_val_batch": ckpt_launches["eval_ckpt"][name] / ckpt_rows["val_batches"],
            "checkpoint_eval": {step: counts[name] for step, counts in ckpt_launches.items()},
            "dp_gloo_2_per_rank_per_step": [[c[name] for c in rank] for rank in dp_launches["per_step"]["gloo_2"]],
            "dp_nccl_1_per_step": [c[name] for c in dp_launches["per_step"]["nccl_1"][0]],
            "dp_gloo_2_per_rank": [counts[name] for counts in dp_launches["gloo_2"]],
            "profile_fwd": {mode: counts[name] for mode, counts in profile_launches.items()},
            "profile_fwd_per_unet_evaluation": {
                mode: study_rows["profile_fwd"][mode]["launches_per_unet_evaluation"][name]
                for mode in profile_launches},
            "toolchain_trainer_per_step": [c[name] for c in toolchain_rows["launches_per_step"]],
            "toolchain_trainer_per_validation": toolchain_rows["launches_per_validation"][name],
            "sp_1x2_per_rank_per_step": [[c[name] for c in rank] for rank in sp_launches["per_step"]],
            "sp_1x2_per_rank": [counts[name] for counts in sp_launches["ranks"]],
            "recipe_r5_per_micro_step": [c[name] for c in recipe_rows["r5"]["launches_per_micro_step"]],
            "recipe_r5_per_validation": recipe_rows["r5"]["launches_per_validation"][name],
            "recipe_tfnet": recipe_rows["launches"]["tfnet"][name],
            "recipe_dilresnet": recipe_rows["launches"]["dilresnet"][name],
        }
    log(f"[7] card: {smi}")
    print(json.dumps({"recipes": recipe_rows, "card": smi}))
    print(json.dumps({"spatial": sp_rows, "card": smi}))
    print(json.dumps({"toolchain": toolchain_rows, "card": smi}))
    print(json.dumps({"study_scripts": study_rows, "card": smi}))
    print(json.dumps({"distributed": dp_rows, "card": smi}))
    print(json.dumps({"checkpoint_eval": ckpt_rows, "card": smi}))
    print(json.dumps({"trainer": trainer_rows, "card": smi}))
    print(json.dumps({"eval_path": eval_rows, "card": smi}))
    print(json.dumps({"blocks": block_rows, "main_path": timings, "profiles": profiles,
                      "train": [train4, train2]}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        sys.exit(rank_worker(Path(sys.argv[2]), sys.argv[3:]))
    if sys.argv[1:] == ["--multi-card"]:
        sys.exit(multi_card_main())
    sys.exit(main())
