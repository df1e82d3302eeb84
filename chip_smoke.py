#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA Hopper GPU (H100).

Run from the repository root:  python3 chip_smoke.py

1. Device: prints the card (nvidia-smi name and power limit) and the
   torch/CUDA versions; fails without CUDA.  TF32 is switched off for
   cuDNN convolutions and matmuls so f32 references are full f32.
2. Build: compiles the Hopper kernels from ``generative_turbulence_tpu_torch/
   csrc`` with nvcc (into build/kernels/) and prints the seconds it took.
3. Kernel vs plain: the fused ResnetBlock chain against its plain torch
   version at the four block shapes the shapes-grid U-Net sends through it
   (batch 8, FiLM on, 8 groups) and one small ragged shape (1 group, no
   FiLM), plus each kernel against its own plain version; one backward.
4. Main path: a synthetic shapes case (192x48x48 cells, padded 194x50x50)
   built in memory, a seeded dim-32 4-level DenoisingModel in bf16, DDIM
   with 10 steps and a 4-step ancestral run at batch 8 through
   ``training.diffusion_task.sample``.  Checks shapes, finiteness, agreement
   of one U-Net evaluation with the plain path, and that every launch
   counter rose by exactly (U-Net evaluations x engaged blocks).
5. Prints the kernels' JSON line and, last, ``{"ok": true, "device": ...}``.

Any failure exits non-zero before the last line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PALLAS = "generative_turbulence_tpu/ops/pallas_kernels.py"
BF16_RTOL, BF16_ATOL, MIN_CORR = 0.06, 0.03, 0.999
# (name, X, Y, Z, C_in, F) of the blocks the gate engages at the shapes grid
ENGAGED_BLOCKS = [
    ("u_net.down_0", 194, 50, 50, 64, 64),
    ("u_net.down_1", 97, 25, 25, 64, 128),
    ("u_net.up_0", 194, 50, 50, 128, 32),
    ("decode_resnet", 194, 50, 50, 32, 32),
]
BATCH = 8
DDIM_STEPS = 10
DDPM_STEPS = 4


class SmokeFailure(RuntimeError):
    pass


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


def compare(torch, got, want, what: str) -> float:
    """bf16 agreement: allclose(rtol 0.06, atol 0.03) and correlation > 0.999."""
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite kernel output")
    err = (got - want).abs()
    max_err = float(err.max())
    bad = int((err > BF16_ATOL + BF16_RTOL * want.abs()).sum())
    corr = float(torch.corrcoef(torch.stack([got.flatten(), want.flatten()]))[0, 1])
    log(f"  {what}: max_abs_err {max_err!r} outside tol {bad} corr {corr!r}")
    check(bad == 0, f"{what}: {bad} elements outside rtol {BF16_RTOL} / atol {BF16_ATOL}")
    check(corr > MIN_CORR, f"{what}: correlation {corr} <= {MIN_CORR}")
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

        # Each kernel against its own plain version at the down_0 shape.
        log("[3] single kernels vs their plain versions at u_net.down_0 (B=8, 64->64)")
        _, X, Y, Z, C, F = ENGAGED_BLOCKS[0]
        args = block_args(torch, gen, BATCH, X, Y, Z, C, F, True)
        x = args[0]
        w = args[1].to(torch.bfloat16).contiguous()
        b = args[2]
        act = ((1 + 0.2 * torch.randn(BATCH, C, generator=gen)).cuda(),
               (0.2 * torch.randn(BATCH, C, generator=gen)).cuda())
        a2 = (1 + 0.2 * torch.randn(BATCH, F, generator=gen)).cuda()
        c2 = (0.2 * torch.randn(BATCH, F, generator=gen)).cuda()
        h = ck.conv3x3x3_stats(x, w, b)[0]
        single = [
            ("conv3x3x3_stats", f"{PALLAS}:463", f"{PALLAS}:251",
             lambda: ck.conv3x3x3_stats(x, w, b),
             lambda: ck._conv3x3x3_stats_plain(x, w, b, None)),
            ("conv3x3x3_stats_silu_in", f"{PALLAS}:562", f"{PALLAS}:463",
             lambda: ck.conv3x3x3_stats(x, w, b, act),
             lambda: ck._conv3x3x3_stats_plain(x, w, b, act)),
            ("affine_silu", f"{PALLAS}:588", None,
             lambda: (ck.affine_silu(h, a2, c2, torch.bfloat16), None),
             lambda: (ck._affine_silu_plain(h, a2, c2, torch.bfloat16), None)),
        ]
        kernels = []
        for name, replaces, also, run, run_plain in single:
            (got, sums), (want, want_sums) = run(), run_plain()
            torch.cuda.synchronize()
            err = compare(torch, got, want, name)
            if sums is not None:
                # The moments as GroupNorm reads them: per-channel mean and
                # variance over the X*Y*Z voxels of each batch element.
                n = X * Y * Z
                mean, want_mean = sums[:, 0] / n, want_sums[:, 0] / n
                var = sums[:, 1] / n - mean**2
                want_var = want_sums[:, 1] / n - want_mean**2
                err_mean = float(((mean - want_mean).abs() / want_var.sqrt()).max())
                err_var = float(((var - want_var).abs() / want_var).max())
                log(f"  {name} channel moments: max |mean err|/std {err_mean!r}, "
                    f"max |var err|/var {err_var!r}")
                check(max(err_mean, err_var) < 1e-3, f"{name}: channel moments off")
            ms, plain = cuda_ms(torch, run, 10), cuda_ms(torch, run_plain, 10)
            log(f"    {name}: kernel {ms!r} ms, plain {plain!r} ms")
            entry = {
                "name": name, "route": "cuda",
                "source": "generative_turbulence_tpu_torch/csrc/fused_double_conv.cu",
                "replaces": replaces, "launches": 0, "max_abs_err": err,
                "ms": ms, "plain_ms": plain,
            }
            if also:
                entry["also_replaces"] = also
            kernels.append(entry)
        cudnn = cuda_ms(torch, lambda: ck._conv3d_replicate(x, w), 10)
        log(f"    for scale: cuDNN bf16 conv3d (pad + conv, no stats) {cudnn!r} ms")

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


def main_path_phase(torch, ck):
    from generative_turbulence_tpu_torch.data.grid import GridMap
    from generative_turbulence_tpu_torch.data.synthetic import build_case
    from generative_turbulence_tpu_torch.data.variables import Variable, stack_channels
    from generative_turbulence_tpu_torch.diffusion.gaussian import GaussianDiffusion, GeneratorNoise
    from generative_turbulence_tpu_torch.models.conditioning import Conditioning
    from generative_turbulence_tpu_torch.models.normalization import Normalizer
    from generative_turbulence_tpu_torch.models.unet import DenoisingModel
    from generative_turbulence_tpu_torch.training.diffusion_task import sample

    log("[4] main path: shapes case 192x48x48 (padded 194x50x50), dim 32, 4 levels, T=500, bf16")
    tic = time.perf_counter()
    variables = (Variable.U, Variable.P)
    meta, fields = build_case(cell_counts=(192, 48, 48), n_frames=1, seed=0)
    frame = stack_channels(fields, variables)[0]  # (n_cells, 4)
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
    log(f"  launches over the sampler calls: {launches} (expect {expected} each, "
        f"{3 * expected} in all = 3 x {len(ENGAGED_BLOCKS)} blocks x {n_evals} U-Net evaluations)")
    for name, count in launches.items():
        check(count == expected, f"{name}: {count} launches, expected {expected}")

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
    return launches, {"fwd_ms": fwd_ms, "plain_fwd_ms": plain_ms, **timings}


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
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"    ptxas: {line.strip()}")

    try:
        block_rows, kernels = kernel_phase(torch, ck)
        launches, timings = main_path_phase(torch, ck)
    except SmokeFailure as e:
        log(f"FAILED: {e}")
        return 1
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
    log(f"[5] card: {smi}")
    print(json.dumps({"blocks": block_rows, "main_path": timings}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
