#!/usr/bin/env python3
"""Variants of the bf16 flash_attention kernel timed against each other on
one card, in turns, at the 2-level U-Net bottleneck's shape (8, 4, 6912, 32)
on the U-Net's strided qkv views.

Run from the repository root:  python3 flash_ab.py

The variants are the kernel of ``csrc/flash_attention.cu`` as it stands
("kernel"), timing-only ablations of it made by text substitution (their
outputs are wrong by design; only their times count):

- ``no_exp``: each exponential replaced by its FFMA argument (MUFU idle);
- ``no_pv``: no O += P V product;
- ``no_softmax``: P is S rounded to bf16 (no max, exponentials or sums);
- ``no_loads``: the producer issues no TMA copy and completes each stage's
  barrier at once;

two other shapes of the same design (checked against the plain version):

- ``two_wg``: two consumer warpgroups (128-query work items), not three;
- ``keys_64``: 64-key stages at D = 32, not 128.

The substitutions find their text in the kernel source or stop the script
with the name of the variant to update.  Each variant is built by its own nvcc, all at once, into
build/kernels/flash_ab/, and timed as the median of 20 launches in each of
4 rounds, the order of the variants reversed every round.  Prints the card's
name and power limit first and one JSON line of medians last.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPE = (8, 4, 48 * 12 * 12, 32)

PV = """      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BKV / 16; ++ks) {
        const uint32_t a[4] = {p[4 * ks], p[4 * ks + 1], p[4 * ks + 2], p[4 * ks + 3]};
        WgmmaRS<DK>::mma(o, a, desc(vst + ks * 256, 128, G::PLANE));
      }
      wgmma_commit();
      wgmma_wait<0>();
"""
SOFTMAX = ("      float mx0 = m0, mx1 = m1;", "      // ---- O += P V")
NO_SOFTMAX = """      uint32_t p[BKV / 4];
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        p[2 * j] = pack_bf16(s[4 * j], s[4 * j + 1]);
        p[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
      }
      l0 += s[0];
      l1 += s[2];

"""
LOADS = ("          mbar_expect_tx(full + slot, bytes);", "          }\n")
ABLATIONS = {
    "no_exp": [('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));', "y = x;")],
    "no_pv": [(PV, "")],
    "no_softmax": [SOFTMAX],
    "no_loads": [LOADS],
}
SHAPES = {
    "two_wg": [("constexpr int NWG = 3;", "constexpr int NWG = 2;")],
    "keys_64": [("static constexpr int BKV = DK <= 32 ? 128 : 64;", "static constexpr int BKV = 64;")],
}


def substitute(src: str, name: str, edits) -> str:
    for old, new in edits:
        try:
            if (old, new) == SOFTMAX:  # a span: from the max to the P V comment
                start, end = src.index(old), src.index(new)
                src = src[:start] + NO_SOFTMAX + src[end:]
            elif (old, new) == LOADS:  # a span: the expect_tx and the copy loop
                start = src.index(old)
                end = src.index(new, src.index("tma_load_4d(vst", start)) + len(new)
                src = src[:start] + "          mbar_arrive(full + slot);\n" + src[end:]
            elif src.count(old) == 1:
                src = src.replace(old, new)
            else:
                raise ValueError
        except ValueError:
            raise SystemExit(f"{name}: the kernel source changed; update this variant ({old[:50]!r})")
    return src


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    from generative_turbulence_tpu_torch.ops import cuda_kernels as ck

    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False; this script needs a GPU")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    base = (ck.CSRC_DIR / "flash_attention.cu").read_text()
    sources = {"kernel": base}
    sources.update({n: substitute(base, n, e) for n, e in {**ABLATIONS, **SHAPES}.items()})
    out = ck.BUILD_DIR / "flash_ab"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        (out / f"{name}.cu").write_text(src)
        cmd = [ck._nvcc(), *ck.NVCC_FLAGS, "-shared", "-o", str(out / f"{name}.so"), str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        text = proc.communicate()[0]
        warnings = [line.strip() for line in text.splitlines() if "C75" in line or " error" in line]
        print(f"{name}: nvcc rc {proc.returncode}" + "".join(f"\n  {w[:160]}" for w in warnings), flush=True)
        if proc.returncode:
            return 1
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.gt_flash_attention.argtypes = [p, p, p, p, i, i, i, i, i, *([ll] * 9), p]
        lib.gt_flash_attention.restype = i
        libs[name] = lib

    B, H, N, D = SHAPE
    qkv = torch.randn(B, N, 3, H, D, generator=torch.Generator().manual_seed(0)).to("cuda", torch.bfloat16)
    q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    outs = {name: torch.empty(SHAPE, dtype=torch.bfloat16, device="cuda") for name in libs}

    def run(name):
        status = libs[name].gt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), outs[name].data_ptr(), 0, B, H, N, D, *strides,
            torch.cuda.current_stream().cuda_stream)
        if status:
            raise RuntimeError(f"{name}: cudaError {status}")

    want = ck._flash_attention_plain(q, k, v).float()
    for name in libs:
        run(name)
        torch.cuda.synchronize()
        if name in ABLATIONS:
            continue
        got = outs[name].float()
        err = float((got - want).abs().max())
        corr = float(torch.corrcoef(torch.stack([got.flatten(), want.flatten()]))[0, 1])
        print(f"{name}: max_abs_err {err!r} corr {corr!r}", flush=True)
        if not (err < 0.03 + 0.06 * float(want.abs().max()) and corr > 0.999):
            print(f"error: {name} disagrees with the plain version")
            return 1

    def median_ms(name, reps=20):
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run(name)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    order, rounds = list(libs), {name: [] for name in libs}
    for r in range(4):
        for name in order if r % 2 == 0 else order[::-1]:
            rounds[name].append(median_ms(name))
    medians = {name: statistics.median(ts) for name, ts in rounds.items()}
    for name, ts in rounds.items():
        print(f"{name}: {medians[name]!r} ms (rounds {ts}); / kernel {medians[name] / medians['kernel']!r}")
    print(json.dumps({"card": smi.stdout.strip(), "shape": list(SHAPE), "ms": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
