"""The PyTorch port imports no JAX, flax, h5py, PyYAML, matplotlib or wandb,
nor the reference's sources or their test stub, and chip_smoke.py refuses to run without a GPU or outside a checkout."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO_ROOT = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import generative_turbulence_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(len(names))
banned = [m for m in ("jax", "flax", "h5py", "yaml", "matplotlib", "wandb", "generative_turbulence_tpu",
                     "turbdiff", "_reference_stub")
          if m in sys.modules]
print("BANNED", banned)
print(" ".join(names))
"""


def test_port_imports_no_jax_flax_h5py():
    res = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL],
        capture_output=True, text=True, cwd=REPO_ROOT, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    n_modules, banned, names = res.stdout.strip().splitlines()
    assert int(n_modules) >= 98  # every sub-package and module of the port so far
    assert {"generative_turbulence_tpu_torch.training.optimizers",
            "generative_turbulence_tpu_torch.training.checkpoint"} <= set(names.split())
    assert {f"generative_turbulence_tpu_torch.{name}" for name in (
        "data.npyd", "data.dataset", "ops.quadrature", "ops.stencils", "ops.spectra", "ops.sinkhorn",
        "eval", "eval.emd", "eval.sample_store", "eval.metrics", "toolchain.h5_to_npyd",
        "training.loop", "training.factory", "training.logging", "training.regression_task", "data.sequence",
        "models.tfnet", "models.dilresnet", "eval.plots", "utils.seed", "utils.exceptions", "train",
        "toolchain.import_ckpt", "scripts", "scripts._common", "scripts.eval_ckpt", "scripts.evaluate_runtime",
        "scripts.sample_metrics", "scripts.evaluate_dataset", "scripts.evaluate_from_initial",
        "scripts.evaluate_with_precision", "scripts.sampler_sweep", "scripts.import_checkpoint",
        "parallel", "parallel.distributed", "parallel.mesh", "parallel.spatial", "graft_entry", "scripts.profile_fwd", "scripts.trivial_baselines",
        "scripts.degenerate_baselines", "scripts.calibrate_sinkhorn", "scripts.tke_profile",
        "scripts.diagnose_trajectory", "scripts.summarize_run", "scripts.compare_runs", "scripts.sweep",
        "toolchain.foam_dicts", "toolchain.foam_io", "toolchain.les_case", "toolchain.mesher", "toolchain.boxmesh",
        "toolchain.shapes", "toolchain.mockflow", "toolchain.generate", "toolchain.convert", "toolchain.analysis",
        "scripts.les_case", "scripts.generate_shapes", "scripts.foam2h5", "scripts.grid_embedding",
        "scripts.dataset_stats", "scripts.case_analysis", "scripts.validate_dataset",
        "utils.wandb", "scripts.run_shapes", "scripts.split_hdf5", "scripts.split_2d3d", "scripts.generate_2d3d",
        "scripts.generate_performance_dataset", "scripts.solve_slurm",
    )} <= set(names.split())
    assert banned == "BANNED []"


def test_card_only_tests_load_without_jax():
    """The card has no JAX: the ``gpu`` tests live in a file that imports
    none, so ``pytest --noconftest -m gpu tests/test_torch_gpu.py`` runs
    there."""
    code = (
        "import sys; sys.path.insert(0, 'tests'); import test_torch_gpu; "
        "print([m for m in ('jax', 'flax', 'yaml', 'generative_turbulence_tpu') if m in sys.modules])"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO_ROOT, timeout=300
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_chip_smoke_fails_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: chip_smoke.py would run for real")
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        capture_output=True, text=True, cwd=REPO_ROOT, timeout=300,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "torch.cuda.is_available() is False" in res.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(REPO_ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def _chip_smoke():
    """chip_smoke.py as a module (it imports torch only when it runs)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO_ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_bound_takes_the_slower_rate():
    """chip_smoke.py's bound: the larger of the bytes over the memory rate
    and each operation count over its peak rate.  At the 2-level path's
    attention shape the exponentials bind bf16 (1.53e9 ex2 at 3.9e12/s,
    beside 0.198 ms of tensor-core FLOP); affine_silu at u_net.down_0 is
    bound by its bytes."""
    smoke = _chip_smoke()
    B, H, N, D = smoke.FLASH_PATH_SHAPE
    got = smoke.bound(4 * B * H * N * D * 2, **{"bf16 tensor FLOP": 4 * B * H * N * N * D,
                                                "MUFU ex2": B * H * N * N})
    assert (got["bound_by"], got["bound_kind"]) == ("operations", "MUFU ex2")
    assert got["bound_ms"] == pytest.approx(B * H * N * N / 3.9e12 * 1e3)
    assert got["bound_ms"] == pytest.approx(0.392006, rel=1e-5)
    h = 8 * 194 * 50 * 50 * 64
    got = smoke.bound(2 * h * 2 + 2 * 8 * 64 * 4, **{"MUFU ex2": h})
    assert (got["bound_by"], got["bound_kind"]) == ("bytes", "bytes")
    assert got["bound_ms"] == pytest.approx((4 * h + 4096) / 3.35e12 * 1e3)


@pytest.mark.parametrize("factor", [1.0, 0.9, 1.1])
def test_chip_smoke_flash_check_holds_the_output_scale(factor):
    """chip_smoke.py's bf16 flash_attention check at 2100 keys, where a 10%
    error of the largest output is still below the plain atol of 0.03: the
    plain check passes the exact output scaled by 0.9 or 1.1; the scaled one
    (atol relative to max |out|, relative L2 error <= 1e-2) refuses it and
    passes the exact output rounded to bf16, as the kernel writes it."""
    import torch

    smoke = _chip_smoke()
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 2100, 32, generator=gen) for _ in range(3))
    want = torch.softmax(q @ k.transpose(-1, -2) * 32**-0.5, dim=-1) @ v
    assert 0.1 * float(want.abs().max()) < smoke.BF16_ATOL
    got = (want * factor).to(torch.bfloat16)
    smoke.compare(torch, got, want, "plain check", quiet=True)
    if factor == 1.0:
        smoke.compare(torch, got, want, "scaled check", quiet=True, scaled=True)
    else:
        with pytest.raises(smoke.SmokeFailure):
            smoke.compare(torch, got, want, "scaled check", quiet=True, scaled=True)
