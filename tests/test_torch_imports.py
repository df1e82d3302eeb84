"""The PyTorch port imports no JAX, flax, h5py or PyYAML, and chip_smoke.py
refuses to run without a GPU or outside a checkout."""

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
banned = [m for m in ("jax", "flax", "h5py", "yaml", "generative_turbulence_tpu") if m in sys.modules]
print("BANNED", banned)
"""


def test_port_imports_no_jax_flax_h5py():
    res = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL],
        capture_output=True, text=True, cwd=REPO_ROOT, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    n_modules, banned = res.stdout.strip().splitlines()
    assert int(n_modules) >= 25  # every sub-package and module of slices 1 and 2
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
