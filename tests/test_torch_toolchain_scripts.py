"""The port's last toolchain entry points (``split_hdf5``, ``split_2d3d``,
``generate_2d3d``, ``generate_performance_dataset``, ``solve_slurm``) against
the JAX package's scripts on the same inputs, and ``utils/wandb.py`` against
the JAX module with a stub ``wandb``.

``generate_2d3d comparison --scales 0.75 --mock-solve --frames 3`` (the
smallest scale the JAX script meshes in 2D: 144x36x36 and 144x36x1 cells)
writes the same case trees byte for byte and the same case files (JAX's
``data.h5``, the port's ``data.npyd``); the splits of one case and of the
study hold the same frames; ``generate_performance_dataset --widths 2``
(2 subdomains, the channel at scale 0.25) writes JAX's tree; ``solve_slurm --dry-run``
writes JAX's case list and sbatch text.  Faults of the reference shown here:
``split-2d3d`` finds no case of a ``.npyd`` study (it looks for
``data.h5``), and ``generate-2d3d comparison`` fails on its 2D case below
scale 0.75 (the port keeps the 2D channel's one z cell at every scale).  One
subprocess, where ``import h5py`` fails, runs the split, the 2D/3D
generation and the performance dataset.
"""

import functools
import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from generative_turbulence_tpu.toolchain import generate as jgenerate
from generative_turbulence_tpu.toolchain.generate import ChannelConfig as JChannelConfig
from generative_turbulence_tpu.utils import wandb as jwandb
from generative_turbulence_tpu_torch.data.npyd import read_tree
from generative_turbulence_tpu_torch.scripts import (
    generate_2d3d,
    generate_performance_dataset,
    solve_slurm,
    split_2d3d,
    split_hdf5,
)
from generative_turbulence_tpu_torch.toolchain import generate as tgenerate
from generative_turbulence_tpu_torch.toolchain.generate import ChannelConfig
from generative_turbulence_tpu_torch.toolchain.shapes import shape_boxes, shape_catalog
from generative_turbulence_tpu_torch.utils import wandb
from test_torch_scripts import jax_script
from test_torch_toolchain import assert_same_case_file, assert_same_tree

REPO = Path(__file__).resolve().parent.parent
COMPARISON = ["comparison", "--scales", "0.75", "--mock-solve", "--frames", "3"]
CASES = ["scale-0.75-2d", "scale-0.75-3d"]
DATA_FILES = ("data.h5", "data.npyd")


def run_jax(name, argv, monkeypatch):
    """``scripts/<name>.py``'s ``main`` with ``argv`` as its command line."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *map(str, argv)])
    return jax_script(name).main()


@pytest.fixture(scope="module")
def studies(tmp_path_factory):
    """The 2D/3D comparison study by the JAX script (``.h5``) and by the port
    (``.npyd``)."""
    root = tmp_path_factory.mktemp("studies")
    with pytest.MonkeyPatch.context() as mp:
        run_jax("generate-2d3d", [COMPARISON[0], root / "jax", *COMPARISON[1:]], mp)
    names = generate_2d3d.main([COMPARISON[0], str(root / "port"), *COMPARISON[1:]])
    assert names == CASES
    return {"jax": root / "jax", "port": root / "port"}


def test_generate_2d3d_matches_jax(studies, capsys):
    for name in CASES:
        jax_case, case = studies["jax"] / "cases" / name, studies["port"] / "cases" / name
        assert_same_tree(case, jax_case, skip=DATA_FILES)
        assert not (case / "data.h5").exists()
        assert_same_case_file(case / "data.npyd", jax_case / "data.h5")
    counts = json.loads((studies["port"] / "cases" / CASES[0] / "mesh-params.json").read_text())["cell_counts"]
    assert counts == [144, 36, 1]


def test_split_hdf5_matches_jax(studies, tmp_path, monkeypatch, capsys):
    """One case's frames into 80/10/10 time ranges, from the ``.npyd`` case
    and the ``.h5`` one, written in either format."""
    jax_file = studies["jax"] / "cases" / CASES[1] / "data.h5"
    run_jax("split-hdf5", [jax_file, tmp_path / "jax"], monkeypatch)
    npyd = split_hdf5.main([str(studies["port"] / "cases" / CASES[1] / "data.npyd"), str(tmp_path / "npyd")])
    h5 = split_hdf5.main([str(jax_file), str(tmp_path / "h5"), "--format", "h5"])
    printed = capsys.readouterr().out
    for split in ("train", "val", "test"):
        want = tmp_path / "jax" / split / CASES[1] / "data.h5"
        assert npyd[split] == tmp_path / "npyd" / split / CASES[1] / "data.npyd" and f"{split}: {npyd[split]}" in printed
        assert_same_case_file(npyd[split], want)
        assert_same_case_file(h5[split], want)
    assert len(read_tree(npyd["train"])[0]["data/times"]) == 1  # int(2 x 0.8) of the 2 frames kept (the first is dropped)


def test_split_2d3d_matches_jax_and_reads_a_npyd_study(studies, tmp_path, monkeypatch, capsys):
    """Every case of the study; JAX's script, which opens ``data.h5`` by
    name, stops on the ``.npyd`` study the port splits."""
    jax_study, study = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(studies["jax"], jax_study, symlinks=True)
    shutil.copytree(studies["port"], study, symlinks=True)
    run_jax("split-2d3d", [jax_study], monkeypatch)
    out = split_2d3d.main([str(study)])
    assert list(out) == CASES
    for name in CASES:
        for split in ("train", "val", "test"):
            assert out[name][split] == study / split / name / "data.npyd"
            assert_same_case_file(out[name][split], jax_study / split / name / "data.h5")
    assert f"{CASES[0]}: train=" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="no converted cases"):
        run_jax("split-2d3d", [study], monkeypatch)


def test_generate_2d3d_keeps_the_2d_z_cell_at_every_scale(tmp_path, monkeypatch):
    """At the JAX script's two smallest default scales its 2D hole (z from
    0 to 1) scales to an empty box and the run stops; the port's 2D cases
    keep their one z cell, and the 3D cases are JAX's (1.5 would give JAX a
    2D case of 2 z cells)."""
    argv = ["comparison", tmp_path / "jax", "--scales", "0.25", "0.5"]
    with pytest.raises(AssertionError, match="empty box"):
        run_jax("generate-2d3d", argv, monkeypatch)
    names = generate_2d3d.main(["comparison", str(tmp_path / "port"), "--scales", "0.25", "0.5"])
    assert names == ["scale-0.25-2d", "scale-0.25-3d", "scale-0.5-2d", "scale-0.5-3d"]
    for name, counts in (("scale-0.25-2d", [48, 12, 1]), ("scale-0.5-2d", [96, 24, 1]), ("scale-0.5-3d", [96, 24, 24])):
        params = json.loads((tmp_path / "port" / "cases" / name / "mesh-params.json").read_text())
        assert params["cell_counts"] == counts
    holes = shape_boxes(shape_catalog()["square-medium"])
    for scale in (0.75, 1.0, 1.25):  # where JAX meshes it: the same 2D channel
        ours = ChannelConfig(holes=holes, scale=scale).two_dimensionalized()
        theirs = JChannelConfig(holes=holes, scale=scale).two_dimensionalized()
        assert ours.scaled_counts == theirs.scaled_counts
        assert [(b.lo, b.hi) for b in ours.scaled_holes()] == [(b.lo, b.hi) for b in theirs.scaled_holes()]


@pytest.fixture(scope="module")
def performance(tmp_path_factory):
    """The performance case of width 2 by the JAX script and by the port, on
    the channel at scale 0.25 in both packages (the scripts take no scale;
    the full grid costs ~10 s a case here)."""
    root = tmp_path_factory.mktemp("performance")
    with pytest.MonkeyPatch.context() as mp:
        for module in (jgenerate, tgenerate):
            mp.setattr(module, "ChannelConfig", functools.partial(module.ChannelConfig, scale=0.25))
        run_jax("generate-performance-dataset", [root / "jax", "--widths", "2"], mp)
        cases = generate_performance_dataset.main([str(root / "port"), "--widths", "2"])
    assert cases == [root / "port" / "cases" / "parallel-2"]
    return root


def test_generate_performance_dataset_matches_jax(performance):
    assert_same_tree(performance / "port", performance / "jax")
    text = (performance / "port" / "cases" / "parallel-2" / "system" / "decomposeParDict").read_text()
    assert "numberOfSubdomains 2;" in text


def test_solve_slurm_dry_run_matches_jax(performance, studies, monkeypatch, capsys):
    """The case list and the sbatch text, written into the same cases root
    by the JAX script and then by the port, for the performance case (2
    CPUs per task) and the study (1), with a partition and each runner;
    nothing is submitted."""
    for root, cpus in ((performance / "jax" / "cases", 2), (studies["jax"] / "cases", 1)):
        for extra in (["--partition", "gpu"], ["--runner", "docker"], ["--runner", "native", "--time", "1:00:00"]):
            texts = []
            for main in (lambda argv: run_jax("solve-slurm", argv, monkeypatch), solve_slurm.main):
                assert main([str(root), "--dry-run", *extra]) in (None, 0)
                texts.append([(root / f).read_text() for f in ("slurm-cases.txt", "solve.sbatch")])
                (root / "solve.sbatch").unlink()
            assert texts[1] == texts[0]
            assert f"#SBATCH --cpus-per-task={cpus}" in texts[1][1]
    printed = capsys.readouterr().out
    assert "wrote" in printed and "cpus each" in printed


def test_solve_slurm_without_cases(tmp_path, capsys):
    assert solve_slurm.main([str(tmp_path)]) == 1
    assert "no cases found" in capsys.readouterr().err


_WITHOUT_H5PY = """
import json, sys
sys.modules["h5py"] = None  # import h5py now raises ImportError
from pathlib import Path
import functools
from generative_turbulence_tpu_torch.scripts import (
    generate_2d3d, generate_performance_dataset, split_2d3d, split_hdf5, validate_dataset)
from generative_turbulence_tpu_torch.toolchain import generate
generate.ChannelConfig = functools.partial(generate.ChannelConfig, scale=0.25)  # the performance case's grid

root = Path(sys.argv[1])
names = generate_2d3d.main(["comparison", str(root / "study"), "--scales", "0.25", "--mock-solve", "--frames", "4"])
study = split_2d3d.main([str(root / "study")])
one = split_hdf5.main([str(root / "study" / "cases" / names[1] / "data.npyd"), str(root / "one")])
cases = generate_performance_dataset.main([str(root / "performance"), "--widths", "1"])
try:
    import h5py
    importable = True
except ImportError:
    importable = False
files = sorted(str(p.relative_to(root)) for p in root.rglob("data.*"))
print(json.dumps({"names": names, "splits": {k: sorted(v) for k, v in study.items()},
                  "one": sorted(one), "cases": [p.name for p in cases], "files": files,
                  "validate": validate_dataset.main([str(root / "study"), "--deep"]),
                  "h5py_importable": importable}))
"""


def test_entry_points_need_no_h5py(tmp_path):
    """The 2D/3D comparison study at scale 0.25 (4 mock frames, 3 kept), its
    split, one case's split and the performance case (at scale 0.25, as in
    ``performance``), in a process where
    ``import h5py`` fails: ``.npyd`` files only, whose study
    ``validate_dataset`` finds intact (it misses only the analyses, which
    the 2D/3D study has none of, as in JAX)."""
    res = subprocess.run([sys.executable, "-c", _WITHOUT_H5PY, str(tmp_path)], capture_output=True, text=True,
                         cwd=REPO, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["names"] == ["scale-0.25-2d", "scale-0.25-3d"] and out["cases"] == ["parallel-1"]
    assert out["splits"] == {name: ["test", "train", "val"] for name in out["names"]}
    assert out["one"] == ["test", "train", "val"] and not out["h5py_importable"]
    assert len(out["files"]) == 2 + 2 * 3 + 3 and all(f.endswith("data.npyd") for f in out["files"])
    missing = ["missing mean-flow.npyd or mean-flow.h5", "missing regions.npz", "missing max-mean-tke.npy"]
    assert out["validate"] == {"n_cases": 2, "failed": {name: missing for name in out["names"]}}


class _StubFile:
    def __init__(self, name):
        self.name = name

    def download(self, root, replace):
        path = Path(root) / self.name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(f"{self.name} {replace}")


class _StubRun:
    config = {"model": {"name": "diffusion"}, "seed": 3}

    def files(self):
        return [_StubFile("checkpoints/last.pt"), _StubFile("checkpoints/best.pt"), _StubFile("output.log")]


def _stub_wandb(calls):
    class Api:
        def run(self, path):
            calls.append(path)
            return _StubRun()

    return types.SimpleNamespace(Api=Api)


@pytest.mark.parametrize("module", [wandb, jwandb], ids=["port", "jax"])
def test_wandb_helpers_with_a_stub(module, tmp_path, monkeypatch):
    """Each helper through a stub ``wandb`` (no network): the same calls and
    files from the port's module as from the JAX one."""
    calls = []
    monkeypatch.setitem(sys.modules, "wandb", _stub_wandb(calls))
    assert module.wandb_available()
    assert module.get_run("team/proj/abc").config["seed"] == 3
    assert module.run_config("team/proj/abc") == _StubRun.config
    out = module.download_checkpoint("team/proj/abc", tmp_path / "best", which="best")
    assert sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file()) == ["checkpoints/best.pt"]
    with pytest.raises(FileNotFoundError, match="No checkpoint matching 'missing'"):
        module.download_checkpoint("team/proj/abc", tmp_path / "none", which="missing")
    config, ckpt = module.restart_checkpoint("team/proj/abc", tmp_path / "restart")
    assert config == _StubRun.config and (ckpt / "checkpoints" / "last.pt").read_text() == "checkpoints/last.pt True"
    assert calls == ["team/proj/abc"] * 6  # restart_checkpoint resolves the run twice
    monkeypatch.setitem(sys.modules, "wandb", None)
    assert not module.wandb_available()
    with pytest.raises(ImportError):
        module.run_config("team/proj/abc")
