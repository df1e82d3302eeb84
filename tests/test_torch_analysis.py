"""The port's per-case analyses (``generative_turbulence_tpu_torch/toolchain/
analysis.py``) and the toolchain's entry points (``generate_shapes``,
``case_analysis``, ``dataset_stats``, ``validate_dataset``) against the JAX
package's on the same inputs.

One generated case is shared by the file: the first train shape at
``--scale 0.25`` (48x12x12 cells), 8 frames mock-solved by the JAX package
into ``data.h5``, and the same datasets as ``data.npyd``.  Each analysis of
the port reads either file; its outputs equal the JAX package's on the
``data.h5`` (host numpy on both sides, bit for bit), but for
``first_turbulent_frame``'s spectra, which run on torch's CPU here: its
index is equal and its distance matrices agree at the f32 tolerance.
"""

import json
import math
import pickle
import shutil
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from generative_turbulence_tpu.ops import spectra as jspectra
from generative_turbulence_tpu.toolchain import analysis as janalysis
from generative_turbulence_tpu.toolchain import generate as jgenerate
from generative_turbulence_tpu.toolchain import shapes as jshapes
from generative_turbulence_tpu.toolchain.boxmesh import build_polymesh as j_build_polymesh
from generative_turbulence_tpu.toolchain.convert import add_grid_embedding as j_add_grid_embedding
from generative_turbulence_tpu_torch.data.npyd import open_case_file, read_tree, write_case_file
from generative_turbulence_tpu_torch.data.schema import FieldStats
from generative_turbulence_tpu_torch.scripts import case_analysis, dataset_stats, generate_shapes, validate_dataset
from generative_turbulence_tpu_torch.toolchain import analysis
from test_torch_scripts import jax_script
from test_torch_toolchain import assert_same_case_file

REPO = Path(__file__).resolve().parents[1]
F32_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_torch_eval_ops.py
FORMATS = ["npyd", "h5"]
SCALE = 0.25
N_FRAMES = 8
SPECTRA = dict(n_sphere=128, n_legendre=8, n_reference=4)  # tests/test_analysis.py's


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """{"h5": the JAX package's data.h5, "npyd": the same as data.npyd}, in
    case directories of their own."""
    root = tmp_path_factory.mktemp("analysis")
    name = jshapes.dataset_split(jshapes.shape_catalog())["train"][0]
    config = jgenerate.ChannelConfig(holes=jshapes.shape_boxes(jshapes.shape_catalog()[name]), scale=SCALE)
    case_dir = root / "h5" / name
    jgenerate.generate_case(case_dir, config, write_polymesh_too=False)
    mesh = j_build_polymesh(jgenerate.domain_mask(config), config.h)
    h5 = jgenerate.mock_solve_direct(case_dir, config, n_frames=N_FRAMES, seed=zlib.crc32(name.encode()) % 2**31,
                                     mesh=mesh)
    j_add_grid_embedding(h5, case_dir, mesh_override=mesh)
    npyd = root / "npyd" / name / "data.npyd"
    write_case_file(npyd, *read_tree(h5))
    return {"h5": h5, "npyd": npyd}


# ---- twins of tests/test_analysis.py::TestAnalysis ------------------------------------------


class TestAnalysis:
    @pytest.mark.parametrize("fmt", FORMATS)
    def test_dataset_stats(self, case, fmt, tmp_path):
        out = tmp_path / "stats.pickle"
        stats = analysis.dataset_stats([case[fmt]], out)
        janalysis.dataset_stats([case["h5"]], tmp_path / "jax.pickle")
        loaded = FieldStats.from_file(out)
        for key in ("u", "p", "k", "nut", "norm(u)", "norm(curl)"):
            assert key in loaded.stats
        assert np.all(loaded.stats["u"]["max"] >= loaded.stats["u"]["min"])
        assert loaded.stats["norm(u)"]["mean"] > 0
        want = pickle.loads((tmp_path / "jax.pickle").read_bytes())
        assert loaded.stats.keys() == want.keys() == stats.stats.keys()
        for key, values in want.items():
            for name, value in values.items():
                np.testing.assert_array_equal(loaded.stats[key][name], value, err_msg=f"{key} {name}")

    @pytest.mark.parametrize("fmt", FORMATS)
    def test_mean_flow(self, case, fmt, tmp_path):
        out = analysis.mean_flow(case[fmt], tmp_path / f"mf.{fmt}", discard_first_seconds=-1, format=fmt)
        with open_case_file(out) as f:
            u = np.asarray(f["data/u"])
            assert u.ndim == 2 and u.shape[1] == 3
        with open_case_file(case[fmt]) as f:
            expect = np.asarray(f["data/u"]).mean(axis=0)
        np.testing.assert_allclose(u, expect, rtol=1e-5)
        want = janalysis.mean_flow(case["h5"], tmp_path / "jax.h5", discard_first_seconds=-1)
        assert_same_case_file(out, want)
        # by default beside the case file, in the format asked for
        default = analysis.mean_flow(case[fmt], discard_first_seconds=-1, format=fmt)
        assert default == case[fmt].parent / f"mean-flow.{fmt}"
        assert_same_case_file(default, want)

    @pytest.mark.parametrize("fmt", FORMATS)
    def test_homogeneous_regions(self, case, fmt, tmp_path):
        out = tmp_path / "regions.npz"
        assignments = analysis.homogeneous_regions(
            case[fmt], out, k=8, max_cluster_size=500, discard_first_seconds=-1
        )
        with open_case_file(case[fmt]) as f:
            n_cells = f["data/u"].shape[1]
        assert assignments.shape == (n_cells,)
        sizes = np.bincount(assignments)
        assert len(sizes) >= 8
        assert sizes.max() <= 500
        assert np.load(out)["assignments"].shape == (n_cells,)
        want = janalysis.homogeneous_regions(
            case["h5"], tmp_path / "jax.npz", k=8, max_cluster_size=500, discard_first_seconds=-1
        )
        np.testing.assert_array_equal(assignments, want)
        np.testing.assert_array_equal(np.load(out)["assignments"], np.load(tmp_path / "jax.npz")["assignments"])

    @pytest.mark.parametrize("fmt", FORMATS)
    def test_max_mean_tke(self, case, fmt, tmp_path):
        value = analysis.max_mean_tke(case[fmt], tmp_path / "mmt.npy", discard_first_seconds=-1)
        assert value >= 0
        assert float(np.load(tmp_path / "mmt.npy")) == value
        want = janalysis.max_mean_tke(case["h5"], tmp_path / "jax.npy", discard_first_seconds=-1)
        assert value == want
        assert (tmp_path / "mmt.npy").read_bytes() == (tmp_path / "jax.npy").read_bytes()

    @pytest.mark.parametrize("fmt", FORMATS)
    def test_first_turbulent_frame(self, case, fmt, monkeypatch):
        """The index equal to JAX's; both distance matrices (the late frames
        among themselves, every frame to the late ones) at the f32
        tolerance, JAX's recorded from its ``log_tke_distance_matrix``."""
        recorded = []
        distance = jspectra.log_tke_distance_matrix

        def record(*args):
            out = distance(*args)
            recorded.append(np.array(out[0]))
            return out

        monkeypatch.setattr(jspectra, "log_tke_distance_matrix", record)
        want = janalysis.first_turbulent_frame(case["h5"], **SPECTRA)
        got = analysis.turbulent_frame_distances(case[fmt], device="cpu", **SPECTRA)
        frame = analysis.first_turbulent_frame(case[fmt], device="cpu", **SPECTRA)
        assert 0 <= frame <= N_FRAMES
        assert got["first"] == frame == want
        want_late, want_all = recorded
        np.fill_diagonal(want_late, np.inf)
        assert got["late"].shape == (4, 4) and got["all"].shape == (N_FRAMES, 4)
        np.testing.assert_allclose(got["late"], want_late, **F32_TOL)
        np.testing.assert_allclose(got["all"], want_all, **F32_TOL)
        assert got["limit"] == pytest.approx(2.0 * want_late.min(axis=1).max(), rel=F32_TOL["rtol"])

    @pytest.mark.parametrize("fmt", FORMATS)
    def test_autocorrelation(self, case, fmt, tmp_path):
        steps = analysis.autocorrelation(case[fmt], tmp_path / "ac.npz", discard_first_seconds=-1)
        data = np.load(tmp_path / "ac.npz")
        assert data["correlation"][0] == pytest.approx(1.0, abs=1e-3)
        assert steps == int(data["decorrelation_steps"])
        want = janalysis.autocorrelation(case["h5"], tmp_path / "jax.npz", discard_first_seconds=-1)
        assert steps == want
        np.testing.assert_array_equal(data["correlation"], np.load(tmp_path / "jax.npz")["correlation"])

    @pytest.mark.parametrize("fmt", FORMATS)
    def test_split_h5(self, case, fmt, tmp_path):
        """The splits of a ``.npyd`` or ``.h5`` case, written in the format
        asked for: the JAX package's splits of the ``.h5``."""
        out = analysis.split_h5(case[fmt], tmp_path / "port", fractions=(0.5, 0.25, 0.25), format=fmt)
        want = janalysis.split_h5(case["h5"], tmp_path / "jax", fractions=(0.5, 0.25, 0.25))
        with open_case_file(case[fmt]) as f:
            T = len(np.asarray(f["data/times"]))
        total = 0
        assert list(out) == list(want) == ["train", "val", "test"]
        for split, path in out.items():
            assert path.name == f"data.{fmt}" and path.parent.name == case[fmt].parent.name
            with open_case_file(path) as f:
                total += len(np.asarray(f["data/times"]))
                assert "grid" in f and "boundary-conditions" in f
            assert_same_case_file(path, want[split])
        assert total == T


# ---- the entry points ---------------------------------------------------------------------


def _shapes_args(out, fmt):
    return [str(out), "--mock-solve", "--frames", "4", "--scale", str(SCALE), "--limit", "1", "--format", fmt]


@pytest.fixture(scope="module")
def jax_shapes(tmp_path_factory):
    """The JAX script's ``generate-shapes --mock-solve --frames 4 --scale 0.25
    --limit 1`` (three cases: the first of each split)."""
    out = tmp_path_factory.mktemp("jax-shapes") / "shapes"
    module = jax_script("generate-shapes")
    saved = sys.argv
    sys.argv = ["generate-shapes.py", *_shapes_args(out, "h5")[:-2]]
    try:
        module.main()
    finally:
        sys.argv = saved
    return out


@pytest.mark.parametrize("fmt", FORMATS)
def test_generate_shapes_matches_jax(jax_shapes, fmt, tmp_path, capsys):
    """Every case file, mean flow, regions, max-mean-TKE position and the
    root's ``stats.pickle`` as the JAX script writes them; the ASCII case
    trees byte for byte; the split links."""
    out = tmp_path / "shapes"
    got = generate_shapes.main(_shapes_args(out, fmt))
    printed = capsys.readouterr().out
    assert "wrote stats.pickle" in printed
    assert got["format"] == fmt and set(got["cases"].values()) == {"generated"}
    for split in ("train", "val", "test"):
        assert sorted(p.name for p in (out / split).iterdir()) == sorted(p.name for p in (jax_shapes / split).iterdir())
        assert got["splits"][split] == [p.name for p in sorted((jax_shapes / split).iterdir())]
    for case in sorted((jax_shapes / "cases").iterdir()):
        mine = out / "cases" / case.name
        assert f"generated {case.name}" in printed
        for stem in ("data", "mean-flow"):
            assert_same_case_file(mine / f"{stem}.{fmt}", case / f"{stem}.h5")
        np.testing.assert_array_equal(np.load(mine / "regions.npz")["assignments"],
                                      np.load(case / "regions.npz")["assignments"])
        assert (mine / "max-mean-tke.npy").read_bytes() == (case / "max-mean-tke.npy").read_bytes()
        for f in case.rglob("*"):
            rel = f.relative_to(case)
            if f.is_file() and rel.suffix not in (".h5", ".npz", ".npy"):
                assert (mine / rel).read_bytes() == f.read_bytes(), rel
    want = pickle.loads((jax_shapes / "stats.pickle").read_bytes())
    stats = pickle.loads((out / "stats.pickle").read_bytes())
    assert stats.keys() == want.keys()
    for key in want:
        for name in want[key]:
            np.testing.assert_array_equal(stats[key][name], want[key][name], err_msg=f"{key} {name}")

    # --resume finds this format's artifacts and skips every case.
    again = generate_shapes.main([*_shapes_args(out, fmt), "--resume"])
    assert set(again["cases"].values()) == {"complete"}


_GENERATE_WITHOUT_H5PY = """
import json, sys
sys.modules["h5py"] = None  # import h5py now raises ImportError
from pathlib import Path
from generative_turbulence_tpu_torch.data.dataset import DataModule
from generative_turbulence_tpu_torch.data.variables import Variable
from generative_turbulence_tpu_torch.scripts import generate_shapes, validate_dataset

out = Path(sys.argv[1])
generate_shapes.main([str(out), "--mock-solve", "--frames", "4", "--scale", "0.25", "--limit", "1"])
case = next((out / "train").iterdir())
dm = DataModule(out, discard_first_seconds=-1.0, batch_size=2, variables=(Variable.U, Variable.P))
dm.setup("fit")
batch = next(iter(dm.train_batches()))
result = validate_dataset.main([str(out), "--deep"])
try:
    import h5py
    importable = True
except ImportError:
    importable = False
try:
    generate_shapes.main([str(out / "h5"), "--mock-solve", "--frames", "2", "--scale", "0.25", "--limit", "1",
                          "--format", "h5"])
    h5_error = None
except ModuleNotFoundError as e:
    h5_error = str(e)
print(json.dumps({"files": sorted(p.name for p in case.iterdir()), "n_train": len(dm.train_dataset),
                  "batch": batch.cells.shape[0], "validate": result, "h5py_importable": importable,
                  "h5_error": h5_error}))
"""


def test_generate_shapes_without_h5py(tmp_path):
    """``generate_shapes --mock-solve --scale 0.25 --limit 1`` in a process
    where ``import h5py`` fails: ``.npyd`` cases that the port's
    ``DataModule`` loads (4 mock frames less the dropped first time
    directory: 3 usable frames) and ``validate_dataset`` passes; ``--format
    h5`` there raises and names ``--format npyd``."""
    res = subprocess.run([sys.executable, "-c", _GENERATE_WITHOUT_H5PY, str(tmp_path / "shapes")],
                         capture_output=True, text=True, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert {"data.npyd", "mean-flow.npyd", "regions.npz", "max-mean-tke.npy"} <= set(out["files"])
    assert not any(name.endswith(".h5") for name in out["files"])
    assert out["n_train"] == 3
    assert out["batch"] in (1, 2)
    assert out["validate"] == {"n_cases": 3, "failed": {}}
    assert not out["h5py_importable"]
    assert "--format npyd" in out["h5_error"]


def test_case_analysis_cli(case, tmp_path, capsys):
    """``--max-mean-tke`` and ``--mean-flow`` on the host; ``--first-turbulent-frame``
    with ``--device cpu``: the JAX package's values.  Its default device is
    the GPU, which stops the run on a machine without one before anything
    is written."""
    data = tmp_path / "case" / "data.npyd"
    shutil.copytree(case["npyd"], data)
    got = case_analysis.main([str(data), "--max-mean-tke", "--mean-flow", "--discard", "-1"])
    printed = capsys.readouterr().out
    assert "max-mean-tke position" in printed and f"mean flow -> {data.parent / 'mean-flow.npyd'}" in printed
    assert got["max_mean_tke"] == janalysis.max_mean_tke(case["h5"], tmp_path / "j.npy", discard_first_seconds=-1)
    assert_same_case_file(got["mean_flow"], janalysis.mean_flow(case["h5"], tmp_path / "j.h5",
                                                                 discard_first_seconds=-1))
    got = case_analysis.main([str(data), "--first-turbulent-frame", "--device", "cpu"])
    assert got == {"first_turbulent_frame": janalysis.first_turbulent_frame(case["h5"])}
    assert f"first turbulent frame: {got['first_turbulent_frame']}" in capsys.readouterr().out

    import torch

    if not torch.cuda.is_available():
        (data.parent / "mean-flow.npyd").rename(data.parent / "kept.npyd")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            case_analysis.main([str(data), "--all"])
        assert not (data.parent / "mean-flow.npyd").exists()


def test_dataset_stats_script_takes_each_case_file(case, tmp_path, capsys):
    """``dataset_stats <root>`` reads each train case's ``data.npyd`` where
    there is one, else its ``data.h5``: the JAX package's statistics."""
    root = tmp_path / "root"
    shutil.copytree(case["npyd"], root / "train" / "a" / "data.npyd")
    shutil.copytree(case["npyd"], root / "train" / "b" / "data.npyd")
    (root / "train" / "b" / "data.h5").write_bytes(b"not an HDF5 file")  # the .npyd beside it is read
    (root / "train" / "c").mkdir()
    shutil.copy(case["h5"], root / "train" / "c" / "data.h5")
    out = dataset_stats.main([str(root)])
    assert out == root / "stats.pickle"
    assert "from 3 cases" in capsys.readouterr().out
    janalysis.dataset_stats([case["h5"]] * 3, tmp_path / "jax.pickle")
    want = pickle.loads((tmp_path / "jax.pickle").read_bytes())
    got = pickle.loads(out.read_bytes())
    for key in want:
        for name in want[key]:
            np.testing.assert_array_equal(got[key][name], want[key][name], err_msg=f"{key} {name}")


def _tree(root: Path, case: dict, fmt: str) -> Path:
    """A dataset tree of one case, the shared case's datasets in ``fmt`` with
    every analysis artifact, as ``generate_shapes`` leaves it."""
    case_dir = root / "cases" / "c0"
    case_dir.mkdir(parents=True)
    data = case_dir / f"data.{fmt}"
    write_case_file(data, *read_tree(case[fmt]))
    analysis.mean_flow(data, discard_first_seconds=-1, format=fmt)
    analysis.homogeneous_regions(data, k=4, discard_first_seconds=-1)
    analysis.max_mean_tke(data, discard_first_seconds=-1)
    return case_dir


@pytest.mark.parametrize("fmt", FORMATS)
def test_validate_dataset_passes_a_good_tree(case, fmt, tmp_path, capsys):
    _tree(tmp_path, case, fmt)
    result = validate_dataset.main([str(tmp_path), "--deep"])
    assert result == {"n_cases": 1, "failed": {}}
    assert json.loads(capsys.readouterr().out) == result
    assert validate_dataset.exit_code(result) == 0
    assert validate_dataset.exit_code(validate_dataset.main([str(tmp_path / "empty")])) == 1


def test_validate_dataset_names_a_corrupt_npyd(case, tmp_path):
    """A truncated frame file, a non-finite frame and a missing artifact each
    fail the case with a message that names the fault (exit code 1)."""
    case_dir = _tree(tmp_path, case, "npyd")
    u = case_dir / "data.npyd" / "data" / "u.npy"
    u.write_bytes(u.read_bytes()[: len(u.read_bytes()) // 2])
    result = validate_dataset.main([str(tmp_path)])
    assert validate_dataset.exit_code(result) == 1
    (error,) = result["failed"]["c0"]
    assert error.startswith("unreadable data.npyd") and "ValueError" in error

    arrays, attrs = read_tree(case["npyd"])
    arrays["data/p"] = arrays["data/p"].copy()
    arrays["data/p"][N_FRAMES - 1, 3] = np.nan
    shutil.rmtree(case_dir / "data.npyd")
    write_case_file(case_dir / "data.npyd", arrays, attrs)
    (case_dir / "regions.npz").unlink()
    result = validate_dataset.main([str(tmp_path)])
    assert result["failed"]["c0"] == [f"non-finite p in frame {N_FRAMES - 1}", "missing regions.npz"]
    res = subprocess.run([sys.executable, "-m", "generative_turbulence_tpu_torch.scripts.validate_dataset",
                          str(tmp_path)], capture_output=True, text=True, cwd=REPO, timeout=300)
    assert res.returncode == 1 and json.loads(res.stdout) == result


def test_validate_dataset_reads_a_npyd_only_tree(case, tmp_path, monkeypatch, capsys):
    """The reference script opens ``<case>/data.h5`` by name, so it fails
    every case of a ``.npyd`` tree (the card's only format); the port takes
    each case's file by ``find_data_files``'s rule and passes it."""
    _tree(tmp_path, case, "npyd")
    assert not list(tmp_path.rglob("*.h5"))
    assert validate_dataset.main([str(tmp_path), "--deep"]) == {"n_cases": 1, "failed": {}}
    capsys.readouterr()
    module = jax_script("validate-dataset")
    monkeypatch.setattr(sys, "argv", ["validate-dataset.py", str(tmp_path)])
    assert module.main() == 1
    jax_result = json.loads(capsys.readouterr().out)
    assert jax_result["failed"]["c0"] == [f"missing {tmp_path / 'cases' / 'c0' / 'data.h5'}"]
    assert math.isfinite(float(np.load(tmp_path / "cases" / "c0" / "max-mean-tke.npy")))
