"""The port's data layer against the JAX package's, on the same JAX-written
dataset (``synthetic_root``: 2 train, 1 val and 1 test case at 24x10x10
cells, 12 frames) read from its ``.h5`` files and from their ``.npyd``
conversion: metadata, times and frames bit-equal, the same batches in the
same order from ``DataModule``, ``compute_stats`` at rtol 1e-6, and the
synthetic writer's files equal to the JAX writer's.  Plus the ``.npyd``
format itself, and the whole read path in a process where ``h5py`` cannot
be imported."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from generative_turbulence_tpu.data import dataset as jdataset
from generative_turbulence_tpu.data import schema as jschema
from generative_turbulence_tpu.data import synthetic as jsynthetic
from generative_turbulence_tpu_torch.data import dataset, npyd, schema, synthetic
from generative_turbulence_tpu_torch.data.variables import Variable
from generative_turbulence_tpu_torch.toolchain import h5_to_npyd

REPO_ROOT = Path(__file__).resolve().parent.parent
ALL_VARIABLES = ("u", "p", "k", "nut")
FORMATS = ["h5", "npyd"]


@pytest.fixture(scope="module")
def roots(synthetic_root, tmp_path_factory):
    """{"h5": the JAX-written dataset, "npyd": a copy converted in place}."""
    copy = tmp_path_factory.mktemp("npyd") / "root"
    shutil.copytree(synthetic_root, copy)
    h5_to_npyd.convert_tree(copy)
    return {"h5": synthetic_root, "npyd": copy}


def _case_files(root, fmt):
    return sorted(root.glob(f"*/*/data.{fmt}"))


def _assert_metadata_equal(meta, jmeta):
    assert meta.nu == jmeta.nu and meta.case_name == jmeta.case_name
    for name in ("h", "cell_counts", "cell_idx", "inside_mask", "cell_types", "unpadded_cell_idx"):
        got, want = getattr(meta, name), getattr(jmeta, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert list(meta.boundaries) == list(jmeta.boundaries)
    for name, desc in meta.boundaries.items():
        assert desc["type"] == jmeta.boundaries[name]["type"]
        np.testing.assert_array_equal(desc["idx"], jmeta.boundaries[name]["idx"])
    got_bcs = {v.key: {b: (bc.type.value, bc.value) for b, bc in bcs.items()}
               for v, bcs in meta.boundary_conditions.items()}
    want_bcs = {v.key: {b: (bc.type.value, bc.value) for b, bc in bcs.items()}
                for v, bcs in jmeta.boundary_conditions.items()}
    assert {k: {b: t for b, (t, _) in v.items()} for k, v in got_bcs.items()} == \
        {k: {b: t for b, (t, _) in v.items()} for k, v in want_bcs.items()}
    for key, bcs in got_bcs.items():
        for b, (_, value) in bcs.items():
            np.testing.assert_array_equal(value, want_bcs[key][b][1])
    assert len(meta.holes) == len(jmeta.holes)
    for (p, s), (jp, js) in zip(meta.holes, jmeta.holes):
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(s, js)


@pytest.mark.parametrize("fmt", FORMATS)
def test_metadata_times_and_frames_bit_equal(roots, fmt):
    h5_files = _case_files(roots["h5"], "h5")
    files = _case_files(roots[fmt], fmt)
    assert [f.parent.name for f in files] == [f.parent.name for f in h5_files] and len(files) == 4
    variables = tuple(Variable(n) for n in ALL_VARIABLES)
    repo = schema.CaseRepository(files, variables)
    jrepo = jschema.CaseRepository(h5_files, tuple(jschema.Variable(n) for n in ALL_VARIABLES))
    for i in range(len(files)):
        _assert_metadata_equal(repo.read_metadata(i), jrepo.read_metadata(i))
        assert repo.times[i].dtype == jrepo.times[i].dtype
        np.testing.assert_array_equal(repo.times[i], jrepo.times[i])
        idxs = [5, 2, 5, 0, 11]  # unsorted, with a repeat
        got, want = repo.read(i, idxs), jrepo.read(i, idxs)
        np.testing.assert_array_equal(got.t, want.t)
        for v, jv in zip(variables, jrepo.variables):
            assert got.fields[v].dtype == np.float32
            np.testing.assert_array_equal(got.fields[v], want.fields[jv])


def test_find_data_files_takes_npyd_over_h5(roots, tmp_path):
    assert [f.name for f in schema.find_data_files(roots["h5"] / "train")] == ["data.h5"] * 2
    assert [f.name for f in schema.find_data_files(roots["npyd"] / "train")] == ["data.npyd"] * 2
    (tmp_path / "empty-case").mkdir()
    (tmp_path / "loose-file.h5").write_bytes(b"")
    assert schema.find_data_files(tmp_path) == []
    assert schema.case_file(roots["npyd"] / "val" / "case-val-00", "mean-flow").name == "mean-flow.npyd"


def _jax_module(root, **kw):
    return jdataset.DataModule(root, cell_bucket=0, buffer_pool=False, device_prefetch=False, **kw)


DATA_KW = dict(discard_first_seconds=3.5e-4, batch_size=5, eval_batch_size=3, val_samples=5,
               test_samples=4, seed=3)


@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("fmt", FORMATS)
def test_train_batches_match_jax(roots, fmt, epoch):
    jdm = _jax_module(roots["h5"], **DATA_KW)
    jdm.setup("fit")
    dm = dataset.DataModule(roots[fmt], **DATA_KW).setup("fit")
    assert dm.n_train_batches() == jdm.n_train_batches() == 4  # 9 valid frames per case, batches of 5
    jsampler = jdataset.GeometryPureBatches(jdm.train_dataset, batch_size=5, shuffle=True, seed=3, epoch=epoch)
    sampler = dataset.GeometryPureBatches(dm.train_dataset, batch_size=5, shuffle=True, seed=3, epoch=epoch)
    order = list(sampler)
    assert order == list(jsampler)
    assert all(len(chunk) == 5 for chunk in order)
    batches, jbatches = list(dm.train_batches(epoch)), list(jdm.train_batches(epoch))
    assert len(batches) == len(jbatches) == len(order)
    for batch, jbatch in zip(batches, jbatches):
        assert batch.metadata.case_name == jbatch.metadata.case_name
        assert isinstance(batch.cells, np.ndarray) and batch.grid.cell_idx.device.type == "cpu"
        np.testing.assert_array_equal(batch.cells, np.asarray(jbatch.cells))
        np.testing.assert_array_equal(batch.t, jbatch.t)
        assert batch.variables == (Variable.U, Variable.P)


@pytest.mark.parametrize("fmt", FORMATS)
def test_eval_batches_match_jax(roots, fmt):
    jdm = _jax_module(roots["h5"], **DATA_KW)
    jdm.setup("fit")
    jdm.setup("test")
    dm = dataset.DataModule(roots[fmt], **DATA_KW).setup("fit").setup("test")
    assert dm.first_val_case() == jdm.first_val_case() == "case-val-00"
    for got, want in ((dm.val_batches(), jdm.val_batches()), (dm.test_batches(), jdm.test_batches())):
        got, want = list(got), list(want)
        assert [b.batch_size for b in got] == [b.batch_size for b in want]
        for batch, jbatch in zip(got, want):
            np.testing.assert_array_equal(batch.cells, np.asarray(jbatch.cells))
            np.testing.assert_array_equal(batch.t, jbatch.t)
    evaluation = dataset.EvaluationBatches(dm.val_dataset, batch_size=3, samples_per_file=5)
    jevaluation = jdataset.EvaluationBatches(jdm.val_dataset, batch_size=3, samples_per_file=5)
    assert list(evaluation) == list(jevaluation) and len(evaluation) == len(jevaluation) == 2


def test_dataset_keeps_one_geometry_per_batch_and_discards_early_frames(roots):
    repo = schema.CaseRepository(schema.find_data_files(roots["npyd"] / "train"), (Variable.U,))
    ds = dataset.CaseDataset(repo, stats=None, discard_first_seconds=3.5e-4)
    assert [list(s) for s in ds.valid_steps] == [list(range(3, 12))] * 2 and len(ds) == 18
    assert ds.sample_idxs_by_file() == [list(range(9)), list(range(9, 18))]
    np.testing.assert_array_equal(ds[[9, 10]].t, repo.times[1][[3, 4]])
    with pytest.raises(ValueError, match="same geometry"):
        ds[[8, 9]]
    np.testing.assert_array_equal(ds.get_times(0, [5e-4, 1e-3]).t, repo.times[0][[4, 9]])


@pytest.mark.parametrize("fmt", FORMATS)
def test_compute_stats_matches_jax(roots, fmt):
    want = jschema.FieldStats.from_file(roots["h5"] / "stats.pickle").stats
    train = sorted((roots[fmt] / "train").glob(f"*/data.{fmt}"))
    assert [f.parent.name for f in train] == ["case-train-00", "case-train-01"]
    got = synthetic.compute_stats(train).stats
    assert sorted(got) == sorted(want)
    for key in want:
        for name in ("min", "max", "mean", "std"):
            np.testing.assert_allclose(got[key][name], want[key][name], rtol=1e-6, err_msg=f"{key} {name}")


def _tree(file):
    """{path: (array or None, {attr: value as str})} of a case file."""
    out = {}
    with npyd.open_case_file(file) as f:
        def walk(group, prefix):
            for name, item in group.items():
                path = f"{prefix}{name}"
                attrs = {k: str(v) for k, v in item.attrs.items()}
                if hasattr(item, "keys"):
                    out[path] = (None, attrs)
                    walk(item, path + "/")
                else:
                    out[path] = (np.asarray(item), attrs)
        walk(f, "")
    return out


@pytest.mark.parametrize("fmt", FORMATS)
def test_generate_case_matches_jax(fmt, tmp_path):
    kw = dict(cell_counts=(12, 8, 8), n_frames=3, seed=4)
    jfile = jsynthetic.generate_case(tmp_path / "jax", **kw)
    file = synthetic.generate_case(tmp_path / "port", format=fmt, **kw)
    assert file == tmp_path / "port" / f"data.{fmt}"
    for stem in ("data", "mean-flow"):
        got, want = _tree(tmp_path / "port" / f"{stem}.{fmt}"), _tree(jfile.parent / f"{stem}.h5")
        assert sorted(got) == sorted(want), stem
        for path, (array, attrs) in want.items():
            assert got[path][1] == attrs, path
            if array is not None:
                assert got[path][0].dtype == array.dtype, path
                np.testing.assert_array_equal(got[path][0], array, err_msg=path)
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "regions.npz")["assignments"],
                                  np.load(tmp_path / "jax" / "regions.npz")["assignments"])
    assert np.load(tmp_path / "port" / "max-mean-tke.npy") == np.load(tmp_path / "jax" / "max-mean-tke.npy")


def test_both_formats_hold_the_same_arrays(tmp_path):
    kw = dict(n_train_cases=1, n_val_cases=1, n_test_cases=0, n_frames=4, cell_counts=(10, 6, 6), seed=2)
    synthetic.generate_synthetic_dataset(tmp_path / "h5", **kw)
    synthetic.generate_synthetic_dataset(tmp_path / "npyd", format="npyd", **kw)
    h5_files, npyd_files = _case_files(tmp_path / "h5", "h5"), _case_files(tmp_path / "npyd", "npyd")
    assert len(h5_files) == len(npyd_files) == 2
    for a, b in zip(h5_files, npyd_files):
        want, got = _tree(a), _tree(b)
        assert sorted(got) == sorted(want)
        for path, (array, _) in want.items():
            if array is not None:
                np.testing.assert_array_equal(got[path][0], array, err_msg=path)
    assert (tmp_path / "h5" / "stats.pickle").read_bytes() == (tmp_path / "npyd" / "stats.pickle").read_bytes()


def test_npyd_round_trip(tmp_path):
    arrays = {
        "data/u": np.arange(24, dtype=np.float32).reshape(4, 2, 3),
        "data/times": np.linspace(0, 1, 4),
        "geometry/holes/sizes": np.zeros((0, 3)),
        "scalar": np.array(7, dtype=np.int64),
        "grid/boundaries/inlets": np.array([3, 1, 2], dtype=np.int64),
    }
    attrs = {"": {"version": 2}, "physical": {"nu": np.float64(1e-5)}, "empty/group": {},
             "grid/boundaries/inlets": {"type": "inlets", "n": np.int64(3), "bytes": b"x"}}
    root = npyd.write_npyd(tmp_path / "x.npyd", arrays, attrs)
    with npyd.open_case_file(root) as f:
        assert f.keys() == ["data", "empty", "geometry", "grid", "physical", "scalar"]
        assert f.attrs == {"version": 2}
        assert f["physical"].attrs == {"nu": 1e-5} and f["physical"].keys() == []
        assert f["empty/group"].keys() == [] and "empty/group" in f and "nope" not in f
        with pytest.raises(KeyError):
            f["data/v"]
        u = f["data"]["u"]
        assert u.shape == (4, 2, 3)
        assert isinstance(u.array, np.memmap)
        np.testing.assert_array_equal(u[[0, 2]], arrays["data/u"][[0, 2]])
        np.testing.assert_array_equal(u[1], arrays["data/u"][1])
        for name, array in arrays.items():
            got = np.asarray(f[name])
            assert got.dtype == array.dtype and got.shape == array.shape, name
            np.testing.assert_array_equal(got, array)
        inlets = f["grid/boundaries"]["inlets"]
        assert inlets.attrs == {"type": "inlets", "n": 3, "bytes": "x"}
        assert [k for k, _ in f["grid/boundaries"].items()] == ["inlets"]
    # The same datasets through write_case_file as HDF5, read back by both.
    h5 = npyd.write_case_file(tmp_path / "x.h5", arrays, attrs)
    with h5py.File(h5, "r") as f:
        assert float(f["physical"].attrs["nu"]) == 1e-5 and f.attrs["version"] == 2 and "empty/group" in f
        for name, array in arrays.items():
            np.testing.assert_array_equal(np.asarray(f[name]), array)


def test_h5_to_npyd_command_line(synthetic_root, tmp_path, capsys):
    case = tmp_path / "case-val-00"
    shutil.copytree(synthetic_root / "val" / "case-val-00", case)
    assert h5_to_npyd.main([str(case)]) == 0
    printed = capsys.readouterr().out.split()
    assert printed == [str(case / "data.npyd"), str(case / "mean-flow.npyd")]
    assert h5_to_npyd.main([str(case / "data.h5")]) == 0  # one file, again in place
    with npyd.open_case_file(case / "mean-flow.npyd") as f, h5py.File(case / "mean-flow.h5") as g:
        np.testing.assert_array_equal(np.asarray(f["data/u"]), np.asarray(g["data/u"]))


def test_batch_to_moves_cells_and_builds_the_grid_there(roots):
    dm = dataset.DataModule(roots["npyd"], eval_batch_size=4, val_samples=4).setup("validate")
    batch = next(iter(dm.val_batches()))
    moved = batch.to("cpu")
    assert isinstance(moved.cells, torch.Tensor) and moved.cells.dtype == torch.float32
    np.testing.assert_array_equal(moved.cells.numpy(), batch.cells)
    assert moved.grid.cell_idx.device.type == "cpu" and moved.grid.n_cells == batch.metadata.n_cells
    assert moved.to("cpu") is moved
    prefetched = next(iter(dataset.DataModule(roots["npyd"], eval_batch_size=4, val_samples=4, device="cpu")
                            .setup("validate").val_batches()))
    assert isinstance(prefetched.cells, torch.Tensor)
    np.testing.assert_array_equal(prefetched.cells.numpy(), batch.cells)


def test_prefetch_raises_the_producers_error():
    def broken():
        yield 1
        raise OSError("disk gone")

    got = dataset.prefetch(broken())
    assert next(got) == 1
    with pytest.raises(OSError, match="disk gone"):
        next(got)


_WITHOUT_H5PY = """
import json, sys
sys.modules["h5py"] = None  # import h5py now raises ImportError
from pathlib import Path
import numpy as np
from generative_turbulence_tpu_torch.data.dataset import DataModule
from generative_turbulence_tpu_torch.data.schema import CaseRepository, find_data_files, read_metadata
from generative_turbulence_tpu_torch.data.synthetic import generate_synthetic_dataset
from generative_turbulence_tpu_torch.data.variables import Variable
from generative_turbulence_tpu_torch.eval import (
    MaxMeanTKEPositionMetric, SampleMetricsCollection, SampleStore, WassersteinTKE)

root = Path(sys.argv[1])
generate_synthetic_dataset(root, n_train_cases=1, n_val_cases=1, n_test_cases=0, n_frames=6, format="npyd")
meta = read_metadata(root / "val" / "case-val-00" / "data.npyd")
repo = CaseRepository(find_data_files(root / "val"), (Variable.U, Variable.P))
frames = repo.read(0, [4, 1])
dm = DataModule(root, eval_batch_size=4, val_samples=4).setup("validate")
batch = next(iter(dm.val_batches()))
store = SampleStore(root / "samples.npyd", dm.variables)
store.add_samples(batch.cells, batch.metadata)
loaded = store.load_samples(meta)
collection = SampleMetricsCollection(
    "val", root / "val", [WassersteinTKE(n_sphere=128, n_legendre=8, device="cpu"), MaxMeanTKEPositionMetric("cpu")])
values = collection.compute(store, dm.stats)
try:
    import h5py
    importable = True
except ImportError:
    importable = False
print(json.dumps({"n_cells": meta.n_cells, "frames": list(frames.fields[Variable.U].shape),
                  "batch": list(batch.cells.shape), "stored": store.n_samples("case-val-00"),
                  "loaded_equal": bool(np.array_equal(loaded.fields[Variable.U], batch.cells[..., :3])),
                  "tke": values["val/tke"], "h5py_importable": importable,
                  "h5py_module": repr(sys.modules["h5py"])}))
"""


def test_npyd_dataset_needs_no_h5py(tmp_path):
    """The card's fault: a ``.npyd`` dataset is written, read, batched,
    stored and scored by a process in which ``import h5py`` fails."""
    res = subprocess.run(
        [sys.executable, "-c", _WITHOUT_H5PY, str(tmp_path / "root")],
        capture_output=True, text=True, cwd=REPO_ROOT, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["frames"] == [2, out["n_cells"], 3] and out["batch"] == [4, out["n_cells"], 4]
    assert out["stored"] == 4 and out["loaded_equal"]
    assert np.isfinite(out["tke"]) and out["tke"] >= 0
    assert not out["h5py_importable"] and out["h5py_module"] == "None"
