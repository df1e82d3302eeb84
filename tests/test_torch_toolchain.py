"""The port's OpenFOAM toolchain (``generative_turbulence_tpu_torch/toolchain``:
dict parser, mesher, shape catalog, case generation, mock solve, conversion,
grid embedding) against the JAX package's on the same inputs: the twins of
``tests/test_toolchain.py``'s classes, each also held against the JAX
result; the generated case tree byte for byte (the twin of
``tests/test_reference_foam_files.py``, which needs a template that is not in
the repository); the converted case's datasets and attributes equal in
``.h5`` and, read back through ``open_case_file``, in ``.npyd``.

One generated case is shared by the file: the first train shape of the
catalog at ``--scale 0.25`` (48x12x12 cells), 4 mock frames.
"""

import filecmp
import json
import shutil
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from generative_turbulence_tpu.toolchain import convert as jconvert
from generative_turbulence_tpu.toolchain import foam_dicts as jfoam_dicts
from generative_turbulence_tpu.toolchain import generate as jgenerate
from generative_turbulence_tpu.toolchain import mesher as jmesher
from generative_turbulence_tpu.toolchain import shapes as jshapes
from generative_turbulence_tpu.toolchain.boxmesh import build_polymesh as j_build_polymesh
from generative_turbulence_tpu_torch.data.npyd import open_case_file, read_tree, write_case_file
from generative_turbulence_tpu_torch.data.schema import read_metadata
from generative_turbulence_tpu_torch.scripts import foam2h5, grid_embedding, les_case
from generative_turbulence_tpu_torch.toolchain import (
    edit_foam_file,
    parse_foam,
    serialize_foam,
)
from generative_turbulence_tpu_torch.toolchain import mesher
from generative_turbulence_tpu_torch.toolchain.boxmesh import build_polymesh, write_polymesh
from generative_turbulence_tpu_torch.toolchain.convert import add_grid_embedding, foam_case_to_h5, read_mesh
from generative_turbulence_tpu_torch.toolchain.foam_dicts import Dimensioned, Field, parse_foam_file
from generative_turbulence_tpu_torch.toolchain.generate import (
    ChannelConfig,
    domain_mask,
    generate_case,
    mock_solve,
    mock_solve_direct,
    refresh_mock_frames,
)
from generative_turbulence_tpu_torch.toolchain.shapes import (
    CROSS_SECTION,
    MIN_WALL_DISTANCE,
    dataset_split,
    shape_boxes,
    shape_catalog,
    validate_shape,
)
from test_torch_scripts import jax_script

FORMATS = ["npyd", "h5"]
SCALE = 0.25
N_FRAMES = 4
SHAPE = dataset_split(shape_catalog())["train"][0]
SEED = zlib.crc32(SHAPE.encode()) % 2**31  # generate_shapes' per-case seed


def _norm(value):
    if isinstance(value, bytes):
        return value.decode()
    return np.asarray(value).tolist()


def assert_same_case_file(got, want):
    """Two case files (either format) hold the same datasets (names, dtypes,
    shapes, values) and the same attributes."""
    got_arrays, got_attrs = read_tree(got)
    want_arrays, want_attrs = read_tree(want)
    assert sorted(got_arrays) == sorted(want_arrays)
    for name, want_array in want_arrays.items():
        g, w = np.asarray(got_arrays[name]), np.asarray(want_array)
        assert (g.dtype, g.shape) == (w.dtype, w.shape), name
        np.testing.assert_array_equal(g, w, err_msg=name)
    as_plain = lambda attrs: {k: {n: _norm(v) for n, v in a.items()} for k, a in attrs.items() if a}  # noqa: E731
    assert as_plain(got_attrs) == as_plain(want_attrs)


def assert_same_tree(got: Path, want: Path, skip=()):
    """Every file under ``want`` exists under ``got`` with the same bytes
    (the paths in ``skip`` aside), and no other file."""
    files = lambda root: {p.relative_to(root) for p in root.rglob("*") if p.is_file()}  # noqa: E731
    got_files = {p for p in files(got) if not any(str(p).startswith(s) for s in skip)}
    want_files = {p for p in files(want) if not any(str(p).startswith(s) for s in skip)}
    assert got_files == want_files
    for rel in sorted(want_files):
        assert filecmp.cmp(got / rel, want / rel, shallow=False), rel


def _configs():
    rects = shape_catalog()[SHAPE]
    jrects = jshapes.shape_catalog()[SHAPE]
    return (ChannelConfig(holes=shape_boxes(rects), scale=SCALE),
            jgenerate.ChannelConfig(holes=jshapes.shape_boxes(jrects), scale=SCALE))


@pytest.fixture(scope="module")
def solved(tmp_path_factory):
    """The shared case, generated and mock-solved (ASCII time directories)
    by the port and by the JAX package; then converted by JAX to ``data.h5``
    with its grid embedding, and by the port to ``data.h5`` and
    ``data.npyd`` with theirs."""
    root = tmp_path_factory.mktemp("toolchain")
    config, jconfig = _configs()
    port, jax_case = root / "port" / SHAPE, root / "jax" / SHAPE
    generate_case(port, config)
    mock_solve(port, config, n_frames=N_FRAMES, seed=SEED)
    jgenerate.generate_case(jax_case, jconfig)
    jgenerate.mock_solve(jax_case, jconfig, n_frames=N_FRAMES, seed=SEED)
    snapshot = root / "snapshot"  # the trees before any conversion
    shutil.copytree(port, snapshot / "port")
    shutil.copytree(jax_case, snapshot / "jax")
    want = jconvert.foam_case_to_h5(jax_case, drop_first_time=True)
    jconvert.add_grid_embedding(want, jax_case)
    got = {}
    for fmt in FORMATS:
        got[fmt] = foam_case_to_h5(port, drop_first_time=True, format=fmt)
        add_grid_embedding(got[fmt], port)
    return {"config": config, "jconfig": jconfig, "port": port, "jax": jax_case, "root": root,
            "snapshot": snapshot, "want": want, "got": got}


# ---- twins of tests/test_toolchain.py::TestFoamDicts -----------------------------------


def _both_parse(text):
    """The port's parse of ``text`` and its serialization, which must be the
    JAX package's, character for character."""
    d = parse_foam(text)
    assert serialize_foam(d) == jfoam_dicts.serialize_foam(jfoam_dicts.parse_foam(text))
    assert repr(d) == repr(jfoam_dicts.parse_foam(text))
    return d


class TestFoamDicts:
    def test_parse_entries(self):
        d = _both_parse(
            """
            // a comment
            application pimpleFoam;
            deltaT 1e-05;  /* block */
            writeInterval 0.0001;
            adjustTimeStep yes;
            maxCo 0.4;
            """
        )
        assert d["application"] == "pimpleFoam"
        assert d["deltaT"] == pytest.approx(1e-5)
        assert d["adjustTimeStep"] == "yes"

    def test_nested_dicts_and_lists(self):
        d = _both_parse(
            """
            solvers { p { solver GAMG; tolerance 1e-06; } }
            vertices ( (0 0 0) (1 0 0) );
            """
        )
        assert d["solvers"]["p"]["solver"] == "GAMG"
        assert d["vertices"][0] == [0, 0, 0]

    def test_dimensions_and_fields(self):
        d = _both_parse(
            """
            nu [0 2 -1 0 0 0 0] 1e-05;
            internalField uniform (20 0 0);
            other nonuniform List<scalar> 3 (1 2 3);
            """
        )
        assert isinstance(d["nu"], Dimensioned)
        assert d["nu"].value == pytest.approx(1e-5)
        assert d["internalField"] == Field(True, [20, 0, 0])
        assert d["other"].uniform is False
        assert d["other"].value == [1, 2, 3]

    def test_roundtrip(self):
        text = """
        FoamFile { version 2.0; format ascii; class dictionary; object controlDict; }
        application pimpleFoam;
        deltaT 1e-05;
        solvers { p { solver GAMG; } }
        value uniform (1 2 3);
        """
        d = _both_parse(text)
        d2 = parse_foam(serialize_foam(d))
        assert d2 == d

    def test_edit_file(self, tmp_path):
        files = {}
        for name, editor in (("port", edit_foam_file), ("jax", jfoam_dicts.edit_foam_file)):
            f = files[name] = tmp_path / name / "controlDict"
            f.parent.mkdir()
            f.write_text("endTime 0.5;\ndeltaT 1e-05;\n")
            with editor(f) as d:
                d["endTime"] = 1.0
        d2 = parse_foam(files["port"].read_text())
        assert d2["endTime"] == 1.0
        assert d2["deltaT"] == pytest.approx(1e-5)
        assert files["port"].read_bytes() == files["jax"].read_bytes()


# ---- twins of TestMesher ------------------------------------------------------------------


def _mesh_files(tmp_path, counts, holes, **kw):
    """The port's mesh and its blockMeshDict/mesh-params.json, each file
    byte-equal to the JAX package's for the same channel."""
    mesh = mesher.mesh_channel(counts, [mesher.Box(*b) for b in holes], **kw)
    jmesh = jmesher.mesh_channel(counts, [jmesher.Box(*b) for b in holes], **kw)
    out = {}
    for name, (m, mod) in {"port": (mesh, mesher), "jax": (jmesh, jmesher)}.items():
        d = tmp_path / name
        d.mkdir(parents=True, exist_ok=True)
        mod.write_blockmesh_dict(m, d / "blockMeshDict")
        out[name] = mod.write_mesh_params(m, d / "mesh-params.json")
    for f in ("blockMeshDict", "mesh-params.json"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    assert out["port"] == out["jax"]
    assert mesh.boundaries.keys() == jmesh.boundaries.keys()
    assert [b.size for b in mesh.blocks] == [b.size for b in jmesh.blocks]
    return mesh, out["port"]


class TestMesher:
    def test_no_holes_single_block(self, tmp_path):
        mesh, _ = _mesh_files(tmp_path, (8, 4, 4), [], h=(0.1, 0.1, 0.1))
        assert len(mesh.blocks) == 1
        assert len(mesh.boundaries["inlets"]) == 1
        assert len(mesh.boundaries["outlets"]) == 1
        assert len(mesh.boundaries["walls"]) == 4

    def test_hole_decomposition_covers_domain(self, tmp_path):
        mesh, _ = _mesh_files(tmp_path, (8, 4, 4), [((2, 1, 1), (4, 3, 3))])
        volume = sum(np.prod(b.size) for b in mesh.blocks)
        assert volume == 8 * 4 * 4 - 2 * 2 * 2
        assert len(mesh.boundaries["walls"]) > 4

    def test_2d_empties(self, tmp_path):
        mesh, _ = _mesh_files(tmp_path, (8, 4, 1), [])
        assert "empties" in mesh.boundaries
        assert len(mesh.boundaries["empties"]) == 2

    def test_blockmesh_dict_written(self, tmp_path):
        mesh, params = _mesh_files(tmp_path, (8, 4, 4), [((2, 1, 1), (4, 3, 3))], h=(0.01,) * 3)
        text = (tmp_path / "port" / "blockMeshDict").read_text()
        assert "hex (" in text and "inlets" in text and "walls" in text
        assert params["cell_counts"] == [8, 4, 4]


# ---- twins of TestShapes ------------------------------------------------------------------


def _rects(catalog):
    return {name: [(r.y, r.z, r.h, r.w) for r in rects] for name, rects in catalog.items()}


class TestShapes:
    def test_catalog_valid_and_split(self):
        cat = shape_catalog()
        assert len(cat) == 45
        for name, rects in cat.items():
            validate_shape(name, rects)
        split = dataset_split(cat)
        assert [len(split[k]) for k in ("train", "val", "test")] == [27, 9, 9]
        assert len(set(split["train"] + split["val"] + split["test"])) == 45
        assert _rects(cat) == _rects(jshapes.shape_catalog())
        assert split == jshapes.dataset_split(jshapes.shape_catalog())

    def test_wall_attached_families_present(self):
        assert (CROSS_SECTION, MIN_WALL_DISTANCE) == (jshapes.CROSS_SECTION, jshapes.MIN_WALL_DISTANCE)
        n = CROSS_SECTION
        wall_attached = set()
        for name, rects in shape_catalog().items():
            for r in rects:
                dists = (r.y, n - (r.y + r.h), r.z, n - (r.z + r.w))
                assert all(d == 0 or d >= MIN_WALL_DISTANCE for d in dists), name
                if any(d == 0 for d in dists):
                    wall_attached.add(name)
        assert len(wall_attached) >= 12
        assert {"span-bar", "corner-single", "fin-bottom"} <= wall_attached

    def test_wall_attached_shape_meshes(self, tmp_path):
        cat = shape_catalog()
        for name in ("floor-slab-low", "span-bar", "corner-quad"):
            holes = [(b.lo, b.hi) for b in shape_boxes(cat[name])]
            mesh, _ = _mesh_files(tmp_path / name, (72, 48, 48), holes)
            assert len(mesh.blocks) > 0
            assert len(mesh.boundaries["inlets"]) > 0
            assert len(mesh.boundaries["outlets"]) > 0

    def test_boxes_extrusion(self):
        for name, rects in shape_catalog().items():
            got = [(b.lo, b.hi) for b in shape_boxes(rects)]
            assert got == [(b.lo, b.hi) for b in jshapes.shape_boxes(jshapes.shape_catalog()[name])], name
        for b in shape_boxes(shape_catalog()["plus"]):
            assert b.lo[0] == 12 and b.hi[0] == 24


# ---- twins of TestCaseGeneration ------------------------------------------------------------


class TestCaseGeneration:
    def test_case_layout(self, solved):
        """The case tree, byte for byte the JAX package's: system/,
        constant/ (its polyMesh among them), 0/, Allrun, mesh-params.json and
        the mock-solved time directories."""
        case_dir = solved["port"]
        for rel in (
            "system/controlDict", "system/fvSchemes", "system/fvSolution", "system/blockMeshDict",
            "constant/physicalProperties", "constant/momentumTransport", "0/U", "0/p", "Allrun",
            "mesh-params.json", "constant/polyMesh/points", "constant/polyMesh/boundary",
        ):
            assert (case_dir / rel).exists(), rel
        assert_same_tree(solved["snapshot"] / "port", solved["snapshot"] / "jax")
        assert len([p for p in case_dir.iterdir() if p.name.startswith("0.0")]) == N_FRAMES

        cd = parse_foam_file(case_dir / "system" / "controlDict")
        assert cd["application"] == "pimpleFoam"
        assert cd["maxCo"] == pytest.approx(0.4)
        mt = parse_foam_file(case_dir / "constant" / "momentumTransport")
        assert mt["LES"]["model"] == "dynamicKEqn"

    @pytest.mark.parametrize("fmt", FORMATS)
    def test_conversion_end_to_end(self, solved, fmt):
        """``foam_case_to_h5`` + ``add_grid_embedding``: the JAX package's
        datasets and attributes, in ``.h5`` and in ``.npyd``."""
        h5_file = solved["got"][fmt]
        assert h5_file.name == f"data.{fmt}"
        assert_same_case_file(h5_file, solved["want"])
        n_cells = int(domain_mask(solved["config"]).sum())
        X, Y, Z = solved["config"].scaled_counts
        with open_case_file(h5_file) as f:
            assert f["physical"].attrs["nu"] == pytest.approx(1e-5)
            assert f["data/u"].shape == (N_FRAMES - 1, n_cells, 3)  # first frame dropped
            assert f["data/p"].shape == (N_FRAMES - 1, n_cells)
            assert np.asarray(f["grid/cell_counts"]).tolist() == [X + 2, Y + 2, Z + 2]
            assert len(np.asarray(f["grid/cell_idx"])) == n_cells
            assert f["boundary-conditions/u/inlets"].attrs["type"] == "fixed-value"
            np.testing.assert_allclose(np.asarray(f["boundary-conditions/u/inlets/value"]), [20, 0, 0])
            assert f["boundary-conditions/u/walls"].attrs["type"] == "fixed-value"
            assert f["boundary-conditions/p/outlets"].attrs["type"] == "fixed-value"

        meta = read_metadata(h5_file)
        assert meta.n_cells == n_cells
        assert not meta.two_dimensional
        assert (meta.cell_types == 0).sum() == meta.n_cells
        for desc in meta.boundaries.values():
            assert not np.intersect1d(desc["idx"], meta.cell_idx).size

    @pytest.mark.parametrize("fmt", FORMATS)
    def test_mock_frames_survive_production_discard(self, solved, fmt):
        with open_case_file(solved["got"][fmt]) as f:
            times = np.asarray(f["data/times"])
        assert (times > 0.025).all(), times

    def test_polymesh_owner_ordering(self, solved):
        points, faces, owner, neighbour, boundary = read_mesh(solved["port"])
        for got, want in zip((points, faces, owner, neighbour), jconvert.read_mesh(solved["jax"])[:4]):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert boundary == jconvert.read_mesh(solved["jax"])[4]
        assert np.all(owner[: len(neighbour)] < neighbour)
        starts = sorted(spec["startFace"] for spec in boundary.values())
        assert starts[0] == len(neighbour)


# ---- the mock-direct path, the frames' refresh, the scripts ---------------------------------


@pytest.fixture(scope="module")
def direct(solved):
    """The shared case mock-solved straight into its case file with the
    mesh in memory (generate_shapes --mock-direct): by the JAX package into
    ``data.h5`` and by the port in both formats, each in a case tree of its
    own."""
    config, jconfig, root = solved["config"], solved["jconfig"], solved["root"]
    out = {}
    mesh = build_polymesh(domain_mask(config), config.h)
    jmesh = j_build_polymesh(jgenerate.domain_mask(jconfig), jconfig.h)
    for got, want in zip(mesh, jmesh):
        if isinstance(want, list):
            assert got == want
        else:
            np.testing.assert_array_equal(got, want)
    for fmt in FORMATS:
        case = root / f"direct-{fmt}" / SHAPE
        generate_case(case, config, write_polymesh_too=False)
        out[fmt] = mock_solve_direct(case, config, n_frames=N_FRAMES, seed=SEED, mesh=mesh, format=fmt)
        add_grid_embedding(out[fmt], case, mesh_override=mesh)
    jcase = root / "direct-jax" / SHAPE
    jgenerate.generate_case(jcase, jconfig, write_polymesh_too=False)
    out["jax"] = jgenerate.mock_solve_direct(jcase, jconfig, n_frames=N_FRAMES, seed=SEED, mesh=jmesh)
    jconvert.add_grid_embedding(out["jax"], jcase, mesh_override=jmesh)
    return out


@pytest.mark.parametrize("fmt", FORMATS)
def test_mock_solve_direct_matches_jax(direct, fmt):
    assert direct[fmt].name == f"data.{fmt}"
    assert_same_case_file(direct[fmt], direct["jax"])
    assert_same_tree(direct[fmt].parent, direct["jax"].parent, skip=("data.",))
    with open_case_file(direct[fmt]) as f:
        assert f["data/u"].shape[0] == N_FRAMES  # no time directory to drop


@pytest.mark.parametrize("fmt", FORMATS)
def test_refresh_mock_frames_matches_jax(solved, direct, fmt, tmp_path):
    """New frames (another seed and count) replace ``data/`` only; the
    geometry, grid and boundary conditions stay; the JAX package's result
    on its ``data.h5``."""
    config, jconfig = solved["config"], solved["jconfig"]
    cases = {}
    for name, src in (("port", direct[fmt]), ("jax", direct["jax"])):
        case = tmp_path / name
        (case / "0.0251").mkdir(parents=True)  # a stale ASCII time directory
        write_case_file(case / src.name, *read_tree(src))
        cases[name] = case
    before = read_tree(cases["port"] / direct[fmt].name)
    got = refresh_mock_frames(cases["port"], config, n_frames=N_FRAMES + 2, seed=SEED + 1, format=fmt)
    want = jgenerate.refresh_mock_frames(cases["jax"], jconfig, n_frames=N_FRAMES + 2, seed=SEED + 1)
    assert got == cases["port"] / f"data.{fmt}"
    assert_same_case_file(got, want)
    after = read_tree(got)
    for name, array in before[0].items():
        if not name.startswith("data/"):
            np.testing.assert_array_equal(after[0][name], array, err_msg=name)
    assert after[0]["data/u"].shape[0] == N_FRAMES + 2
    assert not (cases["port"] / "0.0251").exists()


@pytest.mark.parametrize("fmt", FORMATS)
def test_grid_embedding_replaces_its_groups(direct, fmt, tmp_path):
    """A second ``add_grid_embedding`` (the grid_embedding script, from the
    ASCII mesh) replaces grid/ and geometry/: the same file again."""
    case = direct[fmt].parent
    target = tmp_path / case.name
    (target / "constant").mkdir(parents=True)
    write_case_file(target / direct[fmt].name, *read_tree(direct[fmt]))
    shutil.copy(case / "mesh-params.json", target / "mesh-params.json")
    config = _configs()[0]
    write_polymesh(target, domain_mask(config), config.h)
    out = grid_embedding.main([str(target / direct[fmt].name), str(target)])
    assert out == target / direct[fmt].name
    assert_same_case_file(out, direct["jax"])


@pytest.mark.parametrize("fmt", FORMATS)
def test_foam2h5_script_matches_jax(solved, fmt, tmp_path, capsys):
    """``foam2h5 <case> --grid-embedding --format <fmt>`` on the ASCII case:
    the JAX package's ``data.h5``."""
    case = tmp_path / SHAPE
    shutil.copytree(solved["snapshot"] / "port", case)
    out = foam2h5.main([str(case), "--grid-embedding", "--format", fmt, "--workers", "2"])
    assert out == case / f"data.{fmt}"
    assert f"wrote {out}" in capsys.readouterr().out
    assert_same_case_file(out, solved["want"])
    with pytest.raises(ValueError, match="is not a"):
        foam2h5.main([str(case), "--out", str(tmp_path / "x.h5"), "--format", "npyd"])


def test_les_case_script_matches_jax(tmp_path, capsys, monkeypatch):
    argv = ["--cells", "16", "8", "8", "--hole", "4", "2", "2", "6", "5", "5", "--inflow", "10",
            "--subdomains", "2", "--end-time", "0.1"]
    got = les_case.main([str(tmp_path / "port"), *argv])
    assert got == tmp_path / "port"
    assert "case written to" in capsys.readouterr().out
    jax_les = jax_script("les-case")
    monkeypatch.setattr(sys, "argv", ["les-case.py", str(tmp_path / "jax"), *argv])
    jax_les.main()
    assert_same_tree(tmp_path / "port", tmp_path / "jax")
    assert json.loads((got / "mesh-params.json").read_text())["cell_counts"] == [16, 8, 8]


def test_h5_request_without_h5py_names_npyd(solved, tmp_path, monkeypatch):
    """Where ``h5py`` does not import, ``format="h5"`` raises and names the
    ``.npyd`` format; ``npyd`` needs no ``h5py``."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ModuleNotFoundError, match="--format npyd"):
        foam_case_to_h5(solved["port"], tmp_path / "data.h5", format="h5")
    out = foam_case_to_h5(solved["port"], tmp_path / "data.npyd", format="npyd")
    add_grid_embedding(out, solved["port"])
    with open_case_file(out) as f:
        assert f["data/u"].shape[0] == N_FRAMES - 1
    with pytest.raises(ValueError, match="unknown format"):
        foam_case_to_h5(solved["port"], format="hdf5")
