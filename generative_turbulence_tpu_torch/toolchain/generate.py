"""Case generation: channel config -> complete OpenFOAM case.

Counterpart of the reference's ``scripts/generate_utils.py`` (ChannelConfig +
generate_case): instantiates the LES template, meshes the channel with the
obstacle holes (blockMeshDict for OpenFOAM AND, uniquely to this framework, a
ready polyMesh via the pure-python boxmesh), and records mesh-params.json.

A copy of ``generative_turbulence_tpu/toolchain/generate.py`` whose mock
solves write the case file through the port's format layer: ``data.npyd``
by default, ``data.h5`` with ``format="h5"`` (``h5py`` imported only there),
and whose 2D channel keeps its one z cell at every ``scale`` (the JAX copy
fails on its 2D holes at 0.25 and 0.5 and meshes 2 z cells from 1.5).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .boxmesh import write_polymesh
from .les_case import write_case
from .mesher import Box, mesh_channel, write_blockmesh_dict, write_mesh_params


@dataclasses.dataclass
class ChannelConfig:
    """Physical + numerical channel parameters (shapes defaults: 0.4 x 0.1 x
    0.1 m over 192 x 48 x 48 cells, inflow 20 m/s, nu 1e-5)."""

    size: Tuple[float, float, float] = (0.4, 0.1, 0.1)
    cell_counts: Tuple[int, int, int] = (192, 48, 48)
    inflow: float = 20.0
    nu: float = 1e-5
    end_time: float = 0.5
    delta_t: float = 1e-5
    write_interval: float = 1e-4
    n_subdomains: int = 1
    holes: List[Box] = dataclasses.field(default_factory=list)
    scale: float = 1.0  # refine (>1) or coarsen (<1) the grid

    @property
    def scaled_counts(self) -> Tuple[int, int, int]:
        # An axis of one cell (a 2D channel's z) stays one cell at any scale;
        # the JAX package rounds it to 0 cells below 0.75 and to 2 from 1.5.
        return tuple(c if c == 1 else int(round(c * self.scale)) for c in self.cell_counts)

    @property
    def h(self) -> Tuple[float, float, float]:
        return tuple(s / c for s, c in zip(self.size, self.scaled_counts))

    def two_dimensionalized(self) -> "ChannelConfig":
        """Collapse the z axis to one cell (2D channel), scaling holes."""
        nx, ny, _ = self.cell_counts
        holes2d = [
            Box((b.lo[0], b.lo[1], 0), (b.hi[0], b.hi[1], 1)) for b in self.holes
        ]
        return dataclasses.replace(
            self, cell_counts=(nx, ny, 1), holes=holes2d
        )

    def scaled_holes(self) -> List[Box]:
        if self.scale == 1.0:
            return list(self.holes)
        keep = [c == 1 for c in self.cell_counts]  # as in scaled_counts
        scaled = lambda v: tuple(x if k else int(round(x * self.scale)) for x, k in zip(v, keep))  # noqa: E731
        return [Box(scaled(b.lo), scaled(b.hi)) for b in self.holes]


def generate_case(
    case_dir: Path,
    config: ChannelConfig,
    *,
    write_polymesh_too: bool = True,
) -> Path:
    """Create a ready-to-solve case directory."""
    case_dir = Path(case_dir)
    counts = config.scaled_counts
    two_d = min(counts) == 1

    write_case(
        case_dir,
        inflow=config.inflow,
        nu=config.nu,
        end_time=config.end_time,
        delta_t=config.delta_t,
        write_interval=config.write_interval,
        n_subdomains=config.n_subdomains,
        two_dimensional=two_d,
    )

    mesh = mesh_channel(counts, config.scaled_holes(), config.h)
    write_blockmesh_dict(mesh, case_dir / "system" / "blockMeshDict")
    write_mesh_params(mesh, case_dir / "mesh-params.json")

    if write_polymesh_too:
        inside = np.ones(counts, dtype=bool)
        for hole in config.scaled_holes():
            inside[
                hole.lo[0] : hole.hi[0],
                hole.lo[1] : hole.hi[1],
                hole.lo[2] : hole.hi[2],
            ] = False
        write_polymesh(case_dir, inside, config.h)

    return case_dir


def domain_mask(config: ChannelConfig) -> np.ndarray:
    counts = config.scaled_counts
    inside = np.ones(counts, dtype=bool)
    for hole in config.scaled_holes():
        inside[
            hole.lo[0] : hole.hi[0],
            hole.lo[1] : hole.hi[1],
            hole.lo[2] : hole.hi[2],
        ] = False
    return inside


def _mock_case_flow(config: ChannelConfig, seed: int):
    """Build the structured synthetic-turbulence generator for a case."""
    from .mockflow import MockFlowCase, MockFlowParams

    inside = domain_mask(config)
    holes = np.asarray(
        [[list(b.lo), list(b.hi)] for b in config.scaled_holes()], dtype=np.int64
    ).reshape(-1, 2, 3)
    return MockFlowCase(
        inside,
        holes,
        h=float(config.h[0]),
        params=MockFlowParams(inflow=config.inflow),
        seed=seed,
        nu=config.nu,
    )


def mock_solve(
    case_dir: Path,
    config: ChannelConfig,
    *,
    n_frames: int = 4,
    seed: int = 0,
    time_offset: float = 0.025,
) -> None:
    """Write synthetic solved time directories onto a generated case.

    Stand-in for the OpenFOAM run so the conversion pipeline (foam2h5 +
    grid-embedding) is testable offline.  Fields come from the structured
    synthetic-turbulence generator (``mockflow.MockFlowCase``): potential
    mean flow + wake deficit + von Karman fluctuations, geometry-dependent.
    Zero on no-slip cells is NOT enforced (the solver enforces BCs on faces,
    not cells).

    ``time_offset`` stamps the frames AFTER the laminar ramp-up window: mock
    frames are statistically developed turbulence from frame 0, so offsetting
    by the shapes protocol's ``discard_first_seconds=0.025`` keeps production
    configs working unchanged on mock datasets (a 48-frame mock case stamped
    from t=1e-4 would otherwise be discarded wholesale).
    """
    from .foam_io import write_field

    flow = _mock_case_flow(config, seed)

    bf_specs = {
        "U": {
            "inlets": {"type": "fixedValue", "value": np.array([config.inflow, 0, 0])},
            "outlets": {"type": "inletOutlet", "inletValue": np.zeros(3)},
            "walls": {"type": "noSlip"},
        },
        "p": {
            "inlets": {"type": "zeroGradient"},
            "outlets": {"type": "fixedValue", "value": np.array([0.0])},
            "walls": {"type": "zeroGradient"},
        },
        "k": {
            "inlets": {"type": "fixedValue", "value": np.array([1e-3])},
            "outlets": {"type": "zeroGradient"},
            "walls": {"type": "fixedValue", "value": np.array([0.0])},
        },
        "nut": {
            "inlets": {"type": "calculated", "value": np.array([0.0])},
            "outlets": {"type": "calculated", "value": np.array([0.0])},
            "walls": {"type": "nutkWallFunction", "value": np.array([0.0])},
        },
    }
    dims = {
        "U": "[0 1 -1 0 0 0 0]",
        "p": "[0 2 -2 0 0 0 0]",
        "k": "[0 2 -2 0 0 0 0]",
        "nut": "[0 2 -1 0 0 0 0]",
    }

    for i in range(n_frames):
        t = time_offset + (i + 1) * config.write_interval
        tdir = Path(case_dir) / f"{t:.6g}"
        tdir.mkdir(exist_ok=True)
        fields = flow.cell_frame(i)
        write_field(tdir / "U", "U", fields["u"], bf_specs["U"], dims["U"])
        write_field(tdir / "p", "p", fields["p"], bf_specs["p"], dims["p"])
        write_field(tdir / "k", "k", fields["k"], bf_specs["k"], dims["k"])
        write_field(
            tdir / "nut", "nut", fields["nut"], bf_specs["nut"], dims["nut"]
        )


def mock_solve_direct(
    case_dir: Path,
    config: ChannelConfig,
    *,
    n_frames: int = 4,
    seed: int = 0,
    mesh: Optional[tuple] = None,
    time_offset: float = 0.025,
    format: str = "npyd",
) -> Path:
    """Mock-solve straight into ``data.npyd`` (or ``data.h5`` with
    ``format="h5"``), skipping the ASCII time dirs.

    The ASCII OpenFOAM field format costs ~3x the storage of the float32
    HDF5 and dominates generation time at dataset scale; this path hands the
    in-memory frames to the converter (BCs still come from the real case
    files written by ``generate_case``), producing a byte-equivalent
    ``data.h5`` schema.  ``mesh`` (a ``build_polymesh`` tuple) skips the
    ASCII polyMesh re-parse too.
    """
    from .convert import foam_case_to_h5

    flow = _mock_case_flow(config, seed)
    times = [time_offset + (i + 1) * config.write_interval for i in range(n_frames)]
    frames = [flow.cell_frame(i) for i in range(n_frames)]
    return foam_case_to_h5(
        case_dir,
        frames_override=frames,
        times_override=times,
        mesh_override=mesh,
        format=format,
    )


def refresh_mock_frames(
    case_dir: Path,
    config: ChannelConfig,
    *,
    n_frames: int = 4,
    seed: int = 0,
    time_offset: float = 0.025,
    format: str = "npyd",
) -> Path:
    """Replace only ``data/*`` of an existing case's ``data.npyd`` (or
    ``data.h5`` with ``format="h5"``) with freshly mock-solved frames,
    keeping the mesh/grid/BC groups (the geometry is unchanged — re-meshing
    and re-embedding would be wasted work).  Stale ASCII time directories
    from a previous ASCII mock-solve are removed so the case dir stays
    self-consistent."""
    import shutil

    from ..data.npyd import open_case_file, replace_groups
    from .convert import format_suffix

    case_dir = Path(case_dir)
    h5_file = case_dir / f"data{format_suffix(format)}"
    flow = _mock_case_flow(config, seed)

    with open_case_file(h5_file) as f:
        n_cells = f["grid/cell_idx"].shape[0]
    shapes = {"u": (n_cells, 3), "p": (n_cells,), "k": (n_cells,), "nut": (n_cells,)}
    data = {key: np.empty((n_frames, *shape), dtype=np.float32) for key, shape in shapes.items()}
    for i in range(n_frames):
        fields = flow.cell_frame(i)
        assert fields["u"].shape[0] == n_cells
        for key, ds in data.items():
            ds[i] = fields[key]
    arrays = {
        "data/times": np.asarray(
            [time_offset + (i + 1) * config.write_interval for i in range(n_frames)]
        ),
        **{f"data/{key}": ds for key, ds in data.items()},
    }
    replace_groups(h5_file, ("data",), arrays)

    # drop stale ASCII time dirs (they carried the previous mock's fields)
    for child in case_dir.iterdir():
        if child.is_dir() and _is_float(child.name) and float(child.name) > 0:
            shutil.rmtree(child)
    return h5_file


def _is_float(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False
