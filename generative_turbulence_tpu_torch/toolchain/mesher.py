"""Constructive-solid-geometry channel mesher -> blockMeshDict.

Equivalent capability to the reference's ``scripts/channel-3d.py:21-349``:
an axis-aligned channel box minus axis-aligned obstacle boxes, decomposed
into hex blocks for blockMesh, with outer/obstacle faces classified into
inlets / outlets / walls / empties boundaries.

Approach (re-designed, not a translation): collect the x/y/z cut planes of
all boxes, partition the channel into a rectilinear grid of candidate blocks,
keep blocks outside every hole, then emit deduplicated vertices + hex blocks
(+ per-face boundary patches).  All coordinates are integer cell units scaled
by the physical cell size ``h``.

A copy of ``generative_turbulence_tpu/toolchain/mesher.py`` (host numpy,
no JAX): the same names, defaults and results.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Box:
    """Axis-aligned box in integer cell coordinates: [lo, hi)."""

    lo: Tuple[int, int, int]
    hi: Tuple[int, int, int]

    def __post_init__(self):
        assert all(h > l for l, h in zip(self.lo, self.hi)), f"empty box {self}"

    @property
    def size(self) -> Tuple[int, int, int]:
        return tuple(h - l for l, h in zip(self.lo, self.hi))

    def contains_cell_box(self, lo, hi) -> bool:
        return all(l >= bl and h <= bh for l, h, bl, bh in zip(lo, hi, self.lo, self.hi))

    def overlaps(self, other: "Box") -> bool:
        return all(l < oh and h > ol for l, h, ol, oh in zip(self.lo, self.hi, other.lo, other.hi))


@dataclasses.dataclass
class ChannelMesh:
    """Result of meshing: blocks + boundary faces, in integer cell units."""

    cell_counts: Tuple[int, int, int]
    h: Tuple[float, float, float]
    blocks: List[Box]
    vertices: np.ndarray  # (V, 3) integer coords
    block_vertex_ids: List[Tuple[int, ...]]  # 8 ids per block, blockMesh order
    boundaries: Dict[str, List[Tuple[int, int, int, int]]]  # patch -> quad faces
    holes: List[Box]
    two_dimensional: bool


# blockMesh hex vertex ordering: the 4 bottom vertices counter-clockwise
# (z = lo), then the 4 top vertices in the same x/y order (z = hi).
_HEX_CORNERS = [
    (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
    (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1),
]

# Outward faces of a hex in blockMesh corner indices, per (axis, side).
_FACES = {
    (0, 0): (0, 4, 7, 3),  # x-min
    (0, 1): (1, 2, 6, 5),  # x-max
    (1, 0): (0, 1, 5, 4),  # y-min
    (1, 1): (3, 7, 6, 2),  # y-max
    (2, 0): (0, 3, 2, 1),  # z-min
    (2, 1): (4, 5, 6, 7),  # z-max
}


def mesh_channel(
    cell_counts: Sequence[int],
    holes: Sequence[Box],
    h: Sequence[float] = (1.0, 1.0, 1.0),
) -> ChannelMesh:
    nx, ny, nz = (int(c) for c in cell_counts)
    channel = Box((0, 0, 0), (nx, ny, nz))
    holes = list(holes)
    for hole in holes:
        assert channel.contains_cell_box(hole.lo, hole.hi), f"hole {hole} outside channel"

    # Cut planes: channel bounds + all hole faces, per axis.
    cuts = []
    for axis in range(3):
        vals = {0, (nx, ny, nz)[axis]}
        for hole in holes:
            vals.add(hole.lo[axis])
            vals.add(hole.hi[axis])
        cuts.append(sorted(vals))

    # Candidate blocks = rectilinear cells of the cut grid, minus holes.
    blocks: List[Box] = []
    for ix, iy, iz in itertools.product(
        range(len(cuts[0]) - 1), range(len(cuts[1]) - 1), range(len(cuts[2]) - 1)
    ):
        lo = (cuts[0][ix], cuts[1][iy], cuts[2][iz])
        hi = (cuts[0][ix + 1], cuts[1][iy + 1], cuts[2][iz + 1])
        b = Box(lo, hi)
        if not any(hole.overlaps(b) for hole in holes):
            blocks.append(b)

    # Deduplicated vertex table.
    vertex_ids: Dict[Tuple[int, int, int], int] = {}
    vertices: List[Tuple[int, int, int]] = []

    def vid(p: Tuple[int, int, int]) -> int:
        if p not in vertex_ids:
            vertex_ids[p] = len(vertices)
            vertices.append(p)
        return vertex_ids[p]

    block_vertex_ids = []
    for b in blocks:
        ids = []
        for cx, cy, cz in _HEX_CORNERS:
            p = (
                b.lo[0] + cx * (b.hi[0] - b.lo[0]),
                b.lo[1] + cy * (b.hi[1] - b.lo[1]),
                b.lo[2] + cz * (b.hi[2] - b.lo[2]),
            )
            ids.append(vid(p))
        block_vertex_ids.append(tuple(ids))

    # Boundary faces: a face shared by two blocks appears twice in the count
    # (the rectilinear decomposition guarantees matching face rectangles).
    face_count: Dict[Tuple, List[Tuple[int, int]]] = {}
    for bi, b in enumerate(blocks):
        for (axis, side), corners in _FACES.items():
            plane = b.hi[axis] if side else b.lo[axis]
            other = tuple(
                (l, h) for a, (l, h) in enumerate(zip(b.lo, b.hi)) if a != axis
            )
            face_count.setdefault((axis, plane, other), []).append((bi, side))

    two_d_axes = [a for a in range(3) if (nx, ny, nz)[a] == 1]
    two_dimensional = len(two_d_axes) > 0

    boundaries: Dict[str, List[Tuple[int, int, int, int]]] = {
        "inlets": [],
        "outlets": [],
        "walls": [],
    }
    if two_dimensional:
        boundaries["empties"] = []

    for (axis, plane, _other), owners in face_count.items():
        if len(owners) == 2:
            continue  # interior face (note: requires matching cut planes,
            # which the rectilinear decomposition guarantees)
        assert len(owners) == 1
        bi, side = owners[0]
        corners = _FACES[(axis, side)]
        quad = tuple(block_vertex_ids[bi][c] for c in corners)
        if axis == 0 and plane == 0:
            boundaries["inlets"].append(quad)
        elif axis == 0 and plane == nx:
            boundaries["outlets"].append(quad)
        elif axis in two_d_axes:
            boundaries["empties"].append(quad)
        else:
            boundaries["walls"].append(quad)

    return ChannelMesh(
        cell_counts=(nx, ny, nz),
        h=tuple(float(x) for x in h),
        blocks=blocks,
        vertices=np.asarray(vertices, dtype=np.int64),
        block_vertex_ids=block_vertex_ids,
        boundaries=boundaries,
        holes=holes,
        two_dimensional=two_dimensional,
    )


_PATCH_TYPES = {"inlets": "patch", "outlets": "patch", "walls": "wall", "empties": "empty"}


def write_blockmesh_dict(mesh: ChannelMesh, path: Path):
    """Emit a blockMeshDict (convertToMeters carries the physical cell size
    on x; anisotropic h is expressed through the vertex scaling)."""
    lines = [
        "FoamFile",
        "{",
        "    version 2.0;",
        "    format ascii;",
        "    class dictionary;",
        "    object blockMeshDict;",
        "}",
        "",
        "convertToMeters 1.0;",
        "",
        "vertices",
        "(",
    ]
    hx, hy, hz = mesh.h
    for v in mesh.vertices:
        lines.append(f"    ({v[0] * hx} {v[1] * hy} {v[2] * hz})")
    lines += [");", "", "blocks", "("]
    for b, ids in zip(mesh.blocks, mesh.block_vertex_ids):
        n = b.size
        id_str = " ".join(str(i) for i in ids)
        lines.append(
            f"    hex ({id_str}) ({n[0]} {n[1]} {n[2]}) simpleGrading (1 1 1)"
        )
    lines += [");", "", "boundary", "("]
    for name, faces in mesh.boundaries.items():
        lines += [
            f"    {name}",
            "    {",
            f"        type {_PATCH_TYPES[name]};",
            "        faces",
            "        (",
        ]
        for quad in faces:
            lines.append(f"            ({quad[0]} {quad[1]} {quad[2]} {quad[3]})")
        lines += ["        );", "    }"]
    lines += [");", ""]
    Path(path).write_text("\n".join(lines))


def write_mesh_params(mesh: ChannelMesh, path: Path):
    params = {
        "cell_counts": list(mesh.cell_counts),
        "h": list(mesh.h),
        "bounding_box": [c * hi for c, hi in zip(mesh.cell_counts, mesh.h)],
        "holes": [
            {"position": list(hole.lo), "size": list(hole.size)} for hole in mesh.holes
        ],
        "n_blocks": len(mesh.blocks),
    }
    Path(path).write_text(json.dumps(params, indent=2))
    return params
