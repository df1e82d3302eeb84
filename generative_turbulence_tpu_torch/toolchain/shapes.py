"""The obstacle-shape dataset: 45 named shapes on the channel cross-section.

Counterpart of the reference's ``scripts/generate-shapes.py``: each shape is a
set of axis-aligned rectangles on the 48x48 (y, z) cross-section, extruded 12
cells deep along x at offset 12, with validity checks (fill ratio <= 0.5,
minimum feature diameter, distance from the channel walls) and a fixed
27/9/9 train/val/test split by shape name.

The shape family here is designed fresh (parametric generators) rather than
copied: bars, crosses, L/T/U/H profiles, rings, slits, staircases, and
multi-block arrangements, plus wall-attached families (floor/ceiling slabs,
corner blocks, fins, wall-to-wall spans) matching the reference's
distribution of snug-to-the-wall obstacles (``generate-shapes.py:74-120``).
Validity follows the reference rule (``generate-shapes.py:160-170``): every
rectangle side is either snug against a channel wall (distance 0) or at
least ``MIN_WALL_DISTANCE`` cells away.

A copy of ``generative_turbulence_tpu/toolchain/shapes.py`` (host numpy,
no JAX): the same names, defaults and results.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .mesher import Box

CROSS_SECTION = 48  # cells in y and z
EXTRUDE_DEPTH = 12  # cells in x
X_OFFSET = 12  # cells from the inlet
MIN_FEATURE = 6  # minimum obstacle feature size (cells)
MIN_WALL_DISTANCE = 6  # minimum distance from the channel walls (cells)
MAX_FILL_RATIO = 0.5


@dataclasses.dataclass(frozen=True)
class Rect:
    """(y, z, height, width) rectangle on the cross-section, cell units."""

    y: int
    z: int
    h: int
    w: int

    def mask(self, n: int = CROSS_SECTION) -> np.ndarray:
        m = np.zeros((n, n), dtype=bool)
        m[self.y : self.y + self.h, self.z : self.z + self.w] = True
        return m


def _centered(h: int, w: int, dy: int = 0, dz: int = 0) -> Rect:
    n = CROSS_SECTION
    return Rect((n - h) // 2 + dy, (n - w) // 2 + dz, h, w)


def _bar_shapes() -> Dict[str, List[Rect]]:
    out = {}
    for name, (h, w) in {
        "bar-wide": (12, 30),
        "bar-tall": (30, 12),
        "square-medium": (18, 18),
        "square-large": (24, 24),
    }.items():
        out[name] = [_centered(h, w)]
    return out


def _wall_shapes() -> Dict[str, List[Rect]]:
    """Wall-attached families: floor/ceiling slabs (steps), corner blocks,
    fins growing out of a wall, and wall-to-wall spans.  Fresh parametric
    designs with the same *kind* coverage as the reference's steps, corners,
    pillars and full-width bars (``generate-shapes.py:74-120``)."""
    n = CROSS_SECTION
    out: Dict[str, List[Rect]] = {}
    # Steps: full-width slabs attached to the bottom / top wall.
    out["floor-slab-low"] = [Rect(0, 0, 10, n)]
    out["floor-slab-high"] = [Rect(0, 0, 20, n)]
    out["ceiling-slab"] = [Rect(n - 12, 0, 12, n)]
    # Corner blocks.
    out["corner-single"] = [Rect(0, 0, 16, 16)]
    out["corner-pair-opposite"] = [Rect(0, 0, 13, 13), Rect(n - 13, n - 13, 13, 13)]
    out["corner-pair-adjacent"] = [Rect(0, 0, 13, 13), Rect(0, n - 13, 13, 13)]
    out["corner-quad"] = [
        Rect(0, 0, 11, 11),
        Rect(0, n - 11, 11, 11),
        Rect(n - 11, 0, 11, 11),
        Rect(n - 11, n - 11, 11, 11),
    ]
    # Fins: obstacles growing out of one wall into the channel interior.
    out["fin-bottom"] = [Rect(0, 20, 30, 8)]
    out["fin-top"] = [Rect(n - 30, 20, 30, 8)]
    out["fin-pair-facing"] = [Rect(0, 14, 26, 8), Rect(n - 26, 28, 26, 8)]
    # Spans: bars connecting opposite walls.
    out["span-bar"] = [Rect(0, 20, n, 10)]
    out["span-bar-offset"] = [Rect(0, 30, n, 10)]
    out["span-double"] = [Rect(0, 8, n, 8), Rect(0, 32, n, 8)]
    # Platform (floor-attached, not full width) and a snug elbow.
    out["ledge-platform"] = [Rect(0, 8, 12, 32)]
    out["gallows"] = [Rect(0, 10, 34, 8), Rect(26, 10, 8, 28)]
    return out


def _compound_shapes() -> Dict[str, List[Rect]]:
    n = CROSS_SECTION
    c = n // 2
    out: Dict[str, List[Rect]] = {}
    out["plus"] = [_centered(10, 30), _centered(30, 10)]
    out["plus-thick"] = [_centered(14, 30), _centered(30, 14)]
    out["tee"] = [_centered(8, 30, dy=-8), _centered(16, 8, dy=4)]
    out["tee-inverted"] = [_centered(8, 30, dy=8), _centered(16, 8, dy=-4)]
    out["ell"] = [Rect(12, 12, 24, 8), Rect(28, 12, 8, 22)]
    out["ell-mirrored"] = [Rect(12, n - 20, 24, 8), Rect(28, 14, 8, 22)]
    out["ess"] = [Rect(10, 12, 8, 22), Rect(18, 20, 8, 8), Rect(26, 14, 8, 22)]
    out["aitch"] = [Rect(12, 12, 24, 8), Rect(12, 28, 24, 8), Rect(20, 12, 8, 24)]
    out["you"] = [Rect(12, 12, 24, 8), Rect(12, 28, 24, 8), Rect(28, 12, 8, 24)]
    out["ring"] = [
        Rect(12, 12, 8, 24),
        Rect(28, 12, 8, 24),
        Rect(12, 12, 24, 8),
        Rect(12, 28, 24, 8),
    ]
    out["frame-wide"] = [
        Rect(10, 10, 7, 28),
        Rect(31, 10, 7, 28),
        Rect(10, 10, 28, 7),
        Rect(10, 31, 28, 7),
    ]
    out["two-bars-horizontal"] = [Rect(12, 10, 8, 28), Rect(28, 10, 8, 28)]
    out["two-bars-vertical"] = [Rect(10, 12, 28, 8), Rect(10, 28, 28, 8)]
    out["two-squares-diagonal"] = [Rect(10, 10, 12, 12), Rect(26, 26, 12, 12)]
    out["three-columns"] = [
        Rect(12, 9, 24, 7),
        Rect(12, 20, 24, 7),
        Rect(12, 31, 24, 7),
    ]
    out["staircase"] = [
        Rect(10, 10, 8, 10),
        Rect(17, 17, 8, 10),
        Rect(24, 24, 8, 10),
    ]
    out["staircase-steep"] = [
        Rect(8, 12, 8, 8),
        Rect(16, 20, 8, 8),
        Rect(24, 28, 8, 8),
    ]
    out["diamond-steps"] = [
        _centered(8, 8, dy=-10),
        _centered(8, 8),
        _centered(8, 8, dy=10),
    ]
    out["zigzag"] = [
        Rect(10, 10, 8, 16),
        Rect(18, 18, 8, 16),
        Rect(26, 10, 8, 16),
    ]
    out["slit-horizontal"] = [Rect(12, 10, 10, 28), Rect(26, 10, 10, 28)]
    out["block-pair-wide"] = [Rect(17, 8, 14, 12), Rect(17, 28, 14, 12)]
    out["block-pair-tall"] = [Rect(8, 17, 12, 14), Rect(28, 17, 12, 14)]
    out["corner-blocks"] = [
        Rect(9, 9, 10, 10),
        Rect(9, 29, 10, 10),
        Rect(29, 9, 10, 10),
        Rect(29, 29, 10, 10),
    ]
    out["cross-offset"] = [_centered(8, 26, dy=-6), _centered(26, 8, dz=6)]
    out["anvil"] = [Rect(12, 14, 10, 20), Rect(22, 18, 12, 12)]
    out["mushroom"] = [Rect(10, 12, 10, 24), Rect(20, 20, 14, 8)]
    out["podium"] = [Rect(24, 10, 10, 28), Rect(14, 17, 10, 14)]
    del out["diamond-steps"]  # overlaps centered duplicates; keep the set tidy
    return out


def shape_catalog() -> Dict[str, List[Rect]]:
    catalog: Dict[str, List[Rect]] = {}
    catalog.update(_bar_shapes())
    catalog.update(_compound_shapes())
    catalog.update(_wall_shapes())
    assert len(catalog) == 45, f"catalog must hold 45 shapes, has {len(catalog)}"
    return catalog


def shape_mask(rects: Sequence[Rect], n: int = CROSS_SECTION) -> np.ndarray:
    m = np.zeros((n, n), dtype=bool)
    for r in rects:
        m |= r.mask(n)
    return m


def validate_shape(name: str, rects: Sequence[Rect], n: int = CROSS_SECTION):
    """Dataset validity asserts (reference ``generate-shapes.py:155-178``):
    bounded fill ratio, minimum feature diameter, and the snug-or-clear wall
    rule — each rectangle side sits either flush against a channel wall
    (distance 0, a wall-attached obstacle) or at least ``MIN_WALL_DISTANCE``
    cells away (no sliver gaps blockMesh would turn into bad cells)."""
    mask = shape_mask(rects, n)
    fill = mask.mean()
    if fill > MAX_FILL_RATIO:
        raise ValueError(f"{name}: fill ratio {fill:.2f} > {MAX_FILL_RATIO}")
    if not mask.any():
        raise ValueError(f"{name}: empty shape")
    for r in rects:
        if min(r.h, r.w) < MIN_FEATURE:
            raise ValueError(f"{name}: feature smaller than {MIN_FEATURE} cells")
        for dist in (r.y, n - (r.y + r.h), r.z, n - (r.z + r.w)):
            if dist != 0 and dist < MIN_WALL_DISTANCE:
                raise ValueError(
                    f"{name}: rect {r} is {dist} cells from a wall "
                    f"(must be snug or >= {MIN_WALL_DISTANCE})"
                )


def shape_boxes(
    rects: Sequence[Rect],
    x_offset: int = X_OFFSET,
    depth: int = EXTRUDE_DEPTH,
) -> List[Box]:
    """Extrude cross-section rectangles into 3D hole boxes."""
    return [
        Box((x_offset, r.y, r.z), (x_offset + depth, r.y + r.h, r.z + r.w))
        for r in rects
    ]


def dataset_split(names: Sequence[str]) -> Dict[str, List[str]]:
    """Deterministic 27/9/9 split by name order hash."""
    names = sorted(names)
    if len(names) != 45:
        raise ValueError(f"expected the 45-shape catalog, got {len(names)} names")
    rng = np.random.default_rng(2024)
    perm = rng.permutation(len(names))
    shuffled = [names[i] for i in perm]
    return {
        "train": sorted(shuffled[:27]),
        "val": sorted(shuffled[27:36]),
        "test": sorted(shuffled[36:45]),
    }
