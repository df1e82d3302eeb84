"""Generate the 2D-vs-3D study datasets.

    python -m generative_turbulence_tpu_torch.scripts.generate_2d3d comparison <out_root> [--scales 0.25 0.5 1.0]
    python -m generative_turbulence_tpu_torch.scripts.generate_2d3d regression <out_root> [--inflows 5 10 ...] \\
        [--mock-solve] [--frames N] [--format npyd|h5]

Port of ``scripts/generate-2d3d.py`` (the reference's
``generate-2d-3d-comparison.py`` and ``generate-2d-3d-regression.py``):
``comparison`` is one obstacle at several resolutions x {2d, 3d},
``regression`` a sweep of inflow velocities x {2d, 3d}, each an OpenFOAM case
under ``<out_root>/cases/<name>``.  With ``--mock-solve`` each case is also
"solved" with synthetic fields and converted, with its grid embedding, to
``data.npyd`` (no ``h5py`` needed) or ``data.h5`` with ``--format h5``.
Host numpy only: no tensor work, no device.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..toolchain.convert import FORMATS


def jobs(mode: str, scales, inflows) -> list:
    """(case name, ChannelConfig keyword arguments, 2D?) of each case."""
    if mode == "comparison":
        return [(f"scale-{scale}-{dims}", dict(scale=scale), dims == "2d") for scale in scales for dims in ("2d", "3d")]
    return [(f"inflow-{inflow}-{dims}", dict(inflow=inflow), dims == "2d")
            for inflow in inflows for dims in ("2d", "3d")]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=["comparison", "regression"])
    ap.add_argument("out_root")
    ap.add_argument("--scales", nargs="+", type=float, default=[0.25, 0.5, 0.75, 1.0, 1.25])
    ap.add_argument("--inflows", nargs="+", type=float, default=[2.5, 5.0, 7.5, 10.0, 12.5, 15.0, 17.5, 20.0])
    ap.add_argument("--mock-solve", action="store_true")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--format", default="npyd", choices=sorted(FORMATS),
                    help="case file format of --mock-solve: npyd (no h5py needed) or h5")
    args = ap.parse_intermixed_args(argv)

    from ..toolchain.convert import add_grid_embedding, foam_case_to_h5
    from ..toolchain.generate import ChannelConfig, generate_case, mock_solve
    from ..toolchain.shapes import shape_boxes, shape_catalog

    root = Path(args.out_root)
    holes = shape_boxes(shape_catalog()["square-medium"])
    names = []
    for name, kwargs, two_d in jobs(args.mode, args.scales, args.inflows):
        config = ChannelConfig(holes=holes, **kwargs)
        if two_d:
            config = config.two_dimensionalized()
        case_dir = root / "cases" / name
        generate_case(case_dir, config)
        print(f"generated {name}")
        if args.mock_solve:
            mock_solve(case_dir, config, n_frames=args.frames)
            add_grid_embedding(foam_case_to_h5(case_dir, format=args.format), case_dir)
        names.append(name)
    return names


if __name__ == "__main__":
    main()
