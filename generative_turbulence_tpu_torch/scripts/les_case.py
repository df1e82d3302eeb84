"""Instantiate a single LES case from parameters.

    python -m generative_turbulence_tpu_torch.scripts.les_case <case_dir> --inflow 20 \\
        --end-time 0.5 --cells 192 48 48 [--hole x0 y0 z0 x1 y1 z1 ...] [--subdomains 8]

Port of ``scripts/les-case.py`` (the reference's ``scripts/les-case.py``):
the OpenFOAM case tree (``system/``, ``constant/``, ``0/``, ``Allrun``, the
``blockMeshDict``, a ready ``polyMesh`` and ``mesh-params.json``).  Host
only.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("case_dir")
    ap.add_argument("--inflow", type=float, default=20.0)
    ap.add_argument("--nu", type=float, default=1e-5)
    ap.add_argument("--end-time", type=float, default=0.5)
    ap.add_argument("--delta-t", type=float, default=1e-5)
    ap.add_argument("--write-interval", type=float, default=1e-4)
    ap.add_argument("--cells", nargs=3, type=int, default=[192, 48, 48])
    ap.add_argument("--size", nargs=3, type=float, default=[0.4, 0.1, 0.1])
    ap.add_argument("--subdomains", type=int, default=1)
    ap.add_argument(
        "--hole", nargs=6, type=int, action="append", default=[],
        help="x0 y0 z0 x1 y1 z1 (cell units, repeatable)",
    )
    args = ap.parse_intermixed_args(argv)

    from ..toolchain.generate import ChannelConfig, generate_case
    from ..toolchain.mesher import Box

    config = ChannelConfig(
        size=tuple(args.size),
        cell_counts=tuple(args.cells),
        inflow=args.inflow,
        nu=args.nu,
        end_time=args.end_time,
        delta_t=args.delta_t,
        write_interval=args.write_interval,
        n_subdomains=args.subdomains,
        holes=[Box(tuple(h[:3]), tuple(h[3:])) for h in args.hole],
    )
    case_dir = generate_case(Path(args.case_dir), config)
    print(f"case written to {args.case_dir}")
    return case_dir


if __name__ == "__main__":
    main()
