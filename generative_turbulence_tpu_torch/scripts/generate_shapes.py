"""Generate the 45-shape obstacle dataset: one OpenFOAM case per shape with
train/val/test split symlinks.

    python -m generative_turbulence_tpu_torch.scripts.generate_shapes <out_root> \\
        [--mock-solve | --mock-direct] [--frames N] [--format npyd|h5]

Port of ``scripts/generate-shapes.py`` (the reference's
``scripts/generate-shapes.py``).  With ``--mock-solve`` the cases are also
"solved" with synthetic fields and converted to a case file (offline
pipeline; for real physics run OpenFOAM on the generated cases instead).
The case files and the mean flow are written as ``.npyd`` directories, which
read without ``h5py``, or with ``--format h5`` as HDF5 files (that needs
``h5py``); ``--resume`` looks for the artifacts of that format.  Host numpy
only: no tensor work, no device.
"""

from __future__ import annotations

import argparse
import zlib
from pathlib import Path

from ..toolchain.convert import FORMATS


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out_root")
    ap.add_argument("--mock-solve", action="store_true")
    ap.add_argument(
        "--mock-direct", action="store_true",
        help="mock-solve straight into the case file (no ASCII time dirs; ~3x "
        "less disk, required for large --frames)",
    )
    ap.add_argument(
        "--refresh-frames", action="store_true",
        help="regenerate only the data/* frames (and the frame-derived "
        "analyses) of already-generated cases, reusing mesh/grid groups; "
        "also removes stale ASCII time dirs",
    )
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--n-subdomains", type=int, default=1)
    ap.add_argument(
        "--limit", type=int, default=None,
        help="generate only the first N cases per split (smoke runs)",
    )
    ap.add_argument(
        "--resume", action="store_true",
        help="skip cases whose case file already carries the analysis artifacts; "
        "cases with a case file but missing analyses get only the analyses",
    )
    ap.add_argument(
        "--analyses", default="all", choices=["all", "eval-only", "cheap", "none"],
        help="which cases get the per-case analysis artifacts (mean-flow/"
        "regions/max-tke): 'eval-only' restricts them to val/test cases — "
        "training only needs the case file + stats.pickle, and the analyses cost "
        "minutes per case on one CPU; 'cheap' runs mean-flow + max-tke on "
        "every case but skips regions.npz (disables only the expensive "
        "Wasserstein metric)",
    )
    ap.add_argument(
        "--overfit", type=int, default=None, metavar="N",
        help="build an N-case overfit-diagnostic root: the first N "
        "TRAIN-split cases, with train/ and val/ symlinking the SAME cases. "
        "Evaluates in-distribution memorization — a fast check that the "
        "training stack drives val metrics toward the floor; NOT the "
        "generalization protocol (that is the full 27/9/9 split).",
    )
    ap.add_argument(
        "--format", default="npyd", choices=sorted(FORMATS),
        help="case file format: npyd (data.npyd, mean-flow.npyd; no h5py needed) or h5",
    )
    args = ap.parse_intermixed_args(argv)

    from ..toolchain.analysis import dataset_stats, homogeneous_regions, max_mean_tke, mean_flow
    from ..toolchain.boxmesh import build_polymesh
    from ..toolchain.convert import add_grid_embedding, foam_case_to_h5, format_suffix
    from ..toolchain.generate import (
        ChannelConfig,
        domain_mask,
        generate_case,
        mock_solve,
        mock_solve_direct,
        refresh_mock_frames,
    )
    from ..toolchain.shapes import dataset_split, shape_boxes, shape_catalog, validate_shape

    fmt = args.format
    suffix = format_suffix(fmt)
    data_name, mean_name = f"data{suffix}", f"mean-flow{suffix}"
    root = Path(args.out_root)
    cases_dir = root / "cases"
    catalog = shape_catalog()
    split = dataset_split(catalog)
    if args.limit is not None:
        split = {k: v[: args.limit] for k, v in split.items()}
    if args.overfit is not None:
        names = split["train"][: args.overfit]
        split = {"train": names, "val": names}
    chosen = list(dict.fromkeys(n for names in split.values() for n in names))
    eval_names = set(split.get("val", [])) | set(split.get("test", []))
    done = {}

    def say(name: str, status: str, line: str) -> None:
        done[name] = status
        print(line, flush=True)

    for name in chosen:
        with_analyses = args.analyses in ("all", "cheap") or (
            args.analyses == "eval-only" and name in eval_names
        )
        rects = catalog[name]
        validate_shape(name, rects)
        config = ChannelConfig(
            holes=shape_boxes(rects),
            scale=args.scale,
            n_subdomains=args.n_subdomains,
        )
        case_dir = cases_dir / name
        artifacts = [data_name]
        if with_analyses:
            artifacts += [mean_name, "max-mean-tke.npy"]
            if args.analyses != "cheap":
                artifacts += ["regions.npz"]
        if args.resume and all((case_dir / a).exists() for a in artifacts):
            say(name, "complete", f"skipping {name} (complete)")
            continue
        # deterministic per-case seed (builtin str hash is process-salted)
        seed = zlib.crc32(name.encode()) % 2**31
        if args.resume and not args.refresh_frames and (case_dir / data_name).exists():
            # The case file survived an earlier run: fill in only the analyses.
            h5 = case_dir / data_name
            if with_analyses:
                if not (case_dir / mean_name).exists():
                    mean_flow(h5, discard_first_seconds=-1.0, format=fmt)
                if args.analyses != "cheap" and not (case_dir / "regions.npz").is_file():
                    homogeneous_regions(h5, k=16, discard_first_seconds=-1.0)
                if not (case_dir / "max-mean-tke.npy").is_file():
                    max_mean_tke(h5, discard_first_seconds=-1.0)
            say(name, "analyses filled", f"analyses filled for {name}")
            continue
        if args.refresh_frames:
            h5 = case_dir / data_name
            assert h5.exists(), f"--refresh-frames: no {data_name} in {case_dir}"
            refresh_mock_frames(case_dir, config, n_frames=args.frames, seed=seed, format=fmt)
            say(name, "refreshed", f"refreshed {name}")
        else:
            # mock-direct carries the mesh in memory (the case file gets the
            # full domain/* groups); the ASCII polyMesh is only written when a
            # real OpenFOAM solve could follow.
            generate_case(case_dir, config, write_polymesh_too=not args.mock_direct)
            say(name, "generated", f"generated {name}")
        if args.mock_solve or args.mock_direct:
            if args.mock_direct:
                mesh = build_polymesh(domain_mask(config), config.h)
                h5 = mock_solve_direct(
                    case_dir, config, n_frames=args.frames, seed=seed, mesh=mesh, format=fmt
                )
                add_grid_embedding(h5, case_dir, mesh_override=mesh)
                del mesh
            else:
                mock_solve(case_dir, config, n_frames=args.frames, seed=seed)
                h5 = foam_case_to_h5(case_dir, format=fmt)
                add_grid_embedding(h5, case_dir)
        if (args.mock_solve or args.mock_direct or args.refresh_frames) and with_analyses:
            mean_flow(h5, discard_first_seconds=-1.0, format=fmt)
            if args.analyses != "cheap":
                homogeneous_regions(h5, k=16, discard_first_seconds=-1.0)
            max_mean_tke(h5, discard_first_seconds=-1.0)

    # Split symlinks (same layout as the reference: root/{split}/{case}).
    for split_name, names in split.items():
        split_dir = root / split_name
        split_dir.mkdir(parents=True, exist_ok=True)
        for name in names:
            link = split_dir / name
            if not link.exists():
                link.symlink_to(Path("..") / "cases" / name)

    stats = None
    if args.mock_solve or args.mock_direct or args.refresh_frames:
        train_files = [root / "train" / n / data_name for n in split["train"]]
        stats = root / "stats.pickle"
        dataset_stats(train_files, stats)
        print("wrote stats.pickle")
    return {"root": str(root), "format": fmt, "cases": done, "splits": split,
            "stats": None if stats is None else str(stats)}


if __name__ == "__main__":
    main()
