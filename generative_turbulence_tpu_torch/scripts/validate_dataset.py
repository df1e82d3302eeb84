"""Validate a generated dataset tree: per-case file integrity + artifacts.

    python -m generative_turbulence_tpu_torch.scripts.validate_dataset <data_root> [--deep]

Port of ``scripts/validate-dataset.py``.  Checks every case under
``<data_root>/cases``: its case file, taken by ``find_data_files``'s rule
(``data.npyd`` where there is one, else ``data.h5``; the reference script
opens ``data.h5`` by name and so fails every ``.npyd`` case), openable,
finite fields, consistent frame/cell counts, grid-embedding metadata
present, and the analysis artifacts (``mean-flow.npyd`` or
``mean-flow.h5``, ``regions.npz``, ``max-mean-tke.npy``) readable and
finite.  ``--deep`` additionally re-reads every frame (catches truncated
chunks).  Prints ``{"n_cases": ..., "failed": {case: [errors]}}``; the exit
code is 1 if any case fails or there is none.  Counterpart of the
reference's generation-time asserts (``scripts/generate-shapes.py:155-178``)
as a standalone post-hoc check.  Host only.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional

import numpy as np

from ..data.npyd import open_case_file, read_tree
from ..data.schema import case_file


def check_case(case_dir: Path, deep: bool) -> list:
    errors = []
    file = case_file(case_dir)
    if file is None:
        return [f"missing {case_dir}/data.npyd or data.h5"]
    try:
        with open_case_file(file) as f:
            for key in ("data", "grid", "geometry", "boundary-conditions"):
                if key not in f:
                    errors.append(f"missing group {key}")
            if errors:
                return errors
            u = f["data/u"]
            p = f["data/p"]
            t = f["data/times"][:] if "times" in f["data"] else None
            n_frames, n_cells = u.shape[0], u.shape[1]
            if p.shape[0] != n_frames or p.shape[1] != n_cells:
                errors.append(f"u/p shape mismatch: {u.shape} vs {p.shape}")
            if n_frames < 2:
                errors.append(f"too few frames: {n_frames}")
            frames = range(n_frames) if deep else [0, n_frames - 1]
            for i in frames:
                if not np.isfinite(u[i]).all():
                    errors.append(f"non-finite u in frame {i}")
                if not np.isfinite(p[i]).all():
                    errors.append(f"non-finite p in frame {i}")
            if t is not None and not np.all(np.diff(t) > 0):
                errors.append("non-monotonic times")
    except Exception as e:  # truncated/locked/corrupt file
        return [f"unreadable {file.name}: {e!r}"]

    artifacts = [
        ("mean-flow.npyd or mean-flow.h5", case_file(case_dir, "mean-flow")),
        ("regions.npz", case_dir / "regions.npz"),
        ("max-mean-tke.npy", case_dir / "max-mean-tke.npy"),
    ]
    for name, path in artifacts:
        if path is None or not path.exists():
            errors.append(f"missing {name}")
            continue
        try:
            if path.suffix == ".npz":
                data = np.load(path)
                if "assignments" not in data:
                    errors.append(f"{name} missing assignments")
            elif path.suffix == ".npy":
                arr = np.load(path)
                if not np.isfinite(arr).all():
                    errors.append(f"non-finite {name}")
            else:
                arrays, _ = read_tree(path)
                for key, arr in arrays.items():
                    if np.issubdtype(arr.dtype, np.floating) and not np.isfinite(arr).all():
                        errors.append(f"non-finite {path.name}:{key}")
        except Exception as e:
            errors.append(f"unreadable {path.name}: {e!r}")
    return errors


def main(argv=None) -> Optional[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("data_root")
    ap.add_argument("--deep", action="store_true", help="read every frame")
    args = ap.parse_intermixed_args(argv)

    root = Path(args.data_root)
    cases = sorted((root / "cases").iterdir()) if (root / "cases").is_dir() else []
    if not cases:
        print(f"no cases under {root}/cases", file=sys.stderr)
        return None

    failed = {}
    for case_dir in cases:
        if not case_dir.is_dir():
            continue
        errors = check_case(case_dir, args.deep)
        status = "ok" if not errors else "FAIL"
        print(f"{case_dir.name}: {status}", file=sys.stderr)
        if errors:
            failed[case_dir.name] = errors

    result = {"n_cases": len(cases), "failed": failed}
    print(json.dumps(result))
    return result


def exit_code(result: Optional[dict]) -> int:
    """1 where a case failed or there was none, else 0."""
    return 1 if result is None or result["failed"] else 0


if __name__ == "__main__":
    sys.exit(exit_code(main()))
