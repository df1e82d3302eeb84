"""Submit OpenFOAM solver runs as a SLURM array job.

    python -m generative_turbulence_tpu_torch.scripts.solve_slurm <cases_root> [--partition p] \\
        [--time 48:00:00] [--mem-per-cpu 2G] [--image openfoam/openfoam10-paraview510] \\
        [--runner udocker|docker|native] [--dry-run]

Port of ``scripts/solve-slurm.py`` (the reference's ``scripts/solve-slurm.py
:15-98``): writes ``<cases_root>/slurm-cases.txt`` (one solvable case, a
directory with an ``entrypoint.sh``, per line) and ``<cases_root>/
solve.sbatch``, an array job whose task i runs case i's ``entrypoint.sh``
inside the container, with as many CPUs per task as the largest
``numberOfSubdomains`` of the cases' ``system/decomposeParDict``; then
submits it with ``sbatch`` unless ``--dry-run``.  Host only.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path


def cpu_count_for(case_dir: Path) -> int:
    from ..toolchain.foam_dicts import parse_foam_file

    f = case_dir / "system" / "decomposeParDict"
    if f.is_file():
        return int(parse_foam_file(f).get("numberOfSubdomains", 1))
    return 1


def sbatch_script(cases: list, list_file: Path, n_cpus: int, args) -> str:
    """The array job's text for ``cases`` listed in ``list_file``."""
    if args.runner == "udocker":
        run_cmd = f'udocker run -v "$CASE:/case" {args.image} /case/entrypoint.sh'
    elif args.runner == "docker":
        run_cmd = f'docker run --rm -v "$CASE:/case" {args.image} /case/entrypoint.sh'
    else:
        run_cmd = '"$CASE/entrypoint.sh"'
    return f"""#!/bin/bash
#SBATCH --array=1-{len(cases)}
#SBATCH --cpus-per-task={n_cpus}
#SBATCH --mem-per-cpu={args.mem_per_cpu}
#SBATCH --time={args.time}
{f'#SBATCH --partition={args.partition}' if args.partition else ''}
#SBATCH --output=%x-%a.out

CASE=$(sed -n "${{SLURM_ARRAY_TASK_ID}}p" {list_file.resolve()})
echo "solving $CASE with {n_cpus} cpus"
{run_cmd}
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cases_root")
    ap.add_argument("--partition", default=None)
    ap.add_argument("--time", default="48:00:00")
    ap.add_argument("--mem-per-cpu", default="2G")
    ap.add_argument("--image", default="openfoam/openfoam10-paraview510")
    ap.add_argument("--runner", default="udocker", choices=["udocker", "docker", "native"])
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_intermixed_args(argv)

    root = Path(args.cases_root)
    cases = sorted(d for d in root.iterdir() if (d / "entrypoint.sh").is_file())
    if not cases:
        print("no cases found", file=sys.stderr)
        return 1
    n_cpus = max(cpu_count_for(c) for c in cases)
    list_file = root / "slurm-cases.txt"
    list_file.write_text("\n".join(str(c.resolve()) for c in cases) + "\n")
    batch_file = root / "solve.sbatch"
    batch_file.write_text(sbatch_script(cases, list_file, n_cpus, args))
    print(f"wrote {batch_file} ({len(cases)} cases, {n_cpus} cpus each)")

    if not args.dry_run:
        subprocess.run(["sbatch", str(batch_file)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
