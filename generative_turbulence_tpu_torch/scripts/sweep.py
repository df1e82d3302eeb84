"""Hyperparameter sweeps: the cartesian product of comma-separated override
values, run one after another or written out as a SLURM array.

    python -m generative_turbulence_tpu_torch.scripts.sweep --sweep model=diffusion,tfnet,dilresnet \\
        --sweep trainer.seed=0,1,2 -- data.root=data/shapes

Port of ``scripts/sweep.py`` (the counterpart of the reference's
hydra-multirun experiment presets, ``config/shapes_experiment.yaml``).  Each
run is ``python -m generative_turbulence_tpu_torch.train --device <device>
<overrides> trainer.out_dir=<out>/<tag>``, with the repository root put
first on ``PYTHONPATH`` so that the module is found from any working
directory while relative paths in the overrides keep meaning what they mean
where the sweep was started.  ``--slurm`` writes ``<out>/sweep-cmds.txt``
(one command line per run) and ``<out>/sweep.sbatch`` (an array over its
lines) and submits it where ``sbatch`` exists.
"""

from __future__ import annotations

import argparse
import itertools
import math
import os
import subprocess
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]
MODULE = "generative_turbulence_tpu_torch.train"
# What --derive's expressions may call: the reference's ``eval:`` resolver.
DERIVE_NAMES = {"__builtins__": {}, "math": math, "max": max, "min": min, "int": int, "float": float}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", action="append", default=[], help="key=v1,v2,... (repeatable; cartesian product)")
    ap.add_argument(
        "--derive", action="append", default=[],
        help="key=expr computed per run; {other.key} placeholders substitute swept values, then the expression is "
             "evaluated with math builtins (the reference's `eval:` resolver), e.g. "
             "--derive 'model.eval_unroll_steps=max(int(100/{data.stride}),1)'",
    )
    ap.add_argument("--slurm", action="store_true", help="emit an sbatch array instead")
    ap.add_argument("--time", default="96:00:00")
    ap.add_argument("--partition", default=None)
    ap.add_argument("--out", default="runs/sweep")
    ap.add_argument("--device", default="cuda", help="the runs' torch device (default: cuda)")
    ap.add_argument("rest", nargs="*", help="fixed overrides for every run")
    args = ap.parse_intermixed_args(argv)

    axes = []
    for spec in args.sweep:
        key, _, values = spec.partition("=")
        axes.append([(key, v) for v in values.split(",")])

    combos = list(itertools.product(*axes)) if axes else [()]
    runs = []
    for i, combo in enumerate(combos):
        overrides = [f"{k}={v}" for k, v in combo]
        values = dict(combo)
        for spec in args.derive:
            key, _, expr = spec.partition("=")
            for name, v in values.items():
                expr = expr.replace("{" + name + "}", str(v))
            overrides.append(f"{key}={eval(expr, dict(DERIVE_NAMES))}")
        tag = "-".join(v.replace("/", "_") for _, v in combo) or f"run{i}"
        runs.append(overrides + list(args.rest) + [f"trainer.out_dir={Path(args.out) / tag}"])

    train = [sys.executable, "-m", MODULE, "--device", args.device]
    if args.slurm:
        lines_file = Path(args.out)
        lines_file.mkdir(parents=True, exist_ok=True)
        path = f"PYTHONPATH={REPO_ROOT}${{PYTHONPATH:+:$PYTHONPATH}}"
        (lines_file / "sweep-cmds.txt").write_text("\n".join(" ".join([path, *train, *r]) for r in runs) + "\n")
        script = f"""#!/bin/bash
#SBATCH --array=1-{len(runs)}
#SBATCH --time={args.time}
{f'#SBATCH --partition={args.partition}' if args.partition else ''}
#SBATCH --output=%x-%a.out
eval "$(sed -n "${{SLURM_ARRAY_TASK_ID}}p" {lines_file.resolve()}/sweep-cmds.txt)"
"""
        (lines_file / "sweep.sbatch").write_text(script)
        print(f"wrote {lines_file}/sweep.sbatch ({len(runs)} runs)")
        try:
            subprocess.run(["sbatch", str(lines_file / "sweep.sbatch")], check=True)
        except FileNotFoundError:
            print("sbatch not available here; submit the file on the cluster")
        return runs

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(REPO_ROOT), env.get("PYTHONPATH")]))
    for i, overrides in enumerate(runs):
        print(f"=== run {i + 1}/{len(runs)}: {' '.join(overrides)}", file=sys.stderr)
        subprocess.run([*train, *overrides], check=True, env=env)
    return runs


if __name__ == "__main__":
    main()
