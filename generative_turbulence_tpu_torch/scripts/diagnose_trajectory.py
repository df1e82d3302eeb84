"""Diagnose a non-monotone val/tke against the eps-loss trajectories.

    python -m generative_turbulence_tpu_torch.scripts.diagnose_trajectory <run_dir> [--out <prefix>]

Port of ``scripts/diagnose-trajectory.py``, on the host, over the
``metrics.jsonl`` of a run of the port's ``Trainer``.  Two rival
explanations of a ``val/tke`` that bottoms mid-run and degrades while
``train/loss`` keeps falling are told apart by what every validation logs
(``DiffusionTask.eval_diagnostics``):

- overfitting: the eps-net memorizes the train frames, so
  ``val/eps-loss-t*`` rises (or flattens, then rises) while ``train/loss``
  falls;
- sampler or selection: ``val/eps-loss-t*`` falls with ``train/loss`` but
  the sampled statistics still degrade (look at ``val/sample-u-std``).

Prints the verdict heuristics (with 3 validations or more) as JSON; with
``--out`` writes ``<out>.json`` (the aligned trajectories and the verdict)
and, where ``matplotlib`` imports, ``<out>.png`` (the loss, the eps-loss per
t, val/tke beside sample-u-std); without it, one line on stderr says the
plot was skipped.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np


def plot(train, vals, eps_keys, path: Path) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    s, l = zip(*train)
    axes[0].plot(s, l, lw=0.7)
    axes[0].set_yscale("log")
    axes[0].set_title("train/loss")
    axes[0].set_xlabel("step")
    vsteps = [r["step"] for r in vals]
    for k in eps_keys:
        axes[1].plot(vsteps, [r.get(k) for r in vals], marker="o", ms=3, label=k[len("val/eps-loss-"):])
    axes[1].set_yscale("log")
    axes[1].set_title("val/eps-loss per timestep")
    axes[1].set_xlabel("step")
    axes[1].legend(fontsize=7)
    ax2 = axes[2]
    ax2.plot(vsteps, [r.get("val/tke") for r in vals], marker="o", color="#d62728", label="val/tke")
    ax2.set_xlabel("step")
    ax2.set_ylabel("val/tke")
    ax2b = ax2.twinx()
    ax2b.plot(vsteps, [r.get("val/sample-u-std") for r in vals], marker="s", ms=3, color="#1f77b4",
              label="sample-u-std")
    ax2b.set_ylabel("val/sample-u-std")
    ax2.set_title("sampled statistics")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("run_dir")
    ap.add_argument("--out", default=None, help="output prefix (json+png)")
    args = ap.parse_intermixed_args(argv)

    run_dir = Path(args.run_dir)
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines() if line.strip()]
    train = [(r["step"], r["train/loss"]) for r in records if "train/loss" in r]
    vals = [r for r in records if "val/tke" in r]
    eps_keys = sorted({k for r in vals for k in r if k.startswith("val/eps-loss-t")},
                      key=lambda k: int(k.rsplit("t", 1)[1]))
    ema_keys = sorted({k for r in vals for k in r if k.startswith("val/eps-loss-ema-t")},
                      key=lambda k: int(k.rsplit("t", 1)[1]))

    out = {
        "train": [{"step": s, "loss": l} for s, l in train],
        "validations": [
            {
                "step": r["step"],
                "val/tke": r.get("val/tke"),
                "val/max-mean-tke-pos": r.get("val/max-mean-tke-pos"),
                "val/sample-u-std": r.get("val/sample-u-std"),
                "val/sample-u-absmax": r.get("val/sample-u-absmax"),
                **{k: r.get(k) for k in eps_keys + ema_keys},
            }
            for r in vals
        ],
    }

    # Verdict heuristics: the slope of the val eps-loss (mean over t) across
    # the second half of the validations against the train-loss slope over
    # the same steps.
    if len(vals) >= 3:
        steps = np.array([r["step"] for r in vals], dtype=float)
        eps_mean = np.array([np.mean([r[k] for k in eps_keys if k in r]) for r in vals])
        half = len(vals) // 2
        eps_slope = np.polyfit(steps[half:], eps_mean[half:], 1)[0]
        tsteps = np.array([s for s, _ in train], dtype=float)
        tloss = np.array([l for _, l in train])
        sel = tsteps >= steps[half]
        train_slope = np.polyfit(tsteps[sel], tloss[sel], 1)[0] if sel.sum() > 2 else float("nan")
        tke = np.array([r["val/tke"] for r in vals], dtype=float)
        out["verdict"] = {
            "val_eps_loss_slope_2nd_half": float(eps_slope),
            "train_loss_slope_2nd_half": float(train_slope),
            "val_tke_best_step": int(steps[int(np.nanargmin(tke))]),
            "val_tke_last_over_best": float(tke[-1] / np.nanmin(tke)),
            "overfitting_signature": bool(eps_slope > 0 and train_slope < 0),
        }
        print(json.dumps(out["verdict"], indent=2))

    if args.out:
        prefix = Path(args.out)
        prefix.parent.mkdir(parents=True, exist_ok=True)
        prefix.with_suffix(".json").write_text(json.dumps(out, indent=2))
        if importlib.util.find_spec("matplotlib") is None:
            print("plot skipped: matplotlib is not installed", file=sys.stderr, flush=True)
            print(f"wrote {prefix}.json")
        else:
            plot(train, vals, eps_keys, prefix.with_suffix(".png"))
            print(f"wrote {prefix}.json / .png")
    return out


if __name__ == "__main__":
    main()
