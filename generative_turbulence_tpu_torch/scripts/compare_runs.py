"""Build the 3-model shapes-experiment comparison table.

    python -m generative_turbulence_tpu_torch.scripts.compare_runs \\
        diffusion=docs/runs/shapes-diffusion tfnet=docs/runs/shapes-tfnet \\
        dilresnet=docs/runs/shapes-dilresnet --out docs/runs/shapes-3model-comparison

Port of ``scripts/compare-runs.py``, on the host.  The reference's flagship
experiment compares diffusion, TF-Net and DilResNet on the shapes data,
ranked by ``val/tke``, with the per-step unroll MSE of the regression
models.  This distills ``summarize_run``'s outputs (``summary.json`` and
``metrics.jsonl`` of each run) into ``<out>.json`` and a markdown table
``<out>.md``, with the degenerate samplers' mean ``val/tke``
(``degenerate_baselines``'s JSON, ``--baselines``) as context.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

REGION_KEYS = ["val/tke", "val/tke-front", "val/tke-middle", "val/tke-back", "val/max-mean-tke-pos"]


def load_summary(run_dir: Path) -> dict:
    return json.loads((run_dir / "summary.json").read_text())


def distill(name: str, summary: dict) -> dict:
    best = summary.get("best") or {}
    traj = summary.get("trajectory", [])
    final = traj[-1] if traj else {}
    per_case = summary.get("final_per_case", {})
    last_val = summary.get("final_val_record", {})
    row = {
        "model": name,
        "run_dir": summary.get("run_dir"),
        "n_train_steps": summary.get("n_train_steps"),
        "wall_time_s": summary.get("wall_time_s"),
        "train_loss_last": summary.get("train_loss_last"),
        "best_val_tke": best.get("val/tke"),
        "best_step": best.get("step"),
        "final_val_tke": final.get("val/tke"),
        "n_validations": len(traj),
    }
    for k in REGION_KEYS[1:]:
        if k in last_val:
            row[k] = last_val[k]
    for k, v in sorted(last_val.items()):
        if "wasserstein" in k and k.count("/") == 1:
            row[k] = v
        if k.startswith("val/unroll/mse-"):
            row[k] = v
    row["per_case_val_tke"] = {k.split("/")[-1]: v for k, v in per_case.items() if k.startswith("val/tke/")}
    return row


def degenerate_lines(path: Path) -> dict:
    """Mean val/tke per degenerate sampler (noise / cross-case / mean-flow)."""
    if not path.is_file():
        return {}
    out = {}
    for sampler, metrics in json.loads(path.read_text()).items():
        if not isinstance(metrics, dict):
            continue
        tkes = [v for k, v in metrics.items() if k.endswith("/tke")]
        if tkes:
            out[sampler] = sum(tkes) / len(tkes)
    return out


def fmt(v):
    if v is None:
        return "—"
    if isinstance(v, float):
        return f"{v:.2f}" if abs(v) >= 0.1 else f"{v:.4f}"
    return str(v)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("runs", nargs="+", help="name=docs/runs/<dir> pairs")
    ap.add_argument("--out", default="docs/runs/shapes-3model-comparison")
    ap.add_argument("--baselines", default="docs/runs/degenerate-baselines.json")
    args = ap.parse_intermixed_args(argv)

    rows = []
    for spec in args.runs:
        name, _, run_dir = spec.partition("=")
        summary = load_summary(Path(run_dir))
        # summary.json keeps the last validation's per-case table only; the
        # whole record (Wasserstein and unroll keys) is in metrics.jsonl.
        mfile = Path(run_dir) / "metrics.jsonl"
        if mfile.is_file():
            vals = [json.loads(line) for line in mfile.read_text().splitlines() if line.strip() and "val/tke" in line]
            if vals:
                summary["final_val_record"] = vals[-1]
        rows.append(distill(name, summary))

    baselines = degenerate_lines(Path(args.baselines))
    result = {"models": rows, "degenerate_baselines_mean_val_tke": baselines}

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.with_suffix(".json").write_text(json.dumps(result, indent=2))

    cols = ["model", "n_train_steps", "wall_time_s", "train_loss_last", "best_val_tke", "best_step", "final_val_tke"]
    extra = sorted({k for r in rows for k in r if k.startswith("val/") or "wasserstein" in k})
    lines = [
        "# Shapes experiment: 3-model comparison",
        "",
        "Reference protocol: `config/shapes_experiment.yaml:16-26` "
        "(diffusion vs TF-Net vs DilResNet, monitor `val/tke`); mock-scale "
        "adaptations recorded in `config/shapes_{tfnet,dilresnet}.yaml`.",
        "",
        "| " + " | ".join(cols + extra) + " |",
        "|" + "---|" * (len(cols) + len(extra)),
    ]
    for r in rows:
        lines.append("| " + " | ".join(fmt(r.get(c)) for c in cols + extra) + " |")
    lines += ["", "Degenerate-sampler context (mean val/tke): "
              + ", ".join(f"{k}={v:.1f}" for k, v in baselines.items())]
    out.with_suffix(".md").write_text("\n".join(lines) + "\n")
    print(f"wrote {out}.json and {out}.md ({len(rows)} models)")
    return result


if __name__ == "__main__":
    main()
