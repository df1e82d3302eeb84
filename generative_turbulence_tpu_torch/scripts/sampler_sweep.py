"""Sweep sampling configurations on one checkpoint.

    python -m generative_turbulence_tpu_torch.scripts.sampler_sweep <ckpt_dir> [--configs sweep.json] [--out results.json]

Port of ``scripts/sampler-sweep.py``.  For each configuration (a name and
a list of overrides; ``--configs`` names a JSON list of them, the default is
``DEFAULT_CONFIGS``): restore the checkpoint under the overrides, sample the
val set into ``<trainer.out_dir>/sweep-<name>.npyd`` (every configuration
with the same draws), compute the cheap metrics and the fluctuation
diagnostics against the ground truth, and print one JSON line.  With
``--expensive-config NAME`` that configuration's store also gets the
point-cloud Wasserstein by the masked Sinkhorn on the device, over the
first ``--expensive-cases`` val cases (all without it; 0 means none).  The
store and the cases are read through the port's readers (``.npyd`` or
``.h5``), so a ``.npyd`` dataset needs no ``h5py``.  Runs on the GPU unless
``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

from ..data.npyd import open_case_file
from ..data.schema import CaseRepository, case_file, read_metadata
from ..data.variables import Variable
from ..eval.metrics import SampleMetricsCollection, WassersteinMetric
from ..eval.sample_store import SampleStore
from ..train import resolve_device
from ..training.loop import KeyedNoise
from ._common import load_task_from_checkpoint, sample_val_set

DEFAULT_CONFIGS = [
    {"name": "ddim50-bf16", "overrides": []},
    {"name": "ddim50-bf16-clip", "overrides": ["model.clip_denoised=true"]},
    {"name": "ddim50-f32", "overrides": ["model.compute_dtype=float32"]},
    {"name": "ddim50-f32-clip", "overrides": ["model.compute_dtype=float32", "model.clip_denoised=true"]},
    {"name": "ddpm500-bf16", "overrides": ["model.sampler=ddpm"]},
    {"name": "ddpm500-f32-clip",
     "overrides": ["model.sampler=ddpm", "model.compute_dtype=float32", "model.clip_denoised=true"]},
]


def _case_data_file(data_root: Path, case: str) -> Path:
    file = case_file(Path(data_root) / "val" / case)
    if file is None:
        raise FileNotFoundError(f"no data.npyd or data.h5 in {Path(data_root) / 'val' / case}")
    return file


def fluct_diagnostics(store_path, data_root) -> dict:
    """The samples' fluctuation std of u against the ground truth's (the
    second half of the case's frames), within each metric region, around
    the case's mean flow (its ``mean-flow`` file, else the frames' mean),
    and the RMS error of the samples' mean; each averaged over the cases."""
    store = SampleStore(Path(store_path), (Variable.U,))
    out = {}
    for case in store.case_names:
        data_file = _case_data_file(data_root, case)
        metadata = read_metadata(data_file)
        u_s = store.load_samples(metadata).fields[Variable.U]
        with open_case_file(data_file) as h:
            u_all = h["data/u"]
            u_g = np.asarray(u_all[u_all.shape[0] // 2:])
        mean_flow = case_file(data_file.parent, "mean-flow")
        if mean_flow is not None:
            with open_case_file(mean_flow) as h:
                um = np.asarray(h["data/u"])
        else:
            um = u_g.mean(0)
        X, Y, Z = (int(c) for c in metadata.cell_counts)
        xs = metadata.cell_idx // (Y * Z)
        W = min(Y, Z)
        fs, fg = u_s - um, u_g - um
        for region, n in [("front", 3), ("middle", 2), ("back", 1)]:
            m = (xs >= X - n * W) & (xs < X - n * W + W)
            if not m.any():
                continue
            r = float(fs[:, m].std() / max(fg[:, m].std(), 1e-12))
            out.setdefault(f"fluct-ratio-{region}", []).append(r)
        out.setdefault("mean-err-rms", []).append(float(np.sqrt(((u_s.mean(0) - um) ** 2).mean())))
    return {k: float(np.mean(v)) for k, v in out.items()}


def expensive_pass(store: SampleStore, stats, data_root, k_cases: Optional[int] = None, device="cuda") -> dict:
    """``val/wasserstein`` by the masked Sinkhorn on ``device`` over the
    first ``k_cases`` val cases of the store (all when None; none when 0),
    a case with no samples skipped; the ground truth as
    ``SampleMetricsCollection.compute`` takes it (frames evenly spaced over
    the second half of the case)."""
    metric = WassersteinMetric(solver="sinkhorn", device=device)
    case_names = store.case_names if k_cases is None else store.case_names[:k_cases]
    out = {}
    for case_name in case_names:
        tic = time.time()
        repo = CaseRepository([_case_data_file(data_root, case_name)], store.variables)
        samples = store.load_samples(repo.read_metadata(0))
        if samples.n_samples == 0:
            print(f"[expensive] {case_name}: no samples, skipped", file=sys.stderr)
            continue
        n_data = len(repo.times[0])
        data_idx = np.round(np.linspace(n_data // 2, n_data - 1, num=samples.n_samples)).astype(int)
        data = repo.read(0, data_idx)
        for name, value in metric(samples, data, stats).items():
            out[f"val/{case_name}/{name}"] = float(value)
        print(f"[expensive] {case_name}: "
              + json.dumps({k: round(v, 4) for k, v in out.items() if case_name in k})
              + f" ({time.time() - tic:.0f}s)", file=sys.stderr)
    w_keys = [k for k in out if k.endswith("/wasserstein")]
    if w_keys:
        out["val/wasserstein"] = float(np.mean([out[k] for k in w_keys]))
        out["val/wasserstein-cases"] = float(len(w_keys))
    return out


def main(argv=None, noise_factory=None) -> list:
    """``noise_factory("sample", i)`` gives batch i's draws under every
    configuration; by default a ``KeyedNoise`` seeded with
    ``trainer.seed + 1``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ckpt_dir")
    ap.add_argument("--which", default="best", choices=["best", "last"])
    ap.add_argument("--out", default=None, help="write the records as a JSON list here")
    ap.add_argument("--configs", default=None, help="JSON list of {name, overrides: [...]}; default: the built-in sweep")
    ap.add_argument("--expensive-config", default=None, metavar="NAME",
                    help="also compute val/wasserstein (masked Sinkhorn on the device) on this configuration's store")
    ap.add_argument("--expensive-cases", type=int, default=None, metavar="K",
                    help="bound the expensive pass to the first K val cases (0: none)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_intermixed_args(argv)
    device = resolve_device(args.device)
    configs = json.loads(Path(args.configs).read_text()) if args.configs else DEFAULT_CONFIGS

    results = []
    for spec in configs:
        tic = time.time()
        config, dm, task = load_task_from_checkpoint(args.ckpt_dir, spec["overrides"], args.which, device)
        store_path = Path(config.trainer.out_dir) / f"sweep-{spec['name']}.npyd"
        store = SampleStore(store_path, task.variables)
        sample_val_set(task, dm, store, noise_factory or KeyedNoise(config.trainer.seed + 1, device),
                       label=f"[{spec['name']}] ")
        collection = SampleMetricsCollection(
            "val", Path(config.data.root) / "val", SampleMetricsCollection.default_metrics("sinkhorn", device=device)
        )
        metrics = collection.compute(store, dm.stats, expensive_metrics=False)
        metrics = {k: v for k, v in metrics.items() if k.count("/") == 1}
        if args.expensive_config == spec["name"]:
            # One sampling pass serves the sweep and the expensive record.
            metrics.update(expensive_pass(store, dm.stats, config.data.root, args.expensive_cases, device))
        metrics.update(fluct_diagnostics(store_path, config.data.root))
        rec = {"name": spec["name"], "which": args.which, "seconds": round(time.time() - tic, 1),
               **{k: round(float(v), 4) for k, v in metrics.items()}}
        print(json.dumps(rec), flush=True)
        results.append(rec)

    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=2) + "\n")
    return results


if __name__ == "__main__":
    main()
