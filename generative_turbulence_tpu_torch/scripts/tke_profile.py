"""Streamwise mean-TKE profile of model samples against the ground truth.

    python -m generative_turbulence_tpu_torch.scripts.tke_profile <samples.npyd> <data_root>/val \\
        --out docs/runs/<run>/tke-profile

Port of ``scripts/tke-profile.py``.  Diagnoses ``val/max-mean-tke-pos`` (the
squared error of the argmax x of the mean-TKE profile,
``MaxMeanTKEPositionMetric``): where the sampled fluctuation energy lives
along the channel against where the data puts it.  Per case of the store
(an ``.npyd`` directory, or an ``.h5`` file where ``h5py`` imports): the
x-profiles of the samples and of ``--n-data`` frames spaced evenly over the
second half of the case, their argmax at x >= 24, and the case's
``max-mean-tke.npy``.  The cases are found under ``data_dir`` by
``find_data_files`` (``data.npyd``, else ``data.h5``).  The velocity is
embedded into the grid on the device.

Writes ``<out>.json`` always and ``<out>.png`` (a grid of per-case overlays)
where ``matplotlib`` imports; without it, one line on stderr says the plot
was skipped.  Runs on the GPU unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

from ..data.schema import CaseRepository, find_data_files
from ..data.variables import Variable
from ..eval.metrics import _embed_u
from ..eval.sample_store import SampleStore
from ..train import resolve_device

X_CUT = 24  # the argmax is taken behind the obstacle, as the metric takes it


def x_profile(u_embedded: np.ndarray, x_cut: int = 0) -> np.ndarray:
    """(B, X, Y, Z, 3) -> (X,) mean-TKE profile (fluctuations vs sample mean)."""
    u_fluc = u_embedded - u_embedded.mean(axis=0)
    tke = 0.5 * (u_fluc**2).sum(axis=-1)  # (B, X, Y, Z)
    return np.asarray(tke.mean(axis=(0, 2, 3)))


def plot(out: dict, path: Path) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(out)
    cols = min(3, n)
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(5 * cols, 3.2 * rows), squeeze=False)
    for ax, (case, d) in zip(axes.flat, sorted(out.items())):
        ax.plot(d["data"], label="data", color="#333333")
        ax.plot(d["samples"], label="samples", color="#d62728")
        if d["gt_pos"] is not None:
            ax.axvline(d["gt_pos"], ls="--", lw=0.8, color="#333333")
        ax.axvline(d["argmax_samples"], ls="--", lw=0.8, color="#d62728")
        ax.set_title(case, fontsize=9)
        ax.set_xlabel("x cell")
        ax.set_ylabel("mean TKE")
    for ax in axes.flat[n:]:
        ax.axis("off")
    axes.flat[0].legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("samples_file")
    ap.add_argument("data_dir", help="split directory of <case>/data.npyd (or data.h5)")
    ap.add_argument("--out", default="tke-profile", help="output prefix")
    ap.add_argument("--n-data", type=int, default=16, help="GT frames (evenly spaced over the 2nd half)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_intermixed_args(argv)
    device = resolve_device(args.device)

    samples_file = Path(args.samples_file)
    if not samples_file.exists():
        raise FileNotFoundError(f"no sample store {samples_file}")
    variables = (Variable.U, Variable.P)
    store = SampleStore(samples_file, variables)
    files = {file.parent.name: file for file in find_data_files(Path(args.data_dir))}
    out = {}
    for case_name in store.case_names:
        if case_name not in files:
            raise FileNotFoundError(f"no data.npyd or data.h5 in {Path(args.data_dir) / case_name}")
        repo = CaseRepository([files[case_name]], variables)
        meta = repo.read_metadata(0)
        samples = store.load_samples(meta)
        n_data = len(repo.times[0])
        idx = np.round(np.linspace(n_data // 2, n_data - 1, num=args.n_data)).astype(int)
        data = repo.read(0, idx)

        prof_s = x_profile(_embed_u(samples, device).cpu().numpy())
        prof_d = x_profile(_embed_u(data, device).cpu().numpy())
        gt_file = meta.file.parent / "max-mean-tke.npy"
        out[case_name] = {
            "samples": prof_s.tolist(),
            "data": prof_d.tolist(),
            "argmax_samples": int(prof_s[X_CUT:].argmax() + X_CUT),
            "argmax_data": int(prof_d[X_CUT:].argmax() + X_CUT),
            "gt_pos": float(np.load(gt_file)) if gt_file.is_file() else None,
        }
        print(f"{case_name}: data argmax {out[case_name]['argmax_data']} (gt {out[case_name]['gt_pos']}), "
              f"samples argmax {out[case_name]['argmax_samples']}")

    prefix = Path(args.out)
    prefix.parent.mkdir(parents=True, exist_ok=True)
    prefix.with_suffix(".json").write_text(json.dumps(out, indent=2))
    if importlib.util.find_spec("matplotlib") is None:
        print("plot skipped: matplotlib is not installed", file=sys.stderr, flush=True)
        print(f"wrote {prefix}.json")
    else:
        plot(out, prefix.with_suffix(".png"))
        print(f"wrote {prefix}.json / .png")
    return out


if __name__ == "__main__":
    main()
