"""Trivial-baseline error floors on a dataset.

    python -m generative_turbulence_tpu_torch.scripts.trivial_baselines <data_root> [--split val] [--sigma 1.0]

Port of ``scripts/trivial-baselines.py``.  Two baselines (counterparts of
the reference's ``mean-forecast-errors.py`` and
``gaussian-smoothing-error.py``), per case of the split over ``--frames``
frames spaced evenly over the whole simulation:

- ``mean-forecast``: predict the case's time-mean flow for every frame;
- ``gaussian-smoothing``: predict each frame smoothed by a Gaussian of
  ``--sigma`` cells along x, y and z on the dense padded grid (zeros outside
  the domain), as ``scipy.ndimage.gaussian_filter`` smooths it.

Prints per-variable MSEs (per case and their mean over the cases) as JSON,
so learned models' errors can be put in context.  Runs on the GPU unless
``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..data.schema import CaseRepository, find_data_files
from ..data.variables import Variable
from ..train import resolve_device

TRUNCATE = 4.0  # scipy.ndimage.gaussian_filter's default


def gaussian_weights(sigma: float) -> np.ndarray:
    """scipy's 1-D Gaussian of radius ``int(4 sigma + 0.5)``, normalized, f64."""
    radius = int(TRUNCATE * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    phi = np.exp(-0.5 / (sigma * sigma) * x**2)
    return phi / phi.sum()


def reflect_index(n: int, radius: int) -> np.ndarray:
    """Indices of an axis of ``n`` extended by ``radius`` on each side with
    scipy's ``mode="reflect"`` (``c b a | a b c | c b a``, period 2n), for any
    radius, also one past the axis."""
    i = np.arange(-radius, n + radius) % (2 * n)
    return np.where(i < n, i, 2 * n - 1 - i)


def gaussian_smooth(dense: torch.Tensor, sigma: float, axes=(1, 2, 3)) -> torch.Tensor:
    """``scipy.ndimage.gaussian_filter(dense, sigma)`` along ``axes`` only
    (``mode="reflect"``, truncate 4): one pass per axis, each a weighted sum
    of shifted slices of the extended axis in f64, stored in ``dense``'s
    dtype as scipy stores each pass in its output's."""
    weights = gaussian_weights(sigma)
    radius = len(weights) // 2
    out = dense
    for axis in axes:
        n = out.shape[axis]
        ext = out.double().index_select(axis, torch.as_tensor(reflect_index(n, radius), device=out.device))
        acc = torch.zeros_like(out, dtype=torch.float64)
        for k, w in enumerate(weights.tolist()):
            acc += w * ext.narrow(axis, k, n)
        out = acc.to(dense.dtype)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("data_root")
    ap.add_argument("--split", default="val")
    ap.add_argument("--sigma", type=float, default=1.0)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_intermixed_args(argv)
    device = resolve_device(args.device)

    variables = (Variable.U, Variable.P)
    out = {"mean-forecast": {}, "gaussian-smoothing": {}}
    for file in find_data_files(Path(args.data_root) / args.split):
        repo = CaseRepository([file], variables)
        meta = repo.read_metadata(0)
        n = len(repo.times[0])
        idx = np.round(np.linspace(0, n - 1, min(args.frames, n))).astype(int)
        data = repo.read(0, idx)
        case = meta.case_name
        cell_idx = torch.as_tensor(meta.cell_idx, device=device).long()
        X, Y, Z = (int(c) for c in meta.cell_counts)

        for v in variables:
            x = torch.as_tensor(data.fields[v], device=device)  # (T, N, C)
            mean_pred = x.mean(dim=0, keepdim=True)
            out["mean-forecast"].setdefault(v.key, {})[case] = float(((x - mean_pred) ** 2).double().mean())

            dense = torch.zeros((len(x), X * Y * Z, x.shape[-1]), dtype=torch.float32, device=device)
            dense[:, cell_idx] = x
            smoothed = gaussian_smooth(dense.reshape(len(x), X, Y, Z, -1), args.sigma)
            sm_cells = smoothed.reshape(len(x), -1, x.shape[-1])[:, cell_idx]
            out["gaussian-smoothing"].setdefault(v.key, {})[case] = float(((x - sm_cells) ** 2).double().mean())

    summary = {
        baseline: {v: float(np.mean(list(cases.values()))) for v, cases in vs.items()}
        for baseline, vs in out.items()
    }
    result = {"summary": summary, "per_case": out}
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
