"""Dataset analysis: statistics, mean flow, homogeneous regions, TKE aux files.

Host-side counterparts of the reference's analysis scripts:
- ``dataset_stats``        -> ``stats.pickle``        (scripts/dataset-stats.py)
- ``mean_flow``            -> ``mean-flow.npyd``/``.h5`` (scripts/mean-flow.py)
- ``homogeneous_regions``  -> ``regions.npz``         (scripts/homogeneous-regions.py)
- ``max_mean_tke``         -> ``max-mean-tke.npy``    (scripts/max-mean-tke.py)
- ``first_turbulent_frame``                           (scripts/first-turbulent-frame.py)
- ``autocorrelation``      -> ``autocorrelation.npz`` (scripts/autocorrelation.py)
- ``split_h5``                                        (scripts/split-hdf5.py)

A copy of ``generative_turbulence_tpu/toolchain/analysis.py`` over the
port's format layer: each case file is read with ``open_case_file``
(``data.npyd`` or ``data.h5``, by its path), and the writers take
``format="npyd"`` (the default) or ``"h5"`` (``h5py`` imported only there).
``first_turbulent_frame`` runs the port's grid embedding and spectra on
``device`` (the GPU by default).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..data.npyd import open_case_file, read_tree
from ..data.schema import CaseMetadata, FieldStats, read_metadata
from ..data.synthetic import _numpy_curl, compute_stats as _compute_stats
from .convert import case_output, format_suffix, write_new_case_file


def dataset_stats(train_files: Sequence[Path], out_file: Path) -> FieldStats:
    """Streaming per-channel min/max/mean/std for p,u,k,nut + norm(u),
    norm(curl) over the train cases -> ``stats.pickle``."""
    stats = _compute_stats([Path(f) for f in train_files])
    stats.to_file(out_file)
    return stats


def mean_flow(
    data_file: Path,
    out_file: Optional[Path] = None,
    discard_first_seconds: float = 0.025,
    format: str = "npyd",
) -> Path:
    """Time-mean u and p (post discard) -> ``mean-flow.npyd`` (or
    ``mean-flow.h5`` with ``format="h5"``)."""
    data_file = Path(data_file)
    out_file = case_output(out_file, data_file.parent / "mean-flow", format)
    with open_case_file(data_file) as f:
        times = np.asarray(f["data/times"])
        keep = times > discard_first_seconds
        if not keep.any():
            keep = np.ones_like(keep, dtype=bool)
        u = np.asarray(f["data/u"])[keep].mean(axis=0)
        p = np.asarray(f["data/p"])[keep].mean(axis=0)
    return write_new_case_file(
        out_file, {"data/u": u.astype(np.float32), "data/p": p.astype(np.float32)}, {}
    )


# ---- homogeneous regions (k-means++ under Gaussian W2) -----------------------


def _gaussian_w2_sq(mean_a, var_a, mean_b, var_b) -> np.ndarray:
    """Squared 2-Wasserstein between diagonal Gaussians (closed form):
    |m_a - m_b|^2 + |sqrt(v_a) - sqrt(v_b)|^2, broadcast over leading axes."""
    dm = ((mean_a - mean_b) ** 2).sum(axis=-1)
    ds = ((np.sqrt(var_a) - np.sqrt(var_b)) ** 2).sum(axis=-1)
    return dm + ds


def homogeneous_regions(
    data_file: Path,
    out_file: Optional[Path] = None,
    *,
    k: int = 64,
    max_cluster_size: int = 512,
    discard_first_seconds: float = 0.025,
    seed: int = 0,
    max_iters: int = 50,
) -> np.ndarray:
    """Cluster cells into k regions by the W2 distance between their
    per-cell Normal(mean, var) velocity statistics; oversized clusters are
    split recursively (cap ``max_cluster_size``) -> ``regions.npz``.
    """
    data_file = Path(data_file)
    out_file = Path(out_file) if out_file else data_file.parent / "regions.npz"
    rng = np.random.default_rng(seed)

    with open_case_file(data_file) as f:
        times = np.asarray(f["data/times"])
        keep = times > discard_first_seconds
        if not keep.any():
            keep = np.ones_like(keep, dtype=bool)
        u = np.asarray(f["data/u"])[keep]  # (T, N, 3)

    mean = u.mean(axis=0)  # (N, 3)
    var = u.var(axis=0)  # (N, 3)
    n = len(mean)
    k = min(k, n)

    def kmeans(idx: np.ndarray, k_local: int) -> np.ndarray:
        """k-means++ on the subset ``idx``; returns local assignments.

        The diagonal-Gaussian W2^2 is the squared Euclidean distance in the
        (mean, sqrt(var)) feature space, so assignment uses one matmul
        (|x|^2 - 2 x.c + |c|^2) and center updates use bincounts — the same
        algorithm as the reference's hand-rolled loop
        (``scripts/homogeneous-regions.py:16-25``), vectorized.
        """
        m, v = mean[idx], var[idx]
        phi = np.concatenate([m, np.sqrt(v)], axis=-1)  # (n, 6)
        phi_sq = (phi**2).sum(axis=-1)
        # k-means++ seeding under W2
        centers = [int(rng.integers(len(idx)))]
        d2 = _gaussian_w2_sq(m, v, m[centers[0]], v[centers[0]])
        for _ in range(1, k_local):
            probs = d2 / d2.sum() if d2.sum() > 0 else None
            nxt = int(rng.choice(len(idx), p=probs))
            centers.append(nxt)
            d2 = np.minimum(d2, _gaussian_w2_sq(m, v, m[nxt], v[nxt]))
        cm, cv = m[centers].copy(), v[centers].copy()

        assign = np.zeros(len(idx), dtype=np.int64)
        for _ in range(max_iters):
            cphi = np.concatenate([cm, np.sqrt(cv)], axis=-1)  # (k, 6)
            D = phi_sq[:, None] - 2.0 * (phi @ cphi.T) + (cphi**2).sum(axis=-1)
            new_assign = D.argmin(axis=1)
            if np.array_equal(new_assign, assign):
                break
            assign = new_assign
            counts = np.bincount(assign, minlength=k_local).astype(np.float64)
            safe = np.maximum(counts, 1.0)
            for d in range(3):
                sm = np.bincount(assign, weights=m[:, d], minlength=k_local)
                sv = np.bincount(assign, weights=v[:, d], minlength=k_local)
                cm[:, d] = np.where(counts > 0, sm / safe, cm[:, d])
                cv[:, d] = np.where(counts > 0, sv / safe, cv[:, d])
        return assign

    assignments = kmeans(np.arange(n), k)

    # Split oversized clusters until all fit the cap.
    next_label = assignments.max() + 1
    while True:
        sizes = np.bincount(assignments)
        big = np.nonzero(sizes > max_cluster_size)[0]
        if len(big) == 0:
            break
        for label in big:
            idx = np.nonzero(assignments == label)[0]
            parts = int(np.ceil(len(idx) / max_cluster_size))
            sub = kmeans(idx, parts)
            for p in range(1, parts):
                assignments[idx[sub == p]] = next_label
                next_label += 1

    np.savez(out_file, assignments=assignments)
    return assignments


def max_mean_tke(
    data_file: Path,
    out_file: Optional[Path] = None,
    *,
    discard_first_seconds: float = 0.025,
    x_cut: int = 24,
) -> float:
    """Argmax-x of the mean TKE profile behind the obstacle -> npy."""
    data_file = Path(data_file)
    out_file = Path(out_file) if out_file else data_file.parent / "max-mean-tke.npy"
    meta = read_metadata(data_file)
    with open_case_file(data_file) as f:
        times = np.asarray(f["data/times"])
        keep = times > discard_first_seconds
        if not keep.any():
            keep = np.ones_like(keep, dtype=bool)
        u = np.asarray(f["data/u"])[keep]

    X, Y, Z = (int(c) for c in meta.cell_counts)
    dense = np.zeros((len(u), X * Y * Z, 3), dtype=np.float32)
    dense[:, meta.cell_idx] = u
    dense = dense.reshape(len(u), X, Y, Z, 3)
    fluc = dense - dense.mean(axis=0)
    cut = min(x_cut, X - 1)
    tke = 0.5 * (fluc[:, cut:] ** 2).sum(axis=-1)
    profile = tke.mean(axis=(0, 2, 3))
    value = float(np.argmax(profile) + cut)
    np.save(out_file, value)
    return value


def first_turbulent_frame(
    data_file: Path,
    *,
    n_sphere: int = 512,
    n_legendre: int = 16,
    late_fraction: float = 0.5,
    n_reference: int = 16,
    device="cuda",
) -> int:
    """Detect the onset of fully-developed turbulence: the first frame whose
    TKE-spectrum distance to the late-time frames falls within 2x the max
    nearest-neighbor distance of the late set.  The spectra run on
    ``device``."""
    return turbulent_frame_distances(
        data_file,
        n_sphere=n_sphere,
        n_legendre=n_legendre,
        late_fraction=late_fraction,
        n_reference=n_reference,
        device=device,
    )["first"]


def turbulent_frame_distances(
    data_file: Path,
    *,
    n_sphere: int = 512,
    n_legendre: int = 16,
    late_fraction: float = 0.5,
    n_reference: int = 16,
    device="cuda",
) -> dict:
    """``first_turbulent_frame``'s quantities: ``late`` (the late frames'
    log-TKE distances among themselves, inf on the diagonal), ``all`` (every
    frame's to the late frames), ``limit`` and ``first``."""
    import torch

    from ..data.grid import GridMap, embed_cells
    from ..data.variables import Variable
    from ..ops.spectra import SpectrumOps, log_tke_distance_matrix

    data_file = Path(data_file)
    meta = read_metadata(data_file)
    grid = GridMap.from_metadata(meta, (Variable.U,), device=device)
    with open_case_file(data_file) as f:
        u = np.asarray(f["data/u"])
    T = len(u)
    late_start = int(T * late_fraction)
    late_idx = np.linspace(late_start, T - 1, min(n_reference, T - late_start)).astype(int)

    ops = SpectrumOps.create(n_sphere=n_sphere, n_legendre=n_legendre, device=device)
    with torch.no_grad():
        u_dense = embed_cells(torch.as_tensor(u, device=device), grid)
        u_late = u_dense[torch.as_tensor(late_idx, device=device)]
        u_mean = u_late.mean(dim=0)
        D_late = log_tke_distance_matrix(u_late, u_late, u_mean, ops)[0].cpu().numpy().copy()
        D = log_tke_distance_matrix(u_dense, u_late, u_mean, ops)[0].cpu().numpy()
    np.fill_diagonal(D_late, np.inf)
    limit = 2.0 * D_late.min(axis=1).max()

    close = D.min(axis=1) <= limit
    first = int(np.argmax(close)) if close.any() else T
    return {"late": D_late, "all": D, "limit": float(limit), "first": first}


def autocorrelation(
    data_file: Path,
    out_file: Optional[Path] = None,
    *,
    discard_first_seconds: float = 0.025,
    threshold: float = 1 / np.e,
) -> int:
    """Temporal autocorrelation of the fluctuating velocity in the back
    quarter of the channel; returns the decorrelation step count."""
    data_file = Path(data_file)
    out_file = Path(out_file) if out_file else data_file.parent / "autocorrelation.npz"
    meta = read_metadata(data_file)
    with open_case_file(data_file) as f:
        times = np.asarray(f["data/times"])
        keep = times > discard_first_seconds
        if not keep.any():
            keep = np.ones_like(keep, dtype=bool)
        u = np.asarray(f["data/u"])[keep]

    X = int(meta.cell_counts[0])
    # Select cells in the back quarter by their x coordinate on the grid.
    from ..utils.index import unravel_index

    coords = unravel_index(meta.cell_idx, tuple(meta.cell_counts))
    back = coords[:, 0] >= (3 * X) // 4
    u_back = u[:, back]  # (T, Nb, 3)

    fluc = u_back - u_back.mean(axis=0)
    T = len(fluc)
    var = (fluc**2).mean()
    corr = np.empty(T)
    for lag in range(T):
        corr[lag] = (fluc[: T - lag] * fluc[lag:]).mean() / (var + 1e-12)
    below = np.nonzero(corr < threshold)[0]
    steps = int(below[0]) if len(below) else T
    np.savez(out_file, correlation=corr, decorrelation_steps=steps)
    return steps


def split_h5(
    data_file: Path,
    out_dir: Path,
    *,
    fractions: Tuple[float, float, float] = (0.8, 0.1, 0.1),
    format: str = "npyd",
) -> Dict[str, Path]:
    """Split one case's frames (``data.npyd`` or ``data.h5``) into
    train/val/test time ranges, copying all non-data groups into each output
    file (``data.npyd``, or ``data.h5`` with ``format="h5"``)."""
    assert abs(sum(fractions) - 1.0) < 1e-6
    data_file = Path(data_file)
    out_dir = Path(out_dir)
    suffix = format_suffix(format)
    arrays, attrs = read_tree(data_file)
    T = len(arrays["data/times"])
    n_train = int(T * fractions[0])
    n_val = int(T * fractions[1])
    ranges = {
        "train": slice(0, n_train),
        "val": slice(n_train, n_train + n_val),
        "test": slice(n_train + n_val, T),
    }
    out = {}
    for split, rng_ in ranges.items():
        dst_path = out_dir / split / data_file.parent.name / f"data{suffix}"
        dst_path.parent.mkdir(parents=True, exist_ok=True)
        split_arrays = {
            name: array[rng_] if name.startswith("data/") else array
            for name, array in arrays.items()
        }
        write_new_case_file(dst_path, split_arrays, attrs)
        out[split] = dst_path
    return out
