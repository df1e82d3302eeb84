"""Turbulence sample-quality metrics.

Port of ``generative_turbulence_tpu/eval/metrics.py``.  The field work (grid
embedding, spectra, vorticity, the Sinkhorn solve) runs on the metric's
``device``, the card by default; the exact EMDs run on the host.

- ``WassersteinTKE`` (cheap; the monitored ``val/tke``): pairwise
  log-TKE-spectrum L2 distances over three cube regions at the channel end
  (front/middle/back at 3/2/1 channel-width offsets) around the mean flow of
  ``mean-flow.{npyd,h5}`` (else the data's mean), then the 2-Wasserstein
  distance between the sample and data distributions by exact EMD; plus the
  combined distance over the three regions.  Skips 2D cases.
- ``WassersteinMetric`` (expensive): per-cell features (u, vorticity, p;
  normalized by the stats), per homogeneous region (``regions.npz``) the
  point-cloud W2 between every sample and every data frame, weighted by the
  regions' cell counts, then an outer W2.  ``solver="exact"``: host EMDs,
  on a pool of spawned processes; ``"sinkhorn"``: entropic OT on the device.
- ``MaxMeanTKEPositionMetric`` (cheap): squared error of the argmax-x of the
  mean-TKE profile behind the obstacle against ``max-mean-tke.npy``.  A
  deviation from the JAX package: where the samples hardly fluctuate (the
  profile's largest value within rounding of 0 relative to the samples'
  mean square, as for one flow repeated) the argmax would be rounding
  noise, so the metric is undefined there (NaN) and left out of the mean
  over the cases.  On every other sample set it is the JAX package's value.

``SampleMetricsCollection`` runs each metric per case against ground-truth
frames spaced evenly over the SECOND half of the simulation and averages
across cases; in a ``torch.distributed`` run it merges the per-case values
of every rank first.
"""

from __future__ import annotations

import functools
import math
import multiprocessing
import os
from collections import defaultdict, deque
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.dataset import CaseData
from ..data.grid import GridMap, embed_cells
from ..data.npyd import open_case_file
from ..data.schema import CaseRepository, FieldStats, case_file
from ..data.variables import Variable
from ..ops.sinkhorn import masked_sinkhorn_emd2
from ..ops.spectra import SpectrumOps, log_tke_distance_matrix
from ..ops.stencils import curl
from ..parallel.distributed import allgather_objects
from .emd import emd2_sq_rows, wasserstein2
from .sample_store import SampleStore


def _embed_u(data: CaseData, device) -> torch.Tensor:
    """(B, X, Y, Z, 3) grid embedding of the velocity field of a CaseData."""
    grid = GridMap.from_metadata(data.metadata, (Variable.U,), device=device)
    return embed_cells(torch.as_tensor(data.fields[Variable.U], device=device), grid)


class WassersteinTKE:
    def __init__(self, n_sphere: int = 5810, n_legendre: int = 64, device="cuda"):
        self.device = device
        self.ops = SpectrumOps.create(n_sphere=n_sphere, n_legendre=n_legendre, device=device)
        # region -> case -> (log_tke_sample, log_tke_data, k), kept for plots
        self.case_data: Dict[str, Dict[str, tuple]] = defaultdict(dict)

    def is_expensive(self) -> bool:
        return False

    @torch.no_grad()
    def __call__(self, samples: CaseData, data: CaseData, stats: FieldStats) -> Dict[str, float]:
        if samples.metadata.two_dimensional:
            return {}

        u_sample = _embed_u(samples, self.device)
        u_data = _embed_u(data, self.device)
        mean_flow_file = case_file(data.metadata.file.parent, "mean-flow")
        if mean_flow_file is not None:
            with open_case_file(mean_flow_file) as f:
                u_mean_cells = np.asarray(f["data/u"], dtype=np.float32)
            mean_data = CaseData(metadata=data.metadata, t=np.zeros(1), fields={Variable.U: u_mean_cells[None]})
            u_mean = _embed_u(mean_data, self.device)[0]
        else:
            u_mean = u_data.mean(dim=0)

        # Cut off the synthetic boundary cells.
        u_sample = u_sample[:, 1:-1, 1:-1, 1:-1]
        u_data = u_data[:, 1:-1, 1:-1, 1:-1]
        u_mean = u_mean[1:-1, 1:-1, 1:-1]

        W = min(u_sample.shape[2], u_sample.shape[3])
        L = u_sample.shape[1]
        D_regions = []
        out: Dict[str, float] = {}
        for region, n in {"front": 3, "middle": 2, "back": 1}.items():
            start = L - n * W
            if start < 0:
                continue
            sl = slice(start, start + W)
            D, log_a, log_b, k = log_tke_distance_matrix(u_sample[:, sl], u_data[:, sl], u_mean[sl], self.ops)
            D = D.double().cpu().numpy()
            self.case_data[region][data.metadata.case_name] = tuple(
                t.cpu().numpy() for t in (log_a, log_b, k)
            )
            out[f"tke-{region}"] = wasserstein2(D)
            D_regions.append(D)

        if D_regions:
            out["tke"] = wasserstein2(np.sqrt((np.stack(D_regions) ** 2).sum(axis=0)))
        return out


def _masked_region_costs(s_pad, d_pad, mask, *, reg: float, n_iters: int) -> torch.Tensor:
    """Masked entropic costs for a chunk of padded regions.

    s_pad: (n, Kc, R, F) sample features; d_pad: (m, Kc, R, F) data features;
    mask: (Kc, R) validity.  Returns the (n, Kc, m) squared-distance transport
    costs (the <P, D^2> the exact path computes per block).
    """
    s = s_pad[:, :, None, :, None, :]  # (n, Kc, 1, R, 1, F)
    d = d_pad.permute(1, 0, 2, 3)[None, :, :, None, :, :]  # (1, Kc, m, 1, R, F)
    M = ((s - d) ** 2).sum(dim=-1)  # (n, Kc, m, R, R)
    valid = mask[None, :, None, :]  # (1, Kc, 1, R)
    row_valid = valid.expand(M.shape[:-1])
    col_valid = valid.expand(*M.shape[:-2], M.shape[-1])
    # Scale-invariant regularization: reg relative to each matrix's mean
    # valid cost, so convergence speed does not depend on feature units.
    pair = row_valid[..., :, None] & col_valid[..., None, :]
    mean_cost = torch.where(pair, M, 0.0).sum(dim=(-2, -1)) / pair.sum(dim=(-2, -1)).clamp_min(1)
    return masked_sinkhorn_emd2(M, row_valid, col_valid, reg=reg * mean_cost.clamp_min(1e-12), n_iters=n_iters)


class WassersteinMetric:
    def __init__(
        self,
        max_workers: Optional[int] = None,
        solver: str = "exact",
        max_regions: Optional[int] = None,
        region_seed: int = 0,
        sinkhorn_reg: float = 0.005,
        sinkhorn_iters: int = 1200,
        device="cuda",
    ):
        """solver: 'exact' (host EMD on ``max_workers`` processes, default
        one per core up to 32) or 'sinkhorn' (entropic OT on ``device``, at
        ``sinkhorn_reg`` times each matrix's mean cost for
        ``sinkhorn_iters`` iterations: the JAX package's calibration).

        ``max_regions`` computes the metric over a seeded subset of the
        case's regions (their cell-count weights renormalized); None uses
        them all."""
        if solver not in ("exact", "sinkhorn"):
            raise ValueError(f"Unknown Wasserstein solver {solver!r}")
        self.max_workers = max_workers
        self.solver = solver
        self.max_regions = max_regions
        self.region_seed = region_seed
        self.sinkhorn_reg = sinkhorn_reg
        self.sinkhorn_iters = sinkhorn_iters
        self.device = device

    def is_expensive(self) -> bool:
        return True

    @torch.no_grad()
    def __call__(self, samples: CaseData, data: CaseData, stats: FieldStats) -> Dict[str, float]:
        regions_file = data.metadata.file.parent / "regions.npz"
        if not regions_file.is_file():
            return {}
        assignments = np.load(regions_file)["assignments"]
        region_counts = np.bincount(assignments)
        region_labels = np.arange(len(region_counts))
        if self.max_regions is not None and self.max_regions < len(region_labels):
            rng = np.random.default_rng(self.region_seed)
            region_labels = np.sort(rng.choice(region_labels, size=self.max_regions, replace=False))
            region_counts = region_counts[region_labels]
        region_weights = region_counts.astype(np.float64) / region_counts.sum()
        region_idx = [np.flatnonzero(assignments == k) for k in region_labels]

        sample_features = self.features(samples, stats)
        data_features = self.features(data, stats)
        n, m, K = samples.n_samples, data.n_samples, len(region_labels)
        if self.solver == "sinkhorn":
            D = self._sinkhorn_costs(sample_features, data_features, region_idx)
        else:
            D = self._exact_costs(sample_features.cpu().numpy(), data_features.cpu().numpy(), region_idx, n, m)
        D = np.sqrt(np.einsum("ijk,k->ij", D, region_weights))
        return {"wasserstein": wasserstein2(D)}

    def _exact_costs(self, sample_features, data_features, region_idx, n, m) -> np.ndarray:
        """(n, m, K) exact squared-distance transport costs: one task per
        (region, sample), an (m, R, R) block of distances each, at most two
        per worker in flight, so memory stays O(workers * m * R^2)."""

        def dist_block(k: int, i: int) -> np.ndarray:
            s_region = sample_features[i, region_idx[k]]  # (R, F)
            d_region = data_features[:, region_idx[k]]  # (m, R, F)
            return np.linalg.norm(s_region[None, :, None, :] - d_region[:, None, :, :], axis=-1)

        blocks = [(k, i) for k in range(len(region_idx)) for i in range(n)]
        D = np.zeros((n, m, len(region_idx)))
        n_workers = self.max_workers if self.max_workers is not None else min(32, os.cpu_count() or 1)
        if n_workers <= 1 or len(blocks) <= 1:
            for k, i in blocks:
                D[i, :, k] = emd2_sq_rows(dist_block(k, i))
            return D
        in_flight: deque = deque()
        context = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=n_workers, mp_context=context) as pool:
            for k, i in blocks:
                in_flight.append((k, i, pool.submit(emd2_sq_rows, dist_block(k, i))))
                if len(in_flight) >= 2 * n_workers:
                    k0, i0, fut = in_flight.popleft()
                    D[i0, :, k0] = fut.result()
            while in_flight:
                k0, i0, fut = in_flight.popleft()
                D[i0, :, k0] = fut.result()
        return D

    def _sinkhorn_costs(self, sample_features, data_features, region_idx) -> np.ndarray:
        """(n, m, K) entropic costs: every region's cloud padded to the
        largest, all (region, sample, frame) transports in chunks of regions
        that keep the (n, chunk, m, R, R) cost tensor near 2^25 elements."""
        n, m, K = sample_features.shape[0], data_features.shape[0], len(region_idx)
        R_max = max(len(ix) for ix in region_idx)
        pad_idx = np.zeros((K, R_max), np.int64)
        mask = np.zeros((K, R_max), bool)
        for k, ix in enumerate(region_idx):
            pad_idx[k, : len(ix)] = ix
            mask[k, : len(ix)] = True
        device = sample_features.device
        pad_idx, mask = torch.as_tensor(pad_idx, device=device), torch.as_tensor(mask, device=device)
        s_pad = sample_features[:, pad_idx]  # (n, K, R_max, F)
        d_pad = data_features[:, pad_idx]  # (m, K, R_max, F)
        chunk = max(1, int(2**25 // (n * m * R_max * R_max)))
        solve = functools.partial(_masked_region_costs, reg=self.sinkhorn_reg, n_iters=self.sinkhorn_iters)
        D = np.zeros((n, m, K))
        for k0 in range(0, K, chunk):
            k1 = min(K, k0 + chunk)
            out = solve(s_pad[:, k0:k1], d_pad[:, k0:k1], mask[k0:k1])  # (n, kc, m)
            D[:, :, k0:k1] = out.double().cpu().numpy().transpose(0, 2, 1)
        return D

    def features(self, data: CaseData, stats: FieldStats) -> torch.Tensor:
        """Per-cell normalized (u, vorticity, p) features, (B, n_cells, 7), on
        the metric's device."""
        on = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        vort = curl(_embed_u(data, self.device), data.metadata.h)  # (B, X-2, Y-2, Z-2, 3)
        B = vort.shape[0]
        vort_cells = vort.reshape(B, -1, 3)[:, on(data.metadata.unpadded_cell_idx).long()]
        features = torch.cat([on(data.fields[Variable.U]), vort_cells, on(data.fields[Variable.P])], dim=-1)
        _, std = stats.normalizers(
            (Variable.U, Variable.CURL, Variable.P), mode="u:norm-std;curl:norm-std;p:mean-std"
        )
        return features / on(std)


class MaxMeanTKEPositionMetric:
    # Where the samples do not fluctuate the profile is 0 in exact
    # arithmetic; in float32 each fluctuation is then at most the rounding of
    # the mean over B samples, about B ulps of the velocity, so the profile
    # stays below (B * eps)^2 times the samples' mean square.
    ROUNDING = float(np.finfo(np.float32).eps)

    def __init__(self, device="cuda"):
        self.device = device

    def is_expensive(self) -> bool:
        return False

    @torch.no_grad()
    def __call__(self, samples: CaseData, data: CaseData, stats: FieldStats) -> Dict[str, float]:
        gt_path = data.metadata.file.parent / "max-mean-tke.npy"
        if not gt_path.is_file():
            return {}
        gt = float(np.load(gt_path))

        u_sample = _embed_u(samples, self.device)
        # Mean-flow estimation is part of the task: estimate from samples.
        u_fluc = u_sample - u_sample.mean(dim=0)
        x_cut = min(24, u_sample.shape[1] - 1)
        tke = 0.5 * (u_fluc[:, x_cut:] ** 2).sum(dim=-1)
        profile = tke.mean(dim=(-1, -2))  # (B, X')
        if float(profile.max()) <= (len(u_sample) * self.ROUNDING) ** 2 * float((u_sample**2).mean()):
            return {"max-mean-tke-pos": math.nan}  # undefined: the argmax of rounding noise
        estimate = float(profile.argmax(dim=1).double().mean()) + x_cut
        return {"max-mean-tke-pos": (gt - estimate) ** 2}


# Metrics that are undefined (NaN) on some sample sets by design: a case
# where one is undefined is left out of its mean over the cases.
UNDEFINED_ON_SOME_CASES = ("max-mean-tke-pos",)


class SampleMetricsCollection:
    def __init__(self, prefix: str, data_dir: Path, metrics: Sequence):
        self.prefix = prefix
        self.data_dir = Path(data_dir)
        self.metrics = list(metrics)

    @staticmethod
    def default_metrics(wasserstein_solver: str = "exact", device="cuda") -> List:
        return [
            WassersteinTKE(device=device),
            WassersteinMetric(solver=wasserstein_solver, device=device),
            MaxMeanTKEPositionMetric(device=device),
        ]

    def compute(
        self, sample_store: SampleStore, stats: FieldStats, *, expensive_metrics: bool = True
    ) -> Dict[str, float]:
        # The per-case loop does not raise before the ranks' per-case dicts
        # are merged: a rank that raised there while the others merged would
        # leave them waiting.  A failure travels through the merge as an
        # ``__error__`` entry, and every rank raises after it.
        per_case: Dict[str, Dict[str, float]] = {}
        failure: Optional[Exception] = None
        try:
            for case_name in sample_store.case_names:
                data_file = case_file(self.data_dir / case_name)
                if data_file is None:
                    raise FileNotFoundError(f"no data.npyd or data.h5 in {self.data_dir / case_name}")
                repo = CaseRepository([data_file], sample_store.variables)
                samples = sample_store.load_samples(repo.read_metadata(0))
                if samples.n_samples == 0:
                    continue

                # GT frames evenly spaced over the 2nd half of the simulation.
                n_data = len(repo.times[0])
                data_idx = np.round(np.linspace(n_data // 2, n_data - 1, num=samples.n_samples)).astype(int)
                data = repo.read(0, data_idx)

                case_values: Dict[str, float] = {}
                for metric in self.metrics:
                    if not expensive_metrics and metric.is_expensive():
                        continue
                    for name, value in metric(samples, data, stats).items():
                        case_values[name] = float(value)
                per_case[case_name] = case_values
        except Exception as e:
            failure = e
            per_case["__error__"] = {"rank_error": 1.0}

        # Each rank evaluated its shard of the cases (its own store file):
        # every rank ends with the metrics of all cases, so early stopping and
        # the best checkpoint are decided alike.  Where the ranks' cases
        # overlap (evaluation without shard_eval), rank 0's values win.
        merged: Dict[str, Dict[str, float]] = {}
        other_failed = False
        for rank_cases in allgather_objects(per_case):
            for case_name, case_values in rank_cases.items():
                if case_name == "__error__":
                    other_failed = True
                    continue
                merged.setdefault(case_name, case_values)
        if failure is not None:
            raise RuntimeError(f"sample-metric computation failed: {type(failure).__name__}: {failure}") from failure
        if other_failed:
            raise RuntimeError("sample-metric computation failed on another rank (see that rank's log)")

        values: Dict[str, float] = {}
        metric_names = set()
        for case_name, case_values in merged.items():
            for name, value in case_values.items():
                values[self.log_name(case_name, name)] = value
                metric_names.add(name)
        for name in metric_names:
            case_values_list = [
                values[self.log_name(c, name)] for c in sorted(merged) if self.log_name(c, name) in values
            ]
            if name in UNDEFINED_ON_SOME_CASES:
                case_values_list = [v for v in case_values_list if not math.isnan(v)]
            values[f"{self.prefix}/{name}"] = float(np.mean(case_values_list)) if case_values_list else math.nan
        return values

    def log_name(self, case: str, metric: str) -> str:
        return f"{self.prefix}/{case}/{metric}"
