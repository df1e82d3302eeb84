"""Diagnostic plots: mid-plane slices and TKE spectra.

Port of ``generative_turbulence_tpu/eval/plots.py``: per-variable y/z
mid-plane slice comparisons (sample vs ground truth, incl. derived variables
curl/enstrophy/divergence computed through the grid embedding) and per-case
log-log TKE spectrum overlays from the spectra cached by ``WassersteinTKE``,
written as PNGs under ``<out_dir>/plots/<phase>-<step>/``.

matplotlib is imported only inside the functions that draw.  Where it is
not installed, ``render_eval_plots`` says so in one line on stderr and
returns no paths.
"""

from __future__ import annotations

import importlib.util
import multiprocessing
import sys
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import List, Sequence

import numpy as np
import torch

from ..data.dataset import CaseData
from ..data.grid import GridMap, embed_cells
from ..data.schema import CaseRepository, case_file
from ..data.variables import Variable
from ..ops.stencils import curl, divergence, enstrophy

DERIVED = {Variable.CURL, Variable.ENSTROPHY, Variable.DIVERGENCE}


def _dense_field(data: CaseData, v: Variable) -> np.ndarray:
    """Dense (B, X, Y, Z, C) field for a primary or derived variable (on the
    CPU)."""
    primary = Variable.U if v in DERIVED else v
    grid = GridMap.from_metadata(data.metadata, (primary,), device="cpu")
    dense = embed_cells(torch.as_tensor(data.fields[primary]), grid)
    if v in DERIVED:
        h = data.metadata.h
        op = {Variable.CURL: curl, Variable.ENSTROPHY: enstrophy, Variable.DIVERGENCE: divergence}[v]
        dense = op(dense, h)
    return dense.numpy()


def _use_style():
    import matplotlib

    matplotlib.use("Agg")
    style = Path(__file__).parent / "turbulence.mplstyle"
    if style.is_file():
        import matplotlib.pyplot as plt

        plt.style.use(str(style))


def plot_slice(
    sample: CaseData,
    data: CaseData,
    variables: Sequence[Variable],
    out_file: Path,
    *,
    axis: str = "z",
):
    """Mid-plane slice grid: rows = variables (channel norms), cols = (sample,
    data).  Derived variables are trimmed near the outlet where the padding
    cells distort the stencil."""
    _use_style()
    import matplotlib.colors as mc
    import matplotlib.pyplot as plt

    n_vars = len(variables)
    fig, axes = plt.subplots(n_vars, 2, figsize=(10, 2.2 * n_vars), squeeze=False, constrained_layout=True)
    for row, v in enumerate(variables):
        fields = []
        for d in (sample, data):
            f = _dense_field(d, v)[0]  # first sample
            f = np.linalg.norm(f, axis=-1) if f.shape[-1] > 1 else f[..., 0]
            if v in DERIVED:
                f = f[:-1]  # cut the stencil-distorted outlet column
            mid = f.shape[2] // 2 if axis == "z" else f.shape[1] // 2
            sl = f[:, :, mid] if axis == "z" else f[:, mid, :]
            fields.append(sl.T)
        # Color scales anchor on the DATA panel: signed fields (p,
        # divergence) get a zero-centered diverging map, everything else a
        # sequential map on the data's range.
        data_sl = fields[-1]
        if v in (Variable.P, Variable.DIVERGENCE):
            norm = mc.CenteredNorm(vcenter=0, halfrange=np.abs(data_sl).max())
            cmap = "coolwarm"
        else:
            norm = mc.Normalize(vmin=data_sl.min(), vmax=data_sl.max())
            cmap = "cividis"
        for col, (name, sl) in enumerate(zip(("sample", "data"), fields)):
            ax = axes[row][col]
            im = ax.imshow(sl, origin="lower", norm=norm, cmap=cmap, interpolation="none", aspect="auto")
            ax.set_title(f"{v.key} ({name})", fontsize=9)
            ax.set_xticks([])
            ax.set_yticks([])
        fig.colorbar(im, ax=axes[row], shrink=0.8)
    out_file.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_file, dpi=110)
    plt.close(fig)
    return out_file


def plot_tke_spectrum(
    log_tke_sample: np.ndarray,
    log_tke_data: np.ndarray,
    k: np.ndarray,
    out_file: Path,
    *,
    title: str = "",
):
    """Log-log E(k) overlay: individual sample spectra vs data spectra."""
    _use_style()
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5, 4), constrained_layout=True)
    for i, spec in enumerate(np.exp(log_tke_data)):
        ax.loglog(k, spec, color="C0", alpha=0.4, label="data" if i == 0 else None)
    for i, spec in enumerate(np.exp(log_tke_sample)):
        ax.loglog(k, spec, color="C1", alpha=0.6, label="sample" if i == 0 else None)
    ax.set_xlabel("k")
    ax.set_ylabel("E(k)")
    ax.set_title(title, fontsize=10)
    ax.legend()
    out_file.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_file, dpi=110)
    plt.close(fig)
    return out_file


def _render_spectrum_job(args):
    log_a, log_b, k, out_file, title = args
    return plot_tke_spectrum(log_a, log_b, k, Path(out_file), title=title)


def render_eval_plots(out_dir, store, collection, variables, phase: str, step: int) -> List[Path]:
    """Render all diagnostics for one eval epoch: spectrum overlays from the
    WassersteinTKE cache + y/z slice comparisons of the first case."""
    from .metrics import WassersteinTKE

    if importlib.util.find_spec("matplotlib") is None:
        print("plots skipped: matplotlib is not installed", file=sys.stderr, flush=True)
        return []
    cb = PlotCallback(Path(out_dir))
    paths = []
    tke = next((m for m in collection.metrics if isinstance(m, WassersteinTKE)), None)
    if tke is not None:
        paths += cb.render_spectra(tke, phase, step)

    case_names = store.case_names
    if case_names:
        repo = CaseRepository([case_file(collection.data_dir / case_names[0])], store.variables)
        samples = store.load_samples(repo.read_metadata(0))
        if samples.n_samples > 0:
            data = repo.read(0, [len(repo.times[0]) - 1])
            paths += cb.render_slices(samples, data, variables, phase, step)
    return paths


class PlotCallback:
    """Render validation plots after each eval epoch (spectra in a pool of
    spawned processes when there are more than 2)."""

    def __init__(self, out_dir: Path, max_workers: int = 2):
        self.out_dir = Path(out_dir) / "plots"
        self.max_workers = max_workers

    def render_spectra(self, tke_metric, phase: str, step: int) -> List[Path]:
        """Render the spectra cached by a WassersteinTKE instance."""
        jobs = []
        for region, cases in tke_metric.case_data.items():
            for case, (log_a, log_b, k) in cases.items():
                out = self.out_dir / f"{phase}-{step}" / f"tke-{region}-{case}.png"
                jobs.append((log_a, log_b, k, str(out), f"{case} [{region}]"))
        if not jobs:
            return []
        if self.max_workers > 1 and len(jobs) > 2:
            ctx = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(max_workers=self.max_workers, mp_context=ctx) as pool:
                return list(pool.map(_render_spectrum_job, jobs))
        return [_render_spectrum_job(j) for j in jobs]

    def render_slices(
        self,
        sample: CaseData,
        data: CaseData,
        variables: Sequence[Variable],
        phase: str,
        step: int,
    ) -> List[Path]:
        outs = []
        for axis in ("y", "z"):
            out = self.out_dir / f"{phase}-{step}" / f"{data.metadata.case_name}-{axis}-slice.png"
            outs.append(plot_slice(sample, data, variables, out, axis=axis))
        return outs
