"""Datasets, geometry-pure batch samplers and the input pipeline.

Port of ``generative_turbulence_tpu/data/dataset.py``.  A batch never mixes
geometries, because the dense grid and its index maps are per case.  The
train sampler shuffles frames within each case, chunks them into batches and
shuffles the batch order, with the JAX package's draws from
``np.random.default_rng((seed, epoch))``; the evaluation sampler takes
``samples_per_file`` evenly spaced frames per case.  ``prefetch`` runs the
reads and the collation in a host thread, and with ``DataModule(device=...)``
also the copy of each batch to the device (``Batch.to``: pinned host memory,
``non_blocking``), so that it overlaps the consumer's step.

Training batches carry the values and the order the JAX package's give,
not its residency.  With ``transfer_dtype="bfloat16"`` (implied by
``device_cache_gb > 0``, as every paper recipe sets it) every training
batch's raw frames reach the device rounded to bf16, as JAX's device frame
cache and its bf16 transfer give them; the task embeds them in bf16 and
normalises them as XLA compiles JAX's step (``Normalizer.normalize_frames``).
A training batch's frames come sorted, as JAX's pooled collation and its
frame cache (both on in its default settings and every recipe) read them;
a batch with a repeated frame keeps the sampler's order, as JAX's copying
collation does.  Validation and test batches stay float32.  Left out, as
workarounds for the TPU host link and XLA recompiles: the device-resident
frames themselves, the cell bucket (the padding of the cells and index
tables), the pooled host buffers (``buffer_pool``) and the streamed
batches' f32 read without ``device_prefetch``.

Multi-process runs shard by the rank's dp index and the number of dp groups
(``parallel.mesh``: ``(rank, world)`` of ``torch.distributed`` without a
spatial axis; the sp ranks of one group read the same rows and cases): every
dp group then draws the same global train batches and reads only its own
rows of each (``parallel.mesh.local_rows``; the order is decided on the
global batch), or, with ``shard_by_host``, its own cases at the full batch,
all ranks taking as many batches as the shortest shard holds.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import queue
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.distributed import reduce_host_value
from ..parallel.mesh import dp_rank_and_size, local_rows
from .grid import GridMap
from .schema import CaseMetadata, CaseRepository, FieldStats, find_data_files
from .variables import Variable

TRANSFER_DTYPES = (None, "float32", "bfloat16")


def pinned_device(device):
    """``device``, a bare ``cuda`` made the calling thread's current card:
    the prefetch thread, where batches move to the device, has a current
    card of its own (card 0)."""
    if device is not None and torch.device(device) == torch.device("cuda"):
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass
class CaseData:
    """A set of frames from ONE case: metadata + times + per-variable cell data.

    fields: {Variable: (B, n_cells, dims) float32 numpy}
    """

    metadata: CaseMetadata
    t: np.ndarray
    fields: Dict[Variable, np.ndarray]

    @property
    def n_samples(self) -> int:
        return next(iter(self.fields.values())).shape[0]

    @property
    def variables(self) -> Tuple[Variable, ...]:
        return tuple(self.fields.keys())

    def stacked_cells(self, variables: Sequence[Variable]) -> np.ndarray:
        """(B, n_cells, F) channel-stacked cell values."""
        return np.concatenate([self.fields[v] for v in variables], axis=-1)


@dataclasses.dataclass
class Batch:
    """What a task step receives: cell values + the case's grid map + stats.

    ``cells`` is a host numpy array (a CPU bf16 tensor where the training
    frames are rounded to bf16) and ``grid`` lives on the CPU as the
    collation makes them; ``to(device)`` gives the batch on a device."""

    cells: np.ndarray | torch.Tensor  # (B, n_cells, F) stacked in variable order
    t: np.ndarray  # (B,) simulation times
    grid: GridMap
    metadata: CaseMetadata
    stats: FieldStats
    variables: Tuple[Variable, ...]

    @property
    def batch_size(self) -> int:
        return self.cells.shape[0]

    def to(self, device) -> "Batch":
        """The batch with ``cells`` a tensor on ``device`` (copied from pinned
        host memory without blocking the host, for a CUDA device) and the
        ``GridMap`` built there.  Returns ``self`` when both are there."""
        device = torch.device(device)
        on_device = lambda t: isinstance(t, torch.Tensor) and t.device.type == device.type  # noqa: E731
        if on_device(self.cells) and on_device(self.grid.cell_idx):
            return self
        cells = torch.as_tensor(self.cells)
        if device.type == "cuda":
            cells = cells.pin_memory()
        return dataclasses.replace(
            self,
            cells=cells.to(device, non_blocking=True),
            grid=GridMap.from_metadata(self.metadata, self.variables, device=device),
        )


class CaseDataset:
    """Map-style dataset over the concatenated valid frames of all cases.

    ``discard_first_seconds`` drops the laminar ramp-up.  ``__getitem__`` takes
    a list of frame indices that must all land in one case.
    """

    def __init__(self, repo: CaseRepository, stats: FieldStats, discard_first_seconds: float = -1.0):
        self.repo = repo
        self.stats = stats
        self.discard_first_seconds = discard_first_seconds
        self.reset_caches()

    def reset_caches(self) -> None:
        self.repo.reset_caches()
        self.valid_steps = [
            np.nonzero(times > self.discard_first_seconds)[0] for times in self.repo.times
        ]

    def sample_idxs_by_file(self) -> List[List[int]]:
        out, i = [], 0
        for steps in self.valid_steps:
            out.append(list(range(i, i + len(steps))))
            i += len(steps)
        return out

    def __len__(self) -> int:
        return sum(len(v) for v in self.valid_steps)

    def locate(self, index: np.ndarray) -> Tuple[int, np.ndarray]:
        """Map global frame indices to (file_idx, local indices)."""
        index = np.asarray(index)
        file_idx = 0
        while index.min() >= len(self.valid_steps[file_idx]):
            index = index - len(self.valid_steps[file_idx])
            file_idx += 1
        if index.max() >= len(self.valid_steps[file_idx]):
            raise ValueError("All samples in a batch must come from the same geometry")
        return file_idx, index

    def __getitem__(self, index) -> CaseData:
        if isinstance(index, (int, np.integer)):
            index = [index]
        file_idx, local = self.locate(np.asarray(index))
        frame_idxs = [int(self.valid_steps[file_idx][i]) for i in local]
        return self.repo.read(file_idx, frame_idxs)

    def get_times(self, file_idx: int, times: Sequence[float]) -> CaseData:
        """Exact-time lookup (tenth-of-millisecond comparison)."""
        t = np.round(self.repo.times[file_idx] * 10_000).astype(int).tolist()
        idxs = [t.index(round(t_ * 10_000)) for t_ in times]
        return self.repo.read(file_idx, idxs)


class GeometryPureBatches:
    """Train batch sampler: shuffle within each case, never mix cases.

    ``pad_to_full`` tops up each case's ragged last chunk with extra random
    frames from the same case, so every batch has the same shape.
    """

    def __init__(
        self,
        dataset: CaseDataset,
        *,
        batch_size: int,
        shuffle: bool,
        seed: int = 0,
        epoch: int = 0,
        pad_to_full: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.epoch = epoch
        self.seed = seed
        self.pad_to_full = pad_to_full

    def __len__(self) -> int:
        return sum(math.ceil(len(steps) / self.batch_size) for steps in self.dataset.valid_steps)

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.default_rng((self.seed, self.epoch))
        self.epoch += 1
        batches: List[List[int]] = []
        for idxs in self.dataset.sample_idxs_by_file():
            if self.shuffle:
                rng.shuffle(idxs)
            for i in range(0, len(idxs), self.batch_size):
                chunk = idxs[i : i + self.batch_size]
                short = self.batch_size - len(chunk)
                if short > 0 and self.pad_to_full:
                    pool = [j for j in idxs if j not in chunk] or idxs
                    extra = rng.choice(pool, size=short, replace=len(pool) < short)
                    chunk = chunk + [int(j) for j in extra]
                batches.append(chunk)
        if self.shuffle:
            rng.shuffle(batches)
        yield from batches


class EvaluationBatches:
    """Eval sampler: ``samples_per_file`` evenly spaced frames per case.

    ``shard=(rank, world)`` keeps the cases with ``case_idx % world == rank``:
    distributed evaluation splits whole cases over processes.
    """

    def __init__(
        self,
        dataset: CaseDataset,
        *,
        batch_size: int,
        samples_per_file: int,
        shard: Tuple[int, int] = (0, 1),
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.samples_per_file = samples_per_file
        self.shard = tuple(shard)

    def __len__(self) -> int:
        per_case = math.ceil(self.samples_per_file / self.batch_size)
        rank, world = self.shard
        return len(range(rank, self.dataset.repo.n_cases, world)) * per_case

    def __iter__(self) -> Iterator[List[int]]:
        rank, world = self.shard
        for case_idx, idxs in enumerate(self.dataset.sample_idxs_by_file()):
            if case_idx % world != rank or not idxs:  # not ours, or every frame discarded
                continue
            picks = np.round(np.linspace(0, len(idxs) - 1, num=self.samples_per_file)).astype(int)
            chosen = [idxs[i] for i in picks]
            for i in range(0, len(chosen), self.batch_size):
                yield chosen[i : i + self.batch_size]


def shard_files_by_host(files: List[Path], enabled: bool) -> List[Path]:
    """Round-robin the case files over the dp groups of a multi-process run
    (whole cases per group; a group left without one wraps around)."""
    rank, world = dp_rank_and_size()
    if not enabled or world <= 1:
        return files
    return files[rank::world] or [files[rank % len(files)]]


def train_order(idxs: List[int]) -> List[int]:
    """A global train batch's frames in the order the JAX package's pipeline
    gives them: sorted, as its pooled collation and its frame cache read
    them, unless a frame repeats (a top-up batch), which both refuse."""
    return idxs if len(set(idxs)) < len(idxs) else sorted(idxs)


def check_transfer_dtype(transfer_dtype: Optional[str], device_cache_gb: float) -> Optional[str]:
    """``transfer_dtype`` as the JAX ``DataModule`` resolves it: bf16 when a
    device cache is asked for and none is named; None or "bfloat16"."""
    if transfer_dtype is None and device_cache_gb > 0:
        transfer_dtype = "bfloat16"
    if transfer_dtype not in TRANSFER_DTYPES:
        raise ValueError(f"transfer_dtype must be bfloat16/float32, got {transfer_dtype}")
    return None if transfer_dtype == "float32" else transfer_dtype


def cast_cells(cells: np.ndarray, dtype: Optional[str]) -> np.ndarray | torch.Tensor:
    """The f32 cells as they reach the device: as they are, or rounded to
    bf16 (a CPU tensor, round to nearest even, as the JAX cast)."""
    if dtype is None:
        return cells
    return torch.from_numpy(np.ascontiguousarray(cells)).to(getattr(torch, dtype))


def collate(data: CaseData, stats: FieldStats, variables: Sequence[Variable], dtype: Optional[str] = None) -> Batch:
    variables = tuple(variables)
    return Batch(
        cells=cast_cells(data.stacked_cells(variables), dtype),
        t=np.asarray(data.t),
        grid=GridMap.from_metadata(data.metadata, variables, device="cpu"),
        metadata=data.metadata,
        stats=stats,
        variables=variables,
    )


def prefetch(iterator: Iterator, size: int = 2, transform=None) -> Iterator:
    """Run ``iterator`` in a host thread, keeping ``size`` items ready;
    ``transform`` runs in that thread on each item.  An exception in the
    thread is raised on the consumer's side."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    err: List[BaseException] = []

    def producer():
        try:
            for item in iterator:
                q.put(transform(item) if transform is not None else item)
        except BaseException as e:  # surfaced on the consumer side
            err.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item


class DataModule:
    """Loads stats + per-split datasets from ``root/{train,val,test}/<case>/``
    (``data.npyd`` or ``data.h5`` per case, ``find_data_files``).

    ``device``: None yields host batches; a device moves each batch there in
    the prefetch thread.  In a ``torch.distributed`` run each rank keeps its
    rows of every global train batch of ``batch_size``; ``shard_by_host``
    instead splits the train cases over the ranks, each taking full batches
    of its own cases, and ``shard_eval`` splits the evaluation cases.
    ``device_cache_gb`` and ``transfer_dtype`` are the JAX module's: they
    decide the training frames' dtype as there (the module docstring), and
    nothing else.
    """

    def __init__(
        self,
        root: Path,
        discard_first_seconds: float = -1.0,
        batch_size: int = 1,
        eval_batch_size: int = 8,
        val_samples: int = 8,
        test_samples: int = 32,
        variables: Sequence[Variable] = (Variable.U, Variable.P),
        prefetch_size: int = 2,
        seed: int = 0,
        shard_by_host: bool = False,
        shard_eval: bool = False,
        device: Optional[str | torch.device] = None,
        device_cache_gb: float = 0.0,
        transfer_dtype: Optional[str] = None,
    ):
        self.root = Path(root)
        self.discard_first_seconds = discard_first_seconds
        self.batch_size = batch_size
        self.eval_batch_size = eval_batch_size
        self.val_samples = val_samples
        self.test_samples = test_samples
        self.variables = tuple(variables)
        self.prefetch_size = prefetch_size
        self.seed = seed
        self.shard_by_host = shard_by_host
        self.shard_eval = shard_eval
        self.device = pinned_device(device)
        self.transfer_dtype = check_transfer_dtype(transfer_dtype, device_cache_gb)

        self.stats: Optional[FieldStats] = None
        self.train_dataset: Optional[CaseDataset] = None
        self.val_dataset: Optional[CaseDataset] = None
        self.test_dataset: Optional[CaseDataset] = None
        self._n_train_batches: Optional[int] = None

    def setup(self, stage: str = "fit") -> "DataModule":
        if self.stats is None:
            self.stats = FieldStats.from_file(self.root / "stats.pickle")
        if stage == "fit" and self.train_dataset is None:
            self.train_dataset = self._dataset("train")
        if stage in ("fit", "validate") and self.val_dataset is None:
            self.val_dataset = self._dataset("val")
        if stage == "test" and self.test_dataset is None:
            self.test_dataset = self._dataset("test")
        return self

    def _dataset(self, phase: str) -> CaseDataset:
        files = find_data_files(self.root / phase)
        if not files:
            raise FileNotFoundError(f"No data.npyd or data.h5 under {self.root / phase}")
        files = shard_files_by_host(files, self.shard_by_host and phase == "train")
        return CaseDataset(
            CaseRepository(files, self.variables),
            stats=self.stats,
            discard_first_seconds=self.discard_first_seconds,
        )

    # Batch iterators --------------------------------------------------------

    def train_batches(self, epoch: int = 0) -> Iterator[Batch]:
        # The epoch seeds the shuffle (rng key = (seed, epoch)): each epoch
        # draws a fresh batch order, and a resumed run passing the same global
        # epoch replays the order of the run it resumes.
        sampler = GeometryPureBatches(
            self.train_dataset, batch_size=self.batch_size, shuffle=True, seed=self.seed, epoch=epoch
        )
        rank, world = dp_rank_and_size()
        if self.shard_by_host:
            # A rank that ran out of batches first would leave the others
            # waiting in the gradients' all-reduce.
            sampler = itertools.islice(sampler, self.n_train_batches())
        sampler = map(train_order, sampler)
        if world > 1 and not self.shard_by_host:
            sampler = (local_rows(idxs, rank, world) for idxs in sampler)
        return self._iterate(self.train_dataset, sampler, self.transfer_dtype)

    def n_train_batches(self) -> int:
        """Train batches per epoch; with ``shard_by_host``, the fewest any
        rank's shard holds (a collective on the first call)."""
        if self._n_train_batches is None:
            n = len(GeometryPureBatches(self.train_dataset, batch_size=self.batch_size, shuffle=True))
            if self.shard_by_host:
                n = int(reduce_host_value(n, "min"))
            self._n_train_batches = n
        return self._n_train_batches

    def _eval_shard(self) -> Tuple[int, int]:
        return dp_rank_and_size() if self.shard_eval else (0, 1)

    def first_val_case(self) -> Optional[str]:
        """Name of the case owning the globally-first val batch (from the
        unsharded case order, so exactly one rank yields it)."""
        for case_idx, idxs in enumerate(self.val_dataset.sample_idxs_by_file()):
            if idxs:
                return self.val_dataset.repo.files[case_idx].parent.name
        return None

    def val_batches(self) -> Iterator[Batch]:
        return self._eval_batches(self.val_dataset, self.val_samples)

    def test_batches(self) -> Iterator[Batch]:
        return self._eval_batches(self.test_dataset, self.test_samples)

    def _eval_batches(self, dataset: CaseDataset, samples_per_file: int) -> Iterator[Batch]:
        sampler = EvaluationBatches(
            dataset, batch_size=self.eval_batch_size, samples_per_file=samples_per_file,
            shard=self._eval_shard(),
        )
        return self._iterate(dataset, sampler)

    def _iterate(self, dataset: CaseDataset, sampler, dtype: Optional[str] = None) -> Iterator[Batch]:
        batches = (collate(dataset[idxs], self.stats, self.variables, dtype) for idxs in sampler)
        transform = None if self.device is None else (lambda batch: batch.to(self.device))
        return prefetch(batches, size=self.prefetch_size, transform=transform)
