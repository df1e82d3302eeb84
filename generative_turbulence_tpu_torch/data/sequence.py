"""Sequence datasets for the autoregressive baselines (TF-Net, DilResNet).

Port of ``generative_turbulence_tpu/data/sequence.py``.  Each item is a
window of ``sequence_length`` frames with ``stride`` between them; a batch
reads B*T frames from one case and reshapes them to (B, T, n_cells, F).  The
window starts, the per-epoch shuffle (``GeometryPureBatches`` with the rng
key (seed, epoch)) and the eval windows are the JAX module's, so the batches
are bit-equal to its own for the same seed and epoch.

Training windows carry the values the JAX module's give, not its
residency.  With ``device_cache_gb > 0`` the windows of every case that the
JAX ``SequenceDeviceCache`` would hold (``WindowCacheCapacity``) reach the
device rounded to bf16, in the sampler's order; every case after the first
that does not fit stays float32, as it streams there.  The JAX module's
``eval_device_cache_gb`` changes no value (its eval caches are float32 and
equal to streaming) and is not taken.  Left out, as in ``data/dataset.py``:
the resident windows themselves and the bucket padding, workarounds for the
TPU host link and XLA recompiles.  With ``device`` set, each batch is moved
there in the prefetch thread (``Batch.to``).  In a ``torch.distributed`` run
each rank keeps its rows of every global train batch, as ``DataModule``
does.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from ..parallel.distributed import process_rank_and_world
from ..parallel.mesh import local_rows
from .dataset import (
    Batch,
    CaseData,
    CaseDataset,
    EvaluationBatches,
    GeometryPureBatches,
    cast_cells,
    pinned_device,
    prefetch,
)
from .grid import GridMap
from .npyd import open_case_file
from .schema import CaseRepository, FieldStats, find_data_files
from .variables import Variable, total_dims


@dataclasses.dataclass
class SequenceBatch(Batch):
    """cells has shape (B, T, n_cells, F)."""

    @property
    def seq_len(self) -> int:
        return self.cells.shape[1]


class SequenceDataset(CaseDataset):
    def __init__(
        self,
        repo: CaseRepository,
        stats: FieldStats,
        *,
        sequence_length: int = 8,
        stride: int = 1,
        discard_first_seconds: float = -1.0,
    ):
        if sequence_length < 1 or stride < 1:
            raise ValueError(f"sequence_length {sequence_length} and stride {stride} must be >= 1")
        self.sequence_length = sequence_length
        self.stride = stride
        super().__init__(repo, stats, discard_first_seconds)

    def reset_caches(self) -> None:
        self.repo.reset_caches()
        self.valid_steps = []
        for times in self.repo.times:
            idxs = np.nonzero(times > self.discard_first_seconds)[0]
            span = self.sequence_length * self.stride - 1
            if span > 0:
                idxs = idxs[:-span] if span < len(idxs) else idxs[:0]
            if len(idxs) and not np.all(np.diff(idxs) == 1):
                raise ValueError("Sequence windows require consecutive frames")
            self.valid_steps.append(idxs)

    def cache_steps(self, file_idx: int) -> np.ndarray:
        """Every frame a window of this case can reach, as the JAX window
        cache uploads them: from the first window's start through the last
        start + (T-1) x stride."""
        starts = self.valid_steps[file_idx]
        if len(starts) == 0:
            return np.asarray(starts)
        last = starts[-1] + (self.sequence_length - 1) * self.stride
        return np.arange(starts[0], last + 1)

    def __getitem__(self, index) -> CaseData:
        if isinstance(index, (int, np.integer)):
            index = [index]
        file_idx, local = self.locate(np.asarray(index))
        frame_idxs = [
            int(step)
            for idx in local
            for step in range(
                self.valid_steps[file_idx][idx],
                self.valid_steps[file_idx][idx] + self.sequence_length * self.stride,
                self.stride,
            )
        ]
        data = self.repo.read(file_idx, frame_idxs)
        T = self.sequence_length
        t = data.t.reshape(-1, T)
        fields = {v: arr.reshape(-1, T, *arr.shape[1:]) for v, arr in data.fields.items()}
        return CaseData(metadata=data.metadata, t=t, fields=fields)


class WindowCacheCapacity:
    """The capacity bookkeeping of the JAX package's training
    ``SequenceDeviceCache`` (``DeviceFrameCache._upload``), without the
    residency: which training cases it would hold.  A case is reckoned at its
    cached frames (``SequenceDataset.cache_steps``) x its cells padded up to
    ``cell_bucket`` x its channels x 2 bytes (bf16), when a batch of it first
    asks; the first case that does not fit fills the cache for good.  The JAX cache also stops where an
    upload runs out of device memory; that rule depends on the device and is
    not reproduced."""

    def __init__(self, capacity_bytes: int, cell_bucket: int):
        self.capacity = int(capacity_bytes)
        self.cell_bucket = cell_bucket
        self.used = 0
        self.full = False
        self.cases: set = set()

    def case_bytes(self, dataset: SequenceDataset, file_idx: int) -> int:
        variables = dataset.repo.variables
        with open_case_file(dataset.repo.files[file_idx]) as f:
            n = int(f["data"][variables[0].key].shape[1])
        nb = -(-n // self.cell_bucket) * self.cell_bucket if self.cell_bucket else n
        return len(dataset.cache_steps(file_idx)) * nb * total_dims(variables) * 2

    def holds(self, dataset: SequenceDataset, file_idx: int) -> bool:
        """Whether the cache holds case ``file_idx`` once a batch of it has
        asked (taking it in if it fits)."""
        if file_idx in self.cases:
            return True
        if self.full:
            return False
        nbytes = self.case_bytes(dataset, file_idx)
        if self.used + nbytes > self.capacity:
            self.full = True
            return False
        self.used += nbytes
        self.cases.add(file_idx)
        return True


def collate_sequence(data: CaseData, stats: FieldStats, variables: Sequence[Variable],
                     dtype: Optional[str] = None) -> SequenceBatch:
    variables = tuple(variables)
    return SequenceBatch(
        cells=cast_cells(np.concatenate([data.fields[v] for v in variables], axis=-1), dtype),
        t=np.asarray(data.t),
        grid=GridMap.from_metadata(data.metadata, variables, device="cpu"),
        metadata=data.metadata,
        stats=stats,
        variables=variables,
    )


class SequenceDataModule:
    """Windows of ``seq_len`` frames for training and ``eval_seq_len`` for
    evaluation from ``root/{train,val,test}/<case>/``; ``device`` as in
    ``DataModule``; ``cell_bucket`` and ``device_cache_gb`` decide which
    training windows are bf16, as in the JAX module (the module
    docstring)."""

    def __init__(
        self,
        root: Path,
        discard_first_seconds: float = -1.0,
        batch_size: int = 1,
        seq_len: int = 2,
        eval_batch_size: int = 8,
        eval_seq_len: int = 100,
        val_samples: int = 8,
        test_samples: int = 32,
        variables: Sequence[Variable] = (Variable.U, Variable.P),
        stride: int = 1,
        prefetch_size: int = 2,
        seed: int = 0,
        device: Optional[str | torch.device] = None,
        cell_bucket: int = 16384,
        device_cache_gb: float = 0.0,
    ):
        self.root = Path(root)
        self.discard_first_seconds = discard_first_seconds
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.eval_batch_size = eval_batch_size
        self.eval_seq_len = eval_seq_len
        self.val_samples = val_samples
        self.test_samples = test_samples
        self.variables = tuple(variables)
        self.stride = stride
        self.prefetch_size = prefetch_size
        self.seed = seed
        self.device = pinned_device(device)
        # The JAX module shards no evaluation cases (the Trainer asks).
        self.shard_eval = False
        self.train_cache = WindowCacheCapacity(int(device_cache_gb * 1e9), cell_bucket) if device_cache_gb > 0 else None

        self.stats: Optional[FieldStats] = None
        self.train_dataset: Optional[SequenceDataset] = None
        self.val_dataset: Optional[SequenceDataset] = None
        self.test_dataset: Optional[SequenceDataset] = None

    def setup(self, stage: str = "fit") -> "SequenceDataModule":
        if self.stats is None:
            self.stats = FieldStats.from_file(self.root / "stats.pickle")
        if stage == "fit" and self.train_dataset is None:
            self.train_dataset = self._dataset("train", self.seq_len)
        if stage in ("fit", "validate") and self.val_dataset is None:
            self.val_dataset = self._dataset("val", self.eval_seq_len)
        if stage == "test" and self.test_dataset is None:
            self.test_dataset = self._dataset("test", self.eval_seq_len)
        return self

    def _dataset(self, phase: str, seq_len: int) -> SequenceDataset:
        files = find_data_files(self.root / phase)
        if not files:
            raise FileNotFoundError(f"No data.npyd or data.h5 under {self.root / phase}")
        return SequenceDataset(
            CaseRepository(files, self.variables),
            stats=self.stats,
            sequence_length=seq_len,
            stride=self.stride,
            discard_first_seconds=self.discard_first_seconds,
        )

    def train_batches(self, epoch: int = 0) -> Iterator[SequenceBatch]:
        sampler = GeometryPureBatches(
            self.train_dataset, batch_size=self.batch_size, shuffle=True, seed=self.seed, epoch=epoch
        )
        rank, world = process_rank_and_world()
        if world > 1:
            sampler = (local_rows(idxs, rank, world) for idxs in sampler)
        return self._iterate(self.train_dataset, sampler, self.train_cache)

    def n_train_batches(self) -> int:
        return len(GeometryPureBatches(self.train_dataset, batch_size=self.batch_size, shuffle=True))

    def val_batches(self) -> Iterator[SequenceBatch]:
        sampler = EvaluationBatches(
            self.val_dataset, batch_size=self.eval_batch_size, samples_per_file=self.val_samples
        )
        return self._iterate(self.val_dataset, sampler)

    def test_batches(self) -> Iterator[SequenceBatch]:
        sampler = EvaluationBatches(
            self.test_dataset, batch_size=self.eval_batch_size, samples_per_file=self.test_samples
        )
        return self._iterate(self.test_dataset, sampler)

    def _iterate(self, dataset: SequenceDataset, sampler,
                 cache: Optional[WindowCacheCapacity] = None) -> Iterator[SequenceBatch]:
        def dtype(idxs):
            held = cache is not None and cache.holds(dataset, dataset.locate(np.asarray(idxs))[0])
            return "bfloat16" if held else None

        batches = (collate_sequence(dataset[idxs], self.stats, self.variables, dtype(idxs)) for idxs in sampler)
        transform = None if self.device is None else (lambda batch: batch.to(self.device))
        return prefetch(batches, size=self.prefetch_size, transform=transform)
