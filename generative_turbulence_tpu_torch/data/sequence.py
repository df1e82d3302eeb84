"""Sequence datasets for the autoregressive baselines (TF-Net, DilResNet).

Port of ``generative_turbulence_tpu/data/sequence.py``.  Each item is a
window of ``sequence_length`` frames with ``stride`` between them; a batch
reads B*T frames from one case and reshapes them to (B, T, n_cells, F).  The
window starts, the per-epoch shuffle (``GeometryPureBatches`` with the rng
key (seed, epoch)) and the eval windows are the JAX module's, so the batches
are bit-equal to its own for the same seed and epoch.

Left out, as in ``data/dataset.py``: the cell bucket and the
device-resident window cache (``SequenceDeviceCache``), workarounds for the
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
    pinned_device,
    prefetch,
)
from .grid import GridMap
from .schema import CaseRepository, FieldStats, find_data_files
from .variables import Variable


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


def collate_sequence(data: CaseData, stats: FieldStats, variables: Sequence[Variable]) -> SequenceBatch:
    variables = tuple(variables)
    return SequenceBatch(
        cells=np.concatenate([data.fields[v] for v in variables], axis=-1),
        t=np.asarray(data.t),
        grid=GridMap.from_metadata(data.metadata, variables, device="cpu"),
        metadata=data.metadata,
        stats=stats,
        variables=variables,
    )


class SequenceDataModule:
    """Windows of ``seq_len`` frames for training and ``eval_seq_len`` for
    evaluation from ``root/{train,val,test}/<case>/``; ``device`` as in
    ``DataModule``."""

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
        return self._iterate(self.train_dataset, sampler)

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

    def _iterate(self, dataset: SequenceDataset, sampler) -> Iterator[SequenceBatch]:
        batches = (collate_sequence(dataset[idxs], self.stats, self.variables) for idxs in sampler)
        transform = None if self.device is None else (lambda batch: batch.to(self.device))
        return prefetch(batches, size=self.prefetch_size, transform=transform)
