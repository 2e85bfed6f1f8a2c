"""Per-process sharding samplers, including the elastic variant.

The port's copy of the JAX package's ``data/sampler.py`` (Horovod's
torch/elastic/sampler.py ElasticSampler — shard indices across ranks,
record progress, repartition remaining work after an elastic reset —
plus a plain DistributedSampler).  Built on the framework topology
(``hvd.rank()`` / ``hvd.size()``); the index streams are the
reference's for the same arguments, and feed any loader (a
``torch.utils.data.DataLoader(sampler=...)``, an indexed tensor, ...).
"""

from __future__ import annotations

import math
import random
from typing import Dict, Iterator, List, Optional

__all__ = ["DistributedSampler", "ElasticSampler", "shard_batch_indices"]


def _topo_rank_size(rank: Optional[int], size: Optional[int]):
    if rank is not None and size is not None:
        return rank, size
    from ..common import basics

    return basics.rank(), basics.size()


class DistributedSampler:
    """Deterministic per-rank shard of ``range(num_samples)``.

    Same contract as torch's DistributedSampler (shuffle per epoch with
    common seed; pad to a multiple of world size so every rank yields the
    same count — collective-safe)."""

    def __init__(self, num_samples: int, shuffle: bool = True, seed: int = 0,
                 rank: Optional[int] = None, size: Optional[int] = None,
                 drop_last: bool = False):
        self.num_samples_total = int(num_samples)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self._rank, self._size = _topo_rank_size(rank, size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> List[int]:
        idx = list(range(self.num_samples_total))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        if self.drop_last:
            total = (len(idx) // self._size) * self._size
            idx = idx[:total]
        else:
            total = int(math.ceil(len(idx) / self._size)) * self._size
            idx += idx[: total - len(idx)]
        return idx[self._rank:len(idx):self._size]

    def __iter__(self) -> Iterator[int]:
        return iter(self._indices())

    def __len__(self) -> int:
        if self.drop_last:
            return self.num_samples_total // self._size
        return int(math.ceil(self.num_samples_total / self._size))


class ElasticSampler:
    """Progress-tracking sampler that repartitions remaining work after an
    elastic reset (ref: torch/elastic/sampler.py:24-122, same API:
    set_epoch / record_batch / state_dict / load_state_dict / reset).

    Register it on the elastic ``State``; after a re-rendezvous the state
    machinery calls ``load_state_dict`` (or ``reset``) and the unprocessed
    tail of the epoch is re-split over the *new* world size.
    """

    def __init__(self, num_samples: int, shuffle: bool = True, seed: int = 0,
                 rank: Optional[int] = None, size: Optional[int] = None):
        self.dataset_size = int(num_samples)
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.processed_num = 0
        self.batch_idx = 0
        self._rank_override = rank
        self._size_override = size
        self.reset()

    def set_epoch(self, epoch: int) -> None:
        """Advance the epoch and clear progress.  Call at the END of each
        epoch so a partially completed epoch is not reprocessed (ref
        docstring sampler.py:60-69)."""
        self.epoch = epoch
        self.processed_num = 0
        self.batch_idx = 0
        self.reset()

    def record_batch(self, batch_idx: int, batch_size: int) -> None:
        """Record one processed global batch (all replicas advance)."""
        self.processed_num += batch_size * self.num_replicas
        self.batch_idx = int(batch_idx) + 1

    def cursor(self) -> Dict[str, int]:
        """The ``(epoch, batch_idx)`` resume cursor that rides inside
        every checkpoint / peer snapshot: ``batch_idx`` is the next
        UNprocessed batch of ``epoch``, the position
        ``BaseDataLoader.seek`` fast-forwards to so recovery replays
        zero already-committed batches."""
        return {"epoch": self.epoch, "batch_idx": self.batch_idx}

    def state_dict(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "processed_num": self.processed_num,
                "batch_idx": self.batch_idx}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.epoch = int(state["epoch"])
        self.processed_num = int(state["processed_num"])
        # Pre-cursor checkpoints (PR <= 10) carry no batch_idx: resume
        # conservatively at 0 rather than refusing the state.
        self.batch_idx = int(state.get("batch_idx", 0))
        self.reset()

    def reset(self) -> None:
        """Re-read topology and repartition the remaining indices."""
        self.rank, self.num_replicas = _topo_rank_size(
            self._rank_override, self._size_override)
        all_indices = list(range(self.dataset_size))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(all_indices)
        self.remaining_indices = all_indices[self.processed_num:]
        self.num_samples = int(
            math.ceil(len(self.remaining_indices) / max(self.num_replicas, 1)))
        self.total_size = self.num_samples * self.num_replicas

    def __iter__(self) -> Iterator[int]:
        indices = self.remaining_indices[:]
        indices += indices[: self.total_size - len(indices)]  # pad evenly
        return iter(indices[self.rank:self.total_size:self.num_replicas])

    def __len__(self) -> int:
        return self.num_samples


def shard_batch_indices(global_batch: int, rank: Optional[int] = None,
                        size: Optional[int] = None) -> slice:
    """Slice of a global batch owned by this process (equal split; global
    batch must divide by world size — the jit-path constraint)."""
    r, s = _topo_rank_size(rank, size)
    if global_batch % s:
        raise ValueError(
            f"global batch {global_batch} not divisible by world size {s}")
    per = global_batch // s
    return slice(r * per, (r + 1) * per)
