"""Process sets — sub-groups of ranks doing independent collectives.

The PyTorch counterpart of the JAX package's ``common/process_sets.py``:
a process set is a ``torch.distributed`` group over its ranks, and a
second group over the same ranks for the eager plane only
(``ops/eager.py``).  The eager controller issues its collectives from
its own thread; on a group of their own they can never interleave with
the main thread's collectives (``DistributedOptimizer``,
``broadcast_parameters``) in another order on another rank.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import torch.distributed as dist

from .exceptions import HorovodTpuError, NotInitializedError

__all__ = ["ProcessSet", "ProcessSetTable", "global_process_set",
           "add_process_set", "remove_process_set", "process_set_by_id"]


def _eager_group(ranks: List[int]) -> Optional[dist.ProcessGroup]:
    """The eager plane's group over ``ranks`` (None for a set of one,
    whose eager collectives are local).  ``dist.new_group`` is collective
    over the world: every process calls this in the same order."""
    return dist.new_group(ranks) if len(ranks) > 1 else None


class ProcessSet:
    """A set of global ranks, the process group over them (``None`` is
    the default group, i.e. the whole world) and the eager plane's group
    over them."""

    def __init__(self, ranks: Sequence[int], set_id: int, topo,
                 group: Optional[dist.ProcessGroup] = None,
                 eager_group: Optional[dist.ProcessGroup] = None):
        self.ranks: List[int] = sorted(set(int(r) for r in ranks))
        self.id = set_id
        self.group = group
        self.eager_group = eager_group
        self._topo = topo

    def included(self, global_rank: Optional[int] = None) -> bool:
        r = self._topo.rank if global_rank is None else global_rank
        return r in self.ranks

    def size(self) -> int:
        return len(self.ranks)

    def rank(self) -> int:
        """This process's rank within the set."""
        if not self.included():
            raise HorovodTpuError(
                f"Process {self._topo.rank} is not part of process set "
                f"{self.id}")
        return self.ranks.index(self._topo.rank)

    def global_rank(self, set_rank: int) -> int:
        """Global rank of the member at ``set_rank`` within the set."""
        return self.ranks[set_rank]

    def __repr__(self) -> str:
        return f"ProcessSet(id={self.id}, ranks={self.ranks})"


class ProcessSetTable:
    """id → ProcessSet registry."""

    GLOBAL_ID = 0

    def __init__(self, topo):
        self._lock = threading.RLock()
        self._topo = topo
        self._next_id = 1
        ranks = list(range(topo.size))
        self._sets: Dict[int, ProcessSet] = {
            self.GLOBAL_ID: ProcessSet(ranks, self.GLOBAL_ID, topo,
                                       eager_group=_eager_group(ranks))
        }

    def get(self, set_id: int) -> ProcessSet:
        # No lock: a dict lookup is atomic, and the eager controller's
        # thread looks sets up while add() holds the lock across the
        # collective dist.new_group, which waits for the other ranks.
        ps = self._sets.get(set_id)
        if ps is None:
            raise HorovodTpuError(f"Unknown process set id {set_id}")
        return ps

    def global_set(self) -> ProcessSet:
        return self.get(self.GLOBAL_ID)

    def add(self, ranks: Sequence[int]) -> ProcessSet:
        """Register a new process set.  Every process of the world must
        call this with identical rank lists, in the same order
        (``dist.new_group`` is collective over the whole world), so ids
        agree by construction."""
        ranks = sorted(set(int(r) for r in ranks))
        bad = [r for r in ranks if r < 0 or r >= self._topo.size]
        if bad:
            raise HorovodTpuError(f"Invalid ranks for process set: {bad}")
        with self._lock:
            for ps in self._sets.values():
                if ps.ranks == ranks:
                    return ps
            group = dist.new_group(ranks)
            ps = ProcessSet(ranks, self._next_id, self._topo, group,
                            _eager_group(ranks))
            self._sets[self._next_id] = ps
            self._next_id += 1
            return ps

    def remove(self, set_id: int) -> None:
        if set_id == self.GLOBAL_ID:
            raise HorovodTpuError("Cannot remove the global process set")
        with self._lock:
            self._sets.pop(set_id, None)


def _table() -> ProcessSetTable:
    from . import basics

    tbl = basics._global_state().process_set_table
    if tbl is None:
        raise NotInitializedError()
    return tbl


def global_process_set() -> ProcessSet:
    return _table().global_set()


def add_process_set(ranks: Sequence[int]) -> ProcessSet:
    return _table().add(ranks)


def remove_process_set(set_id: int) -> None:
    _table().remove(set_id)


def process_set_by_id(set_id: int) -> ProcessSet:
    return _table().get(set_id)
