"""Control-plane transports for eager negotiation.

The PyTorch counterpart of the JAX package's ``ops/control_plane.py``:
the same blocking, cycle-synchronous primitives (gather to rank 0,
broadcast from rank 0), less the JAX package's barrier, which nothing
calls (``hvd.barrier`` is a negotiated op).  Where the JAX package uses the JAX
coordination service's key-value store, the port uses the c10d store
the process group was made over (a ``TCPStore``), under the prefix
``hvdt/ctl``.

A local transport serves one-process runs (the negotiation degenerates,
but the queue, fusion and cache still run, so the eager semantics hold).
"""

from __future__ import annotations

import abc
import datetime
from typing import List, Optional

import torch.distributed as dist

from ..resilience import faults
from ..resilience.retry import Backoff, retry

__all__ = ["ControlPlane", "LocalControlPlane", "StoreControlPlane",
           "default_control_plane"]


class ControlPlane(abc.ABC):
    """Blocking, cycle-synchronous control collectives over process ranks."""

    @abc.abstractmethod
    def rank(self) -> int: ...

    @abc.abstractmethod
    def size(self) -> int: ...

    @abc.abstractmethod
    def gather(self, payload: str, cycle: int) -> Optional[List[str]]:
        """All ranks submit a payload; returns the rank-ordered list on rank
        0, None elsewhere."""

    @abc.abstractmethod
    def broadcast(self, payload: Optional[str], cycle: int) -> str:
        """Rank 0 provides payload; everyone returns it."""

    def shutdown(self) -> None:
        pass


class LocalControlPlane(ControlPlane):
    """Single-process control plane — trivial negotiation."""

    def rank(self) -> int:
        return 0

    def size(self) -> int:
        return 1

    def gather(self, payload: str, cycle: int) -> Optional[List[str]]:
        return [payload]

    def broadcast(self, payload: Optional[str], cycle: int) -> str:
        assert payload is not None
        return payload


class StoreControlPlane(ControlPlane):
    """Negotiation over a c10d store.

    Key scheme, under the prefix ``hvdt/ctl``: ``<cycle>/g<rank>`` for
    each rank's gather payload and ``<cycle>/resp`` for the response.
    Cycle counters advance in lockstep on every rank (every rank takes
    part in every cycle), so keys are unique.  Each rank deletes the key
    it wrote ``KEEP`` cycles earlier, once every rank has read it (a rank
    can run at most one cycle ahead of another), so a rank's store calls
    a cycle do not grow with the world: 4 on a rank other than 0, 6 on
    rank 0.  Every blocking read waits at most ``timeout_s``
    (``HVDT_CONTROL_PLANE_TIMEOUT_S``); a timeout raises, which fails
    the controller's cycle and every handle with
    ``HorovodInternalError``.

    ``round_trips`` counts the store calls this rank made, for the
    control plane's cost per cycle.
    """

    KEEP = 8

    def __init__(self, store: dist.Store, rank: int, size: int,
                 timeout_s: Optional[float] = None):
        if timeout_s is None:
            from ..common import config

            timeout_s = config.get_float("HVDT_CONTROL_PLANE_TIMEOUT_S")
        # A client of its own where the store can make one: a TCPStore
        # client serializes its calls, and this plane blocks in wait()
        # while the main thread's own store calls (a new_group's
        # rendezvous) must go through.
        clone = getattr(store, "clone", None)

        def connect():
            # The counterpart of the reference's ``tcp.connect`` fault
            # point (its socket-mesh bootstrap): a kv_drop@...:point=
            # tcp.connect plan makes a connect fail and be retried.
            inj = faults.get_injector()
            if inj is not None:
                inj.fire("tcp.connect", rank=rank)
            return clone() if clone else store

        client = retry(connect, deadline_s=timeout_s,
                       retry_on=(ConnectionError, OSError),
                       backoff=Backoff(first=0.2, cap=5.0,
                                       deadline_s=timeout_s),
                       describe="eager control-plane connect")
        self._store = dist.PrefixStore("hvdt/ctl", client)
        self._rank = rank
        self._size = size
        self._timeout = datetime.timedelta(seconds=timeout_s)
        self.round_trips = 0

    def rank(self) -> int:
        return self._rank

    def size(self) -> int:
        return self._size

    def _get(self, keys: List[str]) -> List[str]:
        self._store.wait(keys, self._timeout)
        self.round_trips += 2
        return [v.decode() for v in self._store.multi_get(keys)]

    def gather(self, payload: str, cycle: int) -> Optional[List[str]]:
        self._store.set(f"{cycle}/g{self._rank}", payload)
        self.round_trips += 1
        self._delete(f"{cycle - self.KEEP}/g{self._rank}", cycle)
        if self._rank != 0:
            return None
        return self._get([f"{cycle}/g{r}" for r in range(self._size)])

    def broadcast(self, payload: Optional[str], cycle: int) -> str:
        key = f"{cycle}/resp"
        if self._rank != 0:
            return self._get([key])[0]
        assert payload is not None
        self._store.set(key, payload)
        self.round_trips += 1
        self._delete(f"{cycle - self.KEEP}/resp", cycle)
        return payload

    def _delete(self, key: str, cycle: int) -> None:
        """Delete ``key``, written ``KEEP`` cycles before ``cycle``."""
        if cycle >= self.KEEP:
            self._store.delete_key(key)
            self.round_trips += 1


def default_control_plane() -> ControlPlane:
    """Pick the control plane for the current topology: the local one in a
    world of one, else the store ``init`` made the process group over."""
    from ..common import basics

    state = basics._global_state()
    topo = basics.topology()
    if topo.size > 1:
        return StoreControlPlane(state.store, topo.rank, topo.size)
    return LocalControlPlane()
