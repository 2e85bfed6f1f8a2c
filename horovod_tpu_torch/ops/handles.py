"""Async operation handles: an int handle per enqueued collective, done
when the controller marks it (a copy of the JAX package's
``ops/handles.py``).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from ..common.exceptions import HorovodInternalError
from ..common.types import Status

__all__ = ["HandleManager"]


class _Entry:
    __slots__ = ("event", "status", "result", "meta")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.status: Optional[Status] = None
        self.result: Any = None
        self.meta: Any = None


class HandleManager:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._next = 0
        self._entries: Dict[int, _Entry] = {}

    def allocate(self) -> int:
        with self._lock:
            h = self._next
            self._next += 1
            self._entries[h] = _Entry()
            return h

    def mark_done(self, handle: int, status: Status, result: Any = None) -> None:
        with self._lock:
            e = self._entries.get(handle)
        if e is None:
            return
        e.status = status
        e.result = result
        e.event.set()

    def set_meta(self, handle: int, meta: Any) -> None:
        """Attach framework-side metadata (the torch binding's in-place
        target) to a live handle.  It shares the entry's lifetime, so it
        is dropped with the entry at ``synchronize`` and never outlives
        the handle it describes."""
        with self._lock:
            e = self._entries.get(handle)
            if e is not None:
                e.meta = meta

    def take_meta(self, handle: int) -> Any:
        """Return and clear the handle's metadata (None if the handle is
        unknown, already resolved, or carries none)."""
        with self._lock:
            e = self._entries.get(handle)
            if e is None or e.meta is None:
                return None
            meta, e.meta = e.meta, None
            return meta

    def poll(self, handle: int) -> bool:
        """True if the operation completed (ref: mpi_ops.py:914 poll)."""
        with self._lock:
            e = self._entries.get(handle)
        if e is None:
            raise ValueError(f"Unknown handle {handle}")
        return e.event.is_set()

    def synchronize(self, handle: int, timeout: Optional[float] = None) -> Any:
        """Block until done, return the result or raise
        (ref: mpi_ops.py:930 synchronize)."""
        with self._lock:
            e = self._entries.get(handle)
        if e is None:
            raise ValueError(f"Unknown handle {handle}")
        if not e.event.wait(timeout):
            # Keep the entry: the collective may still complete and the
            # caller may retry synchronize()/poll() on the same handle.
            raise TimeoutError(f"Collective op (handle {handle}) timed out")
        with self._lock:
            self._entries.pop(handle, None)
        assert e.status is not None
        if not e.status.ok_p():
            raise HorovodInternalError(e.status.reason)
        return e.result

    def abort_all(self, reason: str) -> None:
        """Fail every outstanding handle (elastic teardown path)."""
        with self._lock:
            entries = list(self._entries.values())
        for e in entries:
            if not e.event.is_set():
                e.status = Status.aborted(reason)
                e.event.set()
