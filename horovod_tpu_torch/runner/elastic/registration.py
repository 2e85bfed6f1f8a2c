"""Worker state registry — the rendezvous barrier for elastic resets.

The port's copy of the JAX package's module (Horovod's
runner/elastic/registration.py:1-180
(WorkerStateRegistry): workers report READY (want a new rendezvous),
SUCCESS, or FAILURE; when every live worker has reported, the driver
fires the reset callback that re-keys the rendezvous.)
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Set

__all__ = ["WorkerStateRegistry", "READY", "SUCCESS", "FAILURE"]

READY = "READY"
SUCCESS = "SUCCESS"
FAILURE = "FAILURE"


class WorkerStateRegistry:
    def __init__(self, on_barrier: Callable[[Dict[str, Set[int]]], None],
                 reset_limit: Optional[int] = None):
        self._on_barrier = on_barrier
        self._reset_limit = reset_limit
        self._lock = threading.Lock()
        self._states: Dict[str, Set[int]] = {READY: set(), SUCCESS: set(),
                                             FAILURE: set()}
        self._size = 0
        self._reset_count = 0
        self._barrier_fired = False

    def reset(self, size: int) -> None:
        """Arm the barrier for a new worker generation of ``size`` ranks."""
        with self._lock:
            self._states = {READY: set(), SUCCESS: set(), FAILURE: set()}
            self._size = size
            self._barrier_fired = False

    @property
    def reset_count(self) -> int:
        with self._lock:
            return self._reset_count

    def reset_limit_reached(self) -> bool:
        with self._lock:
            return (self._reset_limit is not None
                    and self._reset_count >= self._reset_limit)

    def record_ready(self, rank: int) -> None:
        self._record(READY, rank)

    def record_success(self, rank: int) -> None:
        self._record(SUCCESS, rank)

    def record_failure(self, rank: int) -> None:
        self._record(FAILURE, rank)

    def count(self, state: str) -> int:
        with self._lock:
            return len(self._states[state])

    def _record(self, state: str, rank: int) -> None:
        fire = False
        with self._lock:
            for s in self._states.values():
                s.discard(rank)
            self._states[state].add(rank)
            reported = set().union(*self._states.values())
            if (self._size > 0 and len(reported) >= self._size
                    and not self._barrier_fired):
                self._barrier_fired = True
                if self._states[READY]:
                    self._reset_count += 1
                fire = True
            snapshot = {k: set(v) for k, v in self._states.items()}
        if fire:
            self._on_barrier(snapshot)
