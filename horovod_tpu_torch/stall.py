"""Coordinator-side stall detection (a copy of the JAX package's
``stall.py``).

Warns when a tensor has been submitted on some-but-not-all ranks for
longer than the warning threshold, listing ready and missing ranks, and
logs an error past ``HVDT_STALL_SHUTDOWN_TIME_SECONDS`` (the escalation
ladder's abort rung is what fails a stalled op).  Host-side
logic divergence (a rank skipping a step) hangs the negotiation, and
this names the tensor and the missing ranks.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Set

from .common import config

__all__ = ["StallInspector"]

log = logging.getLogger(__name__)


class StallInspector:
    def __init__(self, world_size: int, escalator: Optional[object] = None):
        self.enabled = not config.get_bool("HVDT_STALL_CHECK_DISABLE")
        self.warn_s = config.get_int("HVDT_STALL_CHECK_TIME_SECONDS")
        self.shutdown_s = config.get_int("HVDT_STALL_SHUTDOWN_TIME_SECONDS")
        self.world_size = world_size
        # Optional policy ladder (resilience/escalation.Escalator): every
        # check() feeds it pending ages; its abort/reset rungs let the
        # consumer (the eager controller) unwedge a hung negotiation
        # instead of warning forever.
        self.escalator = escalator
        # tensor name -> (first_seen_ts, ranks that reported)
        self._pending: Dict[str, tuple] = {}
        self._warned: Set[str] = set()
        # Past the shutdown threshold (logged once a stall episode).
        self._shut: Set[str] = set()
        self._last_check = 0.0

    def record(self, name: str, rank: int) -> None:
        ts, ranks = self._pending.get(name, (time.monotonic(), set()))
        ranks.add(rank)
        self._pending[name] = (ts, ranks)

    def resolve(self, name: str) -> None:
        self._pending.pop(name, None)
        self._warned.discard(name)
        self._shut.discard(name)
        if self.escalator is not None:
            self.escalator.resolve(name)

    def check(self) -> List[str]:
        """Run the stall check; returns names of stalled tensors
        (ref: stall_inspector.cc:32-104).  Called from the controller's
        cycle loop on the coordinator rank."""
        if not self.enabled:
            return []
        now = time.monotonic()
        if now - self._last_check < 1.0:
            return []
        self._last_check = now
        stalled = []
        for name, (ts, ranks) in self._pending.items():
            age = now - ts
            if self.escalator is not None:
                self.escalator.observe(name, age)
            if age > self.warn_s and name not in self._warned:
                missing = sorted(set(range(self.world_size)) - ranks)
                log.warning(
                    "One or more tensors were submitted to be reduced/"
                    "gathered but were not ready on all ranks for %.0fs. "
                    "This may indicate diverged host-side control flow. "
                    "Stalled op: %s [ready ranks: %s] [missing ranks: %s]",
                    age, name, sorted(ranks), missing)
                self._warned.add(name)
                stalled.append(name)
            if self.shutdown_s and age > self.shutdown_s and \
                    name not in self._shut:
                log.error("Stalled tensor %s exceeded shutdown threshold "
                          "(%ds)", name, self.shutdown_s)
                self._shut.add(name)
        return stalled
