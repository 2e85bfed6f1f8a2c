"""Stall escalation ladder: warn → abort collective → request elastic
reset (a copy of the JAX package's ``resilience/escalation.py``).

1. **warn** (``HVDT_STALL_CHECK_TIME_SECONDS``) — the stall inspector's
   log line.
2. **abort** (``HVDT_STALL_ABORT_TIME_SECONDS``) — the coordinator
   aborts the stalled negotiation: pending ranks get an error response
   and their ``synchronize()`` raises ``HorovodInternalError`` instead of
   hanging forever.  With ``HVDT_FLIGHT_RECORDER`` on, the rung first
   emits the cross-rank desync report (``telemetry/flight_recorder``).
3. **reset** (``HVDT_STALL_RESET_TIME_SECONDS``) — under the elastic
   launcher, additionally publish READY to the driver's registry so the
   whole generation is re-rendezvoused (:func:`request_elastic_reset`).

Each level fires at most once per stall episode per tensor
(``resolve()`` re-arms).  Levels set to 0 are disabled.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, List, Optional, Set

from ..common import config

__all__ = ["WARN", "ABORT", "RESET", "EscalationPolicy", "Escalator",
           "request_elastic_reset"]

log = logging.getLogger(__name__)

WARN, ABORT, RESET = 1, 2, 3
_LEVEL_NAMES = {WARN: "warn", ABORT: "abort", RESET: "reset"}


class EscalationPolicy:
    """Age thresholds (seconds) per ladder level; 0/None disables a
    level.  Monotonicity is enforced by clamping: an abort threshold
    below warn escalates straight through, never out of order."""

    def __init__(self, warn_s: float = 60.0, abort_s: float = 0.0,
                 reset_s: float = 0.0):
        self.warn_s = warn_s
        self.abort_s = max(abort_s, warn_s) if abort_s else 0.0
        self.reset_s = max(reset_s, self.abort_s or warn_s) if reset_s else 0.0

    @classmethod
    def from_env(cls) -> "EscalationPolicy":
        return cls(
            warn_s=config.get_int("HVDT_STALL_CHECK_TIME_SECONDS"),
            abort_s=config.get_int("HVDT_STALL_ABORT_TIME_SECONDS"),
            reset_s=config.get_int("HVDT_STALL_RESET_TIME_SECONDS"))

    def level_for(self, age_s: float) -> int:
        level = 0
        if age_s > self.warn_s:
            level = WARN
        if self.abort_s and age_s > self.abort_s:
            level = ABORT
        if self.reset_s and age_s > self.reset_s:
            level = RESET
        return level


class Escalator:
    """Tracks per-tensor stall level and fires each rung once.

    Thread-safe: ``observe`` runs on the controller's background thread,
    ``drain_aborts``/``reset_requested`` are read from the same cycle
    loop, but tests drive them from the foreground.  Aborts and resets
    are *queued* for the consumer (the controller drains them inside its
    cycle, where it can emit error responses safely).
    """

    def __init__(self, policy: Optional[EscalationPolicy] = None):
        self.policy = policy or EscalationPolicy.from_env()
        self._lock = threading.Lock()
        self._level: Dict[str, int] = {}
        self._pending_aborts: Set[str] = set()
        self._reset_pending = False

    def observe(self, name: str, age_s: float) -> int:
        """Feed one stalled tensor's age; fires every newly crossed rung
        in order.  Returns the current level."""
        target = self.policy.level_for(age_s)
        fired: List[int] = []
        with self._lock:
            current = self._level.get(name, 0)
            if target > current:
                fired = list(range(current + 1, target + 1))
                self._level[name] = target
                for lv in fired:
                    if lv == ABORT:
                        self._pending_aborts.add(name)
                    elif lv == RESET:
                        self._reset_pending = True
        for lv in fired:
            log.warning("stall escalation: %s -> %s (stalled %.0fs)",
                        name, _LEVEL_NAMES[lv], age_s)
            if lv == ABORT:
                _abort_forensics(name, age_s)
        return target

    def resolve(self, name: str) -> None:
        """The tensor completed (or was aborted) — re-arm its ladder."""
        with self._lock:
            self._level.pop(name, None)
            self._pending_aborts.discard(name)

    def drain_aborts(self) -> Set[str]:
        """Tensors whose negotiation the consumer must abort (cleared on
        read)."""
        with self._lock:
            out, self._pending_aborts = self._pending_aborts, set()
            return out

    def reset_requested(self) -> bool:
        """One-shot: True once per requested elastic reset."""
        with self._lock:
            out, self._reset_pending = self._reset_pending, False
            return out


def _abort_forensics(name: str, age_s: float) -> None:
    """Abort-rung forensics: when the flight recorder is on, gather every
    rank's recent collective sequence over the rendezvous KV and emit the
    structured desync report (telemetry/flight_recorder.py).  A no-op
    when the recorder is off; never raises — forensics must not worsen
    the failure being diagnosed."""
    try:
        from ..telemetry.flight_recorder import emit_desync_report

        emit_desync_report(stalled=name, age_s=age_s)
    except Exception as e:
        log.debug("stall-abort forensics failed: %r", e)


def request_elastic_reset(reason: str = "stall escalation") -> bool:
    """Ask the elastic driver for a re-rendezvous by publishing READY to
    its worker registry (the key ``/registry/<generation>/<rank>`` the
    driver polls, ``runner/elastic/driver.py`` ``_poll_worker_registry``;
    the reference's KV contract, byte for byte).  Best-effort: returns
    False outside elastic mode or when the KV is unreachable (the abort
    rung already unwedged the job; reset is an optimization)."""
    if "HVDT_RENDEZVOUS_ADDR" not in os.environ:
        return False
    try:
        from ..runner.http_kv import KVClient

        client = KVClient.from_env()
        gen = int(os.environ.get("HVDT_GENERATION", 0))
        rank = int(os.environ.get("HVDT_RANK", 0))
        client.put(f"/registry/{gen}/{rank}", b"READY")
        log.warning("requested elastic reset (%s)", reason)
        return True
    except (ConnectionError, OSError, KeyError, ValueError) as e:
        log.warning("elastic reset request failed: %r", e)
        return False
