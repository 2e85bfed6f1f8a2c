"""Shared retry/backoff primitive for every transient-failure path.

The port's copy of the JAX package's ``resilience/retry.py``.  One
policy object serves the rendezvous KV client (``runner/http_kv.py``),
the launcher's process-group termination (``runner/safe_shell_exec.py``)
and the eager control plane's connect (``ops/control_plane.py``).  The
shape follows Horovod's retry helpers (runner/util/network.py resource
retries and gloo's bounded connect loop) hardened with the two properties
production retries need:

* **exponential growth with a cap** — a flapping dependency is probed
  quickly at first, then at a bounded steady rate instead of hammering;
* **full jitter** — concurrent workers retrying the same dead endpoint
  decorrelate instead of synchronizing into retry storms (the classic
  AWS-architecture result; every rank backing off identically re-creates
  the thundering herd each period).

Determinism: tests pass ``rng=random.Random(seed)`` (or ``jitter=0``) so
schedules are reproducible under the fault injector.
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Optional, Tuple, Type

__all__ = ["Backoff", "retry", "RetriesExhausted"]


class RetriesExhausted(Exception):
    """Raised by :func:`retry` when attempts/deadline run out; chains the
    last underlying error as ``__cause__``."""


class Backoff:
    """Exponential backoff schedule with full jitter and an optional
    deadline.

    ::

        b = Backoff(first=0.05, cap=2.0, deadline_s=30.0)
        while not ready():
            if not b.sleep():
                raise TimeoutError(...)

    ``next_delay()`` returns the next delay without sleeping (for callers
    that wait on a condition variable instead of ``time.sleep``).
    ``sleep()`` sleeps it and returns False once the deadline would be
    exceeded (never overshooting: the final sleep is truncated to the
    remaining budget).
    """

    def __init__(self, first: float = 0.05, factor: float = 2.0,
                 cap: float = 2.0, jitter: float = 0.5,
                 deadline_s: Optional[float] = None,
                 rng: Optional[random.Random] = None,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic):
        if first <= 0 or factor < 1.0 or cap < first:
            raise ValueError("need first > 0, factor >= 1, cap >= first")
        self.first = first
        self.factor = factor
        self.cap = cap
        self.jitter = max(0.0, min(1.0, jitter))
        self._rng = rng or random
        self._sleep = sleep_fn
        self._clock = clock
        self._deadline = (clock() + deadline_s
                          if deadline_s is not None else None)
        self.attempts = 0

    def reset(self) -> None:
        """Back to the first-delay rung (the dependency answered — the
        next outage starts the probe ladder over)."""
        self.attempts = 0

    def remaining(self) -> Optional[float]:
        if self._deadline is None:
            return None
        return self._deadline - self._clock()

    def expired(self) -> bool:
        r = self.remaining()
        return r is not None and r <= 0

    def next_delay(self) -> float:
        base = min(self.cap, self.first * (self.factor ** self.attempts))
        self.attempts += 1
        if self.jitter:
            # Full jitter over [base*(1-jitter), base]: preserves the cap
            # while decorrelating concurrent retriers.
            base -= self._rng.uniform(0.0, self.jitter) * base
        return base

    def sleep(self) -> bool:
        """Sleep the next delay (truncated to the deadline).  Returns
        False — without sleeping — once the deadline has passed."""
        delay = self.next_delay()
        rem = self.remaining()
        if rem is not None:
            if rem <= 0:
                return False
            delay = min(delay, rem)
        self._sleep(delay)
        return True


def retry(fn: Callable[[], Any], *,
          attempts: Optional[int] = None,
          deadline_s: Optional[float] = None,
          retry_on: Tuple[Type[BaseException], ...] = (ConnectionError,
                                                       OSError),
          backoff: Optional[Backoff] = None,
          on_retry: Optional[Callable[[int, BaseException], None]] = None,
          describe: str = "") -> Any:
    """Call ``fn()`` until it succeeds, backing off between failures.

    Bounded by ``attempts`` (total calls) and/or ``deadline_s`` —
    unbounded retries are a production anti-pattern (they turn a dead
    dependency into a silent hang), so at least one bound is required.
    Exceptions not in ``retry_on`` propagate immediately (a 403 is not a
    flake).  Exhaustion raises :class:`RetriesExhausted` chaining the
    last error.
    """
    if attempts is None and deadline_s is None and (
            backoff is None or backoff.remaining() is None):
        raise ValueError("retry() needs attempts= and/or deadline_s=")
    b = backoff or Backoff(deadline_s=deadline_s)
    last: Optional[BaseException] = None
    call = 0
    while True:
        call += 1
        try:
            return fn()
        except retry_on as e:
            last = e
            if on_retry is not None:
                on_retry(call, e)
            if attempts is not None and call >= attempts:
                break
            if not b.sleep():
                break
    raise RetriesExhausted(
        f"{describe or getattr(fn, '__name__', 'operation')} failed after "
        f"{call} attempt(s): {last!r}") from last
