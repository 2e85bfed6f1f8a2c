"""Dynamic micro-batcher: coalesce concurrent requests into bucket-shaped
batches.

The port's copy of the JAX package's ``serve/batcher.py`` (host-side
logic only: it touches no device).

An endpoint's requests arrive one at a time; the card wants them 32 at a
time.  The batcher is the standard serving answer (TF-Serving's
``BatchingSession``, Triton's dynamic batcher): admit requests into a
bounded queue, have ONE dispatch thread gather everything waiting — up to
``max_batch_size`` rows or ``max_delay_ms`` of linger for the first
request — and run them through the engine as a single padded-bucket
batch.  The linger bound caps the latency cost of batching; the row bound
caps the padding waste; the queue bound is the admission control valve:
past it, :meth:`submit` raises :class:`BackpressureError` *immediately*
(the server maps it to HTTP 503) instead of letting the queue grow into
an OOM — shed load at the door, not in the kernel.

Requests within one gather are grouped by feature shape/dtype (different
shapes cannot concatenate); each group is one engine call, and results
are sliced back per request.  The dispatch thread is the only engine
caller, so device execution is naturally serialized — the concurrency
lives in the waiting futures, not in racing dispatches.
"""

from __future__ import annotations

import collections
import concurrent.futures
import threading
import time
from typing import Any, Callable, Deque, List, Optional

import numpy as np

from ..common import config
from ..common.logging_util import get_logger
from .metrics import MetricsRegistry

__all__ = ["DynamicBatcher", "BackpressureError", "DispatcherDied",
           "RequestDeadlineExceeded"]

log = get_logger(__name__)


class BackpressureError(RuntimeError):
    """Raised by submit() when the bounded queue is full — the caller
    should shed the request (HTTP 503), not wait."""


class DispatcherDied(RuntimeError):
    """The batcher's dispatch thread is gone (killed by a catastrophic
    error, or the batcher was torn down under the caller — e.g. the
    router ejecting this replica mid-flight).  Raised by submit() and
    set on every still-pending future so HTTP handlers fail fast
    instead of parking on a future nobody will ever complete."""


class RequestDeadlineExceeded(TimeoutError):
    """Set on a request's future when its per-request deadline expired
    before (or while) the dispatch thread got to it — the batcher-side
    half of the server's 504, so a stalled engine cannot strand handler
    threads forever."""


class _Request:
    __slots__ = ("x", "future", "enqueued_at", "deadline")

    def __init__(self, x: np.ndarray, deadline_s: Optional[float] = None):
        self.x = x
        self.future: "concurrent.futures.Future" = concurrent.futures.Future()
        self.enqueued_at = time.perf_counter()
        self.deadline = (self.enqueued_at + deadline_s
                         if deadline_s and deadline_s > 0 else None)

    def expired(self, now: Optional[float] = None) -> bool:
        return self.deadline is not None and \
            (now if now is not None else time.perf_counter()) > self.deadline

    def fail(self, exc: BaseException) -> None:
        if not self.future.cancelled() and not self.future.done():
            self.future.set_exception(exc)


class DynamicBatcher:
    """Bounded-queue micro-batcher in front of an ``infer(x)->y`` callable.

    Parameters default to the ``HVDT_SERVE_*`` knobs.  ``max_batch_size``
    counts *rows* (a request may carry several rows); a single oversized
    request still dispatches — the engine chunks it.
    """

    def __init__(self, infer_fn: Callable[[np.ndarray], np.ndarray], *,
                 max_batch_size: Optional[int] = None,
                 max_delay_ms: Optional[float] = None,
                 max_queue_depth: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self._infer = infer_fn
        # Per-request deadline: a request the dispatch thread cannot get
        # to in time fails fast (RequestDeadlineExceeded) instead of
        # holding its handler thread behind a stalled engine.  Defaults
        # to the server's request timeout so the batcher gives up no
        # later than the HTTP layer would.
        self.deadline_s = float(
            deadline_s if deadline_s is not None
            else config.get_float("HVDT_SERVE_REQUEST_TIMEOUT_S"))
        self.max_batch_size = int(
            max_batch_size if max_batch_size is not None
            else config.get_int("HVDT_SERVE_MAX_BATCH_SIZE"))
        self.max_delay_s = float(
            max_delay_ms if max_delay_ms is not None
            else config.get_float("HVDT_SERVE_MAX_DELAY_MS")) / 1000.0
        self.max_queue_depth = int(
            max_queue_depth if max_queue_depth is not None
            else config.get_int("HVDT_SERVE_MAX_QUEUE_DEPTH"))
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._queue_gauge = self.metrics.gauge(
            "serve_queue_depth", "Requests admitted and not yet dispatched")
        self._queue_gauge.set_function(self.queue_depth)
        self._rejected = self.metrics.counter(
            "serve_rejected_total",
            "Requests shed by admission control (queue full -> 503)")
        self._requests = self.metrics.counter(
            "serve_requests_total", "Requests admitted to the batch queue")
        self._batches = self.metrics.counter(
            "serve_batches_total", "Dispatched micro-batches")
        self._fill = self.metrics.summary(
            "serve_batch_fill",
            "Rows per dispatched batch / max_batch_size (how full "
            "micro-batches run)")
        self._wait = self.metrics.summary(
            "serve_queue_wait_seconds", "Admission-to-dispatch queue wait")
        self._expired = self.metrics.counter(
            "serve_deadline_expired_total",
            "Requests failed with RequestDeadlineExceeded before "
            "dispatch completed")

        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._pending: Deque[_Request] = collections.deque()
        self._closed = False
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="hvdt-serve-batcher",
                                        daemon=True)
        self._thread.start()
        # Deadline watchdog: the dispatch loop expires queued requests
        # when it runs, but a dispatch thread WEDGED inside the engine
        # never runs — the watchdog is what keeps the deadline promise
        # then (fail fast beats a handler parked forever).
        self._watchdog: Optional[threading.Thread] = None
        if self.deadline_s > 0:
            self._watchdog = threading.Thread(
                target=self._watchdog_loop, name="hvdt-serve-deadline",
                daemon=True)
            self._watchdog.start()

    # ---- client side ----------------------------------------------------
    def queue_depth(self) -> int:
        with self._lock:
            return sum(r.x.shape[0] for r in self._pending)

    def submit(self, x) -> "concurrent.futures.Future":
        """Admit one request (``[rows, ...feature]``); returns a Future of
        the per-request output.  Raises :class:`BackpressureError` when
        the queue is at bound, ``RuntimeError`` after close()."""
        x = np.asarray(x)
        if x.ndim < 1 or x.shape[0] == 0:
            raise ValueError(f"request needs >=1 rows, got shape {x.shape}")
        req = _Request(x, deadline_s=self.deadline_s)
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if not self._thread.is_alive():
                # Liveness check: a dead dispatch thread means this
                # future would never complete — refuse admission with
                # the typed error instead of hanging the handler.
                raise DispatcherDied("batcher dispatch thread is dead")
            depth = sum(r.x.shape[0] for r in self._pending)
            if depth + x.shape[0] > self.max_queue_depth:
                self._rejected.inc()
                raise BackpressureError(
                    f"queue at bound ({depth}/{self.max_queue_depth} rows)")
            self._pending.append(req)
            self._requests.inc()
            self._not_empty.notify()
        return req.future

    def infer(self, x, timeout: Optional[float] = None) -> np.ndarray:
        """Blocking convenience wrapper over submit()."""
        return self.submit(x).result(timeout=timeout)

    # ---- dispatch side --------------------------------------------------
    def _expire_pending(self) -> int:
        """Fail every queued request past its deadline (typed).  Shared
        by the watchdog and close(); the gather loop does the same
        inline at pop time."""
        now = time.perf_counter()
        with self._lock:
            expired = [r for r in self._pending if r.expired(now)]
            for r in expired:
                self._pending.remove(r)
        for r in expired:
            self._expired.inc()
            r.fail(RequestDeadlineExceeded(
                f"request waited past its {self.deadline_s:.1f}s "
                f"deadline"))
        return len(expired)

    def _watchdog_loop(self) -> None:
        period = max(0.05, min(0.5, self.deadline_s / 4.0))
        while not self._stopped.wait(period):
            self._expire_pending()

    def _gather(self) -> List[_Request]:
        """Block for the first request, linger up to max_delay_s for more,
        then take up to max_batch_size rows (never splitting a request)."""
        with self._not_empty:
            while not self._pending and not self._closed:
                self._not_empty.wait(timeout=0.1)
            if not self._pending:
                return []
            deadline = (self._pending[0].enqueued_at + self.max_delay_s)
            while True:
                rows = sum(r.x.shape[0] for r in self._pending)
                remaining = deadline - time.perf_counter()
                if rows >= self.max_batch_size or remaining <= 0 \
                        or self._closed:
                    break
                self._not_empty.wait(timeout=remaining)
            batch: List[_Request] = []
            rows = 0
            now = time.perf_counter()
            while self._pending:
                nxt_req = self._pending[0]
                if nxt_req.expired(now):
                    # Fail fast at the dispatch seam: the handler that
                    # submitted this is (or will shortly be) giving up;
                    # running it anyway would burn a batch slot on
                    # an answer nobody reads.
                    self._pending.popleft()
                    self._expired.inc()
                    nxt_req.fail(RequestDeadlineExceeded(
                        f"request waited past its {self.deadline_s:.1f}s "
                        f"deadline"))
                    continue
                nxt = nxt_req.x.shape[0]
                if batch and rows + nxt > self.max_batch_size:
                    break
                rows += nxt
                batch.append(self._pending.popleft())
            return batch

    def _dispatch(self, batch: List[_Request]) -> None:
        try:
            self._dispatch_groups(batch)
        except BaseException as e:
            # A non-Exception (SystemExit, KeyboardInterrupt, ...) is
            # taking the dispatch thread down mid-batch: every popped
            # request that has no result yet must be failed HERE — they
            # left _pending, so no other path can reach them.
            for r in batch:
                if not r.future.done() and not r.future.cancelled():
                    r.future.set_exception(DispatcherDied(
                        f"dispatch thread dying mid-batch: {e!r}"))
            raise

    def _dispatch_groups(self, batch: List[_Request]) -> None:
        now = time.perf_counter()
        for r in batch:
            self._wait.observe(now - r.enqueued_at)
        # Deadline re-check at dispatch time: _gather expires requests
        # when it pops them, but a request can outlive its deadline
        # BETWEEN gather and here (a slow linger window, a long compile
        # on the previous group) — running it anyway would burn a batch
        # slot on an answer nobody is waiting for.
        live: List[_Request] = []
        for r in batch:
            if r.expired(now):
                self._expired.inc()
                r.fail(RequestDeadlineExceeded(
                    f"request expired after gather, before dispatch "
                    f"(waited {now - r.enqueued_at:.3f}s)"))
            else:
                live.append(r)
        batch = live
        # Group by feature signature: only same-shaped rows concatenate.
        groups: "collections.OrderedDict[Any, List[_Request]]" = \
            collections.OrderedDict()
        for r in batch:
            groups.setdefault((r.x.shape[1:], r.x.dtype.str), []).append(r)
        for _, reqs in groups.items():
            rows = sum(r.x.shape[0] for r in reqs)
            self._batches.inc()
            self._fill.observe(rows / float(self.max_batch_size))
            try:
                x = (reqs[0].x if len(reqs) == 1
                     else np.concatenate([r.x for r in reqs], axis=0))
                y = np.asarray(self._infer(x))
            except Exception as e:
                for r in reqs:
                    if not r.future.cancelled():
                        r.future.set_exception(e)
                continue
            off = 0
            for r in reqs:
                n = r.x.shape[0]
                if not r.future.cancelled():
                    r.future.set_result(y[off:off + n])
                off += n

    def _dispatch_loop(self) -> None:
        try:
            while True:
                batch = self._gather()
                if not batch:
                    with self._lock:
                        if self._closed and not self._pending:
                            return
                    continue
                try:
                    self._dispatch(batch)
                except Exception:    # defensive: the loop must never die
                    log.exception("serve batcher dispatch failed")
        except BaseException as e:
            # The loop itself died (MemoryError, interpreter teardown,
            # anything past the per-batch guard).  Every parked future
            # must learn about it NOW — an HTTP handler waiting on one
            # of these would otherwise hang until its own timeout, and
            # callers without a timeout would hang forever.
            self.fail_pending(DispatcherDied(
                f"batcher dispatch thread died: {e!r}"))
            raise

    def fail_pending(self, exc: Optional[BaseException] = None) -> int:
        """Fail every admitted-but-unfinished request with ``exc``
        (default :class:`DispatcherDied`).  Used by the dispatch loop's
        crash path and by owners abandoning the batcher wholesale (a
        router ejecting this replica, a drain that ran out of grace).
        Returns the number of futures failed."""
        exc = exc if exc is not None else DispatcherDied(
            "batcher abandoned with requests in flight")
        with self._lock:
            doomed = list(self._pending)
            self._pending.clear()
        n = 0
        for r in doomed:
            r.fail(exc)
            n += 1
        return n

    def close(self, timeout: float = 10.0) -> None:
        """Stop admitting; drain what's queued; join the thread.  If the
        drain does not finish inside ``timeout`` the leftover futures
        are failed (typed) rather than abandoned."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
        self._thread.join(timeout=timeout)
        self._stopped.set()
        if not self._thread.is_alive():
            # Normal exit path: nothing should remain, but a dispatch
            # loop killed between gather and dispatch leaves strays.
            self.fail_pending()
            return
        n = self.fail_pending(DispatcherDied(
            f"batcher close() timed out after {timeout}s with requests "
            f"in flight"))
        if n:
            log.warning("serve batcher close: failed %d in-flight "
                        "request(s) after drain timeout", n)
