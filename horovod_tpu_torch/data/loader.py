"""Data loading: base iterable, background-thread prefetch, device
prefetch.

The counterpart of the JAX package's ``data/loader.py`` (Horovod's
data/data_loader_base.py: ``BaseDataLoader`` with the resume ``seek``,
and ``AsyncDataLoaderMixin``, a background thread pushing batches
through a bounded queue; these are copies, free of any framework).

``prefetch_to_device`` keeps batch N+1's host-to-device copy under
step N.  In the reference each batch is ``jax.device_put`` with a
sharding; here each tensor of a batch is copied to one device:

* a CPU tensor is pinned (page-locked, through PyTorch's caching host
  allocator) and copied with ``non_blocking=True`` on a side stream, so
  the copy runs beside the consumer's kernels;
* before a batch is handed out, the consumer's current stream waits on
  the event recorded after its copy, and each copied tensor is marked as
  used on that stream (``record_stream``), so its memory is not reused
  while the consumer may still read it.

Numpy arrays, numpy scalars and Python numbers become tensors first
(``torch.as_tensor``) and are copied like any other tensor, as the
reference ``device_put``s every leaf; strings and ``None`` pass through.

On the CPU (``device="cpu"``) a batch is moved with ``.to(device)`` and
nothing is in flight.
"""

from __future__ import annotations

import collections
import logging
import numbers
import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from ..common.basics import DeviceLike, resolve_device

__all__ = ["BaseDataLoader", "AsyncDataLoaderMixin", "AsyncDataLoader",
           "prefetch_to_device"]

log = logging.getLogger(__name__)


class BaseDataLoader:
    """Iterable over batches (ref: data_loader_base.py BaseDataLoader).

    Subclasses implement ``_iterate``; ``_process_batch`` is the trainer
    hook applied to every batch (kept for API parity).

    ``seek(cursor)`` arms the deterministic-resume fast-forward: the
    NEXT iteration discards the first ``batch_idx`` batches unprocessed
    (no ``_process_batch``, no device transfer) so recovery replays zero
    already-committed batches.  The cursor is what
    ``ElasticSampler.cursor()`` rides inside every checkpoint / peer
    snapshot — ``epoch`` is the caller's to apply via ``set_epoch``
    before re-iterating; the loader consumes ``batch_idx``.  One-shot:
    the fast-forward applies to the next iteration only.
    """

    _seek_batches = 0

    def __len__(self) -> int:
        raise NotImplementedError

    def _iterate(self) -> Iterator[Any]:
        raise NotImplementedError

    def _process_batch(self, batch: Any) -> Any:
        return batch

    def seek(self, cursor) -> "BaseDataLoader":
        """Arm a fast-forward to ``cursor`` (``{"epoch": e, "batch_idx":
        b}``, an ``(epoch, batch_idx)`` tuple, or a bare batch index)
        for the next iteration.  Returns self for chaining."""
        if isinstance(cursor, dict):
            batch_idx = cursor.get("batch_idx", 0)
        elif isinstance(cursor, (tuple, list)):
            batch_idx = cursor[1] if len(cursor) > 1 else cursor[0]
        else:
            batch_idx = cursor
        batch_idx = int(batch_idx)
        if batch_idx < 0:
            raise ValueError(f"seek cursor batch_idx must be >= 0, "
                             f"got {batch_idx}")
        self._seek_batches = batch_idx
        return self

    def __iter__(self) -> Iterator[Any]:
        skip, self._seek_batches = self._seek_batches, 0
        if skip:
            t0 = time.perf_counter()
            it = self._iterate()
            skipped = 0
            for _ in range(skip):
                try:
                    next(it)
                except StopIteration:
                    log.warning(
                        "seek past the end of the loader: cursor asked "
                        "for batch %d but the stream held %d", skip,
                        skipped)
                    return
                skipped += 1
            _charge_replay(time.perf_counter() - t0)
            for batch in it:
                yield self._process_batch(batch)
            return
        for batch in self._iterate():
            yield self._process_batch(batch)


def _charge_replay(seconds: float) -> None:
    """Attribute fast-forward time to the recovery budget's ``replay``
    phase (None-check when telemetry is off)."""
    from ..telemetry import step_stats

    ledger = step_stats.recovery_ledger()
    if ledger is not None:
        ledger.charge_phase("replay", seconds)


class _Done:
    pass


class _Raised:
    def __init__(self, exc: BaseException):
        self.exc = exc


class AsyncDataLoaderMixin:
    """Background-thread prefetch mixin (ref: data_loader_base.py
    AsyncDataLoaderMixin; queue size 0 disables async, same contract).

    Use as ``class MyAsyncLoader(AsyncDataLoaderMixin, MyLoader)``.  The
    producer thread runs ``super()._iterate()`` and pushes into a bounded
    queue; iteration pops.  Exceptions in the producer re-raise in the
    consumer; ``close()`` joins the thread.
    """

    def __init__(self, *args, async_loader_queue_size: int = 64,
                 close_timeout_s: float = 5.0, **kwargs):
        self._queue_size = async_loader_queue_size
        self._close_timeout_s = float(close_timeout_s)
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        super().__init__(*args, **kwargs)

    def close(self) -> None:
        thread = self._thread
        if thread is None:
            return
        self._stop.set()
        # Two safety nets against the close-mid-iteration hang: the
        # producer's puts are bounded (it re-checks the stop flag every
        # timeout, so it can never stay parked on a full queue), and the
        # drain below unblocks it immediately rather than after the put
        # timeout.  The join is bounded too — a producer wedged inside
        # the UPSTREAM iterator (not our queue) must not hang close();
        # it is a daemon thread and dies with the process.
        deadline = time.monotonic() + self._close_timeout_s
        while thread.is_alive() and time.monotonic() < deadline:
            if self._queue is not None:
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    pass
            thread.join(0.01)
        if thread.is_alive():
            log.warning(
                "async loader producer did not exit within %.1fs of "
                "close() (blocked in the upstream iterator?); abandoning "
                "the daemon thread", self._close_timeout_s)
        self._thread = None

    def _put(self, item: Any) -> bool:
        """Bounded put: parks at most 50 ms at a time so a producer
        blocked on a full queue observes close()'s stop flag.  Returns
        False when shut down instead of delivering."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _producer(self) -> None:
        try:
            for batch in super()._iterate():
                if self._stop.is_set() or not self._put(batch):
                    return
            self._put(_Done())
        except BaseException as e:  # noqa: BLE001 - re-raised in consumer
            self._put(_Raised(e))

    def _iterate(self) -> Iterator[Any]:
        if self._queue_size == 0:  # async disabled (ref contract)
            yield from super()._iterate()
            return
        self.close()
        self._stop.clear()
        self._queue = queue.Queue(self._queue_size)
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()
        while True:
            item = self._queue.get()
            if isinstance(item, _Done):
                break
            if isinstance(item, _Raised):
                raise item.exc
            yield item


class _ListLoader(BaseDataLoader):
    def __init__(self, batches: Iterable[Any]):
        self._batches = list(batches)

    def __len__(self) -> int:
        return len(self._batches)

    def _iterate(self) -> Iterator[Any]:
        yield from self._batches


class AsyncDataLoader(AsyncDataLoaderMixin, _ListLoader):
    """Ready-made async loader over any finite iterable of batches."""



def _map(fn: Callable[[torch.Tensor], Any], batch: Any) -> Any:
    """``fn`` over every tensor of a batch (tensors, and tuples, lists
    and dicts of them); numeric numpy arrays, numpy scalars and Python
    numbers go through ``torch.as_tensor`` first, and other leaves pass
    through."""
    if isinstance(batch, torch.Tensor):
        return fn(batch)
    if ((isinstance(batch, np.ndarray) and batch.dtype.kind in "biufc")
            or isinstance(batch, (np.number, np.bool_, numbers.Number))):
        return fn(torch.as_tensor(batch))
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map(fn, b) for b in batch)
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    return batch


def prefetch_to_device(it: Iterable[Any], size: int = 2,
                       device: DeviceLike = None,
                       put: Optional[Callable[[Any], Any]] = None
                       ) -> Iterator[Any]:
    """Keep ``size`` batches in flight on ``device`` (the card unless the
    caller names another): each is copied before the previous one is
    consumed, so the copy of batch N+1 overlaps step N.  ``put``
    overrides the transfer of a whole batch.

    The returned generator cleans up after itself: abandoning it early
    (``close()`` / GeneratorExit / garbage collection) drops the queued
    device batches instead of holding ``size`` of them until exit.
    """
    if size < 1:
        raise ValueError(
            f"prefetch_to_device needs size >= 1 (got {size}); size "
            "batches are kept in flight, so 0 would never yield")
    return _prefetch_gen(iter(it), size, resolve_device(device), put)


def _prefetch_gen(it: Iterator[Any], size: int, device: torch.device,
                  put: Optional[Callable[[Any], Any]]) -> Iterator[Any]:
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def transfer(batch):
        """(device batch, event after its copy or None)."""
        if put is not None:
            return put(batch), None
        if side is None:
            return _map(lambda t: t.to(device), batch), None

        def copy(t):
            if t.device.type == "cpu" and not t.is_pinned():
                t = t.pin_memory()
            return t.to(device, non_blocking=True)

        with torch.cuda.stream(side):
            out = _map(copy, batch)
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    def hand_out(out, done):
        if done is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            _map(lambda t: t.record_stream(consumer)
                 if t.device.type == "cuda" else None, out)
        return out

    buf: collections.deque = collections.deque()
    try:
        exhausted = False
        while True:
            while not exhausted and len(buf) < size:
                try:
                    buf.append(transfer(next(it)))
                except StopIteration:
                    exhausted = True
            if not buf:
                return
            yield hand_out(*buf.popleft())
    finally:
        # Early abandonment: drop the queued device batches (their memory
        # goes back to the side stream's pool, in stream order).
        buf.clear()
