"""Device prefetch: batch N+1's host-to-device copy under step N.

The PyTorch counterpart of ``prefetch_to_device`` in the JAX package's
``data/loader.py``.  There each batch is ``jax.device_put`` with a
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
import numbers
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from ..common.basics import DeviceLike, resolve_device

__all__ = ["prefetch_to_device"]


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
