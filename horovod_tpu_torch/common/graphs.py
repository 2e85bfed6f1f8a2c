"""CUDA-graph capture state that the port's lower layers read.

``step_pipeline.donated_step`` captures a train step as one CUDA graph
and replays it.  Host-side state that a replay does not re-run (a step
count, the scalars a fused optimizer reads) registers a hook with
:func:`on_replay` while the step is captured; the graphed step calls
every hook before each replay.  Code that keeps such state and cannot
advance it asks :func:`capturing` and raises inside a capture.

The optimizers, the exchange and error feedback import this module; the
step layer above them opens :func:`collect_replay_hooks` around its
capture.

``donated_step`` captures with ``capture_error_mode="global"``: a CUDA
call from any other thread during the capture invalidates it.  The eager
controller's thread issues CUDA work, so it holds :data:`capture_lock`
around that work, and ``donated_step`` holds it across a capture.  A
capture taken by other means (``torch.cuda.graph``,
``make_graphed_callables``, global mode too) while eager ops are in
flight must hold :data:`capture_lock` across it as well, or
``synchronize`` the ops first.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterator, List, Optional

import torch

__all__ = ["capturing", "on_replay", "collect_replay_hooks",
           "capture_lock", "replay_hooks_open"]

# Held across a donated_step capture, and by a thread other than the
# capturing one around each piece of CUDA work it issues.
capture_lock = threading.RLock()

# The hooks of the graph being captured by donated_step (None otherwise).
_hooks: Optional[List[Callable[[], None]]] = None


def capturing() -> bool:
    """True while the current CUDA stream is capturing a graph."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def on_replay(hook: Callable[[], None]) -> None:
    """Run ``hook()`` before each replay of the graph ``donated_step`` is
    capturing, the first replay included.  For host-side state a replay
    must advance: the code under capture leaves that state alone and the
    hook does, per replay, what an eager call would have done.  Raises
    outside a ``donated_step`` capture (a graph captured by other means
    would never call the hook, and the state would freeze).
    """
    if _hooks is None:
        raise RuntimeError(
            "this step keeps host-side state that a CUDA graph replay does "
            "not advance; capture it with horovod_tpu_torch.step_pipeline."
            "donated_step, which updates that state before each replay")
    _hooks.append(hook)


def replay_hooks_open() -> bool:
    """Whether :func:`on_replay` would take a hook now (a
    ``donated_step`` capture is open)."""
    return _hooks is not None


@contextlib.contextmanager
def collect_replay_hooks() -> Iterator[List[Callable[[], None]]]:
    """Collect the :func:`on_replay` hooks registered inside the block
    into the list it yields."""
    global _hooks
    if _hooks is not None:
        raise RuntimeError("a donated_step capture is already open")
    hooks: List[Callable[[], None]] = []
    _hooks = hooks
    try:
        yield hooks
    finally:
        _hooks = None
