"""Step-pipeline layer: the train step as one CUDA graph, the compilation
cache, and double-buffered input.

The PyTorch counterpart of the JAX package's ``step_pipeline.py``.
There :func:`donated_step` is ``jax.jit`` with the state buffers
donated: one compiled program a step, updating the state in place.  Here
it captures the step as one CUDA graph (``torch.cuda.graph``) and
replays it: one launch a step from the host instead of one Python
dispatch per operation, with the state updated in place as before.

Host-side state that a replay would not re-run (a step count, the
learning rate a fused optimizer reads) registers a hook with
:func:`on_replay` (``common/graphs.py``) while the step is captured; the
graphed step calls every hook before each replay.  Code that keeps such
state and cannot advance it raises inside a capture (see
:func:`donated_step`).

:func:`enable_compilation_cache` keeps the reference's knob contract
(``HVDT_COMPILATION_CACHE``) for what the port compiles at run time.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import torch

from .common import config, graphs
from .common.basics import DeviceLike
from .common.graphs import capturing, on_replay

__all__ = ["enable_compilation_cache", "donated_step", "overlap_step",
           "capturing", "on_replay"]

log = logging.getLogger(__name__)

_DISABLED = ("", "0", "off", "none", "false")
_engaged: Optional[str] = None


def enable_compilation_cache(path: Optional[str] = None, *,
                             min_compile_secs: Optional[float] = None
                             ) -> Optional[str]:
    """Point what the port compiles at run time at one directory.

    The nvcc kernels are cached by ``_build.py`` already (keyed by their
    sources' hash); this engages the torch inductor and Triton caches,
    for callers who ``torch.compile`` their own step
    (``TORCHINDUCTOR_CACHE_DIR`` and ``TRITON_CACHE_DIR`` under
    ``path``).  ``path`` defaults to the ``HVDT_COMPILATION_CACHE``
    knob; empty / "off" means disabled and the call is a no-op returning
    the directory engaged before, if any.  ``min_compile_secs`` is
    accepted for the reference's signature and has no effect: torch's
    caches keep every entry.  Idempotent; returns the engaged directory.
    Never raises — an unwritable directory degrades to a warning, not a
    failed run.
    """
    global _engaged

    if path is None:
        path = config.get_str("HVDT_COMPILATION_CACHE")
    if path is None or str(path).strip().lower() in _DISABLED:
        return _engaged
    path = os.path.abspath(os.path.expanduser(str(path)))
    if _engaged == path:
        return _engaged
    try:
        os.makedirs(path, exist_ok=True)
        os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(path, "inductor")
        os.environ["TRITON_CACHE_DIR"] = os.path.join(path, "triton")
        _engaged = path
        log.info("compilation cache at %s", path)
    except Exception as e:     # a cache must never sink a training run
        log.warning("compilation cache not engaged at %s: %r", path, e)
    return _engaged


def _walk(obj) -> Iterator[Any]:
    """The objects of a step argument: a tensor, a module or an optimizer
    itself; the items of a list, tuple or dict; any other object itself
    and, where it wraps an optimizer as ``.optimizer``, that one's."""
    if isinstance(obj, (torch.Tensor, torch.nn.Module,
                        torch.optim.Optimizer)):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _walk(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _walk(o)
    else:
        yield obj
        inner = getattr(obj, "optimizer", None)
        if inner is not None:
            yield from _walk(inner)


def _tensors(obj) -> List[torch.Tensor]:
    """The tensors of a step argument (see :func:`_walk`): a tensor; a
    module's parameters and buffers; an optimizer's parameters and state
    tensors."""
    out: List[torch.Tensor] = []
    for o in _walk(obj):
        if isinstance(o, torch.Tensor):
            out.append(o)
        elif isinstance(o, torch.nn.Module):
            out += [*o.parameters(), *o.buffers()]
        elif isinstance(o, torch.optim.Optimizer):
            out += [p for g in o.param_groups for p in g["params"]]
            for st in o.state.values():
                out += [v for v in st.values() if isinstance(v, torch.Tensor)]
    return out


def _optimizers(obj) -> List[torch.optim.Optimizer]:
    """The optimizers of a step argument (see :func:`_walk`)."""
    return [o for o in _walk(obj) if isinstance(o, torch.optim.Optimizer)]


def _frozen_hyperparameters(obj) -> list:
    """What a graph keeps of the hyperparameters of each optimizer in a
    step argument.  An optimizer may name it (``_frozen_at_capture()``,
    as the port's fused optimizers do: their scalars are refreshed before
    each replay); otherwise every entry of every param group but its
    parameters, which a ``torch.optim`` optimizer hands its kernels as
    Python values that the capture bakes in.  Tensor entries compare by
    identity (a replay reads their current values)."""
    out = []
    for opt in _optimizers(obj):
        named = getattr(opt, "_frozen_at_capture", None)
        if named is not None:
            out.append(named())
            continue
        out.append([{k: (("tensor", id(v)) if isinstance(v, torch.Tensor)
                         else v)
                     for k, v in g.items() if k != "params"}
                    for g in opt.param_groups])
    return out


def _same(a: Any, b: Any) -> bool:
    if a is b:
        return True
    try:
        return bool(a == b)
    except Exception:
        return False


def _phase(obj) -> tuple:
    """What a step argument's next step depends on: the
    ``_graph_phase()`` of each object of it (see :func:`_walk`) whose
    class has one (``DistributedOptimizer`` with
    ``backward_passes_per_step > 1``: the pass of its cycle)."""
    return tuple(o._graph_phase() for o in _walk(obj)
                 if hasattr(type(o), "_graph_phase"))


class _Captured:
    """One captured graph of a step and what its replays need."""

    __slots__ = ("graph", "device", "static", "ptrs", "frozen", "hooks",
                 "out")


class _GraphedStep:
    """The :func:`donated_step` callable (see there)."""

    def __init__(self, fn: Callable, donate_argnums: Sequence[int]):
        self._fn = fn
        self._donate = frozenset(int(i) for i in donate_argnums)
        self._eager_done: set = set()
        self._graphs: Dict[tuple, _Captured] = {}
        # One memory pool for the graphs of every phase: they replay one
        # after another, never at once, and what one leaves for the next
        # lives outside the pool or stays referenced.
        self._pool = None
        self._failed: Optional[BaseException] = None

    @property
    def graphed(self) -> bool:
        """Whether the step has been captured (later calls replay)."""
        return bool(self._graphs)

    def __call__(self, *args):
        if self._failed is not None:
            raise RuntimeError("the capture of this step failed; a graphed "
                               "step never carries on eagerly") \
                from self._failed
        tensors = [_tensors(a) for a in args]
        device = next((t.device for ts in tensors for t in ts if t.is_cuda),
                      None)
        if device is None:            # the CPU: run the step as it is
            return self._fn(*args)
        key = tuple(k for i in sorted(self._donate) if i < len(args)
                    for k in _phase(args[i]))
        cap = self._graphs.get(key)
        if cap is None:
            if key not in self._eager_done:   # builds what the graph holds
                self._eager_done.add(key)
                return self._fn(*args)
            cap = self._capture(args, device, key)
        else:
            self._feed(cap, args, tensors)
        return self._replay(cap)

    def _capture(self, args, device: torch.device, key: tuple) -> _Captured:
        static = list(args)
        for i, a in enumerate(args):
            if i in self._donate or not isinstance(a, torch.Tensor):
                continue
            if not a.is_cuda:
                raise ValueError(f"argument {i} lies on {a.device}; the "
                                 "inputs of a graphed step lie on the card")
            static[i] = a.clone()
        graph = torch.cuda.CUDAGraph()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        try:
            with graphs.capture_lock, \
                    graphs.collect_replay_hooks() as hooks, \
                    torch.cuda.device(device), \
                    torch.cuda.graph(graph, pool=self._pool,
                                     capture_error_mode="global"):
                out = self._fn(*static)
        except BaseException as e:
            self._failed = e
            raise
        cap = _Captured()
        cap.graph, cap.device, cap.static, cap.hooks, cap.out = (
            graph, device, static, hooks, out)
        donated = [i for i in self._donate if i < len(args)]
        cap.ptrs = {i: [t.data_ptr() for t in _tensors(args[i])]
                    for i in donated}
        cap.frozen = {i: _frozen_hyperparameters(args[i]) for i in donated}
        self._graphs[key] = cap
        return cap

    def _feed(self, cap: _Captured, args, tensors) -> None:
        """Check the donated arguments and copy the others into the
        graph's inputs."""
        if len(args) != len(cap.static):
            raise ValueError(f"graphed step captured with "
                             f"{len(cap.static)} arguments, called with "
                             f"{len(args)}")
        for i, ptrs in cap.ptrs.items():
            if [t.data_ptr() for t in tensors[i]] != ptrs:
                raise ValueError(
                    f"donated argument {i} is not the state the step was "
                    "captured with: pass the same tensors (same storage) "
                    "on every call")
            if _frozen_hyperparameters(args[i]) != cap.frozen[i]:
                raise ValueError(
                    f"an optimizer of donated argument {i} changed a "
                    "hyperparameter that the graph keeps as captured (a "
                    "torch.optim optimizer's Python floats, a fused "
                    "optimizer's nesterov or weight decay on/off); "
                    "build a new donated_step for the new values")
        for i, (a, s) in enumerate(zip(args, cap.static)):
            if i in self._donate or a is s:
                continue
            if isinstance(s, torch.Tensor):
                if (not isinstance(a, torch.Tensor) or a.shape != s.shape
                        or a.dtype != s.dtype):
                    raise ValueError(
                        f"argument {i} must be a {s.dtype} tensor of shape "
                        f"{tuple(s.shape)}, as at capture")
                s.copy_(a)
            elif not _same(a, s):
                raise ValueError(f"argument {i} differs from its value at "
                                 "capture, which the graph baked in")

    def _replay(self, cap: _Captured):
        for hook in cap.hooks:
            hook()
        with torch.cuda.device(cap.device):
            cap.graph.replay()
        return cap.out


def donated_step(fn: Callable, *, donate_argnums: Sequence[int] = (0, 1),
                 compile_cache: Optional[str] = None) -> Callable:
    """A train step ``fn(*args)`` captured as one CUDA graph.

    ``fn`` is one step (or several): it updates the state arguments in
    place (a module, an optimizer, tensors; ``donate_argnums``) and
    returns what the caller reads, such as the loss.  On CUDA tensors,
    N calls are exactly N steps:

    * the first call runs ``fn`` eagerly, as a real step: it creates the
      optimizer state, the library workspaces and the NCCL communicators
      (the exchange's and SyncBatchNorm's);
    * the second call captures ``fn`` with ``torch.cuda.graph`` (in the
      "global" error mode, which refuses any host call a capture cannot
      hold) and replays the graph once (the capture itself runs
      nothing), and every later call is one replay.

    A step whose work differs from call to call by host state names that
    state: a donated argument with a ``_graph_phase()`` method (found
    through ``.optimizer`` wrappers), such as ``DistributedOptimizer``
    with ``backward_passes_per_step=k``, whose passes 1 to k-1 only
    accumulate and whose k-th exchanges and steps.  The rule above then
    holds per phase: each phase's first call runs eagerly, its second
    captures a graph of its own, and a call replays the graph of the
    phase at hand (k graphs, which share one memory pool).

    Donated arguments are the state: the same tensors, at the same
    storage, on every call; otherwise the call raises ``ValueError``.
    Other tensor arguments (the batch) are copied into the graph's inputs
    before each replay; other values must equal their value at capture.
    The returned tensors are the graph's outputs: the next call
    overwrites them.

    What a capture freezes: everything read on the host while ``fn`` is
    captured, as ``jax.jit`` freezes it at trace time in the reference —
    knobs such as ``HVDT_FUSED_CONV1X1``, read per call by the ResNet's
    1x1 convs.  The Python-float hyperparameters that a ``torch.optim``
    optimizer passes to its kernels would freeze too, so a call raises
    ``ValueError`` when a donated optimizer's param groups differ from
    theirs at capture (a learning-rate scheduler on ``torch.optim.SGD``
    cannot drive a graphed step).  The port's fused optimizers read
    their scalars (learning rate, momentum, Adam's bias corrections at
    its step count) from device memory that a hook refreshes before each
    replay, so a schedule and the count advance as in eager steps; which
    updates run (nesterov, weight decay on or off) stays as captured,
    and a call that changes it raises.  ``DistributedOptimizer``
    advances its pass count per replay.  The int8/int4 wire and
    ``quant.with_error_feedback`` run inside the graph (their residuals
    are kept in place).  The kernels' ``launches``
    counters count Python calls, so a replay does not move them; count
    a graphed step's launches with ``torch.profiler``.

    On CPU tensors ``fn`` runs eagerly on every call.  On the card
    nothing falls back: a capture that fails raises CUDA's error, and so
    does every later call.  ``compile_cache`` engages
    :func:`enable_compilation_cache` (env-transparent: a no-op unless it
    or the knob names a directory).

    With telemetry on (``HVDT_TELEMETRY=1``) the graphed step is wrapped
    so each call's host duration feeds ``hvdt_step_dispatch_seconds``;
    with distributed tracing on (``HVDT_TRACE_DIR``) the same wrapper
    records a ``train.step`` span and advances the per-step trace id
    (``telemetry/trace.py``).  Attribute access forwards to the graphed
    step; with both off the graphed step itself is returned.
    """
    from .telemetry.instrument import wrap_step

    enable_compilation_cache(compile_cache)
    return wrap_step(_GraphedStep(fn, donate_argnums))


class _OverlapStep:
    """The :func:`overlap_step` handle: calls forward to the graphed
    step; :meth:`run` drives a whole batch stream with double-buffered
    host→device input."""

    __slots__ = ("_fn", "_prefetch", "_device", "_put")

    def __init__(self, fn, prefetch: int, device: DeviceLike, put):
        self._fn = fn
        self._prefetch = prefetch
        self._device = device
        self._put = put

    def __call__(self, *args, **kwargs):
        return self._fn(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def run(self, state, batches):
        """Drive the step over ``batches`` with ``prefetch_size`` device
        batches in flight: batch N+1's copy rides under step N.

        ``state`` is the tuple of leading (donated) arguments; each batch
        is appended as trailing argument(s) — a tuple/list batch is
        splatted.  The step returns the next state tuple.  Returns the
        final state; the prefetch generator is closed (queued device
        batches dropped) even when the loop exits by an exception.
        """
        from .data.loader import prefetch_to_device

        state = tuple(state)
        it = prefetch_to_device(batches, size=self._prefetch,
                                device=self._device, put=self._put)
        try:
            for batch in it:
                args = (tuple(batch) if isinstance(batch, (tuple, list))
                        else (batch,))
                out = self._fn(*state, *args)
                state = out if isinstance(out, tuple) else (out,)
        finally:
            it.close()
        return state


def overlap_step(fn: Callable, *, donate_argnums: Sequence[int] = (0, 1),
                 prefetch_size: int = 2, device: DeviceLike = None,
                 put=None, compile_cache: Optional[str] = None
                 ) -> _OverlapStep:
    """:func:`donated_step` plus double-buffered host→device input
    (``data.loader.prefetch_to_device`` onto ``device``, the card unless
    the caller names another; ``put`` overrides the transfer).  Call it
    like the graphed step, or use ``.run(state, batches)``."""
    if prefetch_size < 1:
        raise ValueError(
            f"overlap_step needs prefetch_size >= 1 (got {prefetch_size})")
    step = donated_step(fn, donate_argnums=donate_argnums,
                        compile_cache=compile_cache)
    return _OverlapStep(step, prefetch_size, device, put)
