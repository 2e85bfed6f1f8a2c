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
from typing import Any, Callable, Dict, List, Optional, Sequence

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


def _tensors(obj) -> List[torch.Tensor]:
    """The tensors of a step argument: a tensor; a module's parameters
    and buffers; an optimizer's parameters and state tensors (through
    wrappers that hold it as ``.optimizer``); the items of a list,
    tuple or dict."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, torch.nn.Module):
        return [*obj.parameters(), *obj.buffers()]
    if isinstance(obj, torch.optim.Optimizer):
        out = [p for g in obj.param_groups for p in g["params"]]
        for st in obj.state.values():
            out += [v for v in st.values() if isinstance(v, torch.Tensor)]
        return out
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in _tensors(o)]
    inner = getattr(obj, "optimizer", None)
    return _tensors(inner) if inner is not None else []


def _optimizers(obj) -> List[torch.optim.Optimizer]:
    """The optimizers of a step argument, found as :func:`_tensors`
    finds tensors."""
    if isinstance(obj, torch.optim.Optimizer):
        return [obj]
    if isinstance(obj, (torch.Tensor, torch.nn.Module)):
        return []
    if isinstance(obj, (list, tuple)):
        return [o for x in obj for o in _optimizers(x)]
    if isinstance(obj, dict):
        return [o for x in obj.values() for o in _optimizers(x)]
    inner = getattr(obj, "optimizer", None)
    return _optimizers(inner) if inner is not None else []


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


class _GraphedStep:
    """The :func:`donated_step` callable (see there)."""

    def __init__(self, fn: Callable, donate_argnums: Sequence[int]):
        self._fn = fn
        self._donate = frozenset(int(i) for i in donate_argnums)
        self._eager_done = False
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._failed: Optional[BaseException] = None
        self._device: Optional[torch.device] = None
        self._static: List[Any] = []
        self._ptrs: Dict[int, List[int]] = {}
        self._frozen: Dict[int, list] = {}
        self._hooks: List[Callable[[], None]] = []
        self._out: Any = None

    @property
    def graphed(self) -> bool:
        """Whether the step has been captured (later calls replay)."""
        return self._graph is not None

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
        if self._graph is None:
            if not self._eager_done:      # builds what the graph captures
                self._eager_done = True
                return self._fn(*args)
            self._capture(args, device)
        else:
            self._feed(args, tensors)
        return self._replay()

    def _capture(self, args, device: torch.device) -> None:
        static = list(args)
        for i, a in enumerate(args):
            if i in self._donate or not isinstance(a, torch.Tensor):
                continue
            if not a.is_cuda:
                raise ValueError(f"argument {i} lies on {a.device}; the "
                                 "inputs of a graphed step lie on the card")
            static[i] = a.clone()
        graph = torch.cuda.CUDAGraph()
        try:
            with graphs.collect_replay_hooks() as hooks, \
                    torch.cuda.device(device), \
                    torch.cuda.graph(graph, capture_error_mode="global"):
                out = self._fn(*static)
        except BaseException as e:
            self._failed = e
            raise
        self._device, self._static, self._hooks, self._out = (
            device, static, hooks, out)
        donated = [i for i in self._donate if i < len(args)]
        self._ptrs = {i: [t.data_ptr() for t in _tensors(args[i])]
                      for i in donated}
        self._frozen = {i: _frozen_hyperparameters(args[i]) for i in donated}
        self._graph = graph

    def _feed(self, args, tensors) -> None:
        """Check the donated arguments and copy the others into the
        graph's inputs."""
        if len(args) != len(self._static):
            raise ValueError(f"graphed step captured with "
                             f"{len(self._static)} arguments, called with "
                             f"{len(args)}")
        for i, ptrs in self._ptrs.items():
            if [t.data_ptr() for t in tensors[i]] != ptrs:
                raise ValueError(
                    f"donated argument {i} is not the state the step was "
                    "captured with: pass the same tensors (same storage) "
                    "on every call")
            if _frozen_hyperparameters(args[i]) != self._frozen[i]:
                raise ValueError(
                    f"an optimizer of donated argument {i} changed a "
                    "hyperparameter that the graph keeps as captured (a "
                    "torch.optim optimizer's Python floats, a fused "
                    "optimizer's nesterov or weight decay on/off); "
                    "build a new donated_step for the new values")
        for i, (a, s) in enumerate(zip(args, self._static)):
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

    def _replay(self):
        for hook in self._hooks:
            hook()
        with torch.cuda.device(self._device):
            self._graph.replay()
        return self._out


def donated_step(fn: Callable, *, donate_argnums: Sequence[int] = (0, 1),
                 compile_cache: Optional[str] = None) -> _GraphedStep:
    """A train step ``fn(*args)`` captured as one CUDA graph.

    ``fn`` is one step (or several): it updates the state arguments in
    place (a module, an optimizer, tensors; ``donate_argnums``) and
    returns what the caller reads, such as the loss.  On CUDA tensors,
    N calls are exactly N steps:

    * the first call runs ``fn`` eagerly, as a real step: it creates the
      optimizer state, the library workspaces and the NCCL communicator;
    * the second call captures ``fn`` with ``torch.cuda.graph`` (in the
      "global" error mode, which refuses any host call a capture cannot
      hold) and replays the graph once (the capture itself runs
      nothing), and every later call is one replay.

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
    advances its pass count per replay and raises inside a capture for
    ``backward_passes_per_step > 1`` (the host decides when to
    communicate) and for the int8/int4 wire.  The kernels' ``launches``
    counters count Python calls, so a replay does not move them; count
    a graphed step's launches with ``torch.profiler``.

    On CPU tensors ``fn`` runs eagerly on every call.  On the card
    nothing falls back: a capture that fails raises CUDA's error, and so
    does every later call.  ``compile_cache`` engages
    :func:`enable_compilation_cache` (env-transparent: a no-op unless it
    or the knob names a directory).
    """
    enable_compilation_cache(compile_cache)
    return _GraphedStep(fn, donate_argnums)


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
