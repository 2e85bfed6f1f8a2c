"""Overlap scheduling: the gradient exchange issued while the backward
runs.

The PyTorch counterpart of the JAX package's ``ops/overlap.py``, in
PyTorch's idiom.  The reference pins an XLA schedule with
``optimization_barrier`` token chains; here the exchange is issued from
the host as the gradients appear, the form Horovod's own
``torch/optimizer.py`` takes:

* **Reverse-topological buckets** (:func:`overlap_schedule`): the
  backward produces gradients in reverse parameter order, so the buckets
  are ``fused_allreduce_buckets`` over the reversed leaves; bucket 0
  holds the output-side leaves and is issued first.
* **Issue and finish** (:class:`_Pipeline`): each bucket is packed and
  its collective issued on a dedicated communication stream, after an
  event on the stream that produced the gradients; a plain bucket's
  ``all_reduce`` is issued with ``async_op=True`` and waited when the
  bucket is finished.  Buckets are issued and finished in schedule
  order on every rank, so every rank issues its NCCL calls in one
  order.  On the int8/int4 wire (``quantized_allreduce_start`` /
  ``finish``) and the hierarchical transport, bucket N+1's start is
  issued before bucket N's finish.
* **The hooked exchange** (:class:`HookedExchange`): under
  ``HVDT_OVERLAP=on`` ``DistributedOptimizer`` registers
  ``register_post_accumulate_grad_hook`` on every parameter; when the
  last gradient of a bucket lands (and its predecessors have been
  issued) the bucket is issued, on autograd's device thread.
  ``step()`` issues what is left, waits, copies back and steps.  Inside
  a ``donated_step`` capture the fork to the communication stream and
  the join are captured with the step, so one graph holds the
  overlapped exchange.
* **Pipelined update** (:func:`exchange_and_update`,
  :func:`pipelined_sgd`): bucket N's update runs after N's wait while
  N+1 is in flight; ``pipelined_sgd`` steps each bucket with one launch
  of kernel #2 over its leaves and keeps ``fused_sgd``'s state.
* **Segmented backward** (:func:`overlap_value_and_grad`): a chain of
  stages whose backward is walked stage by stage, each stage's exchange
  issued before the next segment runs.

Zero-overhead contract: with ``HVDT_OVERLAP`` unset or off,
:func:`get_scheduler` returns None and :func:`exchange_fn` returns
``ops.device.fused_allreduce`` itself, and ``DistributedOptimizer``
registers no hook.

Numerics: a bucket's collective reduces each element across ranks, so
any bucketing gives each leaf the same terms; but NCCL's and gloo's sum
order for an element depends on its place in the buffer, so on the card
f32 results agree with the monolithic exchange up to reassociation, and
bit for bit where the sums are exact.  An overlapped exchange that fails
raises; it never reruns monolithically.

Accounting (:func:`overlap_fraction`, :func:`last_schedule`): the
reference's byte proxy, every bucket but the last issued counted as
hidden.  :func:`enable_latency_hiding` keeps the reference's knob
``HVDT_XLA_LATENCY_HIDING`` and its validation; it configures XLA on a
TPU, so on the card it sets nothing and returns None.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..common import config
from ..common.process_sets import ProcessSet
from ..common.types import ReduceOp
from . import device as dev
from .optim_kernels import FusedSGD

__all__ = [
    "enabled", "get_scheduler", "exchange_fn", "reset", "OverlapScheduler",
    "overlap_schedule", "overlap_value_and_grad", "exchange_and_update",
    "pipelined_sgd", "PipelinedSGD", "HookedExchange",
    "enable_latency_hiding", "overlap_fraction", "last_schedule",
    "reset_accounting",
]

_TRUTHY = ("1", "true", "yes", "on")


def enabled() -> bool:
    """Whether the overlap scheduling layer is on (``HVDT_OVERLAP``)."""
    return os.environ.get("HVDT_OVERLAP", "").strip().lower() in _TRUTHY


# ---------------------------------------------------------------------------
# The process-wide scheduler, cached on the raw env string.
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_cached_env: Optional[str] = "\0unset"   # sentinel != any real env value
_cached_scheduler: Optional["OverlapScheduler"] = None


def get_scheduler() -> Optional["OverlapScheduler"]:
    """The process-wide overlap scheduler, or None when off (one environ
    read and a string compare)."""
    global _cached_env, _cached_scheduler
    raw = os.environ.get("HVDT_OVERLAP")
    if raw != _cached_env:
        with _lock:
            if raw != _cached_env:
                _cached_scheduler = OverlapScheduler() if enabled() else None
                _cached_env = raw
    return _cached_scheduler


def exchange_fn() -> Callable:
    """The bucketed exchange the optimizer layer uses: the scheduler's
    :meth:`OverlapScheduler.exchange` under ``HVDT_OVERLAP=on``, else
    ``ops.device.fused_allreduce`` itself (the same object)."""
    sched = get_scheduler()
    return dev.fused_allreduce if sched is None else sched.exchange


def reset() -> None:
    """Drop the cached scheduler (test isolation)."""
    global _cached_env, _cached_scheduler
    with _lock:
        _cached_env = "\0unset"
        _cached_scheduler = None


# ---------------------------------------------------------------------------
# Accounting: bytes issued with work left to hide under, against the total.
# ---------------------------------------------------------------------------

_acct_lock = threading.Lock()
_acct_hidden = 0.0
_acct_total = 0.0
_last_schedule: Optional[dict] = None


def _account(bucket_bytes: List[int], wire: str) -> None:
    global _acct_hidden, _acct_total, _last_schedule
    total = float(sum(bucket_bytes))
    # Every bucket but the last issued still has backward compute (or
    # pipelined updates) to run under it; the last has nothing left.
    hidden = float(sum(bucket_bytes[:-1])) if len(bucket_bytes) > 1 else 0.0
    with _acct_lock:
        _acct_hidden += hidden
        _acct_total += total
        _last_schedule = {
            "buckets": len(bucket_bytes),
            "bucket_bytes": list(bucket_bytes),
            "hidden_buckets": max(0, len(bucket_bytes) - 1),
            "wire": wire,
        }
    from ..telemetry import instrument as _ti

    rec = _ti.get_recorder()
    if rec is not None:
        rec.observe_overlap(hidden, total)


def overlap_fraction() -> Optional[float]:
    """Collective bytes issued with work left to hide under, over all
    collective bytes, cumulative over every overlapped exchange of this
    process (the reference's byte-weighted proxy); None before any."""
    with _acct_lock:
        if _acct_total <= 0:
            return None
        return _acct_hidden / _acct_total


def last_schedule() -> Optional[dict]:
    """Bucket plan of the most recent overlapped exchange."""
    with _acct_lock:
        return dict(_last_schedule) if _last_schedule else None


def reset_accounting() -> None:
    global _acct_hidden, _acct_total, _last_schedule
    with _acct_lock:
        _acct_hidden = _acct_total = 0.0
        _last_schedule = None


# ---------------------------------------------------------------------------
# Schedule planning
# ---------------------------------------------------------------------------


def overlap_schedule(leaves: Sequence[torch.Tensor],
                     threshold_bytes: Optional[int] = None
                     ) -> List[List[int]]:
    """Reverse-topological bucket plan: ``fused_allreduce_buckets`` over
    the reversed leaves, mapped back to the original indices (bucket 0
    holds the leaves whose gradients the backward produces first)."""
    threshold_bytes = dev._validated_threshold(threshold_bytes)
    n = len(leaves)
    rev = list(reversed(list(leaves)))
    return [[n - 1 - i for i in b]
            for b in dev.fused_allreduce_buckets(rev, threshold_bytes)]


# ---------------------------------------------------------------------------
# Issue and finish
# ---------------------------------------------------------------------------

_comm_streams: Dict[torch.device, torch.cuda.Stream] = {}


def _comm_stream(device: torch.device) -> torch.cuda.Stream:
    """The dedicated communication stream of ``device`` (one a device a
    process, made at first use)."""
    s = _comm_streams.get(device)
    if s is None:
        s = _comm_streams[device] = torch.cuda.Stream(device)
    return s


class _Issued:
    """One issued bucket: its leaves and its started reduction."""

    __slots__ = ("ids", "parts", "bucket", "done")

    def __init__(self, ids, parts, bucket):
        self.ids, self.parts, self.bucket = ids, parts, bucket
        self.done = None            # CUDA event after the comm-side finish


class _Pipeline:
    """Issues the buckets of one exchange in order on the communication
    stream and finishes them in the same order (module docstring).  How
    each bucket is reduced is ``ops.device``'s ``_BucketRoute``, the
    routing ``fused_allreduce`` runs.

    ``issue`` packs a bucket and starts its collective (a plain bucket's
    ``all_reduce`` with ``async_op=True``), then runs the previous
    bucket's comm-side finish half.  ``drain`` waits for each bucket in
    order on the caller's stream and yields its reduced leaves, then
    joins the communication stream into the caller's."""

    def __init__(self, op: ReduceOp, threshold_bytes: Optional[int],
                 prescale_factor: float, postscale_factor: float,
                 wire_dtype: Optional[Any], process_set: Optional[ProcessSet],
                 axis=None, mesh=None):
        self.route = dev._BucketRoute(op, threshold_bytes, prescale_factor,
                                      postscale_factor, wire_dtype,
                                      process_set, axis, mesh)
        self.threshold = self.route.threshold
        self.issued: List[_Issued] = []
        self.finished = 0           # comm-side finishes done (in order)
        self.bucket_bytes: List[int] = []
        self.device: Optional[torch.device] = None
        self.comm: Optional[torch.cuda.Stream] = None

    # -- streams ------------------------------------------------------------

    def _fork(self, device: torch.device):
        """Make the communication stream wait for the work issued so far
        on the current stream (a no-op off the card); returns the context
        to issue under."""
        if device.type != "cuda":
            return contextlib.nullcontext()
        if self.comm is None:
            self.device = device
            self.comm = _comm_stream(device)
        self.comm.wait_stream(torch.cuda.current_stream(device))
        return torch.cuda.stream(self.comm)

    # -- issue --------------------------------------------------------------

    def issue(self, ids: Sequence[int], parts: Sequence[torch.Tensor]) -> None:
        with self._fork(parts[0].device):
            flat = torch.cat([p.detach().reshape(-1) for p in parts])
            self.bucket_bytes.append(self.route.wire_bytes(flat))
            self.issued.append(_Issued(list(ids), list(parts),
                                       self.route.start(
                                           flat, async_op=True,
                                           count=len(parts),
                                           index=len(self.issued))))
            # The previous bucket's finish half goes after this start.
            self._finish_comm(len(self.issued) - 1)

    def _finish_comm(self, upto: int) -> None:
        """Run the comm-side finish of every issued bucket before index
        ``upto``, in order, on the communication stream."""
        while self.finished < upto:
            it = self.issued[self.finished]
            self.route.finish_comm(it.bucket)
            if self.comm is not None and it.bucket.kind != "async":
                it.done = torch.cuda.Event()
                it.done.record(self.comm)
            self.finished += 1

    # -- finish -------------------------------------------------------------

    def drain(self):
        """Yield ``(leaf ids, parts, reduced leaves)`` bucket by bucket in
        schedule order, each waited for on the caller's current stream,
        then join the communication stream into it."""
        with (torch.cuda.stream(self.comm) if self.comm is not None
              else contextlib.nullcontext()):
            self._finish_comm(len(self.issued))
        for it in self.issued:
            if it.done is not None:
                torch.cuda.current_stream(self.device).wait_event(it.done)
            red = self.route.finish(it.bucket)
            out, off = [], 0
            for p in it.parts:
                out.append(red[off:off + p.numel()].view(p.shape))
                off += p.numel()
            yield it.ids, it.parts, out
        if self.comm is not None:
            torch.cuda.current_stream(self.device).wait_stream(self.comm)
        from ..quant.collectives import wire_sentinel

        r = self.route
        _account(self.bucket_bytes,
                 "hierarchical" if r.hier
                 else wire_sentinel(r.quant_leg)
                 if r.quant_leg is not None else "exact")


def _exchange(tensors, op, threshold_bytes, prescale_factor,
              postscale_factor, wire_dtype, process_set, axis, mesh,
              leaf_finish=None) -> List[Any]:
    """Issue every bucket of the reverse-topological plan, then finish
    them in order; ``leaf_finish(i, reduced)`` (default: identity) runs
    on each leaf as its bucket is waited for."""
    pipe = _Pipeline(op, threshold_bytes, prescale_factor, postscale_factor,
                     wire_dtype, process_set, axis, mesh)
    for ids in overlap_schedule(tensors, pipe.threshold):
        pipe.issue(ids, [tensors[i] for i in ids])
    cells: List[Any] = [None] * len(tensors)
    for ids, _, reds in pipe.drain():
        for i, r in zip(ids, reds):
            cells[i] = r if leaf_finish is None else leaf_finish(i, r)
    return cells


class OverlapScheduler:
    """The ``HVDT_OVERLAP=on`` exchange: a drop-in for
    ``ops.device.fused_allreduce`` (same signature and semantics) with
    the reverse-topological, pipelined schedule.  Stateless."""

    def exchange(self, tensors: Sequence[torch.Tensor],
                 op: ReduceOp = ReduceOp.AVERAGE,
                 threshold_bytes: Optional[int] = None,
                 prescale_factor: float = 1.0,
                 postscale_factor: float = 1.0,
                 wire_dtype: Optional[Any] = None,
                 process_set: Optional[ProcessSet] = None, *,
                 axis=None, mesh=None) -> List[torch.Tensor]:
        tensors = list(tensors)
        if not tensors:
            return []
        return _exchange(tensors, op, threshold_bytes, prescale_factor,
                         postscale_factor, wire_dtype, process_set, axis,
                         mesh)


# ---------------------------------------------------------------------------
# The hooked exchange of DistributedOptimizer
# ---------------------------------------------------------------------------


def _weak_hook(ref, p: torch.Tensor) -> None:
    exchange = ref()
    if exchange is not None:
        exchange._hook(p)


def _remove(handles) -> None:
    for h in handles:
        h.remove()


class HookedExchange:
    """Issues a ``DistributedOptimizer``'s buckets from gradient hooks.

    The plan is :func:`overlap_schedule` over the wrapped optimizer's
    parameters that require a gradient.  Each parameter gets a
    ``register_post_accumulate_grad_hook``; on the passes that
    communicate (``owner._hook_pass()``), the hook lets the owner fold
    and transform the gradient (``owner._hook_grad(p)``: the boundary
    pass's accumulation, error feedback's compensation) and marks it
    ready; a bucket is issued when all its gradients are ready and every
    bucket before it has been issued.  :meth:`finish` issues the rest
    (the owner has given every parameter without a gradient a zero one),
    waits in order and copies the reduced values into ``.grad``.  A
    second gradient for a parameter already ready on this pass raises,
    as upstream Horovod's hook does: its bucket may be in flight."""

    def __init__(self, owner, params: Sequence[torch.Tensor]):
        self.owner = owner
        self.params = [p for p in params if p.requires_grad]
        self.plan = overlap_schedule(self.params, owner._threshold)
        self.bucket_of = {}
        for b, ids in enumerate(self.plan):
            for i in ids:
                self.bucket_of[self.params[i]] = b
        # The hooks hold this object weakly, so a dropped optimizer's
        # hooks go with it (a live one's stay until remove()).
        ref = weakref.ref(self)
        self._handles = [p.register_post_accumulate_grad_hook(
            functools.partial(_weak_hook, ref)) for p in self.params]
        self._finalizer = weakref.finalize(self, _remove, self._handles)
        self._lock = threading.Lock()
        self._begin()

    def _begin(self) -> None:
        self.ready: set = set()
        self.remaining = [len(ids) for ids in self.plan]
        self.next_issue = 0
        self.pipe: Optional[_Pipeline] = None

    def in_flight(self) -> bool:
        """Whether this pass's hooks have marked gradients ready that no
        ``finish`` has exchanged yet."""
        return bool(self.ready)

    def remove(self) -> None:
        """Unregister the hooks (an optimizer that stops overlapping)."""
        self._finalizer()

    def _pipeline(self) -> _Pipeline:
        if self.pipe is None:
            o = self.owner
            self.pipe = _Pipeline(o._op, o._threshold, o._prescale,
                                  o._postscale,
                                  o._compression.wire_dtype,
                                  o._process_set)
        return self.pipe

    def _hook(self, p: torch.Tensor) -> None:
        if not self.owner._hook_pass():
            return
        with self._lock, torch.no_grad():
            if p in self.ready:
                # Its bucket may already be packed and in flight: the new
                # gradient would be dropped, or race with the packing.
                raise RuntimeError(
                    "a gradient was computed more than "
                    "backward_passes_per_step times before step(): under "
                    "HVDT_OVERLAP=on each backward pass's gradients are "
                    "exchanged as they land; raise backward_passes_per_step "
                    "to accumulate gradients locally")
            self.owner._hook_grad(p)
            self.ready.add(p)
            self.remaining[self.bucket_of[p]] -= 1
            while (self.next_issue < len(self.plan)
                   and self.remaining[self.next_issue] == 0):
                self._issue(self.next_issue)

    def _issue(self, b: int) -> None:
        ids = list(self.plan[b])
        self._pipeline().issue(ids, [self.params[i].grad for i in ids])
        self.next_issue = b + 1

    @torch.no_grad()
    def finish(self) -> None:
        """Issue the buckets no hook issued, wait for every bucket in
        order and copy the results into ``.grad``."""
        try:
            while self.next_issue < len(self.plan):
                self._issue(self.next_issue)
            if self.pipe is not None:
                for ids, parts, reds in self.pipe.drain():
                    for g, r in zip(parts, reds):
                        g.copy_(r)
        finally:
            self._begin()


# ---------------------------------------------------------------------------
# Pipelined exchange and update
# ---------------------------------------------------------------------------


def exchange_and_update(grads: Sequence[torch.Tensor],
                        leaf_update: Callable, aux_trees: Sequence = (),
                        op: ReduceOp = ReduceOp.AVERAGE, *,
                        threshold_bytes: Optional[int] = None,
                        prescale_factor: float = 1.0,
                        postscale_factor: float = 1.0,
                        wire_dtype: Optional[Any] = None,
                        process_set: Optional[ProcessSet] = None,
                        axis=None, mesh=None):
    """The pipelined exchange fused with a per-leaf update: bucket N's
    ``leaf_update(reduced_grad, *aux_leaves)`` runs after N's wait while
    N+1 is in flight.  ``aux_trees`` are lists congruent with ``grads``
    (momentum buffers, params).  Returns a list like ``grads``, or a
    tuple of such lists when ``leaf_update`` returns tuples."""
    grads = list(grads)
    if not grads:
        return grads
    aux = [list(t) for t in aux_trees]
    cells = _exchange(grads, op, threshold_bytes, prescale_factor,
                      postscale_factor, wire_dtype, process_set, axis, mesh,
                      leaf_finish=lambda i, g: leaf_update(
                          g, *[a[i] for a in aux]))
    if isinstance(cells[0], (tuple, list)):
        return tuple([c[j] for c in cells] for j in range(len(cells[0])))
    return cells


class PipelinedSGD(FusedSGD):
    """``fused_sgd`` whose ``step()`` first exchanges the gradients in
    reverse-topological buckets and steps each bucket's leaves as soon as
    that bucket has been waited for: one launch of kernel #2 a bucket
    (per param group and dtype) while the next bucket is in flight.  Same
    state as ``FusedSGD`` (``{"trace": m}``), so the two swap mid-run;
    ``.grad`` holds the reduced gradients afterwards, as under
    ``DistributedOptimizer``."""

    _MAX_PLANS = 256        # a cached table set per bucket

    def __init__(self, params, learning_rate: float, momentum: float = 0.0,
                 nesterov: bool = False, *,
                 op: ReduceOp = ReduceOp.AVERAGE,
                 threshold_bytes: Optional[int] = None,
                 wire_dtype: Optional[Any] = None,
                 process_set: Optional[ProcessSet] = None,
                 use_kernels: bool = True):
        super().__init__(params, learning_rate, momentum, nesterov,
                         use_kernels=use_kernels)
        self.exchange_op = ReduceOp(op)
        self.threshold_bytes = threshold_bytes
        self.wire_dtype = wire_dtype
        self.process_set = process_set

    @torch.no_grad()
    def step(self, closure: Optional[Callable[[], Any]] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        leaves = [p for _, p in self._leaves if p.grad is not None]
        grads = [p.grad for p in leaves]
        if not leaves:
            return loss
        pipe = _Pipeline(self.exchange_op, self.threshold_bytes, 1.0, 1.0,
                         self.wire_dtype, self.process_set)
        for ids in overlap_schedule(grads, pipe.threshold):
            pipe.issue(ids, [grads[i] for i in ids])
        try:
            for p in leaves:
                p.grad = None
            for ids, parts, reds in pipe.drain():
                for i, g, r in zip(ids, parts, reds):
                    g.copy_(r)
                    leaves[i].grad = g
                super().step()      # this bucket's leaves only
                for i in ids:
                    leaves[i].grad = None
        finally:
            for p, g in zip(leaves, grads):
                p.grad = g
        return loss


def pipelined_sgd(params, learning_rate: float, momentum: float = 0.0,
                  nesterov: bool = False, *,
                  op: ReduceOp = ReduceOp.AVERAGE,
                  threshold_bytes: Optional[int] = None,
                  wire_dtype: Optional[Any] = None,
                  process_set: Optional[ProcessSet] = None,
                  use_kernels: bool = True):
    """``DistributedOptimizer(fused_sgd(...))`` with the exchange and the
    momentum update pipelined per bucket (:class:`PipelinedSGD`): the
    same state, the same f32 math, each bucket's update one kernel #2
    launch after its wait while the next bucket is in flight.  A float
    learning rate only, as ``fused_sgd``."""
    if callable(learning_rate):
        raise ValueError(
            "pipelined_sgd takes a float learning_rate (its state carries "
            "no step count for a schedule); see fused_adam for schedule "
            "support")
    return PipelinedSGD(
        params, learning_rate, momentum, nesterov, op=op,
        threshold_bytes=threshold_bytes, wire_dtype=wire_dtype,
        process_set=process_set, use_kernels=use_kernels)


# ---------------------------------------------------------------------------
# Segmented backward
# ---------------------------------------------------------------------------


def overlap_value_and_grad(stage_fns: Sequence[Callable],
                           op: ReduceOp = ReduceOp.AVERAGE, *,
                           threshold_bytes: Optional[int] = None,
                           prescale_factor: float = 1.0,
                           postscale_factor: float = 1.0,
                           wire_dtype: Optional[Any] = None,
                           process_set: Optional[ProcessSet] = None,
                           reduce_grads: bool = True,
                           axis=None, mesh=None) -> Callable:
    """Value and gradients of a chain of stages with each stage's
    gradient exchange issued as soon as its backward segment has run.

    ``stage_fns``: ``f_i(params_i, x) -> x`` with ``params_i`` a list of
    tensors; the last stage returns a scalar loss.  Returns ``fn(
    params_seq, x) -> (loss, grads_seq)``, ``grads_seq[i]`` stage i's
    gradients (a list like ``params_i``), averaged (``op``) over the
    process set: stage i's buckets are issued between backward segment
    i and segment i-1, and all are waited for at the end, in issue
    order; under ``HVDT_ZERO`` each bucket is reduce-scattered instead
    and all-gathered as it is waited for (``ops/zero.py``).
    ``reduce_grads=False`` skips the exchange (the raw local
    gradients)."""
    stage_fns = tuple(stage_fns)
    if not stage_fns:
        raise ValueError("overlap_value_and_grad needs at least one stage")

    def fn(params_seq, x):
        params_seq = [list(p) for p in params_seq]
        if len(params_seq) != len(stage_fns):
            raise ValueError(
                f"{len(params_seq)} param lists for {len(stage_fns)} stages")
        ins, outs = [], []
        act = x
        with torch.enable_grad():
            for f, p in zip(stage_fns, params_seq):
                a_in = act.detach().requires_grad_(act.is_floating_point())
                ins.append(a_in)
                act = f(p, a_in)
                outs.append(act)
        loss = act
        if loss.dim() != 0:
            raise ValueError("the last stage must return a scalar loss")
        pipes: List[Tuple[int, _Pipeline, List[torch.Tensor]]] = []
        grads: List[Any] = [None] * len(stage_fns)
        ct = torch.ones_like(loss)
        for i in reversed(range(len(stage_fns))):
            want_in = i > 0 and ins[i].requires_grad
            inputs = params_seq[i] + ([ins[i]] if want_in else [])
            got = torch.autograd.grad(outs[i], inputs, grad_outputs=ct,
                                      allow_unused=True)
            g_p = [torch.zeros_like(p) if g is None else g
                   for p, g in zip(params_seq[i], got)]
            if want_in:
                ct = got[-1]
            grads[i] = g_p
            if reduce_grads and g_p:
                from . import zero

                if zero.stage() is not None:
                    pipe = zero._SegmentExchange(
                        g_p, op, threshold_bytes, prescale_factor,
                        postscale_factor, wire_dtype, process_set, axis,
                        mesh)
                else:
                    pipe = _Pipeline(op, threshold_bytes, prescale_factor,
                                     postscale_factor, wire_dtype,
                                     process_set, axis, mesh)
                    for ids in overlap_schedule(g_p, pipe.threshold):
                        pipe.issue(ids, [g_p[j] for j in ids])
                pipes.append((i, pipe, g_p))
        for i, pipe, g_p in pipes:
            out = list(g_p)
            for ids, _, reds in pipe.drain():
                for j, r in zip(ids, reds):
                    out[j] = r
            grads[i] = out
        return loss.detach(), grads

    return fn


# ---------------------------------------------------------------------------
# The reference's XLA latency-hiding knob
# ---------------------------------------------------------------------------

_LATENCY_MODES = ("auto", "on", "off", "0", "1", "false", "true", "none",
                  "no", "yes")


def enable_latency_hiding(mode: Optional[str] = None) -> Optional[str]:
    """The reference's ``HVDT_XLA_LATENCY_HIDING`` (auto|on|off): there it
    appends XLA:TPU flags to ``LIBTPU_INIT_ARGS``.  The port has no XLA;
    its overlap comes from ``HVDT_OVERLAP``'s hooks.  The mode is
    validated and nothing is set: returns None, as the reference's
    ``auto`` does off a TPU."""
    if mode is None:
        mode = config.get_str("HVDT_XLA_LATENCY_HIDING")
    mode = (mode or "auto").strip().lower()
    if mode not in _LATENCY_MODES:
        raise ValueError(
            f"unknown HVDT_XLA_LATENCY_HIDING mode {mode!r}; valid: auto, "
            "on, off")
    return None
