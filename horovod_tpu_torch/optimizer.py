"""DistributedOptimizer — the gradient-averaging wrapper.

The PyTorch counterpart of the JAX package's ``optimizer.py``.  It wraps
a ``torch.optim.Optimizer``; before the wrapped ``step()`` it averages
every parameter's ``.grad`` over the world in fused buckets
(``ops/device.fused_allreduce``: one flat buffer and one ``all_reduce``
per bucket, copied back into the gradients).

``backward_passes_per_step=k`` accumulates the gradients of k calls to
``step()`` locally, in f32, and only the k-th call communicates their
mean and steps the wrapped optimizer; the other calls issue no
collective and leave the parameters unchanged (the update ``optax.
MultiSteps`` gives in the JAX package, without its per-pass exchange).
:func:`microbatch_gradients` is the same accumulation inside one step:
k micro-batches, one exchange.

``compression`` picks the wire: ``Compression.none`` / ``.fp16`` /
``.bf16`` cast each bucket, ``.int8`` / ``.int4`` send each float bucket
through the two-stage block-scaled quantized allreduce
(``quant/collectives.py``); pair those with ``quant.with_error_feedback``.
Left unset, it is read from the environment (``HVDT_COMPRESSION``,
``HVDT_QUANT``) by ``Compression.from_env()``, as in the JAX package.

Inside a CUDA-graph capture (``step_pipeline.donated_step``) the pass
count advances in a replay hook, once a replay.  With
``backward_passes_per_step=k > 1`` the step differs by pass (the first
pass of a cycle copies into the accumulators, the k-th exchanges and
steps), so ``donated_step`` captures one graph per pass of the cycle,
keyed by :meth:`_DistributedOptimizer._graph_phase`, and replays the
one for the pass at hand: the non-boundary graphs hold no collective.
A captured pass replays a fixed set of gradients, so under a capture
every accumulated parameter needs a gradient on every pass (eagerly a
gradient may come and go).  The int8/int4 wire runs inside a capture as it runs eagerly.

``op=hvd.Adasum`` combines each fused bucket with Adasum
(``ops/adasum.py``) instead of averaging it.

``HVDT_OVERLAP=on`` (``ops/overlap.py``) overlaps the exchange with the
backward: a ``register_post_accumulate_grad_hook`` on every parameter
issues each reverse-topological bucket's collective, on a communication
stream, as soon as its last gradient lands (buckets strictly in schedule
order on every rank), and ``step()`` waits, copies back and steps.
Under ``backward_passes_per_step=k > 1`` only the k-th pass
communicates: its hooks fold each gradient into the accumulator and
issue the mean.  Inside a ``donated_step`` capture the hooks, the
communication stream's fork and its join are captured with the step.
``quant.with_error_feedback`` compensates each gradient in its hook,
before the bucket is issued.  A second gradient for a parameter before
``step()`` on a pass that communicates raises, and so does ``zero_grad()``
between ``backward()`` and ``step()``, as in upstream Horovod.  With the
knob unset no hook is registered and ``step()`` runs the exchange as
before.

``zero=`` (default: ``HVDT_ZERO``) shards the exchange and the state
(``ops/zero.py``).  ``"grads"``: each bucket is reduce-scattered and
all-gathered instead of all-reduced (any ``torch.optim`` optimizer; under
``HVDT_OVERLAP=on`` the hooks issue each bucket's reduce-scatter).
``"states"`` / ``"params"``: the wrapped ``fused_sgd`` / ``fused_adam``
gives only its hyperparameters; the returned object keeps each rank's
1/n rows of the moments (its full moments are dropped), and ``step()``
reduce-scatters every bucket, runs #1/#2 on the rank's rows (one launch
a step, or one a bucket as each bucket's wait completes under
``HVDT_OVERLAP=on``) and writes the parameters: under ``"states"`` the
all-gathered deltas are added to them; under ``"params"`` the parameters
live as rank rows between steps (``.pshards``), updated in place, and
:meth:`_ZeroStatesOptimizer.gather_params` writes the full parameters
into the module before the forward.  ``backward_passes_per_step``
accumulates as above and communicates on the boundary pass only; a
``donated_step`` captures the whole sharded step.  With ``HVDT_ZERO``
unset and ``zero=None`` the object is the one built without ZeRO.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from .common import graphs
from .common.process_sets import ProcessSet
from .common.types import ReduceOp
from .ops import device as dev
from .ops.compression import Compression, Compressor

__all__ = ["DistributedOptimizer", "allreduce_gradients",
           "microbatch_gradients"]

def _check_supported(op: ReduceOp) -> None:
    if ReduceOp(op) not in (ReduceOp.AVERAGE, ReduceOp.SUM,
                            ReduceOp.ADASUM):
        raise ValueError(f"Unsupported gradient reduce op: {op}")


def allreduce_gradients(grads: Sequence[torch.Tensor],
                        op: ReduceOp = ReduceOp.AVERAGE,
                        compression: Optional[Compressor] = None,
                        threshold_bytes: Optional[int] = None,
                        prescale_factor: float = 1.0,
                        postscale_factor: float = 1.0,
                        process_set: Optional[ProcessSet] = None
                        ) -> List[torch.Tensor]:
    """Fused gradient allreduce for custom update loops: the reduced
    tensors, in input order.  ``compression=None`` reads the
    environment (``Compression.from_env()``)."""
    _check_supported(op)
    if compression is None:
        compression = Compression.from_env()
    return dev.fused_allreduce(
        grads, op=op, threshold_bytes=threshold_bytes,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        wire_dtype=compression.wire_dtype, process_set=process_set)


def _tree_chunk(tree, i: int, k: int):
    """Micro-batch ``i`` of ``k`` of a batch: every tensor leaf of a
    tensor / list / tuple / dict cut into k equal slices on its leading
    axis."""
    if isinstance(tree, torch.Tensor):
        if tree.dim() == 0 or tree.shape[0] % k:
            raise ValueError(f"a batch leaf of shape {tuple(tree.shape)} "
                             f"does not split into {k} micro-batches")
        n = tree.shape[0] // k
        return tree[i * n:(i + 1) * n]
    if isinstance(tree, dict):
        return {key: _tree_chunk(v, i, k) for key, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_chunk(v, i, k) for v in tree)
    return tree


def microbatch_gradients(grad_fn: Callable, params: Sequence[torch.Tensor],
                         batch: Any, num_microbatches: int, *,
                         op: ReduceOp = ReduceOp.AVERAGE,
                         compression: Optional[Compressor] = None,
                         threshold_bytes: Optional[int] = None,
                         process_set: Optional[ProcessSet] = None
                         ) -> List[torch.Tensor]:
    """Accumulate gradients over micro-batches, then communicate once.

    ``grad_fn(params, microbatch)`` returns the gradients of ``params``
    (a list of tensors, in order) on one micro-batch; ``batch`` is a
    tensor or a list / tuple / dict of them whose leading axis splits
    into ``num_microbatches`` equal slices.  Floating gradients are
    summed in f32 (the first micro-batch's copied, the others added),
    integer ones in their own dtype; the sum is divided by k and cast
    once to each parameter's dtype, then averaged (``op``) over the
    process set by one :func:`allreduce_gradients`.  ``compression``
    defaults to ``Compression.none``, as in the JAX package (the
    environment is not read).  Returns the communicated gradients, in
    ``params`` order."""
    k = int(num_microbatches)
    if k < 1:
        raise ValueError(f"num_microbatches must be >= 1, got {k}")
    params = list(params)
    acc: List[torch.Tensor] = []
    for i in range(k):
        grads = list(grad_fn(params, _tree_chunk(batch, i, k)))
        if len(grads) != len(params):
            raise ValueError(f"grad_fn returned {len(grads)} gradients for "
                             f"{len(params)} parameters")
        with torch.no_grad():
            if not acc:
                acc = [g.to(torch.float32 if p.is_floating_point()
                            else p.dtype, copy=True)
                       for g, p in zip(grads, params)]
            else:
                for a, g in zip(acc, grads):
                    a.add_(g)
    with torch.no_grad():
        total = [(a / k).to(p.dtype) for a, p in zip(acc, params)]
    return allreduce_gradients(total, op=op,
                               compression=compression or Compression.none,
                               threshold_bytes=threshold_bytes,
                               process_set=process_set)


class _DistributedOptimizer:
    """The wrapper ``DistributedOptimizer`` returns.  Attribute access it
    does not define (``param_groups``, ``state``, ``state_dict``, ...)
    goes to the wrapped optimizer."""

    def __init__(self, optimizer: torch.optim.Optimizer, op: ReduceOp,
                 compression: Compressor, backward_passes_per_step: int,
                 threshold_bytes: Optional[int], prescale_factor: float,
                 postscale_factor: float,
                 process_set: Optional[ProcessSet]):
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self.optimizer = optimizer
        self._op = op
        self._compression = compression
        self._k = int(backward_passes_per_step)
        self._threshold = threshold_bytes
        self._prescale = prescale_factor
        self._postscale = postscale_factor
        self._process_set = process_set
        self._passes = 0
        self._acc: Dict[torch.Tensor, torch.Tensor] = {}
        # Eager passes only: the parameters with a gradient so far in
        # this cycle, in order (a dict as an ordered set).
        self._seen: Dict[torch.Tensor, None] = {}
        # HVDT_OVERLAP=on: the hooked exchange, the parameters its hooks
        # folded (boundary pass, k > 1) and transformed (error feedback's
        # per-parameter compensation, set by the wrapper) this pass.
        self._pre_exchange: Optional[Callable[[torch.Tensor], None]] = None
        self._folded: set = set()
        self._transformed: set = set()
        self._hooked = None
        from .ops import overlap

        if overlap.enabled():
            self._hooked = self._hooked_exchange(
                [p for g in optimizer.param_groups for p in g["params"]])

    def _hooked_exchange(self, params):
        """The exchange the gradient hooks issue (``HVDT_OVERLAP=on``)."""
        from .ops import overlap

        return overlap.HookedExchange(self, params)

    def set_overlap(self, on: bool) -> None:
        """Register (or remove) the gradient hooks of the overlapped
        exchange after construction, as ``HVDT_OVERLAP`` would have at
        construction: the autotuner's overlap dimension over one
        optimizer.  A graphed step must be captured again after a
        change."""
        if on and self._hooked is None:
            self._hooked = self._hooked_exchange(
                [p for g in self.optimizer.param_groups
                 for p in g["params"]])
        elif not on and self._hooked is not None:
            if self._hooked.in_flight():
                raise RuntimeError("set_overlap() between backward() and "
                                   "step(): buckets are in flight")
            self._hooked.remove()
            self._hooked = None

    def __getattr__(self, name: str):
        return getattr(self.__dict__["optimizer"], name)

    def _params_with_grad(self) -> List[torch.Tensor]:
        return [p for g in self.optimizer.param_groups for p in g["params"]
                if p.grad is not None]

    def synchronize(self) -> None:
        """Average (or sum) every ``.grad`` over the process set, in
        place, as fused bucket collectives (under ``HVDT_OVERLAP=on``:
        issue the buckets no hook issued and wait for all)."""
        if self._hooked is not None:
            self._hooked.finish()
            return
        params = self._params_with_grad()
        reduced = allreduce_gradients(
            [p.grad for p in params], op=self._op,
            compression=self._compression, threshold_bytes=self._threshold,
            prescale_factor=self._prescale,
            postscale_factor=self._postscale, process_set=self._process_set)
        with torch.no_grad():
            for p, r in zip(params, reduced):
                p.grad.copy_(r)

    def _fold(self, p: torch.Tensor, phase: int, capturing: bool) -> None:
        """Fold ``p``'s gradient of pass ``phase`` into its f32
        accumulator: a parameter's first gradient of the cycle is copied,
        later ones are added."""
        acc = self._acc.get(p)
        if acc is None:
            acc = self._acc[p] = torch.empty(
                p.shape, dtype=torch.float32, device=p.grad.device)
        first = phase == 0 if capturing else p not in self._seen
        if first:
            acc.copy_(p.grad)
        else:
            acc.add_(p.grad)
        if not capturing:
            self._seen[p] = None

    def _set_mean(self, p: torch.Tensor) -> None:
        """Set ``p.grad`` to the cycle's accumulated sum over k, in
        ``p``'s dtype (created where the last pass left it None)."""
        mean = (self._acc[p] / self._k).to(p.dtype)
        if p.grad is None:
            p.grad = mean
        else:
            p.grad.copy_(mean)

    def _accumulate(self, phase: int) -> bool:
        """Fold this pass's grads into the f32 accumulators, pass
        ``phase`` (0 to k-1) of a cycle.  The accumulators are allocated
        once and kept, so a captured pass reads and writes the same
        memory as an eager one.  True on the k-th pass, with the grad of
        every parameter that had one in the cycle set to the accumulated
        sum over k, in its dtype.  Parameters a hook already folded this
        pass (``HVDT_OVERLAP=on``) are skipped.

        Eagerly a gradient may come and go from pass to pass; a captured
        pass replays a fixed set, so under a capture every accumulated
        parameter must have a gradient on every pass."""
        capturing = graphs.capturing()
        with torch.no_grad():
            params = self._params_with_grad()
            if capturing and set(params) != set(self._acc):
                raise RuntimeError(
                    "a gradient appeared inside a CUDA-graph capture that "
                    "no eager pass produced, or one that an eager pass "
                    "produced is missing; run every pass of a cycle "
                    "eagerly first, with every parameter given a gradient "
                    "on every pass")
            for p in params:
                if p not in self._folded:
                    self._fold(p, phase, capturing)
            if phase < self._k - 1:
                return False
            for p in list(self._acc if capturing else self._seen):
                if p not in self._folded:
                    self._set_mean(p)
            self._seen.clear()
        return True

    def _hook_pass(self) -> bool:
        """Whether the backward now running communicates (every pass
        when k = 1, the k-th of a cycle otherwise)."""
        return self._graph_phase() == self._k - 1

    def _hook_grad(self, p: torch.Tensor) -> None:
        """What a hook does to ``p``'s fresh gradient before it is
        marked ready: error feedback's compensation, then on a k > 1
        boundary pass the fold and the mean."""
        if self._pre_exchange is not None:
            self._pre_exchange(p)
            self._transformed.add(p)
        if self._k > 1:
            self._fold(p, self._k - 1, graphs.capturing())
            self._set_mean(p)
            self._folded.add(p)

    def _graph_phase(self) -> int:
        """Passes done in the current cycle of k: what the next
        ``step()`` does depends on it, so ``donated_step`` keeps one
        graph for each value."""
        return self._passes % self._k

    def step(self, closure: Optional[Callable[[], Any]] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        phase = self._graph_phase()
        if graphs.capturing():
            graphs.on_replay(self._count_pass)
        else:
            self._count_pass()
        try:
            if self._k > 1 and not self._accumulate(phase):
                return loss
            self.synchronize()
        finally:
            self._folded.clear()
            self._transformed.clear()
        self.optimizer.step()
        return loss

    def _count_pass(self) -> None:
        self._passes += 1

    def zero_grad(self, set_to_none: bool = True) -> None:
        if self._hooked is not None and self._hooked.in_flight():
            raise RuntimeError(
                "zero_grad() was called after backward() and before step() "
                "or synchronize() under HVDT_OVERLAP=on: the gradients' "
                "buckets are already being exchanged")
        self.optimizer.zero_grad(set_to_none=set_to_none)


class _ZeroGradsOptimizer(_DistributedOptimizer):
    """``zero="grads"``: the exchange is ``ops.zero.rs_exchange`` (each
    bucket reduce-scattered, then all-gathered into ``.grad``); the
    wrapped optimizer steps as usual."""

    def __init__(self, optimizer, op, compression, backward_passes_per_step,
                 threshold_bytes, prescale_factor, postscale_factor,
                 process_set, *, stage: str, spec=None):
        del stage
        self._zero_axis = spec.axis if spec is not None else None
        super().__init__(optimizer, op, compression, backward_passes_per_step,
                         threshold_bytes, prescale_factor, postscale_factor,
                         process_set)

    def _hooked_exchange(self, params):
        from .ops import zero

        return zero._ZeroHooked.for_grads(self, params, self._zero_axis)

    def synchronize(self) -> None:
        if self._hooked is not None:
            self._hooked.finish()
            return
        from .ops import zero

        params = self._params_with_grad()
        reduced = zero.rs_exchange(
            [p.grad for p in params], op=self._op,
            threshold_bytes=self._threshold, prescale_factor=self._prescale,
            postscale_factor=self._postscale,
            wire_dtype=self._compression.wire_dtype,
            process_set=self._process_set, axis=self._zero_axis)
        with torch.no_grad():
            for p, r in zip(params, reduced):
                p.grad.copy_(r)


class _ZeroStatesOptimizer(_DistributedOptimizer):
    """``zero="states"`` / ``"params"``: the object that owns the sharded
    state (module docstring).  ``transform`` is the
    ``ops.zero.ZeroTransformation``, ``zero_state`` its state (this
    rank's rows), ``pshards`` the parameter rows under ``"params"``."""

    def __init__(self, optimizer, op, compression, backward_passes_per_step,
                 threshold_bytes, prescale_factor, postscale_factor,
                 process_set, *, stage: str, spec=None):
        from .ops import zero

        self._zero_stage = stage
        self._zparams = [p for g in optimizer.param_groups
                         for p in g["params"] if p.requires_grad]
        self.transform = zero.zero_from_optimizer(
            optimizer, stage=stage, axis=spec.axis if spec else None, op=op,
            num_shards=spec.num_shards if spec else None,
            threshold_bytes=threshold_bytes,
            wire_dtype=compression.wire_dtype,
            prescale_factor=prescale_factor,
            postscale_factor=postscale_factor, process_set=process_set)
        # The sharded state replaces the wrapped optimizer's moments.
        for p in self._zparams:
            optimizer.state.pop(p, None)
        optimizer._plans = {}
        self.zero_state = self.transform.init(self._zparams)
        self.pshards = (self.transform.shard_params(self._zparams)
                        if stage == "params" else None)
        super().__init__(optimizer, op, compression, backward_passes_per_step,
                         threshold_bytes, prescale_factor, postscale_factor,
                         process_set)

    def _hooked_exchange(self, params):
        from .ops import zero

        impl = zero._impl(self.transform)
        if impl.group() is None:
            return None              # unbound: no exchange to overlap
        return zero._ZeroHooked(self, params,
                                impl.plan_for(self._zparams), impl.pipeline)

    def synchronize(self) -> None:
        raise RuntimeError(
            "under ZeRO stages 'states'/'params' the reduced gradient is "
            "never materialized: step() exchanges and updates")

    def state_dict(self, *args):
        raise RuntimeError(
            "a ZeRO-sharded optimizer keeps its state as shard rows, not in "
            "the wrapped optimizer's state_dict: save gathered_zero_state() "
            "with checkpoint.save_zero_state and restore it with "
            "load_zero_state()")

    load_state_dict = state_dict

    def step(self, closure: Optional[Callable[[], Any]] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        phase = self._graph_phase()
        if graphs.capturing():
            graphs.on_replay(self._count_pass)
        else:
            self._count_pass()
        try:
            if self._k > 1 and not self._accumulate(phase):
                return loss
            missing = [i for i, p in enumerate(self._zparams)
                       if p.grad is None]
            if missing:
                # The sharded update steps every row of a bucket; the
                # wrapped optimizer would skip these parameters instead.
                raise RuntimeError(
                    f"ZeRO stage {self._zero_stage!r} updates every "
                    f"parameter, but parameters {missing[:8]} (in param "
                    f"group order) have no gradient this step: freeze them "
                    f"(requires_grad=False) before building the optimizer, "
                    f"or give them a zero gradient")
            shards = (self._hooked.shards() if self._hooked is not None
                      else None)
            target = (self._zparams if self._zero_stage == "states"
                      else self.pshards)
            self.transform.update([p.grad for p in self._zparams],
                                  self.zero_state, target, apply=True,
                                  shards=shards)
        finally:
            self._folded.clear()
            self._transformed.clear()
        return loss

    @torch.no_grad()
    def gather_params(self) -> None:
        """Write the full parameters into the module from the shard rows
        (stage ``"params"``; under ``"states"`` the parameters are whole
        already and nothing moves)."""
        if self.pshards is None:
            return
        full = self.transform.gather_params(self.pshards, self._zparams)
        for p, v in zip(self._zparams, full):
            p.copy_(v)

    @torch.no_grad()
    def load_params(self) -> None:
        """Stage ``"params"``: copy the module's current parameters into
        the shard rows in place (after a restore of the parameters)."""
        if self.pshards is not None:
            for dst, src in zip(self.pshards,
                                self.transform.shard_params(self._zparams)):
                dst.copy_(src)

    def zero_metadata(self) -> dict:
        """``ops.zero.state_metadata`` of this optimizer's plan."""
        from .ops import zero

        return zero.state_metadata(self.transform, self._zparams)

    def gathered_zero_state(self):
        """The state with whole ``[n, shard_len]`` stacks (every rank
        calls it: a rank-local state's rows are all-gathered), for
        ``checkpoint.save_zero_state``."""
        return self.transform.gather_state(self.zero_state)

    @torch.no_grad()
    def load_zero_state(self, state) -> None:
        """Copy a whole-stack state (``checkpoint.restore_zero_state``)
        into this optimizer's rows in place: a step captured over them
        replays from the restored values."""
        self.transform.scatter_state(state, self.zero_state)

    def set_rs_wire(self, on: bool) -> None:
        """The autotuner's ZeRO dimension: reduce-scatter wire (True) or
        allreduce and slice (False), over the same state.  A graphed
        step must be captured again after a change."""
        from .ops import zero

        zero._impl(self.transform).rs_wire = bool(on)


def DistributedOptimizer(optimizer: torch.optim.Optimizer, *,
                         op: ReduceOp = ReduceOp.AVERAGE,
                         compression: Optional[Compressor] = None,
                         backward_passes_per_step: int = 1,
                         threshold_bytes: Optional[int] = None,
                         prescale_factor: float = 1.0,
                         postscale_factor: float = 1.0,
                         process_set: Optional[ProcessSet] = None,
                         zero: Optional[Any] = None):
    """Wrap a ``torch.optim.Optimizer`` so gradients are averaged across
    the world before each update::

        opt = hvd.DistributedOptimizer(hvd.fused_sgd(model.parameters(),
                                                     0.01, momentum=0.9))
        loss.backward()
        opt.step()

    Args:
      optimizer: the optimizer to wrap.
      op: Average (default) or Sum.
      compression: the wire of the fused collectives: Compression.none /
        .fp16 / .bf16 (casts) or .int8 / .int4 (the quantized allreduce).
        None (default) reads ``HVDT_COMPRESSION`` / ``HVDT_QUANT``.
      backward_passes_per_step: passes accumulated locally between
        collectives (see module docstring; under ``donated_step`` one
        graph a pass of the cycle).
      threshold_bytes: fusion bucket size; default ``HVDT_FUSION_THRESHOLD``.
      prescale_factor / postscale_factor: scales before / after the sum.
      process_set: the ranks to average over (default: the world).
      zero: ZeRO stage (``ops/zero.py``): ``"grads"``, ``"states"``,
        ``"params"``, ``True`` (the env's stage or ``"states"``), a
        ``zero.ZeroSpec`` (its stage, reduce axis, shard count and
        threshold), or None (default) to read ``HVDT_ZERO``.
    """
    from .ops import zero as _zero

    _check_supported(op)
    stage = _zero.resolve_stage(zero)
    if compression is None:
        compression = Compression.from_env()
    if stage is None:
        return _DistributedOptimizer(optimizer, op, compression,
                                     backward_passes_per_step,
                                     threshold_bytes, prescale_factor,
                                     postscale_factor, process_set)
    if ReduceOp(op) not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(f"ZeRO exchange supports SUM/AVERAGE, got {op}")
    spec = zero if isinstance(zero, _zero.ZeroSpec) else None
    if threshold_bytes is None and spec is not None:
        threshold_bytes = spec.threshold_bytes
    cls = _ZeroGradsOptimizer if stage == "grads" else _ZeroStatesOptimizer
    return cls(optimizer, op, compression, backward_passes_per_step,
               threshold_bytes, prescale_factor, postscale_factor,
               process_set, stage=stage, spec=spec)
