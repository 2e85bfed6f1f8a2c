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
The int8/int4 wire runs inside a capture as it runs eagerly.

Every rank exchanges the same set of parameters: each parameter of the
wrapped optimizer's ``param_groups`` that requires a gradient.  Ranks
may differ in which of them have a gradient (a branch taken on some
ranks only, a module frozen on one); a parameter without one goes in as
zeros, in its own dtype, and holds the reduced gradient as ``.grad``
afterwards, as in the reference's ``interop/torch_optimizer.py``.  A pass
of a ``backward_passes_per_step`` cycle that gives a parameter no
gradient adds zeros to its accumulator.  So the exchanged set is fixed
by construction, and a captured pass replays it.

``op=hvd.Adasum`` combines each fused bucket with Adasum
(``ops/adasum.py``) instead of averaging it.

``axis=`` (a dimension of the current mesh, ``parallel.make_mesh``, or a
tuple of them), ``pipeline=`` and ``expert=`` are the reference's
sharded-axis contract.  The exchange reduces over ``axis``'s group
(default ``"dp"`` when ``pipeline`` or ``expert`` is given) instead of
the world, and an ``axis`` that names the ``pipeline`` or ``expert``
axis raises the reference's ``ValueError``: each member of such an axis
owns different parameters (``parallel.mark_sharded`` records which), so
averaging over it would mix them.  Every rank ends the step holding the
reference's gradient, ``jax.grad`` of the loss averaged over the model
axes (the reference's ``shard_map`` body takes ``lax.pmean`` over them).
Before the exchange over ``axis`` each gradient is folded over the mesh's
other dimensions:

* a leaf replicated over ``ep`` (or ``sp``) is averaged over it: each
  member's backward gave the gradient of its own tokens' loss;
* an expert leaf (sharded over ``expert``) is divided by the axis size:
  the all-to-all's transpose already summed every member's tokens into
  it, and it is never averaged over the axis;
* nothing is folded over ``pipeline``: the pipeline's backward
  (``parallel/pipeline.py``) leaves every stage the reference's gradient
  of its own leaves, and every member the same gradient of a leaf
  replicated over ``pp``;
* nothing is folded over ``tp``: every ``tp`` member computes the same
  loss, and the transformer's conjugate operations leave each member
  the whole gradient of its ``tp``-sharded slice and of every replicated
  leaf, equal on all members;
* ``fsdp`` is a data axis: a leaf replicated over it is averaged over
  it, and a leaf sharded over it (the gather's backward already summed
  every member's gradient of the shard) is divided by its size, as an
  expert leaf is.

Leaves sharded over ``tp`` or ``fsdp`` need no keyword: GSPMD owns those
axes in the reference, whose ``DistributedOptimizer`` has only
``pipeline=`` and ``expert=``.  An ``axis`` that names ``tp`` or ``fsdp``
raises, as one naming ``pipeline`` or ``expert`` does.

ZeRO then shards state within ``axis``'s group only.  Under
``HVDT_OVERLAP=on`` the fold runs after the hooked exchange (both are
linear): on the reduced gradients, or under ZeRO ``states`` / ``params``
on each reduced shard, element by element as its parameter's gradient
would be folded.

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

def _zero_fill(params: Sequence[torch.Tensor]) -> None:
    """Give each of ``params`` that has no gradient a zero one, in its
    dtype and layout, so every rank sends the same buffers."""
    with torch.no_grad():
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


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
                        process_set: Optional[ProcessSet] = None,
                        axis=None) -> List[torch.Tensor]:
    """Fused gradient allreduce for custom update loops: the reduced
    tensors, in input order.  ``compression=None`` reads the
    environment (``Compression.from_env()``); ``axis`` names the reduce
    group a transport policy resolves (``ops.device.fused_allreduce``)."""
    _check_supported(op)
    if compression is None:
        compression = Compression.from_env()
    return dev.fused_allreduce(
        grads, op=op, threshold_bytes=threshold_bytes,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        wire_dtype=compression.wire_dtype, process_set=process_set,
        axis=axis)


class _AxisPlan:
    """What ``DistributedOptimizer(axis=, pipeline=, expert=)`` adds to
    the exchange (module docstring): ``process_set``, the group of
    ``axis``; ``axis``, its name(s); ``plan``, ``[(group or None, scale,
    params)]``, the fold over the other mesh dimensions."""

    def __init__(self, params: Sequence[torch.Tensor], axis, pipeline,
                 expert):
        import torch.distributed as dist

        from .common.basics import current_mesh
        from .common.process_sets import global_process_set
        from .parallel.mesh import (AXIS_FSDP, AXIS_TP, fiber_group,
                                    sharded_axes)

        reduce_axes = (axis,) if isinstance(axis, str) else tuple(axis)
        for kind, sharded in (("pipeline", pipeline), ("expert", expert)):
            if sharded is not None and sharded in reduce_axes:
                raise ValueError(
                    f"{kind}={sharded!r} names a parameter-SHARDED mesh axis "
                    f"but axis={axis!r} would reduce gradients over it — "
                    f"every {sharded} rank owns different parameters, so "
                    "averaging across it destroys them.  Drop it from the "
                    "reduce group (ZeRO then shards state within the "
                    "remaining data-parallel group).")
        mesh = current_mesh()
        if mesh is None:
            raise ValueError("axis= names dimensions of the current mesh: "
                             "build one with parallel.make_mesh")
        names = tuple(mesh.mesh_dim_names)
        size = dict(zip(names, mesh.mesh.shape))
        unknown = [a for a in reduce_axes if a not in names]
        if unknown:
            raise ValueError(f"axis {unknown} not among the current mesh's "
                             f"dimensions {names}")
        for sharded in (AXIS_TP, AXIS_FSDP):
            if sharded in reduce_axes:
                raise ValueError(
                    f"axis={axis!r} names {sharded!r}, a parameter-SHARDED "
                    "mesh axis (the model's tensor-parallel or fully-sharded "
                    f"dimension): every {sharded} rank owns a different part "
                    "of the sharded parameters, so averaging across it "
                    "destroys them.  Reduce over the data-parallel axes; the "
                    f"fold handles {sharded}.")
        self.axis = reduce_axes[0] if len(reduce_axes) == 1 else reduce_axes
        gps = global_process_set()
        if set(reduce_axes) == set(names):
            self.process_set = gps
        else:
            group = fiber_group(mesh, reduce_axes)
            self.process_set = ProcessSet(
                dist.get_process_group_ranks(group), -1, gps._topo, group)
        declared = {a for a in (pipeline, expert) if a is not None}
        declared |= {AXIS_TP, AXIS_FSDP}
        folded = [d for d in names if d not in reduce_axes
                  and d not in (pipeline, AXIS_TP) and size[d] > 1]
        plan: Dict[tuple, List[torch.Tensor]] = {}
        for p in params:
            sharded = sharded_axes(p)
            undeclared = [a for a in sharded if a not in declared]
            if undeclared:
                raise ValueError(
                    f"a parameter of shape {tuple(p.shape)} is sharded over "
                    f"{undeclared} (parallel.mark_sharded): name the axis "
                    "as pipeline= or expert=")
            dims = tuple(d for d in folded if d not in sharded)
            scale = 1.0
            for a in (expert, AXIS_FSDP):
                if a in sharded and a in size:
                    scale /= int(size[a])
            if dims or scale != 1.0:
                plan.setdefault((dims, scale), []).append(p)
        self.plan = [(fiber_group(mesh, dims) if dims else None, scale, ps)
                     for (dims, scale), ps in plan.items()]

    @torch.no_grad()
    def fold(self) -> None:
        """Average each planned gradient over its group and scale it, in
        place, one flat all-reduce a group and dtype."""
        import torch.distributed as dist

        for group, scale, params in self.plan:
            if group is None:
                for p in params:
                    p.grad.mul_(scale)
                continue
            factor = scale / dist.get_world_size(group)
            by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
            for p in params:
                by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
            for grads in by_dtype.values():
                flat = torch.cat([g.reshape(-1) for g in grads])
                dist.all_reduce(flat, group=group)
                flat.mul_(factor)
                offset = 0
                for g in grads:
                    g.copy_(flat[offset:offset + g.numel()].view_as(g))
                    offset += g.numel()


    @torch.no_grad()
    def fold_shards(self, shards, zplan, params: Sequence[torch.Tensor],
                    owner: int):
        """:meth:`fold` on ZeRO-reduced shards: ``shards`` yields
        ``(bucket, shard)`` of ``zplan`` (over ``params``) as this rank,
        member ``owner`` of the reduce group, holds them.  Each element
        is folded as its parameter's gradient would be, one flat
        all-reduce a bucket and fold group; yields the same pairs.  The
        members of a fold group share the reduce group's coordinate, so
        they hold the same ranges."""
        import torch.distributed as dist

        entry = {}
        for k, (_, _, ps) in enumerate(self.plan):
            for p in ps:
                entry[p] = k
        for bi, shard in shards:
            lo = owner * zplan.shard_lens[bi]
            hi = lo + zplan.shard_lens[bi]
            ranges: Dict[int, List[tuple]] = {}
            off = 0
            for i in zplan.buckets[bi]:
                end = off + zplan.leaf_sizes[i]
                a, b = max(off, lo), min(end, hi)
                if a < b and params[i] in entry:
                    ranges.setdefault(entry[params[i]], []).append(
                        (a - lo, b - lo))
                off = end
            for k, rs in ranges.items():
                group, scale, _ = self.plan[k]
                views = [shard[a:b] for a, b in rs]
                if group is None:
                    for v in views:
                        v.mul_(scale)
                    continue
                flat = torch.cat(views)
                dist.all_reduce(flat, group=group)
                flat.mul_(scale / dist.get_world_size(group))
                offset = 0
                for v in views:
                    v.copy_(flat[offset:offset + v.numel()])
                    offset += v.numel()
            yield bi, shard


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
        # DistributedOptimizer(axis=): the reduce axis and the fold.
        self._axis = None
        self._axis_plan: Optional[_AxisPlan] = None
        self._passes = 0
        self._acc: Dict[torch.Tensor, torch.Tensor] = {}
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

    def _exchanged(self) -> List[torch.Tensor]:
        """The parameters every rank exchanges: each one of
        ``param_groups`` that requires a gradient, whether or not it has
        one on this rank."""
        return [p for g in self.optimizer.param_groups for p in g["params"]
                if p.requires_grad]

    def synchronize(self) -> None:
        """Average (or sum) the gradient of every parameter that requires
        one over the process set, in place, as fused bucket collectives
        (under ``HVDT_OVERLAP=on``: issue the buckets no hook issued and
        wait for all).  A parameter without a gradient sends zeros and
        gets the reduced gradient as ``.grad``."""
        params = self._exchanged()
        _zero_fill(params)
        if self._hooked is not None:
            self._hooked.finish()
            self._axis_fold()
            return
        self._axis_fold()
        reduced = allreduce_gradients(
            [p.grad for p in params], op=self._op,
            compression=self._compression, threshold_bytes=self._threshold,
            prescale_factor=self._prescale,
            postscale_factor=self._postscale, process_set=self._process_set,
            axis=self._axis)
        with torch.no_grad():
            for p, r in zip(params, reduced):
                p.grad.copy_(r)

    def _axis_fold(self) -> None:
        """The model-axis fold of ``axis=`` (module docstring)."""
        if self._axis_plan is not None:
            self._axis_plan.fold()

    def _fold(self, p: torch.Tensor, phase: int) -> None:
        """Fold ``p``'s gradient of pass ``phase`` into its f32
        accumulator: copied on the cycle's first pass, added on later
        ones; a pass that gave ``p`` no gradient adds zeros."""
        acc = self._acc.get(p)
        if acc is None:
            acc = self._acc[p] = torch.empty(
                p.shape, dtype=torch.float32, device=p.device)
        if p.grad is None:
            if phase == 0:
                acc.zero_()
        elif phase == 0:
            acc.copy_(p.grad)
        else:
            acc.add_(p.grad)

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
        every exchanged parameter set to the accumulated sum over k, in
        its dtype.  Parameters a hook already folded this pass
        (``HVDT_OVERLAP=on``) are skipped."""
        with torch.no_grad():
            params = self._exchanged()
            if graphs.capturing() and set(params) != set(self._acc):
                raise RuntimeError(
                    "the parameters that require a gradient are not the "
                    "ones the eager passes accumulated (requires_grad "
                    "changed, or a parameter was added): run every pass of "
                    "a cycle eagerly again before a capture")
            for p in params:
                if p not in self._folded:
                    self._fold(p, phase)
            if phase < self._k - 1:
                return False
            for p in params:
                if p not in self._folded:
                    self._set_mean(p)
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
            self._fold(p, self._k - 1)
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
        params = self._exchanged()
        _zero_fill(params)
        if self._hooked is not None:
            self._hooked.finish()
            self._axis_fold()
            return
        self._axis_fold()
        from .ops import zero

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
            # A parameter without a gradient steps as the wrapped
            # optimizer steps it on an explicit zero gradient.
            _zero_fill(self._zparams)
            shards = None
            if self._hooked is None:
                self._axis_fold()
            else:
                shards = self._hooked.shards()
                if self._axis_plan is not None:
                    from .ops import zero

                    shards = self._axis_plan.fold_shards(
                        shards, self._hooked.zplan, self._zparams,
                        zero._impl(self.transform).group().owner)
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
                         zero: Optional[Any] = None,
                         axis=None,
                         pipeline: Optional[str] = None,
                         expert: Optional[str] = None):
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
      axis: the mesh dimension(s) to reduce over (module docstring);
        None reduces over ``process_set``, or the world.
      pipeline / expert: the mesh axes the parameters are sharded over
        (``parallel.pipeline_1f1b`` stages, ``parallel.
        moe_dispatch_combine`` experts); ``axis`` then defaults to
        ``"dp"``.
    """
    from .ops import zero as _zero

    _check_supported(op)
    stage = _zero.resolve_stage(zero)
    if compression is None:
        compression = Compression.from_env()
    plan = None
    if axis is None and (pipeline is not None or expert is not None):
        axis = "dp"
    if axis is not None:
        if process_set is not None:
            raise ValueError("pass either axis= or process_set=, not both")
        plan = _AxisPlan([p for g in optimizer.param_groups
                          for p in g["params"] if p.requires_grad],
                         axis, pipeline, expert)
        process_set = plan.process_set
    from .telemetry.instrument import get_recorder

    _rec = get_recorder()
    if _rec is not None:
        # Construction-time config record: which wire format / reduce op
        # the job trains with is the label every collective series gets
        # joined against.
        _rec.registry.counter(
            "hvdt_distributed_optimizer_builds_total",
            "DistributedOptimizer constructions, labelled op/compression"
        ).inc(op=ReduceOp(op).name.lower(),
              compression=getattr(compression, "__name__", "none"),
              backward_passes=str(backward_passes_per_step),
              pipeline=pipeline or "off", expert=expert or "off")
    if stage is None:
        obj = _DistributedOptimizer(optimizer, op, compression,
                                    backward_passes_per_step,
                                    threshold_bytes, prescale_factor,
                                    postscale_factor, process_set)
    else:
        if ReduceOp(op) not in (ReduceOp.SUM, ReduceOp.AVERAGE):
            raise ValueError(f"ZeRO exchange supports SUM/AVERAGE, got {op}")
        spec = zero if isinstance(zero, _zero.ZeroSpec) else None
        if plan is not None:
            spec = _zero.ZeroSpec(stage=stage, axis=plan.axis,
                                  num_shards=spec.num_shards if spec else None,
                                  threshold_bytes=(spec.threshold_bytes
                                                   if spec else None))
        if threshold_bytes is None and spec is not None:
            threshold_bytes = spec.threshold_bytes
        cls = (_ZeroGradsOptimizer if stage == "grads"
               else _ZeroStatesOptimizer)
        obj = cls(optimizer, op, compression, backward_passes_per_step,
                  threshold_bytes, prescale_factor, postscale_factor,
                  process_set, stage=stage, spec=spec)
    if plan is not None:
        obj._axis, obj._axis_plan = plan.axis, plan
    return obj
