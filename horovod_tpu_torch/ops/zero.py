"""ZeRO-sharded gradient exchange and optimizer state — the
reduce-scatter data plane (``HVDT_ZERO``).

The PyTorch counterpart of the JAX package's ``ops/zero.py``.  The
replicated step ends n-fold redundant: every rank holds the whole
reduced gradient and the whole optimizer state.  Three stages remove
that, selected by ``HVDT_ZERO=off|grads|states|params``:

* ``grads`` — the wire changes: each bucket's allreduce becomes an
  explicit reduce-scatter and all-gather (same wire bytes); any
  ``torch.optim`` optimizer steps on the result (:func:`rs_exchange`).
* ``states`` — each rank runs the fused update (#1 ``hvdt_adam_multi``
  / #2 ``hvdt_sgd_multi``, ``csrc/optim.cu``) on its 1/n shard of every
  reduce-scattered bucket with its 1/n shard of the moments, and only
  the updated parameter deltas are all-gathered.
* ``params`` — the parameters live sharded between steps too; the
  update runs in place on the rank's parameter rows (``APPLY``) and
  :meth:`ZeroTransformation.gather_params` materializes them before the
  forward.

Math: Adam and SGD are elementwise, so updating a flat bucket shard
gives each element the value the replicated per-leaf update gives it;
the scalars (learning rate at the pre-increment count, the bias
corrections at the incremented one) are the fused optimizers' own
(``ops/optim_kernels``), so on a world whose sums are exact the sharded
step equals the replicated one bit for bit.

State layout: per reverse-topological bucket (``ops/overlap.py``
``overlap_schedule``) a ``[rows, shard_len]`` stack, ``shard_len``
aligned to :func:`shard_align` elements (whole int8 blocks).  Three
layouts, read from the stacks an update is given:

* **rank-local** — ``[1, shard_len]``, this rank's row only: the n-fold
  memory saving (the reference's ``P(axis)`` "manual" crossing);
* **replicated** — the whole ``[n, shard_len]`` stack on every rank
  (what :meth:`ZeroTransformation.gather_state` and
  ``checkpoint.restore_zero_state`` return): the rank updates its own
  row and all-gathers the rows back;
* **unbound** — no process group, or a group of one: the gradients are
  already global, the whole stack is updated locally and no collective
  runs.

``init`` and ``shard_params`` make rank-local rows on a bound group and
whole stacks unbound.

The exchange: each bucket is packed in leaf order, pre-scaled, padded to
``n * shard_len``, cast to an explicit bf16/fp16 wire (or the transport
policy's fast-tier wire), and reduce-scattered with one
``reduce_scatter_tensor`` a hop of the reduce group (one hop a mesh
dimension, innermost first; ``ops/device.reduce_scatter_flat``).  With
``Compression.int8``/``.int4`` on a one-axis group, or a hierarchical
transport whose slow tier is quantized, the shard rides
``quant.collectives.quantized_reduce_scatter_start/finish`` (#5-#8).
Then AVERAGE divides by n, the postscale applies and the shard is cast
back.  ``rs_wire=False`` (the autotuner's replicated-exchange leg)
all-reduces the bucket and slices this rank's shard: the same values in
the same state layout.  SUM and AVERAGE only.

Scheduling: without ``HVDT_OVERLAP`` the buckets are exchanged in order
and the update is **one multi-tensor launch over every bucket's rows**.
Under ``HVDT_OVERLAP=on`` each bucket's reduce-scatter is issued on the
overlap layer's communication stream (from gradient hooks inside
``DistributedOptimizer``, in schedule order on every rank) and the
update runs one launch a bucket after that bucket's wait, as
``pipelined_sgd`` does.

Under a CUDA-graph capture (``step_pipeline.donated_step``) the update's
launches read their scalars from a device row that a replay hook fills
before each replay (``common.graphs.on_replay``), and the Adam count
advances in that hook, as in ``FusedAdam``.  The row is allocated for
the default stream, outside the graph's memory pool; the state stacks
are allocated by :meth:`ZeroTransformation.init`, before any capture.
The plain versions (CPU tensors, ``use_kernels=False``) cannot be
captured and raise there.

Zero-wrapper contract: with ``HVDT_ZERO`` unset :func:`get_zero` returns
None, :func:`exchange_fn` returns ``overlap.exchange_fn()``'s result
(``ops.device.fused_allreduce`` itself when overlap is off too), and
``DistributedOptimizer`` builds the object it builds without ZeRO.

Not ported: the reference's "unvarying leaf" pre-scale (a shard_map
artifact: a rank's ``.grad`` is its own local gradient).  Telemetry:
each bucket's reduce-scatter and each all-gather (the ``grads`` gather,
the ``states`` delta gather, the ``params`` gather before the forward)
books one ``path="jit"`` record under the reference's op names, counted
the port's way (each collective executed; a ``donated_step`` capture
books through its replay hook); :func:`record_state_gauges` feeds the
per-rank optimizer-state bytes into the telemetry memory gauges.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import threading
from typing import (Any, Callable, Dict, Iterable, List, NamedTuple,
                    Optional, Sequence, Tuple)

import numpy as np
import torch
import torch.distributed as dist

from ..common import graphs
from ..common.process_sets import ProcessSet, global_process_set
from ..common.types import ReduceOp
from . import device as dev
from . import overlap as ovl

__all__ = [
    "STAGES", "ZeroSpec", "ZeroTransformation", "ZeroAdamState",
    "ZeroSgdState", "stage", "enabled", "get_zero", "reset",
    "validate_env", "resolve_stage", "exchange_fn", "rs_exchange",
    "zero_transform", "zero_sgd", "zero_adam", "zero_from_optimizer",
    "state_metadata", "reshard_state", "shard_align",
    "extract_shard_rows", "implant_shard_rows",
    "flatten_state_buffers", "rebucket_state", "concat_states",
    "record_state_gauges",
]

STAGES: Tuple[str, ...] = ("off", "grads", "states", "params")


def shard_align() -> int:
    """Shard alignment in elements: multiples of 256 keep every shard a
    whole number of int8 blocks (a larger ``HVDT_QUANT_BLOCK`` raises
    it), so the quantized reduce-scatter needs no re-padding."""
    from ..quant import kernels as qk

    return max(256, int(qk.quant_block_size()))


# ---------------------------------------------------------------------------
# Env engagement
# ---------------------------------------------------------------------------

_OFF = ("", "0", "off", "none", "false", "no")

_lock = threading.Lock()
_cached_env: Optional[str] = "\0unset"   # sentinel != any real env value
_cached_stage: Optional[str] = None


def stage() -> Optional[str]:
    """The active ZeRO stage from ``HVDT_ZERO``, or None when off.
    Unknown values raise with the valid list (``init()`` calls
    :func:`validate_env`, so a typo fails every worker at init)."""
    global _cached_env, _cached_stage
    raw = os.environ.get("HVDT_ZERO")
    if raw != _cached_env:
        with _lock:
            if raw != _cached_env:
                val = (raw or "").strip().lower()
                if val in _OFF:
                    _cached_stage = None
                elif val in STAGES:
                    _cached_stage = val
                else:
                    raise ValueError(
                        f"unknown HVDT_ZERO stage {raw!r}; valid: "
                        f"{', '.join(STAGES)}")
                _cached_env = raw
    return _cached_stage


def enabled() -> bool:
    return stage() is not None


def get_zero() -> Optional["ZeroSpec"]:
    """The env-selected ZeRO spec, or None when off."""
    st = stage()
    return None if st is None else ZeroSpec(stage=st)


def reset() -> None:
    """Drop the cached stage (test isolation)."""
    global _cached_env, _cached_stage
    with _lock:
        _cached_env = "\0unset"
        _cached_stage = None


def validate_env() -> Optional[str]:
    """Parse ``HVDT_ZERO`` now (``init()`` calls this)."""
    return stage()


def resolve_stage(value=None) -> Optional[str]:
    """Normalize a ``zero=`` keyword: None reads the env; a ZeroSpec
    passes its stage; ``True`` is the env's stage or ``"states"``;
    strings are validated."""
    if value is None:
        return stage()
    if isinstance(value, ZeroSpec):
        return value.stage
    if value is True:
        st = stage()
        return st if st is not None else "states"
    val = str(value).strip().lower()
    if val in _OFF:
        return None
    if val not in STAGES:
        raise ValueError(
            f"unknown ZeRO stage {value!r}; valid: {', '.join(STAGES)}")
    return val


def exchange_fn() -> Callable:
    """The bucketed exchange with ZeRO routing on top of the overlap
    routing: :func:`rs_exchange` at ``grads`` or beyond, else
    ``overlap.exchange_fn()``'s result (``fused_allreduce`` itself when
    overlap is off too)."""
    return ovl.exchange_fn() if stage() is None else rs_exchange


# ---------------------------------------------------------------------------
# Spec / plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ZeroSpec:
    """Construction-time ZeRO configuration.  ``axis``: the reduce group
    (a mesh-axis name or tuple of them; None as ``fused_allreduce``
    resolves it: the current mesh's dimensions, or the process set's
    group).  ``num_shards``: the shard count the state is built for
    (None: the group's size).  A checkpoint restored onto another count
    goes through :func:`reshard_state`."""

    stage: str = "states"
    axis: Any = None
    num_shards: Optional[int] = None
    threshold_bytes: Optional[int] = None

    def __post_init__(self):
        if self.stage not in STAGES or self.stage == "off":
            raise ValueError(
                f"ZeroSpec stage must be one of {STAGES[1:]}, "
                f"got {self.stage!r}")


@dataclasses.dataclass(frozen=True)
class _Plan:
    """Deterministic bucket plan and shard geometry, fixed at init so the
    state layout never moves under autotune threshold changes."""

    buckets: Tuple[Tuple[int, ...], ...]   # leaf indices, reverse-topo
    sizes: Tuple[int, ...]                 # logical elements a bucket
    shard_lens: Tuple[int, ...]            # aligned elements a shard
    dtypes: Tuple[torch.dtype, ...]        # bucket dtype
    leaf_shapes: Tuple[Tuple[int, ...], ...]
    leaf_sizes: Tuple[int, ...]
    num_shards: int
    threshold_bytes: int

    @property
    def padded_sizes(self) -> Tuple[int, ...]:
        return tuple(sl * self.num_shards for sl in self.shard_lens)

    def state_bytes_total(self, n_buffers: int = 1) -> int:
        """Bytes of ``n_buffers`` moment stacks over the whole plan."""
        return n_buffers * sum(ps * dt.itemsize for ps, dt in
                               zip(self.padded_sizes, self.dtypes))

    def state_bytes_per_rank(self, n_buffers: int = 1) -> int:
        return self.state_bytes_total(n_buffers) // self.num_shards


def _make_plan(leaves: Sequence[torch.Tensor], threshold_bytes: Optional[int],
               num_shards: int) -> _Plan:
    threshold_bytes = dev._validated_threshold(threshold_bytes)
    buckets = ovl.overlap_schedule(leaves, threshold_bytes)
    align = shard_align()
    sizes, shard_lens, dtypes = [], [], []
    for bucket in buckets:
        size = sum(int(leaves[i].numel()) for i in bucket)
        sizes.append(size)
        shard_lens.append(-(-size // (num_shards * align)) * align)
        dtypes.append(leaves[bucket[0]].dtype)
    return _Plan(
        buckets=tuple(tuple(b) for b in buckets),
        sizes=tuple(sizes), shard_lens=tuple(shard_lens),
        dtypes=tuple(dtypes),
        leaf_shapes=tuple(tuple(int(s) for s in l.shape) for l in leaves),
        leaf_sizes=tuple(int(l.numel()) for l in leaves),
        num_shards=int(num_shards),
        threshold_bytes=int(threshold_bytes))


# ---------------------------------------------------------------------------
# Telemetry
# ---------------------------------------------------------------------------


def _record_bucket(op: str, axis_label: str, dtype: torch.dtype, wire: str,
                   nbytes: int, name: str, count: int = 1) -> None:
    """One ZeRO collective's records, under the reference's labels
    (``path="jit"``): the collective counters and a flight-recorder
    event.  Each executed collective books once; inside a
    ``donated_step`` capture the recorders book before each replay
    (``telemetry/instrument.deferred_to_replay``)."""
    from ..telemetry import flight_recorder as _frm
    from ..telemetry import instrument as _ti

    rec = _ti.get_recorder()
    flight = _frm.get_flight_recorder()
    if rec is None and flight is None:
        return
    dt = dev._dtype_name(dtype)
    if rec is not None:
        rec.record_collective(op, dt, wire, int(nbytes), count=count,
                              path="jit", axis=axis_label)
    if flight is not None:
        flight.record(op=op, name=name, dtype=dt, shape=(int(nbytes),),
                      nbytes=int(nbytes), wire=wire, path="jit",
                      count=count, axis=axis_label)


# ---------------------------------------------------------------------------
# The reduce group
# ---------------------------------------------------------------------------


class _Group:
    """A reduce group's hops (``ops/device._hops``: one a mesh dimension,
    innermost first, or the process set's group), its size and this
    rank's owner index."""

    def __init__(self, axis, mesh, process_set: Optional[ProcessSet]):
        self.ps = process_set or global_process_set()
        self.axis, self.mesh = axis, mesh
        self.hops = dev._hops(axis, mesh, self.ps)
        self.axes = tuple(a for a, _ in reversed(self.hops))  # outer first
        self.label = "+".join(self.axes)
        self.size = math.prod(dist.get_world_size(g) for _, g in self.hops)
        self.owner = dev.shard_owner_index(axis, mesh, self.ps)

    def reduce_scatter(self, x: torch.Tensor, skip: Optional[str] = None
                       ) -> torch.Tensor:
        """``dev.reduce_scatter_flat`` over the group, or over its other
        axes when ``skip`` names one (the quantized slow hop's)."""
        if skip is None:
            return dev.reduce_scatter_flat(x, self.axis, self.mesh, self.ps)
        rest = tuple(a for a in self.axes if a != skip)
        if not rest:
            return x.detach().reshape(-1).contiguous()
        return dev.reduce_scatter_flat(x, rest, self.mesh, self.ps)

    def all_gather(self, shard: torch.Tensor,
                   name: Optional[str] = None) -> torch.Tensor:
        """The shards of every member concatenated; ``name`` books the
        gather as one ``allgather`` record (ring accounting: (n-1)/n of
        the gathered bytes)."""
        if name is not None:
            n = self.size
            nbytes = shard.numel() * n * shard.element_size()
            _record_bucket("allgather", self.label, shard.dtype,
                           dev._dtype_name(shard.dtype),
                           nbytes * (n - 1) // max(1, n), name)
        return dev.allgather_flat_shards(shard, self.axis, self.mesh,
                                         self.ps)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        for _, g in self.hops:
            dist.all_reduce(x, dist.ReduceOp.SUM, group=g)
        return x

    def group_of(self, axis: str):
        return dict(self.hops)[axis]


def _quant_slow_axis(group: _Group, wire_dtype):
    """``(axis, leg)`` for the one axis whose shard exchange rides a
    block-scaled quantized wire: an explicit ``Compression.int8`` /
    ``.int4`` on a one-axis group, or the transport policy's quantized
    slow tier on a hierarchical group; None otherwise."""
    from ..quant.collectives import quant_wire_leg
    from ..transport import policy as _tpolicy

    leg = quant_wire_leg(wire_dtype)
    if leg is not None and len(group.hops) == 1:
        return group.hops[0][0], leg
    res = _tpolicy.resolve_axis(group.axes)
    if (res is not None and res.kind == "hierarchical"
            and res.slow is not None
            and quant_wire_leg(res.slow.wire) is not None
            and len(res.slow_axes) == 1
            and res.slow_axes[0] in group.axes):
        return res.slow_axes[0], quant_wire_leg(res.slow.wire)
    return None


_WIRE_NAMES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def _cast_wire(group: _Group, wire_dtype) -> Optional[torch.dtype]:
    """The exact wire cast of the reduce-scatter hops: an explicit
    dtype (bf16 / fp16), else the transport policy's fast-tier wire."""
    from ..transport import policy as _tpolicy

    if isinstance(wire_dtype, str):
        wire_dtype = _WIRE_NAMES.get(wire_dtype)
    if wire_dtype is not None:
        return wire_dtype
    res = _tpolicy.resolve_axis(group.axes)
    if res is not None:
        return {"bf16": torch.bfloat16, "fp16": torch.float16}.get(
            res.fast.wire)
    return None


def _scale_(x: torch.Tensor, factor: float) -> torch.Tensor:
    """``x`` times ``factor`` rounded to ``x``'s dtype first, as the
    reference's ``x * jnp.asarray(factor, x.dtype)`` (in place for a
    float tensor)."""
    if factor == 1.0:
        return x
    s = torch.tensor(factor, dtype=x.dtype).item()
    return x.mul_(s) if x.is_floating_point() else x * s


# ---------------------------------------------------------------------------
# The bucket exchange: reduce-scatter (or allreduce + slice), the wire seams
# ---------------------------------------------------------------------------


class _Shard:
    """One bucket's reduce-scatter in flight."""

    __slots__ = ("kind", "dtype", "shard", "work", "quant")

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype
        self.kind = self.shard = self.work = self.quant = None


class _ShardRoute:
    """How each bucket of one exchange is reduce-scattered: started
    (:meth:`start`), then finished in two halves like
    ``ops/device._BucketRoute`` (:meth:`finish_comm`, the quantized
    wire's dequantize-accumulate, on the communication stream; then
    :meth:`finish`: the wait, AVERAGE, postscale and the cast back)."""

    def __init__(self, group: _Group, op: ReduceOp, prescale_factor: float,
                 postscale_factor: float, wire_dtype, rs_wire: bool = True):
        op = ReduceOp(op)
        if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
            raise ValueError(f"ZeRO exchange supports SUM/AVERAGE, got {op}")
        self.group, self.op, self.rs_wire = group, op, rs_wire
        self.pre, self.post = prescale_factor, postscale_factor
        self.quant = _quant_slow_axis(group, wire_dtype)
        self.cast = _cast_wire(group, wire_dtype)

    def wire_bytes(self, flat: torch.Tensor) -> int:
        """Ring accounting: a reduce-scatter moves (n-1)/n of the payload."""
        n = self.group.size
        return flat.numel() * flat.element_size() * (n - 1) // max(1, n)

    def start(self, flat: torch.Tensor, async_op: bool = False,
              index: int = 0, count: int = 1) -> _Shard:
        """Start bucket ``index`` (``count`` leaves) and book its
        ``reduce_scatter`` record."""
        g = self.group
        b = _Shard(flat.dtype)
        floating = flat.is_floating_point()
        if self.quant is not None and floating:
            from ..quant.collectives import wire_sentinel

            wire = wire_sentinel(self.quant[1])
        else:
            wire = dev._dtype_name(flat.dtype)
        _record_bucket("reduce_scatter", g.label, flat.dtype, wire,
                       self.wire_bytes(flat), f"zero.b{index}", count)
        if not self.rs_wire:
            # The replicated-exchange leg: full allreduce, own slice.
            full = g.all_reduce(flat)
            sl = full.numel() // g.size
            b.kind, b.shard = "sync", full[g.owner * sl:(g.owner + 1) * sl]
            return b
        hit = self.quant if floating else None
        x = flat
        if floating and self.cast is not None and x.dtype != self.cast:
            x = x.to(self.cast)
        if hit is None:
            if async_op and len(g.hops) == 1:
                out = x.new_empty(x.numel() // g.size)
                b.work = dist.reduce_scatter_tensor(
                    out, x, dist.ReduceOp.SUM, group=g.hops[0][1],
                    async_op=True)
                b.kind, b.shard = "async", out
            else:
                b.kind, b.shard = "sync", g.reduce_scatter(x)
            return b
        slow, leg = hit
        from ..quant import kernels as qk
        from ..quant.collectives import quantized_reduce_scatter_start
        from ..transport.hierarchy import _AxisSet

        shard = g.reduce_scatter(x, skip=slow)
        slow_group = g.group_of(slow)
        n_slow = dist.get_world_size(slow_group)
        block = qk.quant_block_size()
        if shard.numel() % (n_slow * block):
            raise ValueError(
                f"ZeRO shards of {shard.numel() // n_slow} elements are not "
                f"whole {block}-element quantization blocks")
        b.kind = "quant"
        b.quant = quantized_reduce_scatter_start(
            shard.to(torch.float32), ReduceOp.SUM, wire=leg,
            process_set=_AxisSet(slow_group))
        return b

    def finish_comm(self, b: _Shard) -> None:
        if b.kind == "quant":
            from ..quant.collectives import quantized_reduce_scatter_finish

            b.shard = quantized_reduce_scatter_finish(b.quant)
            b.quant, b.kind = None, "sync"

    def finish(self, b: _Shard) -> torch.Tensor:
        if b.kind == "async":
            b.work.wait()
        shard = b.shard
        if shard.dtype != b.dtype:
            shard = shard.to(b.dtype)
        if self.op == ReduceOp.AVERAGE:
            n = self.group.size
            shard = shard.div_(n) if shard.is_floating_point() \
                else shard / n
        if self.post != 1.0:
            shard = _scale_(shard, self.post)
        if shard.dtype != b.dtype:
            shard = shard.to(b.dtype)
        return shard


def _bucket_flat(leaves: Sequence[Optional[torch.Tensor]], plan: _Plan,
                 bi: int, pre: float = 1.0) -> torch.Tensor:
    """One bucket's leaves concatenated in logical (row-major) order,
    pre-scaled and zero-padded to the padded size; a leaf that is None
    (no gradient) counts as zeros.  A fresh buffer."""
    ids = plan.buckets[bi]
    device = _device_of(leaves, ids)
    parts = [torch.zeros(plan.leaf_sizes[i], dtype=plan.dtypes[bi],
                         device=device) if leaves[i] is None
             else leaves[i].detach().reshape(-1) for i in ids]
    pad = plan.padded_sizes[bi] - plan.sizes[bi]
    if pad:
        parts.append(parts[0].new_zeros(pad))
    flat = torch.cat(parts) if len(parts) > 1 else parts[0].clone()
    return _scale_(flat, pre)


def _device_of(leaves, ids) -> torch.device:
    return next((leaves[i].device for i in ids if leaves[i] is not None),
                torch.device("cpu"))


def _split_bucket(flat: torch.Tensor, plan: _Plan, bi: int
                  ) -> Dict[int, torch.Tensor]:
    """Slice one bucket's flat vector back into its leaves (views)."""
    cells: Dict[int, torch.Tensor] = {}
    offset = 0
    for i in plan.buckets[bi]:
        sz = plan.leaf_sizes[i]
        cells[i] = flat[offset:offset + sz].view(plan.leaf_shapes[i])
        offset += sz
    return cells


class _ZeroPipeline(ovl._Pipeline):
    """The overlapped exchange of ZeRO buckets: each bucket packed and
    its reduce-scatter started on the overlap layer's communication
    stream (a one-hop plain bucket with ``async_op=True``), bucket N's
    comm-side finish after bucket N+1's start; :meth:`drain` waits for
    each in schedule order on the caller's stream and yields ``(bucket,
    reduced shard)``."""

    def __init__(self, route: _ShardRoute, plan: _Plan):
        self.route = route
        self.plan = plan
        self.threshold = plan.threshold_bytes
        self.issued = []
        self.finished = 0
        self.bucket_bytes: List[int] = []
        self.device = None
        self.comm = None

    def issue_bucket(self, bi: int, leaves: Sequence[Optional[torch.Tensor]]
                     ) -> None:
        """Issue bucket ``bi``; ``leaves`` is indexed like the plan's
        leaves (only the bucket's entries are read)."""
        with self._fork(_device_of(leaves, self.plan.buckets[bi])):
            flat = _bucket_flat(leaves, self.plan, bi, self.route.pre)
            self.bucket_bytes.append(self.route.wire_bytes(flat))
            self.issued.append(ovl._Issued(
                [bi], None, self.route.start(
                    flat, True, bi, len(self.plan.buckets[bi]))))
            self._finish_comm(len(self.issued) - 1)

    def drain(self):
        with (torch.cuda.stream(self.comm) if self.comm is not None
              else contextlib.nullcontext()):
            self._finish_comm(len(self.issued))
        for it in self.issued:
            if it.done is not None:
                torch.cuda.current_stream(self.device).wait_event(it.done)
            yield it.ids[0], self.route.finish(it.bucket)
        if self.comm is not None:
            torch.cuda.current_stream(self.device).wait_stream(self.comm)
        ovl._account(self.bucket_bytes, "zero_reduce_scatter")


class _ZeroHooked(ovl.HookedExchange):
    """``DistributedOptimizer``'s hooked exchange under ZeRO
    (``HVDT_OVERLAP=on``): the hooks issue each bucket's reduce-scatter
    (``_ZeroPipeline``) as its last gradient lands, buckets in schedule
    order on every rank; :meth:`shards` issues the rest and yields each
    reduced shard in order, :meth:`finish` (stage ``grads``) all-gathers
    them into ``.grad``."""

    def __init__(self, owner, params, plan: _Plan,
                 pipeline: Callable[[_Plan], _ZeroPipeline]):
        super().__init__(owner, params)
        self.zplan = plan
        self._make_pipeline = pipeline
        # The ZeRO plan (its threshold resolved through the transport
        # policy) decides the buckets.
        self.plan = [list(b) for b in plan.buckets]
        self.bucket_of = {self.params[i]: b
                          for b, ids in enumerate(self.plan) for i in ids}
        self._begin()

    @classmethod
    def for_grads(cls, owner, params, axis) -> "_ZeroHooked":
        from ..transport import policy as _tpolicy

        group = _Group(axis, None, owner._process_set)
        live = [p for p in params if p.requires_grad]
        plan = _make_plan(live, _tpolicy.bucket_threshold(
            group.axes, owner._threshold), group.size)
        route = _ShardRoute(group, owner._op, owner._prescale,
                            owner._postscale, owner._compression.wire_dtype)
        hooked = cls(owner, params, plan,
                     lambda plan: _ZeroPipeline(route, plan))
        hooked.group = group
        return hooked

    def _pipeline(self) -> _ZeroPipeline:
        if self.pipe is None:
            self.pipe = self._make_pipeline(self.zplan)
        return self.pipe

    def _issue(self, b: int) -> None:
        self._pipeline().issue_bucket(b, [p.grad for p in self.params])
        self.next_issue = b + 1

    def shards(self):
        """Issue the buckets no hook issued; yield ``(bucket, reduced
        shard)`` in schedule order."""
        try:
            while self.next_issue < len(self.plan):
                self._issue(self.next_issue)
            yield from self._pipeline().drain()
        finally:
            self._begin()

    @torch.no_grad()
    def finish(self) -> None:
        for bi, shard in self.shards():
            full = self.group.all_gather(shard, f"zero.b{bi}.ag")
            for i, v in _split_bucket(full, self.zplan, bi).items():
                self.params[i].grad.copy_(v)


class _SegmentExchange:
    """One segment's exchange under ``HVDT_ZERO`` for
    ``overlap.overlap_value_and_grad``: every bucket's reduce-scatter
    issued at once (``_ZeroPipeline``), then drained in order with an
    all-gather a bucket, yielding ``(leaf ids, leaves, reduced leaves)``
    as ``overlap._Pipeline.drain`` does."""

    def __init__(self, tensors, op, threshold_bytes, prescale_factor,
                 postscale_factor, wire_dtype, process_set, axis, mesh):
        from ..transport import policy as _tpolicy

        self.tensors = list(tensors)
        self.group = _Group(axis, mesh, process_set)
        self.plan = _make_plan(self.tensors, _tpolicy.bucket_threshold(
            self.group.axes, threshold_bytes), self.group.size)
        self.pipe = _ZeroPipeline(
            _ShardRoute(self.group, op, prescale_factor, postscale_factor,
                        wire_dtype), self.plan)
        for bi in range(len(self.plan.buckets)):
            self.pipe.issue_bucket(bi, self.tensors)

    def drain(self):
        for bi, shard in self.pipe.drain():
            cells = _split_bucket(
                self.group.all_gather(shard, f"zero.b{bi}.ag"), self.plan,
                bi)
            ids = list(self.plan.buckets[bi])
            yield ids, [self.tensors[i] for i in ids], [cells[i] for i in ids]


def _exchange_shards(leaves, plan: _Plan, route: _ShardRoute):
    """``[(bucket, reduced shard)]`` of every bucket: issued in schedule
    order and finished in order (pipelined on the communication stream
    under ``HVDT_OVERLAP=on``)."""
    if ovl.get_scheduler() is not None:
        pipe = _ZeroPipeline(route, plan)
        for bi in range(len(plan.buckets)):
            pipe.issue_bucket(bi, leaves)
        return pipe.drain()
    out = []
    for bi in range(len(plan.buckets)):
        b = route.start(_bucket_flat(leaves, plan, bi, route.pre),
                        index=bi, count=len(plan.buckets[bi]))
        route.finish_comm(b)
        out.append((bi, route.finish(b)))
    return out


def rs_exchange(tensors: Sequence[torch.Tensor],
                op: ReduceOp = ReduceOp.AVERAGE,
                threshold_bytes: Optional[int] = None,
                prescale_factor: float = 1.0,
                postscale_factor: float = 1.0,
                wire_dtype: Optional[Any] = None,
                process_set: Optional[ProcessSet] = None, *,
                axis=None, mesh=None) -> List[torch.Tensor]:
    """Drop-in for ``ops.device.fused_allreduce`` over the reduce-scatter
    wire (``HVDT_ZERO=grads``): per reverse-topological bucket, a
    reduce-scatter, then an all-gather of the reduced shard.  Equal to
    the fused allreduce bit for bit where the sums are exact; the int8
    wire keeps its block-scale bound.  Returns the reduced tensors in
    input order (views into the gathered buffers)."""
    from ..transport import policy as _tpolicy

    tensors = list(tensors)
    if not tensors:
        return []
    group = _Group(axis, mesh, process_set)
    threshold_bytes = dev._validated_threshold(
        _tpolicy.bucket_threshold(group.axes, threshold_bytes))
    plan = _make_plan(tensors, threshold_bytes, group.size)
    route = _ShardRoute(group, op, prescale_factor, postscale_factor,
                        wire_dtype)
    cells: List[Any] = [None] * len(tensors)
    for bi, shard in _exchange_shards(tensors, plan, route):
        for i, v in _split_bucket(group.all_gather(shard, f"zero.b{bi}.ag"),
                                  plan, bi).items():
            cells[i] = v
    return cells


# ---------------------------------------------------------------------------
# State containers
# ---------------------------------------------------------------------------


class ZeroAdamState(NamedTuple):
    """Sharded Adam state: per-bucket ``[rows, shard_len]`` moment stacks
    and the step count (an int32 scalar tensor on the host)."""

    count: torch.Tensor
    mu: Tuple[torch.Tensor, ...]
    nu: Tuple[torch.Tensor, ...]


class ZeroSgdState(NamedTuple):
    """Sharded SGD-momentum state (empty ``trace`` without momentum)."""

    trace: Tuple[torch.Tensor, ...]


class ZeroTransformation(NamedTuple):
    """The reference's handles: ``init``/``update``, the ``params``
    stage's ``shard_params``/``gather_params``, ``full_state`` (the
    equivalent replicated state), the spec and plan accessors; plus
    ``gather_state`` (every row of a rank-local state on every rank, for
    a checkpoint) and ``scatter_state`` (a full-stack state copied into
    a state's own rows in place)."""

    init: Callable
    update: Callable
    shard_params: Callable
    gather_params: Callable
    full_state: Callable
    spec: ZeroSpec
    plan_for: Callable
    state_bytes_per_rank: Callable
    gather_state: Callable
    scatter_state: Callable


def record_state_gauges(spec_bytes_per_rank: int, zero_stage: str) -> None:
    """Feed the per-rank post-sharding optimizer-state accounting into
    the telemetry memory gauges (no-op with telemetry off)."""
    from ..telemetry.step_stats import record_memory_accounting

    record_memory_accounting(optimizer_state_bytes=spec_bytes_per_rank,
                             zero_stage=zero_stage)


def _state_stacks(state) -> List[Tuple[str, Tuple[torch.Tensor, ...]]]:
    """``[(name, stacks)]`` for either state flavour."""
    if hasattr(state, "mu"):
        return [("mu", state.mu), ("nu", state.nu)]
    return [("trace", state.trace)]


# ---------------------------------------------------------------------------
# The sharded update (stages "states" and "params")
# ---------------------------------------------------------------------------

_ROW = 16               # f32 scalars of a launch's device row


class _Rec:
    """One bucket's operands of the update: p (parameter shard, or None),
    g (gradient shard), m, v (moment rows), d (delta out, or None)."""

    __slots__ = ("bi", "p", "g", "m", "v", "d")

    def __init__(self, bi, p, g, m, v, d):
        self.bi, self.p, self.g, self.m, self.v, self.d = bi, p, g, m, v, d


class _ZeroTx:
    """The state and logic behind one :class:`ZeroTransformation`."""

    def __init__(self, optim_spec, stage: str, axis, op, num_shards,
                 threshold_bytes, wire_dtype, prescale_factor,
                 postscale_factor, use_kernels, rs_wire, process_set, mesh):
        kind = optim_spec.get("kind")
        if kind not in ("sgd", "adam"):
            raise ValueError(
                f"ZeRO sharded update supports the fused sgd/adam family, "
                f"got optimizer kind {kind!r}; build the optimizer with "
                f"hvd.fused_sgd(...) / hvd.fused_adam(...) (or use "
                f"HVDT_ZERO=grads, which composes with any torch.optim "
                f"optimizer)")
        if stage not in ("states", "params"):
            raise ValueError(
                f"zero_transform implements stages 'states'/'params', got "
                f"{stage!r} (use rs_exchange / DistributedOptimizer for "
                f"'grads')")
        if kind == "sgd" and callable(optim_spec.get("learning_rate")):
            raise ValueError("zero sgd takes a float learning_rate "
                             "(its state carries no step count); use the "
                             "adam family for schedule support")
        self.hp = optim_spec
        self.kind = kind
        self.stage = stage
        self.use_kernels = (bool(optim_spec.get("use_kernels", True))
                            if use_kernels is None else bool(use_kernels))
        self.spec = ZeroSpec(stage=stage, axis=axis, num_shards=num_shards,
                             threshold_bytes=threshold_bytes)
        self.op = ReduceOp(op)
        self.wire_dtype = wire_dtype
        self.pre, self.post = prescale_factor, postscale_factor
        self.rs_wire = bool(rs_wire)
        self.process_set, self.mesh = process_set, mesh
        self._plans: Dict[Any, _Plan] = {}
        self._group_cache: Optional[_Group] = None

    # -- hyperparameters (read at every update: a live mapping follows
    #    its optimizer's param group) --------------------------------------

    @property
    def momentum(self) -> float:
        return float(self.hp.get("momentum", 0.0) or 0.0)

    @property
    def n_buffers(self) -> int:
        return 2 if self.kind == "adam" else (1 if self.momentum else 0)

    # -- group, plan, layout -----------------------------------------------

    def group(self) -> Optional[_Group]:
        """The bound reduce group, or None (unbound: no process group,
        or a group of one)."""
        if not dist.is_initialized():
            return None
        if self._group_cache is None:
            self._group_cache = _Group(self.spec.axis, self.mesh,
                                       self.process_set)
        g = self._group_cache
        return None if g.size <= 1 else g

    def plan_for(self, params) -> _Plan:
        leaves = list(params)
        key = tuple((tuple(l.shape), l.dtype) for l in leaves)
        plan = self._plans.get(key)
        if plan is None:
            n = self.spec.num_shards
            if n is None:
                g = self.group()
                n = g.size if g is not None else (
                    global_process_set().size()
                    if dist.is_initialized() else 1)
            plan = self._plans[key] = _make_plan(
                leaves, self.spec.threshold_bytes, n)
        return plan

    def _rows_of(self, n: int) -> int:
        """Rows of a new stack: this rank's one on a bound group, the
        whole ``n`` unbound."""
        return 1 if self.group() is not None else n

    def _mode(self, group: Optional[_Group], n: int, leading) -> str:
        if group is None:
            if leading not in (None, n):
                raise ValueError(f"an unbound ZeRO update takes whole "
                                 f"[{n}, shard_len] stacks, got {leading} "
                                 f"rows")
            return "unbound"
        if group.size != n:
            raise ValueError(
                f"ZeRO state was built for {n} shards but the bound reduce "
                f"group {group.axes} has size {group.size}; reshard the "
                f"state (checkpoint.restore_zero_state) or rebuild the "
                f"transform with num_shards={group.size}")
        if leading is None or (leading == 1 and n > 1):
            return "local"
        return "replicated"

    @staticmethod
    def _own_row(stack: torch.Tensor, mode: str, group) -> torch.Tensor:
        if mode == "unbound":
            return stack.view(-1)
        if mode == "local":
            return stack[0]
        return stack[group.owner]

    # -- init / params -----------------------------------------------------

    def init(self, params):
        """Zero moments: this rank's ``[1, shard_len]`` rows on a bound
        group, whole ``[n, shard_len]`` stacks unbound."""
        params = list(params)
        plan = self.plan_for(params)
        rows = self._rows_of(plan.num_shards)
        device = params[0].device if params else None

        def stacks():
            return tuple(torch.zeros((rows, sl), dtype=dt, device=device)
                         for sl, dt in zip(plan.shard_lens, plan.dtypes))

        record_state_gauges(plan.state_bytes_per_rank(self.n_buffers),
                            self.stage)
        if self.kind == "adam":
            return ZeroAdamState(count=torch.zeros((), dtype=torch.int32),
                                 mu=stacks(), nu=stacks())
        if self.momentum:
            return ZeroSgdState(trace=stacks())
        return ZeroSgdState(trace=())

    def shard_params(self, params):
        """Full parameters → per-bucket flat stacks: this rank's
        ``[1, shard_len]`` row on a bound group, the whole ``[n,
        shard_len]`` stack unbound.  No collective."""
        params = list(params)
        plan = self.plan_for(params)
        rows = self._rows_of(plan.num_shards)
        out = []
        for bi in range(len(plan.buckets)):
            with torch.no_grad():
                stack = _bucket_flat(params, plan, bi).view(
                    plan.num_shards, -1)
            if rows == 1 and plan.num_shards > 1:
                own = self.group().owner
                stack = stack[own:own + 1].clone()
            out.append(stack)
        return tuple(out)

    def gather_params(self, pshards, template) -> List[torch.Tensor]:
        """The full parameters from shard stacks: an all-gather of each
        rank-local row, or a reshape of a whole stack.  Returns tensors
        in ``template``'s order, shapes and dtypes."""
        template = list(template)
        plan = self.plan_for(template)
        cells: List[Any] = [None] * len(template)
        for bi, stack in enumerate(pshards):
            if stack.dim() != 2:
                raise ValueError("param shards must be [n|1, shard_len]")
            if stack.shape[0] == 1 and plan.num_shards > 1:
                full = self.group().all_gather(stack[0],
                                               f"zero.b{bi}.params")
            else:
                full = stack.reshape(-1)
            for i, v in _split_bucket(full, plan, bi).items():
                cells[i] = v if v.dtype == template[i].dtype \
                    else v.to(template[i].dtype)
        return cells

    def full_state(self, state, template) -> Dict[str, Any]:
        """The equivalent replicated state, per leaf in ``template``'s
        order: ``{"count", "mu", "nu"}`` (Adam) or ``{"trace"}`` (SGD
        momentum).  Needs whole stacks (:meth:`gather_state` first for a
        rank-local state)."""
        plan = self.plan_for(template)
        n_leaves = len(plan.leaf_sizes)

        def unstack(stacks):
            cells: List[Any] = [None] * n_leaves
            for bi, stack in enumerate(stacks):
                if stack.shape[0] != plan.num_shards:
                    raise ValueError("full_state needs whole [n, shard_len] "
                                     "stacks; gather_state first")
                for i, v in _split_bucket(stack.reshape(-1), plan,
                                          bi).items():
                    cells[i] = v
            return cells

        if self.kind == "adam":
            return {"count": int(state.count), "mu": unstack(state.mu),
                    "nu": unstack(state.nu)}
        if self.momentum:
            return {"trace": unstack(state.trace)}
        return {}

    def gather_state(self, state):
        """A state with whole ``[n, shard_len]`` stacks: a rank-local
        state's rows all-gathered over the group (every rank calls it),
        a whole one cloned."""
        g = self.group()

        def whole(stack):
            if stack.shape[0] == 1 and g is not None:
                return g.all_gather(stack[0]).view(g.size, -1)
            return stack.clone()

        return _map_state(state, whole)

    def scatter_state(self, full, into) -> None:
        """Copy a whole-stack state ``full`` into ``into``'s stacks in
        place (its own row of each under the rank-local layout), keeping
        ``into``'s storages, so a step captured over them replays from
        the restored values.  The Adam count is copied too."""
        for (name, dst), (_, src) in zip(_state_stacks(into),
                                         _state_stacks(full)):
            for d, s in zip(dst, src):
                s = s.to(d.device)
                if d.shape[0] == 1 and s.shape[0] > 1:
                    own = self.group().owner
                    d.copy_(s[own:own + 1])
                else:
                    d.copy_(s)
        if hasattr(into, "mu"):
            into.count.copy_(torch.as_tensor(int(full.count),
                                              dtype=into.count.dtype))

    def state_bytes_per_rank(self, params) -> int:
        return self.plan_for(params).state_bytes_per_rank(self.n_buffers)

    # -- the update --------------------------------------------------------

    def _route(self, group: _Group) -> _ShardRoute:
        return _ShardRoute(group, self.op, self.pre, self.post,
                           self.wire_dtype, self.rs_wire)

    def pipeline(self, plan: _Plan) -> _ZeroPipeline:
        """A pipeline for the hooked exchange (``DistributedOptimizer``
        under ``HVDT_OVERLAP=on``)."""
        return _ZeroPipeline(self._route(self.group()), plan)

    def _scalars(self, state) -> List[float]:
        """The launch's scalars at the current count, in the kernels'
        order (``ops/optim_kernels._adam_multi`` / ``_sgd_multi``)."""
        from .optim_kernels import _adam_scalars

        hp = self.hp
        if self.kind == "adam":
            b1, b2 = float(hp.get("b1", 0.9)), float(hp.get("b2", 0.999))
            return [*_adam_scalars(int(state.count), hp["learning_rate"],
                                   b1, b2),
                    b1, 1.0 - b1, b2, 1.0 - b2,
                    float(hp.get("eps", 1e-8)),
                    float(hp.get("eps_root", 0.0)), self._wd()]
        return [float(hp["learning_rate"]), self.momentum]

    def _wd(self) -> float:
        return float(self.hp.get("weight_decay", 0.0) or 0.0) \
            if self.kind == "adam" else 0.0

    def _advance(self, state) -> None:
        if self.kind == "adam":
            state.count.add_(1)

    def update(self, grads, state, params=None, *, apply: bool = False,
               shards: Optional[Iterable] = None):
        """One sharded step.  ``grads``: this rank's local gradients (the
        global ones when unbound), in the plan's leaf order, None for
        zeros.  ``params``: the parameter tensors (needed for Adam's
        weight decay under ``states``), or the shard stacks under
        ``params``.  Returns ``(updates, state)``, the state's tensors
        updated in place: under ``states`` the per-leaf deltas (None
        with ``apply=True``, which adds them to ``params`` in place);
        under ``params`` the per-bucket delta stacks in the shards'
        layout (None with ``apply=True``, which applies them to the
        shards in place through the kernels' ``APPLY``).  ``shards``: the
        reduced ``(bucket, shard)`` pairs when the caller exchanged them
        already (the hooked overlap path); each bucket is then updated
        as it arrives."""
        grads = list(grads)
        plan = self.plan_for(grads)
        n = plan.num_shards
        group = self.group()
        if self.stage == "params":
            if params is None:
                raise ValueError(
                    "stage='params' updates need the param shard stacks: "
                    "update(grads, state, params=pshards)")
            pshards, p_leaves = tuple(params), None
        else:
            pshards = None
            p_leaves = list(params) if params is not None else None
        wd = self._wd()
        if wd and params is None:
            raise ValueError("zero adam with weight_decay requires params: "
                             "call update(grads, state, params)")
        if self.stage == "states" and apply and p_leaves is None:
            raise ValueError("apply=True needs the parameters: "
                             "update(grads, state, params, apply=True)")
        stacks = [s for _, ss in _state_stacks(state) for s in ss]
        if pshards:
            stacks.append(pshards[0])
        leading = int(stacks[0].shape[0]) if stacks else None
        mode = self._mode(group, n, leading)

        scalars, rows = self._scalars(state), None
        capturing = graphs.capturing()
        cuda = bool(grads) and any(
            g is not None and g.is_cuda for g in grads)
        kernels = self.use_kernels and cuda and (
            self.kind == "adam" or self.momentum)
        if capturing:
            if not kernels:
                raise ValueError(
                    "under CUDA-graph capture the ZeRO update must take the "
                    "fused kernel (CUDA tensors, use_kernels=True, momentum "
                    "> 0 for SGD): the plain version would bake its scalars "
                    "into the graph")
            rows = self._replay_rows(state, grads)

        out_rows: List[Any] = [None] * len(plan.buckets)
        cells: Dict[int, torch.Tensor] = {}

        def finish(rec: _Rec) -> None:
            bi = rec.bi
            if mode == "replicated":
                for name, ss in _state_stacks(state):
                    if ss:
                        self._emit(ss[bi], group)
                if pshards is not None:
                    self._emit(pshards[bi], group)
            if self.stage == "params":
                if not apply:
                    out_rows[bi] = (rec.d.view(n, -1) if mode == "unbound"
                                    else rec.d[None] if mode == "local"
                                    else group.all_gather(rec.d).view(n, -1))
                return
            full = rec.d if mode == "unbound" else group.all_gather(
                rec.d, f"zero.b{bi}.ag")
            parts = _split_bucket(full, plan, bi)
            if apply:
                ids = list(parts)
                torch._foreach_add_([p_leaves[i] for i in ids],
                                    [parts[i] for i in ids])
            else:
                cells.update(parts)

        def rec_of(bi: int, g: torch.Tensor) -> _Rec:
            m = v = None
            if self.kind == "adam":
                m = self._own_row(state.mu[bi], mode, group)
                v = self._own_row(state.nu[bi], mode, group)
            elif self.momentum:
                m = self._own_row(state.trace[bi], mode, group)
            p = None
            if self.stage == "params":
                p = self._own_row(pshards[bi], mode, group)
            elif wd:
                flat = _bucket_flat(p_leaves, plan, bi)
                if mode != "unbound":
                    sl = plan.shard_lens[bi]
                    flat = flat[group.owner * sl:(group.owner + 1) * sl]
                p = flat
            d = None
            if not (apply and self.stage == "params"):
                d = torch.empty_like(g)
            return _Rec(bi, p, g, m, v, d)

        step_apply = apply and self.stage == "params"
        if mode == "unbound":
            pairs = [(bi, _bucket_flat(grads, plan, bi))
                     for bi in range(len(plan.buckets))]
            per_bucket = False
        elif shards is not None:
            pairs, per_bucket = shards, True
        else:
            pairs = _exchange_shards(grads, plan, self._route(group))
            per_bucket = ovl.get_scheduler() is not None
        with torch.no_grad():
            if per_bucket:
                for bi, g in pairs:
                    rec = rec_of(bi, g)
                    self._launch([rec], scalars, rows, kernels, step_apply)
                    finish(rec)
            else:
                recs = [rec_of(bi, g) for bi, g in pairs]
                self._launch(recs, scalars, rows, kernels, step_apply)
                for rec in recs:
                    finish(rec)
        if not capturing:
            self._advance(state)
        if self.stage == "params":
            return (None if apply else tuple(out_rows)), state
        return (None if apply else [cells[i] for i in range(len(grads))]
                ), state

    def _emit(self, stack: torch.Tensor, group: _Group) -> None:
        """Re-assemble a replicated ``[n, L]`` stack from every rank's
        updated row."""
        row = stack[group.owner].clone()
        stack.view(-1).copy_(group.all_gather(row))

    def _replay_rows(self, state, grads) -> torch.Tensor:
        """The device row a captured update's launches read their scalars
        from, and the replay hook that fills it (then advances the
        count) before each replay."""
        device = next(g.device for g in grads if g is not None)
        # Allocated for the default stream, outside the graph's pool: a
        # pool block may hold a temporary earlier in the replay.
        with torch.cuda.stream(torch.cuda.default_stream(device)):
            rows = torch.empty((1, _ROW), dtype=torch.float32, device=device)

        def refresh() -> None:
            host = np.zeros((1, _ROW), np.float32)
            vals = self._scalars(state)
            host[0, :len(vals)] = vals
            rows.copy_(torch.from_numpy(host).pin_memory(), non_blocking=True)
            self._advance(state)

        graphs.on_replay(refresh)
        return rows

    def _launch(self, recs: List[_Rec], scalars, rows, kernels: bool,
                apply: bool) -> None:
        """The update over ``recs``: one multi-tensor launch of #1/#2 for
        CUDA rows (per dtype combination), else the plain versions."""
        from . import optim_kernels as ok

        hp = self.hp
        if not kernels:
            for r in recs:
                self._plain(r, scalars, apply)
            return
        codes, numels, ptrs = [], [], []
        for r in recs:
            ops = (r.p, r.g, r.m, r.v, r.d)
            ok._check_cuda_leaf(*(t for t in ops if t is not None))
            codes.append(tuple(0 if t is None else ok._DTYPE_CODE[t.dtype]
                               for t in ops))
            numels.append(r.g.numel())
            ptrs.append(tuple(0 if t is None else t.data_ptr() for t in ops))
        device = recs[0].g.device
        dev_scalars = None if rows is None else rows[0].data_ptr()
        for t in ok._build_tables([device] * len(recs), codes, numels,
                                  np.array(ptrs, np.uint64)):
            if self.kind == "adam":
                ok._adam_multi(t, scalars[:3], b1=scalars[3],
                               b2=scalars[5], eps=scalars[7],
                               eps_root=scalars[8], wd=scalars[9],
                               apply=apply, device=device,
                               dev_scalars=dev_scalars)
            else:
                ok._sgd_multi(t, scalars[0], scalars[1],
                              nesterov=bool(hp.get("nesterov", False)),
                              apply=apply, device=device,
                              dev_scalars=dev_scalars)

    def _plain(self, r: _Rec, scalars, apply: bool) -> None:
        from .optim_kernels import _adam_leaf_plain, _sgd_leaf_plain

        if self.kind == "adam":
            d, _, _ = _adam_leaf_plain(
                r.p if r.p is not None else r.g, r.g, r.m, r.v, scalars[:3],
                b1=scalars[3], b2=scalars[5], eps=scalars[7],
                eps_root=scalars[8], wd=scalars[9], apply=apply)
        elif self.momentum:
            d, _ = _sgd_leaf_plain(r.g, r.m, scalars[0],
                                   momentum=scalars[1],
                                   nesterov=bool(self.hp.get("nesterov",
                                                             False)),
                                   p=r.p if apply else None)
        else:
            lr = scalars[0]
            if apply:
                r.p.add_((-lr * r.g.float()).to(r.p.dtype))
                d = None
            else:
                d = (-lr * r.g.float()).to(r.g.dtype)
        if d is not None:
            r.d.copy_(d)


def _map_state(state, fn):
    if hasattr(state, "mu"):
        return ZeroAdamState(count=state.count.clone(),
                             mu=tuple(fn(s) for s in state.mu),
                             nu=tuple(fn(s) for s in state.nu))
    return ZeroSgdState(trace=tuple(fn(s) for s in state.trace))


def zero_transform(optim_spec, *, stage: str = "states", axis=None,
                   op: ReduceOp = ReduceOp.AVERAGE,
                   num_shards: Optional[int] = None,
                   threshold_bytes: Optional[int] = None,
                   wire_dtype: Optional[Any] = None,
                   prescale_factor: float = 1.0,
                   postscale_factor: float = 1.0,
                   use_kernels: Optional[bool] = None,
                   rs_wire: bool = True,
                   process_set: Optional[ProcessSet] = None, mesh=None
                   ) -> ZeroTransformation:
    """The ZeRO-sharded exchange and update for a known optimizer family.

    ``optim_spec``: a mapping ``{"kind": "sgd", "learning_rate",
    "momentum", "nesterov"}`` or ``{"kind": "adam", "learning_rate",
    "b1", "b2", "eps", "eps_root", "weight_decay"}`` (optionally
    ``"use_kernels"``), read at every update.  ``process_set`` /
    ``mesh`` / ``axis`` pick the reduce group as ``fused_allreduce``
    does; with no process group, or a group of one, the transform is
    unbound (the gradients are already global, no collective runs)."""
    tx = _ZeroTx(optim_spec, stage, axis, op, num_shards, threshold_bytes,
                 wire_dtype, prescale_factor, postscale_factor, use_kernels,
                 rs_wire, process_set, mesh)
    return ZeroTransformation(
        init=tx.init, update=tx.update, shard_params=tx.shard_params,
        gather_params=tx.gather_params, full_state=tx.full_state,
        spec=tx.spec, plan_for=tx.plan_for,
        state_bytes_per_rank=tx.state_bytes_per_rank,
        gather_state=tx.gather_state, scatter_state=tx.scatter_state)


def _impl(tx: ZeroTransformation) -> _ZeroTx:
    return tx.update.__self__


def zero_sgd(learning_rate, momentum: float = 0.0, nesterov: bool = False,
             **kw) -> ZeroTransformation:
    """:func:`zero_transform` for the SGD-momentum family."""
    return zero_transform(
        {"kind": "sgd", "learning_rate": learning_rate,
         "momentum": momentum, "nesterov": nesterov}, **kw)


def zero_adam(learning_rate, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8, eps_root: float = 0.0,
              weight_decay: float = 0.0, **kw) -> ZeroTransformation:
    """:func:`zero_transform` for the Adam/AdamW family."""
    return zero_transform(
        {"kind": "adam", "learning_rate": learning_rate, "b1": b1,
         "b2": b2, "eps": eps, "eps_root": eps_root,
         "weight_decay": weight_decay}, **kw)


class _LiveSpec:
    """The hyperparameters of a ``FusedSGD`` / ``FusedAdam``, read from
    its param groups at every update (a learning-rate change reaches the
    sharded step as it reaches the replicated one)."""

    def __init__(self, optimizer):
        from .optim_kernels import FusedAdam

        self._opt = optimizer
        self._adam = isinstance(optimizer, FusedAdam)

    def get(self, key, default=None):
        group = self._opt.param_groups[0]
        if key == "kind":
            return "adam" if self._adam else "sgd"
        if key == "use_kernels":
            return self._opt.use_kernels
        if key == "learning_rate" and not self._adam:
            key = "lr"
        return group.get(key, default)

    def __getitem__(self, key):
        return self.get(key)


_HYPER = ("lr", "momentum", "nesterov", "learning_rate", "b1", "b2", "eps",
          "eps_root", "weight_decay")


def zero_from_optimizer(optimizer, *, stage: str, axis=None,
                        op: ReduceOp = ReduceOp.AVERAGE,
                        num_shards: Optional[int] = None,
                        threshold_bytes: Optional[int] = None,
                        wire_dtype: Optional[Any] = None,
                        prescale_factor: float = 1.0,
                        postscale_factor: float = 1.0,
                        rs_wire: bool = True,
                        process_set: Optional[ProcessSet] = None, mesh=None
                        ) -> ZeroTransformation:
    """Route a ``FusedSGD`` / ``FusedAdam`` through :func:`zero_transform`
    (the ``DistributedOptimizer(..., zero=...)`` dispatch); its
    hyperparameters are read from its param groups at every update, so
    every group must carry the same ones."""
    from .optim_kernels import FusedAdam, FusedSGD

    if not isinstance(optimizer, (FusedSGD, FusedAdam)):
        raise ValueError(
            "HVDT_ZERO stages 'states'/'params' shard the optimizer update "
            "itself, so the optimizer's math must be known: build it with "
            "hvd.fused_adam(...) / hvd.fused_sgd(...) (stage 'grads' "
            "composes with any torch.optim optimizer)")
    first = {k: v for k, v in optimizer.param_groups[0].items()
             if k in _HYPER}
    for g in optimizer.param_groups[1:]:
        if {k: v for k, v in g.items() if k in _HYPER} != first:
            raise ValueError("a ZeRO-sharded update takes one set of "
                             "hyperparameters: every param group must "
                             "carry the same ones")
    return zero_transform(
        _LiveSpec(optimizer), stage=stage, axis=axis, op=op,
        num_shards=num_shards, threshold_bytes=threshold_bytes,
        wire_dtype=wire_dtype, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, rs_wire=rs_wire,
        process_set=process_set, mesh=mesh)


# ---------------------------------------------------------------------------
# Checkpoint metadata and resharding (host numpy, as in the reference)
# ---------------------------------------------------------------------------


def _np(t) -> np.ndarray:
    """A host numpy copy of a tensor (bf16 through ml_dtypes where it is
    installed)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def state_metadata(tx: ZeroTransformation, params) -> Dict[str, Any]:
    """JSON-serializable layout descriptor saved next to a sharded
    checkpoint (the reference's keys and values; dtypes by numpy
    name)."""
    plan = tx.plan_for(params)
    return {
        "zero_stage": tx.spec.stage,
        "num_shards": plan.num_shards,
        "threshold_bytes": plan.threshold_bytes,
        "align": shard_align(),
        "buckets": [
            {"size": int(s), "shard_len": int(sl),
             "dtype": dev._dtype_name(dt)}
            for s, sl, dt in zip(plan.sizes, plan.shard_lens,
                                 plan.dtypes)],
    }


def extract_shard_rows(state, shard_index: int) -> Dict[str, Any]:
    """One shard's rows of every ``[n, shard_len]`` stack as host numpy,
    keyed as :func:`checkpoint.save_zero_state` keys them (``mu_0``,
    ``nu_0``, ``trace_0``, ..., plus ``count`` for Adam)."""
    s = int(shard_index)
    rows: Dict[str, Any] = {}
    if hasattr(state, "mu"):
        rows["count"] = np.asarray(int(state.count), np.int32)
    for name, bufs in _state_stacks(state):
        for bi, stack in enumerate(bufs):
            rows[f"{name}_{bi}"] = _np(stack[s])
    return rows


def implant_shard_rows(state, shard_index: int, rows: Dict[str, Any]):
    """Inverse of :func:`extract_shard_rows`: a new state with row
    ``shard_index`` of every stack replaced."""
    s = int(shard_index)

    def patch(stacks, name):
        out = []
        for bi, stack in enumerate(stacks):
            new = stack.detach().clone()
            new[s] = _tensor(rows[f"{name}_{bi}"]).to(new.device)
            out.append(new)
        return tuple(out)

    if hasattr(state, "mu"):
        count = state.count.clone()
        if "count" in rows:
            count = torch.as_tensor(int(np.asarray(rows["count"])),
                                    dtype=torch.int32)
        return ZeroAdamState(count=count, mu=patch(state.mu, "mu"),
                             nu=patch(state.nu, "nu"))
    return ZeroSgdState(trace=patch(state.trace, "trace"))


def _reshard_stack(stack, logical_size: int, new_n: int, align: int):
    """[n_old, L_old] → [n_new, L_new]: concatenate, drop the alignment
    padding, re-pad for the new shard count."""
    flat = _np(stack).reshape(-1)[:logical_size]
    new_len = -(-logical_size // (new_n * align)) * align
    out = np.zeros((new_n * new_len,), flat.dtype)
    out[:logical_size] = flat
    return out.reshape(new_n, new_len)


def reshard_state(state, meta: Dict[str, Any], new_num_shards: int):
    """Re-shard a saved ZeRO state onto another shard count (host
    numpy).  Returns ``(new_state, new_meta)``."""
    align = int(meta.get("align", 256))
    sizes = [int(b["size"]) for b in meta["buckets"]]

    def reshard_all(stacks):
        return tuple(_tensor(_reshard_stack(s, sz, new_num_shards, align))
                     for s, sz in zip(stacks, sizes))

    if hasattr(state, "mu"):
        new_state = ZeroAdamState(
            count=torch.as_tensor(int(state.count), dtype=torch.int32),
            mu=reshard_all(state.mu), nu=reshard_all(state.nu))
    else:
        new_state = ZeroSgdState(trace=reshard_all(state.trace))
    new_meta = dict(meta)
    new_meta["num_shards"] = int(new_num_shards)
    new_meta["buckets"] = [
        {"size": sz,
         "shard_len": -(-sz // (new_num_shards * align)) * align,
         "dtype": b["dtype"]}
        for sz, b in zip(sizes, meta["buckets"])]
    return new_state, new_meta


def flatten_state_buffers(state, meta: Dict[str, Any]) -> Dict[str, Any]:
    """``{buffer_name: global logical vector}`` (host numpy): every
    stack stripped of its alignment padding, concatenated in bucket
    order."""
    sizes = [int(b["size"]) for b in meta["buckets"]]
    out = {}
    for name, stacks in _state_stacks(state):
        out[name] = np.concatenate(
            [_np(s).reshape(-1)[:sz] for s, sz in zip(stacks, sizes)]) \
            if stacks else np.zeros((0,), np.float32)
    return out


def _split_logical(flat, buckets, num_shards: int):
    """Re-split one global logical vector into ``[num_shards,
    shard_len]`` stacks per the target bucket list."""
    stacks = []
    off = 0
    for b in buckets:
        sz, sl = int(b["size"]), int(b["shard_len"])
        chunk = flat[off:off + sz]
        off += sz
        padded = np.zeros((num_shards * sl,), chunk.dtype)
        padded[:sz] = chunk
        stacks.append(_tensor(padded.reshape(num_shards, sl)))
    if off != flat.size:
        raise ValueError(
            f"target buckets cover {off} elements but the saved state "
            f"holds {flat.size} — the layouts describe different "
            "parameter sets")
    return tuple(stacks)


def rebucket_state(state, meta: Dict[str, Any], new_meta: Dict[str, Any]):
    """Re-lay a saved ZeRO state onto another bucketization and/or shard
    count (same total logical size) via the global flat vector."""
    flats = flatten_state_buffers(state, meta)
    n = int(new_meta["num_shards"])
    buckets = new_meta["buckets"]
    if hasattr(state, "mu"):
        return ZeroAdamState(
            count=torch.as_tensor(int(state.count), dtype=torch.int32),
            mu=_split_logical(flats["mu"], buckets, n),
            nu=_split_logical(flats["nu"], buckets, n))
    return ZeroSgdState(trace=_split_logical(flats["trace"], buckets, n))


def concat_states(states, metas):
    """Concatenate per-pipeline-stage ZeRO states (stage-major) into one
    ``(state, meta)``; the combined meta carries ``layout={"pp":
    n_stages, "dp": num_shards}``."""
    if not states:
        raise ValueError("concat_states needs at least one state")
    first = metas[0]
    for m in metas[1:]:
        if int(m["num_shards"]) != int(first["num_shards"]):
            raise ValueError("stage checkpoints disagree on num_shards")
        if int(m.get("align", 256)) != int(first.get("align", 256)):
            raise ValueError("stage checkpoints disagree on alignment")
    kinds = {hasattr(s, "mu") for s in states}
    if len(kinds) != 1:
        raise ValueError("stage checkpoints mix Adam and SGD states")
    buffers = {}
    for name, _ in _state_stacks(states[0]):
        buffers[name] = tuple(
            stack for st in states
            for stack in dict(_state_stacks(st))[name])
    if hasattr(states[0], "mu"):
        state = ZeroAdamState(
            count=torch.as_tensor(int(states[0].count), dtype=torch.int32),
            mu=buffers["mu"], nu=buffers["nu"])
    else:
        state = ZeroSgdState(trace=buffers["trace"])
    meta = dict(first)
    meta["buckets"] = [dict(b) for m in metas for b in m["buckets"]]
    meta["layout"] = {"pp": len(states), "dp": int(first["num_shards"])}
    return state, meta
