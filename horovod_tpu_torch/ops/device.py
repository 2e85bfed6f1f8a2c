"""Collectives on tensors and the fused (bucketed) gradient allreduce.

The PyTorch counterpart of the JAX package's ``ops/device.py``.  There
the collectives are XLA programs over a mesh axis; here they are
``torch.distributed`` calls over a process set's group (NCCL on the
card, gloo on the CPU).

Average is a Sum followed by a division by the set size on every
backend: gloo has no ``ReduceOp.AVG``, and one formula keeps NCCL and
gloo results the same.  (The quantized wire is the exception: it
multiplies by f32 ``1/n``, as the JAX package's quantized collective
does.)
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..common import config
from ..common.process_sets import ProcessSet, global_process_set
from ..common.types import ReduceOp

log = logging.getLogger(__name__)

__all__ = ["allreduce", "allgather", "allgather_ragged", "reduce_scatter",
           "alltoall", "alltoall_uneven", "broadcast", "fused_allreduce",
           "fused_allreduce_buckets", "resolve_transport",
           "reduce_scatter_flat", "allgather_flat_shards",
           "shard_owner_index"]

_DIST_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM,
             ReduceOp.AVERAGE: dist.ReduceOp.SUM,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT}


def _reduce_(buf: torch.Tensor, op: ReduceOp, ps: ProcessSet,
             group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """All-reduce ``buf`` in place over ``group`` (default: the set's
    group); returns the reduced tensor (a new one for an integer
    Average, which turns float, and for Adasum, ``ops/adasum.py``)."""
    op = ReduceOp(op)
    if op == ReduceOp.ADASUM:
        from .adasum import adasum_allreduce

        return adasum_allreduce(buf, ps, group=group)
    dist.all_reduce(buf, _DIST_OPS[op],
                    group=ps.group if group is None else group)
    if op == ReduceOp.AVERAGE:
        if buf.is_floating_point():
            return buf.div_(ps.size())
        return buf / ps.size()
    return buf


def allreduce(tensor: torch.Tensor, op: ReduceOp = ReduceOp.AVERAGE,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Allreduce over the process set; returns a new tensor.  The scales
    apply before and after the reduction, as in the JAX package."""
    ps = process_set or global_process_set()
    out = (tensor * prescale_factor if prescale_factor != 1.0
           else tensor.clone()).contiguous()
    out = _reduce_(out, op, ps)
    if postscale_factor != 1.0:
        out = out.mul_(postscale_factor)
    return out


def allgather(tensor: torch.Tensor, concat_axis: int = 0, *,
              tiled: bool = True,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Allgather over the process set: every rank's tensor concatenated
    along ``concat_axis`` in rank order (``tiled=False`` stacks them on
    a new axis there instead), as ``lax.all_gather`` does."""
    ps = process_set or global_process_set()
    n = ps.size()
    t = tensor.detach()
    gathered = t.new_empty((n,) + tuple(t.shape))
    # Row r of [n, ...] is rank r's [1, ...]: the concatenated layout
    # every backend takes.
    dist.all_gather_into_tensor(gathered, t.unsqueeze(0).contiguous(),
                                group=ps.group)
    if not tiled:
        return gathered.movedim(0, concat_axis).contiguous()
    return torch.cat(list(gathered.unbind(0)), dim=concat_axis)


def allgather_ragged(tensor: torch.Tensor, sizes: Sequence[int],
                     process_set: Optional[ProcessSet] = None
                     ) -> torch.Tensor:
    """Allgather where set rank r contributes its first ``sizes[r]`` rows.
    Every rank passes a tensor padded to ``max(sizes)`` rows (rows past
    its own size are ignored), as in the JAX package, whose shapes are
    static; returns the ``sum(sizes)``-row concatenation in set-rank
    order."""
    ps = process_set or global_process_set()
    sizes = [int(s) for s in sizes]
    n = ps.size()
    if len(sizes) != n:
        raise ValueError(f"len(sizes)={len(sizes)} != set size {n}")
    maxpad = max(sizes)
    if tensor.shape[0] != maxpad:
        raise ValueError(
            f"ragged allgather input must be padded to max(sizes)="
            f"{maxpad} rows, got {tensor.shape[0]}")
    gathered = allgather(tensor, tiled=False, process_set=ps)
    return torch.cat([gathered[r, :sizes[r]] for r in range(n)])


def alltoall_uneven(tensor: torch.Tensor,
                    send_splits: Sequence[Sequence[int]],
                    process_set: Optional[ProcessSet] = None):
    """All-to-all with per-(src, dst) row counts: ``send_splits[r][j]``
    rows go from set rank r to set rank j, each rank's rows summing to
    the (uniform) input's first dimension.  As in the JAX package, the
    output is padded to the largest receive total; returns ``(out,
    recv_count)`` with the rows received in source order, zeros past
    them, and this rank's count as an int32 scalar tensor."""
    ps = process_set or global_process_set()
    m = [[int(v) for v in row] for row in send_splits]
    n = ps.size()
    if len(m) != n or any(len(row) != n for row in m):
        raise ValueError(f"send_splits must be {n}x{n}")
    row_tot = {sum(row) for row in m}
    if len(row_tot) != 1:
        raise ValueError(
            "each rank's send_splits row must sum to the same (uniform) "
            f"input length, got sums {sorted(row_tot)}")
    in_rows = row_tot.pop()
    if tensor.shape[0] != in_rows:
        raise ValueError(
            f"input rows {tensor.shape[0]} != send_splits row sum {in_rows}")
    me = ps.rank()
    recv = [m[r][me] for r in range(n)]
    max_out = max(sum(m[r][j] for r in range(n)) for j in range(n))
    rest = tuple(tensor.shape[1:])
    got = tensor.new_empty((sum(recv),) + rest)
    dist.all_to_all_single(got, tensor.detach().contiguous(),
                           output_split_sizes=recv,
                           input_split_sizes=m[me], group=ps.group)
    out = tensor.new_zeros((max_out,) + rest)
    out[:got.shape[0]] = got
    return out, torch.tensor(sum(recv), dtype=torch.int32,
                             device=tensor.device)


def _split_rows(t: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """[..., n*c, ...] -> [n, ..., c, ...] (chunk j along ``axis`` is row
    j), contiguous; raises unless ``axis`` divides by n."""
    if t.shape[axis] % n:
        raise ValueError(f"dimension {axis} ({t.shape[axis]}) is not "
                         f"divisible by the set size {n}")
    return torch.stack(t.chunk(n, dim=axis))


def reduce_scatter(tensor: torch.Tensor, scatter_axis: int = 0,
                   op: ReduceOp = ReduceOp.SUM,
                   process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Reduce over the process set and keep this rank's chunk of
    ``scatter_axis`` (chunk r on rank r).  Average divides the sum by
    the set size, as ``horovod_tpu.ops.device.reduce_scatter`` does."""
    ps = process_set or global_process_set()
    op = ReduceOp(op)
    if op == ReduceOp.ADASUM:
        raise ValueError(f"Unsupported reduce op: {op}")
    n = ps.size()
    rows = _split_rows(tensor.detach(), scatter_axis, n)
    out = rows.new_empty((1,) + rows.shape[1:])
    dist.reduce_scatter_tensor(out, rows, _DIST_OPS[op], group=ps.group)
    out = out[0]
    if op == ReduceOp.AVERAGE:
        out = out / n
    return out


def alltoall(tensor: torch.Tensor, split_axis: int = 0,
             concat_axis: int = 0,
             process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Equal-split all-to-all: chunk j of ``split_axis`` goes to rank j,
    and the chunks received are concatenated along ``concat_axis`` in
    rank order, as ``lax.all_to_all(..., tiled=True)`` does."""
    ps = process_set or global_process_set()
    rows = _split_rows(tensor.detach(), split_axis, ps.size())
    recv = torch.empty_like(rows)
    dist.all_to_all_single(recv, rows, group=ps.group)
    return torch.cat(list(recv.unbind(0)), dim=concat_axis)


def broadcast(tensor: torch.Tensor, root_rank: int = 0,
              process_set: Optional[ProcessSet] = None) -> torch.Tensor:
    """Broadcast from the set's ``root_rank``; returns a new tensor."""
    ps = process_set or global_process_set()
    out = tensor.detach().clone().contiguous()
    dist.broadcast(out, src=ps.global_rank(root_rank), group=ps.group)
    return out


# ---------------------------------------------------------------------------
# Tensor fusion: bucketed fused allreduce over a list of gradients.  A
# bucket is one flat buffer per (dtype, bucket) and one all_reduce; the
# results are views into it.
# ---------------------------------------------------------------------------

_threshold_warned = False


def _validated_threshold(threshold_bytes: Optional[Any] = None) -> int:
    """Resolve and validate the fusion threshold.

    ``None`` reads ``HVDT_FUSION_THRESHOLD``.  Non-positive or
    unparseable values clamp to the registry default with a one-time
    warning, as in the JAX package."""
    global _threshold_warned

    if threshold_bytes is None:
        threshold_bytes = config.get_int("HVDT_FUSION_THRESHOLD")
    try:
        t = int(threshold_bytes)
    except (TypeError, ValueError):
        t = -1
    if t <= 0:
        default = int(config.KNOBS["HVDT_FUSION_THRESHOLD"].default)
        if not _threshold_warned:
            log.warning(
                "invalid fusion threshold %r (HVDT_FUSION_THRESHOLD or "
                "caller override); clamping to the default %d bytes",
                threshold_bytes, default)
            _threshold_warned = True
        return default
    return t


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy-style dtype name ("float32", "bfloat16", "bool"): the key
    the JAX package sorts dtype groups by."""
    return str(dtype).rsplit(".", 1)[-1]


def fused_allreduce_buckets(leaves: Sequence[torch.Tensor],
                            threshold_bytes: Optional[Any]
                            ) -> List[List[int]]:
    """Plan fusion buckets: group leaf indices by dtype and pack up to
    ``threshold_bytes`` per bucket, each leaf rounded up to 64 bytes.

    The plan equals the JAX package's for the same (shape, dtype) list:
    dtype groups come in canonical dtype-name order, and within a dtype
    the input order is kept."""
    threshold_bytes = _validated_threshold(threshold_bytes)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)
    buckets: List[List[int]] = []
    for dtype, idxs in sorted(by_dtype.items(),
                              key=lambda kv: _dtype_name(kv[0])):
        cur: List[int] = []
        cur_bytes = 0
        itemsize = dtype.itemsize
        for i in idxs:
            nbytes = -(-leaves[i].numel() * itemsize // 64) * 64
            if cur and cur_bytes + nbytes > threshold_bytes:
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += nbytes
        if cur:
            buckets.append(cur)
    return buckets


def _reduce_group(axis, mesh, ps: ProcessSet):
    """The reduce group a transport policy resolves for an exchange over
    ``ps``: the ``axis`` given (a mesh-axis name or tuple of them), else
    every dimension of ``mesh`` (default: the current mesh, which
    ``parallel.make_mesh`` records) when ``ps`` is the whole world, else
    the single axis ``"dp"`` (the set's own group).  Returns ``(axes,
    mesh)``."""
    from ..common.basics import current_mesh

    if mesh is None:
        mesh = current_mesh()
    if axis is not None:
        return ((axis,) if isinstance(axis, str) else tuple(axis)), mesh
    if mesh is not None and ps.size() == mesh.size() \
            and ps is global_process_set():
        return tuple(mesh.mesh_dim_names), mesh
    return ("dp",), mesh


def _rs_hop_order(axis) -> tuple:
    """Sequential reduce-scatter hop order over a reduce group (mesh-axis
    names, outermost first): innermost axis first, so the full payload
    rides the fast links and only the 1/n_fast shard crosses the slow
    outer tier."""
    return tuple(reversed((axis,) if isinstance(axis, str) else tuple(axis)))


def _hops(axis=None, mesh=None, process_set: Optional[ProcessSet] = None):
    """``[(axis name, group)]`` in :func:`_rs_hop_order` for the reduce
    group :func:`_reduce_group` resolves: one hop a dimension of
    ``mesh`` when every axis names one of its dimensions, else the
    process set's own group as the single hop (a group of one axis)."""
    ps = process_set or global_process_set()
    axes, mesh = _reduce_group(axis, mesh, ps)
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if mesh is not None and all(a in names for a in axes):
        return [(a, mesh.get_group(a)) for a in _rs_hop_order(axes)]
    if len(axes) > 1:
        raise ValueError(f"reduce group {axes} names axes that are not "
                         f"dimensions of the current mesh {names}")
    return [(axes[0], ps.group)]


def _scatter_hops(flat: torch.Tensor, groups) -> torch.Tensor:
    """One tiled ``reduce_scatter_tensor`` (a sum) a group, in order."""
    shard = flat.detach().reshape(-1).contiguous()
    for group in groups:
        k = dist.get_world_size(group)
        if shard.numel() % k:
            raise ValueError(f"a flat vector of {shard.numel()} elements "
                             f"does not split over {k} ranks")
        out = shard.new_empty(shard.numel() // k)
        dist.reduce_scatter_tensor(out, shard, dist.ReduceOp.SUM,
                                   group=group)
        shard = out
    return shard


def _gather_hops(shard: torch.Tensor, groups) -> torch.Tensor:
    """The inverse of :func:`_scatter_hops` over the same groups: one
    ``all_gather_into_tensor`` a group, in reverse order."""
    full = shard.detach().reshape(-1).contiguous()
    for group in reversed(list(groups)):
        out = full.new_empty(full.numel() * dist.get_world_size(group))
        dist.all_gather_into_tensor(out, full, group=group)
        full = out
    return full


def reduce_scatter_flat(flat: torch.Tensor, axis=None, mesh=None,
                        process_set: Optional[ProcessSet] = None
                        ) -> torch.Tensor:
    """Tiled reduce-scatter (a sum) of a flat vector over a (possibly
    multi-axis) reduce group: one ``reduce_scatter_tensor`` a hop in
    :func:`_rs_hop_order`.  ``flat``'s length must divide by the group
    size.  Rank ``shard_owner_index(axis)`` receives its contiguous 1/n
    chunk of the summed vector: the ZeRO wire primitive
    (``ops/zero.py``)."""
    return _scatter_hops(flat, [g for _, g in _hops(axis, mesh,
                                                    process_set)])


def allgather_flat_shards(shard: torch.Tensor, axis=None, mesh=None,
                          process_set: Optional[ProcessSet] = None
                          ) -> torch.Tensor:
    """Inverse of :func:`reduce_scatter_flat`: the shards reassembled in
    owner order, so every rank of the group holds the whole vector."""
    return _gather_hops(shard, [g for _, g in _hops(axis, mesh,
                                                    process_set)])


def shard_owner_index(axis=None, mesh=None,
                      process_set: Optional[ProcessSet] = None) -> int:
    """The chunk this rank owns after :func:`reduce_scatter_flat` (the
    first hop's rank is the most significant digit), as the JAX
    package numbers it."""
    idx = 0
    for _, group in _hops(axis, mesh, process_set):
        idx = idx * dist.get_world_size(group) + dist.get_rank(group)
    return idx


def resolve_transport(axis=None, mesh=None,
                      process_set: Optional[ProcessSet] = None):
    """``(ResolvedTransport or None, mesh)`` for an exchange over
    ``process_set``: None when ``HVDT_TRANSPORT`` is unset or the policy
    has nothing to say about the reduce group (:func:`_reduce_group`)."""
    from ..transport import policy as _tpolicy

    if _tpolicy.get_policy() is None:
        return None, mesh
    axes, mesh = _reduce_group(axis, mesh, process_set
                               or global_process_set())
    return _tpolicy.resolve_axis(axes), mesh


def _policy_wire(res, wire_dtype):
    """A flat resolution's per-axis wire, where the caller gave none."""
    from ..quant.collectives import INT4_WIRE, INT8_WIRE

    if res is None or res.kind != "flat" or wire_dtype is not None:
        return wire_dtype
    return {"bf16": torch.bfloat16, "fp16": torch.float16,
            "int8": INT8_WIRE, "int4": INT4_WIRE}.get(res.fast.wire)


class _Bucket:
    """One started bucket: what its two finish halves need."""

    __slots__ = ("kind", "state", "work", "dtype", "red")

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype
        self.kind = self.state = self.work = self.red = None


class _BucketRoute:
    """How each bucket of one exchange is reduced: the routing that
    :func:`fused_allreduce` and the overlapped exchange
    (``ops/overlap.py``) share, resolved once an exchange (transport
    policy, wire, threshold).

    A bucket is started (:meth:`start`), then finished in two halves:
    :meth:`finish_comm`, the collective's own second half (the
    hierarchical gather, the quantized wire's second stage, the
    postscale), which the overlapped exchange runs on its communication
    stream, and :meth:`finish`, on the caller's stream: the wait and the
    division of an ``async_op`` all-reduce, and the cast back."""

    def __init__(self, op: ReduceOp, threshold_bytes: Optional[int],
                 prescale_factor: float, postscale_factor: float,
                 wire_dtype: Optional[Any], process_set: Optional[ProcessSet],
                 axis=None, mesh=None):
        from ..quant.collectives import quant_wire_leg

        self.op = ReduceOp(op)
        self.ps = process_set or global_process_set()
        self.res, self.mesh = resolve_transport(axis, mesh, self.ps)
        if self.res is not None:
            if threshold_bytes is None:
                threshold_bytes = self.res.threshold_bytes
            wire_dtype = _policy_wire(self.res, wire_dtype)
        self.threshold = _validated_threshold(threshold_bytes)
        self.hier = (self.res is not None
                     and self.res.kind == "hierarchical"
                     and self.op in (ReduceOp.SUM, ReduceOp.AVERAGE))
        self.quant_leg = quant_wire_leg(wire_dtype)
        # The quantized path owns the wire format.
        self.wire_dtype = None if self.quant_leg is not None else wire_dtype
        self.pre, self.post = prescale_factor, postscale_factor
        self._axis, self._mesh_arg = axis, mesh
        self._label: Optional[str] = None

    def axis_label(self) -> str:
        """The reduce group's mesh axes joined by ``+`` (the telemetry
        ``axis`` label, as the reference labels its device path)."""
        if self._label is None:
            axes, _ = _reduce_group(self._axis, self._mesh_arg, self.ps)
            self._label = "+".join(axes)
        return self._label

    def _record(self, flat: torch.Tensor, orig_dtype: torch.dtype,
                count: int, index: int, floating: bool) -> None:
        """Telemetry for one bucket as it is reduced: the fusion fill,
        and — for a bucket that the quantized or hierarchical path does
        not book itself — the collective counters and one flight-recorder
        event (``path="jit"``, the reference's label for this path).
        Each executed bucket counts once; inside a CUDA-graph capture the
        recorders book once per replay (``telemetry/instrument``)."""
        from ..telemetry import flight_recorder as _frm
        from ..telemetry import instrument as _ti

        rec = _ti.get_recorder()
        flight = _frm.get_flight_recorder()
        if rec is None and flight is None:
            return
        hier_bucket = self.hier and floating
        quant_bucket = self.quant_leg is not None and floating
        nbytes = flat.numel() * flat.element_size()
        if (self.wire_dtype is not None and floating and not hier_bucket):
            nbytes = flat.numel() * self.wire_dtype.itemsize
            wire = _dtype_name(self.wire_dtype)
        else:
            wire = _dtype_name(flat.dtype)
        dtype, axis = _dtype_name(orig_dtype), self.axis_label()
        if rec is not None:
            rec.observe_fusion_fill(nbytes / float(self.threshold))
            if not quant_bucket and not hier_bucket:
                rec.record_collective("allreduce", dtype, wire, nbytes,
                                      count=count, path="jit", axis=axis)
        if flight is not None and not quant_bucket:
            flight.record(
                op="allreduce",
                name=f"hier.b{index}" if hier_bucket else f"fused.b{index}",
                dtype=dtype, shape=(flat.numel(),), nbytes=nbytes,
                wire=(f"{self.res.fast.wire}/{self.res.slow.wire}"
                      if hier_bucket else wire),
                path="jit", count=count, axis=axis)

    def wire_bytes(self, flat: torch.Tensor) -> int:
        """The bytes a rank puts on the wire for bucket ``flat``."""
        floating = flat.is_floating_point()
        if self.hier and floating:
            from ..transport.hierarchy import wire_bytes_estimate

            return (wire_bytes_estimate(self.res, flat.numel(),
                                        flat.element_size(), self.mesh)
                    or flat.numel() * flat.element_size())
        if self.quant_leg is not None and floating:
            from ..quant import kernels as qk

            wb = qk.wire_bytes_int4 if self.quant_leg == "int4" \
                else qk.wire_bytes
            return int(wb(flat.numel(), qk.quant_block_size()))
        if self.wire_dtype is not None and floating:
            return flat.numel() * self.wire_dtype.itemsize
        return flat.numel() * flat.element_size()

    def start(self, flat: torch.Tensor, async_op: bool = False,
              count: int = 1, index: int = 0) -> _Bucket:
        """Start reducing the flat bucket ``flat`` (which it may consume).
        ``async_op``: a plain all-reduce is issued with ``async_op=True``
        and waited in :meth:`finish`; otherwise it completes here.
        ``count`` (the bucket's tensors) and ``index`` (its place in the
        exchange) label its telemetry."""
        b = _Bucket(flat.dtype)
        floating = flat.is_floating_point()
        self._record(flat, flat.dtype, count, index, floating)
        if self.hier and floating:
            from ..transport.hierarchy import hierarchical_allreduce_start

            b.kind = "hier"
            b.state = hierarchical_allreduce_start(
                flat, self.res, self.op, self.pre, self.mesh)
        elif self.quant_leg is not None and floating:
            from ..quant.collectives import quantized_allreduce_start

            b.kind = "quant"
            b.state = quantized_allreduce_start(
                flat, self.op, prescale_factor=self.pre,
                wire=self.quant_leg, process_set=self.ps,
                axis=self.axis_label())
        else:
            if (self.wire_dtype is not None and floating
                    and flat.dtype != self.wire_dtype):
                flat = flat.to(self.wire_dtype)
            if self.pre != 1.0:
                flat.mul_(self.pre)
            if async_op and self.op != ReduceOp.ADASUM:
                b.kind, b.state = "async", flat
                b.work = dist.all_reduce(flat, _DIST_OPS[self.op],
                                         group=self.ps.group, async_op=True)
            else:
                b.kind, b.state = "reduced", _reduce_(flat, self.op, self.ps)
        return b

    def finish_comm(self, b: _Bucket) -> None:
        """The collective's second half (nothing for an ``async`` bucket,
        whose rest waits for its work in :meth:`finish`)."""
        if b.kind == "async":
            return
        if b.kind == "hier":
            from ..transport.hierarchy import hierarchical_allreduce_finish

            b.red = hierarchical_allreduce_finish(b.state, self.post)
        elif b.kind == "quant":
            from ..quant.collectives import quantized_allreduce_finish

            b.red = quantized_allreduce_finish(b.state, self.post)
        else:
            b.red = b.state.mul_(self.post) if self.post != 1.0 else b.state
        b.state = None

    def finish(self, b: _Bucket) -> torch.Tensor:
        """The reduced bucket in its own dtype, after :meth:`finish_comm`
        (an ``async`` bucket is waited for here, on the current stream)."""
        if b.kind == "async":
            b.work.wait()
            red = b.state
            if self.op == ReduceOp.AVERAGE:
                red = red.div_(self.ps.size()) if red.is_floating_point() \
                    else red / self.ps.size()
            if self.post != 1.0:
                red = red.mul_(self.post)
        else:
            red = b.red
        if red.dtype != b.dtype:
            red = red.to(b.dtype)
        return red


def fused_allreduce(tensors: Sequence[torch.Tensor],
                    op: ReduceOp = ReduceOp.AVERAGE,
                    threshold_bytes: Optional[int] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    wire_dtype: Optional[Any] = None,
                    process_set: Optional[ProcessSet] = None, *,
                    axis=None, mesh=None) -> List[torch.Tensor]:
    """Allreduce a list of tensors as few fused flat collectives.

    Each bucket is concatenated into one flat buffer (cast to
    ``wire_dtype`` when one is given and the bucket is floating), reduced
    by one ``all_reduce`` (``op=Adasum``: ``ops/adasum.py`` over the
    bucket), cast back, and split; the returned tensors are views into
    the reduced buffers, in input order and shapes.  The quantized-wire
    sentinels (``Compression.int8`` / ``.int4`` ``wire_dtype``) instead
    send each float bucket through the two-stage quantized allreduce
    (``quant/collectives.py``); other buckets keep the exact path.

    Transport policies (``HVDT_TRANSPORT``, ``horovod_tpu_torch/
    transport``): when the policy resolves the reduce group
    hierarchically, float SUM/AVERAGE buckets take the two-level
    allreduce (fast-tier reduce-scatter, slow-tier shard exchange,
    all-gather) over the process groups of ``mesh``'s dimensions; a
    single-axis flat resolution only overrides the wire (where
    ``wire_dtype`` is None) and the threshold (where ``threshold_bytes``
    is None).  The reduce group is ``axis`` (a mesh-axis name or a tuple
    of them), or by default every dimension of ``mesh``, which defaults
    to the current mesh that ``parallel.make_mesh`` records (the
    reference's ``hvd.mesh()``), when the process set is the world; with
    no mesh it is the single axis ``"dp"``.  With ``HVDT_TRANSPORT``
    unset neither argument is read and the flat path runs as it did
    without the policy layer.

    Telemetry (``HVDT_TELEMETRY``, ``HVDT_FLIGHT_RECORDER``): each bucket
    records its fusion fill and, unless the quantized or hierarchical
    path books it, one ``path="jit"`` collective series entry and flight
    event, each time it is reduced (a CUDA-graph replay included)."""
    tensors = list(tensors)
    if not tensors:
        return []
    route = _BucketRoute(op, threshold_bytes, prescale_factor,
                         postscale_factor, wire_dtype, process_set, axis, mesh)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for bi, bucket in enumerate(fused_allreduce_buckets(tensors,
                                                        route.threshold)):
        parts = [tensors[i] for i in bucket]
        b = route.start(torch.cat([p.detach().reshape(-1) for p in parts]),
                        count=len(parts), index=bi)
        route.finish_comm(b)
        red = route.finish(b)
        offset = 0
        for i, p in zip(bucket, parts):
            n = p.numel()
            out[i] = red[offset:offset + n].view(p.shape)
            offset += n
    return out
