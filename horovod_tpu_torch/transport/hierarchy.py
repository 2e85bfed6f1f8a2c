"""Hierarchical allreduce under a transport policy: the two-level data
plane.

The PyTorch counterpart of the JAX package's ``transport/hierarchy.py``.
Each tier runs on the process group of a ``DeviceMesh`` dimension
(``mesh.get_group(axis)``); ``ops.device.fused_allreduce`` and the
overlap scheduler route float SUM/AVERAGE buckets here when
``HVDT_TRANSPORT`` resolves the reduce group hierarchically:

1. an optional fast-tier wire cast (``bf16`` / ``fp16``);
2. **fast tier**: ``reduce_scatter_tensor`` over the innermost axis (or
   the two innermost under ``2d_ring``); ``tree`` makes it one
   ``all_reduce`` instead (no split);
3. **slow tier**: the shard crosses the outer axes, an ``all_reduce``
   for exact wires, or the port's two-stage quantized allreduce
   (``quant/collectives``) over the slow group for ``int8`` / ``int4``;
4. ``all_gather_into_tensor`` back over the fast tier;
5. one division by the group's total size for AVERAGE, the postscale,
   the input's dtype.

:func:`hierarchical_allreduce_start` issues steps 1-2 (and, on a
quantized slow wire, the wire-format hop of step 3);
:func:`hierarchical_allreduce_finish` the rest, so the overlap scheduler
can put bucket N's finish after bucket N+1's start.  ``finish(start(x))``
is :func:`hierarchical_allreduce_flat`.

Numerics: the split only reassociates the cross-rank sum, and AVERAGE
divides the full sum once, as the flat path does, so f32 results equal
flat ``fused_allreduce`` on exactly representable inputs and differ by
reassociation rounding otherwise.  The int8 slow wire keeps the
quantized collective's block-scale/2 bound per stage on the shard.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..common.types import ReduceOp
from .policy import ResolvedTransport

__all__ = ["InflightHierarchical", "hierarchical_allreduce_start",
           "hierarchical_allreduce_finish", "hierarchical_allreduce_flat",
           "wire_bytes_estimate", "tier_sizes"]

_WIRE_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16}


class _AxisSet:
    """A mesh dimension's process group in the shape the quantized
    collective takes (``group``, ``size()``, ``rank()``)."""

    def __init__(self, group: dist.ProcessGroup):
        self.group = group

    def size(self) -> int:
        return dist.get_world_size(self.group)

    def rank(self) -> int:
        return dist.get_rank(self.group)


def _mesh_of(mesh):
    if mesh is None:
        from ..common.basics import current_mesh

        mesh = current_mesh()
    if mesh is None:
        raise ValueError(
            "a hierarchical transport needs a DeviceMesh whose dimensions "
            "are the reduce group's axes: build one with parallel."
            "make_mesh (it becomes the current mesh) or pass mesh=")
    return mesh


def _axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


@dataclasses.dataclass
class InflightHierarchical:
    """A hierarchical allreduce whose fast tier (and, on a quantized slow
    wire, the wire-format slow hop) has been issued: the output of
    :func:`hierarchical_allreduce_start`, the input of
    :func:`hierarchical_allreduce_finish`."""

    res: ResolvedTransport
    groups: Dict[str, Any]
    op: ReduceOp
    n_total: int
    size: int
    pad: int
    dtype: torch.dtype
    gathered: bool                  # True when the fast tier was fused
    slow_done: bool                 # True when no slow exchange remains
    shard: Optional[torch.Tensor] = None
    quant_state: Optional[Any] = None   # slow tier in flight (int8/int4)


def hierarchical_allreduce_start(flat: torch.Tensor, res: ResolvedTransport,
                                 op: ReduceOp = ReduceOp.AVERAGE,
                                 prescale_factor: float = 1.0,
                                 mesh=None) -> InflightHierarchical:
    """Fast-tier reduce-scatter (or all-reduce under ``tree``) and, on a
    quantized slow wire, the slow tier's wire hop, for one flat float
    bucket over ``mesh`` (default: the current mesh)."""
    from ..quant.collectives import quant_wire_leg

    op = ReduceOp(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(
            f"hierarchical allreduce supports SUM/AVERAGE, got {op}")
    if quant_wire_leg(res.fast.wire) is not None:
        raise ValueError(
            f"{res.fast.wire} rides the slow (dcn) axis; the fast-axis "
            "reduce-scatter leg has no quantized wire format")
    mesh = _mesh_of(mesh)
    groups = {a: mesh.get_group(a) for a in res.axes}
    n_total = math.prod(_axis_size(mesh, a) for a in res.axes)
    dtype = flat.dtype
    size = flat.numel()

    x = flat.detach().reshape(-1)
    if prescale_factor != 1.0:
        x = x * prescale_factor
    cast_to = _WIRE_DTYPES.get(res.fast.wire)
    if cast_to is not None and x.dtype != cast_to:
        x = x.to(cast_to)
    if x.data_ptr() == flat.data_ptr():
        x = x.clone()               # the collectives reduce in place

    pad = 0
    n_fast = math.prod(_axis_size(mesh, a) for a in res.fast_axes)
    if res.fast.algorithm == "tree":
        _record_hop("allreduce", "+".join(res.fast_axes), dtype,
                    res.fast.wire,
                    2 * _ring_bytes(size, x.element_size(), n_fast))
        for a in res.fast_axes:
            dist.all_reduce(x, dist.ReduceOp.SUM, group=groups[a])
        shard, gathered = x, True
    else:
        pad = (-size) % n_fast
        if pad:
            x = torch.cat([x, x.new_zeros(pad)])
        shard = x
        for a in res.fast_axes:
            k = _axis_size(mesh, a)
            _record_hop("reduce_scatter", a, dtype, res.fast.wire,
                        _ring_bytes(shard.numel(), shard.element_size(), k))
            out = shard.new_empty(shard.numel() // k)
            dist.reduce_scatter_tensor(out, shard, dist.ReduceOp.SUM,
                                       group=groups[a])
            shard = out
        gathered = False

    inflight = InflightHierarchical(
        res=res, groups=groups, op=op, n_total=n_total, size=size, pad=pad,
        dtype=dtype, gathered=gathered, slow_done=not res.slow_axes,
        shard=shard)
    leg = quant_wire_leg(res.slow.wire) if res.slow_axes else None
    if leg is not None:
        from ..quant.collectives import quantized_allreduce_start

        inflight.quant_state = quantized_allreduce_start(
            shard, ReduceOp.SUM, wire=leg,
            process_set=_AxisSet(groups[res.slow_axes[0]]),
            axis=res.slow_axes[0])
        inflight.shard = None
        inflight.slow_done = True
    return inflight


def hierarchical_allreduce_finish(inflight: InflightHierarchical,
                                  postscale_factor: float = 1.0
                                  ) -> torch.Tensor:
    """The slow tier (or its quantized finish), the fast all-gather, one
    AVERAGE division, the postscale and the input's dtype."""
    res, groups = inflight.res, inflight.groups
    if inflight.quant_state is not None:
        from ..quant.collectives import quantized_allreduce_finish

        shard = quantized_allreduce_finish(inflight.quant_state)
    else:
        shard = inflight.shard
        if not inflight.slow_done:
            cast_slow = _WIRE_DTYPES.get(res.slow.wire)
            hop = shard
            if cast_slow is not None and hop.dtype != cast_slow:
                hop = hop.to(cast_slow)
            n_slow = math.prod(dist.get_world_size(groups[a])
                               for a in res.slow_axes)
            _record_hop("allreduce", "+".join(res.slow_axes),
                        inflight.dtype, res.slow.wire,
                        2 * _ring_bytes(shard.numel(), hop.element_size(),
                                        n_slow))
            for a in res.slow_axes:
                dist.all_reduce(hop, dist.ReduceOp.SUM, group=groups[a])
            shard = hop if hop.dtype == shard.dtype else hop.to(shard.dtype)
    if not inflight.gathered:
        for a in reversed(res.fast_axes):
            k = dist.get_world_size(groups[a])
            _record_hop("allgather", a, inflight.dtype, res.fast.wire,
                        _ring_bytes(shard.numel() * k, shard.element_size(),
                                    k))
            out = shard.new_empty(shard.numel() * k)
            dist.all_gather_into_tensor(out, shard, group=groups[a])
            shard = out
    out = shard
    if inflight.pad:
        out = out[:inflight.size]
    if inflight.op == ReduceOp.AVERAGE:
        out = out / inflight.n_total
    if postscale_factor != 1.0:
        out = out * postscale_factor
    return out.to(inflight.dtype)


def hierarchical_allreduce_flat(flat: torch.Tensor, res: ResolvedTransport,
                                op: ReduceOp = ReduceOp.AVERAGE,
                                prescale_factor: float = 1.0,
                                postscale_factor: float = 1.0,
                                mesh=None) -> torch.Tensor:
    """Allreduce one flat float vector over a hierarchically resolved
    reduce group: ``finish(start(flat))``."""
    return hierarchical_allreduce_finish(
        hierarchical_allreduce_start(flat, res, op, prescale_factor, mesh),
        postscale_factor)


def _record_hop(op: str, axis: str, dtype: torch.dtype, wire: str,
                nbytes: int, count: int = 1) -> None:
    """Per-tier-hop accounting (``path="jit"``, as in the reference): the
    main collective counters gain the axis label and the per-axis
    ``hvdt_wire_bytes_total{axis=...}`` counter books the hop, once per
    execution (once per replay inside a ``donated_step`` capture)."""
    from ..telemetry import instrument as _ti

    rec = _ti.get_recorder()
    if rec is not None:
        rec.record_collective(op, str(dtype).rsplit(".", 1)[-1], wire,
                              int(nbytes), count=count, path="jit",
                              axis=axis)


def _ring_bytes(size_elems: int, itemsize: int, k: int) -> int:
    """A rank's ring wire bytes for one data-moving hop (RS or AG) over
    an axis of size k: (k-1)/k of the payload."""
    if k <= 1:
        return 0
    return int(size_elems * itemsize * (k - 1) // k)


def tier_sizes(res: ResolvedTransport, mesh=None) -> Tuple[int, int]:
    """(fast, slow) tier sizes of a resolved group on ``mesh`` (default:
    the current mesh); (1, 1) without a mesh."""
    if mesh is None:
        from ..common.basics import current_mesh

        mesh = current_mesh()
    if mesh is None:
        return 1, 1
    return (math.prod(_axis_size(mesh, a) for a in res.fast_axes),
            math.prod(_axis_size(mesh, a) for a in res.slow_axes))


def wire_bytes_estimate(res: ResolvedTransport, count: int, itemsize: int,
                        mesh=None) -> int:
    """A rank's wire bytes for one hierarchical allreduce of ``count``
    elements across both tiers (ring accounting: a hop over an axis of
    size k carries (k-1)/k of its payload), the reference's formula."""
    fast_n, slow_n = tier_sizes(res, mesh)
    fast_item = {"bf16": 2, "fp16": 2}.get(res.fast.wire, itemsize)
    total = 2 * _ring_bytes(count, fast_item, fast_n)      # RS+AG, or AR
    shard = count if res.fast.algorithm == "tree" \
        else max(1, count // max(1, fast_n))
    if slow_n > 1 and res.slow is not None:
        from ..quant import kernels as qk

        if res.slow.wire == "int8":
            total += int(qk.wire_bytes(shard, qk.quant_block_size()))
        elif res.slow.wire == "int4":
            total += int(qk.wire_bytes_int4(shard, qk.quant_block_size()))
        else:
            slow_item = {"bf16": 2, "fp16": 2}.get(res.slow.wire, itemsize)
            total += 2 * _ring_bytes(shard, slow_item, slow_n)
    return int(total)
