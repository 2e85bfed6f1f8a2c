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

__all__ = ["allreduce", "allgather", "reduce_scatter", "alltoall",
           "broadcast", "fused_allreduce", "fused_allreduce_buckets"]

_DIST_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM,
             ReduceOp.AVERAGE: dist.ReduceOp.SUM,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT}


def _reduce_(buf: torch.Tensor, op: ReduceOp,
             ps: ProcessSet) -> torch.Tensor:
    """All-reduce ``buf`` in place; returns the reduced tensor (a new
    one only for an integer Average, which turns float)."""
    op = ReduceOp(op)
    if op == ReduceOp.ADASUM:
        raise NotImplementedError(
            "Adasum is not ported yet (ROADMAP Queue 1: exchange "
            "scheduling)")
    dist.all_reduce(buf, _DIST_OPS[op], group=ps.group)
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


def fused_allreduce(tensors: Sequence[torch.Tensor],
                    op: ReduceOp = ReduceOp.AVERAGE,
                    threshold_bytes: Optional[int] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    wire_dtype: Optional[Any] = None,
                    process_set: Optional[ProcessSet] = None
                    ) -> List[torch.Tensor]:
    """Allreduce a list of tensors as few fused flat collectives.

    Each bucket is concatenated into one flat buffer (cast to
    ``wire_dtype`` when one is given and the bucket is floating), reduced
    by one ``all_reduce``, cast back, and split; the returned tensors are
    views into the reduced buffers, in input order and shapes.  The
    quantized-wire sentinels (``Compression.int8`` / ``.int4``
    ``wire_dtype``) instead send each float bucket through the two-stage
    quantized allreduce (``quant/collectives.py``); other buckets keep
    the exact path."""
    from ..quant.collectives import quant_wire_leg, quantized_allreduce_flat

    ps = process_set or global_process_set()
    tensors = list(tensors)
    if not tensors:
        return []
    quant_leg = quant_wire_leg(wire_dtype)
    if quant_leg is not None:
        wire_dtype = None       # the quantized path owns the wire format
    buckets = fused_allreduce_buckets(tensors, threshold_bytes)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for bucket in buckets:
        parts = [tensors[i] for i in bucket]
        flat = torch.cat([p.detach().reshape(-1) for p in parts])
        orig_dtype = flat.dtype
        if quant_leg is not None and flat.is_floating_point():
            red = quantized_allreduce_flat(
                flat, op, prescale_factor=prescale_factor,
                postscale_factor=postscale_factor, wire=quant_leg,
                process_set=ps)
        else:
            if (wire_dtype is not None and flat.is_floating_point()
                    and flat.dtype != wire_dtype):
                flat = flat.to(wire_dtype)
            if prescale_factor != 1.0:
                flat.mul_(prescale_factor)
            red = _reduce_(flat, op, ps)
            if postscale_factor != 1.0:
                red.mul_(postscale_factor)
        if red.dtype != orig_dtype:
            red = red.to(orig_dtype)
        offset = 0
        for i, p in zip(bucket, parts):
            n = p.numel()
            out[i] = red[offset:offset + n].view(p.shape)
            offset += n
    return out
