"""Two-stage quantized allreduce — int8 or packed-int4 wire end to end.

The PyTorch counterpart of the JAX package's ``quant/collectives.py``,
over a process set's ``torch.distributed`` group instead of a mesh axis:

1. each rank pads its flat vector to ``n`` equal, block-aligned shards
   and quantizes it (quant/kernels);
2. **reduce-scatter in wire format**: ``all_to_all_single`` moves every
   rank's copy of shard *j* (payload, then the f32 block scales) to rank
   *j*;
3. each rank dequantize-accumulates its shard in f32 (never in wire
   precision); Average multiplies by f32 ``1/n`` as the reference does;
4. the reduced shard is requantized and reassembled in wire format with
   ``all_gather_into_tensor`` (the reference zero-embeds and ``psum``s,
   only to keep JAX's replicated type; the regions are disjoint, so both
   give the same bytes);
5. a final dequantize, postscale, unpad, and the input dtype.

A world of one runs every stage too (the collectives copy), so one card
launches all four kernels.  Telemetry: :func:`quantized_allreduce_start`
books the wire-format payload under the quantized wire label
(``path="jit"``) and one flight-recorder event, each time it runs (once
per replay inside a ``donated_step`` capture); the eager path books its
packed all-gather as ``path="eager"`` with a begin/end flight event.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..common.process_sets import ProcessSet, global_process_set
from ..common.types import ReduceOp
from . import kernels as qk

__all__ = ["quantized_allreduce_flat", "quantized_allreduce",
           "quantized_allreduce_start", "quantized_allreduce_finish",
           "quantized_reduce_scatter_start",
           "quantized_reduce_scatter_finish",
           "InflightQuantized", "eager_quantized_allreduce",
           "INT8_WIRE", "INT4_WIRE", "quant_wire_leg", "wire_sentinel"]

# Sentinels a Compressor exposes as ``wire_dtype`` to select this path in
# fused_allreduce (strings on purpose: never mistakable for a dtype).
INT8_WIRE = "int8_blockwise"
INT4_WIRE = "int4_blockwise"

_WIRE_LEGS = {"int8": "int8", INT8_WIRE: "int8",
              "int4": "int4", INT4_WIRE: "int4"}


def quant_wire_leg(wire_dtype) -> Optional[str]:
    """``"int8"`` / ``"int4"`` when ``wire_dtype`` names a quantized
    wire (leg name or blockwise sentinel), else ``None``."""
    if not isinstance(wire_dtype, str):
        return None
    return _WIRE_LEGS.get(wire_dtype)


def wire_sentinel(wire: str) -> str:
    """The compressor sentinel for a quantized leg name."""
    return INT4_WIRE if wire == "int4" else INT8_WIRE


def _check_wire(wire: str) -> str:
    if wire not in ("int8", "int4"):
        raise ValueError(
            f"quantized allreduce wire must be 'int8' or 'int4', "
            f"got {wire!r}")
    return wire


def _check_op(op: ReduceOp) -> ReduceOp:
    op = ReduceOp(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(
            f"quantized allreduce supports SUM/AVERAGE, got {op}")
    return op


@dataclasses.dataclass
class InflightQuantized:
    """A quantized allreduce whose wire-format reduce-scatter has run but
    whose dequantize-accumulate half has not: the output of
    :func:`quantized_allreduce_start`, the input of
    :func:`quantized_allreduce_finish`.  ``q_recv``/``s_recv`` are the
    received wire shards ([n, shard] int8 payload — [n, shard/2] for
    int4 — and [n, shard/block] f32 scales)."""
    q_recv: torch.Tensor
    s_recv: torch.Tensor
    process_set: ProcessSet
    op: ReduceOp
    block: int
    n: int
    shard: int
    total: int
    size: int
    dtype: torch.dtype
    wire: str = "int8"


def _record_wire(dtype: torch.dtype, wire: str, size: int, block: int,
                 axis: str) -> None:
    """Telemetry for one quantized bucket: the wire-format payload the
    bucket moves per hop (1 B/elem int8 or 0.5 B/elem int4, + f32 block
    scales) under the quantized wire label, and one flight event."""
    from ..telemetry import flight_recorder as _frm
    from ..telemetry import instrument as _ti

    rec = _ti.get_recorder()
    flight = _frm.get_flight_recorder()
    if rec is None and flight is None:
        return
    sentinel = wire_sentinel(wire)
    payload = int(qk.wire_bytes_int4(size, block) if wire == "int4"
                  else qk.wire_bytes(size, block))
    dname = str(dtype).rsplit(".", 1)[-1]
    if rec is not None:
        rec.record_collective("allreduce", dname, sentinel, payload,
                              path="jit", axis=axis)
    if flight is not None:
        flight.record(op="allreduce", name="quantized.flat", dtype=dname,
                      shape=(int(size),), nbytes=payload, wire=sentinel,
                      path="jit", axis=axis)


def _all_to_all(rows: torch.Tensor, ps: ProcessSet) -> torch.Tensor:
    """[n, k] -> [n, k]: row j goes to rank j; row r of the result came
    from rank r."""
    out = torch.empty_like(rows)
    dist.all_to_all_single(out, rows, group=ps.group)
    return out


def _all_gather(shard: torch.Tensor, n: int, ps: ProcessSet) -> torch.Tensor:
    out = shard.new_empty(n * shard.numel())
    dist.all_gather_into_tensor(out, shard, group=ps.group)
    return out


def quantized_allreduce_start(flat: torch.Tensor,
                              op: ReduceOp = ReduceOp.AVERAGE,
                              block_size: Optional[int] = None,
                              prescale_factor: float = 1.0,
                              wire: str = "int8",
                              process_set: Optional[ProcessSet] = None,
                              axis: str = "dp"
                              ) -> InflightQuantized:
    """Stages 1-2: pad, quantize locally and run the wire-format
    reduce-scatter.  ``finish(start(x))`` is
    :func:`quantized_allreduce_flat`.  ``axis`` labels the telemetry
    (the mesh axes of the reduce group)."""
    op = _check_op(op)
    wire = _check_wire(wire)
    ps = process_set or global_process_set()
    block = block_size or qk.quant_block_size()
    if flat.dim() != 1:
        raise ValueError(f"quantized allreduce takes a 1-D vector, got "
                         f"shape {tuple(flat.shape)}")
    n = ps.size()
    size = flat.numel()
    shard = -(-size // (n * block)) * block
    total = shard * n
    _record_wire(flat.dtype, wire, size, block, axis)

    x = flat.detach().to(torch.float32)
    if prescale_factor != 1.0:
        x = x * prescale_factor
    if total != size:
        x = torch.cat([x, x.new_zeros(total - size)])

    if wire == "int4":
        q, scales = qk.quantize_flat_int4(x, block)
        q_rows = q.view(n, shard // 2)
    else:
        q, scales = qk.quantize_flat(x, block)
        q_rows = q.view(n, shard)
    q_recv = _all_to_all(q_rows, ps)
    s_recv = _all_to_all(scales.view(n, shard // block), ps)
    return InflightQuantized(q_recv=q_recv, s_recv=s_recv, process_set=ps,
                             op=op, block=block, n=n, shard=shard,
                             total=total, size=size, dtype=flat.dtype,
                             wire=wire)


def _dequant_accumulate(inflight: InflightQuantized) -> torch.Tensor:
    """Stage 3: dequantize the n received shards and sum them in f32."""
    block, n, shard = inflight.block, inflight.n, inflight.shard
    if inflight.wire == "int4":
        deq = qk.dequantize_flat_int4(inflight.q_recv.reshape(-1),
                                      inflight.s_recv.reshape(-1), block)
        acc = deq.view(n, shard).sum(0)
    else:
        # The reference does this stage in XLA, not in a Pallas kernel.
        contrib = (inflight.q_recv.view(n, shard // block, block)
                   .to(torch.float32) * inflight.s_recv[:, :, None])
        acc = contrib.sum(0).reshape(-1)
    if inflight.op == ReduceOp.AVERAGE:
        acc = acc * (1.0 / n)
    return acc


def quantized_allreduce_finish(inflight: InflightQuantized,
                               postscale_factor: float = 1.0
                               ) -> torch.Tensor:
    """Stages 3-5: dequantize-accumulate this rank's shard, requantize,
    gather the wire-format shards, dequantize; returns the reduced
    vector in the input's dtype."""
    acc = _dequant_accumulate(inflight)
    n, block, ps = inflight.n, inflight.block, inflight.process_set
    if inflight.wire == "int4":
        q_out, s_out = qk.quantize_flat_int4(acc, block)
    else:
        q_out, s_out = qk.quantize_flat(acc, block)
    q_full = _all_gather(q_out, n, ps)
    s_full = _all_gather(s_out, n, ps)
    if inflight.wire == "int4":
        out = qk.dequantize_flat_int4(q_full, s_full, block)
    else:
        out = qk.dequantize_flat(q_full, s_full, block)
    if postscale_factor != 1.0:
        out = out * postscale_factor
    if inflight.total != inflight.size:
        out = out[:inflight.size]
    return out.to(inflight.dtype)


def quantized_reduce_scatter_start(flat: torch.Tensor,
                                   op: ReduceOp = ReduceOp.SUM,
                                   block_size: Optional[int] = None,
                                   prescale_factor: float = 1.0,
                                   wire: str = "int8",
                                   process_set: Optional[ProcessSet] = None
                                   ) -> InflightQuantized:
    """The reduce-scatter half of the two-stage collective: stages 1-2,
    as :func:`quantized_allreduce_start`."""
    return quantized_allreduce_start(flat, op, block_size, prescale_factor,
                                     wire=wire, process_set=process_set)


def quantized_reduce_scatter_finish(inflight: InflightQuantized
                                    ) -> torch.Tensor:
    """Stage 3 only: this rank's reduced shard in f32 (``[shard]``
    elements, its contiguous chunk of the padded vector), with no
    requantization and no reassembly."""
    return _dequant_accumulate(inflight)


def quantized_allreduce_flat(flat: torch.Tensor,
                             op: ReduceOp = ReduceOp.AVERAGE,
                             block_size: Optional[int] = None,
                             prescale_factor: float = 1.0,
                             postscale_factor: float = 1.0,
                             wire: str = "int8",
                             process_set: Optional[ProcessSet] = None
                             ) -> torch.Tensor:
    """Allreduce one flat float vector over the quantized wire (the
    bucket-level primitive ``fused_allreduce`` routes to).  SUM/AVERAGE
    only; returns the reduced vector in the input dtype, the same on
    every rank."""
    return quantized_allreduce_finish(
        quantized_allreduce_start(flat, op, block_size, prescale_factor,
                                  wire=wire, process_set=process_set),
        postscale_factor)


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    raise TypeError(f"unsupported leaf container {type(tree).__name__}")


def quantized_allreduce(tree: Any, op: ReduceOp = ReduceOp.AVERAGE,
                        block_size: Optional[int] = None,
                        prescale_factor: float = 1.0,
                        postscale_factor: float = 1.0,
                        wire: str = "int8",
                        process_set: Optional[ProcessSet] = None) -> Any:
    """Per-tensor convenience over a tensor, or a dict / list / tuple of
    them: every float tensor rides :func:`quantized_allreduce_flat`
    (for the bucketed hot path use ``ops.device.fused_allreduce`` with
    ``Compression.int8``), other tensors the exact
    ``ops.device.allreduce``."""
    from ..ops import device as dev

    def one(t: torch.Tensor) -> torch.Tensor:
        if t.is_floating_point():
            return quantized_allreduce_flat(
                t.reshape(-1), op, block_size, prescale_factor,
                postscale_factor, wire=wire,
                process_set=process_set).view(t.shape)
        return dev.allreduce(t, op, prescale_factor, postscale_factor,
                             process_set=process_set)

    return _tree_map(one, tree)


def eager_quantized_allreduce(tensor: torch.Tensor,
                              name: Optional[str] = None,
                              op: ReduceOp = ReduceOp.AVERAGE,
                              block_size: Optional[int] = None,
                              process_set: Optional[ProcessSet] = None
                              ) -> torch.Tensor:
    """Quantized allreduce as one ``all_gather`` of each rank's packed
    int8 wire bytes (payload ‖ f32 scales); each rank then
    dequantize-accumulates every rank's copy locally, in rank order.
    Per-rank traffic ``(n-1)·size·(1+4/block)`` bytes.  ``name`` names
    the flight-recorder event (the negotiated eager op in the
    reference).  Returns a new tensor in the input's shape and dtype."""
    op = _check_op(op)
    ps = process_set or global_process_set()
    block = block_size or qk.quant_block_size()
    flat = tensor.detach().reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    q, scales = qk.quantize_flat(flat, block)
    nq = q.numel()
    packed = torch.cat([q.view(torch.uint8), scales.view(torch.uint8)])
    n = ps.size()
    from ..telemetry import flight_recorder as _frm
    from ..telemetry import instrument as _ti

    rec = _ti.get_recorder()
    dname = str(tensor.dtype).rsplit(".", 1)[-1]
    if rec is not None:
        rec.record_collective("allreduce", dname, INT8_WIRE,
                              packed.numel(), path="eager")
    flight = _frm.get_flight_recorder()
    fr_seq = None
    if flight is not None:
        fr_seq = flight.record_begin(
            op="allreduce", name=name or "quantized.eager", dtype=dname,
            shape=tuple(tensor.shape), nbytes=int(packed.numel()),
            wire=INT8_WIRE, path="eager")
    try:
        gathered = _all_gather(packed, n, ps)
    except Exception:
        if flight is not None:
            flight.record_end(fr_seq, status="error")
        raise
    if flight is not None:
        flight.record_end(fr_seq)
    per_rank = gathered.view(n, packed.numel())
    acc = torch.zeros(nq, dtype=torch.float32, device=flat.device)
    for r in range(n):
        payload = per_rank[r, :nq].view(torch.int8)
        # A fresh copy: the view as f32 needs a 4-byte-aligned offset.
        scales_r = per_rank[r, nq:].clone().view(torch.float32)
        acc += qk.dequantize_flat(payload, scales_r, block)
    if op == ReduceOp.AVERAGE:
        acc /= n
    if pad:
        acc = acc[:-pad]
    return acc.view(tensor.shape).to(tensor.dtype)
