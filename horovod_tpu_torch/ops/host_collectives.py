"""Cross-process data plane of the eager path.

The PyTorch counterpart of the JAX package's ``ops/host_collectives.py``.
There each eager collective is a jitted XLA program over the process
set's mesh; here it is a ``torch.distributed`` call over the process
set's eager group (``ProcessSet.eager_group``: NCCL on the card, gloo on
the CPU) on tensors that lie on the set's device.  The semantics are the
JAX package's: ragged allgather in set-rank order, broadcast from a
set-relative root, uneven alltoall returning the receive splits, and
reducescatter's rows split with the remainder to the low ranks.

Unlike the JAX package's default data plane, int64 and float64 go
through exactly (NCCL and gloo carry both), as its TCP data plane does.
Dtypes a backend lacks ride as another of the same width (a move) or
widened to int32 (a reduction).  A set of one short-circuits in the
layer above (``ops/eager.py``), so these functions assume size > 1.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..common.types import ReduceOp
from .device import _reduce_

__all__ = ["host_allreduce", "host_allgather", "host_broadcast",
           "host_alltoall", "host_reducescatter"]

# Dtypes neither NCCL nor gloo carries: moved as a same-width dtype,
# reduced widened.
_NARROW_INTS = (torch.int16, torch.uint16)


def _movable(t: torch.Tensor) -> torch.Tensor:
    """A view of ``t`` that every backend moves bit for bit."""
    if t.dtype in _NARROW_INTS:
        return t.view(torch.float16)
    if t.dtype == torch.bool:
        return t.view(torch.uint8)
    return t


def _identity_value(op: ReduceOp, dtype: torch.dtype):
    """Reduction identity element, dtype-aware (int MIN/MAX must not use
    float infinities): a joined rank's contribution."""
    op = ReduceOp(op)
    if op in (ReduceOp.SUM, ReduceOp.AVERAGE, ReduceOp.ADASUM):
        return 0
    if op == ReduceOp.PRODUCT:
        return 1
    if dtype == torch.bool:
        return op == ReduceOp.MIN
    if op == ReduceOp.MIN:
        return (torch.iinfo(dtype).max if not dtype.is_floating_point
                else float("inf"))
    if op == ReduceOp.MAX:
        return (torch.iinfo(dtype).min if not dtype.is_floating_point
                else float("-inf"))
    raise ValueError(f"No identity for {op}")


def host_allreduce(buf: torch.Tensor, process_set,
                   op: ReduceOp) -> torch.Tensor:
    """Allreduce ``buf`` (a flat buffer the caller owns; it may be
    reduced in place) across the set.  Average is a Sum then a division
    by the set size (``ops/device.py`` ``_reduce_``); on integers the
    division truncates toward zero, exactly, where the JAX package
    divides in floating point and casts back."""
    op = ReduceOp(op)
    dtype = buf.dtype
    wire = buf
    if dtype in _NARROW_INTS or dtype == torch.bool:
        wire = buf.to(torch.int32)
    if op == ReduceOp.AVERAGE and not dtype.is_floating_point:
        wire = _reduce_(wire, ReduceOp.SUM, process_set,
                        group=process_set.eager_group)
        wire = torch.div(wire, process_set.size(), rounding_mode="trunc")
    else:
        wire = _reduce_(wire, op, process_set,
                        group=process_set.eager_group)
    return wire if wire.dtype == dtype else wire.to(dtype)


def host_broadcast(value: Optional[torch.Tensor], root_rank: int,
                   process_set, shape: Tuple[int, ...], dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """Broadcast from set-relative ``root_rank``.  Non-root processes pass
    ``value=None`` and receive the root's tensor, in the negotiated
    ``shape`` (a 0-d tensor travels as one element)."""
    if process_set.rank() == root_rank:
        buf = value.reshape(-1).clone()
    else:
        buf = torch.empty(torch.Size(shape).numel(), dtype=dtype,
                          device=device)
    dist.broadcast(_movable(buf), src=process_set.global_rank(root_rank),
                   group=process_set.eager_group)
    return buf.reshape(shape)


def host_allgather(value: torch.Tensor, process_set,
                   all_dim0: Sequence[int]) -> torch.Tensor:
    """Ragged allgather: concat along dim 0 with per-set-rank sizes
    ``all_dim0`` (negotiated by the controller).  Each rank's block is
    padded to the largest, gathered, and sliced back in set-rank order."""
    max0 = max(all_dim0) if all_dim0 else 0
    rest = tuple(value.shape[1:])
    if max0 == 0:                       # every rank holds zero rows
        return value.new_zeros((0,) + rest)
    padded = value.new_zeros((max0,) + rest)
    padded[:value.shape[0]] = value
    n = process_set.size()
    full = value.new_empty((n * max0,) + rest)
    dist.all_gather_into_tensor(_movable(full), _movable(padded),
                                group=process_set.eager_group)
    return torch.cat([full[r * max0:r * max0 + int(d)]
                      for r, d in enumerate(all_dim0)])


def host_alltoall(value: torch.Tensor, splits: Sequence[int], process_set,
                  all_splits: Sequence[Sequence[int]]
                  ) -> Tuple[torch.Tensor, List[int]]:
    """Uneven alltoall: ``all_splits[r]`` is set rank r's send splits
    (rows along dim 0), negotiated by the controller.  Returns (output,
    recv_splits)."""
    me = process_set.rank()
    recv = [int(s[me]) for s in all_splits]
    out = value.new_empty((sum(recv),) + tuple(value.shape[1:]))
    dist.all_to_all_single(_movable(out), _movable(value.contiguous()),
                           output_split_sizes=recv,
                           input_split_sizes=[int(s) for s in splits],
                           group=process_set.eager_group)
    return out, recv


def host_reducescatter(value: torch.Tensor, process_set,
                       op: ReduceOp) -> torch.Tensor:
    """Reduce, then keep this rank's rows: an equal split with the
    remainder to the low ranks."""
    reduced = host_allreduce(value.clone(), process_set, op)
    p = process_set.size()
    r = process_set.rank()
    n = reduced.shape[0]
    base, rem = divmod(n, p)
    start = r * base + min(r, rem)
    stop = start + base + (1 if r < rem else 0)
    return reduced[start:stop]
