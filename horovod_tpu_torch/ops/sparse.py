"""Sparse (indexed-slices) allreduce — the embedding-gradient path.

The PyTorch counterpart of the JAX package's ``ops/sparse.py``.  A
sparse gradient is (indices [nnz], values [nnz, ...rest], dense_shape);
ranks hold different nnz.

* ``sparse_allreduce`` — eager: allgather indices and values across the
  process set (the eager allgather negotiates the ragged first dim); the
  result keeps duplicate indices, and ``to_dense`` scatter-adds.
* ``sparse_allreduce_jit`` — the same over ``ops/device.py``'s allgather,
  with no negotiation: nnz must be equal on every rank (pad with a
  sentinel row if needed).  The name is the JAX package's, whose form
  runs inside ``shard_map``.

Indices and values may be torch tensors or numpy arrays; the result
holds the same type.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..common.types import ReduceOp

__all__ = ["SparseGradient", "sparse_allreduce", "sparse_allreduce_async",
           "sparse_allreduce_jit"]


@dataclasses.dataclass
class SparseGradient:
    """Indexed-slices gradient: ``dense[indices[i]] += values[i]``."""

    indices: Any                 # [nnz] int
    values: Any                  # [nnz, ...rest]
    dense_shape: Tuple[int, ...]

    def to_dense(self):
        if isinstance(self.values, torch.Tensor):
            out = self.values.new_zeros(self.dense_shape)
            return out.index_add_(0, self.indices.long(), self.values)
        out = np.zeros(self.dense_shape, self.values.dtype)
        np.add.at(out, np.asarray(self.indices), np.asarray(self.values))
        return out


def sparse_allreduce_async(indices, values, dense_shape,
                           name: Optional[str] = None,
                           op: ReduceOp = ReduceOp.AVERAGE,
                           process_set=None):
    """Async start; returns a zero-arg resolver."""
    from . import eager

    # When unnamed, let the controller auto-name each collective with its
    # deterministic per-process counter — the name must be identical on
    # every rank for negotiation to match.
    h_idx = eager.allgather_async(indices,
                                  name=f"{name}.indices" if name else None,
                                  process_set=process_set)
    h_val = eager.allgather_async(values,
                                  name=f"{name}.values" if name else None,
                                  process_set=process_set)

    def resolve() -> SparseGradient:
        vals = eager.synchronize(h_val)
        idx = eager.synchronize(h_idx)
        if op == ReduceOp.AVERAGE:
            from ..common import basics

            size = (process_set.size() if process_set is not None
                    else basics.size())
            if isinstance(vals, torch.Tensor):
                vals = (vals / size).to(vals.dtype)
            else:
                vals = (vals / size).astype(vals.dtype)
        return SparseGradient(idx, vals, tuple(dense_shape))

    return resolve


def sparse_allreduce(indices, values, dense_shape,
                     name: Optional[str] = None,
                     op: ReduceOp = ReduceOp.AVERAGE,
                     process_set=None) -> SparseGradient:
    return sparse_allreduce_async(indices, values, dense_shape, name=name,
                                  op=op, process_set=process_set)()


def sparse_allreduce_jit(indices: torch.Tensor, values: torch.Tensor,
                         process_set=None,
                         op: ReduceOp = ReduceOp.AVERAGE
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Equal-nnz allgather over the process set; returns concatenated
    (indices, values) with values averaged for AVERAGE."""
    from ..common.process_sets import global_process_set
    from . import device

    ps = process_set or global_process_set()
    gi = device.allgather(indices, process_set=ps)
    gv = device.allgather(values, process_set=ps)
    if op == ReduceOp.AVERAGE:
        gv = gv / ps.size()
    elif op != ReduceOp.SUM:
        raise ValueError("sparse allreduce supports SUM/AVERAGE")
    return gi, gv.to(values.dtype)
