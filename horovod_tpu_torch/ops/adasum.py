"""Adasum: scale-invariant gradient combination.

The PyTorch counterpart of the JAX package's ``ops/adasum.py``.  The
Adasum combination of two gradients a, b is::

    adasum(a, b) = (1 - (a.b)/(2 a.a)) a  +  (1 - (a.b)/(2 b.b)) b

which is the sum for orthogonal gradients and (a+b)/2 for parallel
ones.  Across N = 2^k ranks it is applied in a binary tree (rank 2i with
2i+1, then the results pairwise, ...); other rank counts raise
``ValueError``.

* :func:`adasum_allreduce` — the sharded form, on a process set's group:
  an ``all_to_all`` gives rank s shard s of every rank's vector, the
  tree runs on those 1/N shards with each level's three dots per pair
  summed over the ranks in one ``all_reduce`` of a ``[pairs, 3]`` f32
  stack (exact full-vector dots), and an ``all_gather`` reassembles the
  result.  O(G) wire and memory a rank; the combination is in f32.
  ``fused_allreduce(op=Adasum)`` runs it on each fused bucket, so the
  dots span the bucket, as in the reference.
* :func:`host_adasum` — the eager data plane's form (``hvd.allreduce(op=
  hvd.Adasum)``): every rank gathers the flat vectors over the set's
  eager group and computes the same tree in float64.

The combination is a handful of elementwise passes and dots, which the
reference computes in XLA; plain PyTorch ops are its counterpart here.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..common.process_sets import ProcessSet, global_process_set

__all__ = ["adasum_allreduce", "host_adasum", "adasum_pair"]


def adasum_pair(a, b, dot_ab, dot_aa, dot_bb):
    """One Adasum combination given precomputed dots (numpy arrays or
    tensors)."""
    eps = np.finfo(np.float32).tiny
    scale_a = 1.0 - dot_ab / (2.0 * (dot_aa + eps))
    scale_b = 1.0 - dot_ab / (2.0 * (dot_bb + eps))
    return scale_a * a + scale_b * b


def _check_power_of_two(n: int) -> None:
    if n & (n - 1):
        raise ValueError(f"Adasum requires a power-of-2 rank count, got {n}")


def _np_adasum_tree(vectors: List[np.ndarray]) -> np.ndarray:
    """The binary-tree Adasum over a list of rank vectors, in float64:
    the reference's host semantics."""
    vecs = [v.astype(np.float64) for v in vectors]
    _check_power_of_two(len(vecs))
    while len(vecs) > 1:
        nxt = []
        for i in range(0, len(vecs), 2):
            a, b = vecs[i], vecs[i + 1]
            nxt.append(adasum_pair(a, b, float(a @ b), float(a @ a),
                                   float(b @ b)))
        vecs = nxt
    return vecs[0]


def _tree(vecs: Sequence[torch.Tensor]) -> torch.Tensor:
    """:func:`_np_adasum_tree` on 1-D tensors, in their dtype, with the
    dots left on the tensors' device."""
    vecs = list(vecs)
    while len(vecs) > 1:
        vecs = [adasum_pair(a, b, a @ b, a @ a, b @ b)
                for a, b in zip(vecs[0::2], vecs[1::2])]
    return vecs[0]


def host_adasum(flat: torch.Tensor, process_set) -> torch.Tensor:
    """Eager-path Adasum of a flat vector across ``process_set``: the
    vectors are gathered over the set's eager group and every rank
    computes the identical float64 tree (deterministic); the result is
    in ``flat``'s dtype."""
    from . import host_collectives as hostc

    p = process_set.size()
    if p == 1:
        return flat
    _check_power_of_two(p)
    stacked = hostc.host_allgather(flat.reshape(1, -1), process_set,
                                   [1] * p)
    return _tree(list(stacked.double().unbind(0))).to(flat.dtype)


def adasum_allreduce(tensor: torch.Tensor,
                     process_set: Optional[ProcessSet] = None, *,
                     group: Optional[dist.ProcessGroup] = None
                     ) -> torch.Tensor:
    """Adasum allreduce of one tensor over the process set (``group``
    overrides the set's group), in the sharded formulation of the module
    docstring.  Returns a new tensor in the input's shape and dtype."""
    ps = process_set or global_process_set()
    group = ps.group if group is None else group
    n = ps.size()
    _check_power_of_two(n)
    shape, dtype = tensor.shape, tensor.dtype
    flat = tensor.detach().reshape(-1).to(torch.float32, copy=True)
    if n == 1:
        return flat.reshape(shape).to(dtype)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    chunk = flat.numel() // n
    # Row j after the exchange: rank j's values on this rank's shard.
    rows = torch.empty_like(flat).view(n, chunk)
    dist.all_to_all_single(rows, flat.view(n, chunk), group=group)
    vecs = list(rows.unbind(0))
    while len(vecs) > 1:
        pairs = list(zip(vecs[0::2], vecs[1::2]))
        partial = torch.stack([torch.stack([a @ b, a @ a, b @ b])
                               for a, b in pairs])          # [pairs, 3]
        dist.all_reduce(partial, group=group)
        vecs = [adasum_pair(a, b, partial[k, 0], partial[k, 1],
                            partial[k, 2])
                for k, (a, b) in enumerate(pairs)]
    full = flat.new_empty(n * chunk)
    dist.all_gather_into_tensor(full, vecs[0].contiguous(), group=group)
    if pad:
        full = full[:-pad]
    return full.reshape(shape).to(dtype)
