"""State-consistency helpers: broadcast parameters, optimizer state and
objects from one rank to all (the PyTorch counterpart of the JAX
package's ``functions.py``).  Used at training start to make rank 0's
state authoritative.  Tensors are broadcast in place.
"""

from __future__ import annotations

import pickle
from typing import Any, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from .common import basics
from .common.process_sets import ProcessSet, global_process_set

__all__ = ["broadcast_parameters", "broadcast_optimizer_state",
           "broadcast_object", "allgather_object"]

Params = Union[torch.nn.Module, dict, Iterable[Tuple[str, torch.Tensor]],
               Iterable[torch.Tensor]]


def _tensors_of(params: Params) -> List[torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    if isinstance(params, dict):
        return list(params.values())
    out = []
    for item in params:
        out.append(item[1] if isinstance(item, tuple) else item)
    return out


def _backend_holds(t: torch.Tensor) -> bool:
    """Whether the process group's backend can move ``t`` in place
    (NCCL moves CUDA tensors, gloo CPU tensors)."""
    return t.device.type == basics.topology().device.type


def _broadcast_(t: torch.Tensor, src: int, ps: ProcessSet) -> None:
    t = t.detach()
    if t.is_contiguous():
        dist.broadcast(t, src=src, group=ps.group)
    else:
        buf = t.contiguous()
        dist.broadcast(buf, src=src, group=ps.group)
        t.copy_(buf)


def broadcast_parameters(params: Params, root_rank: int = 0,
                         process_set: Optional[ProcessSet] = None) -> Params:
    """Broadcast, in place, every tensor of ``params`` from ``root_rank``:
    a module (its ``state_dict()``, so buffers such as BN running stats
    go too), a dict of tensors, ``named_parameters()`` pairs, or a list
    of tensors.  Returns ``params``."""
    ps = process_set or global_process_set()
    src = ps.global_rank(root_rank)
    for t in _tensors_of(params):
        if _backend_holds(t):
            _broadcast_(t, src, ps)
        else:
            with torch.no_grad():
                t.copy_(broadcast_object(t.detach().cpu(), root_rank, ps))
    return params


def broadcast_optimizer_state(optimizer, root_rank: int = 0,
                              process_set: Optional[ProcessSet] = None):
    """Broadcast an optimizer's state from ``root_rank``: its state
    tensors in place, and the hyperparameters of its param groups (the
    step ``count`` among them) and any non-tensor state as objects.  A
    callable hyperparameter (a learning-rate schedule) is not sent: each
    rank keeps its own, as the JAX package keeps the schedule in the
    update closure and broadcasts only the state.  The state must have
    the same structure on every rank (the fused optimizers create theirs
    with each param group)."""
    ps = process_set or global_process_set()
    tensors = []
    others = []
    for group in optimizer.param_groups:
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            for key in sorted(st):
                v = st[key]
                if isinstance(v, torch.Tensor):
                    tensors.append(v)
                else:
                    others.append((st, key))
    broadcast_parameters(tensors, root_rank, ps)
    meta = broadcast_object(
        ([{k: v for k, v in g.items()
           if k != "params" and not callable(v)}
          for g in optimizer.param_groups],
         [st[key] for st, key in others]), root_rank, ps)
    for group, hyper in zip(optimizer.param_groups, meta[0]):
        group.update(hyper)
    for (st, key), v in zip(others, meta[1]):
        st[key] = v
    return optimizer


def broadcast_object(obj: Any, root_rank: int = 0,
                     process_set: Optional[ProcessSet] = None) -> Any:
    """Broadcast a picklable object from ``root_rank``."""
    ps = process_set or global_process_set()
    box = [obj if ps.rank() == root_rank else None]
    dist.broadcast_object_list(box, src=ps.global_rank(root_rank),
                               group=ps.group)
    return box[0]


def allgather_object(obj: Any, process_set: Optional[ProcessSet] = None,
                     name: Optional[str] = None) -> list:
    """Gather a picklable object from every rank, in set-rank order, over
    two named eager allgathers (the pickled bytes, then their lengths)."""
    from .ops import eager

    ps = process_set or global_process_set()
    name = name or "allgather_object"
    payload = np.frombuffer(pickle.dumps(obj), dtype=np.uint8).copy()
    gathered = eager.allgather(payload.reshape(-1, 1),
                               name=f"{name}.data", process_set=ps)
    # ragged gather of (n_i, 1) blocks; recover per-rank lengths
    sizes = eager.allgather(np.array([[payload.shape[0]]], dtype=np.int64),
                            name=f"{name}.sizes", process_set=ps)
    out = []
    offset = 0
    flat = np.asarray(gathered).reshape(-1)
    for n in np.asarray(sizes).reshape(-1):
        out.append(pickle.loads(flat[offset:offset + int(n)]
                                .astype(np.uint8).tobytes()))
        offset += int(n)
    return out
