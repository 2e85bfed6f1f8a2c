"""State-consistency helpers: broadcast parameters, optimizer state and
objects from one rank to all (the PyTorch counterpart of the JAX
package's ``functions.py``).  Used at training start to make rank 0's
state authoritative.  Tensors are broadcast in place.
"""

from __future__ import annotations

from typing import Any, Iterable, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from .common import basics
from .common.process_sets import ProcessSet, global_process_set

__all__ = ["broadcast_parameters", "broadcast_optimizer_state",
           "broadcast_object"]

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
    tensors in place, and the hyperparameters of its param groups (and
    any non-tensor state) as objects.  The state must have the same
    structure on every rank (the fused optimizers create theirs at
    construction)."""
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
        ([{k: v for k, v in g.items() if k != "params"}
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
