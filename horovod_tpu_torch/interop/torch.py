"""PyTorch binding: Horovod's torch API over the port's eager controller.

The counterpart of the JAX package's ``interop/torch.py`` (Horovod's
``horovod/torch/mpi_ops.py`` and ``functions.py``): the same calls
(``allreduce``, ``allgather``, ``broadcast``, ``alltoall``, their async
and in-place variants, ``broadcast_parameters``,
``broadcast_optimizer_state``) on ``torch.Tensor`` s, so that
``import horovod_tpu_torch.interop.torch as hvd`` is drop-in for
``import horovod.torch as hvd``::

    hvd.init()
    opt = hvd.DistributedOptimizer(opt,
                                   named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.allreduce_(metric, name="metric")

Every call is a named, negotiated eager collective
(``ops/eager.py``): a CPU tensor rides gloo, a CUDA tensor NCCL, and a
result comes back on the input's device and in its dtype.  A CUDA tensor
stays on the card: nothing here copies it to the host (the JAX package
takes CPU tensors only and raises on any other).  The in-place variants
write the result into their argument when the handle is synchronized,
through ``.data``, so a leaf parameter that requires a gradient accepts
the copy.
"""

from __future__ import annotations

import weakref
from typing import Any, Iterable, Mapping, Optional, Tuple

import torch

from ..common.types import ReduceOp
from ..ops import eager

__all__ = ["allreduce", "allreduce_async", "allreduce_", "allreduce_async_",
           "grouped_allreduce", "grouped_allreduce_async",
           "grouped_allreduce_", "grouped_allreduce_async_",
           "sparse_allreduce_async",
           "allgather", "allgather_async",
           "broadcast", "broadcast_async", "broadcast_", "broadcast_async_",
           "alltoall", "alltoall_async", "join", "barrier", "poll",
           "synchronize",
           "broadcast_parameters", "broadcast_optimizer_state",
           "broadcast_object", "allgather_object", "Compression",
           "DistributedOptimizer", "SyncBatchNorm"]


def __getattr__(name):
    if name == "DistributedOptimizer":
        from .torch_optimizer import DistributedOptimizer

        return DistributedOptimizer
    if name == "SyncBatchNorm":
        from .torch_sync_batch_norm import SyncBatchNorm

        return SyncBatchNorm
    if name == "Compression":
        from ..ops.compression import Compression

        return Compression
    if name in ("broadcast_object", "allgather_object"):
        from .. import functions

        return getattr(functions, name)
    if name == "elastic":
        # ref: horovod.torch.elastic submodule (TorchState, run)
        from . import torch_elastic

        return torch_elastic
    if name == "TorchState":
        from .torch_elastic import TorchState

        return TorchState
    from . import core_attr

    found = core_attr(name)
    if found is not None:
        return found
    raise AttributeError(name)


def _inplace(handle: int, target: torch.Tensor) -> int:
    """Attach ``target`` to the handle, weakly, so :func:`synchronize`
    writes the result into it; the reference keeps it inside the handle's
    entry (``HandleManager.set_meta``), which drops it with the handle."""
    eager._controller().handles.set_meta(handle, weakref.ref(target))
    return handle


def allreduce_async(tensor, average: Optional[bool] = None,
                    name: Optional[str] = None, op=None,
                    process_set=None) -> int:
    return eager.allreduce_async(tensor, average=average, name=name, op=op,
                                 process_set=process_set)


def allreduce_async_(tensor, average: Optional[bool] = None,
                     name: Optional[str] = None, op=None,
                     process_set=None) -> int:
    """In-place async allreduce: :func:`synchronize` copies the result
    back into ``tensor``."""
    return _inplace(allreduce_async(tensor, average, name, op, process_set),
                    tensor)


def allreduce(tensor, average: Optional[bool] = None,
              name: Optional[str] = None, op=None, process_set=None):
    return synchronize(allreduce_async(tensor, average, name, op,
                                       process_set))


def allreduce_(tensor, average: Optional[bool] = None,
               name: Optional[str] = None, op=None, process_set=None):
    return synchronize(allreduce_async_(tensor, average, name, op,
                                        process_set))


def grouped_allreduce_async(tensors, average: Optional[bool] = None,
                            name: Optional[str] = None, op=None,
                            process_set=None):
    return eager.grouped_allreduce_async(list(tensors), average=average,
                                         name=name, op=op,
                                         process_set=process_set)


def grouped_allreduce_async_(tensors, average: Optional[bool] = None,
                             name: Optional[str] = None, op=None,
                             process_set=None):
    tensors = list(tensors)
    handles = grouped_allreduce_async(tensors, average, name, op,
                                      process_set)
    return [_inplace(h, t) for h, t in zip(handles, tensors)]


def grouped_allreduce(tensors, **kwargs):
    return [synchronize(h)
            for h in grouped_allreduce_async(tensors, **kwargs)]


def grouped_allreduce_(tensors, **kwargs):
    return [synchronize(h)
            for h in grouped_allreduce_async_(tensors, **kwargs)]


def sparse_allreduce_async(tensor, name: str, op=None, process_set=None):
    """Allreduce of a sparse COO tensor by two allgathers (indices and
    values).  Returns a zero-argument callable that synchronizes both and
    builds the combined sparse tensor, values averaged unless ``op`` is
    Sum (the reference's handle contract)."""
    from ..common.process_sets import global_process_set

    ps = process_set or global_process_set()
    t = tensor.coalesce() if tensor.layout == torch.sparse_coo else tensor
    indices_h = allgather_async(t._indices().transpose(0, 1).contiguous(),
                                name=f"{name}.indices", process_set=ps)
    values_h = allgather_async(t._values(), name=f"{name}.values",
                               process_set=ps)
    average = op is None or op == ReduceOp.AVERAGE

    def handle():
        values = synchronize(values_h)
        indices = synchronize(indices_h)
        if average:
            values = values / ps.size()
        return torch.sparse_coo_tensor(indices.transpose(0, 1), values,
                                       t.size())

    return handle


def allgather_async(tensor, name: Optional[str] = None,
                    process_set=None) -> int:
    return eager.allgather_async(tensor, name=name, process_set=process_set)


def allgather(tensor, name: Optional[str] = None, process_set=None):
    return synchronize(allgather_async(tensor, name, process_set))


def broadcast_async(tensor, root_rank: int = 0,
                    name: Optional[str] = None, process_set=None) -> int:
    return eager.broadcast_async(tensor, root_rank, name=name,
                                 process_set=process_set)


def broadcast_async_(tensor, root_rank: int = 0,
                     name: Optional[str] = None, process_set=None) -> int:
    """In-place async broadcast: :func:`synchronize` copies the result
    back into ``tensor``."""
    return _inplace(broadcast_async(tensor, root_rank, name, process_set),
                    tensor)


def broadcast(tensor, root_rank: int = 0, name: Optional[str] = None,
              process_set=None):
    return synchronize(broadcast_async(tensor, root_rank, name, process_set))


def broadcast_(tensor, root_rank: int = 0, name: Optional[str] = None,
               process_set=None):
    return synchronize(broadcast_async_(tensor, root_rank, name,
                                        process_set))


def alltoall_async(tensor, splits=None, name: Optional[str] = None,
                   process_set=None) -> int:
    if isinstance(splits, torch.Tensor):
        splits = splits.tolist()
    return eager.alltoall_async(tensor, splits=splits, name=name,
                                process_set=process_set)


def alltoall(tensor, splits=None, name: Optional[str] = None,
             process_set=None):
    """Returns ``(output, recv_splits)``."""
    return synchronize(alltoall_async(tensor, splits, name, process_set))


def join(process_set=None) -> int:
    """Signal no more work on this rank; returns the last rank to join."""
    return eager.join(process_set)


def barrier(process_set=None) -> None:
    eager.barrier(process_set)


def poll(handle: int) -> bool:
    return eager.poll(handle)


def synchronize(handle: int):
    """Wait for an async handle and return its result, a tensor on the
    input's device and in its dtype (alltoall: ``(tensor, recv_splits)``).
    An in-place handle's result is written into its tensor, which is
    returned."""
    ref = eager._controller().handles.take_meta(handle)
    out = eager.synchronize(handle)
    target = ref() if ref is not None else None
    if target is None:
        return out
    recv_splits = None
    if isinstance(out, tuple):
        out, recv_splits = out
    # Through .data, so leaf tensors with requires_grad=True (model
    # parameters) accept the copy.
    with torch.no_grad():
        if target.shape != out.shape:
            target.data = out
        else:
            target.data.copy_(out)
    return target if recv_splits is None else (target, recv_splits)


def broadcast_parameters(params, root_rank: int = 0,
                         process_set=None) -> None:
    """Broadcast a ``model.state_dict()`` or ``named_parameters()`` in
    place, each tensor as ``param.<name>``."""
    items: Iterable[Tuple[str, Any]] = (params.items()
                                        if isinstance(params, Mapping)
                                        else params)
    for name, p in items:
        if not isinstance(p, torch.Tensor):
            continue
        new = broadcast(p, root_rank=root_rank, name=f"param.{name}",
                        process_set=process_set)
        with torch.no_grad():
            p.copy_(new)


def broadcast_optimizer_state(optimizer, root_rank: int = 0,
                              process_set=None) -> None:
    """Broadcast a torch optimizer's state tensors in place, each as
    ``opt.<group index>.<param index>.<key>`` (names equal on every rank,
    where ``id(p)`` would not be)."""
    for gi, group in enumerate(optimizer.param_groups):
        for pi, p in enumerate(group["params"]):
            state = optimizer.state.get(p, {})
            for key, value in sorted(state.items()):
                if isinstance(value, torch.Tensor):
                    new = broadcast(value, root_rank=root_rank,
                                    name=f"opt.{gi}.{pi}.{key}",
                                    process_set=process_set)
                    with torch.no_grad():
                        value.copy_(new)
