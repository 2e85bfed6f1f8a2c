"""Grad-hook ``DistributedOptimizer``: Horovod's torch optimizer wrapper.

The counterpart of the JAX package's ``interop/torch_optimizer.py``
(Horovod's ``horovod/torch/optimizer.py``).  It wraps any
``torch.optim`` optimizer; each trainable parameter gets a
``register_post_accumulate_grad_hook`` that, the moment autograd has
accumulated the parameter's gradient, enqueues it as a named async
allreduce (``grad.<name>``) on the port's eager controller, whose thread
negotiates and reduces while the backward goes on.  ``step()``
synchronizes the handles, installs the reduced gradients and steps::

    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    opt = hvd.DistributedOptimizer(opt,
                                   named_parameters=model.named_parameters())
    loss.backward()       # gradients stream into named allreduces
    opt.step()            # synchronize(), then the wrapped step

The port's own ``horovod_tpu_torch.DistributedOptimizer`` is the other
wrapper: it exchanges fused buckets in ``step()`` (or from its own hooks
under ``HVDT_OVERLAP=on``) with no negotiation.  This one keeps Horovod's
surface: ``named_parameters``, ``backward_passes_per_step`` (k backwards,
then one ``step()``; each hook enqueues the accumulated gradient over k
on the k-th), ``gradient_predivide_factor``, ``num_groups`` / ``groups``
(one all-or-nothing grouped allreduce a group), ``sparse_as_dense``,
``synchronize()`` and ``skip_synchronize()``.

Every rank enqueues every optimized parameter that requires a gradient:
:meth:`_Hooks.synchronize` enqueues zeros for one that no hook enqueued
(a branch not taken on this rank), so no rank waits on a name that never
comes.  A gradient goes over the wire in f32 when its dtype is not f32,
f64 or f16 (bf16 among them), the zeros too, so every rank negotiates one
dtype for a name; compression is applied in the hook, to the zeros too.
On the card the gradients stay there: a CUDA gradient is reduced over
NCCL, and ``Compression.int8`` / ``.int4`` snap it to the wire's grid
with the quantize / dequantize kernels.
"""

from __future__ import annotations

import contextlib
import functools
import weakref
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from ..common.types import ReduceOp
from ..ops import eager
from ..ops.compression import Compression
from ..ops.overlap import _remove, _weak_hook

__all__ = ["DistributedOptimizer"]

# Gradient dtypes the wire carries as they are; any other goes as f32.
_WIRE_DTYPES = (torch.float32, torch.float64, torch.float16)


class _Hooks:
    """The per-parameter allreduce state behind the wrapper's methods."""

    def __init__(self, optimizer, named_parameters, op, process_set,
                 backward_passes_per_step: int, compression=None,
                 gradient_predivide_factor: float = 1.0,
                 num_groups: int = 0, groups=None,
                 sparse_as_dense: bool = False):
        self.op = ReduceOp(op)
        self.process_set = process_set
        self.k = max(1, int(backward_passes_per_step))
        # None: the environment's (HVDT_COMPRESSION / HVDT_QUANT).
        self.compression = compression or Compression.from_env()
        self.predivide = float(gradient_predivide_factor)
        if self.predivide != 1.0 and self.op != ReduceOp.AVERAGE:
            raise ValueError("gradient_predivide_factor requires op=Average")
        self.sparse_as_dense = bool(sparse_as_dense)
        self._handles: Dict[torch.Tensor, int] = {}
        self._delay: Dict[torch.Tensor, int] = {}   # backwards left
        self._ctx: Dict[torch.Tensor, Any] = {}     # decompress contexts
        self._synchronized = False                  # grads reduced

        params = [p for group in optimizer.param_groups
                  for p in group["params"]]
        if named_parameters is not None:
            seen = set()
            for n, _ in named_parameters:
                if n in seen:
                    raise ValueError(
                        f"duplicate parameter name {n!r} in "
                        "named_parameters: collective names must be unique")
                seen.add(n)
            by_obj = {id(p): n for n, p in named_parameters}
            missing = [p for p in params if id(p) not in by_obj]
            if missing:
                raise ValueError(
                    "named_parameters does not cover all optimized "
                    f"parameters ({len(missing)} missing)")
            self._names = {p: f"grad.{by_obj[id(p)]}" for p in params}
        else:
            self._names = {p: f"grad.{i}" for i, p in enumerate(params)}

        # Groups: one all-or-nothing grouped allreduce each.  Only the
        # optimizer's trainable parameters get hooks and zero fill, so
        # only they can complete a group: a group listing others still
        # issues.
        trainable = [p for p in params if p.requires_grad]
        self._group_of: Dict[torch.Tensor, int] = {}
        if groups is not None and num_groups:
            raise ValueError("pass either num_groups or groups, not both")
        if groups is not None:
            optimized = {id(p) for p in trainable}
            listed = set()
            for gi, members in enumerate(groups):
                for p in members:
                    if id(p) in listed:
                        raise ValueError("parameter appears in two groups")
                    listed.add(id(p))
                    if p.requires_grad and id(p) in optimized:
                        self._group_of[p] = gi
        elif num_groups:
            n = max(1, min(int(num_groups), len(trainable)))
            per = -(-len(trainable) // n)
            for i, p in enumerate(trainable):
                self._group_of[p] = i // per
        self._group_members: Dict[int, List[torch.Tensor]] = {}
        for p, gi in self._group_of.items():
            self._group_members.setdefault(gi, []).append(p)
        self._group_pending: Dict[int, Dict[torch.Tensor, torch.Tensor]] = {}
        # Group ids equal on every rank: taken now, in group-index order
        # (hooks, and so issues, come in a different order on each rank).
        self._group_gid: Dict[int, int] = {}
        if self._group_members:
            ctl = eager._controller()
            for gi in sorted(self._group_members):
                self._group_gid[gi] = ctl.next_group_id()

        # The hooks hold this object weakly: a dropped optimizer's hooks
        # go with it (remove() drops a live one's).
        ref = weakref.ref(self)
        handles = []
        for p in trainable:
            self._delay[p] = self.k
            handles.append(p.register_post_accumulate_grad_hook(
                functools.partial(_weak_hook, ref)))
        self._finalizer = weakref.finalize(self, _remove, handles)

    def remove(self) -> None:
        """Unregister the gradient hooks."""
        self._finalizer()

    def _hook(self, p: torch.Tensor) -> None:
        if self._delay[p] <= 0:
            raise RuntimeError(
                f"Gradients for {self._names[p]!r} were computed more than "
                f"backward_passes_per_step={self.k} times before "
                "step()/synchronize()")
        self._delay[p] -= 1
        if self._delay[p] == 0:
            self._enqueue(p)

    def _scale_factors(self) -> Tuple[ReduceOp, float, float]:
        """The op and pre/postscale with ``gradient_predivide_factor``
        folded in: Average becomes Sum with prescale 1/f and postscale
        f/size."""
        if self.predivide == 1.0:
            return self.op, 1.0, 1.0
        from ..common.process_sets import global_process_set

        ps = self.process_set or global_process_set()
        return (ReduceOp.SUM, 1.0 / self.predivide,
                self.predivide / ps.size())

    def _wire_grad(self, p: torch.Tensor, zeros: bool) -> torch.Tensor:
        """``p``'s gradient as it is sent: a copy (the controller reads it
        while the caller goes on) in the wire dtype, divided by k, then
        compressed; zeros of the same dtype when ``zeros``."""
        wire = p.dtype if p.dtype in _WIRE_DTYPES else torch.float32
        if zeros:
            grad = torch.zeros(p.shape, dtype=wire, device=p.device)
        else:
            g = p.grad.detach()
            if g.is_sparse:
                if not self.sparse_as_dense:
                    raise NotImplementedError(
                        f"sparse gradient for {self._names[p]!r}: pass "
                        "sparse_as_dense=True or use "
                        "interop.torch.sparse_allreduce_async")
                g = g.to_dense()
            grad = g.to(wire, copy=True)
            if self.k > 1:
                grad /= self.k
        grad, self._ctx[p] = self.compression.compress(grad)
        return grad

    def _enqueue(self, p: torch.Tensor, zeros: bool = False) -> None:
        grad = self._wire_grad(p, zeros)
        op, pre, post = self._scale_factors()
        self._synchronized = False
        gi = self._group_of.get(p)
        if gi is None:
            self._handles[p] = eager.allreduce_async(
                grad, name=self._names[p], op=op, prescale_factor=pre,
                postscale_factor=post, process_set=self.process_set)
            return
        # A group issues once every member has its gradient, members in
        # name order (the hooks' order differs from rank to rank).
        pending = self._group_pending.setdefault(gi, {})
        pending[p] = grad
        if len(pending) == len(self._group_members[gi]):
            members = sorted(pending, key=lambda q: self._names[q])
            handles = eager.grouped_allreduce_async(
                [pending[q] for q in members], name=f"grad_group.{gi}",
                op=op, prescale_factor=pre, postscale_factor=post,
                process_set=self.process_set, group_id=self._group_gid[gi])
            self._handles.update(zip(members, handles))
            del self._group_pending[gi]

    def mid_accumulation(self) -> bool:
        return any(0 < d < self.k for d in self._delay.values())

    def synchronize(self, optimizer) -> None:
        """Enqueue every trainable parameter no hook enqueued (zeros when
        it has no gradient), wait for every handle and install the
        reduced gradients."""
        queued = set(self._handles)
        for pending in self._group_pending.values():
            queued.update(pending)
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.requires_grad and p not in queued:
                    self._enqueue(p, zeros=p.grad is None)
        with torch.no_grad():
            for p, handle in self._handles.items():
                out = self.compression.decompress(eager.synchronize(handle),
                                                  self._ctx.pop(p))
                if p.grad is None or p.grad.is_sparse:
                    # A densified sparse gradient's reduced value replaces
                    # the sparse one outright.
                    p.grad = out.view(p.shape).to(p.dtype, copy=True)
                else:
                    p.grad.copy_(out.view(p.grad.shape))
        self._handles.clear()
        for p in self._delay:
            self._delay[p] = self.k
        self._synchronized = True


def DistributedOptimizer(optimizer,
                         named_parameters: Optional[
                             Iterable[Tuple[str, Any]]] = None,
                         compression=None,
                         backward_passes_per_step: int = 1,
                         op: ReduceOp = ReduceOp.AVERAGE,
                         gradient_predivide_factor: float = 1.0,
                         num_groups: int = 0,
                         groups=None,
                         sparse_as_dense: bool = False,
                         process_set=None):
    """Wrap a ``torch.optim`` optimizer with gradient-allreduce hooks
    (Horovod's ``hvd.DistributedOptimizer``; module docstring).  Returns
    the optimizer itself, its class swapped for a subclass of its own, so
    ``isinstance`` checks and learning-rate schedulers keep working; the
    hooks live in its ``_hvdt`` attribute (``opt._hvdt.remove()`` drops
    them)."""
    named = list(named_parameters) if named_parameters is not None else None
    base = optimizer.__class__
    cls = type("Distributed" + base.__name__, (base,), {
        "step": _step,
        "synchronize": _synchronize,
        "zero_grad": _zero_grad,
        "skip_synchronize": _skip_synchronize,
        "_hvdt_base": base,
    })
    optimizer.__class__ = cls
    optimizer._hvdt = _Hooks(
        optimizer, named, op, process_set, backward_passes_per_step,
        compression=compression,
        gradient_predivide_factor=gradient_predivide_factor,
        num_groups=num_groups, groups=groups,
        sparse_as_dense=sparse_as_dense)
    return optimizer


def _step(self, closure=None):
    h = self._hvdt
    if closure is not None:
        # A closure's backward would enqueue allreduces after the
        # synchronize below, and the step would apply local gradients.
        raise ValueError(
            "DistributedOptimizer.step() does not support closures: run "
            "backward() first, then call step() with no arguments.")
    if h.mid_accumulation():
        raise RuntimeError(
            f"step() called mid-accumulation: with "
            f"backward_passes_per_step={h.k}, call backward() {h.k} times "
            "before each step()")
    if not h._synchronized:
        h.synchronize(self)
    out = self._hvdt_base.step(self)
    h._synchronized = False
    return out


def _synchronize(self):
    """Wait for every outstanding gradient allreduce and install the
    reduced gradients."""
    self._hvdt.synchronize(self)


def _skip_synchronize(self):
    """Context manager telling the next ``step()`` not to synchronize
    again, after an explicit ``synchronize()`` (gradient clipping)::

        opt.synchronize()
        torch.nn.utils.clip_grad_norm_(model.parameters(), 1.0)
        with opt.skip_synchronize():
            opt.step()
    """
    h = self._hvdt

    @contextlib.contextmanager
    def _ctx():
        # step() skips synchronizing while h._synchronized holds, so the
        # context only guards against misuse.
        if not h._synchronized:
            raise RuntimeError(
                "skip_synchronize() entered without a prior synchronize(): "
                "step() would apply unreduced gradients")
        yield

    return _ctx()


def _zero_grad(self, set_to_none: bool = True):
    h = self._hvdt
    if h._handles:
        raise RuntimeError(
            "zero_grad() called with allreduce handles outstanding: call "
            "step() or synchronize() first")
    if h.mid_accumulation():
        raise RuntimeError(
            "zero_grad() called mid-accumulation would discard gradients: "
            f"with backward_passes_per_step={h.k}, zero only after the "
            "boundary step()")
    return self._hvdt_base.zero_grad(self, set_to_none=set_to_none)
