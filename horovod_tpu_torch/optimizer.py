"""DistributedOptimizer — the gradient-averaging wrapper.

The PyTorch counterpart of the JAX package's ``optimizer.py``.  It wraps
a ``torch.optim.Optimizer``; before the wrapped ``step()`` it averages
every parameter's ``.grad`` over the world in fused buckets
(``ops/device.fused_allreduce``: one flat buffer and one ``all_reduce``
per bucket, copied back into the gradients).

``backward_passes_per_step=k`` accumulates the gradients of k calls to
``step()`` locally, in f32, and only the k-th call communicates their
mean and steps the wrapped optimizer; the other calls issue no
collective and leave the parameters unchanged (the update ``optax.
MultiSteps`` gives in the JAX package, without its per-pass exchange).

``compression`` picks the wire: ``Compression.none`` / ``.fp16`` /
``.bf16`` cast each bucket, ``.int8`` / ``.int4`` send each float bucket
through the two-stage block-scaled quantized allreduce
(``quant/collectives.py``); pair those with ``quant.with_error_feedback``.
Left unset, it is read from the environment (``HVDT_COMPRESSION``,
``HVDT_QUANT``) by ``Compression.from_env()``, as in the JAX package.

ZeRO, overlap scheduling and Adasum are later work and raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from .common.process_sets import ProcessSet
from .common.types import ReduceOp
from .ops import device as dev
from .ops.compression import Compression, Compressor

__all__ = ["DistributedOptimizer", "allreduce_gradients"]

def _check_supported(op: ReduceOp) -> None:
    if ReduceOp(op) == ReduceOp.ADASUM:
        raise NotImplementedError(
            "Adasum is not ported yet (ROADMAP Queue 1, item 8)")
    if ReduceOp(op) not in (ReduceOp.AVERAGE, ReduceOp.SUM):
        raise ValueError(f"Unsupported gradient reduce op: {op}")


def allreduce_gradients(grads: Sequence[torch.Tensor],
                        op: ReduceOp = ReduceOp.AVERAGE,
                        compression: Optional[Compressor] = None,
                        threshold_bytes: Optional[int] = None,
                        prescale_factor: float = 1.0,
                        postscale_factor: float = 1.0,
                        process_set: Optional[ProcessSet] = None
                        ) -> List[torch.Tensor]:
    """Fused gradient allreduce for custom update loops: the reduced
    tensors, in input order.  ``compression=None`` reads the
    environment (``Compression.from_env()``)."""
    _check_supported(op)
    if compression is None:
        compression = Compression.from_env()
    return dev.fused_allreduce(
        grads, op=op, threshold_bytes=threshold_bytes,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        wire_dtype=compression.wire_dtype, process_set=process_set)


class _DistributedOptimizer:
    """The wrapper ``DistributedOptimizer`` returns.  Attribute access it
    does not define (``param_groups``, ``state``, ``state_dict``, ...)
    goes to the wrapped optimizer."""

    def __init__(self, optimizer: torch.optim.Optimizer, op: ReduceOp,
                 compression: Compressor, backward_passes_per_step: int,
                 threshold_bytes: Optional[int], prescale_factor: float,
                 postscale_factor: float,
                 process_set: Optional[ProcessSet]):
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self.optimizer = optimizer
        self._op = op
        self._compression = compression
        self._k = int(backward_passes_per_step)
        self._threshold = threshold_bytes
        self._prescale = prescale_factor
        self._postscale = postscale_factor
        self._process_set = process_set
        self._passes = 0
        self._acc: Dict[torch.Tensor, torch.Tensor] = {}

    def __getattr__(self, name: str):
        return getattr(self.__dict__["optimizer"], name)

    def _params_with_grad(self) -> List[torch.Tensor]:
        return [p for g in self.optimizer.param_groups for p in g["params"]
                if p.grad is not None]

    def synchronize(self) -> None:
        """Average (or sum) every ``.grad`` over the process set, in
        place, as fused bucket collectives."""
        params = self._params_with_grad()
        reduced = allreduce_gradients(
            [p.grad for p in params], op=self._op,
            compression=self._compression, threshold_bytes=self._threshold,
            prescale_factor=self._prescale,
            postscale_factor=self._postscale, process_set=self._process_set)
        with torch.no_grad():
            for p, r in zip(params, reduced):
                p.grad.copy_(r)

    def _accumulate(self) -> bool:
        """Fold this pass's grads into the f32 accumulators; True on the
        k-th pass, with the grads then set to the accumulated mean."""
        with torch.no_grad():
            for p in self._params_with_grad():
                acc = self._acc.get(p)
                if acc is None:
                    self._acc[p] = p.grad.float().clone()
                else:
                    acc.add_(p.grad.float())
            if self._passes % self._k:
                return False
            for p, acc in self._acc.items():
                mean = (acc / self._k).to(p.dtype)
                if p.grad is None:
                    p.grad = mean
                else:
                    p.grad.copy_(mean)
            self._acc.clear()
        return True

    def step(self, closure: Optional[Callable[[], Any]] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self._passes += 1
        if self._k > 1 and not self._accumulate():
            return loss
        self.synchronize()
        self.optimizer.step()
        return loss

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)


def DistributedOptimizer(optimizer: torch.optim.Optimizer, *,
                         op: ReduceOp = ReduceOp.AVERAGE,
                         compression: Optional[Compressor] = None,
                         backward_passes_per_step: int = 1,
                         threshold_bytes: Optional[int] = None,
                         prescale_factor: float = 1.0,
                         postscale_factor: float = 1.0,
                         process_set: Optional[ProcessSet] = None,
                         zero: Optional[Any] = None):
    """Wrap a ``torch.optim.Optimizer`` so gradients are averaged across
    the world before each update::

        opt = hvd.DistributedOptimizer(hvd.fused_sgd(model.parameters(),
                                                     0.01, momentum=0.9))
        loss.backward()
        opt.step()

    Args:
      optimizer: the optimizer to wrap.
      op: Average (default) or Sum.
      compression: the wire of the fused collectives: Compression.none /
        .fp16 / .bf16 (casts) or .int8 / .int4 (the quantized allreduce).
        None (default) reads ``HVDT_COMPRESSION`` / ``HVDT_QUANT``.
      backward_passes_per_step: passes accumulated locally between
        collectives (see module docstring).
      threshold_bytes: fusion bucket size; default ``HVDT_FUSION_THRESHOLD``.
      prescale_factor / postscale_factor: scales before / after the sum.
      process_set: the ranks to average over (default: the world).
      zero: ZeRO state sharding, not ported yet.
    """
    if zero is not None:
        raise NotImplementedError(
            "ZeRO state sharding is not ported yet (ROADMAP Queue 1, item 8)")
    _check_supported(op)
    if compression is None:
        compression = Compression.from_env()
    return _DistributedOptimizer(optimizer, op, compression,
                                 backward_passes_per_step, threshold_bytes,
                                 prescale_factor, postscale_factor,
                                 process_set)
