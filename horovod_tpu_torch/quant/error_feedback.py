"""Error feedback for quantized gradient communication.

The PyTorch counterpart of the JAX package's ``quant/error_feedback.py``
(EF-SGD lineage): the quantization error of each step's gradient is
carried into the next step instead of dropped, so the int8/int4 wire
trains like the exact one.  Per parameter, before the wrapped
optimizer's ``step()``:

    e        = grad.float() + residual    # error-compensated gradient
    sent     = qdq(e)                      # the value the wire carries
    residual = e - sent                    # this rank's quantization error
    grad     = sent, in grad's dtype       # what the wrapped chain sees

``qdq`` is :func:`quant.kernels.quantize_dequantize` (or its int4
sibling): exactly the stage-1 wire value, so the first hop of the
quantized allreduce carries ``sent`` without further loss.  The f32
residuals are per-rank state.  ``enabled=False`` keeps the same state
(zero residuals) and passes the gradients through exactly.  A step
inside a CUDA-graph capture raises ``NotImplementedError``: the wire
under capture is not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from ..common import graphs
from . import kernels as qk

__all__ = ["with_error_feedback"]


class _ErrorFeedbackOptimizer:
    """The wrapper :func:`with_error_feedback` returns.  Attribute access
    it does not define (``param_groups``, ``synchronize``, ...) goes to
    the wrapped optimizer."""

    def __init__(self, optimizer: Any, block_size: Optional[int],
                 enabled: bool, wire: str):
        self.optimizer = optimizer
        self._block = block_size
        self._enabled = enabled
        self.wire = wire
        self._qdq = (qk.quantize_dequantize_int4 if wire == "int4"
                     else qk.quantize_dequantize)
        self._params: List[torch.Tensor] = [
            p for g in optimizer.param_groups for p in g["params"]]
        self.residual: Dict[torch.Tensor, torch.Tensor] = {
            p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in self._params}

    def __getattr__(self, name: str):
        return getattr(self.__dict__["optimizer"], name)

    @torch.no_grad()
    def compensate(self) -> None:
        """Replace every ``.grad`` with its quantized, error-compensated
        value and keep the new residuals (a no-op when disabled, apart
        from the f32 round trip of ``grad + 0``)."""
        for p in self._params:
            g = p.grad
            if g is None:
                continue
            r = self.residual[p]
            e = g.float() + r
            if self._enabled:
                sent = self._qdq(e, self._block)
                torch.sub(e, sent, out=r)
            else:
                sent = e
            g.copy_(sent)

    def step(self, closure: Optional[Callable[[], Any]] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        if graphs.capturing():
            raise NotImplementedError(
                "error feedback inside a CUDA-graph capture is not ported "
                "yet (ROADMAP Queue 1: the rest of slice 2)")
        self.compensate()
        self.optimizer.step()
        return loss

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def state_dict(self) -> Dict[str, Any]:
        """The wrapped optimizer's state and the residuals, in parameter
        order."""
        return {"inner": self.optimizer.state_dict(),
                "residual": [self.residual[p].clone() for p in self._params]}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        residual = state["residual"]
        if len(residual) != len(self._params):
            raise ValueError(f"state has {len(residual)} residuals for "
                             f"{len(self._params)} parameters")
        self.optimizer.load_state_dict(state["inner"])
        for p, r in zip(self._params, residual):
            self.residual[p].copy_(r)


def with_error_feedback(optimizer: Any, block_size: Optional[int] = None,
                        enabled: bool = True, wire: str = "int8"):
    """Wrap an optimizer (typically ``DistributedOptimizer(...,
    compression=Compression.int8)``) with a quantization-error residual
    accumulator::

        opt = hvd.quant.with_error_feedback(
            hvd.DistributedOptimizer(hvd.fused_sgd(model.parameters(),
                                                   0.01, momentum=0.9),
                                     compression=hvd.Compression.int8))
        loss.backward()
        opt.step()

    Args:
      optimizer: the optimizer receiving the on-grid gradients.
      block_size: wire block size (default ``HVDT_QUANT_BLOCK``).
      enabled: with False, gradients pass through and the residuals stay
        zero: the same state, exact math (the f32-wire leg of an A/B).
      wire: the grid ``sent`` is snapped to, ``"int8"`` or ``"int4"``
        (it does not read the environment).
    """
    if wire not in ("int8", "int4"):
        raise ValueError(
            f"with_error_feedback wire must be 'int8' or 'int4', "
            f"got {wire!r}")
    return _ErrorFeedbackOptimizer(optimizer, block_size, enabled, wire)
