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
(zero residuals) and passes the gradients through exactly.  The
residuals are allocated once and updated in place, and nothing on the
path reads a value on the host, so a step captured by
``step_pipeline.donated_step`` replays the eager step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch

from . import kernels as qk

__all__ = ["ErrorFeedbackState", "with_error_feedback", "tile_residual",
           "stack_residual", "unstack_residual"]


class ErrorFeedbackState(NamedTuple):
    """The reference's functional error-feedback state: ``residual``, a
    tree (tensor, or dict / list / tuple of them) of f32 carried
    quantization error, and ``inner``, the wrapped transformation's
    state."""
    residual: Any
    inner: Any


# The helpers below are the reference's shard_map carry pattern: there
# one program holds every rank's residual, stacked on a leading [n] axis
# that crosses the shard_map boundary.  In the port each process holds
# its own residual (``_ErrorFeedbackOptimizer.residual``), so a caller
# needs them only to move a residual tree between that stacked layout
# and one rank's: a checkpoint written by the reference's loop, or a
# tree gathered from every rank (``hvd.allgather`` gives the [n, ...]
# layout ``unstack_residual`` takes row by row).


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    raise TypeError(f"unsupported residual leaf {type(tree).__name__}")


def tile_residual(state: ErrorFeedbackState, n: int) -> ErrorFeedbackState:
    """Residual leaves gain a leading [n] axis (identical copies): a
    fresh state laid out for an ``n``-rank stacked carry."""
    return state._replace(residual=_map(
        lambda t: t.unsqueeze(0).repeat((n,) + (1,) * t.dim()),
        state.residual))


def unstack_residual(state: ErrorFeedbackState) -> ErrorFeedbackState:
    """Drop the leading [1] axis of one rank's slice of a stacked
    residual."""
    return state._replace(residual=_map(lambda t: t[0], state.residual))


def stack_residual(state: ErrorFeedbackState) -> ErrorFeedbackState:
    """Re-add the leading [1] axis, so one rank's residual concatenates
    with its peers' into the stacked layout."""
    return state._replace(residual=_map(lambda t: t.unsqueeze(0),
                                        state.residual))


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
        # An overlapped DistributedOptimizer (HVDT_OVERLAP=on) issues its
        # buckets from gradient hooks, before step(): it compensates each
        # gradient there, and step() skips the ones it did.
        self._inner_hooks = getattr(optimizer, "_hooked", None) is not None
        if self._inner_hooks:
            optimizer._pre_exchange = self._compensate_one

    def __getattr__(self, name: str):
        return getattr(self.__dict__["optimizer"], name)

    @torch.no_grad()
    def _compensate_one(self, p: torch.Tensor) -> None:
        g = p.grad
        if g is None:
            if not p.requires_grad:
                return
            # As the reference's update on a zero gradient: this rank
            # sends qdq(0 + r) in the slot the wrapped optimizer would
            # zero-fill, and keeps the new residual.
            g = p.grad = torch.zeros_like(p)
        r = self.residual[p]
        e = g.float() + r
        if self._enabled:
            sent = self._qdq(e, self._block)
            torch.sub(e, sent, out=r)
        else:
            sent = e
        g.copy_(sent)

    @torch.no_grad()
    def compensate(self) -> None:
        """Replace every ``.grad`` with its quantized, error-compensated
        value and keep the new residuals (a no-op when disabled, apart
        from the f32 round trip of ``grad + 0``).  Gradients an
        overlapped inner optimizer's hooks compensated this pass are
        skipped."""
        done = self.optimizer._transformed if self._inner_hooks else ()
        for p in self._params:
            if p not in done:
                self._compensate_one(p)

    def step(self, closure: Optional[Callable[[], Any]] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
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
