"""Training-loop callbacks and schedules.

The port of the JAX package's ``callbacks.py`` on torch tensors (ref:
horovod/_keras/callbacks.py — BroadcastGlobalVariablesCallback :20,
MetricAverageCallback :49, LearningRateWarmupCallback;
keras/callbacks.py:151 BestModelCheckpoint).  Training loops are
explicit, so these are functions and schedules rather than Keras
callback objects:

* ``broadcast_global_state``    — sync parameters (and an optimizer's
  state) from rank 0 at start
* ``average_metrics``           — allreduce epoch metrics across ranks
* ``warmup_schedule``           — LR warmup to lr*size over N steps (the
  "facebook paper" ramp the reference implements)
* ``rank_zero_only``            — checkpoint-on-rank-0 guard
* ``BestModelCheckpoint``       — keep the best parameters by a metric
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from .common import basics
from .common.process_sets import ProcessSet, global_process_set
from .functions import broadcast_optimizer_state, broadcast_parameters

__all__ = ["broadcast_global_state", "average_metrics", "warmup_schedule",
           "rank_zero_only", "BestModelCheckpoint"]


def broadcast_global_state(params, optimizer=None, root_rank: int = 0,
                           process_set: Optional[ProcessSet] = None):
    """Make rank 0's parameters (a module, a dict or list of tensors;
    in place) and optionally an optimizer's state authoritative (ref:
    BroadcastGlobalVariablesCallback on_batch_end-once semantics).
    Returns ``params``, or ``(params, optimizer)`` when one is given."""
    params = broadcast_parameters(params, root_rank, process_set)
    if optimizer is not None:
        optimizer = broadcast_optimizer_state(optimizer, root_rank,
                                              process_set)
        return params, optimizer
    return params


def average_metrics(metrics: Mapping[str, Any],
                    process_set: Optional[ProcessSet] = None
                    ) -> Dict[str, float]:
    """Average scalar metrics across ranks at epoch end, one named eager
    allreduce a metric in sorted key order (ref: MetricAverageCallback
    _keras/callbacks.py:49).  A metric may be a number, a numpy value or
    a 0-d tensor."""
    from .ops import eager

    ps = process_set or global_process_set()
    out = {}
    for key in sorted(metrics):
        val = metrics[key]
        if isinstance(val, torch.Tensor):
            val = val.detach().cpu().double().numpy()
        val = np.asarray(val, dtype=np.float64)
        out[key] = float(eager.allreduce(val, name=f"metric.{key}",
                                         process_set=ps))
    return out


def warmup_schedule(base_lr: float, warmup_steps: int,
                    scale: Optional[float] = None,
                    after: Optional[Callable[[Any], Any]] = None):
    """LR schedule ramping from base_lr to base_lr*scale over warmup_steps
    (ref: LearningRateWarmupCallback — gradual warmup to the size-scaled
    rate per Goyal et al.), then following ``after`` (step → absolute
    learning rate) or holding the scaled rate.

    ``scale`` defaults to the world size (the linear-scaling rule).  The
    schedule takes a step (a number or a tensor) and returns a float32
    tensor, computed in float32 as the reference computes it."""
    if scale is None:
        scale = float(max(1, basics.size())) if basics.is_initialized() \
            else 1.0

    def schedule(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        target = base_lr * scale
        frac = torch.clamp(step / max(1, warmup_steps), max=1.0)
        warm = base_lr + (target - base_lr) * frac
        if after is None:
            return warm
        return torch.where(step < warmup_steps, warm,
                           torch.as_tensor(after(step),
                                           dtype=torch.float32))

    return schedule


def rank_zero_only(fn: Callable) -> Callable:
    """Decorator: run only on (global) rank 0 — the checkpoint guard
    (ref: rank-0-only save pattern, keras/callbacks.py:151)."""

    def wrapper(*args, **kwargs):
        if basics.rank() == 0:
            return fn(*args, **kwargs)
        return None

    return wrapper


def _host(params):
    """Host copies of a module's ``state_dict()`` or of a tree of
    tensors."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    if isinstance(params, torch.Tensor):
        return params.detach().to("cpu", copy=True)
    if isinstance(params, dict):
        return {k: _host(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_host(v) for v in params)
    return params


class BestModelCheckpoint:
    """Keep the best parameters by a monitored metric, saving host copies
    with ``torch.save`` on rank 0 only (ref: keras/callbacks.py:151
    BestModelCheckpoint)."""

    def __init__(self, path: str, monitor: str = "val_loss",
                 mode: str = "min"):
        self.path = path
        self.monitor = monitor
        self.mode = mode
        self.best: Optional[float] = None

    def __call__(self, metrics: Mapping[str, Any], params) -> bool:
        value = metrics[self.monitor]
        value = float(value.item() if isinstance(value, torch.Tensor)
                      else np.asarray(value))
        better = (self.best is None or
                  (value < self.best if self.mode == "min" else
                   value > self.best))
        if better:
            self.best = value
            if basics.rank() == 0:
                torch.save(_host(params), self.path)
        return better
