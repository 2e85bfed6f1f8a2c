"""Cross-rank synchronized batch normalization (SyncBatchNorm).

The PyTorch counterpart of the JAX package's ``sync_batch_norm.py``.
There the batch statistics are ``lax.pmean``'d over a mesh axis inside
the jitted step and autodiff transposes the collective; here they are
all-reduced over a ``torch.distributed`` process group by an autograd
Function whose backward is that transpose (:func:`group_mean`).

* :func:`sync_batch_stats` — the global ``(mean, var)`` of a tensor over
  its local reduction axes and the group: the moments ``E[x]`` and
  ``E[x²]`` are averaged over the group in one collective, then
  ``var = E[x²] - E[x]²``.  Averaging per-rank variances instead would
  drop the between-rank term (the variance of the rank means).
* :class:`SyncBatchNorm` — flax's ``nn.BatchNorm`` with ``axis_name``
  bound, as the reference's ``SyncBatchNorm`` is: the feature axis last,
  biased (fast) variance clipped at 0, eps 1e-5, running statistics
  ``ra = m * ra + (1 - m) * batch`` with m = 0.99.  ``torch.nn.
  SyncBatchNorm`` differs on all three counts and is not used.

The group is a ``ProcessGroup``, a ``DeviceMesh`` (its ``axis``
dimension is taken, ``"dp"`` by default) or None for the world; without
an initialized process group a world of one is assumed and no
collective runs.  Equal shards on every rank, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from .common.basics import DeviceLike, resolve_device

__all__ = ["SyncBatchNorm", "sync_batch_stats", "group_mean",
           "resolve_group"]


def resolve_group(group=None, axis: str = "dp"
                  ) -> Tuple[Optional[dist.ProcessGroup], int]:
    """``(process group, its size)`` for a group argument: a
    ``ProcessGroup``, a ``DeviceMesh`` (its ``axis`` dimension) or None
    for the world (``(None, 1)`` when no process group exists)."""
    if hasattr(group, "get_group"):
        group = group.get_group(axis)
    if group is None:
        if not dist.is_initialized():
            return None, 1
        group = dist.group.WORLD
    return group, dist.get_world_size(group)


def all_sum_(t: torch.Tensor, group: Optional[dist.ProcessGroup]
             ) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (no-op without a group)."""
    if group is not None:
        dist.all_reduce(t, dist.ReduceOp.SUM, group=group)
    return t


class _GroupMean(torch.autograd.Function):
    """The mean over the group of each rank's ``x``.  Its transpose is
    the same mean of the cotangents: every rank's output depends on
    every rank's input with weight 1/n.  Sum, then divide (gloo has no
    ``ReduceOp.AVG``)."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return all_sum_(x.contiguous().clone(), group).div_(size)

    @staticmethod
    def backward(ctx, g):
        return (all_sum_(g.contiguous().clone(), ctx.group).div_(ctx.size),
                None, None)


def group_mean(x: torch.Tensor, group=None, axis: str = "dp"
               ) -> torch.Tensor:
    """Differentiable mean of ``x`` over the ranks of ``group`` (one
    collective; see :func:`resolve_group`)."""
    pg, size = resolve_group(group, axis)
    return _GroupMean.apply(x, pg, size)


def sync_batch_stats(x: torch.Tensor, group=None,
                     reduction_axes: Sequence[int] = (0,), *,
                     axis: str = "dp"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global ``(mean, var)`` of ``x`` over ``reduction_axes`` and the
    ranks of ``group``: the statistic SyncBatchNorm normalizes with.
    ``E[x]`` and ``E[x²]`` ride one collective as a ``[2, ...]`` stack;
    ``var = E[x²] - E[x]²`` (biased).  Differentiable."""
    axes = tuple(reduction_axes)
    m = torch.stack([x.mean(axes), (x * x).mean(axes)])
    m1, m2 = group_mean(m, group, axis).unbind(0)
    return m1, m2 - m1 * m1


class SyncBatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` synchronized across the ranks of ``group``
    (the reference's ``SyncBatchNorm``, ``axis_name="dp"``).

    The features are the last axis of the input; the statistics reduce
    over every other axis and the group, in f32.  Parameters ``scale``
    and ``bias`` (``param_dtype``), buffers ``mean`` and ``var`` (f32,
    flax's ``batch_stats``).  In training mode the batch statistics
    normalize and update the running ones; in eval mode (or with
    ``use_running_average=True``) the running ones normalize.  The
    output dtype is the promotion of the input's and the parameters'
    (flax's ``_normalize``).
    """

    def __init__(self, num_features: int, *, momentum: float = 0.99,
                 eps: float = 1e-5, group=None, axis_name: str = "dp",
                 param_dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.momentum, self.eps = momentum, eps
        self.group, self.axis_name = group, axis_name
        self.scale = nn.Parameter(torch.ones(num_features, dtype=param_dtype,
                                             device=dev))
        self.bias = nn.Parameter(torch.zeros(num_features, dtype=param_dtype,
                                             device=dev))
        self.register_buffer("mean", torch.zeros(num_features, device=dev))
        self.register_buffer("var", torch.ones(num_features, device=dev))

    def forward(self, x: torch.Tensor,
                use_running_average: Optional[bool] = None) -> torch.Tensor:
        if use_running_average is None:
            use_running_average = not self.training
        xf = x.float()
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            mean, var = sync_batch_stats(xf, self.group,
                                         tuple(range(x.dim() - 1)),
                                         axis=self.axis_name)
            var = torch.clamp_min(var, 0.0)
            with torch.no_grad():
                k = self.momentum
                self.mean.copy_(k * self.mean + (1 - k) * mean)
                self.var.copy_(k * self.var + (1 - k) * var)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.scale)
        y = y + self.bias
        out = torch.promote_types(x.dtype, self.scale.dtype)
        return y.to(out)
