"""Cross-rank ``SyncBatchNorm`` with torch's ``_BatchNorm`` semantics.

The counterpart of the JAX package's ``interop/torch_sync_batch_norm.py``
(Horovod's ``horovod/torch/sync_batch_norm.py``): a drop-in for
``nn.BatchNorm*d`` whose training-mode statistics are those of the
global batch.  The forward packs ``[count, sum, sum of squares]`` per
channel and sums it over the ranks with one named eager allreduce
(``sync_bn.stats``); the backward packs ``[sum dy, sum dy·(x - mean)]``
and sums it as ``sync_bn.grads``.  Both vectors (``[2C+1]`` and
``[2C]``) are summed on the input's device in float64, where the JAX
package sums them on the host in float64; the mean and variance are then
formed in float32 and the output normalised in the input's dtype, so a
half or bf16 input keeps its dtype.  The weight and bias gradients stay
local: they ride the optimizer's allreduce like every other gradient.

``momentum=None`` keeps a cumulative average; the running variance is
made unbiased with the global count the forward reduced, so ragged
per-rank batches give the running statistics of the whole batch.  In
eval mode, or in a world of one, it is plain ``_BatchNorm``.

This is not ``horovod_tpu_torch.SyncBatchNorm``, which has flax's
semantics (biased variance, the port's ResNet layers).
"""

from __future__ import annotations

import torch
from torch.nn.modules.batchnorm import _BatchNorm

from ..common.types import ReduceOp
from ..ops import eager

__all__ = ["SyncBatchNorm"]


def _allreduce_sum(packed: torch.Tensor, name: str) -> torch.Tensor:
    return eager.allreduce(packed, name=name, op=ReduceOp.SUM)


class _SyncBNFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        # x: [N, C, *]; statistics over every dim but C.
        dims = [0] + list(range(2, x.dim()))
        c = x.shape[1]
        x64 = x.detach().to(torch.float64)
        packed = torch.cat([
            torch.full((1,), float(x.numel() // c), dtype=torch.float64,
                       device=x.device),
            x64.sum(dims), (x64 * x64).sum(dims)])
        packed = _allreduce_sum(packed, "sync_bn.stats")
        n_total = packed[0]
        mean = (packed[1:1 + c] / n_total).to(torch.float32)
        var = (packed[1 + c:] / n_total).to(torch.float32) - mean * mean
        invstd = torch.rsqrt(var + eps)

        shape = [1, c] + [1] * (x.dim() - 2)
        # Normalise in the input's dtype (a half or bf16 model gets half
        # or bf16 out); the mean and var for the running stats stay f32.
        out = (x - mean.to(x.dtype).view(shape)) * \
            invstd.to(x.dtype).view(shape)
        if weight is not None:
            out = out * weight.view(shape) + bias.view(shape)
        ctx.save_for_backward(x, weight, mean, invstd)
        # A tensor: reading it on the host would wait for the device.
        ctx.n_total = n_total
        ctx.dims = dims
        ctx.bn_shape = shape
        count = n_total.to(torch.float32)
        ctx.mark_non_differentiable(mean, var, count)
        return out, mean, var, count

    @staticmethod
    def backward(ctx, grad_output, _gmean, _gvar, _gcount):
        x, weight, mean, invstd = ctx.saved_tensors
        dims, shape, n = ctx.dims, ctx.bn_shape, ctx.n_total
        xmu = x - mean.to(x.dtype).view(shape)

        sum_dy = grad_output.sum(dims)                     # [C]
        sum_dy_xmu = (grad_output * xmu).sum(dims)         # [C]
        c = x.shape[1]
        packed = _allreduce_sum(
            torch.cat([sum_dy, sum_dy_xmu]).to(torch.float64),
            "sync_bn.grads")
        # The global means of dy and dy·(x - mean), formed in f64.
        mean_dy = (packed[:c] / n).to(torch.float32).to(x.dtype)
        mean_dy_xmu = (packed[c:] / n).to(torch.float32).to(x.dtype)

        w = (weight.to(x.dtype).view(shape) if weight is not None
             else torch.ones_like(invstd, dtype=x.dtype).view(shape))
        inv = invstd.to(x.dtype).view(shape)
        dx = w * inv * (
            grad_output
            - mean_dy.view(shape)
            - xmu * (inv ** 2) * mean_dy_xmu.view(shape))

        if weight is not None:
            dw = (grad_output * xmu * inv).sum(dims)
            db = sum_dy
        else:
            dw = db = None
        return dx, dw, db, None


class SyncBatchNorm(_BatchNorm):
    """Drop-in ``nn.BatchNorm*d`` with cross-rank statistics (Horovod's
    ``hvd.SyncBatchNorm``, the same constructor).  A module-level class:
    picklable (``torch.save(model)``) and ``isinstance``-able."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True):
        super().__init__(num_features, eps=eps, momentum=momentum,
                         affine=affine,
                         track_running_stats=track_running_stats)

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(
                f"expected at least 2D input (got {x.dim()}D)")

    def forward(self, x):
        self._check_input_dim(x)
        from ..common import basics

        world = basics.size() if basics.is_initialized() else 1
        if not self.training or world == 1:
            return super().forward(x)
        out, mean, var, count = _SyncBNFunction.apply(
            x, self.weight if self.affine else None,
            self.bias if self.affine else None, self.eps)
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked += 1
                if self.momentum is None:        # cumulative average
                    m = 1.0 / self.num_batches_tracked.to(torch.float32)
                else:
                    m = self.momentum
                # Unbiased with the global count the forward reduced.
                unbiased = var * (count / (count - 1.0).clamp(min=1.0))
                self.running_mean.mul_(1 - m).add_(mean * m)
                self.running_var.mul_(1 - m).add_(unbiased * m)
        return out
