"""Fused 1x1-conv (matmul) + BatchNorm kernels.

The PyTorch counterpart of the JAX package's ``ops/conv_fused.py``.  A
1x1 convolution over NHWC activations is a matmul over the flattened
spatial grid (``[B*H*W, Cin] @ [Cin, Cout]``).  Two kernels, written in
CUDA C++ for Hopper in ``csrc/conv_fused.cu`` (the source's header says
what bounds them and how the design answers it):

* ``_mm_forward`` (replaces ``_mm_kernel``): ``relu((a @ w) * scale +
  bias)`` with f32 accumulation and one write in ``a``'s dtype — the
  eval-mode conv + folded BN affine;
* ``matmul_batch_stats`` (replaces ``_mm_stats_kernel``): ``z = a @ w``
  written once, plus per-``BLOCK_M``-row partial sums of z and z² from
  the f32 accumulator — the train-mode conv + batch statistics.

Both are one persistent wgmma + TMA GEMM with two epilogues.  Each
wrapper takes its kernel's plain PyTorch version only for a tensor on
the CPU; on a CUDA tensor it launches the kernel (bf16 or fp16 operands
of one type) or raises.  ``launches`` on each wrapper counts kernel
launches.

The differentiable entries are ``torch.autograd.Function``s whose
backward is the JAX package's formula in plain PyTorch (the reference's
backward is XLA): z is recomputed, relu'(0) = 0 from the ``y > 0`` mask,
and cotangents arriving on the batch mean/var are honoured.  BatchNorm
here is per-rank; the cross-rank (SyncBN) form is later work.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

__all__ = ["matmul_bn_relu", "conv1x1_bn_relu", "conv1x1_bn_relu_reference",
           "matmul_batch_stats", "conv1x1_bn_train",
           "conv1x1_bn_train_reference"]

# Row height of one s1/s2 partial: the CUDA kernel's output tile height.
BLOCK_M = 128
_KERNEL_DTYPES = (torch.bfloat16, torch.float16)


def _lib() -> ctypes.CDLL:
    from .._build import load_library

    lib = load_library("conv_fused")
    if not getattr(lib, "_hvdt_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.hvdt_mm_bn_relu.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        lib.hvdt_mm_bn_relu.restype = i
        lib.hvdt_mm_stats.argtypes = [p, p, p, p, p, i, i, i, i, p]
        lib.hvdt_mm_stats.restype = i
        lib.hvdt_conv_fused_block_m.argtypes = []
        lib.hvdt_conv_fused_block_m.restype = i
        if lib.hvdt_conv_fused_block_m() != BLOCK_M:
            raise RuntimeError("csrc/conv_fused.cu tile height differs from "
                               f"BLOCK_M={BLOCK_M}")
        lib._hvdt_typed = True
    return lib


def _check_shapes(a: torch.Tensor, w: torch.Tensor) -> Tuple[int, int, int]:
    if a.dim() != 2 or w.dim() != 2:
        raise ValueError(f"a and w must be 2-D, got {tuple(a.shape)} and "
                         f"{tuple(w.shape)}")
    m, k = a.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"a has K={k} but w has K={k2}")
    return m, k, n


def _cuda_operands(a: torch.Tensor, w: torch.Tensor, k: int, n: int):
    """Validate the kernel's operands; returns (a, wt) contiguous, with
    wt = w transposed to [N, K] (free when w is itself the transpose of
    a contiguous [N, K] weight, as a 1x1 conv's OIHW weight is)."""
    if a.device.type != "cuda":
        raise ValueError(f"fused conv kernels run on CUDA, got {a.device}")
    if w.device != a.device:
        raise ValueError(f"a on {a.device} but w on {w.device}")
    if a.dtype not in _KERNEL_DTYPES or w.dtype != a.dtype:
        raise TypeError("the fused conv kernels take bf16 or fp16 operands "
                        f"of one type, got {a.dtype} and {w.dtype}")
    if k == 0 or k % 8 or n % 8:
        raise ValueError(f"K={k} and N={n} must be multiples of 8, K > 0")
    a = a.contiguous()
    wt = w.t().contiguous()
    for t in (a, wt):
        if t.data_ptr() % 16:
            raise ValueError("fused conv operands must be 16-byte aligned")
    return a, wt


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---- kernel #3: matmul + folded BN affine (+ReLU) ------------------------


def _mm_forward_plain(a, w, scale, bias, relu: bool) -> torch.Tensor:
    """Plain version of ``_mm_forward``: f32 product, f32 epilogue, one
    cast to ``a``'s dtype."""
    y = torch.matmul(a.float(), w.float())
    y.mul_(scale.float()).add_(bias.float())
    if relu:
        y.clamp_min_(0.0)
    return y.to(a.dtype)


def _mm_forward(a: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor, relu: bool) -> torch.Tensor:
    """``relu((a @ w) * scale + bias)``: a [M, K], w [K, N], scale/bias
    [N] (f32); returns [M, N] in a's dtype."""
    m, k, n = _check_shapes(a, w)
    if scale.shape != (n,) or bias.shape != (n,):
        raise ValueError(f"scale/bias must be [{n}], got "
                         f"{tuple(scale.shape)}/{tuple(bias.shape)}")
    if a.device.type == "cpu":
        return _mm_forward_plain(a, w, scale, bias, relu)
    a, wt = _cuda_operands(a, w, k, n)
    scale = scale.float().contiguous()
    bias = bias.float().contiguous()
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        rc = _lib().hvdt_mm_bn_relu(a.data_ptr(), wt.data_ptr(),
                                    scale.data_ptr(), bias.data_ptr(),
                                    out.data_ptr(), m, n, k, int(relu),
                                    int(a.dtype == torch.float16),
                                    _stream(a))
    if rc:
        raise RuntimeError(f"hvdt_mm_bn_relu launch failed: CUDA error {rc}")
    _mm_forward.launches += 1
    return out


_mm_forward.launches = 0


class _MMDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, w, scale, bias, relu):
        y = _mm_forward(a, w, scale, bias, relu)
        ctx.relu = relu
        # y feeds only the relu mask: without relu it is not kept.
        ctx.save_for_backward(a, w, scale, bias, y if relu else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        """g = dy * 1[y>0]; dz = g * scale; da = dz w^T; dw = a^T dz;
        dbias = sum_M g; dscale = sum_M g*z with z = a @ w recomputed in
        f32 (exact for every scale, including zero)."""
        a, w, scale, bias, y = ctx.saved_tensors
        g = dy.float()
        if ctx.relu:
            g = torch.where(y > 0, g, 0.0)
        dz = (g * scale.float()).to(a.dtype)
        da = torch.matmul(dz, w.t()).to(a.dtype)
        # dw = a^T dz, formed as (dz^T a)^T: the [N, K] product is
        # contiguous, so the grad reaches an OIHW weight in its layout.
        dw = torch.matmul(dz.t(), a).t().to(w.dtype)
        dbias = g.sum(0).to(bias.dtype)
        z = torch.matmul(a.float(), w.float())
        dscale = (g * z).sum(0).to(scale.dtype)
        return da, dw, dscale, dbias, None


def matmul_bn_relu(a: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, *, relu: bool = True) -> torch.Tensor:
    """``relu((a @ w) * scale + bias)`` with the affine fused into the
    matmul epilogue; differentiable (see module docstring)."""
    return _MMDiff.apply(a, w, scale, bias, relu)


def conv1x1_bn_relu(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, *, relu: bool = True) -> torch.Tensor:
    """Fused NHWC 1x1 conv + BN affine (+ReLU).  x: [B, H, W, Cin];
    w: [Cin, Cout]; scale/bias: [Cout]."""
    b, h, wd, cin = x.shape
    out = matmul_bn_relu(x.reshape(b * h * wd, cin), w, scale, bias,
                         relu=relu)
    return out.view(b, h, wd, w.shape[1])


def conv1x1_bn_relu_reference(x, w, scale, bias, *, relu=True):
    """Oracle: f32 einsum, f32 affine, one cast to x's dtype."""
    y = torch.einsum("bhwc,cd->bhwd", x.float(), w.float())
    y = y * scale.float() + bias.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype)


# ---- kernel #4: matmul + batch-stat partial sums -------------------------


def _mm_stats_plain(a, w):
    """Plain version of ``matmul_batch_stats``: the f32 product, its cast,
    and the per-BLOCK_M-row column sums of z and z² in f32."""
    acc = torch.matmul(a.float(), w.float())
    m, n = acc.shape
    nb = -(-m // BLOCK_M)
    padded = acc.new_zeros((nb * BLOCK_M, n))
    padded[:m] = acc
    tiles = padded.view(nb, BLOCK_M, n)
    return acc.to(a.dtype), tiles.sum(1), (tiles * tiles).sum(1)


def matmul_batch_stats(a: torch.Tensor, w: torch.Tensor):
    """One fused pass: ``z = a @ w`` (written once, in a's dtype) plus
    per-``BLOCK_M``-row partial sums of z and z² (f32
    ``[ceil(M/BLOCK_M), N]``).
    Finish as ``mean = s1.sum(0)/M``, ``var = s2.sum(0)/M - mean²``."""
    m, k, n = _check_shapes(a, w)
    if a.device.type == "cpu":
        return _mm_stats_plain(a, w)
    a, wt = _cuda_operands(a, w, k, n)
    nb = -(-m // BLOCK_M)
    z = torch.empty((m, n), dtype=a.dtype, device=a.device)
    s1 = torch.empty((nb, n), dtype=torch.float32, device=a.device)
    s2 = torch.empty((nb, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        rc = _lib().hvdt_mm_stats(a.data_ptr(), wt.data_ptr(), z.data_ptr(),
                                  s1.data_ptr(), s2.data_ptr(), m, n, k,
                                  int(a.dtype == torch.float16), _stream(a))
    if rc:
        raise RuntimeError(f"hvdt_mm_stats launch failed: CUDA error {rc}")
    matmul_batch_stats.launches += 1
    return z, s1, s2


matmul_batch_stats.launches = 0


def _train_forward(a, w, gamma, beta, eps: float, relu: bool):
    m = a.shape[0]
    z, s1, s2 = matmul_batch_stats(a, w)
    s1t, s2t = s1.sum(0), s2.sum(0)
    mean = s1t / m
    var = torch.clamp_min(s2t / m - mean * mean, 0.0)
    scale = gamma.float() * torch.rsqrt(var + eps)
    bias = beta.float() - mean * scale
    # Normalize from the stored z, in f32.
    y = z.float()
    y.mul_(scale).add_(bias)
    if relu:
        y.clamp_min_(0.0)
    return y.to(a.dtype), mean, var


class _TrainDiff(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, w, gamma, beta, eps, relu):
        y, mean, var = _train_forward(a, w, gamma, beta, eps, relu)
        ctx.eps, ctx.relu = eps, relu
        ctx.save_for_backward(a, w, gamma, beta, mean, var,
                              y if relu else None)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean_ct, dvar_ct):
        """Batch-stat BN backward.  With inv = rsqrt(var+eps) and
        zhat = (z-mean)*inv:  g = dy*1[y>0]; dbeta = sum g;
        dgamma = sum g*zhat; dzhat = g*gamma;
        dz = inv*(dzhat - mean_B(dzhat) - zhat*mean_B(dzhat*zhat));
        da = dz w^T; dw = a^T dz.  Cotangents on the mean/var outputs add
        their direct paths (d mean/d z = 1/M; d var/d z = 2(z-mean)/M)."""
        a, w, gamma, beta, mean, var, y = ctx.saved_tensors
        m = a.shape[0]
        g = dy.float()
        if ctx.relu:
            g = torch.where(y > 0, g, 0.0)
        z = torch.matmul(a.float(), w.float())
        inv = torch.rsqrt(var + ctx.eps)
        zhat = (z - mean) * inv
        dbeta = g.sum(0).to(beta.dtype)
        dgamma = (g * zhat).sum(0).to(gamma.dtype)
        dzhat = g * gamma.float()
        dz = inv * (dzhat - dzhat.mean(0) - zhat * (dzhat * zhat).mean(0))
        if dmean_ct is not None:
            dz = dz + dmean_ct.float() / m
        if dvar_ct is not None:
            dz = dz + dvar_ct.float() * 2.0 * (z - mean) / m
        dz = dz.to(a.dtype)
        da = torch.matmul(dz, w.t()).to(a.dtype)
        dw = torch.matmul(dz.t(), a).t().to(w.dtype)
        return da, dw, dgamma, dbeta, None, None


def conv1x1_bn_train(x: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, *, eps: float = 1e-5,
                     relu: bool = True, axis: Optional[str] = None):
    """Fused NHWC 1x1 conv + train-mode BN (+ReLU): batch statistics come
    from the kernel's partial sums.  Returns ``(y, batch_mean,
    batch_var)`` (biased var, f32) for the caller's running-stat update.
    Differentiable (see module docstring)."""
    if axis is not None:
        raise NotImplementedError(
            "cross-rank SyncBN (axis=) is not ported yet (ROADMAP Queue 1: "
            "the rest of slice 1)")
    b, h, wd, cin = x.shape
    cout = w.shape[1]
    if gamma.shape != (cout,) or beta.shape != (cout,):
        raise ValueError(f"gamma/beta must be [{cout}], got "
                         f"{tuple(gamma.shape)}/{tuple(beta.shape)}")
    y2d, mean, var = _TrainDiff.apply(x.reshape(b * h * wd, cin), w, gamma,
                                      beta, float(eps), relu)
    return y2d.view(b, h, wd, cout), mean, var


def conv1x1_bn_train_reference(x, w, gamma, beta, *, eps=1e-5, relu=True):
    """Train-form oracle, f32 throughout."""
    z = torch.einsum("bhwc,cd->bhwd", x.float(), w.float())
    mean = z.mean(dim=(0, 1, 2))
    var = z.var(dim=(0, 1, 2), unbiased=False)
    y = (z - mean) * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype), mean, var
