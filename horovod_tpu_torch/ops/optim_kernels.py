"""Fused optimizer updates: one pass over each parameter per step.

The PyTorch counterpart of the JAX package's ``ops/optim_kernels.py``.
A stock Adam step is some ten elementwise passes over every parameter
(moment decay, moment update, two bias corrections, sqrt, divide,
scale, apply); these kernels run the whole recurrence in f32 registers
and touch each parameter's bytes once.

Two Triton kernels for Hopper, built at first launch:

* ``_adam_kernel`` (replaces the TPU kernel ``_adam_kernel`` via
  ``_adam_leaf_fused``): Adam/AdamW — ``m, v`` update, bias-corrected
  ``u``, additive weight decay, ``delta = -lr * u``;
* ``_sgd_kernel`` (replaces ``_sgd_kernel`` via ``_sgd_leaf_fused``):
  the momentum/nesterov trace, ``delta = -lr * u``.

What bounds them on the card: bytes.  Both are elementwise f32 passes
with no reuse and a few flops per byte, far below the tensor cores'
line; an SGD-momentum step over ResNet-50's 25.56 M f32 parameters must
move about 20 B per parameter (read p, g, m; write p, m), 511 MB or
0.15 ms at 3.35 TB/s, and Adam about 28 B per parameter.  The design
answers that by reading each operand once with masked, contiguous
1024-element blocks (16-byte accesses per thread), keeping all
arithmetic in registers, updating the moments in place, and — in the
optimizers — applying ``p += delta`` in the same pass (fusing
``optax.apply_updates``; the plain versions do the same), so no delta
tensor is written and read back.  One launch per parameter for now.

The scalars follow the JAX package exactly: lr comes from the
pre-increment step count, the bias corrections from the incremented
count, ``eps_root`` sits inside the sqrt and ``eps`` outside it, weight
decay is additive; the kernels use IEEE-rounded sqrt and division and
no fused multiply-add, so they round as the plain versions do.

Each wrapper takes the plain PyTorch version for tensors on the CPU, or
when the caller passes ``use_kernels=False``; on a CUDA tensor it
launches its kernel or raises.  ``launches`` on each wrapper counts
kernel launches.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import torch

__all__ = ["fused_adam", "fused_sgd", "fused_update_eligible",
           "sgd_leaf_update", "adam_leaf_update", "FusedAdam", "FusedSGD"]

_BLOCK = 1024      # elements per program: 8 per thread at 4 warps
_NUM_WARPS = 4
_kernels: dict = {}


def fused_update_eligible(leaf: torch.Tensor, *extra_dtypes) -> bool:
    """True when ``leaf`` can take the fused kernel: a non-empty floating
    tensor of 2 bytes or more, with ``extra_dtypes`` (the moments') the
    same kind.  The TPU's 128-lane and sublane tiling floors do not
    apply on the card."""
    for d in (leaf.dtype, *extra_dtypes):
        if not d.is_floating_point or d.itemsize < 2:
            return False
    return leaf.numel() > 0


def _triton_kernels() -> dict:
    """Compile-on-first-use Triton kernels (triton is imported here, not
    at module import: it exists only where there is a card)."""
    if _kernels:
        return _kernels
    global triton, tl
    import triton
    import triton.language as tl

    @triton.jit
    def _sgd_kernel(g_ptr, m_ptr, p_ptr, d_ptr, n, lr, momentum,
                    NESTEROV: tl.constexpr, APPLY: tl.constexpr,
                    BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        g = tl.load(g_ptr + offs, mask=mask).to(tl.float32)
        m = g + momentum * tl.load(m_ptr + offs, mask=mask).to(tl.float32)
        if NESTEROV:
            u = g + momentum * m
        else:
            u = m
        tl.store(m_ptr + offs, m.to(m_ptr.dtype.element_ty), mask=mask)
        if APPLY:
            p = tl.load(p_ptr + offs, mask=mask)
            d = (-lr * u).to(p.dtype)
            tl.store(p_ptr + offs,
                     (p.to(tl.float32) + d.to(tl.float32)).to(p.dtype),
                     mask=mask)
        else:
            tl.store(d_ptr + offs, (-lr * u).to(d_ptr.dtype.element_ty),
                     mask=mask)

    @triton.jit
    def _adam_kernel(p_ptr, g_ptr, m_ptr, v_ptr, d_ptr, n, lr, bc1, bc2,
                     b1, one_minus_b1, b2, one_minus_b2, eps, eps_root, wd,
                     WD: tl.constexpr, APPLY: tl.constexpr,
                     BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        g = tl.load(g_ptr + offs, mask=mask).to(tl.float32)
        m = b1 * tl.load(m_ptr + offs, mask=mask).to(tl.float32) \
            + one_minus_b1 * g
        v = b2 * tl.load(v_ptr + offs, mask=mask).to(tl.float32) \
            + one_minus_b2 * (g * g)
        u = tl.div_rn(m * bc1, tl.sqrt_rn(v * bc2 + eps_root) + eps)
        if WD or APPLY:
            p = tl.load(p_ptr + offs, mask=mask)
            if WD:
                u = u + wd * p.to(tl.float32)
        tl.store(m_ptr + offs, m.to(m_ptr.dtype.element_ty), mask=mask)
        tl.store(v_ptr + offs, v.to(v_ptr.dtype.element_ty), mask=mask)
        if APPLY:
            d = (-lr * u).to(p.dtype)
            tl.store(p_ptr + offs,
                     (p.to(tl.float32) + d.to(tl.float32)).to(p.dtype),
                     mask=mask)
        else:
            tl.store(d_ptr + offs, (-lr * u).to(d_ptr.dtype.element_ty),
                     mask=mask)

    _kernels.update(sgd=_sgd_kernel, adam=_adam_kernel, cdiv=triton.cdiv)
    return _kernels


def _same_layout(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same shape and the same element order in memory (strides agree on
    every dimension longer than 1)."""
    return a.shape == b.shape and all(
        sa == sb for sa, sb, n in zip(a.stride(), b.stride(), a.shape)
        if n > 1)


def _in_layout_of(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``g`` with ``p``'s memory layout (a copy only when they differ)."""
    return g if _same_layout(g, p) else torch.empty_like(p).copy_(g)


def _check_cuda_leaf(*ts: torch.Tensor) -> None:
    """The kernels walk every operand as one flat, dense buffer in the
    same element order: same device, shape and layout, and dense."""
    ref = ts[0]
    if ref.device.type != "cuda":
        raise ValueError(f"fused optimizer kernels run on CUDA, got "
                         f"{ref.device}")
    if not fused_update_eligible(ref, *(t.dtype for t in ts[1:])):
        raise TypeError("fused optimizer kernels take non-empty floating "
                        "tensors of 2 bytes or more, got "
                        f"{[t.dtype for t in ts]}")
    for t in ts:
        if t.device != ref.device or not _same_layout(t, ref):
            raise ValueError("fused optimizer operands must share device, "
                             "shape and memory layout")
    if not (ref.is_contiguous()
            or ref.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError("fused optimizer operands must be dense")


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


# ---- SGD (momentum) ------------------------------------------------------


def _sgd_leaf_plain(g, m, lr: float, *, momentum: float, nesterov: bool,
                    p: Optional[torch.Tensor] = None):
    """Plain version of ``_sgd_leaf_fused``: the same f32 formulas; m is
    updated in place; with ``p`` the delta is applied to it in place."""
    g32 = g.float()
    m_new = g32 + momentum * m.float()
    u = g32 + momentum * m_new if nesterov else m_new
    m.copy_(m_new)
    if p is not None:
        p.add_((-lr * u).to(p.dtype))
        return None, m
    return (-lr * u).to(g.dtype), m


def _sgd_leaf_fused(g, m, lr: float, *, momentum: float, nesterov: bool,
                    p: Optional[torch.Tensor] = None):
    """One launch of ``_sgd_kernel`` over a leaf: returns ``(delta, m)``,
    or ``(None, m)`` after applying the delta to ``p`` in place."""
    _check_cuda_leaf(g, m, *(() if p is None else (p,)))
    k = _triton_kernels()
    n = g.numel()
    d = torch.empty_like(g) if p is None else None
    with torch.cuda.device(g.device):
        k["sgd"][(k["cdiv"](n, _BLOCK),)](
            g, m, g if p is None else p, g if d is None else d, n,
            float(lr), float(momentum), NESTEROV=bool(nesterov),
            APPLY=p is not None, BLOCK=_BLOCK, num_warps=_NUM_WARPS,
            enable_fp_fusion=False)
    _sgd_leaf_fused.launches += 1
    return d, m


_sgd_leaf_fused.launches = 0


def _sgd_leaf(g, m, lr, *, momentum, nesterov, use_kernels, p=None):
    if g.numel() == 0 or _on_cpu(g) or not use_kernels:
        return _sgd_leaf_plain(g, m, lr, momentum=momentum,
                               nesterov=nesterov, p=p)
    return _sgd_leaf_fused(g, m, lr, momentum=momentum, nesterov=nesterov,
                           p=p)


def sgd_leaf_update(g: torch.Tensor, m: torch.Tensor,
                    scalars: Sequence[float], *, momentum: float,
                    nesterov: bool = False, use_kernels: bool = True):
    """Per-leaf SGD-momentum update ``(delta, new_trace)``; ``scalars``
    is ``[lr]``.  The trace ``m`` is updated in place and returned."""
    return _sgd_leaf(g, m, float(scalars[0]), momentum=momentum,
                     nesterov=nesterov, use_kernels=use_kernels)


class FusedSGD(torch.optim.Optimizer):
    """``optax.sgd`` semantics as a ``torch.optim.Optimizer``: with
    ``momentum`` each parameter takes one ``_sgd_kernel`` pass per step
    (trace update and apply); without it there is no state and the step
    is one plain scale-and-add, as in the JAX package.  State per
    parameter: ``{"trace": m}``, zeros from construction (optax's
    ``TraceState``)."""

    def __init__(self, params, learning_rate: float, momentum: float = 0.0,
                 nesterov: bool = False, *, use_kernels: bool = True):
        if callable(learning_rate):
            raise ValueError(
                "fused_sgd takes a float learning_rate (its state carries "
                "no step count for a schedule); use fused_adam for "
                "schedule support")
        super().__init__(params, dict(lr=float(learning_rate),
                                      momentum=float(momentum),
                                      nesterov=bool(nesterov)))
        self.use_kernels = use_kernels
        for group in self.param_groups:
            if group["momentum"]:
                for p in group["params"]:
                    self.state[p]["trace"] = torch.zeros_like(p)

    @torch.no_grad()
    def step(self, closure: Optional[Callable[[], Any]] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, mom = group["lr"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                if not mom:
                    p.add_((-lr * p.grad.float()).to(p.dtype))
                    continue
                _sgd_leaf(_in_layout_of(p.grad, p), self.state[p]["trace"],
                          lr, momentum=mom,
                          nesterov=group["nesterov"],
                          use_kernels=self.use_kernels, p=p)
        return loss


def fused_sgd(params, learning_rate: float, momentum: float = 0.0,
              nesterov: bool = False, *, use_kernels: bool = True
              ) -> FusedSGD:
    """``optax.sgd`` drop-in over ``params`` (see :class:`FusedSGD`)."""
    return FusedSGD(params, learning_rate, momentum, nesterov,
                    use_kernels=use_kernels)


# ---- Adam ----------------------------------------------------------------


def _adam_scalars(count: int, learning_rate, b1: float, b2: float):
    """``[lr, 1/(1-b1^t), 1/(1-b2^t)]`` in f32: lr at the pre-increment
    count, the bias corrections at the incremented count t."""
    f32 = np.float32
    lr = learning_rate(count) if callable(learning_rate) else learning_rate
    t = f32(count + 1)
    one = f32(1.0)
    return [float(f32(lr)),
            float(one / (one - np.power(f32(b1), t))),
            float(one / (one - np.power(f32(b2), t)))]


def _adam_leaf_plain(p, g, m, v, scalars, *, b1, b2, eps, eps_root, wd,
                     apply: bool):
    """Plain version of ``_adam_leaf_fused``: the same f32 formulas; m, v
    updated in place; with ``apply`` the delta goes into p in place."""
    lr, bc1, bc2 = scalars
    g32 = g.float()
    m_new = b1 * m.float() + (1.0 - b1) * g32
    v_new = b2 * v.float() + (1.0 - b2) * (g32 * g32)
    u = (m_new * bc1) / (torch.sqrt(v_new * bc2 + eps_root) + eps)
    if wd:
        u = u + wd * p.float()
    m.copy_(m_new)
    v.copy_(v_new)
    if apply:
        p.add_((-lr * u).to(p.dtype))
        return None, m, v
    return (-lr * u).to(p.dtype), m, v


def _adam_leaf_fused(p, g, m, v, scalars, *, b1, b2, eps, eps_root, wd,
                     apply: bool):
    """One launch of ``_adam_kernel`` over a leaf: returns ``(delta, m,
    v)``, or ``(None, m, v)`` after applying the delta to p in place."""
    _check_cuda_leaf(p, g, m, v)
    k = _triton_kernels()
    n = g.numel()
    d = None if apply else torch.empty_like(p)
    lr, bc1, bc2 = scalars
    with torch.cuda.device(g.device):
        k["adam"][(k["cdiv"](n, _BLOCK),)](
            p, g, m, v, p if d is None else d, n, float(lr), float(bc1),
            float(bc2), float(b1), 1.0 - b1, float(b2), 1.0 - b2, float(eps),
            float(eps_root), float(wd), WD=bool(wd), APPLY=apply,
            BLOCK=_BLOCK, num_warps=_NUM_WARPS, enable_fp_fusion=False)
    _adam_leaf_fused.launches += 1
    return d, m, v


_adam_leaf_fused.launches = 0


def _adam_leaf(p, g, m, v, scalars, *, b1, b2, eps, eps_root, wd,
               use_kernels, apply):
    fn = (_adam_leaf_plain if g.numel() == 0 or _on_cpu(g)
          or not use_kernels else _adam_leaf_fused)
    return fn(p, g, m, v, scalars, b1=b1, b2=b2, eps=eps, eps_root=eps_root,
              wd=wd, apply=apply)


def adam_leaf_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                     v: torch.Tensor, scalars: Sequence[float], *,
                     b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                     eps_root: float = 0.0, weight_decay: float = 0.0,
                     use_kernels: bool = True):
    """Per-leaf Adam update ``(delta, m_new, v_new)``; ``scalars`` is
    ``[lr, 1/(1-b1^t), 1/(1-b2^t)]``.  m and v are updated in place."""
    return _adam_leaf(p, g, m, v, [float(s) for s in scalars], b1=b1, b2=b2,
                      eps=eps, eps_root=eps_root, wd=weight_decay,
                      use_kernels=use_kernels, apply=False)


class FusedAdam(torch.optim.Optimizer):
    """``optax.adam``/``adamw`` semantics as a ``torch.optim.Optimizer``:
    each parameter takes one ``_adam_kernel`` pass per step (moments,
    bias correction, decay and apply).  ``learning_rate`` may be a float
    or a schedule ``count -> lr``, evaluated at the pre-increment count.
    State per parameter: ``{"mu", "nu"}``, zeros from construction; the
    step count (optax's ``ScaleByAdamState.count``) is ``group["count"]``.
    """

    def __init__(self, params, learning_rate: Union[float, Callable],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0, *, weight_decay: float = 0.0,
                 mu_dtype: Optional[torch.dtype] = None,
                 use_kernels: bool = True):
        super().__init__(params, dict(
            learning_rate=learning_rate, b1=float(b1), b2=float(b2),
            eps=float(eps), eps_root=float(eps_root),
            weight_decay=float(weight_decay), count=0))
        self.use_kernels = use_kernels
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["mu"] = torch.zeros_like(
                    p, dtype=mu_dtype or p.dtype)
                self.state[p]["nu"] = torch.zeros_like(p)

    @torch.no_grad()
    def step(self, closure: Optional[Callable[[], Any]] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            scalars = _adam_scalars(group["count"], group["learning_rate"],
                                    group["b1"], group["b2"])
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                _adam_leaf(p, _in_layout_of(p.grad, p), st["mu"], st["nu"],
                           scalars,
                           b1=group["b1"], b2=group["b2"], eps=group["eps"],
                           eps_root=group["eps_root"],
                           wd=group["weight_decay"],
                           use_kernels=self.use_kernels, apply=True)
            group["count"] += 1
        return loss


def fused_adam(params, learning_rate: Union[float, Callable],
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               eps_root: float = 0.0, *, weight_decay: float = 0.0,
               mu_dtype: Optional[torch.dtype] = None,
               use_kernels: bool = True) -> FusedAdam:
    """``optax.adam``/``adamw`` drop-in over ``params`` (see
    :class:`FusedAdam`)."""
    return FusedAdam(params, learning_rate, b1, b2, eps, eps_root,
                     weight_decay=weight_decay, mu_dtype=mu_dtype,
                     use_kernels=use_kernels)
