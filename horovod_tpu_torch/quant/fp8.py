"""Per-tensor-scaled fp8 (e4m3) matmul: the low-precision compute leg.

The PyTorch counterpart of the JAX package's ``quant/fp8.py``.  Both
operands of ``x @ w`` are scaled into ``torch.float8_e4m3fn`` per tensor
and multiplied with f32 accumulation:

* on a CUDA tensor by ``torch._scaled_mm`` (cuBLASLt's e4m3 GEMM with
  tensor-wise f32 scales, output in ``x``'s dtype).  The reference
  computes this product with XLA, outside any Pallas kernel, so the
  library call is its counterpart; no hand-written kernel is owed;
* on a CPU tensor by its plain version, ``(qx.float() @ qw.float()) *
  (sx * sw)`` cast to ``x``'s dtype.

Scaling is the reference's: ``scale = amax * (1/448)`` (a multiply by
the rounded reciprocal), 1 where amax is 0; each operand is divided by
its scale, clipped to [-448, 448] and cast to e4m3 (no inf; 448 is the
largest finite value).  Two ways to supply amax: the operand's own
``max|x|`` (default) or the rolling history of
:class:`Fp8AmaxState` (:func:`fp8_matmul_delayed`, Transformer Engine's
delayed scaling).

The backward is the straight-through gradient of the dequantized
product ``(qx*sx) @ (qw*sw)``: ``dx = (dY @ qw^T) * sw`` and ``dw =
(qx^T @ dY) * sx``, each times its operand's clip mask (1 inside, 0
outside, 1/2 on exactly +-448, where the reference's ``clip`` splits the
tie), computed and kept in f32.  The reference instead rounds its
backward cotangents to e4m3 (JAX transposes an f8 ``dot_general`` into
an f8 cotangent), so at typical cotangent scales its ``dx`` and ``dw``
flush to zero; the port does not copy that (ROADMAP, "Reference
caveats").  On the card the backward products take ``dY`` as it comes
(bf16 or fp16, into which every e4m3 value converts exactly) with an
f32 result.

Gate: ``HVDT_FP8=off|matmul`` (:func:`matmul_enabled`), read by the
transformer's projections.  :func:`fp8_available` is true when the dtype
exists and, on a machine with a card, the card is sm_89 or newer and a
tiny ``_scaled_mm`` runs; a probe that fails on such a card raises, it
never turns the gate into a silent ``x @ w``.  Where the dtype or the
card's support is absent the gate is off and the projection is the plain
matmul, the reference's identity.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..common import config
from ..common.basics import DeviceLike, resolve_device

__all__ = [
    "E4M3_MAX",
    "fp8_available",
    "fp8_mode",
    "matmul_enabled",
    "fp8_matmul",
    "Fp8AmaxState",
    "init_amax_state",
    "fp8_matmul_delayed",
]

# Max finite |value| of float8_e4m3fn (no inf encoding).
E4M3_MAX = 448.0

_FP8_MODES = ("off", "matmul")

_probe_result: Optional[bool] = None


def _fp8_dtype():
    return getattr(torch, "float8_e4m3fn", None)


def fp8_available() -> bool:
    """True when ``float8_e4m3fn`` exists and, on a machine with a CUDA
    card, the card runs e4m3 GEMMs (sm_89 or newer, and a 16x16
    ``_scaled_mm`` probe succeeds; probed once a process).  Without a
    card the plain version computes the product, so the dtype suffices.
    Raises when the probe fails on a card that should run it."""
    global _probe_result
    if _probe_result is None:
        dt = _fp8_dtype()
        if dt is None:
            _probe_result = False
        elif not torch.cuda.is_available():
            _probe_result = True
        elif torch.cuda.get_device_capability() < (8, 9):
            _probe_result = False
        else:
            try:
                a = torch.ones((16, 16), device="cuda").to(dt)
                one = torch.ones((), device="cuda")
                torch._scaled_mm(a, a.t(), scale_a=one, scale_b=one,
                                 out_dtype=torch.bfloat16)
                torch.cuda.synchronize()
            except Exception as e:
                cap = torch.cuda.get_device_capability()
                raise RuntimeError(
                    f"the fp8 probe (torch._scaled_mm on e4m3) failed on "
                    f"{torch.cuda.get_device_name()} (sm_{cap[0]}{cap[1]}),"
                    " which should run it") from e
            _probe_result = True
    return _probe_result


def fp8_mode() -> str:
    """The validated ``HVDT_FP8`` value."""
    mode = (config.get_str("HVDT_FP8") or "off").lower()
    if mode not in _FP8_MODES:
        raise ValueError(
            f"unknown HVDT_FP8 mode {mode!r}; valid: "
            f"{', '.join(_FP8_MODES)}")
    return mode


def matmul_enabled() -> bool:
    """True when matmuls should ride the fp8 path: ``HVDT_FP8=matmul``
    and :func:`fp8_available`."""
    return fp8_mode() == "matmul" and fp8_available()


def _scale_for(amax: torch.Tensor) -> torch.Tensor:
    """Per-tensor scale mapping ``[-amax, amax]`` onto the e4m3 range;
    all-zero tensors get scale 1 (q = 0 exactly, no 0/0)."""
    amax = torch.clamp_min(torch.as_tensor(amax).float(), 0.0)
    inv = torch.tensor(1.0 / E4M3_MAX, dtype=torch.float32,
                       device=amax.device)
    return torch.where(amax > 0, amax * inv, torch.ones_like(amax))


def _cast_e4m3(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    # Clip before the convert: values past +-448 would otherwise land on
    # e4m3 NaN (no inf encoding).
    y = x.to(torch.float32, copy=True).div_(scale)
    return y.clamp_(-E4M3_MAX, E4M3_MAX).to(_fp8_dtype())


def _cast_and_mask(x: torch.Tensor, scale: torch.Tensor,
                   mask_dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(_cast_e4m3(x, scale), d clip / d y)``: the mask is 1 where
    ``|x/scale| < 448``, 1/2 where it is exactly 448 (``clip``'s tie)
    and 0 where the clip was active; ``mask_dtype`` holds those three
    values exactly (float32 or bfloat16)."""
    y = x.to(torch.float32, copy=True).div_(scale)
    a = y.abs()
    one = torch.ones((), dtype=mask_dtype, device=x.device)
    mask = torch.where(a < E4M3_MAX, one,
                       torch.where(a == E4M3_MAX, one * 0.5, one * 0.0))
    return y.clamp_(-E4M3_MAX, E4M3_MAX).to(_fp8_dtype()), mask


def _amax(t: torch.Tensor) -> torch.Tensor:
    """``max|t|`` in ``t``'s dtype, no gradient (one pass)."""
    return torch.linalg.vector_norm(t.detach(), float("inf"))


def _check_cuda_operands(k: int, n: int) -> None:
    if not fp8_available():
        raise RuntimeError(
            "fp8_matmul on a CUDA tensor needs an sm_89+ card and "
            "torch.float8_e4m3fn; this card has no e4m3 GEMM")
    if k % 16 or n % 16:
        raise ValueError(
            f"fp8_matmul on the card needs K and N multiples of 16 "
            f"(torch._scaled_mm), got K={k}, N={n}")


def _mm_f32(a: torch.Tensor, b: torch.Tensor,
            like: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an f32 result.  For a 16-bit CUDA cotangent
    ``like`` both operands take its dtype (each e4m3 value converts
    exactly) and cuBLAS accumulates and returns f32; everything else is
    multiplied in f32."""
    if like.is_cuda and like.dtype in (torch.bfloat16, torch.float16):
        return torch.mm(a.to(like.dtype), b.to(like.dtype),
                        out_dtype=torch.float32)
    return a.float() @ b.float()


class _Fp8Matmul(torch.autograd.Function):
    """``[m, k] @ [k, n]`` through e4m3 with the straight-through f32
    backward (see the module docstring).  The forward keeps the e4m3
    operands and their clip masks (bf16: 0, 1/2 and 1 are exact) for the
    backward."""

    @staticmethod
    def forward(ctx, x2, w, sx, sw):
        if any(ctx.needs_input_grad[:2]):
            qx, mx = _cast_and_mask(x2, sx, torch.bfloat16)
            qw, mw = _cast_and_mask(w, sw, torch.bfloat16)
            ctx.save_for_backward(qx, qw, mx, mw, sx, sw)
            ctx.dtypes = (x2.dtype, w.dtype)
        else:
            qx, qw = _cast_e4m3(x2, sx), _cast_e4m3(w, sw)
        if x2.is_cuda:
            _check_cuda_operands(x2.shape[1], w.shape[1])
            return torch._scaled_mm(qx, qw.t().contiguous().t(),
                                    scale_a=sx.reshape(()),
                                    scale_b=sw.reshape(()),
                                    out_dtype=x2.dtype)
        return ((qx.float() @ qw.float()) * (sx * sw)).to(x2.dtype)

    @staticmethod
    def backward(ctx, g):
        qx, qw, mx, mw, sx, sw = ctx.saved_tensors
        x_dtype, w_dtype = ctx.dtypes
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (_mm_f32(g, qw.t(), g) * sw * mx).to(x_dtype)
        if ctx.needs_input_grad[1]:
            dw = (_mm_f32(qx.t(), g, g) * sx * mw).to(w_dtype)
        return dx, dw, None, None


def fp8_matmul(x: torch.Tensor, w: torch.Tensor,
               amax_x: Optional[torch.Tensor] = None,
               amax_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w`` with both operands per-tensor-scaled into e4m3 and f32
    accumulation; result in ``x``'s dtype.  ``x`` is ``[..., k]``, ``w``
    is ``[k, n]`` (the transformer projection shape).

    ``amax_x`` / ``amax_w`` override the current-max statistics (the
    delayed-scaling hook); by default each operand's own ``max|.|``
    (no gradient) is used.  On a CUDA tensor this is ``torch._scaled_mm``
    or it raises (no card support, K or N not a multiple of 16); on a
    CPU tensor, the plain version."""
    if _fp8_dtype() is None:
        return x @ w.to(x.dtype)
    if amax_x is None:
        amax_x = _amax(x)
    if amax_w is None:
        amax_w = _amax(w)
    sx = _scale_for(amax_x.detach())
    sw = _scale_for(amax_w.detach())
    k = x.shape[-1]
    out = _Fp8Matmul.apply(x.reshape(-1, k), w, sx, sw)
    return out.reshape(*x.shape[:-1], w.shape[-1])


class Fp8AmaxState(NamedTuple):
    """Delayed-max scaling state for one matmul site: the rolling amax
    history of each operand (f32 ``[history]``, newest last)."""
    x: torch.Tensor
    w: torch.Tensor


def init_amax_state(history: int = 16,
                    device: DeviceLike = None) -> Fp8AmaxState:
    """Fresh all-zero history (zero amax gives scale 1 on step 0; real
    statistics take over as the history fills), on the card unless
    ``device`` names another."""
    dev = resolve_device(device)
    return Fp8AmaxState(x=torch.zeros(history, device=dev),
                        w=torch.zeros(history, device=dev))


def fp8_matmul_delayed(x: torch.Tensor, w: torch.Tensor,
                       state: Fp8AmaxState
                       ) -> Tuple[torch.Tensor, Fp8AmaxState]:
    """``x @ w`` scaled by the max of the history and this step's amax
    (never a stale zero on the first step, never more than one step
    behind after it), and the state rolled forward with this step's
    observed amaxes.  Functional: thread the state like optimizer
    state."""
    if _fp8_dtype() is None:
        return x @ w.to(x.dtype), state
    ax = _amax(x).float()
    aw = _amax(w).float()
    out = fp8_matmul(x, w, amax_x=torch.maximum(state.x.max(), ax),
                     amax_w=torch.maximum(state.w.max(), aw))
    new = Fp8AmaxState(x=torch.cat([state.x[1:], ax[None]]),
                       w=torch.cat([state.w[1:], aw[None]]))
    return out, new
