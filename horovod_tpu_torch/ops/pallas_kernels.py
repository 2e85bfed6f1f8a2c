"""Flash attention: the streaming forward and its two backward passes,
and the whole-sequence ("smallseq") forward and backward.

The PyTorch counterpart of the JAX package's ``ops/pallas_kernels.py``
(the module keeps its name so the two are found side by side).  The
naive einsum materializes the [B, H, Lq, Lk] score matrix in device
memory; the flash kernels stream K/V blocks past a resident Q block with
an online softmax, so memory traffic is O(L·D) instead of O(L²).

Five kernels, written in CUDA C++ for Hopper (each source's header says
what bounds its kernels and how the design answers it), each beside its
plain PyTorch version.  In ``csrc/flash_attn.cu``:

* ``_flash_fwd`` (replaces ``_kernel``, via ``_flash_call``) — #9: the
  online-softmax forward with an ``(acc, m, l)`` carry in and out, causal
  mask from global ``q_offset``/``k_offset``, causal block pruning, GQA
  through ``kv head = h // group``; ``finish=True`` starts the carry at
  ``(0, -1e30, 0)`` and returns ``(acc / l, m + log l)`` from the same
  launch, as ``_flash_fwd_core`` does around the TPU kernel;
* ``_flash_dq`` (replaces ``_dq_kernel``) — #10: dQ from the saved
  logsumexp and ``delta = rowsum(dO * O)``;
* ``_flash_dkv`` (replaces ``_dkv_kernel``) — #11: dK, dV per q-head in
  f32 (``flash_grad_block`` sums a GQA group afterwards).

In ``csrc/flash_smallseq.cu``, for sequences that fit one block (the
short-sequence regime of BERT-style pretraining):

* ``_smallseq_fwd`` (replaces ``_smallseq_fwd_kernel``) — #12:
  softmax(q kᵀ · scale) v and the logsumexp against each row's exact max,
  with no online carry;
* ``_smallseq_bwd`` (replaces ``_smallseq_bwd_kernel``) — #13: dq, dk, dv
  in the input dtype from the saved logsumexp, ``delta = rowsum(dO * O)``
  computed once per q row and a GQA group's dk/dv summed inside; one call
  makes two launches (dQ, which writes delta, then dK/dV), on the
  backward bodies that #10 and #11 run.

Entry points, with the reference's signatures and [B, L, H, D] layouts:
:func:`flash_attention` (differentiable), :func:`flash_block_update` (one
ring step on the carry), :func:`flash_grad_block` (the kernel backward of
one Q x K/V block pair), :func:`flash_attention_smallseq`
(differentiable, through #12 and #13) and :func:`attention_reference`
(the oracle).

A ``torch.autograd.Function`` takes the place of the reference's
``custom_vjp``.  Its backward reads ``HVDT_FLASH_BWD`` when it runs:
``kernel`` (or ``pallas``) goes through :func:`flash_grad_block`; the
default ``xla`` is the blockwise recompute of the reference's XLA branch,
ported as plain PyTorch (:func:`_flash_attn_bwd_blockwise`).

Each kernel wrapper takes its plain version only for a tensor on the
CPU; on a CUDA tensor it launches the kernel or raises (``ValueError``
for a dtype other than bf16/fp16 or a head dim other than 64/128).
``block_q``/``block_k`` (and ``heads_per_block`` for #12/#13) shape the
plain versions' loops, which follow the TPU kernels' block order and
pruning; the CUDA kernels tile at their own sizes (all on the wgmma +
TMA core of ``csrc/flash_sm90.cuh``: 192 q rows a CTA for #9 and for #10
at D 64, 128 k rows for #11, 64 q rows for #12, 64 q and 64 k rows for
#13's two launches at D 64).  ``launches`` on each wrapper counts its
calls that launched its kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..common import config

__all__ = ["flash_attention", "flash_attention_smallseq",
           "flash_block_update", "flash_grad_block",
           "attention_reference"]

_NEG_INF = -1e30
_KERNEL_DTYPES = {torch.bfloat16: 0, torch.float16: 1}
_KERNEL_HEAD_DIMS = (64, 128)
_Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _fit_block(n: int, block: int) -> int:
    """Largest power-of-2 reduction of ``block`` that divides ``n`` (the
    reference's clamp, without its TPU sublane floor: on the card the
    kernels tile at their own size and mask a ragged edge)."""
    fitted = min(block, n)
    while fitted > 1 and n % fitted:
        fitted //= 2
    return max(fitted, 1)


def _lib() -> ctypes.CDLL:
    from .._build import load_library

    lib = load_library("flash_attn")
    if not getattr(lib, "_hvdt_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # B, H, Hkv, Lq, Lk, D, fp16, q_offset, k_offset, causal; scale;
        # stream.
        tail = [i] * 10 + [f, p]
        lib.hvdt_flash_fwd.argtypes = [p] * 11 + tail
        lib.hvdt_flash_dq.argtypes = [p] * 7 + tail
        lib.hvdt_flash_dkv.argtypes = [p] * 8 + tail
        for fn in (lib.hvdt_flash_fwd, lib.hvdt_flash_dq, lib.hvdt_flash_dkv):
            fn.restype = i
        lib._hvdt_typed = True
    return lib


def _smallseq_lib() -> ctypes.CDLL:
    from .._build import load_library

    lib = load_library("flash_smallseq")
    if not getattr(lib, "_hvdt_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # B, H, Hkv, L, D, fp16, causal; scale; stream.
        tail = [i] * 7 + [f, p]
        lib.hvdt_smallseq_fwd.argtypes = [p] * 5 + tail
        lib.hvdt_smallseq_bwd.argtypes = [p] * 10 + tail
        lib.hvdt_smallseq_fwd.restype = i
        lib.hvdt_smallseq_bwd.restype = i
        lib._hvdt_typed = True
    return lib


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _cuda_operands(q, k, v, *more):
    """Validate the kernel operands (all in the model dtype, [B, L, H, D]
    and [B, L, Hkv, D]); returns them contiguous."""
    ts = (q, k, v, *more)
    if any(t.device != q.device for t in ts):
        raise ValueError("flash kernel operands must share one device")
    if q.dtype not in _KERNEL_DTYPES or any(t.dtype != q.dtype for t in ts):
        raise ValueError("the flash kernels take bf16 or fp16 operands of "
                         f"one dtype, got {[t.dtype for t in ts]}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q [B, Lq, H, D] and k/v [B, Lk, Hkv, D] expected, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash kernels take head dim 64 or 128, got {d}")
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (batch, head dim, GQA group)")
    ts = tuple(t.contiguous() for t in ts)
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("flash kernel operands must be 16-byte aligned")
    return ts


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_rc(rc: int, name: str) -> None:
    if rc:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _seq_mask(q0: int, n_q: int, k0: int, n_k: int, device) -> torch.Tensor:
    """``[n_q, n_k]`` causal mask of global positions: q >= k."""
    qp = q0 + torch.arange(n_q, device=device)
    kp = k0 + torch.arange(n_k, device=device)
    return qp[:, None] >= kp[None, :]


def _heads(x: torch.Tensor, group: int) -> torch.Tensor:
    """[B, L, Hkv, D] → [B, H, L, D], each kv head serving its group."""
    x = x.transpose(1, 2)
    return x.repeat_interleave(group, dim=1) if group > 1 else x


def _visible(causal: bool, q_offset: int, k_offset: int, iq: int, bq: int,
             ik: int, bk: int) -> bool:
    """The TPU kernels' causal block pruning: some row of q block ``iq``
    reaches k block ``ik``."""
    return (not causal) or q_offset + iq * bq + bq - 1 >= k_offset + ik * bk


# ---- kernel #9: forward ---------------------------------------------------


def _flash_fwd_plain(q, k, v, carry: Optional[_Carry], q_offset: int,
                     k_offset: int, *, causal: bool, scale: float,
                     block_q: int, block_k: int, finish: bool):
    """Plain version of ``_flash_fwd``: the TPU kernel's grid walked in
    its order — q blocks of ``block_q``, and within each the k blocks of
    ``block_k`` it can see — with the same online-softmax update in f32
    and P rounded to V's dtype before the PV product."""
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    qt = q.transpose(1, 2)
    kt, vt = _heads(k, h // hkv), _heads(v, h // hkv)
    if carry is None:
        acc = q.new_zeros((b, h, lq, d), dtype=torch.float32)
        m = q.new_full((b, h, lq, 1), _NEG_INF, dtype=torch.float32)
        l = q.new_zeros((b, h, lq, 1), dtype=torch.float32)
    else:
        acc = carry[0].transpose(1, 2).float().clone()
        m = carry[1][..., None].float().clone()
        l = carry[2][..., None].float().clone()
    for iq in range(lq // block_q):
        rows = slice(iq * block_q, (iq + 1) * block_q)
        qb = qt[:, :, rows].float()
        a_b, m_b, l_b = acc[:, :, rows], m[:, :, rows], l[:, :, rows]
        for ik in range(lk // block_k):
            if not _visible(causal, q_offset, k_offset, iq, block_q, ik,
                            block_k):
                continue
            cols = slice(ik * block_k, (ik + 1) * block_k)
            s = qb @ kt[:, :, cols].float().transpose(-1, -2) * scale
            if causal:
                mask = _seq_mask(q_offset + iq * block_q, block_q,
                                 k_offset + ik * block_k, block_k, q.device)
                s = torch.where(mask, s, _NEG_INF)
            m_new = torch.maximum(m_b, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            if causal:
                p = torch.where(mask, p, 0.0)
            corr = torch.exp(m_b - m_new)
            vb = vt[:, :, cols]
            a_b.mul_(corr).add_(p.to(vb.dtype).float() @ vb.float())
            l_b.mul_(corr).add_(p.sum(-1, keepdim=True))
            m_b.copy_(m_new)
    if finish:
        l = torch.clamp_min(l, 1e-30)
        return ((acc / l).transpose(1, 2).to(q.dtype),
                (m + torch.log(l))[..., 0])
    return acc.transpose(1, 2), m[..., 0], l[..., 0]


def _flash_fwd(q, k, v, carry: Optional[_Carry], q_offset: int,
               k_offset: int, *, causal: bool, scale: float, block_q: int,
               block_k: int, finish: bool):
    """One online-softmax pass of q [B, Lq, H, D] over k/v [B, Lk, Hkv, D].

    ``carry`` is ``(acc [B, Lq, H, D], m [B, H, Lq], l [B, H, Lq])`` f32
    or None (start at ``(0, -1e30, 0)``).  Returns the new carry, or with
    ``finish`` the output ``acc / max(l, 1e-30)`` in q's dtype and the
    logsumexp ``m + log l`` [B, H, Lq] f32."""
    if q.device.type == "cpu":
        return _flash_fwd_plain(q, k, v, carry, q_offset, k_offset,
                                causal=causal, scale=scale, block_q=block_q,
                                block_k=block_k, finish=finish)
    q, k, v = _cuda_operands(q, k, v)
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    f32 = dict(dtype=torch.float32, device=q.device)
    if carry is not None:
        carry = tuple(c.float().contiguous() for c in carry)
        if (carry[0].shape != q.shape
                or carry[1].shape != (b, h, lq) or carry[2].shape != (b, h, lq)):
            raise ValueError("carry must be acc [B, Lq, H, D], m/l [B, H, Lq]")
    if finish:
        out = (torch.empty_like(q), torch.empty((b, h, lq), **f32))
        dst = (None, None, None, *out)
    else:
        out = (torch.empty((b, lq, h, d), **f32),
               torch.empty((b, h, lq), **f32), torch.empty((b, h, lq), **f32))
        dst = (*out, None, None)
    src = carry if carry is not None else (None, None, None)
    with torch.cuda.device(q.device):
        rc = _lib().hvdt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *map(_ptr, src),
            *map(_ptr, dst), b, h, hkv, lq, lk, d, _KERNEL_DTYPES[q.dtype],
            int(q_offset), int(k_offset), int(causal), float(scale),
            _stream(q))
    _check_rc(rc, "hvdt_flash_fwd")
    _flash_fwd.launches += 1
    return out


_flash_fwd.launches = 0


# ---- kernels #10 and #11: backward ----------------------------------------


def _grad_tile(qt, kt, vt, dot, lse, delta, iq, ik, bq, bk, q_offset,
               k_offset, causal, scale):
    """The TPU backward kernels' shared step for (q block iq) x (k block
    ik), all [B, H, L, D]: the block operands, p = exp(s*scale - lse)
    (zero where masked) and dS = p * (dP - delta) * scale, f32."""
    rows = slice(iq * bq, (iq + 1) * bq)
    cols = slice(ik * bk, (ik + 1) * bk)
    qb, dob = qt[:, :, rows], dot[:, :, rows]
    kb, vb = kt[:, :, cols], vt[:, :, cols]
    s = qb.float() @ kb.float().transpose(-1, -2) * scale
    p = torch.exp(s - lse[:, :, rows, None])
    if causal:
        mask = _seq_mask(q_offset + iq * bq, bq, k_offset + ik * bk, bk,
                         qt.device)
        p = torch.where(mask, p, 0.0)
    dp = dob.float() @ vb.float().transpose(-1, -2)
    ds = p * (dp - delta[:, :, rows, None]) * scale
    return qb, kb, dob, p, ds


def _row_stats(lse, delta, shape):
    """lse and delta for the backward kernels: [B, H, Lq] f32, contiguous
    and 16-byte aligned (#11 reads them through a TMA tensor map, whose
    base must be)."""
    out = []
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be [B, H, Lq] = {shape}, got "
                             f"{tuple(t.shape)}")
        t = t.float().contiguous()
        out.append(t if t.data_ptr() % 16 == 0 else t.clone())
    return out


def _bwd_layout(q, k, v, do):
    h, hkv = q.shape[2], k.shape[2]
    return (q.transpose(1, 2), _heads(k, h // hkv), _heads(v, h // hkv),
            do.transpose(1, 2))


def _flash_dq_plain(q, k, v, do, lse, delta, q_offset, k_offset, *, causal,
                    scale, block_q, block_k):
    """Plain version of ``_flash_dq``: per q block, dQ accumulated over
    the k blocks it sees, dS rounded to K's dtype."""
    qt, kt, vt, dot = _bwd_layout(q, k, v, do)
    b, lq, h, d = q.shape
    dq = torch.zeros((b, h, lq, d), dtype=torch.float32, device=q.device)
    for iq in range(lq // block_q):
        for ik in range(k.shape[1] // block_k):
            if not _visible(causal, q_offset, k_offset, iq, block_q, ik,
                            block_k):
                continue
            _, kb, _, _, ds = _grad_tile(qt, kt, vt, dot, lse, delta, iq, ik,
                                         block_q, block_k, q_offset, k_offset,
                                         causal, scale)
            dq[:, :, iq * block_q:(iq + 1) * block_q] += (
                ds.to(kb.dtype).float() @ kb.float())
    return dq.transpose(1, 2)


def _flash_dq(q, k, v, do, lse, delta, q_offset: int, k_offset: int, *,
              causal: bool, scale: float, block_q: int, block_k: int):
    """dQ [B, Lq, H, D] f32 of q/do [B, Lq, H, D] over k/v [B, Lk, Hkv, D],
    from lse and delta [B, H, Lq] f32."""
    if q.device.type == "cpu":
        return _flash_dq_plain(q, k, v, do, lse, delta, q_offset, k_offset,
                               causal=causal, scale=scale, block_q=block_q,
                               block_k=block_k)
    q, k, v, do = _cuda_operands(q, k, v, do)
    b, lq, h, d = q.shape
    lse, delta = _row_stats(lse, delta, (b, h, lq))
    dq = torch.empty((b, lq, h, d), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _lib().hvdt_flash_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h,
            k.shape[2], lq, k.shape[1], d, _KERNEL_DTYPES[q.dtype],
            int(q_offset), int(k_offset), int(causal), float(scale),
            _stream(q))
    _check_rc(rc, "hvdt_flash_dq")
    _flash_dq.launches += 1
    return dq


_flash_dq.launches = 0


def _flash_dkv_plain(q, k, v, do, lse, delta, q_offset, k_offset, *, causal,
                     scale, block_q, block_k):
    """Plain version of ``_flash_dkv``: per k block, dK and dV accumulated
    over the q blocks that see it, P rounded to dO's dtype and dS to Q's;
    per q-head [B, Lk, H, D] f32."""
    qt, kt, vt, dot = _bwd_layout(q, k, v, do)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    dk = torch.zeros((b, h, lk, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for ik in range(lk // block_k):
        cols = slice(ik * block_k, (ik + 1) * block_k)
        for iq in range(lq // block_q):
            if not _visible(causal, q_offset, k_offset, iq, block_q, ik,
                            block_k):
                continue
            qb, _, dob, p, ds = _grad_tile(qt, kt, vt, dot, lse, delta, iq,
                                           ik, block_q, block_k, q_offset,
                                           k_offset, causal, scale)
            dv[:, :, cols] += (p.to(dob.dtype).float().transpose(-1, -2)
                               @ dob.float())
            dk[:, :, cols] += (ds.to(qb.dtype).float().transpose(-1, -2)
                               @ qb.float())
    return dk.transpose(1, 2), dv.transpose(1, 2)


def _flash_dkv(q, k, v, do, lse, delta, q_offset: int, k_offset: int, *,
               causal: bool, scale: float, block_q: int, block_k: int):
    """(dK, dV) per q-head, [B, Lk, H, D] f32 each (see ``_flash_dq``)."""
    if q.device.type == "cpu":
        return _flash_dkv_plain(q, k, v, do, lse, delta, q_offset, k_offset,
                                causal=causal, scale=scale, block_q=block_q,
                                block_k=block_k)
    q, k, v, do = _cuda_operands(q, k, v, do)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    lse, delta = _row_stats(lse, delta, (b, h, lq))
    dk = torch.empty((b, lk, h, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    with torch.cuda.device(q.device):
        rc = _lib().hvdt_flash_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, k.shape[2], lq, lk, d, _KERNEL_DTYPES[q.dtype],
            int(q_offset), int(k_offset), int(causal), float(scale),
            _stream(q))
    _check_rc(rc, "hvdt_flash_dkv")
    _flash_dkv.launches += 1
    return dk, dv


_flash_dkv.launches = 0


def flash_grad_block(q, k, v, do, out, lse, *, q_offset=0, k_offset=0,
                     causal: bool = True, scale: Optional[float] = None,
                     block_q: int = 512, block_k: int = 512,
                     delta: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash backward for one (Q block x K/V block) pair, through kernels
    #10 and #11; also the whole-sequence backward (zero offsets).

    q/do/out [B, Lq, H, D]; k/v [B, Lk, Hkv, D]; lse [B, H, Lq].  Returns
    (dq, dk, dv) in f32, dk/dv group-summed to [B, Lk, Hkv, D]."""
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    if scale is None:
        scale = d ** -0.5
    block_q = _fit_block(lq, block_q)
    block_k = _fit_block(lk, block_k)
    if delta is None:
        # f32 rowsum of dO * O, outside the kernels as in the reference.
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    kw = dict(causal=causal, scale=float(scale), block_q=block_q,
              block_k=block_k)
    q_offset, k_offset = int(q_offset), int(k_offset)
    dq = _flash_dq(q, k, v, do, lse, delta, q_offset, k_offset, **kw)
    dk, dv = _flash_dkv(q, k, v, do, lse, delta, q_offset, k_offset, **kw)
    if group > 1:
        dk = dk.reshape(b, lk, hkv, group, d).sum(3)
        dv = dv.reshape(b, lk, hkv, group, d).sum(3)
    return dq, dk, dv


def _flash_attn_bwd_blockwise(q, k, v, out, lse, do, causal: bool,
                              scale: float, block_q: int, block_k: int):
    """The default backward (``HVDT_FLASH_BWD=xla``): the reference's
    blockwise recompute in plain f32 PyTorch (its XLA branch).  Tiles are
    capped by the same [B, H, tq, blk] f32 budget of 96 MiB; a q tile
    strictly above a K block is skipped (causal pruning)."""
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    blk = _fit_block(lk, min(block_k, 512))
    tq = _fit_block(lq, min(block_q, 512))
    tile_budget = 96 * 1024 * 1024
    while b * h * tq * blk * 4 > tile_budget and max(tq, blk) > 128:
        if blk >= tq and blk > 128:
            blk = _fit_block(lk, blk // 2)
        else:
            tq = _fit_block(lq, tq // 2)
    f32 = torch.float32
    delta = (do.float() * out.float()).sum(-1)             # [B, Lq, H]
    dq = torch.zeros((b, lq, h, d), dtype=f32, device=q.device)
    dk = torch.empty((b, lk, hkv, d), dtype=f32, device=q.device)
    dv = torch.empty_like(dk)
    for i in range(lk // blk):
        cols = slice(i * blk, (i + 1) * blk)
        ks, vs = k[:, cols].float(), v[:, cols].float()
        if group > 1:
            ks = ks.repeat_interleave(group, dim=2)
            vs = vs.repeat_interleave(group, dim=2)
        dk_b = torch.zeros((b, blk, h, d), dtype=f32, device=q.device)
        dv_b = torch.zeros_like(dk_b)
        for j in range(lq // tq):
            if causal and (j + 1) * tq - 1 < i * blk:
                continue
            rows = slice(j * tq, (j + 1) * tq)
            q_t, do_t = q[:, rows].float(), do[:, rows].float()
            s = torch.einsum("bqhd,bkhd->bhqk", q_t, ks) * scale
            if causal:
                mask = _seq_mask(j * tq, tq, i * blk, blk, q.device)
                s = torch.where(mask, s, _NEG_INF)
            p = torch.exp(s - lse[:, :, rows, None])
            dv_b += torch.einsum("bhqk,bqhd->bkhd", p, do_t)
            dp = torch.einsum("bqhd,bkhd->bhqk", do_t, vs)
            ds = p * (dp - delta[:, rows].transpose(1, 2)[..., None]) * scale
            dq[:, rows] += torch.einsum("bhqk,bkhd->bqhd", ds, ks)
            dk_b += torch.einsum("bhqk,bqhd->bkhd", ds, q_t)
        if group > 1:
            dk_b = dk_b.reshape(b, blk, hkv, group, d).sum(3)
            dv_b = dv_b.reshape(b, blk, hkv, group, d).sum(3)
        dk[:, cols], dv[:, cols] = dk_b, dv_b
    return dq, dk, dv


class _FlashAttn(torch.autograd.Function):
    """Kernel forward (#9); the backward is chosen by ``HVDT_FLASH_BWD``
    when it runs (the reference reads it when the backward is traced)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_q, block_k):
        out, lse = _flash_fwd(q, k, v, None, 0, 0, causal=causal,
                              scale=scale, block_q=block_q, block_k=block_k,
                              finish=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, scale, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, block_q, block_k = ctx.opts
        do = do.contiguous()
        if config.get_str("HVDT_FLASH_BWD").lower() in ("kernel", "pallas"):
            dq, dk, dv = flash_grad_block(q, k, v, do, out, lse,
                                          causal=causal, scale=scale,
                                          block_q=block_q, block_k=block_k)
        else:
            dq, dk, dv = _flash_attn_bwd_blockwise(q, k, v, out, lse, do,
                                                   causal, scale, block_q,
                                                   block_k)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    block_q: int = 512, block_k: int = 1024) -> torch.Tensor:
    """Fused flash attention: q [B, Lq, H, D], k/v [B, Lk, Hkv, D] (GQA
    via fewer kv heads) → [B, Lq, H, D] in q's dtype.  Differentiable:
    the forward is kernel #9, the backward the blockwise recompute or,
    under ``HVDT_FLASH_BWD=kernel``, kernels #10/#11."""
    b, lq, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    block_q = _fit_block(lq, block_q)
    block_k = _fit_block(k.shape[1], block_k)
    return _FlashAttn.apply(q, k, v, causal, float(scale), block_q, block_k)


def flash_block_update(q: torch.Tensor, k_blk: torch.Tensor,
                       v_blk: torch.Tensor, acc: torch.Tensor,
                       row_max: torch.Tensor, row_sum: torch.Tensor, *,
                       q_offset, k_offset, causal: bool, scale: float,
                       block_q: int = 512, block_k: int = 1024) -> _Carry:
    """One ring step: q/acc [B, Lq, H, D]; k_blk/v_blk [B, Lk, Hkv, D];
    row_max/row_sum [B, H, Lq]; ``q_offset``/``k_offset`` the global
    positions of the local shards.  Returns the updated (acc, row_max,
    row_sum), f32."""
    block_q = _fit_block(q.shape[1], block_q)
    block_k = _fit_block(k_blk.shape[1], block_k)
    return _flash_fwd(q, k_blk, v_blk, (acc, row_max, row_sum),
                      int(q_offset), int(k_offset), causal=causal,
                      scale=float(scale), block_q=block_q, block_k=block_k,
                      finish=False)


# ---- kernels #12 and #13: whole-sequence attention ------------------------


def _fit_heads_per_block(h: int, group: int, heads_per_block: int) -> int:
    """Largest hb <= requested that divides h and is a multiple of the
    GQA group (so a block's kv heads are whole).  ``group`` is the floor:
    a request below it (or a knob value <= 0) clamps up to one whole kv
    group per block, never 0 — the reference's clamp."""
    hb = max(min(heads_per_block, h), group)
    while h % hb or hb % group:
        hb -= 1
    return max(hb, group)


def _head_blocks(h: int, hkv: int, hb: int):
    """The TPU kernels' grid over heads: (q heads, kv heads) slices of
    ``hb`` q heads and their ``hb // group`` kv heads."""
    group = h // hkv
    for h0 in range(0, h, hb):
        yield slice(h0, h0 + hb), slice(h0 // group, (h0 + hb) // group)


def _smallseq_fwd_plain(q, k, v, *, causal: bool, scale: float, hb: int):
    """Plain version of ``_smallseq_fwd``: the TPU kernel's body over
    blocks of ``hb`` heads — f32 scores times scale, -1e30 where masked,
    the row's max, p = exp(s - max) zeroed where masked, its f32 sum, P
    rounded to V's dtype before P·V, and o = acc / sum without a clamp."""
    b, l, h, _ = q.shape
    group = h // k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    mask = _seq_mask(0, l, 0, l, q.device) if causal else None
    for heads, kv in _head_blocks(h, k.shape[2], hb):
        qh = q[:, :, heads].transpose(1, 2).float()
        kh, vh = _heads(k[:, :, kv], group), _heads(v[:, :, kv], group)
        s = qh @ kh.float().transpose(-1, -2) * scale
        if causal:
            s = torch.where(mask, s, _NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        if causal:
            p = torch.where(mask, p, 0.0)
        lsum = p.sum(-1, keepdim=True)
        acc = p.to(vh.dtype).float() @ vh.float()
        out[:, :, heads] = (acc / lsum).to(q.dtype).transpose(1, 2)
        lse[:, heads] = (m + torch.log(lsum))[..., 0]
    return out, lse


def _smallseq_fwd(q, k, v, *, causal: bool, scale: float, hb: int):
    """Whole-sequence attention of q [B, L, H, D] over k/v [B, L, Hkv, D]:
    (o [B, L, H, D] in q's dtype, lse [B, H, L] f32).  ``hb`` shapes only
    the plain version's loop."""
    if q.device.type == "cpu":
        return _smallseq_fwd_plain(q, k, v, causal=causal, scale=scale,
                                   hb=hb)
    q, k, v = _cuda_operands(q, k, v)
    b, l, h, d = q.shape
    if k.shape[1] != l:
        raise ValueError(f"the smallseq kernels need lq == lk, got {l} and "
                         f"{k.shape[1]}")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _smallseq_lib().hvdt_smallseq_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, k.shape[2], l, d, _KERNEL_DTYPES[q.dtype],
            int(causal), float(scale), _stream(q))
    _check_rc(rc, "hvdt_smallseq_fwd")
    _smallseq_fwd.launches += 1
    return out, lse


_smallseq_fwd.launches = 0


def _smallseq_bwd_plain(q, k, v, do, out, lse, *, causal: bool,
                        scale: float, hb: int):
    """Plain version of ``_smallseq_bwd``: the TPU kernel's body over
    blocks of ``hb`` heads — p = exp(s·scale - lse) zeroed where masked,
    delta = rowsum(dO·O) in f32, dV = round(p)ᵀ dO, dS = p (dP - delta)
    scale, dQ = round(dS) K, dK = round(dS)ᵀ Q, a GQA group's dK/dV summed
    in f32 from its first head on; returned in the input dtype."""
    b, l, h, _ = q.shape
    hkv = k.shape[2]
    group = h // hkv
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    mask = _seq_mask(0, l, 0, l, q.device) if causal else None
    for heads, kv in _head_blocks(h, hkv, hb):
        qh, doh, oh = (x[:, :, heads].transpose(1, 2) for x in (q, do, out))
        kh, vh = _heads(k[:, :, kv], group), _heads(v[:, :, kv], group)
        s = qh.float() @ kh.float().transpose(-1, -2) * scale
        p = torch.exp(s - lse[:, heads, :, None])
        if causal:
            p = torch.where(mask, p, 0.0)
        delta = (doh.float() * oh.float()).sum(-1, keepdim=True)
        dv_c = p.to(doh.dtype).float().transpose(-1, -2) @ doh.float()
        dp = doh.float() @ vh.float().transpose(-1, -2)
        ds = (p * (dp - delta) * scale).to(qh.dtype).float()
        dq[:, :, heads] = (ds @ kh.float()).to(q.dtype).transpose(1, 2)
        dk_c = ds.transpose(-1, -2) @ qh.float()
        # [B, hb, L, D] -> [B, hb_kv, group, L, D]: sum each group in order.
        dk_c = dk_c.unflatten(1, (-1, group))
        dv_c = dv_c.unflatten(1, (-1, group))
        dk_b, dv_b = dk_c[:, :, 0], dv_c[:, :, 0]
        for i in range(1, group):
            dk_b, dv_b = dk_b + dk_c[:, :, i], dv_b + dv_c[:, :, i]
        dk[:, :, kv] = dk_b.to(k.dtype).transpose(1, 2)
        dv[:, :, kv] = dv_b.to(v.dtype).transpose(1, 2)
    return dq, dk, dv


def _smallseq_bwd(q, k, v, do, out, lse, *, causal: bool, scale: float,
                  hb: int):
    """(dq [B, L, H, D], dk, dv [B, L, Hkv, D]) in the input dtype from
    dO [B, L, H, D], the forward's out and lse [B, H, L] f32.  One call
    makes two launches: dQ, which also writes delta = rowsum(dO·O) into a
    [B, H, L] f32 scratch tensor, then dK/dV, which reads it."""
    if q.device.type == "cpu":
        return _smallseq_bwd_plain(q, k, v, do, out, lse, causal=causal,
                                   scale=scale, hb=hb)
    q, k, v, do, out = _cuda_operands(q, k, v, do, out)
    b, l, h, d = q.shape
    if k.shape[1] != l:
        raise ValueError(f"the smallseq kernels need lq == lk, got {l} and "
                         f"{k.shape[1]}")
    delta = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    lse, delta = _row_stats(lse, delta, (b, h, l))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        rc = _smallseq_lib().hvdt_smallseq_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            out.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, k.shape[2], l, d,
            _KERNEL_DTYPES[q.dtype], int(causal), float(scale), _stream(q))
    _check_rc(rc, "hvdt_smallseq_bwd")
    _smallseq_bwd.launches += 1
    return dq, dk, dv


_smallseq_bwd.launches = 0


class _SmallseqAttn(torch.autograd.Function):
    """Kernel forward (#12) saving (q, k, v, out, lse); kernel backward
    (#13) — the reference's ``_smallseq_diff`` custom_vjp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, hb):
        out, lse = _smallseq_fwd(q, k, v, causal=causal, scale=scale, hb=hb)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, scale, hb)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, hb = ctx.opts
        dq, dk, dv = _smallseq_bwd(q, k, v, do.contiguous(), out, lse,
                                   causal=causal, scale=scale, hb=hb)
        return dq, dk, dv, None, None, None


def flash_attention_smallseq(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             scale: Optional[float] = None,
                             heads_per_block: int = 8) -> torch.Tensor:
    """Whole-sequence fused attention for the short-sequence regime (the
    BERT-Large-shape complement of :func:`flash_attention`): q [B, L, H,
    D], k/v [B, L, Hkv, D] (GQA via fewer kv heads) → [B, L, H, D] in q's
    dtype.  Differentiable: the forward is kernel #12 and the backward
    kernel #13, which recomputes the probabilities from the saved
    logsumexp.  ``heads_per_block`` is clamped as the reference clamps it
    and shapes the plain version's loop over heads."""
    b, l, h, d = q.shape
    hkv = k.shape[2]
    if h % hkv:
        raise ValueError(f"q heads {h} not divisible by kv heads {hkv}")
    if k.shape[1] != l:
        raise ValueError("flash_attention_smallseq needs lq == lk "
                         f"(got {l} vs {k.shape[1]})")
    if scale is None:
        scale = d ** -0.5
    hb = _fit_heads_per_block(h, h // hkv, heads_per_block)
    return _SmallseqAttn.apply(q, k, v, causal, float(scale), hb)


def attention_reference(q, k, v, *, causal=True, scale=None):
    """Naive attention (materializes the scores) — the correctness
    oracle: f32 scores and softmax, one cast to q's dtype."""
    b, lq, h, d = q.shape
    hkv = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    if h != hkv:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s = torch.where(_seq_mask(0, lq, 0, k.shape[1], q.device), s,
                        _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
