"""Ring attention: exact attention over sequence shards passed around a
ring of processes.

The PyTorch counterpart of the JAX package's
``parallel/ring_attention.py``.  Each member of a process group (the
``sp`` dimension of a mesh) holds one shard of the sequence.  Q stays
put; the K/V blocks, and the key side's ``segment_ids``, rotate to member
``(rank + 1) % sp`` with ``dist.batch_isend_irecv``, while each member
folds every visiting block into a flash-style (log-sum-exp) running
carry.  Per-step memory is O(block).  The transfer of step s + 1's block
is posted before step s computes and waited for only when that block is
used, so the transfer runs beside the step.

Per step, either the plain math of the reference's non-kernel path
(:func:`_block_update` forward, :func:`_bwd_block_grads` backward, f32
scores masked by global positions and segment labels) or, under
``use_pallas``, the flash kernels: ``flash_block_update`` (#9) forward
and ``flash_grad_block`` (#10 then #11) backward.  A step is one of
three static cases, decided on the host from the member and the step:
the block came from an earlier member (fully visible), from this member
(the causal diagonal), or from a later one (wholly masked under
``causal``, so skipped).  The step bodies are module-level functions
(:func:`_forward_step`, :func:`_backward_step`) so a caller can drive
every member of a ring in one process.

On a CUDA tensor the kernels are the default wherever they take the
operands; the plain step materializes f32 scores of every block pair.

Load balance: under ``causal`` member r computes r + 1 of its sp
steps, so the last member's steps bound the ring.  The reference has
the same imbalance and no zigzag layout, and neither has the port.

Differentiation: a ``torch.autograd.Function`` whose backward is a
second ring pass, recomputing each block's probabilities from the saved
logsumexp: dq accumulates locally, and the f32 dk/dv accumulators travel
with their K/V block (and its key labels) and come home after sp
rotations.  A tensor ``scale`` that requires grad gets ``sum(dq * q) /
scale``.

With one member there is no transfer.

Inside a ``step_pipeline.donated_step`` capture the ring is captured as
it runs eagerly: its host choices (each step's case, ``use_pallas``, the
masks) are constants of the member and the step, so the graph is the
eager ring's sequence of kernels and NCCL P2P transfers, frozen; a wait
on a transfer is a stream wait.  The transfers' records (the ``sp``
axis's ``ppermute`` bytes and one flight-recorder event a pass, as the
pipeline books its clock) are booked before each replay through
``graphs.on_replay``, so a capture by other means raises.  The
donated step's eager warm-up call posts both directions (forward K/V,
backward dK/dV), which creates NCCL's P2P communicators before the
capture.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..common import config, graphs
from ..ops.pallas_kernels import (_KERNEL_DTYPES, _KERNEL_HEAD_DIMS,
                                  flash_block_update, flash_grad_block)

__all__ = ["ring_attention"]

_NEG_INF = -1e30
_Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
_FULL, _DIAG, _SKIP = "full", "diagonal", "skip"


# ---- the plain per-step math ----------------------------------------------


def _block_update(q, k, v, acc, row_max, row_sum, mask, scale):
    """One flash-attention block accumulation step, in f32.

    q: [B, Lq, H, D]; k/v: [B, Lk, Hkv, D] (Hkv divides H; expanded here,
    after the transfer, so the ring only moves the unexpanded K/V); acc:
    [B, Lq, H, D]; row_max/row_sum: [B, H, Lq]; mask: bool broadcastable
    to [B, H, Lq, Lk], or None for a fully visible block.
    """
    h, kv_heads = q.shape[2], k.shape[2]
    if h != kv_heads:
        k = k.repeat_interleave(h // kv_heads, dim=2)
        v = v.repeat_interleave(h // kv_heads, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        scores = torch.where(mask, scores, _NEG_INF)
    new_max = torch.maximum(row_max, scores.amax(-1))
    # A wholly masked row has scores == new_max == -1e30, whose exp() is
    # 1: re-mask explicitly.
    p = torch.exp(scores - new_max[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    correction = torch.exp(row_max - new_max)
    acc = acc * correction.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    row_sum = row_sum * correction + p.sum(-1)
    return acc, new_max, row_sum


def _bwd_block_grads(qf, dof, k_blk, v_blk, lse, delta_bhq, mask, scale,
                     group):
    """One visiting K/V block's (dq, dk, dv) contributions in the plain
    ring backward, scores recomputed from the saved logsumexp.

    qf/dof: f32 ``[B, Lq, H, D]``; k_blk/v_blk: raw ``[B, Lk, Hkv, D]``;
    lse and delta_bhq: ``[B, H, Lq]``; mask: broadcastable to ``[B, H,
    Lq, Lk]`` or None (fully visible); group = H // Hkv.  Returns f32
    dq ``[B, Lq, H, D]`` and dk/dv ``[B, Lk, Hkv, D]``.
    """
    ks, vs = k_blk.float(), v_blk.float()
    if group > 1:
        ks = ks.repeat_interleave(group, dim=2)
        vs = vs.repeat_interleave(group, dim=2)
    s_ = torch.einsum("bqhd,bkhd->bhqk", qf, ks) * scale
    p = torch.exp(s_ - lse[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    dv_c = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vs)
    ds = p * (dp - delta_bhq[..., None]) * scale
    dq_c = torch.einsum("bhqk,bkhd->bqhd", ds, ks)
    dk_c = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    if group > 1:
        b, lk, hkv, d = k_blk.shape
        dk_c = dk_c.reshape(b, lk, hkv, group, d).sum(3)
        dv_c = dv_c.reshape(b, lk, hkv, group, d).sum(3)
    return dq_c, dk_c, dv_c


# ---- the step bodies -------------------------------------------------------


def _case(src: int, my: int, causal: bool) -> str:
    """A step's static case for the block of member ``src`` on member
    ``my``."""
    if not causal or src < my:
        return _FULL
    return _DIAG if src == my else _SKIP


def _step_mask(q, k_blk, src, my, causal, q_seg, k_seg):
    """The plain step's mask from global positions and segment labels, or
    None when the block is fully visible."""
    mask = None
    if causal:
        lq, lk = q.shape[1], k_blk.shape[1]
        q_pos = my * lq + torch.arange(lq, device=q.device)
        k_pos = src * lk + torch.arange(lk, device=q.device)
        mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
    if k_seg is not None:
        same = (q_seg[:, :, None] == k_seg[:, None, :])[:, None]
        mask = same if mask is None else mask & same
    return mask


def _init_carry(q: torch.Tensor) -> _Carry:
    """(acc, row_max, row_sum) before the first step: (0, -1e30, 0) f32."""
    b, lq, h, d = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.zeros((b, lq, h, d), **f32),
            torch.full((b, h, lq), _NEG_INF, **f32),
            torch.zeros((b, h, lq), **f32))


def _forward_step(q, k_blk, v_blk, carry: _Carry, *, src: int, my: int,
                  causal: bool, scale: float, use_pallas: bool, q_seg=None,
                  k_seg=None) -> _Carry:
    """One forward ring step on member ``my``: ``carry`` updated with the
    K/V block (and key labels ``k_seg``) that came from member ``src``.
    A later member's block under ``causal`` leaves the carry as it is.
    Under ``use_pallas``, kernel #9 on the step's static case; otherwise
    the plain masked update."""
    case = _case(src, my, causal)
    if case == _SKIP:
        return carry
    if use_pallas:
        return flash_block_update(q, k_blk, v_blk, *carry, q_offset=0,
                                  k_offset=0, causal=case == _DIAG,
                                  scale=scale)
    mask = _step_mask(q, k_blk, src, my, causal, q_seg, k_seg)
    return _block_update(q, k_blk, v_blk, *carry, mask, scale)


def _finish(carry: _Carry, dtype: torch.dtype):
    """(out [B, Lq, H, D] in ``dtype``, lse [B, H, Lq] f32) from the
    carry after the last step."""
    acc, row_max, row_sum = carry
    row_sum = torch.clamp_min(row_sum, 1e-30)
    out = acc / row_sum.transpose(1, 2)[..., None]
    lse = row_max + torch.log(row_sum)
    return out.to(dtype), lse


class _BwdInputs(NamedTuple):
    """What every backward step reads: the member's q, dO, out and lse,
    delta = rowsum(dO * O) [B, H, Lq] f32 (computed once), and for the
    plain step f32 copies of q and dO."""
    q: torch.Tensor
    do: torch.Tensor
    out: torch.Tensor
    lse: torch.Tensor
    delta: torch.Tensor
    qf: Optional[torch.Tensor]
    dof: Optional[torch.Tensor]


def _bwd_inputs(q, do, out, lse, use_pallas: bool) -> _BwdInputs:
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    if use_pallas:
        return _BwdInputs(q, do, out, lse, delta, None, None)
    return _BwdInputs(q, do, out, lse, delta, q.float(), do.float())


def _backward_step(inp: _BwdInputs, k_blk, v_blk, *, src: int, my: int,
                   causal: bool, scale: float, use_pallas: bool, q_seg=None,
                   k_seg=None):
    """One backward ring step on member ``my`` for the K/V block (and key
    labels ``k_seg``) of member ``src``: f32 (dq [B, Lq, H, D], dk, dv
    [B, Lk, Hkv, D]) of this block pair, or None for a later member's
    block under ``causal``.  Under ``use_pallas``, kernels #10 and #11
    (``flash_grad_block``) on the step's static case; otherwise
    :func:`_bwd_block_grads`."""
    case = _case(src, my, causal)
    if case == _SKIP:
        return None
    if use_pallas:
        return flash_grad_block(inp.q, k_blk, v_blk, inp.do, inp.out,
                                inp.lse, causal=case == _DIAG, scale=scale,
                                delta=inp.delta)
    mask = _step_mask(inp.q, k_blk, src, my, causal, q_seg, k_seg)
    group = inp.q.shape[2] // k_blk.shape[2]
    return _bwd_block_grads(inp.qf, inp.dof, k_blk, v_blk, inp.lse,
                            inp.delta, mask, scale, group)


# ---- the ring --------------------------------------------------------------


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _record_ring(ring: "_Ring", name: str, nbytes: int, count: int,
                 dtype: torch.dtype) -> None:
    """Book one ring pass's transfers (``count`` tensors, ``nbytes`` in
    all) as one ``ppermute`` series entry (``path="jit"``, the ring's
    axis) and one flight-recorder event.  Inside a CUDA-graph capture
    the booking runs before each replay (``graphs.on_replay``)."""
    dt = str(dtype).rsplit(".", 1)[-1]

    def book() -> None:
        if not count:
            return
        from ..telemetry import flight_recorder as _frm
        from ..telemetry import instrument as _ti

        rec = _ti.get_recorder()
        if rec is not None:
            rec.record_collective("ppermute", dt, "exact", nbytes,
                                  count=count, path="jit", axis=ring.axis)
        flight = _frm.get_flight_recorder()
        if flight is not None:
            flight.record(op="ppermute", name=name, dtype=dt,
                          shape=(int(nbytes),), nbytes=nbytes, wire="exact",
                          path="jit", count=count, axis=ring.axis)

    if graphs.capturing():
        graphs.on_replay(book)
    else:
        book()


class _Pending:
    """Transfers in flight; the sent tensors stay referenced until they
    complete."""

    def __init__(self, works, sent):
        self._works, self._sent = works, sent

    def wait(self) -> None:
        for w in self._works:
            w.wait()
        self._works, self._sent = (), ()


class _Ring:
    """The ring of a process group: its size, this member's index and the
    global ranks of the next and previous members.  ``group`` is a
    ``ProcessGroup``, a ``DeviceMesh`` (its ``axis`` dimension is taken)
    or None for the world (a world of one when no process group exists).
    """

    def __init__(self, group=None, axis: str = "sp"):
        self.axis = axis
        if hasattr(group, "get_group"):
            group = group.get_group(axis)
        if group is None and not dist.is_initialized():
            self.group, self.size, self.rank = None, 1, 0
            return
        self.group = group if group is not None else dist.group.WORLD
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        if self.rank < 0:
            raise ValueError("this process is not a member of the ring's "
                             "process group")
        self.next = dist.get_global_rank(self.group,
                                         (self.rank + 1) % self.size)
        self.prev = dist.get_global_rank(self.group,
                                         (self.rank - 1) % self.size)

    def post(self, *tensors: torch.Tensor, backward: bool = False):
        """Send ``tensors`` to the next member (the previous one when
        ``backward``) and receive the same shapes from the other side into
        new buffers.  Returns (received buffers, :class:`_Pending`); the
        buffers hold the data only after ``wait()``."""
        sent = [t.contiguous() for t in tensors]
        recv = [torch.empty_like(t) for t in sent]
        to, frm = (self.prev, self.next) if backward else (self.next,
                                                           self.prev)
        ops = []
        for s, r in zip(sent, recv):
            ops.append(dist.P2POp(dist.isend, s, to, self.group))
            ops.append(dist.P2POp(dist.irecv, r, frm, self.group))
        return recv, _Pending(dist.batch_isend_irecv(ops), sent)


def _ring_forward(q, k, v, ring: _Ring, causal: bool, scale: float,
                  segment_ids, use_pallas: bool):
    """Forward ring pass; returns (out in q's dtype, lse [B, H, Lq] f32)."""
    carry = _init_carry(q)
    blk = (k, v) if segment_ids is None else (k, v, segment_ids)
    _record_ring(ring, "ring.fwd", (ring.size - 1) * _nbytes(blk),
                 (ring.size - 1) * len(blk), k.dtype)
    for s in range(ring.size):
        pending = None
        if s + 1 < ring.size:
            nxt, pending = ring.post(*blk)
        carry = _forward_step(q, blk[0], blk[1], carry,
                              src=(ring.rank - s) % ring.size, my=ring.rank,
                              causal=causal, scale=scale,
                              use_pallas=use_pallas, q_seg=segment_ids,
                              k_seg=blk[2] if len(blk) > 2 else None)
        if pending is not None:
            pending.wait()
            blk = nxt
    return _finish(carry, q.dtype)


def _ring_backward(q, k, v, out, lse, do, segment_ids, ring: _Ring,
                   causal: bool, scale: float, use_pallas: bool):
    """Second ring pass: dq accumulates here; the f32 (dk, dv)
    accumulator of the resident block gets this member's contribution and
    moves on with the block (and its key labels), arriving home after sp
    rotations.  Returns f32 (dq, dk, dv)."""
    inp = _bwd_inputs(q, do, out, lse, use_pallas)
    b, lk, hkv, d = k.shape
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    blk = (k, v) if segment_ids is None else (k, v, segment_ids)
    # The block moves every step but the last, the f32 (dk, dv)
    # accumulators every step of a ring of two or more.
    moves = ring.size if ring.size > 1 else 0
    _record_ring(ring, "ring.bwd",
                 (ring.size - 1) * _nbytes(blk) + moves * 8 * k.numel(),
                 (ring.size - 1) * len(blk) + moves * 2, k.dtype)
    acc_in: Optional[_Pending] = None
    acc_recv: Sequence[torch.Tensor] = ()
    for s in range(ring.size):
        blk_in = None
        if s + 1 < ring.size:
            blk_next, blk_in = ring.post(*blk)
        grads = _backward_step(inp, blk[0], blk[1],
                               src=(ring.rank - s) % ring.size, my=ring.rank,
                               causal=causal, scale=scale,
                               use_pallas=use_pallas, q_seg=segment_ids,
                               k_seg=blk[2] if len(blk) > 2 else None)
        if acc_in is None:
            acc = [torch.zeros((b, lk, hkv, d), dtype=torch.float32,
                               device=k.device) for _ in range(2)]
        else:
            acc_in.wait()
            acc = list(acc_recv)
        if grads is not None:
            dq += grads[0]
            acc = [acc[0] + grads[1], acc[1] + grads[2]]
        if ring.size == 1:
            acc_recv = acc
        else:
            acc_recv, acc_in = ring.post(*acc)
        if blk_in is not None:
            blk_in.wait()
            blk = blk_next
    if acc_in is not None:
        acc_in.wait()
    dk, dv = acc_recv
    return dq, dk, dv


class _RingAttn(torch.autograd.Function):
    """The forward ring saving (q, k, v, out, lse); its backward is the
    second ring pass (the reference's ``custom_vjp``).  ``scale_t`` is the
    scale tensor when it requires grad, else None: since every score is
    ``scale * q.k``, its gradient is ``sum(dq * q) / scale``."""

    @staticmethod
    def forward(ctx, q, k, v, scale_t, segment_ids, ring, causal, scale,
                use_pallas):
        out, lse = _ring_forward(q, k, v, ring, causal, scale, segment_ids,
                                 use_pallas)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids, scale_t)
        ctx.opts = (ring, causal, scale, use_pallas)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, segment_ids, scale_t = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, out, lse, do.contiguous(),
                                    segment_ids, *ctx.opts)
        dscale = None
        if ctx.needs_input_grad[3]:
            dscale = ((dq * q.float()).sum() / ctx.opts[2]).reshape(
                scale_t.shape).to(scale_t.dtype)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dscale,
                None, None, None, None, None)


def _kernel_operands(q, k, v) -> bool:
    """Whether kernels #9-#11 on the card take these operands: one
    16-bit dtype and head dim 64 or 128."""
    return (q.dtype in _KERNEL_DTYPES and k.dtype == v.dtype == q.dtype
            and q.shape[3] in _KERNEL_HEAD_DIMS)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   group=None, axis: str = "sp", causal: bool = True,
                   scale: Union[float, torch.Tensor, None] = None,
                   segment_ids: Optional[torch.Tensor] = None,
                   use_pallas: Optional[bool] = None) -> torch.Tensor:
    """Exact (optionally causal) attention over a sequence-sharded ring.

    Every member of the ring calls it with its local shards, in the same
    order as every other collective.

    Args:
      q, k, v: local shards ``[batch, local_seq, heads, head_dim]``;
        k/v may have fewer heads (MQA/GQA) as long as they divide q's.
        Member r holds positions ``[r * local_seq, (r + 1) * local_seq)``.
      group: the ring: a ``ProcessGroup``, a ``DeviceMesh`` whose ``axis``
        dimension is taken, or None for the world.
      axis: the mesh dimension carrying the sequence shards.
      causal: a causal mask over global positions.
      scale: score scale; default ``1/sqrt(head_dim)``.  A tensor that
        requires grad gets its gradient.
      segment_ids: optional ``[batch, local_seq]`` integer labels of
        packed sequences: attention stays within equal labels.  The key
        side's labels rotate with K/V.
      use_pallas: run each step through kernels #9-#11
        (``flash_block_update`` forward, ``flash_grad_block``
        backward).  Legal only with ``segment_ids=None``; on the CPU also
        only with both lengths tiling by ``min(128, L)``, the reference's
        gate (the card's kernels mask a ragged edge).  None engages them
        where legal when ``HVDT_RING_PALLAS`` is set, and on a CUDA
        tensor also whenever the kernels take the operands (bf16/fp16,
        head dim 64 or 128).  True where illegal warns and runs the
        plain step on the CPU, and raises on the card; on a CUDA tensor
        the kernels raise for operands they do not take.

    Returns ``[batch, local_seq, heads, head_dim]`` in q's dtype.
    """
    b, lq, h, d = q.shape
    if h % k.shape[2]:
        raise ValueError(
            f"q heads {h} not divisible by kv heads {k.shape[2]}")
    if scale is None:
        scale = d ** -0.5
    lk = k.shape[1]
    on_card = q.device.type == "cuda"

    kernel_legal = segment_ids is None and (
        on_card or not (lq % min(128, lq) or lk % min(128, lk)))
    if use_pallas is None:
        use_pallas = kernel_legal and (
            config.get_bool("HVDT_RING_PALLAS")
            or (on_card and _kernel_operands(q, k, v)))
    elif use_pallas and not kernel_legal:
        if on_card:
            raise ValueError("ring_attention(use_pallas=True): kernels "
                             "#9-#11 take no segment_ids")
        warnings.warn(
            "ring_attention(use_pallas=True) ignored: the kernels need "
            f"segment_ids=None and 128-tiling shapes (lq={lq}, lk={lk}); "
            "running the plain block update", stacklevel=2)
        use_pallas = False

    scale_t = None
    if isinstance(scale, torch.Tensor):
        scale_t = scale if scale.requires_grad else None
        scale = scale.detach()
    return _RingAttn.apply(q, k, v, scale_t, segment_ids, _Ring(group, axis),
                           causal, float(scale), bool(use_pallas))
