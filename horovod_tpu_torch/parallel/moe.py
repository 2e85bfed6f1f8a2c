"""Expert parallelism: capacity-factor top-k MoE with all-to-all token
routing over a process group.

The PyTorch counterpart of the JAX package's ``parallel/moe.py``.  Each
member of a process group (the ``ep`` dimension of a mesh) holds its own
tokens and ``experts_per_rank`` experts.  A token's top-k experts are
picked from a softmax in f32, the gates renormalised over the chosen k;
the choices are flattened k-major, so every primary choice claims an
expert's capacity before any secondary one.  Kept choices are written
into a static ``[E, cap, D]`` dispatch block, which one all-to-all sends
to the experts' members; ``expert_fn`` runs on ``[E_local, ep * cap,
D]``, a second all-to-all brings the results back, and each kept slot is
gathered and weighted by its gate.  Choices over capacity are dropped
(their output is zero: the caller's residual passes them through).

The dispatch writes and the combine reads only kept rows: a dropped
choice points at one spare row past the block, which is never sent.
(The reference adds zero-weighted dropped rows into slot (0, 0), which
is exact, but an accumulate on the card would make the order of the
sums nondeterministic.)

The all-to-all is a ``torch.autograd.Function`` whose backward is the
same all-to-all of the cotangent: the transpose JAX takes of
``lax.all_to_all``.  The wire follows ``transport.policy.resolve_axis``
for the group's axis name, as in the reference: ``bf16`` / ``fp16`` cast
for the flight; ``int8`` sends block-scaled int8 codes and f32 scales
(each rank's slice padded to whole blocks), through kernels #5 and #6 on
CUDA tensors and their plain versions on CPU tensors.  The backward
sends the cotangent over the same wire.  The reference's gradient
through its int8 wire differs: the cast to int8 passes no cotangent, so
``jax.grad`` reaches the inputs only through each block's scale (one
element a block: its absolute maximum); the port's is the quantized
cotangent everywhere (``tests/test_torch_port_moe.py``).

Telemetry, as in the reference: each all-to-all books the collective
counters (``op="alltoall"``, ``path="jit"``, the ``ep`` axis, the wire's
payload bytes) and one flight-recorder event, each time it runs (the
backward's all-to-alls too, named ``<name>.grad``; once per replay
inside a ``donated_step`` capture); each call sets the capacity gauges,
and :func:`report_moe_aux` the per-step routing gauges.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ..common import config
from .ring_attention import _Ring

__all__ = ["moe_dispatch_combine", "MoEAux", "moe_capacity",
           "report_moe_aux", "a2a_wire_bytes"]


class MoEAux(NamedTuple):
    load_balance_loss: torch.Tensor   # switch-transformer aux loss (scalar)
    dropped_fraction: torch.Tensor    # fraction of choices over capacity


def moe_capacity(tokens_per_rank: int, num_experts: int, *,
                 top_k: int = 1, capacity_factor: float = 1.25) -> int:
    """Per-expert dispatch slots: ``ceil(T·k/E · factor)``, floor 1."""
    want = tokens_per_rank * top_k * capacity_factor
    return max(1, int(-(-want // num_experts)))


def _wire(axis: str) -> Optional[str]:
    """The transport policy's wire for ``axis`` (None: the exact
    exchange)."""
    from ..transport import policy as _tpolicy

    res = _tpolicy.resolve_axis(axis)
    return res.fast.wire if res is not None else None


def a2a_wire_bytes(block_shape, dtype: torch.dtype, wire: Optional[str]
                   ) -> int:
    """Bytes one rank puts on the wire for one all-to-all of a block of
    ``block_shape`` (leading dim: the group size) in ``dtype`` over
    ``wire``: the int8 codes and f32 scales of each padded slice, the
    cast payload, or the block itself."""
    ep = int(block_shape[0])
    rest = 1
    for s in block_shape[1:]:
        rest *= int(s)
    if wire == "int8" and dtype.is_floating_point:
        from ..quant.kernels import quant_block_size

        bs = quant_block_size()
        padded = rest + (-rest) % bs
        return ep * padded + ep * (padded // bs) * 4
    if wire in ("bf16", "fp16") and dtype.is_floating_point:
        return ep * rest * 2
    return ep * rest * dtype.itemsize


def _exchange(x: torch.Tensor, ring: _Ring) -> torch.Tensor:
    """Equal-split all-to-all of ``x`` [ep, ...] over the ring's group:
    slice i goes to member i."""
    if ring.size == 1:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=ring.group)
    return out


def _a2a_on_wire(block: torch.Tensor, ring: _Ring, wire: Optional[str]
                 ) -> torch.Tensor:
    """:func:`_exchange` over ``wire``, back in ``block``'s dtype."""
    dtype = block.dtype
    if not dtype.is_floating_point or wire not in ("int8", "bf16", "fp16"):
        return _exchange(block, ring)
    if wire in ("bf16", "fp16"):
        wdt = torch.bfloat16 if wire == "bf16" else torch.float16
        return _exchange(block.to(wdt), ring).to(dtype)
    from ..quant.kernels import (dequantize_flat, quant_block_size,
                                 quantize_flat)

    ep = block.shape[0]
    rest = block.numel() // ep
    bs = quant_block_size()
    pad = (-rest) % bs
    rows = block.reshape(ep, rest).to(torch.float32)
    if pad:
        rows = torch.cat([rows, rows.new_zeros((ep, pad))], dim=1)
    padded = rest + pad
    # Row boundaries align with block boundaries after padding, so one
    # flat quantize covers every member's slice.  On the card the
    # kernels run or raise; the CPU takes their plain versions.
    on_card = block.device.type == "cuda"
    q, scales = quantize_flat(rows.reshape(-1), bs, use_kernels=on_card)
    recv_q = _exchange(q.reshape(ep, padded), ring)
    recv_s = _exchange(scales.reshape(ep, padded // bs), ring)
    out = dequantize_flat(recv_q.reshape(-1), recv_s.reshape(-1), bs,
                          use_kernels=on_card).reshape(ep, padded)
    if pad:
        out = out[:, :rest]
    return out.reshape(block.shape).to(dtype)


def _record_a2a(block: torch.Tensor, wire: Optional[str], axis: str,
                name: str) -> None:
    """Telemetry for one all-to-all: the collective counters and one
    flight-recorder event (no-op with both off)."""
    from ..telemetry import flight_recorder as _frm
    from ..telemetry import instrument as _ti

    rec = _ti.get_recorder()
    flight = _frm.get_flight_recorder()
    if rec is None and flight is None:
        return
    dname = str(block.dtype).rsplit(".", 1)[-1]
    floating = block.dtype.is_floating_point
    label = ("int8_blockwise" if wire == "int8" and floating
             else {"bf16": "bfloat16", "fp16": "float16"}.get(wire, dname)
             if floating else dname)
    nbytes = a2a_wire_bytes(block.shape, block.dtype, wire)
    if rec is not None:
        rec.record_collective("alltoall", dname, label, nbytes, count=1,
                              path="jit", axis=axis)
    if flight is not None:
        flight.record(op="alltoall", name=name, dtype=dname,
                      shape=tuple(int(s) for s in block.shape),
                      nbytes=nbytes, wire=label, path="jit", count=1,
                      axis=axis)


class _AllToAll(torch.autograd.Function):
    """The all-to-all over the wire; its backward is the same all-to-all
    of the cotangent over the same wire."""

    @staticmethod
    def forward(ctx, block, ring, wire, axis, name):
        ctx.opts = (ring, wire, axis, name)
        _record_a2a(block, wire, axis, name)
        return _a2a_on_wire(block, ring, wire)

    @staticmethod
    def backward(ctx, grad):
        ring, wire, axis, name = ctx.opts
        _record_a2a(grad, wire, axis, f"{name}.grad")
        return _a2a_on_wire(grad, ring, wire), None, None, None, None


def _mean_over(x: torch.Tensor, ring: _Ring) -> torch.Tensor:
    """The sum of ``x`` over the group divided by its size."""
    x = x.contiguous().clone()
    dist.all_reduce(x, group=ring.group)
    return x / ring.size


class _GroupMean(torch.autograd.Function):
    """``lax.pmean`` over the group; its transpose is the same mean of
    the cotangents."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        return _mean_over(x, ring)

    @staticmethod
    def backward(ctx, grad):
        return _mean_over(grad, ctx.ring), None


def _group_mean(x: torch.Tensor, ring: _Ring) -> torch.Tensor:
    return x if ring.size == 1 else _GroupMean.apply(x, ring)


def moe_dispatch_combine(tokens: torch.Tensor,
                         router_logits: torch.Tensor,
                         expert_fn: Callable[[torch.Tensor], torch.Tensor],
                         *,
                         group=None,
                         axis: str = "ep",
                         experts_per_rank: int = 1,
                         capacity_factor: Optional[float] = None,
                         top_k: Optional[int] = None
                         ) -> Tuple[torch.Tensor, MoEAux]:
    """Route each token to its top-k experts across the group.

    Every member calls it with its own tokens, in the same order as every
    other collective.

    Args:
      tokens: local tokens ``[T, D]``.
      router_logits: ``[T, E]``, ``E = group size * experts_per_rank``;
        member r holds experts ``[r * experts_per_rank, (r + 1) *
        experts_per_rank)``.
      expert_fn: this member's experts, ``[E_local, N, D] -> [E_local, N,
        D]``.
      group: a ``ProcessGroup``, a ``DeviceMesh`` whose ``axis``
        dimension is taken, or None for the world (a group of one when no
        process group exists).
      axis: the mesh dimension of the experts, and the name the transport
        policy resolves for the wire.
      capacity_factor: per-expert slots = ceil(T·k/E · factor); defaults
        to ``HVDT_MOE_CAPACITY_FACTOR`` (1.25).
      top_k: experts a token, gates renormalised over the chosen k;
        defaults to ``HVDT_MOE_TOPK`` (1, switch routing), read at each
        call.

    Returns (combined ``[T, D]`` in ``tokens``' dtype, :class:`MoEAux`
    averaged over the group).
    """
    if capacity_factor is None:
        capacity_factor = config.get_float("HVDT_MOE_CAPACITY_FACTOR")
    if top_k is None:
        top_k = config.get_int("HVDT_MOE_TOPK")
    k = max(1, int(top_k))
    t, d = tokens.shape
    ring = _Ring(group, axis)
    ep = ring.size
    e_total = ep * experts_per_rank
    if router_logits.shape[-1] != e_total:
        raise ValueError(
            f"router logits last dim {router_logits.shape[-1]} != "
            f"ep*experts_per_rank = {e_total}")
    if k > e_total:
        raise ValueError(f"top_k={k} exceeds {e_total} experts")
    cap = moe_capacity(t, e_total, top_k=k, capacity_factor=capacity_factor)

    probs = torch.softmax(router_logits.float(), dim=-1)
    top_vals, top_idx = torch.topk(probs, k, dim=-1)             # [T, K]
    gates = top_vals / torch.clamp_min(top_vals.sum(-1, keepdim=True), 1e-9)

    # k-major flattening: row k*T + t is token t's k-th choice.
    expert_f = top_idx.t().reshape(-1)                           # [K*T]
    gate_f = gates.t().reshape(-1)
    # Choice i's slot in its expert: how many earlier choices picked it.
    # The one-hot is laid out [E, K*T] so the scan runs along the last
    # dimension, where the card's scan is parallel (along the first
    # dimension of [K*T, E] it gives each of the E columns one thread).
    hot = (torch.arange(e_total, device=expert_f.device)[:, None]
           == expert_f[None, :]).to(torch.int64)                # [E, K*T]
    pos_in_expert = ((hot.cumsum(1) - hot) * hot).sum(0)
    kept = pos_in_expert < cap
    # Kept choices own distinct slots; a dropped one points at the spare
    # row e_total * cap, which is cut off before the exchange.
    slot = torch.where(kept, expert_f * cap + pos_in_expert,
                       torch.full_like(expert_f, e_total * cap))

    tokens_f = tokens.repeat(k, 1)                               # [K*T, D]
    flat = tokens.new_zeros((e_total * cap + 1, d))
    dispatch = flat.index_copy(0, slot, tokens_f)[:-1]
    wire = _wire(axis)
    block = dispatch.reshape(ep, experts_per_rank, cap, d)
    recv = _AllToAll.apply(block, ring, wire, axis, "moe.dispatch")
    recv = recv.transpose(0, 1).reshape(experts_per_rank, ep * cap, d)
    processed = expert_fn(recv)
    processed = processed.reshape(experts_per_rank, ep, cap, d).transpose(
        0, 1)
    back = _AllToAll.apply(processed, ring, wire, axis,
                           "moe.combine").reshape(e_total * cap, d)
    back = torch.cat([back, back.new_zeros((1, d))])

    slots = back[slot] * gate_f.to(tokens.dtype)[:, None]         # [K*T, D]
    out = slots.reshape(k, t, d).sum(0)

    # Switch-transformer load balance over the primary routing, averaged
    # over the group: E * sum_e f_e * P_e.
    primary = torch.nn.functional.one_hot(top_idx[:, 0], e_total).float()
    f = _group_mean(primary.mean(0), ring)
    p_mean = _group_mean(probs.mean(0), ring)
    aux = MoEAux(
        load_balance_loss=e_total * (f * p_mean).sum(),
        dropped_fraction=_group_mean(1.0 - kept.float().mean(), ring))

    from ..telemetry import instrument as _ti

    rec = _ti.get_recorder()
    if rec is not None:
        # Static routing geometry: slot count and the slot/token
        # expansion the capacity factor buys.
        rec.registry.gauge(
            "hvdt_moe_capacity_slots",
            "Per-expert dispatch slots of the last traced MoE layer "
            "(ceil(T*k/E * capacity_factor))").set(float(cap))
        rec.registry.gauge(
            "hvdt_moe_expansion_ratio",
            "Dispatch slots / routed assignments of the last traced "
            "MoE layer (capacity head-room; <1 guarantees drops)"
        ).set(float(cap * e_total) / float(t * k))
    return out, aux


def report_moe_aux(aux: MoEAux, *, step: Optional[int] = None) -> None:
    """Host-side per-step reporter for the routing aux outputs.

    The step returns ``MoEAux`` as tensors; the train loop calls this
    after the step to surface them as ``hvdt_moe_*`` gauges (the
    history and anomaly layers pick the gauges up from the registry).
    Reading them waits for the device.  No-op when telemetry is off."""
    from ..telemetry import instrument as _ti

    rec = _ti.get_recorder()
    if rec is None:
        return
    del step
    rec.registry.gauge(
        "hvdt_moe_load_balance_loss",
        "Switch-transformer load-balance aux loss of the last "
        "reported step (E * sum_e f_e * P_e)").set(
        float(aux.load_balance_loss))
    rec.registry.gauge(
        "hvdt_moe_dropped_fraction",
        "Fraction of routed token assignments dropped over expert "
        "capacity in the last reported step").set(
        float(aux.dropped_fraction))
