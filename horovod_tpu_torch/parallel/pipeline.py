"""Pipeline parallelism: the 1F1B microbatch clock over a process group.

The PyTorch counterpart of the JAX package's ``parallel/pipeline.py``.
Each member of a process group (the ``pp`` dimension of a mesh) runs one
stage; activations move to the next stage with point-to-point sends
(``dist.isend`` / ``dist.irecv``, as ``parallel/ring_attention.py``
moves K/V).  The clock is the reference's: ``m + p - 1`` ticks, stage
``s`` busy on ticks ``s .. s + m - 1`` with microbatch ``tick - s``, so
the first ``p - 1`` ticks fill the pipeline (warmup), the middle ones
keep every stage busy (steady) and the last ``p - 1`` drain it
(cooldown).  A stage computes only on its busy ticks; the reference
computes on every tick and zeroes the bubble, which gives the same
values.

Differentiation keeps the reference's semantics, which is ``jax.grad``
through its scans: the whole forward clock, then the mirrored reverse
clock.  :func:`pipeline_1f1b` is one ``torch.autograd.Function``; its
forward runs every busy tick's stage under autograd and keeps the graph,
and its backward walks the ticks in reverse, each stage taking the
cotangent of its output from the next stage (the last stage: from the
pipeline's output), running the stage's backward and sending the
cotangent of its input to the previous stage.  Two transposes:

* ``broadcast_out=True`` sends the last stage's outputs to every member
  (the reference's psum of the masked outputs).  Its backward gives the
  last stage one cotangent, the mean of the members' cotangents: with
  the reference's loss averaged over ``pp`` the psum's transpose sums
  cotangents that each carry ``1 / pp``.
* The microbatches are replicated over the group and only stage 0 reads
  them, so their cotangent (stage 0's) is sent to every member, as the
  transpose of the reference's replicated input is a psum over ``pp``.

So when every member computes the same loss from the broadcast output,
each one ends the backward holding the reference's gradient: the whole
gradient of the microbatches (and of whatever is replicated before the
pipeline) and the slice of it that belongs to its stage's parameters.

Telemetry, as in the reference: each forward books the schedule's
per-stage phase histograms (in tick units), the clock's ``ppermute``
bytes (``path="jit"``, the ``pp`` axis) and one flight-recorder event
per clock segment; :func:`report_pipeline_mfu` sets
``hvdt_pipeline_mfu``.

Inside a ``step_pipeline.donated_step`` capture the pipeline is captured
as it runs eagerly: the clock is fixed by ``(p, m)``, so the graph is the
eager clock's sequence of stage kernels and NCCL P2P transfers, a wait
on a transfer a stream wait, and the schedule's records are booked
before each replay (``graphs.on_replay``); a capture by other means
raises.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from ..common import config, graphs
from .ring_attention import _Ring

__all__ = ["pipeline_1f1b", "pipeline_spmd", "bubble_fraction",
           "report_pipeline_mfu", "NOMINAL_SIM_PEAK_FLOPS"]

# The reference's nominal peak for its CPU simulation (the
# ``HVDT_PEAK_FLOPS`` default): MFU is a ratio, any consistent value works.
NOMINAL_SIM_PEAK_FLOPS = 1e12


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """Idle ÷ total stage-ticks of the 1F1B clock: ``(p-1)/(m+p-1)``."""
    p, m = int(num_stages), int(num_microbatches)
    if p < 1 or m < 1:
        raise ValueError(f"need p >= 1 and m >= 1, got ({p}, {m})")
    return (p - 1) / (m + p - 1)


def _record_schedule(axis: str, p: int, m: int, tick_bytes: int,
                     dtype: str = "float32") -> None:
    """Booking of one pipeline schedule: per-stage phase histograms in
    tick units + one flight-recorder send/recv event per clock
    segment (no-op with both recorders off)."""
    from ..telemetry import flight_recorder as _frm
    from ..telemetry import instrument as _ti

    rec = _ti.get_recorder()
    flight = _frm.get_flight_recorder()
    if rec is None and flight is None:
        return
    ticks = m + p - 1
    warmup = p - 1
    steady = max(0, m - (p - 1))
    cooldown = ticks - warmup - steady
    if rec is not None:
        for s in range(p):
            # Tick units: the idle/total ratio (the observed bubble
            # fraction) is unit-free.
            rec.observe_phase(f"PIPELINE_STAGE{s}_WARMUP", float(s))
            rec.observe_phase(f"PIPELINE_STAGE{s}_ACTIVE", float(m))
            rec.observe_phase(f"PIPELINE_STAGE{s}_COOLDOWN",
                              float(p - 1 - s))
        rec.record_collective(
            "ppermute", dtype, "exact", tick_bytes * ticks,
            count=ticks, path="jit", axis=axis)
    if flight is not None:
        for seg, n in (("warmup", warmup), ("steady", steady),
                       ("cooldown", cooldown)):
            if n <= 0:
                continue
            flight.record(
                op="ppermute", name=f"pipeline.{seg}",
                dtype=dtype, shape=(int(tick_bytes),),
                nbytes=tick_bytes * n, wire="exact", path="jit",
                count=n, axis=axis)


def _recv(like: torch.Tensor, src: int, ring: _Ring) -> torch.Tensor:
    buf = torch.empty_like(like)
    dist.irecv(buf, src, group=ring.group).wait()
    return buf


class _Pipeline(torch.autograd.Function):
    """The forward clock; its backward is the reverse clock (module
    docstring).  ``leaves`` are the stage parameters' tensors."""

    @staticmethod
    def forward(ctx, microbatches, ring, stage_fn, spec, broadcast_out,
                graph, *leaves):
        p, me, m = ring.size, ring.rank, microbatches.shape[0]
        mine = [t.detach().requires_grad_(t.requires_grad) for t in leaves]
        params = pytree.tree_unflatten(mine, spec)
        sends, saved = [], []
        out = torch.zeros_like(microbatches)
        with torch.enable_grad() if graph else torch.no_grad():
            for mb in range(m):          # stage `me` runs tick me + mb
                if me == 0:
                    x = microbatches[mb].detach().requires_grad_(
                        graph and microbatches.requires_grad)
                else:
                    # The previous stage sends this input's cotangent
                    # back, so it always takes one.
                    x = _recv(microbatches[0], ring.prev,
                              ring).requires_grad_(graph)
                y = stage_fn(params, x)
                if y.shape != x.shape or y.dtype != x.dtype:
                    raise ValueError(
                        f"a stage must keep its input's shape and dtype: "
                        f"{tuple(x.shape)} {x.dtype} -> {tuple(y.shape)} "
                        f"{y.dtype}")
                if graph:
                    saved.append((x, y))
                if me < p - 1:
                    sends.append((dist.isend(y.detach().contiguous(),
                                             ring.next, group=ring.group),
                                  y))
                else:
                    out[mb] = y.detach()
        for work, _ in sends:
            work.wait()
        if broadcast_out and p > 1:
            dist.broadcast(out, dist.get_global_rank(ring.group, p - 1),
                           group=ring.group)
        ctx.ring, ctx.broadcast_out = ring, broadcast_out
        ctx.saved, ctx.mine = saved, mine
        return out

    @staticmethod
    def backward(ctx, grad_out):
        ring, saved, mine = ctx.ring, ctx.saved, ctx.mine
        p, me, m = ring.size, ring.rank, len(saved)
        grad_out = grad_out.contiguous()
        if ctx.broadcast_out and p > 1:
            grad_out = grad_out.clone()
            dist.all_reduce(grad_out, group=ring.group)
            grad_out /= p
        wants = [t for t in mine if t.requires_grad]
        grads: List[Optional[torch.Tensor]] = [None] * len(wants)
        d_mb = torch.zeros_like(grad_out) if ctx.needs_input_grad[0] \
            else None
        sends = []
        for mb in reversed(range(m)):
            x, y = saved[mb]
            gy = (grad_out[mb] if me == p - 1
                  else _recv(y.detach(), ring.next, ring))
            inputs = ([x] if x.requires_grad else []) + wants
            got = (torch.autograd.grad(y, inputs, gy, allow_unused=True)
                   if inputs and y.requires_grad else [None] * len(inputs))
            if x.requires_grad:
                dx, got = got[0], got[1:]
                if dx is None:
                    dx = torch.zeros_like(x)
                if me > 0:
                    dx = dx.contiguous()
                    sends.append((dist.isend(dx, ring.prev,
                                             group=ring.group), dx))
                else:
                    d_mb[mb] = dx
            for i, g in enumerate(got):
                if g is not None:
                    grads[i] = g if grads[i] is None else grads[i] + g
        for work, _ in sends:
            work.wait()
        ctx.saved = ()
        if d_mb is not None and p > 1:
            dist.broadcast(d_mb, dist.get_global_rank(ring.group, 0),
                           group=ring.group)
        it = iter(grads)
        leaf_grads = [next(it) if t.requires_grad else None for t in mine]
        return (d_mb, None, None, None, None, None, *leaf_grads)


def pipeline_1f1b(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                  stage_params: Any,
                  microbatches: torch.Tensor,
                  *,
                  group=None,
                  axis: str = "pp",
                  broadcast_out: bool = True) -> torch.Tensor:
    """Run ``stage_fn`` as one pipeline stage per group member, on the
    1F1B warmup / steady / cooldown clock.

    Every member calls it, in the same order as every other collective.

    Args:
      stage_fn: ``(params, x) -> y`` mapping one microbatch through this
        member's stage; ``y`` has ``x``'s shape and dtype.
      stage_params: this member's stage parameters (a tensor, or a
        list / tuple / dict of them).
      microbatches: ``[M, mb, ...]`` activations, the same on every
        member (stage 0 reads them).
      group: a ``ProcessGroup``, a ``DeviceMesh`` whose ``axis``
        dimension is taken, or None for the world (a group of one when no
        process group exists).  Member r runs stage r.
      broadcast_out: True sends the last stage's outputs to every member
        (the loss is then computed on each); False leaves zeros on the
        others.

    Returns ``[M, mb, ...]``: the last stage's outputs.
    """
    leaves, spec = pytree.tree_flatten(stage_params)
    if not all(isinstance(t, torch.Tensor) for t in leaves):
        raise TypeError("stage_params must be a tensor or a list / tuple / "
                        "dict of tensors")
    # Without autograd (an evaluation, the bench's forward) the stages
    # keep no graph.
    graph = torch.is_grad_enabled() and (
        microbatches.requires_grad or any(t.requires_grad for t in leaves))
    ring = _Ring(group, axis)
    book = functools.partial(
        _record_schedule, axis, ring.size, microbatches.shape[0],
        microbatches[0].numel() * microbatches.element_size(),
        dtype=str(microbatches.dtype).rsplit(".", 1)[-1])
    if graphs.capturing():
        graphs.on_replay(book)
    else:
        book()
    return _Pipeline.apply(microbatches, ring, stage_fn, spec,
                           bool(broadcast_out), graph, *leaves)


def pipeline_spmd(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                  stage_params: Any,
                  microbatches: torch.Tensor,
                  *,
                  group=None,
                  axis: str = "pp",
                  broadcast_out: bool = True) -> torch.Tensor:
    """The reference's alias of :func:`pipeline_1f1b` (same contract,
    same outputs)."""
    return pipeline_1f1b(stage_fn, stage_params, microbatches, group=group,
                         axis=axis, broadcast_out=broadcast_out)


def report_pipeline_mfu(flops_per_step: float, step_seconds: float,
                        peak_flops_per_sec: Optional[float] = None
                        ) -> float:
    """Model FLOPs utilization: achieved FLOP/s ÷ peak, as the
    ``hvdt_pipeline_mfu`` gauge.  The peak defaults to
    ``HVDT_PEAK_FLOPS`` (the reference's nominal 1e12).  Returns the
    computed MFU; no gauge write when telemetry is off."""
    if peak_flops_per_sec is None:
        peak_flops_per_sec = config.get_float("HVDT_PEAK_FLOPS")
    mfu = float(flops_per_step) / (float(step_seconds)
                                   * float(peak_flops_per_sec))
    from ..telemetry import instrument as _ti

    rec = _ti.get_recorder()
    if rec is not None:
        rec.registry.gauge(
            "hvdt_pipeline_mfu",
            "Model FLOPs utilization of the last reported pipeline "
            "step (achieved model FLOP/s / peak FLOP/s)").set(mfu)
    return mfu
