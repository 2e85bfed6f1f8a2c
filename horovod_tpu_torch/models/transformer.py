"""Decoder-only Transformer LM: the PyTorch counterpart of the JAX
package's ``models/transformer.py`` (training path).

Same configuration, parameter names, initialisation scheme and numerics
as the reference:

* bf16 compute, f32 parameters; ``_proj`` casts the weight to the
  activation dtype and keeps its output there (``x @ w`` with ``w`` as
  [in, out], so weights carry over from the JAX package without
  transposes);
* ``_rmsnorm`` takes the mean square in f32 and multiplies in the
  activation dtype; ``_rope`` rotates in f32 and casts back;
* block parameters stay stacked ``[layers, ...]`` as the reference keeps
  them for ``lax.scan``: ``embed``, ``ln_f`` and ``block.<name>`` are
  the module's parameters, so an optimizer sees 11 leaves and
  ``convert.transformer_params_from_jax`` is a copy.  The layer loop
  unbinds each stacked leaf once per forward (indexing ``p[i]`` in the
  loop would make autograd build a full-size zero gradient per layer);
* ``remat=True`` (``remat_policy="full"``) is ``jax.checkpoint`` per
  block in the reference and ``torch.utils.checkpoint`` per layer here;
  the recompute runs the attention forward a second time;
* attention goes through the kernels of ``ops/pallas_kernels.py`` when
  :func:`_flash_fn` picks them, in the reference's order:
  ``HVDT_FLASH_ATTENTION=off`` turns every kernel off and ``on`` forces
  the streaming flash kernel; otherwise ``HVDT_FLASH_SMALLSEQ`` picks the
  whole-sequence kernels (``flash_attention_smallseq``, ``on`` for seq %
  128 == 0 up to 1024, ``auto`` disengaged while no measured threshold is
  set), then ``HVDT_FLASH_ATTENTION=auto`` engages the streaming kernel on
  CUDA tensors when the f32 score tensor would reach 4 GiB (the
  reference's gates, with "on the TPU" read as "on the card"); otherwise
  the materialized-score softmax.  On the CPU the kernels' plain versions
  run;
* the loss runs the full sequence and drops the last position; with
  ``loss_chunk`` the vocab is walked in checkpointed chunks with an
  online logsumexp (logits rounded to bf16 before the f32 math, the
  padded vocab masked with -inf).

Sequence parallelism (``cfg.sp > 1``) runs attention as the exact ring
of ``parallel/ring_attention.py`` (on the card through kernels #9-#11,
its default there) over the ``sp_group=`` that
:func:`transformer_hidden`, :func:`transformer_apply`,
:func:`transformer_loss` and ``Transformer.forward`` take (a process
group, or a mesh whose ``sp`` dimension is taken; required when ``sp >
1``, of size ``sp``).  Each member passes its local shard of the tokens,
positions are offset by ``sp_rank * local_seq``, and the loss is the
local shard's loss, as in the reference: the caller averages it over the
ring (the reference's example takes ``lax.pmean`` over ``sp``).  The
gradients each member's backward leaves are its share of the gradient of
the ring's summed loss, so ``DistributedOptimizer``'s average over the
whole world (dp x sp ranks) is the reference's gradient of the sp-mean
loss averaged over dp.  Under ``remat`` the recompute runs the forward
ring again, with its transfers, on every member in the same order.

``HVDT_FP8=matmul`` runs every projection through the e4m3 product of
``quant/fp8.py``.

MoE (``num_experts > 0``) makes every block's MLP a mixture of experts
with the reference's stacked leaves ``w_router`` [L, d, E], ``w_up`` [L,
E, d, f] and ``w_down`` [L, E, f, d].  With ``ep == 1`` it is the
reference's dense fallback (argmax top-1, the gate the raw softmax
probability, no capacity); with ``ep > 1`` the tokens go through
``parallel.moe_dispatch_combine`` over ``ep_group=`` (a process group,
or a mesh whose ``ep`` dimension is taken), the experts' two products as
``torch.bmm``.  Each member of the ``ep`` group passes its own tokens
(the tokens are sharded over ``ep``) and holds only its ``E / ep``
experts.  An ``ep_group`` of one with ``ep == 1`` takes the routed path
with every expert local (capacity and all), as ``moe_dispatch_combine``
in a group of one does in the reference.  As in the reference, at
``top_k = 1`` the ``ep > 1`` gate is identically 1 (the router gets no
gradient from the loss), the load-balance loss is not added to the
model's loss, and ``HVDT_MOE_TOPK`` is read at each call.

``pp > 1`` runs the blocks as ``parallel.pipeline_1f1b`` over
``pp_group=``: every stage embeds, the batch is cut into ``m = pp``
microbatches, member s holds and runs layers ``[s * L / pp, (s + 1) * L
/ pp)``, and every stage applies ``ln_f`` and the loss to the broadcast
output.  ``parallel.mark_sharded`` records the leaves each member holds a
slice of (every block leaf over ``pp``, the experts also over ``ep``),
which ``DistributedOptimizer(axis=, pipeline=, expert=)`` reads.  On
the card attention runs the port's kernels inside the pipeline and the
MoE blocks; the reference falls back to XLA attention inside its
``shard_map`` islands, which computes the same function.

``sp > 1`` composes with ``dp``, ``ep`` and ``pp`` as in the reference,
which builds all of them from one ``transformer_hidden`` (manual axes
``sp`` and ``ep``, ``pipeline_spmd`` over ``pp``): with ``ep > 1`` the ring
runs inside the MoE blocks (the member's tokens are its batch rows and
its shard of the sequence; the all-to-all goes over ``ep`` between the
members that hold the same shard), with ``pp > 1`` inside each stage (the
stage's members form the ring; the pipeline moves activations between
the members of one ``sp`` index).  ``DistributedOptimizer(axis="dp")``
then averages a replicated leaf over ``sp`` (and ``ep``) before the
exchange over ``dp``.

Tensor parallelism (``cfg.tp > 1``, ``tp_group=``) is Megatron's layout
under the reference's rules (``parallel.transformer_rules``: ``heads``
and ``mlp`` over ``tp``, ``kv``, ``vocab`` and ``embed`` replicated):
``wq`` and the MLP's ``w_up`` / ``w_gate`` are column-parallel (each
member holds its heads' / its ``d_ff / tp`` columns), ``wo`` and
``w_down`` row-parallel, with a sum over ``tp`` after each.  The two
conjugate operations are autograd Functions: at the column entry the
identity forward whose backward all-reduces the input's gradient
(:class:`_TpEnter`), after the row product the all-reduce forward whose
backward is the identity (:class:`_TpLeave`).  ``wk`` / ``wv`` stay whole
on every member; each member takes its ``kv_heads / tp`` heads' columns
through :class:`_TpColumns` (the slice forward, the all-gather of the
slices' gradients backward), so every member ends the backward with the
whole gradient of every replicated leaf (``embed``, the norms, ``wk`` /
``wv``), equal on all of them.  Attention runs on the member's ``heads /
tp`` local heads through the same :func:`_flash_fn` choice, taken on the
local batch and heads (the reference's island plan).  The same tokens
go to every ``tp`` member.

Fully-sharded data parallelism (``cfg.fsdp > 1``, ``fsdp_group=``) follows
``transformer_rules(fsdp=True)``: every leaf with an ``embed`` dimension
holds ``d_model / fsdp`` of it on each member, the batch shards over
(``dp``, ``fsdp``).  Each block all-gathers its leaves over ``fsdp`` just
before use (:class:`_FsdpGather`: the all-gather forward, the
reduce-scatter of the gradient backward) and drops the whole weights
after it; the ``embed`` gather serves the lookup and the tied logits or
chunked loss.  Under ``remat`` the gather is inside the checkpointed
block, so the recompute gathers again and no layer's whole weights live
across the step (without ``remat`` autograd keeps each layer's
activation-dtype copy for the backward).  This is the port's per-layer
ZeRO-3, the reference's ``fsdp_shardings`` path under GSPMD; the ZeRO
``params`` stage (``ops/zero.py``) keeps its once-a-step gather, as the
reference's ``shard_map`` path does.  ``fsdp`` and ``tp`` compose: the
gather over ``fsdp`` gives the ``tp``-local weight.  A member's gradient
of an ``fsdp``-sharded leaf is the sum over ``fsdp`` of the members'
gradients of their own tokens' losses; ``DistributedOptimizer(axis=
"dp")`` divides it by the ``fsdp`` size and averages the replicated
leaves over ``fsdp``.

``tp`` with experts follows the reference's expert layout
(``("stages", "experts", "embed", "mlp")`` / ``("stages", "experts",
"mlp", "embed")``, ``mlp`` over ``tp``, ``experts`` over ``ep``): each
expert's two products run on the member's ``d_ff / tp`` columns, the
expert input enters through :class:`_TpEnter` and the down projection's
partial output leaves through :class:`_TpLeave`, as in the dense MLP.
The router stays replicated over ``tp``, so every member routes the
same tokens the same way.

``remat_policy="dots"`` (``HVDT_REMAT=dots``) is the reference's
``dots_with_no_batch_dims_saveable``: ``torch.utils.checkpoint`` with a
selective-checkpoint policy that saves the outputs of products without
batch dimensions (``aten.mm`` / ``aten.addmm``, which ``x @ w`` reaches,
and ``aten._scaled_mm`` under ``HVDT_FP8=matmul``) and recomputes the
rest: norms, RoPE, SiLU, the batched products (``bmm``: the expert
products, the materialized scores) and the attention kernels'
autograd Functions.  The paged serving functions are not defined here
yet (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Mapping, Optional, Union

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..common import config
from ..common.basics import DeviceLike, resolve_device
from ..ops.pallas_kernels import flash_attention, flash_attention_smallseq
from ..parallel.mesh import mark_sharded
from ..parallel.moe import moe_dispatch_combine
from ..parallel.pipeline import pipeline_1f1b
from ..parallel.ring_attention import _Ring, ring_attention
from ..parallel.sharding import (local_part, logical_to_mesh,
                                 transformer_rules)
from ..quant import fp8 as _fp8

__all__ = [
    "TransformerConfig", "Transformer", "transformer_init",
    "transformer_hidden", "transformer_apply", "transformer_loss",
    "transformer_logical_axes", "transformer_flops_per_token",
    "remat_from_env", "checkpoint_policy",
]

_REMAT_MODES = ("none", "full", "dots")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 32000
    layers: int = 4
    d_model: int = 512
    heads: int = 8
    kv_heads: int = 8            # < heads ⇒ GQA
    d_ff: int = 2048
    max_seq: int = 2048
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16    # activation/compute dtype
    param_dtype: torch.dtype = torch.float32
    # MoE: num_experts == 0 is the dense MLP; every block is MoE when on.
    num_experts: int = 0
    capacity_factor: float = 1.25
    sp: int = 1                  # sequence-parallel degree (ring attention)
    ep: int = 1                  # expert-parallel degree
    pp: int = 1                  # pipeline stages (layers % pp == 0)
    tp: int = 1                  # tensor-parallel degree (Megatron layers)
    fsdp: int = 1                # fully-sharded degree (embed dims sharded)
    remat: bool = False          # torch.utils.checkpoint each block
    remat_policy: str = "full"   # "full" or "dots" when remat
    loss_chunk: int = 0          # >0: chunked-vocab cross entropy

    @property
    def head_dim(self) -> int:
        return self.d_model // self.heads

    @property
    def layers_per_stage(self) -> int:
        assert self.layers % max(self.pp, 1) == 0
        return self.layers // max(self.pp, 1)


def _moe_ep(cfg: TransformerConfig) -> bool:
    """Whether the blocks route tokens over an ``ep`` group."""
    return bool(cfg.num_experts) and cfg.ep > 1


def _check_supported(cfg: TransformerConfig) -> None:
    for what, n in (("heads", cfg.heads), ("kv_heads", cfg.kv_heads),
                    ("d_ff", cfg.d_ff)):
        if n % max(cfg.tp, 1):
            raise ValueError(f"{what} {n} not divisible by tp {cfg.tp}")
    if cfg.d_model % max(cfg.fsdp, 1):
        raise ValueError(f"d_model {cfg.d_model} not divisible by fsdp "
                         f"{cfg.fsdp}")
    if cfg.layers % max(cfg.pp, 1):
        raise ValueError(f"layers {cfg.layers} not divisible by pp {cfg.pp}")
    if _moe_ep(cfg) and cfg.num_experts % cfg.ep:
        raise ValueError(f"num_experts {cfg.num_experts} not divisible by "
                         f"ep {cfg.ep}")
    if cfg.remat and cfg.remat_policy not in ("full", "dots"):
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r} "
                         "(expected 'full' or 'dots')")


def _logical_axes(moe: bool) -> dict:
    """The reference's logical axes of each leaf (see
    :func:`transformer_logical_axes`)."""
    block = {
        "ln1": ("stages", None),
        "ln2": ("stages", None),
        "wq": ("stages", "embed", "heads"),
        "wk": ("stages", "embed", "kv"),
        "wv": ("stages", "embed", "kv"),
        "wo": ("stages", "heads", "embed"),
    }
    if moe:
        block["w_router"] = ("stages", "embed", None)
        block["w_up"] = ("stages", "experts", "embed", "mlp")
        block["w_down"] = ("stages", "experts", "mlp", "embed")
    else:
        block["w_up"] = ("stages", "embed", "mlp")
        block["w_gate"] = ("stages", "embed", "mlp")
        block["w_down"] = ("stages", "mlp", "embed")
    return {"embed": ("vocab", "embed"), "ln_f": (None,), "block": block}


def _axis_sizes(cfg: TransformerConfig) -> dict:
    """The sizes of the mesh axes that shard the parameters."""
    return {"pp": cfg.pp, "ep": cfg.ep if cfg.num_experts else 1,
            "tp": cfg.tp, "fsdp": cfg.fsdp}


def _rules(cfg: TransformerConfig) -> dict:
    return transformer_rules(fsdp=cfg.fsdp > 1)


def _leaf_logical(name: str, cfg: TransformerConfig) -> tuple:
    axes = _logical_axes(bool(cfg.num_experts))
    if name in ("embed", "ln_f"):
        return axes[name]
    return axes["block"].get(name, ("stages", None))


def leaf_spec(name: str, cfg: TransformerConfig) -> tuple:
    """The mesh-axis spec (``parallel.logical_to_mesh``) of the leaf
    ``name`` (``embed``, ``ln_f`` or a block leaf's name) under ``cfg``'s
    ``pp`` / ``ep`` / ``tp`` / ``fsdp`` sizes and the reference's rules."""
    return logical_to_mesh(_leaf_logical(name, cfg), _rules(cfg),
                           _axis_sizes(cfg))


def local_slice(name: str, leaf, cfg: TransformerConfig, pp_rank: int = 0,
                ep_rank: int = 0, tp_rank: int = 0, fsdp_rank: int = 0):
    """The part of the global leaf ``name`` (``embed``, ``ln_f`` or a block
    leaf, stacked [layers, ...]) that the member ``(pp_rank, ep_rank,
    tp_rank, fsdp_rank)`` holds under the reference's rules
    (``parallel.local_part``): its stage's layers under ``pp > 1``, its
    experts under ``ep > 1``, its heads' or MLP columns / rows under ``tp
    > 1`` and its part of the ``embed`` dimension under ``fsdp > 1``.
    Works on tensors (a view) and numpy arrays."""
    return local_part(leaf, _leaf_logical(name, cfg), _rules(cfg),
                      _axis_sizes(cfg), dict(pp=pp_rank, ep=ep_rank,
                                             tp=tp_rank, fsdp=fsdp_rank))


class Transformer(nn.Module):
    """The LM's parameters with the reference's names: ``embed``
    [vocab, d], ``ln_f`` [d], and the stacked ``block.<name>``
    [layers, ...] (``ln1``, ``ln2``, ``wq``, ``wk``, ``wv``, ``wo``, and
    ``w_up``, ``w_gate``, ``w_down`` or, with experts, ``w_router``,
    ``w_up``, ``w_down``).  Under ``pp`` / ``ep`` / ``tp`` / ``fsdp`` it
    holds the part of member ``(pp_rank, ep_rank, tp_rank, fsdp_rank)``
    (:func:`local_slice`) of the global parameters the same generator
    draws, and ``parallel.mark_sharded`` records the axes each leaf is
    sharded over.  ``forward`` returns f32 logits."""

    def __init__(self, cfg: TransformerConfig,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None, *, pp_rank: int = 0,
                 ep_rank: int = 0, tp_rank: int = 0, fsdp_rank: int = 0):
        super().__init__()
        _check_supported(cfg)
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator()
        self.cfg, self.pp_rank, self.ep_rank = cfg, pp_rank, ep_rank
        self.tp_rank, self.fsdp_rank = tp_rank, fsdp_rank
        d, h, hk, dh, f = (cfg.d_model, cfg.heads, cfg.kv_heads,
                           cfg.head_dim, cfg.d_ff)
        n, pd = cfg.layers, cfg.param_dtype
        ranks = dict(pp_rank=pp_rank, ep_rank=ep_rank, tp_rank=tp_rank,
                     fsdp_rank=fsdp_rank)

        def part(name, whole):
            # Drawn whole, so every layout holds parts of one model.
            mine = local_slice(name, whole, cfg, **ranks)
            return mine.to(pd, copy=mine.numel() != whole.numel())

        def linear(name, fan_in, *shape):
            return part(name, torch.randn((n, *shape), generator=gen)
                        * fan_in ** -0.5)

        def ones(*shape):
            return part("ln1", torch.ones((n, *shape), dtype=pd))

        self.embed = nn.Parameter(part(
            "embed", torch.randn((cfg.vocab, d), generator=gen) * 0.02))
        self.ln_f = nn.Parameter(torch.ones(d, dtype=pd))
        block = {
            "ln1": ones(d),
            "ln2": ones(d),
            "wq": linear("wq", d, d, h * dh),
            "wk": linear("wk", d, d, hk * dh),
            "wv": linear("wv", d, d, hk * dh),
            "wo": linear("wo", h * dh, h * dh, d),
        }
        if cfg.num_experts:
            e = cfg.num_experts
            block["w_router"] = linear("w_router", d, d, e)
            block["w_up"] = linear("w_up", d, e, d, f)
            block["w_down"] = linear("w_down", f, e, f, d)
        else:
            block["w_up"] = linear("w_up", d, d, f)
            block["w_gate"] = linear("w_gate", d, d, f)
            block["w_down"] = linear("w_down", f, f, d)
        self.block = nn.ParameterDict(block)
        for name, leaf in self.named_parameters():
            axes = [a for entry in leaf_spec(name.split(".")[-1], cfg)
                    for a in ((entry,) if isinstance(entry, str)
                              else entry or ())]
            if axes:
                mark_sharded(leaf, *axes)
        self.to(dev)

    def forward(self, tokens: torch.Tensor, *, sp_group=None,
                ep_group=None, pp_group=None, tp_group=None,
                fsdp_group=None) -> torch.Tensor:
        return transformer_apply(self, tokens, self.cfg, sp_group=sp_group,
                                 ep_group=ep_group, pp_group=pp_group,
                                 tp_group=tp_group, fsdp_group=fsdp_group)


def transformer_init(seed: Union[int, torch.Generator],
                     cfg: TransformerConfig,
                     device: DeviceLike = None, *, pp_rank: int = 0,
                     ep_rank: int = 0, tp_rank: int = 0,
                     fsdp_rank: int = 0) -> Transformer:
    """A :class:`Transformer` with random weights drawn on the CPU from
    ``seed`` (an int or a ``torch.Generator``) as the reference draws
    them (normal · fan_in^-0.5, embed normal · 0.02, norms 1), placed on
    ``device`` (the card unless the caller names another).  Under ``pp``
    / ``ep`` / ``tp`` / ``fsdp`` the module holds member ``(pp_rank,
    ep_rank, tp_rank, fsdp_rank)``'s part of the model the same seed
    draws with every degree 1."""
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    return Transformer(cfg, generator=gen, device=device, pp_rank=pp_rank,
                       ep_rank=ep_rank, tp_rank=tp_rank, fsdp_rank=fsdp_rank)


def transformer_logical_axes(cfg: TransformerConfig) -> dict:
    """The reference's logical axis names of each leaf (None: a
    replicated dimension): the stacked-layers dimension is ``stages``
    (sharded over ``pp``), the expert dimension ``experts`` (over
    ``ep``); ``parallel.transformer_rules`` maps the rest."""
    return _logical_axes(bool(cfg.num_experts))


def _rmsnorm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6)).to(x.dtype) * g.to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """x: [B, L, H, D]; positions: [B, L] global token positions."""
    d2 = x.shape[-1] // 2
    freqs = torch.pow(1.0 / theta, torch.arange(d2, dtype=torch.float32,
                                                 device=x.device) / d2)
    ang = positions[..., None].float() * freqs              # [B, L, d2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     -1).to(x.dtype)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dense projection ``x @ w`` in the activation dtype; with
    ``HVDT_FP8=matmul`` on a build and card that run e4m3 GEMMs, the
    per-tensor-scaled fp8 product (``quant/fp8.py``), otherwise exactly
    the plain matmul.  The gate is read at each call."""
    if _fp8.matmul_enabled():
        return _fp8.fp8_matmul(x, w)
    return x @ w.to(x.dtype)


# ---- the tp and fsdp collectives ---------------------------------------------


def _all_gather_dim(t: torch.Tensor, ring: _Ring, dim: int) -> torch.Tensor:
    """The members' ``t`` concatenated along ``dim``, in member order."""
    t = t.contiguous()
    out = t.new_empty((ring.size * t.numel(),))
    dist.all_gather_into_tensor(out, t.reshape(-1), group=ring.group)
    parts = out.view(ring.size, *t.shape)
    if dim == 0:
        return parts.reshape(ring.size * t.shape[0], *t.shape[1:])
    return torch.cat(parts.unbind(0), dim)


def _reduce_scatter_dim(t: torch.Tensor, ring: _Ring, dim: int
                        ) -> torch.Tensor:
    """The sum over the members of ``t``, cut along ``dim`` into
    ``ring.size`` blocks: this member's block."""
    n = ring.size
    stacked = (t.contiguous() if dim == 0
               else torch.stack(t.chunk(n, dim))).reshape(-1)
    out = t.new_empty((t.numel() // n,))
    dist.reduce_scatter_tensor(out, stacked, group=ring.group)
    shape = list(t.shape)
    shape[dim] //= n
    return out.view(shape)


class _FsdpGather(torch.autograd.Function):
    """A leaf's whole weight from the members' shards along ``dim``: the
    all-gather forward; backward, the reduce-scatter (sum) of its
    gradient, which leaves each member the sum over ``fsdp`` of every
    member's gradient of its shard."""

    @staticmethod
    def forward(ctx, shard, ring, dim):
        ctx.ring, ctx.dim = ring, dim
        return _all_gather_dim(shard, ring, dim)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter_dim(grad, ctx.ring, ctx.dim), None, None


class _TpEnter(torch.autograd.Function):
    """The column-parallel entry: identity forward; backward, the sum
    over ``tp`` of the members' gradients of the (replicated) input."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.ring.group)
        return grad, None


class _TpLeave(torch.autograd.Function):
    """After a row-parallel product: the sum over ``tp`` of the members'
    partial outputs forward; identity backward."""

    @staticmethod
    def forward(ctx, y, ring):
        y = y.contiguous().clone()
        dist.all_reduce(y, group=ring.group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _TpColumns(torch.autograd.Function):
    """A replicated weight's columns of this ``tp`` member (``1 / tp`` of
    the last dimension): the slice forward; backward, the members'
    gradients of their columns all-gathered into the whole gradient,
    the same on every member."""

    @staticmethod
    def forward(ctx, w, ring):
        ctx.ring = ring
        c = w.shape[-1] // ring.size
        return w[..., ring.rank * c:(ring.rank + 1) * c].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _all_gather_dim(grad, ctx.ring, grad.dim() - 1), None


@dataclasses.dataclass(frozen=True)
class _Layout:
    """The resolved ``tp`` / ``fsdp`` groups of one call (None: the axis
    has one member) and, per block leaf, the dimension of its per-layer
    slice that is sharded over ``fsdp`` (None: replicated)."""

    tp: Optional[_Ring]
    fsdp: Optional[_Ring]
    fsdp_dims: Mapping[str, Optional[int]]


def _fsdp_dim(name: str, cfg: TransformerConfig) -> Optional[int]:
    for dim, entry in enumerate(leaf_spec(name, cfg)):
        if entry == "fsdp" or (isinstance(entry, tuple) and "fsdp" in entry):
            return dim
    return None


def _gather_block(p: Mapping[str, torch.Tensor], layout: Optional[_Layout]):
    """One layer's leaves with the ``fsdp``-sharded ones gathered whole."""
    if layout is None or layout.fsdp is None:
        return p
    out = {}
    for name, w in p.items():
        dim = layout.fsdp_dims.get(name)
        # The stacked-layers dimension is gone from a layer's leaf.
        out[name] = w if dim is None else _FsdpGather.apply(
            w, layout.fsdp, dim - 1)
    return out


def _qkv(x, wq, wk, wv, positions, cfg: TransformerConfig):
    """Rotated q/k/v projections [B, L, H(kv), D] (H, Hkv: the heads
    whose columns ``wq`` / ``wk`` / ``wv`` hold)."""
    b, l, _ = x.shape
    dh = cfg.head_dim
    q = _proj(x, wq).reshape(b, l, -1, dh)
    k = _proj(x, wk).reshape(b, l, -1, dh)
    v = _proj(x, wv).reshape(b, l, -1, dh)
    return (_rope(q, positions, cfg.rope_theta),
            _rope(k, positions, cfg.rope_theta), v)


def _attention(p, x, positions, cfg: TransformerConfig, sp_group=None,
               tp: Optional[_Ring] = None):
    b, l, d = x.shape
    wk, wv = p["wk"], p["wv"]
    if tp is not None:
        x = _TpEnter.apply(x, tp)
        wk, wv = _TpColumns.apply(wk, tp), _TpColumns.apply(wv, tp)
    q, k, v = _qkv(x, p["wq"], wk, wv, positions, cfg)
    # This member's heads (all of them without tp).
    h, hk, dh = q.shape[2], k.shape[2], cfg.head_dim
    # The reference's mesh-island planner (_flash_plan) exists because
    # Mosaic kernels cannot be auto-partitioned by GSPMD; a process here
    # holds whole local tensors, so the plan is the ring (the sequence
    # dim is this member's shard), the direct call or none.
    if cfg.sp > 1:
        o = ring_attention(q, k, v, group=sp_group, causal=True)
    elif (fn := _flash_fn(l, dh, batch=b, heads=h,
                          device=x.device)) is not None:
        o = fn(q, k, v)
    else:
        if h != hk:
            k = k.repeat_interleave(h // hk, dim=2)
            v = v.repeat_interleave(h // hk, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
            * dh ** -0.5
        mask = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
        s = torch.where(mask, s, -1e30)
        w = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", w, v)
    out = _proj(o.reshape(b, l, h * dh), p["wo"])
    return out if tp is None else _TpLeave.apply(out, tp)


def _flash_enabled(seq_len: int, head_dim: int, *, batch: int = 1,
                   heads: int = 1, device: Optional[torch.device] = None
                   ) -> bool:
    """Flash kernel policy: HVDT_FLASH_ATTENTION=auto|on|off.

    'auto' (default) engages the kernel on CUDA tensors only when the
    materialized-score path would be memory-heavy: the f32 score tensor
    ``batch x heads x L x L`` at or past 4 GiB.  'on' forces it whenever
    the sequence tiles (on the CPU the kernels' plain versions run)."""
    mode = config.get_str("HVDT_FLASH_ATTENTION").lower()
    if mode == "off":
        return False
    shapes_ok = seq_len % min(128, seq_len) == 0 and seq_len >= 8
    if mode == "on":
        return shapes_ok
    score_bytes = 4 * batch * heads * seq_len * seq_len
    return (shapes_ok and score_bytes >= 4 * 1024 ** 3
            and device is not None and torch.device(device).type == "cuda")


# 'auto' engagement threshold for the smallseq kernels: the least number
# of (batch x head-block) programs, as in the reference.  None keeps auto
# disengaged: no measured break-even exists for it on the card yet.
_SMALLSEQ_AUTO_MIN_PROGRAMS: Optional[int] = None


def _smallseq_vmem_ok(seq_len: int, head_dim: int, hb: int) -> bool:
    """The reference's fit test for one (batch, head-block) program,
    kept with its formula so ``auto`` answers as the reference does.

    It models a TPU core's VMEM: the backward's bf16 q/do/out + k/v
    blocks, f32 dq/dk/dv outputs and one head's f32 [L, L] probability
    and d-score pair within a 12 MiB budget.  The card's kernels stream
    64-row tiles through shared memory and do not depend on it; it is to
    be re-fit when ``auto`` gets a threshold measured on the card."""
    bf16_in = 5 * hb * seq_len * head_dim * 2
    f32_out = 3 * hb * seq_len * head_dim * 4
    scratch = 2 * seq_len * seq_len * 4
    return bf16_in + f32_out + scratch <= 12 * 1024 ** 2


def _smallseq_enabled(seq_len: int, head_dim: int, *, batch: int,
                      heads: int, device: Optional[torch.device] = None
                      ) -> bool:
    """Whole-sequence kernel policy: HVDT_FLASH_SMALLSEQ=auto|on|off.

    'on' selects :func:`flash_attention_smallseq` for every sequence that
    fits one block (seq % 128 == 0 and seq <= 1024; on the CPU the plain
    versions run).  'auto' engages it on CUDA tensors when the sequence
    fits, :func:`_smallseq_vmem_ok` holds and there are at least
    ``_SMALLSEQ_AUTO_MIN_PROGRAMS`` (batch x head-block) programs — never
    while that threshold is None.  ``batch``/``heads`` are local sizes."""
    mode = config.get_str("HVDT_FLASH_SMALLSEQ").lower()
    if mode == "off":
        return False
    shapes_ok = seq_len % 128 == 0 and seq_len <= 1024
    if mode == "on":
        return shapes_ok
    if _SMALLSEQ_AUTO_MIN_PROGRAMS is None:
        return False
    hb = min(config.get_int("HVDT_FLASH_SMALLSEQ_HB"), max(heads, 1))
    programs = batch * max(heads, 1) // max(hb, 1)
    return (shapes_ok and _smallseq_vmem_ok(seq_len, head_dim, hb)
            and programs >= _SMALLSEQ_AUTO_MIN_PROGRAMS
            and device is not None and torch.device(device).type == "cuda")


def _flash_fn(seq_len: int, head_dim: int, *, batch: int, heads: int,
              device: Optional[torch.device] = None):
    """The attention kernel for these local shapes, or None for the
    materialized-score path.  HVDT_FLASH_ATTENTION=off is the master off
    switch; =on forces the STREAMING kernel."""
    mode = config.get_str("HVDT_FLASH_ATTENTION").lower()
    if mode == "off":
        return None
    if mode != "on" and _smallseq_enabled(seq_len, head_dim, batch=batch,
                                          heads=heads, device=device):
        return functools.partial(
            flash_attention_smallseq, causal=True,
            heads_per_block=config.get_int("HVDT_FLASH_SMALLSEQ_HB"))
    if _flash_enabled(seq_len, head_dim, batch=batch, heads=heads,
                      device=device):
        return functools.partial(flash_attention, causal=True)
    return None


def _mlp(p, x, tp: Optional[_Ring] = None):
    if tp is not None:
        x = _TpEnter.apply(x, tp)
    up = _proj(x, p["w_up"])
    gate = torch.nn.functional.silu(_proj(x, p["w_gate"]))
    out = _proj(up * gate, p["w_down"])
    return out if tp is None else _TpLeave.apply(out, tp)


def _moe_mlp(p, x, cfg: TransformerConfig, ep_group=None,
             tp: Optional[_Ring] = None):
    """The MoE MLP of one block: ``(out [b, l, d], MoEAux or None)``.
    Under ``tp`` the expert leaves hold the member's ``mlp`` columns."""
    b, l, d = x.shape
    tokens = x.reshape(b * l, d)
    logits = tokens @ p["w_router"].to(x.dtype)
    w_up, w_down = p["w_up"].to(x.dtype), p["w_down"].to(x.dtype)

    def enter(t):
        return t if tp is None else _TpEnter.apply(t, tp)

    def leave(t):
        return t if tp is None else _TpLeave.apply(t, tp)

    if _moe_ep(cfg) or ep_group is not None:
        def expert_fn(toks):                     # [E_local, N, D]
            return leave(torch.bmm(torch.nn.functional.silu(
                torch.bmm(enter(toks), w_up)), w_down))

        out, aux = moe_dispatch_combine(
            tokens, logits, expert_fn, group=ep_group, axis="ep",
            experts_per_rank=cfg.num_experts // cfg.ep,
            capacity_factor=cfg.capacity_factor)
    else:
        # The dense fallback: every expert on every token, exact, no
        # capacity.  "nd,edf->enf" has no batch dimension, so it is one
        # [N, d] x [d, E*f] product (a dot the "dots" policy saves, as
        # the reference's does); "enf,efd->end" is batched over e.
        e, f = w_up.shape[0], w_up.shape[2]
        probs = torch.softmax(logits.float(), -1)
        top = torch.argmax(probs, -1)
        gate = probs.gather(1, top[:, None])[:, 0]
        up = enter(tokens) @ w_up.permute(1, 0, 2).reshape(d, e * f)
        hmid = torch.nn.functional.silu(up.reshape(-1, e, f).transpose(0, 1))
        all_out = leave(torch.bmm(hmid, w_down))                 # [E, N, d]
        sel = all_out.gather(0, top[None, :, None].expand(1, -1, d))[0]
        out = sel * gate[:, None].to(x.dtype)
        aux = None
    return out.reshape(b, l, d), aux


def _dots_policy(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: save the outputs of products
    without batch dimensions, recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default, aten._scaled_mm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(_dots_policy)


def checkpoint_policy(mode: Optional[str] = None):
    """Resolve an ``HVDT_REMAT`` mode: ``None`` (no remat), ``"full"``
    (``torch.utils.checkpoint`` per block, saving only its input) or, for
    ``dots``, the selective-checkpoint policy function (``op -> save or
    recompute``) that saves the products without batch dimensions.
    ``mode=None`` reads the env knob; unknown modes raise with the valid
    list."""
    if mode is None:
        mode = config.get_str("HVDT_REMAT")
    mode = (mode or "none").strip().lower() or "none"
    if mode not in _REMAT_MODES:
        raise ValueError(f"unknown HVDT_REMAT mode {mode!r}; valid: "
                         f"{', '.join(_REMAT_MODES)}")
    if mode == "dots":
        return _dots_policy
    return None if mode == "none" else "full"


def remat_from_env(cfg: TransformerConfig,
                   mode: Optional[str] = None) -> TransformerConfig:
    """Apply the ``HVDT_REMAT`` knob (``none|full|dots``) to a config."""
    pol = checkpoint_policy(mode)
    if pol is None:
        return dataclasses.replace(cfg, remat=False)
    return dataclasses.replace(cfg, remat=True,
                               remat_policy="full" if pol == "full"
                               else "dots")


def remat_checkpoint(fn, *args, policy: str = "full"):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant):
    ``"full"`` saves only the inputs, ``"dots"`` also the outputs of the
    products without batch dimensions (:func:`checkpoint_policy`)."""
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=_dots_context)
    return checkpoint(fn, *args, use_reentrant=False)


def _block(p, x, positions, cfg: TransformerConfig, sp_group=None,
           ep_group=None, layout: Optional[_Layout] = None):
    p = _gather_block(p, layout)
    tp = layout.tp if layout is not None else None
    x = x + _attention(p, _rmsnorm(x, p["ln1"]), positions, cfg, sp_group,
                       tp)
    if cfg.num_experts:
        y, _ = _moe_mlp(p, _rmsnorm(x, p["ln2"]), cfg, ep_group, tp)
    else:
        y = _mlp(p, _rmsnorm(x, p["ln2"]), tp)
    return x + y


def _scan_blocks(block_params: Mapping[str, torch.Tensor], x, positions,
                 cfg: TransformerConfig, sp_group=None, ep_group=None,
                 layout: Optional[_Layout] = None):
    """The reference's ``lax.scan`` over the stacked layers, as a loop:
    each stacked leaf is unbound once, and with ``cfg.remat`` every layer
    runs under ``torch.utils.checkpoint`` (:func:`remat_checkpoint`),
    its ``fsdp`` gathers inside."""
    names = list(block_params)
    per_layer = list(zip(*(torch.unbind(block_params[n], 0)
                           for n in names)))

    def body(x, *leaves):
        return _block(dict(zip(names, leaves)), x, positions, cfg,
                      sp_group, ep_group, layout)

    for leaves in per_layer:
        if cfg.remat:
            x = remat_checkpoint(body, x, *leaves, policy=cfg.remat_policy)
        else:
            x = body(x, *leaves)
    return x


def _sp_rank(cfg: TransformerConfig, sp_group) -> int:
    """This member's index in the sequence-parallel ring (0 without
    one); checks that ``sp_group`` is given when ``cfg.sp > 1`` and that
    its size is ``cfg.sp``."""
    if sp_group is None:
        if cfg.sp > 1:
            raise ValueError(f"cfg.sp = {cfg.sp} needs sp_group= (the "
                             "ring's process group or a mesh with an 'sp' "
                             "dimension)")
        return 0
    ring = _Ring(sp_group, "sp")
    if ring.size != cfg.sp:
        raise ValueError(f"sp_group has {ring.size} members, cfg.sp is "
                         f"{cfg.sp}")
    return ring.rank


def _member(params: Transformer, n: int, group, axis: str,
            checked: bool = False) -> Optional[_Ring]:
    """Check that ``group`` (required when ``n > 1``) has ``n`` members and
    that this process is the one whose slice ``params`` holds; returns
    its ring when ``n > 1``.  ``checked``: a group given with ``n == 1``
    must have one member too."""
    if n <= 1 and not (checked and group is not None):
        return None
    if group is None:
        raise ValueError(f"cfg.{axis} = {n} needs {axis}_group= (a process "
                         f"group or a mesh with an {axis!r} dimension)")
    ring = _Ring(group, axis)
    if ring.size != n:
        raise ValueError(f"{axis}_group has {ring.size} members, cfg.{axis} "
                         f"is {n}")
    held = getattr(params, f"{axis}_rank", ring.rank)
    if ring.rank != held:
        raise ValueError(f"this process is member {ring.rank} of the "
                         f"{axis} group but the module holds member "
                         f"{held}'s slice")
    return ring if n > 1 else None


def _layout(params: Transformer, cfg: TransformerConfig, tp_group,
            fsdp_group) -> Optional[_Layout]:
    tp = _member(params, cfg.tp, tp_group, "tp", checked=True)
    fsdp = _member(params, cfg.fsdp, fsdp_group, "fsdp", checked=True)
    if tp is None and fsdp is None:
        return None
    dims = {name: _fsdp_dim(name, cfg) for name in params.block} \
        if fsdp is not None else {}
    return _Layout(tp, fsdp, dims)


def _forward(params: Transformer, tokens: torch.Tensor,
             cfg: TransformerConfig, sp_group=None, ep_group=None,
             pp_group=None, tp_group=None, fsdp_group=None):
    """(final-norm hidden states, the whole ``embed``): under ``fsdp`` the
    one gather of ``embed`` serves the lookup and the logits."""
    _check_supported(cfg)
    b, l = tokens.shape
    offset = _sp_rank(cfg, sp_group) * l
    _member(params, cfg.ep if cfg.num_experts else 1, ep_group, "ep")
    _member(params, cfg.pp, pp_group, "pp")
    layout = _layout(params, cfg, tp_group, fsdp_group)
    positions = offset + torch.arange(l, device=tokens.device).expand(b, l)
    embed = params.embed
    if layout is not None and layout.fsdp is not None:
        embed = _FsdpGather.apply(embed, layout.fsdp, _fsdp_dim("embed", cfg))
    x = embed.to(cfg.dtype)[tokens.long()]
    if cfg.pp > 1:
        # m = pp microbatches over the batch (the least schedule); the
        # positions are the same in every microbatch.
        m = cfg.pp
        if b % m:
            raise ValueError(f"batch {b} not divisible by pp {cfg.pp}")
        mb = b // m

        def stage_fn(stage_params, a):
            return _scan_blocks(stage_params, a, positions[:mb], cfg,
                                sp_group, ep_group, layout)

        x = pipeline_1f1b(stage_fn, dict(params.block),
                          x.reshape(m, mb, l, cfg.d_model), group=pp_group,
                          axis="pp").reshape(b, l, cfg.d_model)
    else:
        x = _scan_blocks(params.block, x, positions, cfg, sp_group, ep_group,
                         layout)
    return _rmsnorm(x, params.ln_f), embed


def transformer_hidden(params: Transformer, tokens: torch.Tensor,
                       cfg: TransformerConfig, *, sp_group=None,
                       ep_group=None, pp_group=None, tp_group=None,
                       fsdp_group=None) -> torch.Tensor:
    """Final-norm hidden states [batch, seq, d_model] (everything but the
    vocab projection).  tokens: [batch, seq] integer ids: this member's
    local shard of the sequence when ``cfg.sp > 1`` (positions offset by
    ``sp_rank * seq``), the full sequence otherwise; this member's own
    batch under ``ep`` and ``fsdp``; the same batch on every ``pp`` stage
    and every ``tp`` member.  ``tp_group`` / ``fsdp_group`` (a process
    group or a mesh; required when ``cfg.tp`` / ``cfg.fsdp`` > 1, of that
    size) carry the tensor-parallel and fully-sharded collectives."""
    return _forward(params, tokens, cfg, sp_group, ep_group, pp_group,
                    tp_group, fsdp_group)[0]


def transformer_apply(params: Transformer, tokens: torch.Tensor,
                      cfg: TransformerConfig, *, sp_group=None,
                      ep_group=None, pp_group=None, tp_group=None,
                      fsdp_group=None) -> torch.Tensor:
    """Logits [batch, seq, vocab] f32 for next-token prediction (see
    :func:`transformer_hidden`)."""
    x, embed = _forward(params, tokens, cfg, sp_group, ep_group, pp_group,
                        tp_group, fsdp_group)
    return (x @ embed.to(x.dtype).t()).float()


def _xent_chunk(m, s, tl, xf, wc, tgt, base: int, vocab: int):
    """One vocab chunk of :func:`_chunked_xent`: logits rounded to the
    activation dtype, then the f32 online logsumexp and the target
    logit."""
    chunk = wc.shape[0]
    logits = (xf @ wc.t()).float()                          # [N, chunk]
    valid = torch.arange(chunk, device=xf.device) + base < vocab
    logits = torch.where(valid[None, :], logits, float("-inf"))
    m_new = torch.maximum(m, logits.amax(-1))
    s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(-1)
    in_chunk = (tgt >= base) & (tgt < base + chunk)
    idx = torch.clamp(tgt - base, 0, chunk - 1)
    tl = torch.where(in_chunk, logits.gather(1, idx[:, None])[:, 0], tl)
    return m_new, s, tl


def _chunked_xent(x: torch.Tensor, embed: torch.Tensor,
                  targets: torch.Tensor, chunk: int) -> torch.Tensor:
    """Cross entropy without the [tokens, vocab] logits: a loop over vocab
    chunks with an online logsumexp, each chunk checkpointed so the
    backward recomputes its logits instead of saving them."""
    b, t, d = x.shape
    vocab = embed.shape[0]
    n_chunks = -(-vocab // chunk)
    pad = n_chunks * chunk - vocab
    w = embed.to(x.dtype)
    if pad:
        w = torch.cat([w, w.new_zeros((pad, d))])
    xf = x.reshape(b * t, d)
    tgt = targets.reshape(b * t).long()
    f32 = dict(dtype=torch.float32, device=x.device)
    m = torch.full((b * t,), float("-inf"), **f32)
    s = torch.zeros((b * t,), **f32)
    tl = torch.zeros((b * t,), **f32)
    for ci in range(n_chunks):
        wc = w[ci * chunk:(ci + 1) * chunk]
        m, s, tl = checkpoint(_xent_chunk, m, s, tl, xf, wc, tgt,
                              ci * chunk, vocab, use_reentrant=False)
    return (torch.log(s) + m - tl).mean()


def transformer_loss(params: Transformer, tokens: torch.Tensor,
                     cfg: TransformerConfig, *, sp_group=None,
                     ep_group=None, pp_group=None, tp_group=None,
                     fsdp_group=None) -> torch.Tensor:
    """Causal LM loss (next-token cross entropy) over the local shard.
    The model runs on the FULL (local) sequence and the last position's
    prediction is dropped, so the attention length stays the caller's
    ``seq`` (which is what lets the flash gate's tiling check pass).
    Under ``cfg.sp > 1``, ``ep > 1`` or ``fsdp > 1`` the caller averages
    the members' losses; every ``pp`` stage and every ``tp`` member
    returns the same loss."""
    targets = tokens[:, 1:]
    x, embed = _forward(params, tokens, cfg, sp_group, ep_group, pp_group,
                        tp_group, fsdp_group)
    if cfg.loss_chunk:
        return _chunked_xent(x[:, :-1], embed, targets, cfg.loss_chunk)
    logits = (x @ embed.to(x.dtype).t()).float()[:, :-1]
    logp = torch.log_softmax(logits, -1)
    return -logp.gather(-1, targets[..., None].long())[..., 0].mean()


def transformer_flops_per_token(cfg: TransformerConfig) -> float:
    """Approximate forward-pass matmul FLOPs per token (for MFU metrics),
    the reference's formula."""
    d, f, n = cfg.d_model, cfg.d_ff, cfg.layers
    h, hk, dh = cfg.heads, cfg.kv_heads, cfg.head_dim
    attn_proj = 2 * d * (h * dh + 2 * hk * dh + h * dh)
    attn_scores = 2 * 2 * cfg.max_seq * h * dh
    mlp = 2 * d * f * (3 if not cfg.num_experts else 2)
    return n * (attn_proj + attn_scores + mlp) + 2 * d * cfg.vocab
