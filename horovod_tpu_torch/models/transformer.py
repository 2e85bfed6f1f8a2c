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
``shard_map`` islands, which computes the same function.  ``sp > 1``
together with ``ep > 1`` or ``pp > 1`` raises (parallel axes, part 2).

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
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..common import config
from ..common.basics import DeviceLike, resolve_device
from ..ops.pallas_kernels import flash_attention, flash_attention_smallseq
from ..parallel.mesh import mark_sharded
from ..parallel.moe import moe_dispatch_combine
from ..parallel.pipeline import pipeline_1f1b
from ..parallel.ring_attention import _Ring, ring_attention
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
    if cfg.sp > 1 and (_moe_ep(cfg) or cfg.pp > 1):
        raise NotImplementedError(
            "sp > 1 together with ep > 1 or pp > 1 is not ported yet "
            "(ROADMAP Queue 1: parallel axes, part 2)")
    if cfg.layers % max(cfg.pp, 1):
        raise ValueError(f"layers {cfg.layers} not divisible by pp {cfg.pp}")
    if _moe_ep(cfg) and cfg.num_experts % cfg.ep:
        raise ValueError(f"num_experts {cfg.num_experts} not divisible by "
                         f"ep {cfg.ep}")
    if cfg.remat and cfg.remat_policy not in ("full", "dots"):
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r} "
                         "(expected 'full' or 'dots')")


_EXPERT_LEAVES = ("w_up", "w_down")


def local_slice(name: str, leaf, cfg: TransformerConfig, pp_rank: int = 0,
                ep_rank: int = 0):
    """The part of the global block leaf ``name`` (stacked [layers, ...])
    that the member ``(pp_rank, ep_rank)`` holds: its stage's layers
    under ``pp > 1`` and, for an expert leaf under ``ep > 1``, its
    experts.  Works on tensors and numpy arrays."""
    if cfg.pp > 1:
        n = cfg.layers_per_stage
        leaf = leaf[pp_rank * n:(pp_rank + 1) * n]
    if _moe_ep(cfg) and name in _EXPERT_LEAVES:
        e = cfg.num_experts // cfg.ep
        leaf = leaf[:, ep_rank * e:(ep_rank + 1) * e]
    return leaf


class Transformer(nn.Module):
    """The LM's parameters with the reference's names: ``embed``
    [vocab, d], ``ln_f`` [d], and the stacked ``block.<name>``
    [layers, ...] (``ln1``, ``ln2``, ``wq``, ``wk``, ``wv``, ``wo``, and
    ``w_up``, ``w_gate``, ``w_down`` or, with experts, ``w_router``,
    ``w_up``, ``w_down``).  Under ``pp`` / ``ep`` it holds the slice of
    member ``(pp_rank, ep_rank)`` (:func:`local_slice`) of the global
    parameters the same generator draws.  ``forward`` returns f32
    logits."""

    def __init__(self, cfg: TransformerConfig,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None, *, pp_rank: int = 0,
                 ep_rank: int = 0):
        super().__init__()
        _check_supported(cfg)
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator()
        self.cfg, self.pp_rank, self.ep_rank = cfg, pp_rank, ep_rank
        d, h, hk, dh, f = (cfg.d_model, cfg.heads, cfg.kv_heads,
                           cfg.head_dim, cfg.d_ff)
        n, pd = cfg.layers, cfg.param_dtype

        def linear(name, fan_in, *shape):
            # Drawn whole, so every layout holds slices of one model.
            w = torch.randn((n, *shape), generator=gen) * fan_in ** -0.5
            return local_slice(name, w, cfg, pp_rank, ep_rank).to(
                pd, copy=cfg.pp > 1 or _moe_ep(cfg))

        def ones(*shape):
            return local_slice("ln", torch.ones((n, *shape), dtype=pd), cfg,
                               pp_rank, ep_rank)

        self.embed = nn.Parameter(
            (torch.randn((cfg.vocab, d), generator=gen) * 0.02).to(pd))
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
        for name, leaf in self.block.items():
            axes = (("pp",) if cfg.pp > 1 else ()) + (
                ("ep",) if _moe_ep(cfg) and name in _EXPERT_LEAVES else ())
            if axes:
                mark_sharded(leaf, *axes)
        self.to(dev)

    def forward(self, tokens: torch.Tensor, *, sp_group=None,
                ep_group=None, pp_group=None) -> torch.Tensor:
        return transformer_apply(self, tokens, self.cfg, sp_group=sp_group,
                                 ep_group=ep_group, pp_group=pp_group)


def transformer_init(seed: Union[int, torch.Generator],
                     cfg: TransformerConfig,
                     device: DeviceLike = None, *, pp_rank: int = 0,
                     ep_rank: int = 0) -> Transformer:
    """A :class:`Transformer` with random weights drawn on the CPU from
    ``seed`` (an int or a ``torch.Generator``) as the reference draws
    them (normal · fan_in^-0.5, embed normal · 0.02, norms 1), placed on
    ``device`` (the card unless the caller names another).  Under ``pp``
    / ``ep`` the module holds member ``(pp_rank, ep_rank)``'s slice of
    the model the same seed draws with ``pp = ep = 1``."""
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    return Transformer(cfg, generator=gen, device=device, pp_rank=pp_rank,
                       ep_rank=ep_rank)


def transformer_logical_axes(cfg: TransformerConfig) -> dict:
    """The reference's logical axis names of each leaf (None: a
    replicated dimension): the stacked-layers dimension is ``stages``
    (sharded over ``pp``), the expert dimension ``experts`` (over
    ``ep``)."""
    block = {
        "ln1": ("stages", None),
        "ln2": ("stages", None),
        "wq": ("stages", "embed", "heads"),
        "wk": ("stages", "embed", "kv"),
        "wv": ("stages", "embed", "kv"),
        "wo": ("stages", "heads", "embed"),
    }
    if cfg.num_experts:
        block["w_router"] = ("stages", "embed", None)
        block["w_up"] = ("stages", "experts", "embed", "mlp")
        block["w_down"] = ("stages", "experts", "mlp", "embed")
    else:
        block["w_up"] = ("stages", "embed", "mlp")
        block["w_gate"] = ("stages", "embed", "mlp")
        block["w_down"] = ("stages", "mlp", "embed")
    return {"embed": ("vocab", "embed"), "ln_f": (None,), "block": block}


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


def _qkv(p, x, positions, cfg: TransformerConfig):
    """Rotated q/k/v projections [B, L, H(kv), D]."""
    b, l, _ = x.shape
    h, hk, dh = cfg.heads, cfg.kv_heads, cfg.head_dim
    q = _proj(x, p["wq"]).reshape(b, l, h, dh)
    k = _proj(x, p["wk"]).reshape(b, l, hk, dh)
    v = _proj(x, p["wv"]).reshape(b, l, hk, dh)
    return (_rope(q, positions, cfg.rope_theta),
            _rope(k, positions, cfg.rope_theta), v)


def _attention(p, x, positions, cfg: TransformerConfig, sp_group=None):
    b, l, d = x.shape
    h, hk, dh = cfg.heads, cfg.kv_heads, cfg.head_dim
    q, k, v = _qkv(p, x, positions, cfg)
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
    return _proj(o.reshape(b, l, h * dh), p["wo"])


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


def _mlp(p, x):
    up = _proj(x, p["w_up"])
    gate = torch.nn.functional.silu(_proj(x, p["w_gate"]))
    return _proj(up * gate, p["w_down"])


def _moe_mlp(p, x, cfg: TransformerConfig, ep_group=None):
    """The MoE MLP of one block: ``(out [b, l, d], MoEAux or None)``."""
    b, l, d = x.shape
    tokens = x.reshape(b * l, d)
    logits = tokens @ p["w_router"].to(x.dtype)
    w_up, w_down = p["w_up"].to(x.dtype), p["w_down"].to(x.dtype)
    if _moe_ep(cfg) or ep_group is not None:
        def expert_fn(toks):                     # [E_local, N, D]
            return torch.bmm(torch.nn.functional.silu(torch.bmm(toks, w_up)),
                             w_down)

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
        up = tokens @ w_up.permute(1, 0, 2).reshape(d, e * f)
        hmid = torch.nn.functional.silu(up.reshape(-1, e, f).transpose(0, 1))
        all_out = torch.bmm(hmid, w_down)                        # [E, N, d]
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
           ep_group=None):
    x = x + _attention(p, _rmsnorm(x, p["ln1"]), positions, cfg, sp_group)
    if cfg.num_experts:
        y, _ = _moe_mlp(p, _rmsnorm(x, p["ln2"]), cfg, ep_group)
    else:
        y = _mlp(p, _rmsnorm(x, p["ln2"]))
    return x + y


def _scan_blocks(block_params: Mapping[str, torch.Tensor], x, positions,
                 cfg: TransformerConfig, sp_group=None, ep_group=None):
    """The reference's ``lax.scan`` over the stacked layers, as a loop:
    each stacked leaf is unbound once, and with ``cfg.remat`` every layer
    runs under ``torch.utils.checkpoint`` (:func:`remat_checkpoint`)."""
    names = list(block_params)
    per_layer = list(zip(*(torch.unbind(block_params[n], 0)
                           for n in names)))

    def body(x, *leaves):
        return _block(dict(zip(names, leaves)), x, positions, cfg,
                      sp_group, ep_group)

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


def _member(params: Transformer, n: int, group, axis: str) -> None:
    """Check that ``group`` (required when ``n > 1``) has ``n`` members and
    that this process is the one whose slice ``params`` holds."""
    if n <= 1:
        return
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


def transformer_hidden(params: Transformer, tokens: torch.Tensor,
                       cfg: TransformerConfig, *, sp_group=None,
                       ep_group=None, pp_group=None) -> torch.Tensor:
    """Final-norm hidden states [batch, seq, d_model] (everything but the
    vocab projection).  tokens: [batch, seq] integer ids: this member's
    local shard of the sequence when ``cfg.sp > 1`` (positions offset by
    ``sp_rank * seq``), the full sequence otherwise; this member's own
    batch under ``ep``; the same batch on every ``pp`` stage."""
    _check_supported(cfg)
    b, l = tokens.shape
    offset = _sp_rank(cfg, sp_group) * l
    _member(params, cfg.ep if cfg.num_experts else 1, ep_group, "ep")
    _member(params, cfg.pp, pp_group, "pp")
    positions = offset + torch.arange(l, device=tokens.device).expand(b, l)
    x = params.embed.to(cfg.dtype)[tokens.long()]
    if cfg.pp > 1:
        # m = pp microbatches over the batch (the least schedule); the
        # positions are the same in every microbatch.
        m = cfg.pp
        if b % m:
            raise ValueError(f"batch {b} not divisible by pp {cfg.pp}")
        mb = b // m

        def stage_fn(stage_params, a):
            return _scan_blocks(stage_params, a, positions[:mb], cfg,
                                sp_group, ep_group)

        x = pipeline_1f1b(stage_fn, dict(params.block),
                          x.reshape(m, mb, l, cfg.d_model), group=pp_group,
                          axis="pp").reshape(b, l, cfg.d_model)
    else:
        x = _scan_blocks(params.block, x, positions, cfg, sp_group, ep_group)
    return _rmsnorm(x, params.ln_f)


def transformer_apply(params: Transformer, tokens: torch.Tensor,
                      cfg: TransformerConfig, *, sp_group=None,
                      ep_group=None, pp_group=None) -> torch.Tensor:
    """Logits [batch, seq, vocab] f32 for next-token prediction (see
    :func:`transformer_hidden`)."""
    x = transformer_hidden(params, tokens, cfg, sp_group=sp_group,
                           ep_group=ep_group, pp_group=pp_group)
    return (x @ params.embed.to(x.dtype).t()).float()


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
                     ep_group=None, pp_group=None) -> torch.Tensor:
    """Causal LM loss (next-token cross entropy) over the local shard.
    The model runs on the FULL (local) sequence and the last position's
    prediction is dropped, so the attention length stays the caller's
    ``seq`` (which is what lets the flash gate's tiling check pass).
    Under ``cfg.sp > 1`` or ``ep > 1`` the caller averages the members'
    losses; every ``pp`` stage returns the same loss."""
    targets = tokens[:, 1:]
    groups = dict(sp_group=sp_group, ep_group=ep_group, pp_group=pp_group)
    if cfg.loss_chunk:
        x = transformer_hidden(params, tokens, cfg, **groups)[:, :-1]
        return _chunked_xent(x, params.embed, targets, cfg.loss_chunk)
    logits = transformer_apply(params, tokens, cfg, **groups)[:, :-1]
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
