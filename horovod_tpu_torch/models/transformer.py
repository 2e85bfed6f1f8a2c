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
``quant/fp8.py``.  Outside this slice, and raising
``NotImplementedError`` naming their ROADMAP item: MoE (``num_experts >
0``), ``pp``/``ep > 1``, ``remat_policy="dots"``, and the paged serving
functions (not defined here yet).
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
from ..parallel.ring_attention import _Ring, ring_attention
from ..quant import fp8 as _fp8

__all__ = [
    "TransformerConfig", "Transformer", "transformer_init",
    "transformer_hidden", "transformer_apply", "transformer_loss",
    "transformer_flops_per_token", "remat_from_env", "checkpoint_policy",
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
    num_experts: int = 0         # MoE: not ported yet
    capacity_factor: float = 1.25
    sp: int = 1                  # sequence-parallel degree (ring attention)
    ep: int = 1                  # expert parallel: not ported yet
    pp: int = 1                  # pipeline: not ported yet
    remat: bool = False          # torch.utils.checkpoint each block
    remat_policy: str = "full"   # "dots" is not ported yet
    loss_chunk: int = 0          # >0: chunked-vocab cross entropy

    @property
    def head_dim(self) -> int:
        return self.d_model // self.heads


def _check_supported(cfg: TransformerConfig) -> None:
    if cfg.num_experts:
        raise NotImplementedError(
            "MoE blocks (num_experts > 0) are not ported yet (ROADMAP "
            "Queue 1: parallel axes)")
    for axis, n in (("pp", cfg.pp), ("ep", cfg.ep)):
        if n > 1:
            raise NotImplementedError(
                f"{axis} > 1 is not ported yet (ROADMAP Queue 1: parallel "
                "axes)")
    if cfg.remat and cfg.remat_policy != "full":
        if cfg.remat_policy == "dots":
            raise NotImplementedError(
                "remat_policy='dots' is not ported yet (ROADMAP Queue 1: "
                "parallel axes)")
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r} "
                         "(expected 'full' or 'dots')")


class Transformer(nn.Module):
    """The LM's parameters with the reference's names: ``embed``
    [vocab, d], ``ln_f`` [d], and the stacked ``block.<name>``
    [layers, ...] (``ln1``, ``ln2``, ``wq``, ``wk``, ``wv``, ``wo``,
    ``w_up``, ``w_gate``, ``w_down``).  ``forward`` returns f32 logits."""

    def __init__(self, cfg: TransformerConfig,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        _check_supported(cfg)
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator()
        self.cfg = cfg
        d, h, hk, dh, f = (cfg.d_model, cfg.heads, cfg.kv_heads,
                           cfg.head_dim, cfg.d_ff)
        n, pd = cfg.layers, cfg.param_dtype

        def linear(fan_in, *shape):
            return (torch.randn((n, *shape), generator=gen)
                    * fan_in ** -0.5).to(pd)

        self.embed = nn.Parameter(
            (torch.randn((cfg.vocab, d), generator=gen) * 0.02).to(pd))
        self.ln_f = nn.Parameter(torch.ones(d, dtype=pd))
        self.block = nn.ParameterDict({
            "ln1": torch.ones((n, d), dtype=pd),
            "ln2": torch.ones((n, d), dtype=pd),
            "wq": linear(d, d, h * dh),
            "wk": linear(d, d, hk * dh),
            "wv": linear(d, d, hk * dh),
            "wo": linear(h * dh, h * dh, d),
            "w_up": linear(d, d, f),
            "w_gate": linear(d, d, f),
            "w_down": linear(f, f, d),
        })
        self.to(dev)

    def forward(self, tokens: torch.Tensor, *,
                sp_group=None) -> torch.Tensor:
        return transformer_apply(self, tokens, self.cfg, sp_group=sp_group)


def transformer_init(seed: Union[int, torch.Generator],
                     cfg: TransformerConfig,
                     device: DeviceLike = None) -> Transformer:
    """A :class:`Transformer` with random weights drawn on the CPU from
    ``seed`` (an int or a ``torch.Generator``) as the reference draws
    them (normal · fan_in^-0.5, embed normal · 0.02, norms 1), placed on
    ``device`` (the card unless the caller names another)."""
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    return Transformer(cfg, generator=gen, device=device)


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


def checkpoint_policy(mode: Optional[str] = None):
    """Resolve an ``HVDT_REMAT`` mode: ``None`` (no remat) or ``"full"``
    (``torch.utils.checkpoint`` per block).  ``mode=None`` reads the env
    knob; unknown modes raise with the valid list; ``dots`` is not ported
    yet and raises."""
    if mode is None:
        mode = config.get_str("HVDT_REMAT")
    mode = (mode or "none").strip().lower() or "none"
    if mode not in _REMAT_MODES:
        raise ValueError(f"unknown HVDT_REMAT mode {mode!r}; valid: "
                         f"{', '.join(_REMAT_MODES)}")
    if mode == "dots":
        raise NotImplementedError(
            "HVDT_REMAT=dots is not ported yet (ROADMAP Queue 1: parallel "
            "axes)")
    return None if mode == "none" else "full"


def remat_from_env(cfg: TransformerConfig,
                   mode: Optional[str] = None) -> TransformerConfig:
    """Apply the ``HVDT_REMAT`` knob (``none|full``) to a config."""
    if checkpoint_policy(mode) is None:
        return dataclasses.replace(cfg, remat=False)
    return dataclasses.replace(cfg, remat=True, remat_policy="full")


def _block(p, x, positions, cfg: TransformerConfig, sp_group=None):
    x = x + _attention(p, _rmsnorm(x, p["ln1"]), positions, cfg, sp_group)
    return x + _mlp(p, _rmsnorm(x, p["ln2"]))


def _scan_blocks(block_params: Mapping[str, torch.Tensor], x, positions,
                 cfg: TransformerConfig, sp_group=None):
    """The reference's ``lax.scan`` over the stacked layers, as a loop:
    each stacked leaf is unbound once, and with ``cfg.remat`` every layer
    runs under ``torch.utils.checkpoint`` (saving only its input)."""
    names = list(block_params)
    per_layer = list(zip(*(torch.unbind(block_params[n], 0)
                           for n in names)))

    def body(x, *leaves):
        return _block(dict(zip(names, leaves)), x, positions, cfg,
                      sp_group)

    for leaves in per_layer:
        if cfg.remat:
            x = checkpoint(body, x, *leaves, use_reentrant=False)
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


def transformer_hidden(params: Transformer, tokens: torch.Tensor,
                       cfg: TransformerConfig, *,
                       sp_group=None) -> torch.Tensor:
    """Final-norm hidden states [batch, seq, d_model] (everything but the
    vocab projection).  tokens: [batch, seq] integer ids: this member's
    local shard of the sequence when ``cfg.sp > 1`` (positions offset by
    ``sp_rank * seq``), the full sequence otherwise."""
    _check_supported(cfg)
    b, l = tokens.shape
    offset = _sp_rank(cfg, sp_group) * l
    positions = offset + torch.arange(l, device=tokens.device).expand(b, l)
    x = params.embed.to(cfg.dtype)[tokens.long()]
    x = _scan_blocks(params.block, x, positions, cfg, sp_group)
    return _rmsnorm(x, params.ln_f)


def transformer_apply(params: Transformer, tokens: torch.Tensor,
                      cfg: TransformerConfig, *,
                      sp_group=None) -> torch.Tensor:
    """Logits [batch, seq, vocab] f32 for next-token prediction (see
    :func:`transformer_hidden`)."""
    x = transformer_hidden(params, tokens, cfg, sp_group=sp_group)
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
                     cfg: TransformerConfig, *,
                     sp_group=None) -> torch.Tensor:
    """Causal LM loss (next-token cross entropy) over the local shard.
    The model runs on the FULL (local) sequence and the last position's
    prediction is dropped, so the attention length stays the caller's
    ``seq`` (which is what lets the flash gate's tiling check pass).
    Under ``cfg.sp > 1`` the caller averages the members' losses."""
    targets = tokens[:, 1:]
    if cfg.loss_chunk:
        x = transformer_hidden(params, tokens, cfg,
                               sp_group=sp_group)[:, :-1]
        return _chunked_xent(x, params.embed, targets, cfg.loss_chunk)
    logits = transformer_apply(params, tokens, cfg,
                               sp_group=sp_group)[:, :-1]
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
