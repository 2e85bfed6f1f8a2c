"""PyTorch port, the attention CUDA kernels (csrc/flash_attn.cu, #9-#11,
and csrc/flash_smallseq.cu, #12-#13, all on the core of
csrc/flash_sm90.cuh; #10, #11 and #13 on the backward bodies of
csrc/flash_bwd_sm90.cuh) held against their plain PyTorch versions on
the card.

Every test is marked ``cuda`` and skips without a card.  This file
imports neither JAX nor the JAX package, so it runs where only PyTorch
is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_flash_card.py

Tolerance, each row against its own size: a row is one [D] vector of
an output shaped [B, L, H, D] (else one value), and its error in L2 must
stay within one bf16/fp16 ulp relative (2^-7 / 2^-10) of its own norm
plus the root-mean-square row norm (a floor for rows near zero).  The
kernel and the plain version round the same f32 quantities (P, dS, the
output) and differ only in the order of their f32 sums; rows and not
elements, because an element of dQ or dK can cancel to near zero while
its terms are large.  The logsumexp has no 16-bit rounding: 1e-5.
"""

import pytest
import torch

from horovod_tpu_torch.ops import pallas_kernels as pk

pytestmark = pytest.mark.cuda

_ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(gen, *shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _assert_close(got, want, dtype, lse=False, floors=None):
    """``floors`` (one per output, None for the default) replaces the rms
    row norm as the floor of an output's rows."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    floors = floors or (None,) * len(got)
    for i, (g, w, fl) in enumerate(zip(got, want, floors)):
        rel = 1e-5 if (lse and i == 1) else _ULP[dtype]
        diff, w = g.float() - w.float(), w.float()
        if w.dim() == 4:
            err, size = diff.norm(dim=-1), w.norm(dim=-1)
        else:
            err, size = diff.abs(), w.abs()
        tol = rel * (size + (size.square().mean().sqrt() if fl is None
                             else fl))
        worst = (err / tol.clamp_min(1e-30)).max().item()
        assert worst <= 1.0, (i, worst, diff.abs().max().item(),
                              w.square().mean().sqrt().item())


def _check(gen, b, lq, lk, h, hkv, d, dtype, causal, q_offset=0,
           k_offset=0):
    q, do = _rand(gen, b, lq, h, d, dtype=dtype), _rand(gen, b, lq, h, d,
                                                        dtype=dtype)
    k, v = (_rand(gen, b, lk, hkv, d, dtype=dtype) for _ in range(2))
    kw = dict(causal=causal, scale=d ** -0.5, block_q=pk._fit_block(lq, 512),
              block_k=pk._fit_block(lk, 512))
    offs = (q_offset, k_offset)
    got = pk._flash_fwd(q, k, v, None, *offs, finish=True, **kw)
    _assert_close(got, pk._flash_fwd_plain(q, k, v, None, *offs, finish=True,
                                           **kw), dtype, lse=True)
    out, lse = got
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    args = (q, k, v, do, lse, delta, *offs)
    _assert_close(pk._flash_dq(*args, **kw), pk._flash_dq_plain(*args, **kw),
                  dtype)
    _assert_close(pk._flash_dkv(*args, **kw),
                  pk._flash_dkv_plain(*args, **kw), dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_kernels_match_plain(card, dtype, d, causal):
    before = pk._flash_fwd.launches
    _check(card, 2, 256, 256, 4, 2, d, dtype, causal)
    assert pk._flash_fwd.launches == before + 1


@pytest.mark.parametrize("lq,lk,hkv,d,causal", [
    (200, 200, 2, 64, True), (200, 136, 1, 128, False),
    (72, 200, 2, 64, False)])
def test_ragged_lengths_are_masked(card, lq, lk, hkv, d, causal):
    """Lengths that are not a multiple of the kernels' tiles."""
    _check(card, 1, lq, lk, 2, hkv, d, torch.bfloat16, causal)


def test_offsets_and_carry_match_plain(card):
    """flash_block_update's carry form at global offsets, including a
    K/V block wholly in the causal future (the carry comes back as it
    went in)."""
    b, lq, lk, h, d = 2, 128, 128, 4, 64
    q = _rand(card, b, lq, h, d)
    k, v = (_rand(card, b, lk, 2, d) for _ in range(2))
    carry = (torch.randn((b, lq, h, d), generator=card, device="cuda"),
             torch.randn((b, h, lq), generator=card, device="cuda"),
             1.0 + torch.rand((b, h, lq), generator=card, device="cuda"))
    for q_offset, k_offset in ((256, 128), (0, 10_000)):
        kw = dict(q_offset=q_offset, k_offset=k_offset, causal=True,
                  scale=d ** -0.5)
        got = pk.flash_block_update(q, k, v, *carry, **kw)
        want = pk._flash_fwd_plain(q, k, v, carry, q_offset, k_offset,
                                   causal=True, scale=d ** -0.5, block_q=128,
                                   block_k=128, finish=False)
        _assert_close(got, want, torch.bfloat16)
        if k_offset == 10_000:
            for g, c in zip(got, carry):
                assert torch.equal(g, c)
    _check(card, 2, 256, 128, 4, 2, d, torch.bfloat16, True, 128, 64)


# The backward kernels tile 192 (#10, D 64) or 128 (#10 at D 128, #11) own
# rows a CTA in warpgroups of 64, and stream 64-row tiles through the TMA,
# which zero-fills rows past the end; lse and delta reach #11 as one 1-D
# run.  (b, lq, lk, h, hkv, d, dtype, causal, q_offset, k_offset): offsets
# off every tile (q rows 0-15 see no key, so their lse is about -1e30);
# Lq != Lk, both off the tiles; Lq 102, not a multiple of 4 (the plain
# versions' blocks are then 2 and 8); GQA 4; D 128 fp16; non-causal with
# Lq below one warpgroup.
_BACKWARD_EDGES = [
    (2, 200, 200, 4, 2, 64, torch.bfloat16, True, 8, 24),
    (1, 1000, 744, 4, 2, 64, torch.bfloat16, True, 0, 0),
    (2, 102, 72, 4, 2, 64, torch.bfloat16, True, 0, 0),
    (2, 256, 256, 8, 2, 64, torch.bfloat16, True, 0, 0),
    (2, 300, 300, 4, 2, 128, torch.float16, True, 0, 0),
    (2, 40, 136, 4, 2, 64, torch.bfloat16, False, 0, 0)]


@pytest.mark.parametrize("b,lq,lk,h,hkv,d,dtype,causal,q_offset,k_offset",
                         _BACKWARD_EDGES)
def test_backward_edges_match_plain(card, b, lq, lk, h, hkv, d, dtype, causal,
                                    q_offset, k_offset):
    before = (pk._flash_dq.launches, pk._flash_dkv.launches)
    _check(card, b, lq, lk, h, hkv, d, dtype, causal, q_offset, k_offset)
    assert (pk._flash_dq.launches, pk._flash_dkv.launches) == (
        before[0] + 1, before[1] + 1)


def test_backward_row_stats_are_checked(card):
    """#11 reads lse and delta through a TMA tensor map, whose base must be
    16-byte aligned: a view that is not is copied (and gives the same
    gradients); lse or delta of the wrong shape raises."""
    b, lq, lk, h, d = 2, 102, 72, 4, 64
    q, do = _rand(card, b, lq, h, d), _rand(card, b, lq, h, d)
    k, v = (_rand(card, b, lk, 2, d) for _ in range(2))
    kw = dict(causal=True, scale=d ** -0.5, block_q=pk._fit_block(lq, 512),
              block_k=pk._fit_block(lk, 512))
    out, lse = pk._flash_fwd(q, k, v, None, 0, 0, finish=True, **kw)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    shifted = []
    for t in (lse, delta):
        buf = torch.empty(t.numel() + 1, device="cuda")
        shifted.append(buf[1:].view(t.shape))
        shifted[-1].copy_(t)
        assert shifted[-1].data_ptr() % 16
    want = pk._flash_dkv_plain(q, k, v, do, lse, delta, 0, 0, **kw)
    _assert_close(pk._flash_dkv(q, k, v, do, *shifted, 0, 0, **kw), want,
                  torch.bfloat16)
    for bad in ((lse[:, :, 1:], delta), (lse, delta[:1])):
        with pytest.raises(ValueError):
            pk._flash_dkv(q, k, v, do, *bad, 0, 0, **kw)
        with pytest.raises(ValueError):
            pk._flash_dq(q, k, v, do, *bad, 0, 0, **kw)


# The forward #9 tiles 192 q rows a CTA (three warpgroups of 64) and #12 64
# (one warpgroup), with 64 or 128 K/V rows a step (each source's FwdCfg),
# loaded by the TMA with the ragged end zero-filled: lengths off those
# multiples and below one warpgroup, GQA groups of 1 and 4 at L 1000, D 128
# and fp16.  (lq, lk, hkv, d, dtype,
# causal); the plain version walks one block of the whole length where the
# TPU block clamp would give a tiny block.
_TILING = [(40, 40, 2, 64, torch.bfloat16, True),
           (300, 300, 2, 128, torch.float16, True),
           (1000, 1000, 1, 64, torch.bfloat16, True),
           (1000, 1000, 4, 128, torch.bfloat16, False),
           (1000, 1000, 4, 64, torch.float16, True),
           (130, 1000, 4, 64, torch.bfloat16, False)]


def _block(n):
    fit = pk._fit_block(n, 512)
    return fit if fit >= 64 else n


@pytest.mark.parametrize("lq,lk,hkv,d,dtype,causal", _TILING)
def test_forward_tiling_matches_plain(card, lq, lk, hkv, d, dtype, causal):
    q = _rand(card, 2, lq, 4, d, dtype=dtype)
    k, v = (_rand(card, 2, lk, hkv, d, dtype=dtype) for _ in range(2))
    kw = dict(causal=causal, scale=d ** -0.5, block_q=_block(lq),
              block_k=_block(lk))
    before = pk._flash_fwd.launches
    got = pk._flash_fwd(q, k, v, None, 0, 0, finish=True, **kw)
    assert pk._flash_fwd.launches == before + 1
    _assert_close(got, pk._flash_fwd_plain(q, k, v, None, 0, 0, finish=True,
                                           **kw), dtype, lse=True)
    torch.cuda.synchronize()


@pytest.mark.parametrize("k_offset", [64, 24])
@pytest.mark.parametrize("d,dtype", [(64, torch.bfloat16),
                                     (128, torch.float16)])
def test_carry_passes_through_rows_before_every_key(card, d, dtype,
                                                    k_offset):
    """flash_block_update with k_offset past q_offset 0: q rows below
    k_offset see no key, so their carry (acc, m, l) comes back bit for
    bit; the other rows match the plain version, also past the ragged end
    of Lk 200.  At k_offset 64 the unseen rows are a whole warpgroup that
    runs no product; at 24 they share a warpgroup, and its tiles, with
    rows that see keys, so their rescale must be exactly 1 and their p
    exactly 0."""
    b, lq, lk, h = 2, 256, 200, 4
    q = _rand(card, b, lq, h, d, dtype=dtype)
    k, v = (_rand(card, b, lk, 2, d, dtype=dtype) for _ in range(2))
    carry = (torch.randn((b, lq, h, d), generator=card, device="cuda"),
             torch.randn((b, h, lq), generator=card, device="cuda"),
             1.0 + torch.rand((b, h, lq), generator=card, device="cuda"))
    kw = dict(q_offset=0, k_offset=k_offset, causal=True, scale=d ** -0.5)
    got = pk.flash_block_update(q, k, v, *carry, **kw)
    want = pk._flash_fwd_plain(q, k, v, carry, 0, k_offset, causal=True,
                               scale=d ** -0.5, block_q=256, block_k=200,
                               finish=False)
    _assert_close(got, want, dtype)
    assert torch.equal(got[0][:, :k_offset], carry[0][:, :k_offset])
    assert torch.equal(got[1][:, :, :k_offset], carry[1][:, :, :k_offset])
    assert torch.equal(got[2][:, :, :k_offset], carry[2][:, :, :k_offset])


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64),
                                     (torch.bfloat16, 32),
                                     (torch.bfloat16, 96)])
def test_unsupported_operands_raise(card, dtype, d):
    """No quiet fallback on the card: another dtype or head dim raises."""
    q = torch.zeros((1, 64, 2, d), dtype=dtype, device="cuda")
    with pytest.raises(ValueError):
        pk.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        pk.flash_block_update(q, q, q, q.float(),
                              torch.zeros((1, 2, 64), device="cuda"),
                              torch.zeros((1, 2, 64), device="cuda"),
                              q_offset=0, k_offset=0, causal=True,
                              scale=1.0)


# ---- the whole-sequence kernels #12 and #13 ---------------------------------


def _check_smallseq(gen, b, l, h, hkv, d, dtype, causal):
    q, do = _rand(gen, b, l, h, d, dtype=dtype), _rand(gen, b, l, h, d,
                                                       dtype=dtype)
    k, v = (_rand(gen, b, l, hkv, d, dtype=dtype) for _ in range(2))
    kw = dict(causal=causal, scale=d ** -0.5,
              hb=pk._fit_heads_per_block(h, h // hkv, 8))
    got = pk._smallseq_fwd(q, k, v, **kw)
    _assert_close(got, pk._smallseq_fwd_plain(q, k, v, **kw), dtype,
                  lse=True)
    args = (q, k, v, do, *got)
    grads = pk._smallseq_bwd(*args, **kw)
    assert all(g.dtype == dtype for g in grads)
    _assert_close(grads, pk._smallseq_bwd_plain(*args, **kw), dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_smallseq_kernels_match_plain(card, dtype, d, causal):
    before = (pk._smallseq_fwd.launches, pk._smallseq_bwd.launches)
    _check_smallseq(card, 2, 256, 4, 2, d, dtype, causal)
    assert (pk._smallseq_fwd.launches, pk._smallseq_bwd.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("l,hkv,d,causal", [
    (200, 2, 64, True), (200, 1, 128, False), (72, 4, 64, True),
    (65, 2, 64, True)])
def test_smallseq_ragged_lengths_are_masked(card, l, hkv, d, causal):
    """Lengths that are not a multiple of the kernels' tiles, and GQA
    groups of 1, 2 and 4."""
    _check_smallseq(card, 2, l, 4, hkv, d, torch.bfloat16, causal)


@pytest.mark.parametrize("l,hkv,d,dtype,causal", [
    (40, 2, 64, torch.bfloat16, True), (300, 2, 128, torch.float16, True),
    (1000, 1, 64, torch.bfloat16, True), (1000, 4, 128, torch.bfloat16, True),
    (1000, 4, 64, torch.float16, True), (1024, 4, 64, torch.bfloat16, False)])
def test_smallseq_forward_tiling_matches_plain(card, l, hkv, d, dtype,
                                               causal):
    """#12 off its tiles' multiples (L 40 below one warpgroup, L 300),
    GQA groups of 1 and 4 at L 1000, D 128, fp16, and non-causal at
    L 1024."""
    q = _rand(card, 2, l, 4, d, dtype=dtype)
    k, v = (_rand(card, 2, l, hkv, d, dtype=dtype) for _ in range(2))
    kw = dict(causal=causal, scale=d ** -0.5,
              hb=pk._fit_heads_per_block(4, 4 // hkv, 8))
    before = pk._smallseq_fwd.launches
    got = pk._smallseq_fwd(q, k, v, **kw)
    assert pk._smallseq_fwd.launches == before + 1
    _assert_close(got, pk._smallseq_fwd_plain(q, k, v, **kw), dtype,
                  lse=True)
    torch.cuda.synchronize()


def _rms_row(x):
    return x.float().norm(dim=-1).square().mean().sqrt().item()


# #13 is two launches on the backward bodies of flash_bwd_sm90.cuh: dQ (64
# q rows a CTA, one warpgroup, K/V tiles of 64 rows), which forms delta,
# then dK/dV (64 k rows a CTA of one kv head, walking the q tiles of each
# q head of its GQA group in turn, 64 rows a step at D 64 and 32 at
# D 128), with ragged ends zero-filled by the TMA and lse/delta read as one
# 1-D run.  (b, l, h, hkv, d, dtype, causal): L 1 (one key: dS = p (dP -
# delta) cancels to 0, so dq and dk are held to one ulp of the size of
# the terms that cancel), L 40 below one tile, L 65 one row past it,
# L 300 and 1000 off the tiles, GQA groups of 1, 4 and 8 (H 16 over
# Hkv 2), non-causal at L 1024, D 128 in fp16, and 15 dK/dV CTAs (an odd
# count: B 3, Hkv 1, 5 k tiles).
_SMALLSEQ_BWD_TILING = [
    (2, 1, 4, 2, 64, torch.bfloat16, True),
    (2, 40, 4, 2, 64, torch.bfloat16, True),
    (2, 65, 4, 4, 64, torch.bfloat16, True),
    (2, 300, 4, 1, 64, torch.bfloat16, True),
    (1, 1000, 16, 2, 64, torch.bfloat16, True),
    (1, 1000, 4, 4, 128, torch.bfloat16, True),
    (2, 1024, 4, 1, 64, torch.bfloat16, False),
    (2, 300, 4, 2, 128, torch.float16, True),
    (3, 320, 2, 1, 64, torch.bfloat16, True)]


@pytest.mark.parametrize("b,l,h,hkv,d,dtype,causal", _SMALLSEQ_BWD_TILING)
def test_smallseq_backward_tiling_matches_plain(card, b, l, h, hkv, d, dtype,
                                               causal):
    q, do = _rand(card, b, l, h, d, dtype=dtype), _rand(card, b, l, h, d,
                                                       dtype=dtype)
    k, v = (_rand(card, b, l, hkv, d, dtype=dtype) for _ in range(2))
    kw = dict(causal=causal, scale=d ** -0.5,
              hb=pk._fit_heads_per_block(h, h // hkv, 8))
    out, lse = pk._smallseq_fwd(q, k, v, **kw)
    args = (q, k, v, do, out, lse)
    before = pk._smallseq_bwd.launches
    got = pk._smallseq_bwd(*args, **kw)
    assert pk._smallseq_bwd.launches == before + 1
    assert [g.dtype for g in got] == [dtype] * 3
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    floors = None
    if l == 1:  # a row's terms: scale |dO| |v| |k| (dq), and |q| (dk,
        # over the group)
        terms = kw["scale"] * _rms_row(do) * _rms_row(v)
        floors = (terms * _rms_row(k), terms * _rms_row(q) * (h // hkv),
                  None)
    _assert_close(got, pk._smallseq_bwd_plain(*args, **kw), dtype,
                  floors=floors)
    torch.cuda.synchronize()


@pytest.mark.parametrize("hkv", [4, 1])
def test_smallseq_backward_is_deterministic(card, hkv):
    """No atomics: two calls give the same bits, at GQA groups 1 and 4."""
    b, l, h, d = 2, 512, 4, 64
    q, do = _rand(card, b, l, h, d), _rand(card, b, l, h, d)
    k, v = (_rand(card, b, l, hkv, d) for _ in range(2))
    kw = dict(causal=True, scale=d ** -0.5, hb=4)
    args = (q, k, v, do, *pk._smallseq_fwd(q, k, v, **kw))
    first = pk._smallseq_bwd(*args, **kw)
    second = pk._smallseq_bwd(*args, **kw)
    for x, y in zip(first, second):
        assert torch.equal(x.view(torch.int16), y.view(torch.int16))


def test_kernels_launch_from_a_fresh_thread(card):
    """The first CUDA call of a new host thread (autograd's backward thread
    may make its first in a kernel's wrapper) launches #9-#13: the tensor
    maps are encoded after the runtime has made the context current
    there."""
    import threading

    b, l, h, d = 2, 128, 4, 64
    q, k, v, do = (_rand(card, b, l, h, d) for _ in range(4))
    ss = dict(causal=True, scale=d ** -0.5, hb=4)
    fl = dict(causal=True, scale=d ** -0.5, block_q=128, block_k=128)
    out, lse = pk._smallseq_fwd(q, k, v, **ss)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    calls = {
        "smallseq_bwd": (lambda: pk._smallseq_bwd(q, k, v, do, out, lse, **ss),
                         lambda: pk._smallseq_bwd_plain(q, k, v, do, out, lse,
                                                        **ss)),
        "smallseq_fwd": (lambda: pk._smallseq_fwd(q, k, v, **ss),
                         lambda: pk._smallseq_fwd_plain(q, k, v, **ss)),
        "flash_dq": (lambda: pk._flash_dq(q, k, v, do, lse, delta, 0, 0, **fl),
                     lambda: pk._flash_dq_plain(q, k, v, do, lse, delta, 0, 0,
                                                **fl)),
        "flash_dkv": (lambda: pk._flash_dkv(q, k, v, do, lse, delta, 0, 0,
                                            **fl),
                      lambda: pk._flash_dkv_plain(q, k, v, do, lse, delta, 0,
                                                  0, **fl)),
        "flash_fwd": (lambda: pk._flash_fwd(q, k, v, None, 0, 0, finish=True,
                                            **fl),
                      lambda: pk._flash_fwd_plain(q, k, v, None, 0, 0,
                                                  finish=True, **fl))}
    for name, (kern, plain) in calls.items():
        got = {}
        thread = threading.Thread(target=lambda: got.update(out=kern()))
        thread.start()
        thread.join()
        assert "out" in got, name
        torch.cuda.synchronize()
        _assert_close(got["out"], plain(), torch.bfloat16,
                      lse=name.endswith("fwd"))


def test_smallseq_autograd_runs_the_kernels(card):
    """flash_attention_smallseq on CUDA tensors: one launch of #12 in the
    forward and one of #13 in the backward, gradients as the plain
    backward's."""
    q, k, v = (_rand(card, 2, 128, 4, 64) for _ in range(3))
    do = _rand(card, 2, 128, 4, 64)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (pk._smallseq_fwd.launches, pk._smallseq_bwd.launches)
    out = pk.flash_attention_smallseq(*leaves)
    out.backward(do)
    assert (pk._smallseq_fwd.launches, pk._smallseq_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    o_ref, lse = pk._smallseq_fwd_plain(q, k, v, causal=True,
                                        scale=64 ** -0.5, hb=4)
    want = pk._smallseq_bwd_plain(q, k, v, do, out.detach(), lse,
                                  causal=True, scale=64 ** -0.5, hb=4)
    _assert_close(out.detach(), o_ref, torch.bfloat16)
    _assert_close(tuple(x.grad for x in leaves), want, torch.bfloat16)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64),
                                     (torch.bfloat16, 32),
                                     (torch.bfloat16, 96)])
def test_smallseq_unsupported_operands_raise(card, dtype, d):
    """No quiet fallback on the card: another dtype or head dim raises."""
    q = torch.zeros((1, 64, 2, d), dtype=dtype, device="cuda")
    with pytest.raises(ValueError):
        pk.flash_attention_smallseq(q, q, q)
    with pytest.raises(ValueError):
        pk._smallseq_bwd(q, q, q, q, q, torch.zeros((1, 2, 64), device="cuda"),
                         causal=True, scale=1.0, hb=2)
