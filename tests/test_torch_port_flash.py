"""PyTorch port, flash attention (horovod_tpu_torch/ops/pallas_kernels.py)
held against the JAX package's ops/pallas_kernels.py on the same numpy
inputs.

The JAX side runs its Pallas kernels in interpret mode on the CPU, as
tests/test_pallas.py runs them; the port runs the kernels' plain
PyTorch versions, as it does for every CPU tensor, and must launch no
kernel.  Sizes follow tests/test_pallas.py (B <= 2, L <= 256 except the
L = 768 case, H <= 8, D 16-32).  The kernels themselves are held to
these plain versions on the card (tests/test_torch_port_flash_card.py
and chip_smoke.py).

Tolerances:
* f32: 2e-6 absolute on outputs of magnitude ~1 and 1e-5 relative on
  the unnormalized carry — the same algorithm over the same blocks in
  the same order, so only the matmuls' summation order differs (about
  5e-7 measured);
* gradients (f32): 1e-5 absolute — measured about 1e-6;
* bf16: one bf16 ulp of the largest output (2^-7 of it): both sides
  round the same f32 value to bf16, and f32 sums in another order can
  move it across a rounding boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import pallas_kernels as jpk
from horovod_tpu_torch.ops import pallas_kernels as tpk

_ATOL = 2e-6
_GRAD_ATOL = 1e-5


_KERNELS = (tpk._flash_fwd, tpk._flash_dq, tpk._flash_dkv, tpk._smallseq_fwd,
            tpk._smallseq_bwd)


@pytest.fixture(autouse=True)
def _no_launches():
    for fn in _KERNELS:
        fn.launches = 0
    yield
    for fn in _KERNELS:
        assert fn.launches == 0


def _qkv(seed, b=2, l=128, h=4, hkv=None, d=32, lk=None):
    rng = np.random.default_rng(seed)
    hkv, lk = hkv or h, lk or l
    return (rng.standard_normal((b, l, h, d)).astype(np.float32),
            rng.standard_normal((b, lk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, lk, hkv, d)).astype(np.float32))


def _j(*xs, dtype=jnp.float32):
    return [jnp.asarray(x, dtype) for x in xs]


def _t(*xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


def _close(got, want, atol=_ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2)])
def test_flash_attention_matches_jax(causal, h, hkv):
    q, k, v = _qkv(0, h=h, hkv=hkv)
    want = jpk.flash_attention(*_j(q, k, v), causal=causal, block_q=32,
                               block_k=32)
    got = tpk.flash_attention(*_t(q, k, v), causal=causal, block_q=32,
                              block_k=32)
    _close(got, want)
    _close(got, tpk.attention_reference(*_t(q, k, v), causal=causal),
           atol=2e-5)


def test_flash_bf16_matches_jax():
    q, k, v = _qkv(2)
    want = np.asarray(jpk.flash_attention(
        *_j(q, k, v, dtype=jnp.bfloat16), causal=True, block_q=32,
        block_k=32), np.float32)
    got = tpk.flash_attention(*_t(q, k, v, dtype=torch.bfloat16),
                              causal=True, block_q=32, block_k=32)
    assert got.dtype == torch.bfloat16
    _close(got.float(), want, atol=np.abs(want).max() * 2.0 ** -7)


@pytest.mark.parametrize("l,block", [(100, 64), (768, 512)])
def test_flash_block_fitting_matches_jax(l, block):
    """L = 100 fits block 64 down to 4; L = 768 (a multiple of 128, not
    of the default blocks) fits 512 down to 256 and 1024 to 768."""
    q, k, v = _qkv(3, b=1, l=l, h=2, d=16)
    want = jpk.flash_attention(*_j(q, k, v), block_q=block, block_k=block)
    got = tpk.flash_attention(*_t(q, k, v), block_q=block, block_k=block)
    _close(got, want)
    _close(got, tpk.attention_reference(*_t(q, k, v)), atol=2e-5)


@pytest.mark.parametrize("n,block,want", [
    (768, 512, 256), (768, 1024, 768), (2048, 512, 512), (64, 512, 64),
    (100, 64, 4), (4096, 1024, 1024)])
def test_fit_block_matches_jax(n, block, want):
    assert tpk._fit_block(n, block) == want
    assert jpk._fit_block(n, block, jnp.float32) == want


def _carry(seed, b, l, h, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, l, h, d)).astype(np.float32),
            rng.standard_normal((b, h, l)).astype(np.float32),
            (1.0 + rng.random((b, h, l))).astype(np.float32))


@pytest.mark.parametrize("q_offset,k_offset", [(0, 0), (64, 32), (32, 96)])
@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2)])
def test_block_update_with_offsets_matches_jax(q_offset, k_offset, h, hkv):
    q, k, v = _qkv(4, l=64, h=h, hkv=hkv)
    acc, m, l = _carry(5, 2, 64, h, 32)
    kw = dict(q_offset=q_offset, k_offset=k_offset, causal=True,
              scale=32 ** -0.5, block_q=32, block_k=32)
    want = jpk.flash_block_update(*_j(q, k, v, acc, m, l), **kw)
    got = tpk.flash_block_update(*_t(q, k, v, acc, m, l), **kw)
    for g, w in zip(got, want):
        _close(g, w, atol=_ATOL, rtol=1e-5)


def test_block_update_fully_masked_block_returns_carry():
    """A K/V block wholly in the causal future leaves the carry exactly
    as it was (and makes no NaN)."""
    q, k, v = _qkv(6, b=1, l=32, h=2, d=16)
    acc = np.ones((1, 32, 2, 16), np.float32)
    m = np.full((1, 2, 32), 3.0, np.float32)
    l = np.full((1, 2, 32), 2.0, np.float32)
    kw = dict(q_offset=0, k_offset=10_000, causal=True, scale=0.25,
              block_q=32, block_k=32)
    got = tpk.flash_block_update(*_t(q, k, v, acc, m, l), **kw)
    want = jpk.flash_block_update(*_j(q, k, v, acc, m, l), **kw)
    for g, w, c in zip(got, want, (acc, m, l)):
        np.testing.assert_array_equal(g.numpy(), c)
        np.testing.assert_array_equal(np.asarray(w), c)


def test_block_update_stream_equals_full_attention():
    """flash_block_update over 4 K/V shards (the ring schedule, run in
    order) gives full causal attention, and the JAX stream's carry."""
    b, l, h, d, shards = 2, 128, 4, 32, 4
    lk = l // shards
    q, k, v = _qkv(7, b=b, l=l, h=h, d=d)
    tq, tk, tv = _t(q, k, v)
    carry = (torch.zeros((b, l, h, d)), torch.full((b, h, l), -1e30),
             torch.zeros((b, h, l)))
    jcarry = (jnp.zeros((b, l, h, d)), jnp.full((b, h, l), -1e30),
              jnp.zeros((b, h, l)))
    for s in range(shards):
        kw = dict(q_offset=0, k_offset=s * lk, causal=True, scale=d ** -0.5,
                  block_q=32, block_k=32)
        cols = slice(s * lk, (s + 1) * lk)
        carry = tpk.flash_block_update(tq, tk[:, cols], tv[:, cols], *carry,
                                       **kw)
        jcarry = jpk.flash_block_update(*_j(q), *_j(k[:, cols], v[:, cols]),
                                        *jcarry, **kw)
    for g, w in zip(carry, jcarry):
        _close(g, w, atol=_ATOL, rtol=1e-5)
    out = carry[0] / carry[2].clamp_min(1e-30).transpose(1, 2)[..., None]
    _close(out, tpk.attention_reference(tq, tk, tv), atol=2e-5)


@pytest.mark.parametrize("causal,q_offset,k_offset,h,hkv", [
    (True, 0, 0, 4, 4), (True, 0, 0, 4, 2), (True, 64, 32, 4, 2),
    (False, 0, 0, 4, 2)])
def test_flash_grad_block_matches_jax(causal, q_offset, k_offset, h, hkv):
    q, k, v = _qkv(8, l=64, h=h, hkv=hkv)
    do = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    out, lse = tpk._flash_fwd(*_t(q, k, v), None, q_offset, k_offset,
                              causal=causal, scale=32 ** -0.5, block_q=32,
                              block_k=32, finish=True)
    out, lse = out.numpy(), lse.numpy()
    kw = dict(q_offset=q_offset, k_offset=k_offset, causal=causal,
              block_q=32, block_k=32)
    want = jpk.flash_grad_block(*_j(q, k, v, do, out, lse), **kw)
    got = tpk.flash_grad_block(*_t(q, k, v, do, out, lse), **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        _close(g, w, atol=_GRAD_ATOL)


@pytest.mark.parametrize("causal,q_offset,k_offset,h,hkv", [
    (True, 0, 0, 4, 4), (True, 40, 8, 4, 2), (False, 0, 0, 4, 2)])
def test_flash_grad_block_bf16_matches_jax(causal, q_offset, k_offset, h,
                                           hkv):
    """bf16 operands: the plain versions of #10 and #11 round P to dO's
    dtype and dS to Q's and K's where the reference's Pallas kernels do
    (and the card holds the CUDA kernels to these plain versions).  The
    offsets (40, 8) are off the 32-row blocks.  Tolerance: one bf16 ulp
    (2^-7) of each output row's L2 norm, a row being one [D] vector of
    dq, dk or dv — the two sides round the same f32 values to bf16, and
    f32 sums in another order (delta, the products) can move one across a
    rounding boundary."""
    bf16 = dict(dtype=jnp.bfloat16), dict(dtype=torch.bfloat16)
    q, k, v = _qkv(15, l=64, h=h, hkv=hkv)
    do = np.random.default_rng(16).standard_normal(q.shape).astype(
        np.float32)
    out, lse = tpk._flash_fwd(*_t(q, k, v, **bf16[1]), None, q_offset,
                              k_offset, causal=causal, scale=32 ** -0.5,
                              block_q=32, block_k=32, finish=True)
    out, lse = out.float().numpy(), lse.numpy()
    kw = dict(q_offset=q_offset, k_offset=k_offset, causal=causal,
              block_q=32, block_k=32)
    want = jpk.flash_grad_block(*_j(q, k, v, do, out, **bf16[0]),
                                jnp.asarray(lse), **kw)
    got = tpk.flash_grad_block(*_t(q, k, v, do, out, **bf16[1]),
                               torch.from_numpy(lse), **kw)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.float32 and g.shape == w.shape
        err = np.linalg.norm(g.numpy() - w, axis=-1)
        assert (err <= 2.0 ** -7 * np.linalg.norm(w, axis=-1)).all(), (
            err.max(), np.linalg.norm(w, axis=-1).min())


@pytest.mark.parametrize("bwd", ["kernel", "xla"])
@pytest.mark.parametrize("causal", [True, False])
def test_autograd_matches_jax_grad(bwd, causal, monkeypatch):
    """Gradients of sum(flash_attention(q, k, v) * dO) through the
    autograd Function, under HVDT_FLASH_BWD, against jax.grad of the
    reference's flash_attention under the same knob."""
    monkeypatch.setenv("HVDT_FLASH_BWD", bwd)
    q, k, v = _qkv(10, h=4, hkv=2)
    do = np.random.default_rng(11).standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=causal, block_q=32, block_k=32)

    def loss(a, b, c):
        return (jpk.flash_attention(a, b, c, **kw) * jnp.asarray(do)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*_j(q, k, v))
    leaves = [x.requires_grad_() for x in _t(q, k, v)]
    (tpk.flash_attention(*leaves, **kw) * torch.from_numpy(do)).sum().backward()
    for t, w in zip(leaves, want):
        _close(t.grad, w, atol=_GRAD_ATOL)


def test_backward_knob_is_read_when_the_backward_runs(monkeypatch):
    """The port reads HVDT_FLASH_BWD when backward() runs (the reference
    reads it when the backward is traced): a graph built under xla runs
    the kernel backward if the knob is flipped before backward()."""
    calls = []
    real = tpk.flash_grad_block
    monkeypatch.setattr(tpk, "flash_grad_block",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setenv("HVDT_FLASH_BWD", "xla")
    q, k, v = (x.requires_grad_() for x in _t(*_qkv(12, l=64)))
    out = tpk.flash_attention(q, k, v, block_q=32, block_k=32)
    monkeypatch.setenv("HVDT_FLASH_BWD", "kernel")
    out.sum().backward()
    assert calls == [1]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 1)])
def test_attention_reference_matches_jax(causal, h, hkv):
    q, k, v = _qkv(13, h=h, hkv=hkv)
    want = jpk.attention_reference(*_j(q, k, v), causal=causal)
    got = tpk.attention_reference(*_t(q, k, v), causal=causal)
    _close(got, want, atol=2e-6)


def test_smallseq_is_not_ported_yet():
    """Named for when flash_attention_smallseq raised; it is ported now
    (tests/test_torch_port_smallseq.py holds it in full): on the CPU it
    runs its plain versions, matches the reference's kernel and the
    oracle, and is differentiable."""
    q, k, v = _qkv(14, h=4, hkv=2)
    want = jpk.flash_attention_smallseq(*_j(q, k, v), heads_per_block=2)
    leaves = [x.requires_grad_() for x in _t(q, k, v)]
    got = tpk.flash_attention_smallseq(*leaves, heads_per_block=2)
    _close(got.detach(), want)
    _close(got.detach(), tpk.attention_reference(*_t(q, k, v)), atol=2e-5)
    got.sum().backward()
    assert all(x.grad is not None and torch.isfinite(x.grad).all()
               for x in leaves)
