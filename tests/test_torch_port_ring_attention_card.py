"""PyTorch port, ring attention on the card: the pytest form of
chip_smoke.py's ring_entry and ring_virtual checks at a small size (B 2,
shard 256, H 4, Hkv 2, D 64, bf16, rings of 2 and 4).

* The entry point in an NCCL world of one (one step, no transfer) with
  ``use_pallas=True`` against ``flash_attention`` with the kernel
  backward, at shard 256 and at 200 (which does not tile by 128): #9
  launches once, #10 and #11 once each; the plain step
  (``use_pallas=False``) against the kernel step, with no launch; f32
  operands and ``segment_ids`` with ``use_pallas=True`` raise;
  ``use_pallas=None`` engages the kernels on bf16 operands and keeps the
  plain step on f32 ones.
* Every member of a ring driven in one process through the ring
  module's step functions (the rotation done by indexing the shard
  list), against whole-sequence ``flash_attention``: #9, #10 and #11
  launch sp(sp+1)/2 times causal and sp² times not; the same ring with
  the plain step (``use_pallas=False``), with no launch, against the
  kernel ring.
* The ring and the 1F1B pipeline (a group of one) captured by
  ``step_pipeline.donated_step``: every replay equal to the eager call,
  bit for bit (chip_smoke.py's ``--ring-cards 4`` and
  ``--parallel-cards 4`` hold the graphed ring and pipeline across four
  cards).

Every test is marked ``cuda`` and skips without a card.  This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda \
        tests/test_torch_port_ring_attention_card.py

Tolerance, each row against its own size (chip_smoke.py's
``closeness``): one bf16 ulp (2^-7) of the row's L2 norm plus the rms
row norm.  The plain step against the kernel step: 2^-6, since the
kernels round P and dS to bf16 and the plain step does not (measured on
the CPU against the kernels' plain versions: under half an ulp a row).
"""

import importlib

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import pallas_kernels as pk

rmod = importlib.import_module("horovod_tpu_torch.parallel.ring_attention")

pytestmark = pytest.mark.cuda

_ULP = 2.0 ** -7
_B, _N, _H, _HKV, _D = 2, 256, 4, 2, 64
_KERNELS = (pk._flash_fwd, pk._flash_dq, pk._flash_dkv)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.fixture
def world1(card):
    hvd.init()
    yield card
    hvd.shutdown()


def _rand(gen, *shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _operands(gen, l, dtype=torch.bfloat16):
    return (_rand(gen, _B, l, _H, _D, dtype=dtype),
            _rand(gen, _B, l, _HKV, _D, dtype=dtype),
            _rand(gen, _B, l, _HKV, _D, dtype=dtype),
            _rand(gen, _B, l, _H, _D, dtype=dtype))


def _assert_close(got, want, rel=_ULP):
    for i, (g, w) in enumerate(zip(got, want)):
        diff, w = g.float() - w.float(), w.float()
        err, size = diff.norm(dim=-1), w.norm(dim=-1)
        tol = rel * (size + size.square().mean().sqrt())
        worst = (err / tol.clamp_min(1e-30)).max().item()
        assert worst <= 1.0, (i, worst, diff.abs().max().item())


def _grads(fn, q, k, v, do):
    q, k, v = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = fn(q, k, v)
    return (out.detach(), *torch.autograd.grad(out, (q, k, v), do))


def _launches():
    torch.cuda.synchronize()
    return [fn.launches for fn in _KERNELS]


def _reset():
    for fn in _KERNELS:
        fn.launches = 0


def _whole(q, k, v, do, causal, monkeypatch):
    monkeypatch.setenv("HVDT_FLASH_BWD", "kernel")
    return _grads(lambda *a: pk.flash_attention(*a, causal=causal), q, k, v,
                  do)


@pytest.mark.parametrize("n", [_N, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_entry_matches_flash_attention(world1, monkeypatch, causal, n):
    args = _operands(world1, n)
    _reset()
    got = _grads(lambda q, k, v: rmod.ring_attention(
        q, k, v, causal=causal, use_pallas=True), *args)
    assert _launches() == [1, 1, 1]
    _assert_close(got, _whole(*args, causal, monkeypatch))


def test_entry_plain_step_matches_kernel_step(world1):
    args = _operands(world1, _N)
    _reset()
    plain = _grads(lambda q, k, v: rmod.ring_attention(
        q, k, v, use_pallas=False), *args)
    assert _launches() == [0, 0, 0]
    kern = _grads(lambda q, k, v: rmod.ring_attention(
        q, k, v, use_pallas=True), *args)
    _assert_close(plain, kern, rel=2 * _ULP)


def test_f32_operands_raise(world1):
    q, k, v, _ = _operands(world1, _N, dtype=torch.float32)
    with pytest.raises(ValueError, match="bf16 or fp16"):
        rmod.ring_attention(q, k, v, use_pallas=True)


def test_segment_ids_with_kernels_raise(world1):
    q, k, v, _ = _operands(world1, _N)
    seg = torch.zeros((_B, _N), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="segment_ids"):
        rmod.ring_attention(q, k, v, segment_ids=seg, use_pallas=True)


@pytest.mark.parametrize("dtype,launches", [(torch.bfloat16, [1, 1, 1]),
                                            (torch.float32, [0, 0, 0])])
def test_default_engages_kernels_the_operands_allow(world1, monkeypatch,
                                                    dtype, launches):
    monkeypatch.delenv("HVDT_RING_PALLAS", raising=False)
    args = _operands(world1, 200, dtype=dtype)
    _reset()
    _grads(rmod.ring_attention, *args)
    assert _launches() == launches


def _virtual_ring(qs, ks, vs, dos, causal, use_pallas):
    """Every member of the ring through the step functions: (out, dq, dk,
    dv) over the whole sequence, bf16."""
    sp = len(qs)
    kw = dict(causal=causal, scale=_D ** -0.5, use_pallas=use_pallas)
    outs, lses = [], []
    for my in range(sp):
        carry = rmod._init_carry(qs[my])
        for s in range(sp):
            src = (my - s) % sp
            carry = rmod._forward_step(qs[my], ks[src], vs[src], carry,
                                       src=src, my=my, **kw)
        out, lse = rmod._finish(carry, qs[my].dtype)
        outs.append(out)
        lses.append(lse)
    dq = [torch.zeros(x.shape, dtype=torch.float32, device="cuda")
          for x in qs]
    dk = [torch.zeros(x.shape, dtype=torch.float32, device="cuda")
          for x in ks]
    dv = [torch.zeros_like(x) for x in dk]
    for my in range(sp):
        inp = rmod._bwd_inputs(qs[my], dos[my], outs[my], lses[my],
                               use_pallas)
        for s in range(sp):
            src = (my - s) % sp
            g = rmod._backward_step(inp, ks[src], vs[src], src=src, my=my,
                                    **kw)
            if g is not None:
                dq[my] += g[0]
                dk[src] += g[1]
                dv[src] += g[2]
    return [torch.cat(x, 1).to(torch.bfloat16) for x in (outs, dq, dk, dv)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sp", [2, 4])
def test_virtual_ring_matches_whole_sequence(card, monkeypatch, sp, causal):
    q, k, v, do = _operands(card, sp * _N)
    shards = [[x[:, i * _N:(i + 1) * _N].contiguous() for i in range(sp)]
              for x in (q, k, v, do)]
    _reset()
    got = _virtual_ring(*shards, causal, True)
    steps = sp * (sp + 1) // 2 if causal else sp * sp
    assert _launches() == [steps] * 3
    _assert_close(got, _whole(q, k, v, do, causal, monkeypatch))
    _reset()
    plain = _virtual_ring(*shards, causal, False)
    assert _launches() == [0, 0, 0]
    _assert_close(plain, got, rel=2 * _ULP)


# ---- the ring and the pipeline inside a donated_step capture ---------------


def _graphed_and_eager(fn, *args):
    """Four calls of ``fn(*args)`` eagerly and through ``donated_step``
    (the eager warm-up, the capture and its replay, two replays): each
    call's outputs, cloned."""
    from horovod_tpu_torch.step_pipeline import donated_step

    graphed = donated_step(fn, donate_argnums=())
    out = {"eager": [], "graphed": []}
    for _ in range(4):
        out["eager"].append([t.clone() for t in fn(*args)])
        out["graphed"].append([t.clone() for t in graphed(*args)])
    assert graphed.graphed
    return out


@pytest.mark.parametrize("causal", [True, False])
def test_graphed_ring_matches_eager(world1, causal):
    """The ring (a group of one: its kernel step, and the replay hook
    that books its records) captured by donated_step: every replay's
    output and gradients equal the eager call's, bit for bit."""
    q, k, v, do = _operands(world1, _N)

    def fn(q, k, v, do):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = rmod.ring_attention(*leaves, causal=causal, use_pallas=True)
        return [out, *torch.autograd.grad(out, leaves, do)]

    runs = _graphed_and_eager(fn, q, k, v, do)
    for eager, graphed in zip(runs["eager"], runs["graphed"]):
        for e, g in zip(eager, graphed):
            assert torch.equal(e, g)


def test_graphed_pipeline_matches_eager(world1):
    """The 1F1B pipeline over a group of one, each microbatch through a
    stage that runs flash_attention (#9 forward), captured by
    donated_step (with the replay hook that books its schedule):
    every replay's output and gradients equal the eager call's."""
    from horovod_tpu_torch.parallel import pipeline_1f1b

    q, k, v, _ = _operands(world1, _N)
    mb = torch.stack([q, q.flip(0)])              # 2 microbatches

    def stage(p, x):
        return pk.flash_attention(x, p[0], p[1], causal=True)

    def fn(mb, k, v):
        leaves = [k.detach().requires_grad_(), v.detach().requires_grad_()]
        x = mb.detach().requires_grad_()
        out = pipeline_1f1b(stage, leaves, x)
        return [out, *torch.autograd.grad(out.float().square().sum(),
                                          [x, *leaves])]

    runs = _graphed_and_eager(fn, mb, k, v)
    for eager, graphed in zip(runs["eager"], runs["graphed"]):
        for e, g in zip(eager, graphed):
            assert torch.equal(e, g)
