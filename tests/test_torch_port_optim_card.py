"""PyTorch port, the multi-tensor optimizer CUDA kernels (csrc/optim.cu:
#1 hvdt_adam_multi, #2 hvdt_sgd_multi) held against their plain PyTorch
versions on the card.

Every test is marked ``cuda`` and skips without a card.  This file
imports neither JAX nor the JAX package, so it runs where only PyTorch
is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_optim_card.py

Tolerance: none.  The kernels do the plain versions' f32 operations in
the same order, each rounded once (no fused multiply-add), with the same
f32 scalars, and round to 16 bits to nearest even, so parameters,
moments and deltas must hold the same bytes.
"""

import math

import pytest
import torch

from horovod_tpu_torch.ops import optim_kernels as ok

pytestmark = pytest.mark.cuda

_INT_OF_SIZE = {4: torch.int32, 2: torch.int16}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same_bytes(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    it = _INT_OF_SIZE[a.element_size()]
    return torch.equal(a.contiguous().view(it), b.contiguous().view(it))


def _mixed_leaves(seed):
    """Sizes 1, 3, 130, 4096 and 2^20+7 in f32, a channels_last 4-D leaf,
    a view at storage offset 1 (unaligned: the scalar path), bf16 and
    f16 leaves.  The same seed gives the same leaves."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    leaves = [rnd(n) for n in (1, 3, 130, 4096, 2 ** 20 + 7)]
    leaves.append(rnd(64, 32, 3, 3).to(memory_format=torch.channels_last))
    leaves.append(rnd(5001)[1:])
    leaves += [rnd(4096, dtype=torch.bfloat16), rnd(130, dtype=torch.bfloat16),
               rnd(3, 1000, dtype=torch.float16)]
    return leaves


def _grads(leaves, step):
    """Contiguous grads (the channels_last leaf's is copied into its
    layout by the optimizer); leaf 2 has none at step 1."""
    g = torch.Generator(device="cuda").manual_seed(100 + step)
    return [None if (i, step) == (2, 1) else
            (torch.randn(tuple(p.shape), generator=g, device="cuda") * 0.1
             ).to(p.dtype) for i, p in enumerate(leaves)]


def _run(make_opt, steps=3):
    """(leaves, optimizer, launches per step) of ``steps`` steps through
    the kernel and through the plain version, from the same state."""
    runs = []
    for use_kernels in (True, False):
        leaves = _mixed_leaves(0)
        opt = make_opt(leaves, use_kernels)
        per_step = []
        for step in range(steps):
            for p, g in zip(leaves, _grads(leaves, step)):
                p.grad = g
            before = ok._sgd_multi.launches + ok._adam_multi.launches
            opt.step()
            per_step.append(ok._sgd_multi.launches + ok._adam_multi.launches
                            - before)
        torch.cuda.synchronize()
        runs.append((leaves, opt, per_step))
    return runs


def _assert_same_state(runs, keys):
    (kl, kopt, _), (pl, popt, _) = runs
    for i, (a, b) in enumerate(zip(kl, pl)):
        assert _same_bytes(a, b), ("param", i, (a.float() - b.float()).abs()
                                   .max().item())
        for k in keys:
            assert _same_bytes(kopt.state[a][k], popt.state[b][k]), (k, i)


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_matches_plain_bitwise(card, nesterov):
    runs = _run(lambda ps, uk: ok.fused_sgd(ps, 0.01, momentum=0.9,
                                            nesterov=nesterov,
                                            use_kernels=uk))
    _assert_same_state(runs, ["trace"])
    # One launch per dtype combination (f32, bf16, f16) and step.
    assert runs[0][2] == [3, 3, 3] and runs[1][2] == [0, 0, 0]


@pytest.mark.parametrize("kw", [
    {},
    {"weight_decay": 0.01, "eps_root": 1e-8, "mu_dtype": torch.float32},
    {"weight_decay": 1e-4, "b1": 0.8, "b2": 0.99, "eps": 1e-6},
])
def test_adam_matches_plain_bitwise(card, kw):
    runs = _run(lambda ps, uk: ok.fused_adam(ps, 1e-3, use_kernels=uk,
                                             **kw))
    _assert_same_state(runs, ["mu", "nu"])
    assert runs[0][2] == [3, 3, 3]


def test_skipped_leaf_is_untouched(card):
    """A leaf whose grad is None keeps its parameter and moments."""
    leaves = _mixed_leaves(0)
    opt = ok.fused_adam(leaves, 1e-3)
    for p, g in zip(leaves, _grads(leaves, 0)):
        p.grad = g
    opt.step()
    before = [leaves[2].clone(), opt.state[leaves[2]]["mu"].clone()]
    for p, g in zip(leaves, _grads(leaves, 1)):
        p.grad = g
    opt.step()
    assert _same_bytes(leaves[2], before[0])
    assert _same_bytes(opt.state[leaves[2]]["mu"], before[1])
    assert not _same_bytes(leaves[3], _mixed_leaves(0)[3])


def test_more_leaves_than_a_table_split(card):
    """More leaves than one kernel-parameter table holds: cut into
    ceil(n / cap) launches a step, each bit-identical."""
    n = ok._TABLE_CAP + 17
    runs = []
    for use_kernels in (True, False):
        g = torch.Generator(device="cuda").manual_seed(5)
        leaves = [torch.randn(3 + i % 5, generator=g, device="cuda")
                  for i in range(n)]
        opt = ok.fused_sgd(leaves, 0.05, momentum=0.9,
                           use_kernels=use_kernels)
        before = ok._sgd_multi.launches
        for step in range(2):
            for p in leaves:
                p.grad = torch.randn(p.shape, generator=g, device="cuda")
            opt.step()
        runs.append((leaves, opt, ok._sgd_multi.launches - before))
    assert runs[0][2] == 2 * math.ceil(n / ok._TABLE_CAP) == 4
    assert runs[1][2] == 0
    _assert_same_state(runs, ["trace"])


@pytest.mark.parametrize("pdt,offset", [(torch.float32, 0),
                                        (torch.float32, 1),
                                        (torch.bfloat16, 0),
                                        (torch.float16, 1)])
def test_leaf_updates_write_the_delta(card, pdt, offset):
    """The non-apply mode of sgd_leaf_update and adam_leaf_update (the
    delta written out, one launch of a one-leaf table each), aligned and
    at storage offset 1, against the plain version."""
    g = torch.Generator(device="cuda").manual_seed(7)

    def rnd(n, dtype=pdt):
        return torch.randn(n + offset, generator=g, device="cuda").to(
            dtype)[offset:]

    n = 70_001
    p, grad = rnd(n), rnd(n) * 0.1
    m, v = rnd(n, torch.float32), rnd(n).abs()
    sc = ok._adam_scalars(4, 1e-3, 0.9, 0.999)
    before = ok._adam_multi.launches
    got = ok.adam_leaf_update(p, grad, m.clone(), v.clone(), sc,
                              weight_decay=0.01, eps_root=1e-8)
    want = ok._adam_leaf_plain(p, grad, m.clone(), v.clone(), sc, b1=0.9,
                               b2=0.999, eps=1e-8, eps_root=1e-8, wd=0.01,
                               apply=False)
    assert ok._adam_multi.launches == before + 1
    assert all(_same_bytes(a, b) for a, b in zip(got, want))
    before = ok._sgd_multi.launches
    got = ok.sgd_leaf_update(grad, p.clone(), [0.1], momentum=0.9,
                             nesterov=True)
    want = ok._sgd_leaf_plain(grad, p.clone(), 0.1, momentum=0.9,
                              nesterov=True)
    assert ok._sgd_multi.launches == before + 1
    assert all(_same_bytes(a, b) for a, b in zip(got, want))


def test_unsupported_dtype_raises(card):
    """No quiet fallback on the card: a float64 leaf raises TypeError."""
    p = torch.zeros(16, dtype=torch.float64, device="cuda")
    p.grad = torch.ones_like(p)
    for opt in (ok.fused_adam([p], 1e-3), ok.fused_sgd([p], 0.1,
                                                        momentum=0.9)):
        with pytest.raises(TypeError):
            opt.step()
    with pytest.raises(TypeError):
        ok.sgd_leaf_update(p.grad, torch.zeros_like(p), [0.1], momentum=0.9)
