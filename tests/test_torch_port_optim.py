"""PyTorch port, fused optimizers (horovod_tpu_torch/ops/optim_kernels.py)
held against the JAX package's fused_sgd / fused_adam.

The same numpy parameters and gradients go through both.  The JAX side
runs both of its lowerings (the Pallas kernels in interpret mode on the
tile-eligible leaves plus the XLA fallback on the others, and the XLA
fallback everywhere with use_kernels=False); the port runs its plain
PyTorch versions, as it does for every CPU tensor, and must not launch a
kernel.

Tolerance, f32: rtol 1e-6 / atol 1e-7 — the same formulas in the same
order on both sides, so only sqrt/div and multiply-add contraction ulps
differ.  bf16 leaves: one bf16 ulp of the leaf's largest value (rtol
8e-3, atol max|x|/256), since both sides round the f32 update into bf16
and a 1-ulp f32 difference can flip that rounding, also where a moment
update cancels to a small value.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.ops import optim_kernels as jok
from horovod_tpu_torch.ops import optim_kernels as tok

_SHAPES = {
    "w": ((16, 128), np.float32),      # JAX kernel-eligible
    "deep": ((4, 8, 256), np.float32),  # JAX kernel-eligible
    "bias": ((130,), np.float32),       # JAX fallback (% 128 != 0)
    "tiny": ((256,), np.float32),       # JAX fallback (rows 2 < 8)
    "bf": ((32, 128), "bfloat16"),      # JAX kernel-eligible, bf16
}
_STEPS = 3


def _np_params(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, (s, _) in _SHAPES.items()}


def _np_grads(step):
    rng = np.random.default_rng(100 + step)
    return {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
            for k, (s, _) in _SHAPES.items()}


def _jax_tree(np_tree):
    return {k: jnp.asarray(v, dtype=jnp.bfloat16 if _SHAPES[k][1] ==
                           "bfloat16" else jnp.float32)
            for k, v in np_tree.items()}


def _torch_leaf(k, v):
    t = torch.from_numpy(np.array(v, np.float32))
    return t.to(torch.bfloat16) if _SHAPES[k][1] == "bfloat16" else t


def _assert_close(got: torch.Tensor, want, key):
    a = got.float().numpy()
    b = np.asarray(want, np.float32)
    if _SHAPES[key][1] == "bfloat16":
        np.testing.assert_allclose(a, b, rtol=8e-3,
                                   atol=np.abs(b).max() / 256, err_msg=key)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=key)


def _run_jax(tx):
    params = _jax_tree(_np_params())
    state = tx.init(params)
    update = jax.jit(tx.update)
    history = []
    for step in range(_STEPS):
        grads = _jax_tree(_np_grads(step))
        updates, state = update(grads, state, params)
        params = optax.apply_updates(params, updates)
        history.append((params, state))
    return history


def _run_port(make_opt, state_keys):
    params = {k: _torch_leaf(k, v) for k, v in _np_params().items()}
    opt = make_opt(list(params.values()))
    history = []
    for step in range(_STEPS):
        for k, g in _np_grads(step).items():
            params[k].grad = _torch_leaf(k, g)
        opt.step()
        history.append((
            {k: p.detach().clone() for k, p in params.items()},
            {sk: {k: opt.state[p][sk].clone() for k, p in params.items()}
             for sk in state_keys}))
    return history


@pytest.fixture(autouse=True)
def _no_launches():
    """On the CPU path no kernel launches (counters stay 0)."""
    tok._sgd_multi.launches = 0
    tok._adam_multi.launches = 0
    yield
    assert tok._sgd_multi.launches == 0
    assert tok._adam_multi.launches == 0


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("momentum,nesterov", [(0.9, False), (0.9, True),
                                               (0.0, False)])
def test_fused_sgd_matches_jax(momentum, nesterov, use_kernels):
    lr = 0.05
    want = _run_jax(jok.fused_sgd(lr, momentum=momentum, nesterov=nesterov,
                                  use_kernels=use_kernels))
    keys = ("trace",) if momentum else ()
    got = _run_port(lambda ps: tok.fused_sgd(ps, lr, momentum=momentum,
                                             nesterov=nesterov), keys)
    for (jp, js), (tp, ts) in zip(want, got):
        for k in _SHAPES:
            _assert_close(tp[k], jp[k], k)
            if momentum:
                _assert_close(ts["trace"][k], js.trace[k], k)
    if not momentum:
        assert not tok.fused_sgd([torch.zeros(3)], lr).state


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("kw", [
    {},
    {"weight_decay": 0.01},
    {"eps_root": 1e-8, "b1": 0.8, "b2": 0.99},
    {"weight_decay": 0.05, "eps_root": 1e-6, "eps": 1e-6},
])
def test_fused_adam_matches_jax(kw, use_kernels):
    lr = 1e-2
    want = _run_jax(jok.fused_adam(lr, use_kernels=use_kernels, **kw))
    got = _run_port(lambda ps: tok.fused_adam(ps, lr, **kw), ("mu", "nu"))
    for (jp, js), (tp, ts) in zip(want, got):
        for k in _SHAPES:
            _assert_close(tp[k], jp[k], k)
            _assert_close(ts["mu"][k], js.mu[k], k)
            _assert_close(ts["nu"][k], js.nu[k], k)


def test_fused_adam_schedule_uses_pre_increment_count():
    """A schedule sees the pre-increment count; bias corrections the
    incremented one (the JAX package's convention)."""
    want = _run_jax(jok.fused_adam(lambda c: 1e-2 * 0.5 ** c))
    got = _run_port(lambda ps: tok.fused_adam(ps, lambda c: 1e-2 * 0.5 ** c),
                    ("mu", "nu"))
    for (jp, _), (tp, _) in zip(want, got):
        for k in _SHAPES:
            _assert_close(tp[k], jp[k], k)


def test_leaf_updates_match_jax():
    """The public per-leaf functions return (delta, moments) like the
    JAX package's, with the same scalars."""
    rng = np.random.default_rng(7)
    p, g, m, v = (rng.standard_normal((8, 128)).astype(np.float32)
                  for _ in range(4))
    v = np.abs(v)
    sc = [1e-2, 1.0 / (1 - 0.9), 1.0 / (1 - 0.999)]
    jd, jm, jv = jok.adam_leaf_update(
        jnp.asarray(p), jnp.asarray(g), jnp.asarray(m), jnp.asarray(v),
        jnp.asarray(sc, jnp.float32), weight_decay=0.01)
    td, tm, tv = tok.adam_leaf_update(
        torch.from_numpy(p), torch.from_numpy(g), torch.from_numpy(m.copy()),
        torch.from_numpy(v.copy()), sc, weight_decay=0.01)
    for got, want in ((td, jd), (tm, jm), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    jd, jm = jok.sgd_leaf_update(jnp.asarray(g), jnp.asarray(m),
                                 jnp.asarray([0.1], jnp.float32),
                                 momentum=0.9, nesterov=True)
    td, tm = tok.sgd_leaf_update(torch.from_numpy(g),
                                 torch.from_numpy(m.copy()), [0.1],
                                 momentum=0.9, nesterov=True)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6,
                               atol=1e-7)


def test_eligibility_has_no_tiling_floor():
    assert tok.fused_update_eligible(torch.zeros(130))
    assert tok.fused_update_eligible(torch.zeros(3, dtype=torch.bfloat16),
                                     torch.float32)
    assert not tok.fused_update_eligible(torch.zeros(0))
    assert not tok.fused_update_eligible(torch.zeros(4, dtype=torch.int32))
    assert not tok.fused_update_eligible(torch.zeros(4), torch.int8)


def test_fused_sgd_rejects_schedule():
    with pytest.raises(ValueError, match="float learning_rate"):
        tok.fused_sgd([torch.zeros(2)], lambda c: 0.1, momentum=0.9)


# ---- the multi-tensor launches: host tables, checked on the CPU ------------

_TORCH_OF_CODE = {0: torch.float32, 1: torch.bfloat16, 2: torch.float16}


def _flat(ptr, n, code):
    """The ``n`` elements at host address ``ptr`` as a tensor of type
    ``code``, aliasing that memory (as the kernel reads the table)."""
    dtype = _TORCH_OF_CODE[code]
    buf = (ctypes.c_uint8 * (n * dtype.itemsize)).from_address(int(ptr))
    return torch.frombuffer(buf, dtype=torch.uint8).view(dtype)


def _interpret(entry, table, scalars, flags):
    """What one launch of ``entry`` does, on host memory: every CTA's
    (leaf, chunk) as the kernel finds it, through the plain versions."""
    codes = [(table.dtypes >> (4 * i)) & 15 for i in range(5)]
    apply = bool(flags & tok._APPLY)
    for block in range(table.nchunks):
        leaf, start, stop = tok._chunk_owner(table.rec, block)
        r = table.rec[leaf]
        n = int(r["n"])
        ops = {name: (_flat(r[name], n, code)[start:stop] if r[name] else None)
               for name, code in zip(tok._OPERANDS, codes)}
        if entry == "hvdt_sgd_multi":
            d, _ = tok._sgd_leaf_plain(
                ops["g"], ops["m"], scalars[0], momentum=scalars[1],
                nesterov=bool(flags & tok._NESTEROV),
                p=ops["p"] if apply else None)
        else:
            lr, bc1, bc2, b1, _, b2, _, eps, eps_root, wd = scalars
            assert bool(flags & tok._WEIGHT_DECAY) == bool(wd)
            d, _, _ = tok._adam_leaf_plain(
                ops["p"], ops["g"], ops["m"], ops["v"], [lr, bc1, bc2], b1=b1,
                b2=b2, eps=eps, eps_root=eps_root, wd=wd, apply=apply)
        if not apply:
            ops["d"].copy_(d)


@pytest.fixture
def table_route(monkeypatch):
    """CPU leaves take the kernel route: the tables are built and each
    launch is interpreted on host memory.  Yields the launches as
    (entry, leaves, dtype word, chunks)."""
    launches = []

    def launch(entry, table, scalars, flags, device, dev_scalars=None):
        assert dev_scalars is None        # no capture here
        launches.append((entry, len(table.rec), table.dtypes, table.nchunks))
        _interpret(entry, table, [float(s) for s in scalars], flags)

    monkeypatch.setattr(tok, "_on_cpu", lambda t: False)
    monkeypatch.setattr(tok, "_check_cuda_leaf", tok._check_leaf)
    monkeypatch.setattr(tok, "_launch", launch)
    yield launches
    tok._sgd_multi.launches = tok._adam_multi.launches = 0


# (shape, dtype, param group) of a mixed leaf set: f32 and bf16 leaves in
# two param groups with different learning rates.
_MIXED = {"w": ((16, 128), "f32", 0), "b": ((130,), "f32", 1),
          "bf": ((32, 128), "bf16", 0), "bfb": ((64,), "bf16", 1)}
_LRS = (0.05, 0.01)


def _mixed_np(seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * (1 if seed < 100 else 0.1)
                ).astype(np.float32) for k, (s, _, _) in _MIXED.items()}


def _mixed_close(got, want, key):
    a, b = got.float().numpy(), np.asarray(want, np.float32)
    if _MIXED[key][1] == "bf16":
        np.testing.assert_allclose(a, b, rtol=8e-3,
                                   atol=np.abs(b).max() / 256, err_msg=key)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=key)


def _run_jax_groups(make_tx):
    """One JAX transform per param group, over that group's leaves."""
    out = []
    for gi, lr in enumerate(_LRS):
        keys = [k for k, (_, _, g) in _MIXED.items() if g == gi]

        def tree(np_tree):
            return {k: jnp.asarray(np_tree[k], dtype=jnp.bfloat16 if
                                   _MIXED[k][1] == "bf16" else jnp.float32)
                    for k in keys}

        tx = make_tx(lr)
        params = tree(_mixed_np(0))
        state = tx.init(params)
        update = jax.jit(tx.update)
        hist = []
        for step in range(_STEPS):
            updates, state = update(tree(_mixed_np(100 + step)), state,
                                    params)
            params = optax.apply_updates(params, updates)
            hist.append((params, state))
        out.append(hist)
    return [({**a[0], **b[0]}, (a[1], b[1])) for a, b in zip(*out)]


def _run_port_groups(make_opt):
    params = {k: torch.from_numpy(v).to(torch.bfloat16 if _MIXED[k][1] ==
                                        "bf16" else torch.float32)
              for k, v in _mixed_np(0).items()}
    groups = [[params[k] for k, (_, _, g) in _MIXED.items() if g == gi]
              for gi in range(2)]
    opt = make_opt(groups)
    hist = []
    for step in range(_STEPS):
        for k, g in _mixed_np(100 + step).items():
            params[k].grad = torch.from_numpy(g).to(params[k].dtype)
        opt.step()
        hist.append(({k: p.detach().clone() for k, p in params.items()},
                     {k: {sk: t.clone() for sk, t in opt.state[p].items()}
                      for k, p in params.items()}))
    return hist


@pytest.mark.parametrize("route", ["plain", "table"])
def test_fused_sgd_mixed_leaves_two_groups_match_jax(route, request):
    """f32 and bf16 leaves in two param groups with different lr, nesterov:
    the port (plain, or through the tables) against the JAX package."""
    launches = request.getfixturevalue("table_route") if route == "table" \
        else None
    want = _run_jax_groups(lambda lr: jok.fused_sgd(lr, momentum=0.9,
                                                    nesterov=True))
    got = _run_port_groups(lambda gs: tok.fused_sgd(
        [{"params": gs[0]}, {"params": gs[1], "lr": _LRS[1]}], _LRS[0],
        momentum=0.9, nesterov=True))
    for (jp, js), (tp, ts) in zip(want, got):
        for k, (_, _, gi) in _MIXED.items():
            _mixed_close(tp[k], jp[k], k)
            _mixed_close(ts[k]["trace"], js[gi].trace[k], k)
    if launches is not None:
        # (group, dtype combination): 4 launches a step, one leaf each.
        assert len(launches) == 4 * _STEPS
        assert {n for _, n, _, _ in launches} == {1}


@pytest.mark.parametrize("route", ["plain", "table"])
def test_fused_adam_mixed_leaves_two_groups_match_jax(route, request):
    """bf16 params with f32 mu_dtype beside f32 params, weight decay, two
    param groups with different learning rates."""
    launches = request.getfixturevalue("table_route") if route == "table" \
        else None
    want = _run_jax_groups(lambda lr: jok.fused_adam(
        lr, weight_decay=0.01, mu_dtype=jnp.float32))
    got = _run_port_groups(lambda gs: tok.fused_adam(
        [{"params": gs[0]}, {"params": gs[1], "learning_rate": _LRS[1]}],
        _LRS[0], weight_decay=0.01, mu_dtype=torch.float32))
    for (jp, js), (tp, ts) in zip(want, got):
        for k, (_, _, gi) in _MIXED.items():
            _mixed_close(tp[k], jp[k], k)
            assert ts[k]["mu"].dtype == torch.float32
            np.testing.assert_allclose(ts[k]["mu"].numpy(),
                                       np.asarray(js[gi].mu[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
            _mixed_close(ts[k]["nu"], js[gi].nu[k], k)
    if launches is not None:
        assert len(launches) == 4 * _STEPS
        f32, bf = 0, 1
        words = {tok._pack_dtypes((c, c, f32, c, 0)) for c in (f32, bf)}
        assert {w for _, _, w, _ in launches} == words


def test_table_route_equals_plain_route(table_route, monkeypatch):
    """The whole host side of a step through the tables — grouping,
    splits, skipped leaves, a grad in another layout than its param,
    per-group scalars — gives exactly the plain route's result, and
    launches once per (group, dtype combination) and table."""
    monkeypatch.setattr(tok, "_TABLE_CAP", 2)

    def leaves():
        g = torch.Generator().manual_seed(0)
        w4 = torch.randn((8, 16, 3, 3), generator=g).to(
            memory_format=torch.channels_last)
        flat = [torch.randn(n, generator=g) for n in (1, 3, 130, 20000)]
        half = [torch.randn(n, generator=g).to(torch.bfloat16)
                for n in (5, 4096)]
        return [w4, *flat, *half]

    def grads(ps, step):
        """Contiguous grads (so the channels_last leaf's is copied into
        its layout); leaf 2 has none at step 1."""
        rng = np.random.default_rng(10 + step)
        return [None if (i, step) == (2, 1) else
                torch.from_numpy(rng.standard_normal(tuple(p.shape))
                                 .astype(np.float32)).to(p.dtype)
                for i, p in enumerate(ps)]

    results, per_step = [], []
    for use_kernels in (True, False):
        ps = leaves()
        opt = tok.fused_adam([{"params": ps[:4]},
                              {"params": ps[4:], "learning_rate": 3e-3}],
                             1e-2, weight_decay=1e-3, eps_root=1e-8,
                             mu_dtype=torch.float32, use_kernels=use_kernels)
        for step in range(3):
            for p, g in zip(ps, grads(ps, step)):
                p.grad = g
            before = len(table_route)
            opt.step()
            per_step.append(len(table_route) - before)
        results.append((ps, [opt.state[p] for p in ps]))
    (kp, ks), (pp, pst) = results
    for a, b in zip(kp, pp):
        assert torch.equal(a, b)
    for a, b in zip(ks, pst):
        assert torch.equal(a["mu"], b["mu"]) and torch.equal(a["nu"], b["nu"])
    # Group 0 holds 4 f32 leaves (2 tables of 2, also when leaf 2 has no
    # grad), group 1 one f32 and two bf16 leaves (a table each); the
    # plain route launches nothing.
    assert per_step == [4, 4, 4, 0, 0, 0], table_route
    assert [n for _, n, _, _ in table_route[4:8]] == [2, 1, 1, 2]
    assert tok._adam_multi.launches == len(table_route)


def test_leaf_updates_through_a_one_leaf_table(table_route):
    """sgd_leaf_update / adam_leaf_update on the kernel route: one launch
    of a one-leaf table each, the delta written out, as the plain
    version."""
    g = torch.randn(1000, generator=torch.Generator().manual_seed(1))
    m, v, p = g * 0.5, g.abs(), g * 2
    want = tok._adam_leaf_plain(p, g, m.clone(), v.clone(), [1e-2, 10.0, 1e3],
                                b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                                wd=0.01, apply=False)
    got = tok.adam_leaf_update(p, g, m.clone(), v.clone(), [1e-2, 10.0, 1e3],
                               weight_decay=0.01)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    want = tok._sgd_leaf_plain(g, m.clone(), 0.1, momentum=0.9,
                               nesterov=True)
    got = tok.sgd_leaf_update(g, m.clone(), [0.1], momentum=0.9,
                              nesterov=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert [(e, n) for e, n, _, _ in table_route] == [
        ("hvdt_adam_multi", 1), ("hvdt_sgd_multi", 1)]


def test_table_builder_groups_splits_and_covers():
    """The host table builder on shapes, dtypes and fake pointers: the
    grouping by (param group, dtype combination), the split under the
    kernel-parameter byte cap, the (leaf, chunk) mapping the kernel
    computes covering every element exactly once, the alignment flags."""
    cap = tok._TABLE_CAP
    assert tok._HEADER_BYTES + cap * tok._LEAF.itemsize <= 32764
    assert tok._HEADER_BYTES + (cap + 1) * tok._LEAF.itemsize > 32764
    f32, bf = (0, 0, 0, 0, 0), (1, 1, 0, 1, 0)
    numels = [1, 3, 16384, 16385, 50000, 130, 4096, 7]
    groups = [0, 0, 1, 0, 1, 0, 0, 1]
    codes = [f32, bf, f32, f32, f32, bf, f32, bf]
    base = np.arange(len(numels), dtype=np.uint64)[:, None] << np.uint64(24)
    ptrs = base + np.array([0x100, 0, 0x200, 0x300, 0], np.uint64)
    ptrs[:, 4] = 0                               # no delta: apply mode
    ptrs[5, 2] += 4                              # m of leaf 5 unaligned
    tables = tok._build_tables(groups, codes, numels, ptrs)
    assert [(t.group, t.dtypes, list(t.index)) for t in tables] == [
        (0, tok._pack_dtypes(f32), [0, 3, 6]),
        (0, tok._pack_dtypes(bf), [1, 5]),
        (1, tok._pack_dtypes(f32), [2, 4]),
        (1, tok._pack_dtypes(bf), [7])]
    for t in tables:
        covered = [np.zeros(int(n), np.int64) for n in t.rec["n"]]
        for block in range(t.nchunks):
            leaf, start, stop = tok._chunk_owner(t.rec, block)
            assert start < stop
            covered[leaf][start:stop] += 1
        assert all((c == 1).all() for c in covered)
        assert list(t.rec["n"]) == [numels[i] for i in t.index]
        assert (t.rec["p"] == ptrs[t.index, 0]).all()
    assert [list(t.rec["aligned"]) for t in tables] == [
        [1, 1, 1], [1, 0], [1, 1], [1]]
    # A grad at an odd address clears its leaf's flag, and only its.
    gptrs = ptrs[:, 1] + np.uint64(0x400)
    gptrs[3] += np.uint64(2)
    tables[0].set_grads(gptrs)
    assert list(tables[0].rec["aligned"]) == [1, 0, 1]
    assert (tables[0].rec["g"] == gptrs[[0, 3, 6]]).all()
    # More leaves than a table holds: runs of cap, in order.
    many = 2 * cap + 5
    split = tok._build_tables([0] * many, [f32] * many, [3] * many,
                              np.zeros((many, 5), np.uint64))
    assert [len(t.rec) for t in split] == [cap, cap, 5]
    assert [t.nchunks for t in split] == [cap, cap, 5]
    assert np.concatenate([t.index for t in split]).tolist() == list(
        range(many))


# ---- state kept through a checkpoint and created for added groups ---------


def _fresh_leaf_jax(tx, p0, grads):
    """``tx`` over the one leaf ``p0`` from a fresh state, one step per
    grad: the (param, state) after each."""
    params, hist = {"x": jnp.asarray(p0)}, []
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update({"x": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, updates)
        hist.append((params["x"], state))
    return hist


@pytest.mark.parametrize("fresh_mu_dtype", [torch.bfloat16, None])
@pytest.mark.parametrize("route", ["plain", "table"])
def test_fused_adam_mu_dtype_survives_checkpoint(fresh_mu_dtype, route,
                                                 request):
    """A bf16 ``mu`` beside an f32 param comes back from
    ``state_dict()`` / ``load_state_dict()`` as bf16, whatever the fresh
    optimizer's own ``mu_dtype``, and the step after the round trip is,
    bit for bit, the step of an optimizer that never went through it;
    both agree with the JAX fused_adam at the file's f32 / bf16
    tolerances."""
    if route == "table":
        request.getfixturevalue("table_route")
    rng = np.random.default_rng(11)
    p0 = rng.standard_normal((16, 128)).astype(np.float32)
    grads = [(rng.standard_normal((16, 128)) * 0.1).astype(np.float32)
             for _ in range(2)]
    want = _fresh_leaf_jax(jok.fused_adam(1e-3, mu_dtype=jnp.bfloat16), p0,
                           grads)

    def opt_of(p, mu_dtype=torch.bfloat16):
        return tok.fused_adam([p], 1e-3, mu_dtype=mu_dtype)

    p, q = (torch.from_numpy(p0.copy()) for _ in range(2))
    a, b = opt_of(p), opt_of(q)
    for t, opt in ((p, a), (q, b)):
        t.grad = torch.from_numpy(grads[0])
        opt.step()
    a2 = opt_of(p, fresh_mu_dtype)
    a2.load_state_dict(a.state_dict())
    assert a2.state[p]["mu"].dtype == torch.bfloat16
    assert a2.state[p]["nu"].dtype == torch.float32
    assert a2.param_groups[0]["count"] == 1
    for t, opt in ((p, a2), (q, b)):
        t.grad = torch.from_numpy(grads[1])
        opt.step()
    torch.testing.assert_close(p, q, rtol=0, atol=0)
    for key in ("mu", "nu"):
        torch.testing.assert_close(a2.state[p][key], b.state[q][key],
                                   rtol=0, atol=0)
    jp, js = want[-1]
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)
    assert js.mu["x"].dtype == jnp.bfloat16
    mu_want = np.asarray(js.mu["x"], np.float32)
    np.testing.assert_allclose(a2.state[p]["mu"].float().numpy(), mu_want,
                               rtol=8e-3, atol=np.abs(mu_want).max() / 256)
    np.testing.assert_allclose(a2.state[p]["nu"].numpy(),
                               np.asarray(js.nu["x"]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("route", ["plain", "table"])
@pytest.mark.parametrize("kind", ["sgd", "sgd_nesterov", "adam",
                                  "adam_bf16_mu"])
def test_added_param_group_gets_state(kind, route, request):
    """A param group added after construction gets zero moments (``mu``
    in ``mu_dtype``) and its own step count, so its leaf updates as the
    JAX transform updates a fresh leaf, step for step, beside the leaf
    of the first group."""
    if route == "table":
        request.getfixturevalue("table_route")
    rng = np.random.default_rng(5)
    p0, q0 = (rng.standard_normal(s).astype(np.float32)
              for s in ((8, 128), (130,)))
    gp, gq = ([(rng.standard_normal(x.shape) * 0.1).astype(np.float32)
               for _ in range(_STEPS)] for x in (p0, q0))
    if kind.startswith("sgd"):
        nesterov = kind == "sgd_nesterov"
        make_jax = lambda lr: jok.fused_sgd(lr, momentum=0.9,  # noqa: E731
                                            nesterov=nesterov)
        make_port = lambda ps: tok.fused_sgd(  # noqa: E731
            ps, 0.05, momentum=0.9, nesterov=nesterov)
        keys, lr_key = ("trace",), "lr"
    else:
        mu = kind == "adam_bf16_mu"
        make_jax = lambda lr: jok.fused_adam(  # noqa: E731
            lr, weight_decay=0.01, mu_dtype=jnp.bfloat16 if mu else None)
        make_port = lambda ps: tok.fused_adam(  # noqa: E731
            ps, 0.05, weight_decay=0.01,
            mu_dtype=torch.bfloat16 if mu else None)
        keys, lr_key = ("mu", "nu"), "learning_rate"
    want_p = _fresh_leaf_jax(make_jax(0.05), p0, gp)
    want_q = _fresh_leaf_jax(make_jax(0.01), q0, gq)
    p, q = torch.from_numpy(p0.copy()), torch.from_numpy(q0.copy())
    opt = make_port([p])
    opt.add_param_group({"params": [q], lr_key: 0.01})
    for step in range(_STEPS):
        p.grad, q.grad = torch.from_numpy(gp[step]), torch.from_numpy(gq[step])
        opt.step()
        for t, (jt, js) in ((p, want_p[step]), (q, want_q[step])):
            np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-6,
                                       atol=1e-7)
            for key in keys:
                got = opt.state[t][key]
                ref = getattr(js, key)["x"]
                assert got.dtype == getattr(torch, str(ref.dtype))
                ref = np.asarray(ref, np.float32)
                tol = ((8e-3, np.abs(ref).max() / 256)
                       if got.dtype == torch.bfloat16 else (1e-6, 1e-7))
                np.testing.assert_allclose(got.float().numpy(), ref,
                                           rtol=tol[0], atol=tol[1])
