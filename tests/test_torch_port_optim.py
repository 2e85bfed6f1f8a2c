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
    tok._sgd_leaf_fused.launches = 0
    tok._adam_leaf_fused.launches = 0
    yield
    assert tok._sgd_leaf_fused.launches == 0
    assert tok._adam_leaf_fused.launches == 0


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
