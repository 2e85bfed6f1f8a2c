"""PyTorch port, the slice as a whole: ResNet (horovod_tpu_torch/models/
resnet.py) trained with fused_sgd, held against the JAX package's
resnet_loss + fused_sgd on the same weights and batches.

ResNet-26 (one bottleneck per stage), 64x64 images, batch 4, 10
classes.  The weights (the JAX package's parameter tree, filled from
numpy) go through horovod_tpu_torch.convert; the JAX side runs its
fused conv kernels in Pallas interpret mode and the XLA lowering of its
fused_sgd (its kernel lowering is held to the port in
test_torch_port_optim.py), the port its plain PyTorch versions (the CPU
path), launching no kernel.  The JAX side is computed once per module
and shared by the cases.

Each of the two training steps starts both sides from the same state:
before step k the port loads the JAX side's params, BN statistics and
momentum trace (optimizer_state_from_jax), so a step compares like with
like instead of compounding the previous step's rounding.

Tolerances (f32):
* loss rtol 1e-5; batch statistics and logits rtol 1e-4 / atol 1e-4;
* gradients and parameter updates, as relative L2 errors: 3e-2 per
  tensor and 1.5e-2 over all of them.  The early layers' gradients are
  ill-conditioned in f32: the batch-stat BN reductions are summed in
  another order, a ReLU whose pre-activation sits within that rounding
  of 0 flips, and the flipped unit's upstream gradient moves its
  layer's BN gradients.  From identical state the port and the
  reference differ by 0.3% on the first batch and by up to 1.1% per
  tensor (0.55% overall) on the second, measured on the CPU.
bf16 forward: logits within 5% of their largest value — bf16 keeps 8
significant bits, and the two frameworks round the BN's x*a + b and the
convolutions' outputs at different places (XLA may keep a fused
elementwise chain in f32), which moves every layer by about a bf16 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models import resnet as jrn
from horovod_tpu.ops.optim_kernels import fused_sgd as jax_fused_sgd
from horovod_tpu_torch.convert import (_param_tensors,
                                       optimizer_state_from_jax,
                                       resnet_params_from_jax)
from horovod_tpu_torch.models import resnet as trn
from horovod_tpu_torch.ops import conv_fused as tcf
from horovod_tpu_torch.ops import optim_kernels as tok

_LR, _MOMENTUM, _STEPS = 0.01, 0.9, 2
_JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _batch(step, n=4, size=64):
    rng = np.random.default_rng(step)
    return (rng.standard_normal((n, size, size, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_cfg(dtype="f32"):
    return jrn.ResNetConfig(num_classes=10, dtype=_JDT[dtype], depth=26)


def _numpy_init(cfg, seed=0):
    """The JAX package's (params, batch_stats) tree, traced abstractly
    from resnet50_init, filled from numpy as that init fills it:
    He-normal convs, FC scaled by cin^-0.5, BN scale 1 / bias 0, running
    mean 0 / var 1."""
    shapes = jax.eval_shape(lambda k: jrn.resnet50_init(k, cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        if len(shape) == 4:
            scale = np.sqrt(2.0 / np.prod(shape[:3]))
        elif name.endswith("['fc_w']"):
            scale = shape[0] ** -0.5
        else:
            one = name.endswith(("['scale']", "['var']"))
            return np.full(shape, float(one), np.float32)
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return tuple(jax.tree.map(jnp.asarray,
                              jax.tree_util.tree_map_with_path(fill, tree))
                 for tree in shapes)


def _port_model(params, stats, dtype="f32"):
    cfg = trn.ResNetConfig(num_classes=10, dtype=_TDT[dtype], depth=26)
    model = trn.resnet50_init(0, cfg, device="cpu")
    model.load_state_dict(resnet_params_from_jax(_np(params), _np(stats)))
    return model


@pytest.fixture(scope="module")
def jax_side():
    """Two JAX training steps with the fused kernels on (with the state
    each starts from), plus one forward each with the knob off and in
    bf16."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HVDT_FUSED_CONV1X1", "1")
        cfg = _jax_cfg()
        # f32 parameters whatever the compute dtype: one init serves all.
        params0, stats0 = _numpy_init(cfg)
        params, stats = params0, stats0
        out["init"] = (_np(params), _np(stats))
        tx = jax_fused_sgd(_LR, momentum=_MOMENTUM, use_kernels=False)
        opt_state = tx.init(params)
        grad_fn = jax.jit(jax.value_and_grad(jrn.resnet_loss, has_aux=True),
                          static_argnums=(4,))
        steps = []
        for step in range(_STEPS):
            x, y = _batch(step)
            before = (_np(params), _np(stats), _np(opt_state.trace))
            (loss, stats), grads = grad_fn(params, stats, jnp.asarray(x),
                                           jnp.asarray(y), cfg)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            steps.append({"before": before, "loss": float(loss),
                          "grads": _np(grads), "params": _np(params),
                          "stats": _np(stats)})
        out["steps"] = steps

        x, _ = _batch(0)
        logits, _ = jax.jit(jrn.resnet_apply, static_argnums=(3, 4))(
            params0, stats0, jnp.asarray(x), _jax_cfg("bf16"), True)
        out["bf16_logits"] = np.asarray(logits, np.float32)

        mp.delenv("HVDT_FUSED_CONV1X1")
        logits, new_stats = jax.jit(jrn.resnet_apply, static_argnums=(3, 4))(
            params0, stats0, jnp.asarray(x), cfg, True)
        out["off_logits"], out["off_stats"] = (np.asarray(logits),
                                               _np(new_stats))
    return out


@pytest.fixture(autouse=True)
def _no_launches():
    tcf._mm_forward.launches = 0
    tcf.matmul_batch_stats.launches = 0
    tok._sgd_leaf_fused.launches = 0
    yield
    assert tcf._mm_forward.launches == 0
    assert tcf.matmul_batch_stats.launches == 0
    assert tok._sgd_leaf_fused.launches == 0


def _assert_stats(model, want):
    got = model.batch_stats()

    def walk(g, w, path):
        for k, v in w.items():
            if isinstance(v, dict):
                walk(g[k], v, f"{path}.{k}")
            else:
                np.testing.assert_allclose(g[k].numpy(), v, rtol=1e-4,
                                           atol=1e-4, err_msg=f"{path}.{k}")

    walk(got, want, "")


def _assert_rel(got: dict, want: dict):
    """Relative L2 errors: 3e-2 per tensor, 1.5e-2 over all of them."""
    assert set(got) == set(want)
    diff = total = 0.0
    for name, w in want.items():
        w = np.asarray(w, np.float64)
        d = np.linalg.norm(np.asarray(got[name], np.float64) - w)
        assert d <= 3e-2 * np.linalg.norm(w) + 1e-12, (name, d)
        diff += d * d
        total += float(np.sum(w * w))
    assert np.sqrt(diff) <= 1.5e-2 * np.sqrt(total), np.sqrt(diff / total)


def test_two_fused_sgd_steps_match_jax(jax_side, monkeypatch):
    """Loss, every gradient, the parameter update (through the momentum
    trace on the second step) and the new BN statistics, from the same
    state on both sides each step."""
    monkeypatch.setenv("HVDT_FUSED_CONV1X1", "1")
    model = _port_model(*jax_side["init"])
    opt = tok.fused_sgd(model.parameters(), _LR, momentum=_MOMENTUM)
    named = dict(model.named_parameters())
    for step, want in enumerate(jax_side["steps"]):
        params, stats, trace = want["before"]
        model.load_state_dict(resnet_params_from_jax(params, stats))
        optimizer_state_from_jax(optax.TraceState(trace=trace), model, opt)
        before = _param_tensors(params)
        x, y = _batch(step)
        opt.zero_grad()
        loss, _ = trn.resnet_loss(model, torch.from_numpy(x),
                                  torch.from_numpy(y))
        loss.backward()
        np.testing.assert_allclose(loss.item(), want["loss"], rtol=1e-5)
        _assert_rel({k: p.grad.numpy() for k, p in named.items()},
                    {k: g.numpy() for k, g in
                     _param_tensors(want["grads"]).items()})
        opt.step()
        _assert_rel({k: (p.detach() - before[k]).numpy()
                     for k, p in named.items()},
                    {k: (p - before[k]).numpy() for k, p in
                     _param_tensors(want["params"]).items()})
        _assert_stats(model, want["stats"])


def test_forward_knob_off_matches_jax(jax_side, monkeypatch):
    monkeypatch.delenv("HVDT_FUSED_CONV1X1", raising=False)
    model = _port_model(*jax_side["init"])
    x, _ = _batch(0)
    with torch.no_grad():
        logits, _ = trn.resnet_apply(model, torch.from_numpy(x), True)
    np.testing.assert_allclose(logits.numpy(), jax_side["off_logits"],
                               rtol=1e-4, atol=1e-4)
    _assert_stats(model, jax_side["off_stats"])


def test_forward_bf16_matches_jax(jax_side, monkeypatch):
    monkeypatch.setenv("HVDT_FUSED_CONV1X1", "1")
    model = _port_model(*jax_side["init"], dtype="bf16")
    x, _ = _batch(0)
    with torch.no_grad():
        logits, _ = trn.resnet_apply(model, torch.from_numpy(x), True)
    want = jax_side["bf16_logits"]
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), want, rtol=0,
                               atol=5e-2 * np.abs(want).max())


@pytest.mark.parametrize("train", [True, False])
def test_fused_gate_selects_26_convs_at_resnet50(monkeypatch, train):
    """The gate picks the reference's layers: at ResNet-50, 26 convs per
    forward (8 in stage 1, 12 in stage 2, 6 in stage 3)."""
    monkeypatch.setenv("HVDT_FUSED_CONV1X1", "1")
    calls = []
    if train:
        real = tcf.matmul_batch_stats
        monkeypatch.setattr(tcf, "matmul_batch_stats",
                            lambda a, w: calls.append(a.shape) or real(a, w))
    else:
        real = tcf._mm_forward
        monkeypatch.setattr(tcf, "_mm_forward",
                            lambda a, *r: calls.append(a.shape) or real(a, *r))
    cfg = trn.ResNetConfig(num_classes=10, dtype=torch.float32, depth=50)
    model = trn.resnet50_init(0, cfg, device="cpu")
    x, _ = _batch(0, n=2)
    with torch.no_grad():
        logits, _ = trn.resnet_apply(model, torch.from_numpy(x), train)
    assert torch.isfinite(logits).all()
    # M = batch*H*W of each fused conv: a stage's first conv1 still sees
    # the previous stage's grid (the stride is on the 3x3 conv).
    assert [m for m, _ in calls] == ([512] + [128] * 7 + [128] + [32] * 11
                                     + [32] + [8] * 5)


def test_entry_points_need_cuda_or_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trn.resnet50_init(0, trn.ResNetConfig(depth=26))
