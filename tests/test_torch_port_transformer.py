"""PyTorch port, the slice as a whole: the transformer LM (horovod_tpu_
torch/models/transformer.py) held against the JAX package's
models/transformer.py on the same numpy weights and tokens.

Size: 2 layers, d_model 64, 4 heads over 2 kv heads (GQA, head dim 16),
d_ff 128, vocab 128, seq 128, batch 2, f32.  The weights are the JAX
package's parameter tree filled from numpy and carried over by
horovod_tpu_torch.convert; with flash on, the JAX side runs its Pallas
kernels in interpret mode and the port the kernels' plain versions (no
launch).  The JAX side is computed once per distinct configuration.

Tolerances (f32): loss rtol 1e-5; gradients and parameter updates as
relative L2 errors, 1e-4 per tensor — the same math in the same order
up to the matmuls' summation order (about 1e-6 measured).  bf16 loss:
2e-2 relative — the two frameworks round activations at the same
places but XLA may keep a fused elementwise chain in f32, which moves
each layer by about a bf16 ulp.  The 2-process step: 1e-4 relative L2
(f32 averages of per-rank means against the global-batch mean).
"""

import os
import socket
import subprocess
import sys
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.models import transformer as jt
from horovod_tpu.ops.optim_kernels import fused_adam as jax_fused_adam
from horovod_tpu_torch.convert import (_param_tensors,
                                       optimizer_state_from_jax,
                                       transformer_params_from_jax)
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.ops import optim_kernels as tok
from horovod_tpu_torch.ops import pallas_kernels as tpk

ROOT = pathlib.Path(__file__).resolve().parents[1]
_KW = dict(vocab=128, layers=2, d_model=64, heads=4, kv_heads=2, d_ff=128,
           max_seq=128)
_LR, _WD = 1e-2, 1e-4


def _jcfg(dtype=jnp.float32, **kw):
    return jt.TransformerConfig(dtype=dtype, **{**_KW, **kw})


def _tcfg(dtype=torch.float32, **kw):
    return tt.TransformerConfig(dtype=dtype, **{**_KW, **kw})


def _numpy_params(seed=0):
    """The JAX package's params tree, traced abstractly from
    transformer_init and filled from numpy (norms 1, weights N(0, 0.1²))."""
    shapes = jax.eval_shape(lambda key: jt.transformer_init(key, _jcfg()),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if "ln" in jax.tree_util.keystr(path):
            return np.ones(leaf.shape, np.float32)
        return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _tokens(seed=1, b=2, l=128):
    return np.random.default_rng(seed).integers(0, 128, (b, l)).astype(
        np.int32)


def _port(params, cfg):
    model = tt.transformer_init(0, cfg, device="cpu")
    model.load_state_dict(transformer_params_from_jax(params))
    return model


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(autouse=True)
def _no_launches():
    fns = (tpk._flash_fwd, tpk._flash_dq, tpk._flash_dkv, tpk._smallseq_fwd,
           tpk._smallseq_bwd, tok._adam_multi)
    for fn in fns:
        fn.launches = 0
    yield
    for fn in fns:
        assert fn.launches == 0


@pytest.fixture(scope="module")
def jax_side():
    """JAX loss and gradients per distinct (flash, backward, loss_chunk)
    configuration, computed on first use."""
    params = _numpy_params()
    tokens = _tokens()
    cache = {}

    def get(flash, bwd, chunk, dtype="f32"):
        key = (flash, bwd if flash == "on" else None, chunk, dtype)
        if key not in cache:
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("HVDT_FLASH_ATTENTION", flash)
                mp.setenv("HVDT_FLASH_BWD", bwd)
                cfg = _jcfg(dtype=jnp.bfloat16 if dtype == "bf16"
                            else jnp.float32, loss_chunk=chunk)
                # A fresh jit per configuration: the knobs are read when
                # the function is traced.
                loss, grads = jax.jit(jax.value_and_grad(
                    lambda p, t: jt.transformer_loss(p, t, cfg)))(
                        jax.tree.map(jnp.asarray, params),
                        jnp.asarray(tokens))
            cache[key] = (float(loss), _param_tensors(_np(grads)))
        return cache[key]

    return params, tokens, get


def _assert_rel(got: dict, want: dict, tol=1e-4):
    assert set(got) == set(want)
    for name, w in want.items():
        w = np.asarray(w, np.float64)
        d = np.linalg.norm(np.asarray(got[name], np.float64) - w)
        assert d <= tol * np.linalg.norm(w) + 1e-12, (name, d)


@pytest.mark.parametrize("chunk", [0, 32])
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("bwd", ["kernel", "xla"])
@pytest.mark.parametrize("flash", ["on", "off"])
def test_loss_and_grads_match_jax(jax_side, monkeypatch, flash, bwd, remat,
                                  chunk):
    params, tokens, get = jax_side
    want_loss, want_grads = get(flash, bwd, chunk)
    monkeypatch.setenv("HVDT_FLASH_ATTENTION", flash)
    monkeypatch.setenv("HVDT_FLASH_BWD", bwd)
    cfg = _tcfg(remat=remat, loss_chunk=chunk)
    model = _port(params, cfg)
    calls = []
    real = tpk._flash_fwd
    monkeypatch.setattr(tpk, "_flash_fwd",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    loss = tt.transformer_loss(model, torch.from_numpy(tokens), cfg)
    loss.backward()
    # Flash on: one forward per layer, and again per layer under remat.
    assert len(calls) == (0 if flash == "off" else 2 * (1 + remat))
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    _assert_rel({n: p.grad.numpy() for n, p in model.named_parameters()},
                {n: g.numpy() for n, g in want_grads.items()})


def test_bf16_loss_matches_jax(jax_side, monkeypatch):
    params, tokens, get = jax_side
    want, _ = get("on", "kernel", 32, "bf16")
    monkeypatch.setenv("HVDT_FLASH_ATTENTION", "on")
    cfg = _tcfg(dtype=torch.bfloat16, loss_chunk=32)
    loss = tt.transformer_loss(_port(params, cfg), torch.from_numpy(tokens),
                               cfg)
    np.testing.assert_allclose(loss.item(), want, rtol=2e-2)


def test_logits_match_jax(jax_side, monkeypatch):
    params, tokens, _ = jax_side
    monkeypatch.setenv("HVDT_FLASH_ATTENTION", "off")
    want = jt.transformer_apply(jax.tree.map(jnp.asarray, params),
                                jnp.asarray(tokens), _jcfg())
    with torch.no_grad():
        got = _port(params, _tcfg())(torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


# ---- gates ---------------------------------------------------------------


_BIG = dict(batch=16, heads=16)          # 16 GiB of f32 scores at 4096
_CPU, _CUDA = torch.device("cpu"), torch.device("cuda")


@pytest.mark.parametrize("mode,seq,device,want", [
    ("auto", 4096, _CPU, False),     # auto never engages on the CPU
    ("auto", 4096, _CUDA, True),     # the bert-large seq-4096 path
    ("auto", 512, _CUDA, False),     # 1 GiB of scores: below the gate
    ("on", 128, _CPU, True),
    ("on", 100, _CPU, True),         # one block of 100
    ("on", 200, _CPU, False),        # 200 does not tile by 128
    ("off", 4096, _CUDA, False)])
def test_flash_gate(monkeypatch, mode, seq, device, want):
    monkeypatch.setenv("HVDT_FLASH_ATTENTION", mode)
    assert tt._flash_enabled(seq, 64, device=device, **_BIG) is want
    if mode != "auto":       # the reference's auto asks for a TPU
        assert jt._flash_enabled(seq, 64, **_BIG) is want
    fn = tt._flash_fn(seq, 64, device=device, **_BIG)
    assert (fn is not None) is want
    if want:
        assert fn.func is tpk.flash_attention


def test_flash_gate_default_is_auto(monkeypatch):
    monkeypatch.delenv("HVDT_FLASH_ATTENTION", raising=False)
    assert tt._flash_enabled(4096, 64, device=_CUDA, **_BIG)
    assert not tt._flash_enabled(4096, 64, device=_CPU, **_BIG)


def test_smallseq_on_raises_and_streaming_overrides(monkeypatch, jax_side):
    """Named for when HVDT_FLASH_SMALLSEQ=on raised; now it routes the
    attention through flash_attention_smallseq (the loss matches the
    materialized-score path's), HVDT_FLASH_ATTENTION=on forces the
    streaming kernel instead and off turns both off; auto stays
    disengaged."""
    params, tokens, get = jax_side
    cfg = _tcfg()
    model = _port(params, cfg)
    calls = {"smallseq": 0, "flash": 0}
    for name, key in (("flash_attention_smallseq", "smallseq"),
                      ("flash_attention", "flash")):
        real = getattr(tt, name)
        monkeypatch.setattr(
            tt, name, lambda *a, _r=real, _k=key, **k:
            calls.__setitem__(_k, calls[_k] + 1) or _r(*a, **k))
    want, _ = get("off", "xla", 0)
    monkeypatch.setenv("HVDT_FLASH_SMALLSEQ", "on")
    for mode, smallseq, flash in ((None, 2, 0), ("on", 0, 2), ("off", 0, 0)):
        if mode is None:
            monkeypatch.delenv("HVDT_FLASH_ATTENTION", raising=False)
        else:
            monkeypatch.setenv("HVDT_FLASH_ATTENTION", mode)
        calls.update(smallseq=0, flash=0)
        loss = tt.transformer_loss(model, torch.from_numpy(tokens), cfg)
        assert calls == {"smallseq": smallseq, "flash": flash}, mode
        np.testing.assert_allclose(loss.item(), want, rtol=1e-5)
    monkeypatch.setenv("HVDT_FLASH_SMALLSEQ", "auto")
    assert not tt._smallseq_enabled(512, 64, batch=128, heads=16,
                                    device=_CUDA)


# Parallel axes, part 1 ported MoE, ep, pp and dots, part 2 sp together
# with pp: those configs build (tests/test_torch_port_transformer_parallel.py
# and tests/test_torch_port_tensor_parallel.py hold them to the
# reference).  The ids are the ones these cases had while all of them
# raised.
@pytest.mark.parametrize("kw,match", [
    (dict(num_experts=4), None),
    (dict(sp=2, pp=2), None),
    (dict(pp=2), None),
    (dict(ep=2), None),
    (dict(remat=True, remat_policy="dots"), None)],
    ids=[f"kw{i}-Queue 1: parallel axes" for i in range(5)])
def test_unported_configs_raise(kw, match):
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            tt.transformer_init(0, _tcfg(**kw), device="cpu")
        return
    model = tt.transformer_init(0, _tcfg(**kw), device="cpu")
    assert model.cfg == _tcfg(**kw)
    layers = _KW["layers"] // kw.get("pp", 1)
    assert model.block["wq"].shape[0] == layers
    assert ("w_router" in model.block) == bool(kw.get("num_experts"))


def test_fp8_and_remat_knobs(monkeypatch, jax_side):
    params, tokens, _ = jax_side
    cfg = _tcfg()
    model = _port(params, cfg)
    off = tt.transformer_loss(model, torch.from_numpy(tokens), cfg)
    monkeypatch.setenv("HVDT_FP8", "matmul")
    # The e4m3 projections (tests/test_torch_port_fp8.py holds them to
    # the reference): a finite loss that is not the f32 one.
    fp8 = tt.transformer_loss(model, torch.from_numpy(tokens), cfg)
    assert torch.isfinite(fp8) and fp8.item() != off.item()
    monkeypatch.setenv("HVDT_FP8", "bogus")
    with pytest.raises(ValueError, match="valid: off, matmul"):
        tt.transformer_loss(model, torch.from_numpy(tokens), cfg)
    monkeypatch.delenv("HVDT_FP8")
    monkeypatch.setenv("HVDT_REMAT", "full")
    assert tt.remat_from_env(cfg).remat
    assert not tt.remat_from_env(cfg, "none").remat
    dots = tt.remat_from_env(cfg, "dots")
    assert dots.remat and dots.remat_policy == "dots"
    with pytest.raises(ValueError, match="valid: none, full, dots"):
        tt.checkpoint_policy("bogus")


def test_flops_per_token_matches_jax():
    kw = dict(vocab=30528, layers=24, d_model=1024, heads=16, kv_heads=16,
              d_ff=4096, max_seq=4096)
    assert (tt.transformer_flops_per_token(tt.TransformerConfig(**kw))
            == jt.transformer_flops_per_token(jt.TransformerConfig(**kw)))


def test_entry_points_need_cuda_or_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.transformer_init(0, _tcfg())


# ---- convert and the optimizer -------------------------------------------


def test_convert_round_trip():
    params = _numpy_params(3)
    model = _port(params, _tcfg())
    want = _param_tensors(params)
    sd = model.state_dict()
    assert list(dict(model.named_parameters())) and len(sd) == 11
    assert set(sd) == set(want)
    for name, t in sd.items():
        np.testing.assert_array_equal(t.numpy(), want[name].numpy())
    # Stacked block leaves, [layers, in, out] as in the reference.
    assert sd["block.wq"].shape == (2, 64, 64)
    assert sd["block.wk"].shape == (2, 64, 32)


@pytest.fixture
def world1():
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def test_fused_adamw_step_matches_optax(jax_side, world1):
    """DistributedOptimizer(fused_adam(lr, weight_decay)) from an
    optax.adamw state (its ScaleByAdamState is opt_state[0], carried by
    optimizer_state_from_jax) takes the optax.adamw step — and the JAX
    package's fused_adam step."""
    params, tokens, get = jax_side
    _, grads = get("off", "xla", 0)
    jparams = jax.tree.map(jnp.asarray, params)
    tx = optax.adamw(_LR, weight_decay=_WD)
    state = tx.init(jparams)
    # One earlier step, so the state carries a count and moments.
    jgrads = jax.tree.map(lambda g: jnp.asarray(g) * 0.5,
                          {"embed": grads["embed"].numpy(),
                           "ln_f": grads["ln_f"].numpy(),
                           "block": {n[6:]: g.numpy() for n, g in
                                     grads.items() if n.startswith("block.")}})
    _, state = tx.update(jgrads, state, jparams)
    cfg = _tcfg()
    model = _port(params, cfg)
    opt = hvd.DistributedOptimizer(tok.fused_adam(model.parameters(), _LR,
                                                  weight_decay=_WD))
    optimizer_state_from_jax(state, model, opt)
    assert opt.param_groups[0]["count"] == 1
    for n, p in model.named_parameters():
        p.grad = grads[n].clone()
    opt.step()
    full = {"embed": grads["embed"].numpy(), "ln_f": grads["ln_f"].numpy(),
            "block": {n[6:]: g.numpy() for n, g in grads.items()
                      if n.startswith("block.")}}
    full = jax.tree.map(jnp.asarray, full)
    updates, _ = tx.update(full, state, jparams)
    want = _param_tensors(_np(optax.apply_updates(jparams, updates)))
    fused = jax_fused_adam(_LR, weight_decay=_WD)
    f_updates, _ = fused.update(full, state[0], jparams)
    want_fused = _param_tensors(_np(optax.apply_updates(jparams, f_updates)))
    before = _param_tensors(params)
    got = {n: (p.detach() - before[n]).numpy()
           for n, p in model.named_parameters()}
    _assert_rel(got, {n: (w - before[n]).numpy() for n, w in want.items()})
    _assert_rel(got, {n: (w - before[n]).numpy()
                      for n, w in want_fused.items()})


def test_optimizer_state_from_jax_rejects_unknown_state():
    model = _port(_numpy_params(), _tcfg())
    opt = tok.fused_adam(model.parameters(), _LR)
    with pytest.raises(TypeError, match="unsupported optimizer state"):
        optimizer_state_from_jax((optax.EmptyState(),), model, opt)


# ---- two-process gloo world -----------------------------------------------

_WORKER = r"""
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import transformer as tt

data = np.load(sys.argv[1])
hvd.init(device="cpu")
r = hvd.rank()
cfg = tt.TransformerConfig(vocab=128, layers=2, d_model=64, heads=4,
                           kv_heads=2, d_ff=128, max_seq=128,
                           dtype=torch.float32, loss_chunk=32)
model = tt.transformer_init(1 + r, cfg, device="cpu")
if r == 0:
    model.load_state_dict({k[3:]: torch.from_numpy(data[k])
                           for k in data.files if k.startswith("sd.")})
hvd.broadcast_parameters(model.state_dict(), root_rank=0)
opt = hvd.DistributedOptimizer(hvd.fused_adam(
    model.parameters(), float(data["lr"]), weight_decay=float(data["wd"])))
tokens = torch.from_numpy(data["tokens"][r:r + 1])
loss = tt.transformer_loss(model, tokens, cfg)
loss.backward()
opt.step()
res = {}
for k, p in model.named_parameters():
    res["grad." + k] = p.grad.numpy().copy()
    res["param." + k] = p.detach().numpy().copy()
np.savez(sys.argv[2], **res)
hvd.shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_step_matches_global_batch(tmp_path, monkeypatch):
    """Each rank takes one of the two sequences; DistributedOptimizer
    averages the gradients, which is the global-batch gradient (the loss
    is a mean over equal halves), and both ranks take the fused Adam
    step the JAX package's fused_adam takes on it."""
    for knob in ("HVDT_FLASH_ATTENTION", "HVDT_FLASH_BWD", "HVDT_FP8"):
        monkeypatch.delenv(knob, raising=False)
    params = _numpy_params(4)
    tokens = _tokens(5)
    sd = transformer_params_from_jax(params)
    np.savez(tmp_path / "in.npz", tokens=tokens, lr=np.float32(_LR),
             wd=np.float32(_WD), **{"sd." + k: v.numpy() for k, v in sd.items()})
    env = dict(os.environ, HVDT_SIZE="2",
               HVDT_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(tmp_path / "in.npz"),
         str(tmp_path / f"out{r}.npz")], env=dict(env, HVDT_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]

    cfg = _jcfg(loss_chunk=32)
    jparams = jax.tree.map(jnp.asarray, params)
    grads = jax.grad(jt.transformer_loss)(jparams, jnp.asarray(tokens), cfg)
    tx = jax_fused_adam(_LR, weight_decay=_WD)
    updates, _ = tx.update(grads, tx.init(jparams), jparams)
    new = _param_tensors(_np(optax.apply_updates(jparams, updates)))
    want_g = _param_tensors(_np(grads))
    init = _param_tensors(params)

    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out.decode()[-3000:]
    res = [np.load(tmp_path / f"out{r}.npz") for r in range(2)]
    for r in range(2):
        _assert_rel({k: res[r]["grad." + k] for k in want_g},
                    {k: g.numpy() for k, g in want_g.items()})
        _assert_rel({k: res[r]["param." + k] - init[k].numpy()
                     for k in new},
                    {k: (p - init[k]).numpy() for k, p in new.items()})
    for k in new:
        np.testing.assert_array_equal(res[0]["param." + k],
                                      res[1]["param." + k], err_msg=k)
