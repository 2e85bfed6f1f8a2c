"""PyTorch port, ring attention and the sequence-parallel LM
(horovod_tpu_torch/parallel/, models/transformer.py with sp > 1) held
against the JAX package's parallel/ring_attention.py and
models/transformer.py on the same numpy inputs.

* One 4-process gloo world runs the port's ``ring_attention`` over
  ``make_mesh(sp=4)`` for every case below; the reference runs under
  ``jax.shard_map`` over ``make_mesh(sp=4)`` of four CPU devices (with
  ``use_pallas=True`` its Pallas kernels run in interpret mode, under
  ``check_vma=False`` as tests/test_parallel.py runs them, and the
  port's kernel wrappers take their plain versions).  Forward and the
  gradients of ``((out * w) ** 2).sum()``: causal and not, MHA and GQA
  (H 4, Hkv 2), ``use_pallas`` on and off, ``segment_ids`` (plain, and
  with ``use_pallas=True``, which warns and runs the plain step on both
  sides), and a scale tensor that requires grad.
* One 2-process world trains the sp = 2 LM (the tiny f32 config of
  tests/test_models.py) against the reference's ``transformer_loss``
  under a shard_map over ``{'sp'}`` with ``pmean``: loss, gradients and
  one ``DistributedOptimizer(fused_adam)`` step, with and without
  ``loss_chunk`` and under ``remat``.
* In-process: ``MeshSpec``/``mesh_shape_for`` against the reference,
  the mesh of a world of one, the config checks, the ring under a
  (simulated) capture and the knob, a world of one against ``flash_attention``, and a world of
  one with ``segment_ids`` or a scale that requires grad (plain and
  kernel steps) against dense attention under autograd.

Tolerances (f32): out 2e-5 absolute and relative, as
tests/test_parallel.py holds the reference ring to dense attention;
gradients 1e-4 absolute and relative (sums over four ring steps of
products whose order differs from XLA's; at most 1e-5 absolute
measured, on gradients up to about 100).  LM: loss
rtol 1e-5, gradients and parameter updates 1e-4 relative L2 per tensor,
as tests/test_torch_port_transformer.py.  A world of one against
flash_attention: 2e-6 absolute, as tests/test_torch_port_flash.py.
"""

import importlib
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

import horovod_tpu_torch as hvd
from horovod_tpu.models import transformer as jt
from horovod_tpu.ops.optim_kernels import fused_adam as jax_fused_adam
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu.parallel import ring_attention as jax_ring_attention
from horovod_tpu_torch.common import graphs
from horovod_tpu_torch.convert import _param_tensors
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.ops import optim_kernels as tok
from horovod_tpu_torch.ops import pallas_kernels as tpk
from horovod_tpu_torch.parallel import mesh as tmesh

# The package exports the function under the module's name.
tring = importlib.import_module("horovod_tpu_torch.parallel.ring_attention")

ROOT = pathlib.Path(__file__).resolve().parents[1]
_SP, _B, _L, _H, _D = 4, 2, 128, 4, 16      # global L: 32 rows a member
_OUT_TOL = dict(atol=2e-5, rtol=2e-5)
_GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
_LR, _WD = 1e-2, 1e-4

# name -> (causal, kv heads, segment_ids, use_pallas, grad of the scale)
_CASES = {
    "causal_mha_plain": (True, 4, False, False, False),
    "causal_gqa_plain": (True, 2, False, False, False),
    "full_mha_plain": (False, 4, False, False, False),
    "full_gqa_plain": (False, 2, False, False, False),
    "causal_mha_pallas": (True, 4, False, True, False),
    "causal_gqa_pallas": (True, 2, False, True, False),
    "full_mha_pallas": (False, 4, False, True, False),
    "full_gqa_pallas": (False, 2, False, True, False),
    "segments_plain": (True, 4, True, False, False),
    "segments_pallas_warns": (True, 2, True, True, False),
    "scale_grad": (True, 2, False, False, True),
}
_KERNELS = (tpk._flash_fwd, tpk._flash_dq, tpk._flash_dkv)


@pytest.fixture(autouse=True)
def _no_launches():
    for fn in _KERNELS + (tok._adam_multi,):
        fn.launches = 0
    yield
    for fn in _KERNELS + (tok._adam_multi,):
        assert fn.launches == 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(worker: str, n: int, tmp, inputs: pathlib.Path):
    env = dict(os.environ, HVDT_SIZE=str(n),
               HVDT_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return [subprocess.Popen(
        [sys.executable, "-c", worker, str(inputs), str(tmp / f"out{r}.npz")],
        env=dict(env, HVDT_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(n)]


def _collect(procs, tmp):
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out.decode()[-3000:]
    return [dict(np.load(tmp / f"out{r}.npz")) for r in range(len(procs))]


# ---- the 4-process ring ----------------------------------------------------

_RING_WORKER = r"""
import sys, warnings
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel import make_mesh, ring_attention

data = np.load(sys.argv[1])
hvd.init(device="cpu")
mesh = make_mesh(sp=4)
r = mesh.get_local_rank("sp")
res = {}
for name in data["names"]:
    causal, hkv, seg, pallas, scale_grad = (int(x) for x in data["c." + name])
    n = data["q"].shape[1] // 4
    rows = slice(r * n, (r + 1) * n)
    q = torch.tensor(data["q"][:, rows], requires_grad=True)
    k = torch.tensor(data["k"][:, rows, :hkv], requires_grad=True)
    v = torch.tensor(data["v"][:, rows, :hkv], requires_grad=True)
    kw = dict(group=mesh, causal=bool(causal), use_pallas=bool(pallas))
    if seg:
        kw["segment_ids"] = torch.from_numpy(data["seg"][:, rows])
    if scale_grad:
        kw["scale"] = torch.tensor(float(data["scale"]), requires_grad=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = ring_attention(q, k, v, **kw)
    res[name + ".warned"] = np.array(len(caught))
    ((out * torch.from_numpy(data["w"])) ** 2).sum().backward()
    res[name + ".out"] = out.detach().numpy()
    for t, g in (("dq", q), ("dk", k), ("dv", v)):
        res[name + "." + t] = g.grad.numpy()
    if scale_grad:
        res[name + ".dscale"] = kw["scale"].grad.numpy()
np.savez(sys.argv[2], **res)
hvd.shutdown()
"""


def _ring_inputs():
    rng = np.random.default_rng(0)
    return dict(q=rng.standard_normal((_B, _L, _H, _D)).astype(np.float32),
                k=rng.standard_normal((_B, _L, _H, _D)).astype(np.float32),
                v=rng.standard_normal((_B, _L, _H, _D)).astype(np.float32),
                w=rng.standard_normal(_D).astype(np.float32),
                seg=np.repeat(rng.integers(0, 3, (_B, _L // 8)), 8,
                              axis=1).astype(np.int32),
                scale=np.float32(0.3))


def _jax_ring(inp, causal, hkv, seg, pallas, scale_grad):
    """The reference ring under shard_map: (out, dq, dk, dv[, dscale])."""
    mesh = jmesh.make_mesh(sp=_SP, devices=jax.devices()[:_SP])
    spec = P(None, "sp")
    q, w = jnp.asarray(inp["q"]), jnp.asarray(inp["w"])
    k, v = jnp.asarray(inp["k"][:, :, :hkv]), jnp.asarray(inp["v"][:, :, :hkv])
    segs = jnp.asarray(inp["seg"])
    scale = jnp.asarray(inp["scale"])

    def loss(q, k, v, scale):
        def local(q, k, v, s, scale):
            return jax_ring_attention(
                q, k, v, causal=causal, use_pallas=pallas,
                segment_ids=s if seg else None,
                scale=scale if scale_grad else None)
        out = jax.shard_map(local, mesh=mesh,
                            in_specs=(spec, spec, spec, spec, P()),
                            out_specs=spec, check_vma=not pallas)(
                                q, k, v, segs, scale)
        return ((out * w) ** 2).sum(), out

    argnums = (0, 1, 2, 3) if scale_grad else (0, 1, 2)
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=argnums, has_aux=True))(q, k, v, scale)
    return [np.asarray(x) for x in (out, *grads)]


@pytest.fixture(scope="module")
def ring_world(tmp_path_factory):
    """The port's results per rank and the reference's per case."""
    tmp = tmp_path_factory.mktemp("ring")
    inp = _ring_inputs()
    names = list(_CASES)
    np.savez(tmp / "in.npz", names=np.array(names),
             **{"c." + n: np.array(c, np.int32) for n, c in _CASES.items()},
             **inp)
    procs = _spawn(_RING_WORKER, _SP, tmp, tmp / "in.npz")
    want = {n: _jax_ring(inp, *c) for n, c in _CASES.items()}
    return _collect(procs, tmp), want


@pytest.mark.parametrize("name", list(_CASES))
def test_ring_matches_reference(ring_world, name):
    res, want = ring_world
    seg, pallas, scale_grad = _CASES[name][2:]

    def cat(key):
        return np.concatenate([r[f"{name}.{key}"] for r in res], axis=1)

    np.testing.assert_allclose(cat("out"), want[name][0], **_OUT_TOL)
    for key, w in zip(("dq", "dk", "dv"), want[name][1:4]):
        np.testing.assert_allclose(cat(key), w, err_msg=key, **_GRAD_TOL)
    if scale_grad:
        got = sum(float(r[f"{name}.dscale"]) for r in res)
        np.testing.assert_allclose(got, want[name][4], **_GRAD_TOL)
    warned = [int(r[f"{name}.warned"]) for r in res]
    assert warned == [int(seg and pallas)] * _SP


# ---- the 2-process sequence-parallel LM ------------------------------------

_LM_KW = dict(vocab=100, layers=2, d_model=32, heads=2, kv_heads=2, d_ff=64,
              max_seq=32, sp=2)
_LM_CASES = {"dense": dict(loss_chunk=0), "chunked": dict(loss_chunk=32),
             "chunked_remat": dict(loss_chunk=32, remat=True)}

_LM_WORKER = r"""
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.parallel import make_mesh

data = np.load(sys.argv[1], allow_pickle=True)
hvd.init(device="cpu")
mesh = make_mesh(sp=2)
r = mesh.get_local_rank("sp")
kw = data["kw"].item()
sd = {k[3:]: torch.from_numpy(data[k]) for k in data.files
      if k.startswith("sd.")}
l = data["tokens"].shape[1] // 2
tokens = torch.from_numpy(data["tokens"][:, r * l:(r + 1) * l])
res = {}
for name, extra in data["cases"].item().items():
    cfg = tt.TransformerConfig(dtype=torch.float32, **kw, **extra)
    model = tt.transformer_init(0, cfg, device="cpu")
    model.load_state_dict(sd)
    opt = hvd.DistributedOptimizer(hvd.fused_adam(
        model.parameters(), float(data["lr"]), weight_decay=float(data["wd"])))
    loss = tt.transformer_loss(model, tokens, cfg, sp_group=mesh)
    loss.backward()
    res[name + ".loss"] = np.array(loss.item())
    for k, p in model.named_parameters():
        res[name + ".grad." + k] = p.grad.numpy().copy()
    opt.step()
    for k, p in model.named_parameters():
        res[name + ".param." + k] = p.detach().numpy().copy()
np.savez(sys.argv[2], **res)
hvd.shutdown()
"""


def _lm_params(seed=0):
    """The reference's params tree, traced from transformer_init and
    filled from numpy (norms 1, weights N(0, 0.1²))."""
    cfg = jt.TransformerConfig(dtype=jnp.float32, **_LM_KW)
    shapes = jax.eval_shape(lambda key: jt.transformer_init(key, cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if "ln" in jax.tree_util.keystr(path):
            return np.ones(leaf.shape, np.float32)
        return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jax_lm(params, tokens, chunk):
    """The reference's sp = 2 loss (pmean over sp), its gradients and
    the fused_adam step's parameters."""
    cfg = jt.TransformerConfig(dtype=jnp.float32, loss_chunk=chunk,
                               **_LM_KW)
    mesh = jmesh.make_mesh(sp=2, devices=jax.devices()[:2])

    def loss_fn(p, t):
        def local(p, t):
            loss = jt.transformer_loss(p, t, cfg)
            varying = tuple(set(jax.typeof(loss).vma) & {"sp"})
            return lax.pmean(loss, varying) if varying else loss
        return jax.shard_map(local, mesh=mesh, in_specs=(P(), P(None, "sp")),
                             out_specs=P())(p, t)

    jparams = jax.tree.map(jnp.asarray, params)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jparams,
                                                       jnp.asarray(tokens))
    tx = jax_fused_adam(_LR, weight_decay=_WD)
    updates, _ = tx.update(grads, tx.init(jparams), jparams)
    new = optax.apply_updates(jparams, updates)
    return (float(loss), _param_tensors(jax.tree.map(np.asarray, grads)),
            _param_tensors(jax.tree.map(np.asarray, new)))


@pytest.fixture(scope="module")
def lm_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm")
    params = _lm_params()
    tokens = np.random.default_rng(1).integers(0, 100, (2, 32)).astype(
        np.int32)
    sd = _param_tensors(params)
    np.savez(tmp / "in.npz", tokens=tokens, lr=np.float32(_LR),
             wd=np.float32(_WD), kw=np.array(_LM_KW),
             cases=np.array(_LM_CASES),
             **{"sd." + k: v.numpy() for k, v in sd.items()})
    procs = _spawn(_LM_WORKER, 2, tmp, tmp / "in.npz")
    want = {chunk: _jax_lm(params, tokens, chunk) for chunk in (0, 32)}
    return _collect(procs, tmp), want, sd


def _assert_rel(got: dict, want: dict, tol=1e-4):
    assert set(got) == set(want)
    for name, w in want.items():
        w = np.asarray(w, np.float64)
        d = np.linalg.norm(np.asarray(got[name], np.float64) - w)
        assert d <= tol * np.linalg.norm(w) + 1e-12, (name, d)


@pytest.mark.parametrize("name", list(_LM_CASES))
def test_sp_lm_matches_reference(lm_world, name):
    """The members' mean loss is the reference's pmean loss; the mean of
    their gradients (what DistributedOptimizer averages) is its gradient,
    and both members take its fused_adam step.  remat changes nothing."""
    res, want, init = lm_world
    loss, grads, new = want[_LM_CASES[name]["loss_chunk"]]
    np.testing.assert_allclose(np.mean([r[name + ".loss"] for r in res]),
                               loss, rtol=1e-5)
    _assert_rel({k: (res[0][f"{name}.grad.{k}"] + res[1][f"{name}.grad.{k}"])
                 / 2 for k in grads}, {k: g.numpy() for k, g in grads.items()})
    for r in res:
        _assert_rel({k: r[f"{name}.param.{k}"] - init[k].numpy()
                     for k in new},
                    {k: (p - init[k]).numpy() for k, p in new.items()})
    for k in new:
        np.testing.assert_array_equal(res[0][f"{name}.param.{k}"],
                                      res[1][f"{name}.param.{k}"], err_msg=k)


# ---- in-process ------------------------------------------------------------


@pytest.mark.parametrize("sizes", [dict(tp=2, dp=4), dict(sp=4, dp=2),
                                   dict(sp=2, pp=2, ep=2, custom=3)])
def test_mesh_spec_matches_reference(sizes):
    got = tmesh.MeshSpec.create(**dict(sizes))
    want = jmesh.MeshSpec.create(**dict(sizes))
    assert got.axes == want.axes and got.total == want.total
    assert tmesh.CANONICAL_AXES == jmesh.CANONICAL_AXES
    for n, kw in ((8, dict(tp=2, pp=2)), (8, dict(sp=4)),
                  (16, dict(sp=2, ep=2, fsdp=2))):
        assert (tmesh.mesh_shape_for(n, **kw).axes
                == jmesh.mesh_shape_for(n, **kw).axes)
    with pytest.raises(ValueError):
        tmesh.MeshSpec.create(devices_total=8, dp=3)
    with pytest.raises(ValueError):
        tmesh.mesh_shape_for(8, sp=3)


@pytest.fixture
def world1():
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def test_make_mesh_world_of_one(world1):
    mesh = tmesh.make_mesh(dp=1, sp=1)
    assert mesh.mesh_dim_names == ("dp", "sp")
    assert mesh.device_type == "cpu"
    assert tring._Ring(mesh).size == 1
    with pytest.raises(ValueError, match="world has 1 ranks"):
        tmesh.make_mesh(sp=2)
    with pytest.raises(TypeError):
        tmesh.make_mesh(tmesh.MeshSpec.create(sp=1), dp=1)


# ep = 2 without experts and num_experts = 4 at ep = 1 run in a world of
# one since parallel axes, part 1 (exc None: the loss is finite); sp with
# pp builds since part 2, and in a world of one its loss asks for the
# ring's group (tests/test_torch_port_tensor_parallel.py runs it across
# 4 processes).  The ids are the ones these cases had while all of them
# raised.
@pytest.mark.parametrize("kw,exc,match", [
    (dict(sp=2), ValueError, "needs sp_group"),
    (dict(sp=2, pp=2), ValueError, "needs sp_group"),
    (dict(ep=2), None, None),
    (dict(num_experts=4), None, None)],
    ids=["kw0-ValueError-needs sp_group"] + [
        f"kw{i}-NotImplementedError-Queue 1: parallel axes"
        for i in (1, 2, 3)])
def test_sp_config_checks(world1, kw, exc, match):
    cfg = tt.TransformerConfig(dtype=torch.float32, **{**_LM_KW, "sp": 1,
                                                       **kw})
    tokens = torch.zeros((1, 8), dtype=torch.long)
    if exc is None:
        model = tt.transformer_init(0, cfg, device="cpu")
        assert torch.isfinite(tt.transformer_loss(model, tokens, cfg))
        return
    with pytest.raises(exc, match=match):
        model = tt.transformer_init(0, cfg, device="cpu")
        tt.transformer_loss(model, tokens, cfg)


def test_sp_group_size_must_match(world1):
    cfg = tt.TransformerConfig(dtype=torch.float32, **_LM_KW)
    model = tt.transformer_init(0, cfg, device="cpu")
    with pytest.raises(ValueError, match="sp_group has 1 members"):
        model(torch.zeros((1, 8), dtype=torch.long),
              sp_group=tmesh.make_mesh(sp=1))


def test_capture_raises(monkeypatch):
    """Under a capture the ring books its records through
    ``graphs.on_replay``: outside a ``donated_step`` capture that raises,
    as ``on_replay`` does; inside one the ring runs, forward and
    backward, with one replay hook a pass, and gives the eager values."""
    q = torch.tensor(np.random.default_rng(0).standard_normal(
        (1, 8, 2, 16)).astype(np.float32), requires_grad=True)
    monkeypatch.setattr(graphs, "capturing", lambda: True)
    with pytest.raises(RuntimeError, match="donated_step"):
        tring.ring_attention(q, q, q)
    with graphs.collect_replay_hooks() as hooks:
        out = tring.ring_attention(q, q, q)
        (grad,) = torch.autograd.grad(out.square().sum(), q)
    assert len(hooks) == 2
    monkeypatch.setattr(graphs, "capturing", lambda: False)
    want = tring.ring_attention(q, q, q)
    (want_grad,) = torch.autograd.grad(want.square().sum(), q)
    assert torch.equal(out, want) and torch.equal(grad, want_grad)


def _qkv(seed, b=2, l=64, h=4, hkv=2, d=16):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(s).astype(np.float32),
                         requires_grad=True)
            for s in ((b, l, h, d), (b, l, hkv, d), (b, l, hkv, d))]


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("world", ["none", "gloo"])
def test_world_of_one_matches_flash_attention(request, world, causal,
                                              use_pallas):
    """One member: no transfer, one step (the causal diagonal or a fully
    visible block), forward and backward as flash_attention's."""
    if world == "gloo":
        request.getfixturevalue("world1")
    q, k, v = _qkv(3)
    out = tring.ring_attention(q, k, v, causal=causal, use_pallas=use_pallas)
    do = torch.from_numpy(np.random.default_rng(4).standard_normal(
        out.shape).astype(np.float32))
    got = (out, *torch.autograd.grad(out, (q, k, v), do))
    ref = tpk.flash_attention(q, k, v, causal=causal)
    want = (ref, *torch.autograd.grad(ref, (q, k, v), do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(),
                                   atol=2e-6, rtol=0)


def _dense(q, k, v, causal, scale, seg):
    """Softmax attention over whole tensors, differentiated by autograd."""
    group = q.shape[2] // k.shape[2]
    k, v = (x.repeat_interleave(group, dim=2) for x in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    lq = q.shape[1]
    mask = torch.ones((lq, lq), dtype=torch.bool)
    if causal:
        mask = mask.tril()
    mask = mask[None, None]
    if seg is not None:
        mask = mask & (seg[:, :, None] == seg[:, None, :])[:, None]
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


@pytest.mark.parametrize("seg,scale_grad,use_pallas", [
    (True, False, False), (True, True, False), (False, True, False),
    (False, True, True)])
@pytest.mark.parametrize("causal", [True, False])
def test_world_of_one_segments_and_scale_grad_match_dense(causal, seg,
                                                          scale_grad,
                                                          use_pallas):
    """The ring's own backward pass masks by the rotated key labels and
    gives a grad-requiring scale sum(dq * q) / scale."""
    q, k, v = _qkv(7)
    labels = torch.from_numpy(np.repeat(np.random.default_rng(8).integers(
        0, 3, (2, 8)), 8, axis=1)) if seg else None
    scale = torch.tensor(0.3, requires_grad=scale_grad)
    out = tring.ring_attention(q, k, v, causal=causal, scale=scale,
                               segment_ids=labels, use_pallas=use_pallas)
    ref = _dense(q, k, v, causal, scale, labels)
    leaves = (q, k, v, scale) if scale_grad else (q, k, v)
    do = torch.from_numpy(np.random.default_rng(9).standard_normal(
        out.shape).astype(np.float32))
    got = (out, *torch.autograd.grad(out, leaves, do))
    want = (ref, *torch.autograd.grad(ref, leaves, do))
    np.testing.assert_allclose(got[0].detach().numpy(),
                               want[0].detach().numpy(), **_OUT_TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **_GRAD_TOL)


def test_knob_engages_kernel_steps_where_legal(monkeypatch):
    """HVDT_RING_PALLAS=1 engages the kernel step only where legal; an
    explicit use_pallas=True on illegal shapes warns and runs plain."""
    calls = []
    real = tring.flash_block_update
    monkeypatch.setattr(tring, "flash_block_update",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    q, k, v = _qkv(5, l=64)
    monkeypatch.delenv("HVDT_RING_PALLAS", raising=False)
    tring.ring_attention(q, k, v)
    assert calls == []
    monkeypatch.setenv("HVDT_RING_PALLAS", "1")
    tring.ring_attention(q, k, v)
    assert calls == [1]
    q2, k2, v2 = _qkv(6, l=200)          # 200 does not tile by 128
    tring.ring_attention(q2, k2, v2)
    with pytest.warns(UserWarning, match="use_pallas=True"):
        tring.ring_attention(q2, k2, v2, use_pallas=True)
    seg = torch.zeros((2, 64), dtype=torch.long)
    with pytest.warns(UserWarning, match="use_pallas=True"):
        tring.ring_attention(q, k, v, segment_ids=seg, use_pallas=True)
    assert calls == [1]
