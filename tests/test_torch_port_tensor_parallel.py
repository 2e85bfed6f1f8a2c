"""PyTorch port, the transformer LM over ``tp`` and ``fsdp`` and the
sequence axis beside ``dp``, ``ep`` and ``pp``
(horovod_tpu_torch/models/transformer.py with ``tp_group=`` /
``fsdp_group=``, ``DistributedOptimizer(axis="dp")``'s fold) held against
the JAX package's models/transformer.py on the same numpy weights and
tokens.

Size: 2 layers, d_model 64, 4 heads (GQA: 2 kv heads), d_ff 128, vocab
256, f32; seq 32 and a global batch of 4 unless a case says otherwise.
The weights are the JAX package's parameter tree filled from numpy and
carried over by ``convert.transformer_params_from_jax`` with each
member's part (``pp`` / ``ep`` / ``tp`` / ``fsdp``).  The batch rows shard
over the data axes (dp, fsdp, ep), the sequence over ``sp``; every ``tp``
member and every ``pp`` stage sees the same rows.

One gloo world of 2 processes runs ``tp2`` (heads and MLP columns over
2), ``fsdp2`` (``embed`` dims over 2, ``loss_chunk``) and
``tp2_smallseq`` (seq 128 with ``HVDT_FLASH_SMALLSEQ=on``: the port's
plain version of #12/#13 on the member's 2 local heads, the reference's
kernel in interpret mode on all 4); one world of 4 runs ``dp2_tp2``,
``fsdp2_tp2`` (with ``remat``: the gathers run again in the recompute),
``sp2_dp2``, ``sp2_ep2`` (4 experts, top-2, capacity factor 4: no drops),
``sp2_pp2`` and ``tp2_ep2`` (the same experts, each expert's ``mlp``
columns over ``tp``, the router replicated).  Each world is spawned
once, in a module-scoped fixture.

References: the reference's single-device ``transformer_loss`` /
``transformer_apply`` and ``jax.grad`` on the global batch (one jitted
run serves every case with its config and tokens; tp2 is also held
against the reference's own GSPMD run over a ``dp 4 x tp 2`` mesh of the
CPU's 8 devices, as tests/test_models.py builds it).  An sp case's loss
is the mean of the ring members' local losses (each shard's next-token
loss within the shard, as ``transformer_loss`` gives a member), taken
from the same run's logits.  sp2_ep2 routes its tokens at top-2 with
the gate renormalised over the chosen experts, which the reference's
single-device MoE (its dense top-1 fallback) does not compute: it is
held against the reference's ``shard_map`` over ("ep", "sp"), the loss
averaged by ``lax.pmean``, as its ``transformer_hidden`` composes the two
manual axes; tp2_ep2 likewise against its ``shard_map`` over ("ep",),
the whole (unsharded over ``tp``) experts of each ``ep`` member.  Each member's gradients after
``DistributedOptimizer(fused_adam, axis="dp", ...).synchronize()`` are
held to its part of the reference's gradient, and its parameters after
the step to its part of the reference's ``fused_adam`` step (the XLA
path, ``use_kernels=False``; eps 1e-3, see ``_EPS``); every leaf is equal,
gradient and parameter, on every member that holds the same part of it.

Tolerances (f32): logits and loss within rtol 5e-4 / atol 5e-4 (the
reference's own test_tp_matches_single_device); gradients and the step's
parameter updates within 1e-4 relative L2 per leaf.
"""

import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from horovod_tpu.models import transformer as jt
from horovod_tpu.ops.optim_kernels import fused_adam as jax_fused_adam
from horovod_tpu.parallel import sharding as jsharding
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.parallel import local_part

ROOT = pathlib.Path(__file__).resolve().parents[1]
_KW = dict(vocab=256, layers=2, d_model=64, heads=4, kv_heads=2, d_ff=128,
           max_seq=32)
_B, _L = 4, 32
# Adam's first step is g / (|g| + eps) per element: with the default eps
# an element whose gradient is a near-cancelled sum (|g| ~ 1e-8, its
# relative rounding O(1)) moves by up to 2 lr on either side, so the two
# packages' steps differ by ~1e-4 relative L2 while their gradients agree
# to ~1e-6.  eps 1e-3 keeps the step a smooth function of the gradient.
_LR, _WD, _EPS = 1e-2, 1e-4, 1e-3
_RTOL = _ATOL = 5e-4
_REL = 1e-4

# name: (world, mesh sizes, config, reference, env).  reference: "single"
# (one device, the global batch) or the two shard_map axes.
_MOE = dict(num_experts=4, ep=2, capacity_factor=4.0)
_CASES = {
    "tp2": (2, dict(dp=1, tp=2), dict(tp=2), "single", {}),
    "fsdp2": (2, dict(dp=1, fsdp=2), dict(fsdp=2, loss_chunk=64), "single",
              {}),
    "tp2_smallseq": (2, dict(dp=1, tp=2), dict(tp=2, max_seq=128),
                     "single", {"HVDT_FLASH_SMALLSEQ": "on"}),
    "dp2_tp2": (4, dict(dp=2, tp=2), dict(tp=2), "single", {}),
    "fsdp2_tp2": (4, dict(dp=1, fsdp=2, tp=2), dict(fsdp=2, tp=2,
                                                     remat=True), "single",
                  {}),
    "sp2_dp2": (4, dict(dp=2, sp=2), dict(sp=2), "single", {}),
    "sp2_ep2": (4, dict(dp=1, ep=2, sp=2), dict(sp=2, **_MOE), ("ep", "sp"),
                {"HVDT_MOE_TOPK": "2"}),
    "sp2_pp2": (4, dict(dp=1, pp=2, sp=2), dict(sp=2, pp=2), "single", {}),
    "tp2_ep2": (4, dict(dp=1, ep=2, tp=2), dict(tp=2, **_MOE), ("ep",),
                {"HVDT_MOE_TOPK": "2"}),
}
_SMALLSEQ_SHAPE = (2, 128)       # batch, seq of tp2_smallseq


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jcfg(**kw):
    return jt.TransformerConfig(dtype=jnp.float32, **{**_KW, **kw})


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


def _numpy_params(moe: bool, seed=0):
    cfg = _jcfg(**(_MOE if moe else {}))
    shapes = jax.eval_shape(lambda key: jt.transformer_init(key, cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if "ln" in jax.tree_util.keystr(path):
            return np.ones(leaf.shape, np.float32)
        return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)

    return jax.tree.map(np.asarray,
                        jax.tree_util.tree_map_with_path(fill, shapes))


def _tokens(name):
    b, l = _SMALLSEQ_SHAPE if name == "tp2_smallseq" else (_B, _L)
    return np.random.default_rng(1).integers(0, 256, (b, l)).astype(np.int32)


def _ref_cfg(name):
    """The reference's single-device config of a case: the port's
    without tp / fsdp (GSPMD owns them there), sp and pp (one device runs
    the whole sequence and every layer), remat and loss_chunk (the port's
    own tests hold those to the plain paths)."""
    extra = {k: v for k, v in _CASES[name][2].items()
             if k not in ("tp", "fsdp", "sp", "pp", "remat", "loss_chunk")}
    return _jcfg(**extra)


def _sp_loss(logits, tokens, sp):
    """The mean of the ``sp`` members' local losses: next-token cross
    entropy within each sequence shard (a shard's last position has no
    target), every shard the same length."""
    b, l, _ = logits.shape
    n = l // sp
    logp = jax.nn.log_softmax(logits.reshape(b, sp, n, -1)[:, :, :-1], -1)
    tgt = tokens.reshape(b, sp, n)[:, :, 1:]
    return -jnp.take_along_axis(logp, tgt[..., None], -1).mean()


@jax.jit
def _adam_step(p, grads):
    # One compiled program a parameter tree, not some hundred op-by-op
    # dispatches a case.
    tx = jax_fused_adam(_LR, eps=_EPS, weight_decay=_WD, use_kernels=False)
    updates, _ = tx.update(grads, tx.init(p), p)
    return jax.tree.map(lambda a, u: a + u, p, updates)


_SINGLE = {}


def _reference(name, params, tokens):
    """(loss, logits, gradients, parameters after one fused_adam step) of
    the reference: on one device (the global batch; an sp case's loss is
    the mean of the ring members' local losses) or, for sp2_ep2, under
    ``shard_map`` over ("ep", "sp")."""
    _, _, kw, ref, env = _CASES[name]
    cfg = _ref_cfg(name)
    p = jax.tree.map(jnp.asarray, params)
    t = jnp.asarray(tokens)
    if ref == "single":
        key = (cfg, tokens.shape, tuple(sorted(env.items())))
        if key not in _SINGLE:
            def losses(p, t):
                logits = jt.transformer_apply(p, t, cfg)
                return jt.transformer_loss(p, t, cfg), _sp_loss(logits, t, 2)

            def run(p, t):
                (loss, loss_sp), vjp = jax.vjp(lambda q: losses(q, t), p)
                one, zero = jnp.ones(()), jnp.zeros(())
                return (loss, loss_sp, jt.transformer_apply(p, t, cfg),
                        vjp((one, zero))[0], vjp((zero, one))[0])

            with mock.patch.dict(os.environ, env):
                _SINGLE[key] = jax.jit(run)(p, t)
        loss, loss_sp, logits, grads, grads_sp = _SINGLE[key]
        if kw.get("sp", 1) > 1:
            loss, grads = loss_sp, grads_sp
    else:
        mesh = Mesh(np.asarray(jax.devices()[:2 ** len(ref)]).reshape(
            (2,) * len(ref)), ref)
        ecfg = _jcfg(**{k: v for k, v in kw.items() if k != "tp"})

        def spec(lg):
            s = ["ep" if n == "experts" else None for n in lg]
            while s and s[-1] is None:
                s.pop()
            return P(*s)

        specs = jax.tree.map(spec, jt.transformer_logical_axes(ecfg),
                             is_leaf=lambda x: isinstance(x, tuple))

        def local(p, t):
            loss = jt.transformer_loss(p, t, ecfg)
            v = tuple(set(jax.typeof(loss).vma) & set(ref))
            return (lax.pmean(loss, v) if v else loss,
                    jt.transformer_apply(p, t, ecfg))

        fn = jax.shard_map(local, mesh=mesh, in_specs=(specs, P(*ref)),
                           out_specs=(P(), P(*ref)))
        with mock.patch.dict(os.environ, env):
            (loss, logits), grads = jax.jit(jax.value_and_grad(
                fn, has_aux=True))(p, t)
    new = _adam_step(p, grads)
    return (float(loss), np.asarray(logits),
            _flat(jax.tree.map(np.asarray, grads)),
            _flat(jax.tree.map(np.asarray, new)))


def _gspmd_tp(params, tokens):
    """The reference's GSPMD run over dp 4 x tp 2 (tests/test_models.py's
    construction): loss, logits and gradients."""
    cfg = _jcfg()
    mesh = Mesh(np.asarray(jax.devices()).reshape(4, 2), ("dp", "tp"))
    rules = jsharding.transformer_rules()
    sharded = jax.tree.map(
        lambda a, lg: jax.device_put(jnp.asarray(a), NamedSharding(
            mesh, jsharding.logical_to_mesh(lg, rules, mesh))),
        params, jt.transformer_logical_axes(cfg),
        is_leaf=lambda x: isinstance(x, tuple) and all(
            isinstance(e, (str, type(None))) for e in x))

    def both(p, t):
        return (jt.transformer_loss(p, t, cfg),
                jt.transformer_apply(p, t, cfg))

    (loss, logits), grads = jax.jit(
        jax.value_and_grad(both, has_aux=True),
        out_shardings=NamedSharding(mesh, P()))(sharded, jnp.asarray(tokens))
    return float(loss), np.asarray(logits), _flat(jax.tree.map(np.asarray,
                                                               grads))


_WORKER = r"""
import json, os, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.convert import transformer_params_from_jax
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.parallel import make_mesh, local_part, sharded_axes

cases = json.loads(sys.argv[3])
hvd.init(device="cpu")
seen_heads = []
plain_smallseq = tt.flash_attention_smallseq


def spy(q, k, v, **kw):
    seen_heads.append([int(q.shape[2]), int(k.shape[2])])
    return plain_smallseq(q, k, v, **kw)


tt.flash_attention_smallseq = spy
res = {}
for name, (sizes, kw, env) in cases.items():
    data = np.load(os.path.join(sys.argv[1], name + ".npz"))
    params = {"block": {}}
    for key in data.files:
        if key.startswith("block."):
            params["block"][key[6:]] = data[key]
        elif key != "tokens":
            params[key] = data[key]
    os.environ.update(env)
    mesh = make_mesh(**sizes)
    coords = {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}
    cfg = tt.TransformerConfig(dtype=torch.float32, **kw)
    moe = bool(cfg.num_experts)
    model = tt.transformer_init(0, cfg, device="cpu", **{
        a + "_rank": coords.get(a, 0) for a in ("pp", "ep", "tp", "fsdp")})
    given = {a: (coords[a], sizes[a]) for a in ("pp", "ep", "tp", "fsdp")
             if sizes.get(a, 1) > 1}
    model.load_state_dict(transformer_params_from_jax(params, **given))
    tokens = torch.from_numpy(np.ascontiguousarray(local_part(
        data["tokens"], ("batch", "seq"),
        {"batch": ("dp", "fsdp", "ep"), "seq": "sp"}, sizes, coords)))
    groups = {a + "_group": mesh for a in ("sp", "ep", "pp", "tp", "fsdp")
              if sizes.get(a, 1) > 1}
    opt = hvd.DistributedOptimizer(
        hvd.fused_adam(model.parameters(), float(sys.argv[4]),
                       eps=float(sys.argv[6]), weight_decay=float(sys.argv[5])),
        axis="dp", pipeline="pp" if cfg.pp > 1 else None,
        expert="ep" if moe and cfg.ep > 1 else None)
    seen_heads.clear()
    with torch.no_grad():
        logits = tt.transformer_apply(model, tokens, cfg, **groups)
    loss = tt.transformer_loss(model, tokens, cfg, **groups)
    loss.backward()
    opt.synchronize()
    res[name + ".loss"] = np.array(loss.item())
    res[name + ".logits"] = logits.numpy()
    res[name + ".coords"] = np.array(json.dumps(coords))
    res[name + ".heads"] = np.array(seen_heads, dtype=np.int64).reshape(-1, 2)
    for k, p in model.named_parameters():
        res[name + ".grad." + k] = p.grad.numpy().copy()
        res[name + ".axes." + k] = np.array(",".join(sharded_axes(p)))
    opt.optimizer.step()
    for k, p in model.named_parameters():
        res[name + ".param." + k] = p.detach().numpy().copy()
    for k in env:
        del os.environ[k]
np.savez(sys.argv[2], **res)
hvd.shutdown()
"""


def _spawn(world, names, tmp):
    cases = {name: (_CASES[name][1], {**_KW, **_CASES[name][2]},
                    _CASES[name][4]) for name in names}
    env = dict(os.environ, HVDT_SIZE=str(world),
               HVDT_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for k in ("HVDT_TRANSPORT", "HVDT_OVERLAP", "HVDT_ZERO",
              "HVDT_FLASH_SMALLSEQ", "HVDT_FLASH_ATTENTION", "HVDT_MOE_TOPK",
              "HVDT_RING_PALLAS"):
        env.pop(k, None)
    return [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(tmp),
         str(tmp / f"out{world}_{r}.npz"), json.dumps(cases), str(_LR),
         str(_WD), str(_EPS)],
        env=dict(env, HVDT_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Per case: the members' results (each a dict with ``coords``), the
    reference's (loss, logits, grads, params) and the initial params."""
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    inputs = {}
    for name, case in _CASES.items():
        params = _numpy_params(moe=bool(case[2].get("num_experts")))
        tokens = _tokens(name)
        inputs[name] = (params, tokens)
        np.savez(tmp / f"{name}.npz", tokens=tokens, **_flat(params))
    procs = {n: _spawn(n, [k for k, c in _CASES.items() if c[0] == n], tmp)
             for n in (2, 4)}
    want = {name: _reference(name, *inputs[name]) for name in _CASES}
    gspmd = _gspmd_tp(*inputs["tp2"])
    got = {name: [] for name in _CASES}
    for n, ps in procs.items():
        for r, p in enumerate(ps):
            log, _ = p.communicate(timeout=300)
            assert p.returncode == 0, log.decode()[-3000:]
            out = dict(np.load(tmp / f"out{n}_{r}.npz"))
            for name in got:
                if name + ".loss" in out:
                    got[name].append({k[len(name) + 1:]: v
                                      for k, v in out.items()
                                      if k.startswith(name + ".")})
    return got, want, gspmd, {n: _flat(p) for n, (p, _) in inputs.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _coords(res):
    return json.loads(str(res["coords"]))


def _part(name, leaf_name, leaf, coords):
    """The member's part of a global leaf (the port's own rules)."""
    cfg = tt.TransformerConfig(**{**_KW, **_CASES[name][2]})
    short = leaf_name[6:] if leaf_name.startswith("block.") else leaf_name
    ranks = {a + "_rank": coords.get(a, 0) for a in ("pp", "ep", "tp",
                                                     "fsdp")}
    return np.asarray(tt.local_slice(short, leaf, cfg, **ranks))


def _data_members(name, members):
    """One member per distinct data coordinate (dp, fsdp, ep, sp): the
    members whose local losses make up the global mean."""
    seen, out = set(), []
    for res in members:
        c = _coords(res)
        key = tuple(c.get(a, 0) for a in ("dp", "fsdp", "ep", "sp"))
        if key not in seen:
            seen.add(key)
            out.append(res)
    return out


@pytest.mark.parametrize("name", list(_CASES))
def test_layout_matches_reference(worlds, name):
    """Loss (the mean of the data members' local losses), each member's
    logits (its rows and sequence shard of the reference's), gradients
    after synchronize() and the fused_adam step's update of its part."""
    got, want, _, init = worlds
    loss, logits, grads, new = want[name]
    members = got[name]
    assert len(members) == _CASES[name][0]
    losses = [float(r["loss"]) for r in _data_members(name, members)]
    np.testing.assert_allclose(np.mean(losses), loss, rtol=_RTOL,
                               atol=_ATOL)
    # The reference's logits are the global [batch, seq, vocab] (the
    # shard_map's out_specs reassemble them); each member holds its rows
    # and its shard of the sequence.
    rows = {"batch": ("dp", "fsdp", "ep"), "seq": "sp"}
    sizes = dict(_CASES[name][1])
    for res in members:
        c = _coords(res)
        np.testing.assert_allclose(
            res["logits"], local_part(logits, ("batch", "seq"), rows, sizes,
                                      c), rtol=_RTOL, atol=_ATOL)
        for leaf, g in grads.items():
            w = _part(name, leaf, g, c)
            assert res["grad." + leaf].shape == w.shape, leaf
            assert _rel(res["grad." + leaf], w) < _REL, (
                leaf, c, _rel(res["grad." + leaf], w))
            before = _part(name, leaf, init[name][leaf], c)
            step = res["param." + leaf] - before
            want_step = _part(name, leaf, new[leaf], c) - before
            assert _rel(step, want_step) < _REL, (leaf, c,
                                                  _rel(step, want_step))


@pytest.mark.parametrize("name", list(_CASES))
def test_every_member_holds_the_same_replicated_values(worlds, name):
    """A leaf's gradient after synchronize() and its value after the step
    are equal, bit for bit, on every member that holds the same part of
    it (all members, for a leaf sharded over no axis)."""
    got, _, _, _ = worlds
    members = got[name]
    leaves = [k[5:] for k in members[0] if k.startswith("grad.")]
    replicated = 0
    for leaf in leaves:
        axes = [a for a in str(members[0]["axes." + leaf]).split(",") if a]
        replicated += not axes
        groups = {}
        for res in members:
            c = _coords(res)
            groups.setdefault(tuple(c.get(a, 0) for a in axes),
                              []).append(res)
        for same in groups.values():
            for res in same[1:]:
                for kind in ("grad.", "param."):
                    np.testing.assert_array_equal(
                        res[kind + leaf], same[0][kind + leaf],
                        err_msg=f"{name} {kind}{leaf}")
    assert replicated >= 1


def test_tp_matches_the_reference_gspmd_run(worlds):
    """tp2 against the reference's own GSPMD tensor parallelism (dp 4 x
    tp 2 over the CPU's 8 devices): loss, logits and each member's part
    of every gradient."""
    got, _, gspmd, _ = worlds
    loss, logits, grads = gspmd
    for res in got["tp2"]:
        np.testing.assert_allclose(float(res["loss"]), loss, rtol=_RTOL,
                                   atol=_ATOL)
        np.testing.assert_allclose(res["logits"], logits, rtol=_RTOL,
                                   atol=_ATOL)
        c = _coords(res)
        for leaf, g in grads.items():
            w = _part("tp2", leaf, g, c)
            assert _rel(res["grad." + leaf], w) < _REL, leaf


def test_layouts_shard_what_the_rules_say(worlds):
    """Which axes each leaf is marked sharded over, and the local shapes
    that follow (wk / wv stay whole under tp: kv is replicated)."""
    got, _, _, _ = worlds
    tp = got["fsdp2_tp2"][0]
    want = {"embed": "fsdp", "ln_f": "", "block.ln1": "",
            "block.wq": "fsdp,tp", "block.wk": "fsdp", "block.wv": "fsdp",
            "block.wo": "tp,fsdp", "block.w_up": "fsdp,tp",
            "block.w_gate": "fsdp,tp", "block.w_down": "tp,fsdp"}
    for leaf, axes in want.items():
        assert str(tp["axes." + leaf]) == axes, leaf
    assert tp["grad.block.wq"].shape == (2, 32, 32)
    assert tp["grad.block.wk"].shape == (2, 32, 32)
    assert tp["grad.block.wo"].shape == (2, 32, 32)
    assert tp["grad.embed"].shape == (256, 32)
    pp = got["sp2_pp2"][0]
    assert str(pp["axes.block.wq"]) == "pp"
    assert str(got["sp2_ep2"][0]["axes.block.w_up"]) == "ep"


def test_smallseq_runs_on_the_local_heads(worlds):
    """tp2_smallseq takes the whole-sequence path (#12/#13's plain
    version) on each member's 2 of 4 heads (1 of 2 kv heads), once a
    layer in the forward (apply, then the loss)."""
    got, _, _, _ = worlds
    for res in got["tp2_smallseq"]:
        heads = res["heads"]
        assert len(heads) == 2 * _KW["layers"], heads
        assert (heads == [2, 1]).all(), heads
    for res in got["tp2"]:
        assert len(res["heads"]) == 0


# ---- in-process: configs, groups and the optimizer contract ---------------


@pytest.mark.parametrize("kw,exc,match", [
    (dict(tp=3), ValueError, "heads 4 not divisible by tp 3"),
    (dict(tp=4), ValueError, "kv_heads 2 not divisible by tp 4"),
    (dict(tp=2, d_ff=127), ValueError, "d_ff 127 not divisible by tp 2"),
    (dict(fsdp=3), ValueError, "d_model 64 not divisible by fsdp 3"),
    (dict(tp=2, num_experts=4), None, None)], ids=[
        "kw0-ValueError-heads 4 not divisible by tp 3",
        "kw1-ValueError-kv_heads 2 not divisible by tp 4",
        "kw2-ValueError-d_ff 127 not divisible by tp 2",
        "kw3-ValueError-d_model 64 not divisible by fsdp 3",
        "kw4-NotImplementedError-parallel axes, part 3"])
def test_config_checks(kw, exc, match):
    """The configs a member cannot hold raise; tp with experts builds,
    each expert's ``mlp`` columns over ``tp`` and the router whole (the
    id of the last case is that of the raise it replaced)."""
    import torch

    cfg = tt.TransformerConfig(dtype=torch.float32, **{**_KW, **kw})
    if exc is not None:
        with pytest.raises(exc, match=match):
            tt.transformer_init(0, cfg, device="cpu")
        return
    model = tt.transformer_init(0, cfg, device="cpu", tp_rank=1)
    f = _KW["d_ff"] // 2
    assert model.block["w_up"].shape == (2, 4, _KW["d_model"], f)
    assert model.block["w_down"].shape == (2, 4, f, _KW["d_model"])
    assert model.block["w_router"].shape == (2, _KW["d_model"], 4)
    whole = tt.transformer_init(0, dataclasses.replace(cfg, tp=1),
                                device="cpu")
    np.testing.assert_array_equal(model.block["w_up"].detach().numpy(),
                                  whole.block["w_up"][..., f:].detach().numpy())


def test_groups_and_optimizer_axis_checks():
    """tp / fsdp groups must be given for a degree above one and have its
    size; a group of one at degree one runs the unsharded model, byte for
    byte; axis= naming tp or fsdp raises."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import make_mesh

    cfg = tt.TransformerConfig(dtype=torch.float32, **_KW)
    tokens = torch.from_numpy(_tokens("tp2")).long()
    hvd.init(device="cpu")
    try:
        mesh = make_mesh(dp=1, fsdp=1, tp=1)
        model = tt.transformer_init(0, cfg, device="cpu")
        plain = tt.transformer_loss(model, tokens, cfg)
        ones = tt.transformer_loss(model, tokens, cfg, tp_group=mesh,
                                   fsdp_group=mesh)
        assert plain.item() == ones.item()
        for axis in ("tp", "fsdp"):
            wide = tt.TransformerConfig(dtype=torch.float32,
                                        **{**_KW, axis: 2})
            part = tt.transformer_init(0, wide, device="cpu")
            with pytest.raises(ValueError, match=f"needs {axis}_group"):
                tt.transformer_loss(part, tokens, wide)
            with pytest.raises(ValueError,
                               match=f"{axis}_group has 1 members"):
                tt.transformer_loss(part, tokens, wide,
                                    **{axis + "_group": mesh})
        params = list(model.parameters())
        for axis in ("tp", ("dp", "fsdp")):
            with pytest.raises(ValueError, match="parameter-SHARDED"):
                hvd.DistributedOptimizer(torch.optim.SGD(params, 0.1),
                                         axis=axis)
        opt = hvd.DistributedOptimizer(torch.optim.SGD(params, 0.1),
                                       axis="dp")
        assert opt._axis == "dp"
    finally:
        hvd.shutdown()
