"""PyTorch port: ZeRO sharding (horovod_tpu_torch/ops/zero.py and
``DistributedOptimizer(zero=...)``) against the JAX package's
ops/zero.py and against the port's own replicated path.

* Stage resolution, the env knob and every error message equal the
  reference's; ``_make_plan`` gives the reference's buckets, sizes,
  shard lengths and dtypes on ResNet-26's leaves; the checkpoint
  metadata and reshard functions give the reference's values on the
  same stacks.
* In a 4-process gloo world, on exactly representable gradients
  (multiples of 1/4, so no sum rounds in any order): ``rs_exchange``
  equals ``fused_allreduce`` bit for bit (and so under
  ``HVDT_OVERLAP=on``), the int8 wire stays within its block-scale
  bound; stages ``states`` and ``params`` over 5 steps of SGD-momentum
  and of Adam with weight decay, in the rank-local and replicated
  layouts and through ``DistributedOptimizer``, give each rank the rows
  of the unbound transform fed the global mean gradient, bit for bit,
  and those rows equal the matching rows of the reference's unbound
  ``zero_transform`` (use_kernels=False) within the replicated
  optimizer's port tolerance (f32: rtol 1e-6, atol 1e-7);
  ``HVDT_OVERLAP=on`` gives the same bytes as without it;
  ``rs_wire=False`` the same values in the same layout; a shard-count
  mismatch raises; on a 2x2 ("dcn", "ici") mesh the hierarchical f32
  exchange equals the flat one bit for bit and the int8 slow tier stays
  within its bound.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from horovod_tpu.ops import zero as jz
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import device as tdev
from horovod_tpu_torch.ops import zero as tz

ROOT = pathlib.Path(__file__).resolve().parents[1]

_RTOL, _ATOL = 1e-6, 1e-7
SHAPES = [(24, 16), (16,), (16, 40), (40,), (40, 9), (9,), (300,)]
TH = 2048            # bytes: several buckets over these leaves
STEPS = 5
N = 4


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("HVDT_ZERO", "HVDT_OVERLAP", "HVDT_TRANSPORT",
              "HVDT_FUSION_THRESHOLD", "HVDT_QUANT_BLOCK"):
        monkeypatch.delenv(k, raising=False)
    tz.reset()
    jz.reset()
    yield
    tz.reset()
    jz.reset()


# ---------------------------------------------------------------------------
# Stage resolution, errors, plan geometry (no process group)
# ---------------------------------------------------------------------------


def _err(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("raw", ["", "0", "off", "none", "false", "no",
                                 "grads", "states", "params", "STATES",
                                 " params ", "bogus"])
def test_stage_knob_matches_reference(raw, monkeypatch):
    monkeypatch.setenv("HVDT_ZERO", raw)
    tz.reset()
    jz.reset()
    if raw == "bogus":
        assert _err(tz.stage) == _err(jz.stage)
        assert _err(tz.validate_env) == _err(jz.validate_env)
        return
    assert tz.stage() == jz.stage()
    assert tz.enabled() == jz.enabled()
    assert (tz.get_zero() is None) == (jz.get_zero() is None)


@pytest.mark.parametrize("value", [None, True, "grads", "states", "params",
                                   "off", "", "nope"])
@pytest.mark.parametrize("env", ["", "params"])
def test_resolve_stage_matches_reference(value, env, monkeypatch):
    monkeypatch.setenv("HVDT_ZERO", env)
    if value == "nope":
        assert _err(lambda: tz.resolve_stage(value)) == _err(
            lambda: jz.resolve_stage(value))
        return
    assert tz.resolve_stage(value) == jz.resolve_stage(value)
    spec = tz.ZeroSpec("grads")
    assert tz.resolve_stage(spec) == "grads"


def test_spec_and_transform_errors_match_reference():
    assert _err(lambda: tz.ZeroSpec("off")) == _err(lambda: jz.ZeroSpec("off"))
    assert _err(lambda: tz.ZeroSpec("x")) == _err(lambda: jz.ZeroSpec("x"))
    for kw in (dict(stage="grads"), dict(stage="off")):
        assert _err(lambda: tz.zero_sgd(0.1, **kw)) == _err(
            lambda: jz.zero_sgd(0.1, **kw))
    tmsg = _err(lambda: tz.zero_transform({"kind": "lamb"}))
    jmsg = _err(lambda: jz.zero_transform({"kind": "lamb"}))
    assert tmsg.replace("torch.optim optimizer", "optax chain") == jmsg
    assert _err(lambda: tz.zero_sgd(lambda c: 0.1)) == _err(
        lambda: jz.zero_sgd(lambda c: 0.1)).replace(
        "(TraceState carries no step count)", "(its state carries no step "
        "count)")
    p = torch.zeros(3, requires_grad=True)
    msg = _err(lambda: tz.zero_from_optimizer(torch.optim.SGD([p], 0.1),
                                              stage="states"))
    assert "hvd.fused_adam(...) / hvd.fused_sgd(...)" in msg
    tx = tz.zero_adam(1e-3, weight_decay=0.1)
    st = tx.init([p])
    assert "requires params" in _err(lambda: tx.update([p], st))
    assert "param shard stacks" in _err(
        lambda: tz.zero_sgd(0.1, stage="params").update(
            [p], tz.ZeroSgdState(trace=())))
    with pytest.raises(ValueError, match="SUM/AVERAGE"):
        tz._ShardRoute(None, hvd.Max, 1.0, 1.0, None)


def test_exchange_fn_identity(monkeypatch):
    assert tz.exchange_fn() is tdev.fused_allreduce
    monkeypatch.setenv("HVDT_ZERO", "grads")
    assert tz.exchange_fn() is tz.rs_exchange
    monkeypatch.setenv("HVDT_ZERO", "off")
    assert tz.exchange_fn() is tdev.fused_allreduce


def _resnet26_leaves():
    from horovod_tpu_torch.models import ResNetConfig, resnet50_init

    model = resnet50_init(0, ResNetConfig(num_classes=10, depth=26,
                                          dtype=torch.float32),
                          device="meta")
    return list(model.parameters())


@pytest.mark.parametrize("threshold", [None, 1 << 20, 4 << 20, 100, 0])
@pytest.mark.parametrize("n", [1, 4, 8])
def test_plan_matches_reference_on_resnet26(threshold, n):
    leaves = _resnet26_leaves()
    jleaves = [np.zeros(tuple(p.shape), np.float32) for p in leaves]
    tp = tz._make_plan(leaves, threshold, n)
    jp = jz._make_plan(jleaves, threshold, n)
    assert tp.buckets == jp.buckets
    assert tp.sizes == jp.sizes and tp.shard_lens == jp.shard_lens
    assert [tdev._dtype_name(d) for d in tp.dtypes] == [
        np.dtype(d).name for d in jp.dtypes]
    assert tp.leaf_shapes == jp.leaf_shapes
    assert tp.padded_sizes == jp.padded_sizes
    assert tp.threshold_bytes == jp.threshold_bytes
    for k in (1, 2):
        assert tp.state_bytes_per_rank(k) == jp.state_bytes_per_rank(k)


def test_plan_mixed_dtypes_matches_reference():
    rng = np.random.default_rng(3)
    names = ["float32", "bfloat16", "float16"]
    import ml_dtypes

    npd = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
           "float16": np.float16}
    specs = [(tuple(int(d) for d in rng.integers(1, 50, rng.integers(1, 3))),
              names[rng.integers(3)]) for _ in range(25)]
    tleaves = [torch.empty(s, dtype=getattr(torch, d)) for s, d in specs]
    jleaves = [np.zeros(s, npd[d]) for s, d in specs]
    for n in (2, 3):
        tp, jp = tz._make_plan(tleaves, 600, n), jz._make_plan(jleaves, 600, n)
        assert (tp.buckets, tp.sizes, tp.shard_lens) == (
            jp.buckets, jp.sizes, jp.shard_lens)
        assert [tdev._dtype_name(d) for d in tp.dtypes] == [
            np.dtype(d).name for d in jp.dtypes]


# ---------------------------------------------------------------------------
# Checkpoint metadata and resharding on the same stacks
# ---------------------------------------------------------------------------


def _states(kind, seed=5, n=4):
    leaves = [torch.empty(s) for s in SHAPES]
    tx = (tz.zero_adam(1e-3, num_shards=n, threshold_bytes=TH)
          if kind == "adam" else
          tz.zero_sgd(0.1, momentum=0.9, num_shards=n, threshold_bytes=TH))
    jtx = (jz.zero_adam(1e-3, num_shards=n, threshold_bytes=TH)
           if kind == "adam" else
           jz.zero_sgd(0.1, momentum=0.9, num_shards=n, threshold_bytes=TH))
    plan = tx.plan_for(leaves)
    rng = np.random.default_rng(seed)
    bufs = {name: [rng.standard_normal((n, sl)).astype(np.float32)
                   for sl in plan.shard_lens]
            for name in (("mu", "nu") if kind == "adam" else ("trace",))}
    if kind == "adam":
        t = tz.ZeroAdamState(count=torch.tensor(7, dtype=torch.int32),
                             mu=tuple(map(torch.from_numpy, bufs["mu"])),
                             nu=tuple(map(torch.from_numpy, bufs["nu"])))
        j = jz.ZeroAdamState(count=jnp.asarray(7, jnp.int32),
                             mu=tuple(map(jnp.asarray, bufs["mu"])),
                             nu=tuple(map(jnp.asarray, bufs["nu"])))
    else:
        t = tz.ZeroSgdState(trace=tuple(map(torch.from_numpy,
                                            bufs["trace"])))
        j = jz.ZeroSgdState(trace=tuple(map(jnp.asarray, bufs["trace"])))
    jl = [np.zeros(s, np.float32) for s in SHAPES]
    return tx, jtx, leaves, jl, t, j


def _same_state(t, j):
    assert hasattr(t, "mu") == hasattr(j, "mu")
    if hasattr(t, "mu"):
        assert int(t.count) == int(j.count)
        pairs = list(zip(t.mu + t.nu, j.mu + j.nu))
    else:
        pairs = list(zip(t.trace, j.trace))
    for a, b in pairs:
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_metadata_and_reshard_match_reference(kind):
    tx, jtx, leaves, jl, t, j = _states(kind)
    meta = tz.state_metadata(tx, leaves)
    assert meta == jz.state_metadata(jtx, jl)
    for s in range(4):
        tr, jr = tz.extract_shard_rows(t, s), jz.extract_shard_rows(j, s)
        assert tr.keys() == jr.keys()
        for k in tr:
            np.testing.assert_array_equal(tr[k], np.asarray(jr[k]))
    rows = jz.extract_shard_rows(j, 1)
    _same_state(tz.implant_shard_rows(t, 3, rows),
                jz.implant_shard_rows(j, 3, rows))
    for new_n in (1, 2, 3, 8):
        ts, tm = tz.reshard_state(t, meta, new_n)
        js, jm = jz.reshard_state(j, meta, new_n)
        assert tm == jm
        _same_state(ts, js)
    tf, jf = tz.flatten_state_buffers(t, meta), jz.flatten_state_buffers(
        j, meta)
    assert tf.keys() == jf.keys()
    for k in tf:
        np.testing.assert_array_equal(tf[k], jf[k])
    _, tm2 = tz.reshard_state(t, meta, 2)
    _same_state(tz.rebucket_state(t, meta, tm2),
                jz.rebucket_state(j, meta, tm2))
    tc, tcm = tz.concat_states([t, t], [meta, meta])
    jc, jcm = jz.concat_states([j, j], [meta, meta])
    assert tcm == jcm
    _same_state(tc, jc)


def test_concat_errors_match_reference():
    tx, jtx, leaves, jl, t, j = _states("adam")
    _, _, _, _, ts, js = _states("sgd")
    meta = tz.state_metadata(tx, leaves)
    m2 = dict(meta, num_shards=2)
    for args_t, args_j in (
            (([], []), ([], [])),
            (([t, t], [meta, m2]), ([j, j], [meta, m2])),
            (([t, ts], [meta, meta]), ([j, js], [meta, meta]))):
        assert _err(lambda: tz.concat_states(*args_t)) == _err(
            lambda: jz.concat_states(*args_j))


# ---------------------------------------------------------------------------
# The 4-process world
# ---------------------------------------------------------------------------

_WORKER = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import device as dev
from horovod_tpu_torch.ops import zero as tz
from horovod_tpu_torch.ops import overlap as ov

data = np.load(sys.argv[1])
hvd.init(device="cpu")
r, n = hvd.rank(), hvd.size()
SHAPES = [tuple(s) for s in json.loads(sys.argv[3])]
TH, STEPS = int(data["th"]), int(data["steps"])
res = {}

def grads_of(step, rank):
    return [torch.from_numpy(data[f"g{step}.{rank}.{i}"].copy())
            for i in range(len(SHAPES))]

def params0():
    return [torch.from_numpy(data[f"p{i}"].copy()) for i in range(len(SHAPES))]

# 1. rs_exchange against fused_allreduce (exact inputs), the int8 wire.
g = grads_of(0, r)
ints = [torch.arange(7, dtype=torch.int32) * (r + 1)]
for tag, kw in (("avg", {}), ("sum", dict(op=hvd.Sum)),
                ("scaled", dict(prescale_factor=0.5, postscale_factor=2.0)),
                ("bf16", dict(wire_dtype=torch.bfloat16))):
    xs = g + (ints if tag in ("avg", "sum") else [])
    a = dev.fused_allreduce(xs, threshold_bytes=TH, **kw)
    b = tz.rs_exchange(xs, threshold_bytes=TH, **kw)
    for i, (x, y) in enumerate(zip(a, b)):
        res[f"ex.{tag}.fused.{i}"] = x.numpy()
        res[f"ex.{tag}.rs.{i}"] = y.numpy()
os.environ["HVDT_OVERLAP"] = "on"
ov.reset()
for i, y in enumerate(tz.rs_exchange(g, threshold_bytes=TH)):
    res[f"ex.ovl.{i}"] = y.numpy()
del os.environ["HVDT_OVERLAP"]
ov.reset()
for i, y in enumerate(tz.rs_exchange(g, threshold_bytes=TH,
                                     wire_dtype=hvd.Compression.int8.wire_dtype)):
    res[f"ex.int8.{i}"] = y.numpy()

# 2. The sharded update, by kind, stage and layout.
def make_tx(kind, stage, rs_wire=True):
    kw = dict(stage=stage, num_shards=n, threshold_bytes=TH, rs_wire=rs_wire)
    if kind == "sgd":
        return tz.zero_sgd(0.1, momentum=0.9, **kw)
    return tz.zero_adam(1e-2, weight_decay=0.05, **kw)

def run_tx(kind, stage, layout, rs_wire=True):
    tx = make_tx(kind, stage, rs_wire=rs_wire)
    ps = params0()
    st = tx.init(ps)
    pshards = tx.shard_params(ps) if stage == "params" else None
    if layout == "replicated":
        # Every rank's rows gathered: the whole [n, L] stacks.
        st = tx.gather_state(st)
        if pshards is not None:
            pshards = tuple(dev.allgather_flat_shards(s[0]).view(n, -1)
                            for s in pshards)
    for s in range(STEPS):
        gs = grads_of(s, r)
        if stage == "params":
            upd, st = tx.update(gs, st, pshards)
            pshards = tuple(a + b for a, b in zip(pshards, upd))
        else:
            upd, st = tx.update(gs, st, ps)
            ps = [a + b for a, b in zip(ps, upd)]
    if stage == "params":
        ps = tx.gather_params(pshards, ps)
    return tx, st, ps

def rows_of(tx, st, layout):
    out = {}
    for name in (("mu", "nu") if hasattr(st, "mu") else ("trace",)):
        for bi, stack in enumerate(getattr(st, name)):
            row = stack[0] if layout == "local" else stack[r]
            out[f"{name}{bi}"] = row.numpy()
    if hasattr(st, "mu"):
        out["count"] = np.array(int(st.count))
    return out

for kind in ("sgd", "adam"):
    for stage in ("states", "params"):
        for layout in ("local", "replicated"):
            tx, st, ps = run_tx(kind, stage, layout)
            tag = f"{kind}.{stage}.{layout}"
            for k, v in rows_of(tx, st, layout).items():
                res[f"z.{tag}.{k}"] = v
            for i, p in enumerate(ps):
                res[f"z.{tag}.p{i}"] = p.numpy()
            if layout == "local":
                res[f"z.{tag}.bytes"] = np.array(
                    tx.state_bytes_per_rank(ps))
        tx, st, ps = run_tx(kind, "states", "local", rs_wire=False)
        for k, v in rows_of(tx, st, "local").items():
            res[f"z.{kind}.arwire.{k}"] = v
        for i, p in enumerate(ps):
            res[f"z.{kind}.arwire.p{i}"] = p.numpy()
        res[f"z.{kind}.arwire.shape0"] = np.array(
            (st.mu if kind == "adam" else st.trace)[0].shape)

# 3. Through DistributedOptimizer, with and without overlap, and k = 2.
def opt_run(kind, stage, overlap=False, k=1):
    if overlap:
        os.environ["HVDT_OVERLAP"] = "on"
    ov.reset()
    ps = [p.requires_grad_() for p in params0()]
    inner = (hvd.fused_sgd(ps, 0.1, momentum=0.9) if kind == "sgd"
             else hvd.fused_adam(ps, 1e-2, weight_decay=0.05))
    opt = hvd.DistributedOptimizer(inner, threshold_bytes=TH, zero=stage,
                                   backward_passes_per_step=k)
    hooked = opt._hooked is not None
    for s in range(STEPS):
        for _ in range(k):
            opt.zero_grad()
            if stage == "params":
                opt.gather_params()
            w = [torch.from_numpy(v.copy()) for v in
                 (data[f"g{s}.{r}.{i}"] for i in range(len(SHAPES)))]
            # d(sum(p * w))/dp = w: the same exact gradients as above.
            sum((p * wi).sum() for p, wi in zip(ps, w)).backward()
            opt.step()
    if stage == "params":
        opt.gather_params()
    os.environ.pop("HVDT_OVERLAP", None)
    ov.reset()
    if opt._hooked is not None:
        opt._hooked.remove()
    return opt, ps, hooked

for kind in ("sgd", "adam"):
    for stage in ("states", "params"):
        for tag, kw in (("mono", {}), ("ovl", dict(overlap=True)),
                        ("k2", dict(k=2))):
            opt, ps, hooked = opt_run(kind, stage, **kw)
            t = f"o.{kind}.{stage}.{tag}"
            res[f"{t}.hooked"] = np.array(hooked)
            st = opt.zero_state
            for k_, v in rows_of(opt.transform, st, "local").items():
                res[f"{t}.{k_}"] = v
            for i, p in enumerate(ps):
                res[f"{t}.p{i}"] = p.detach().numpy()
            full = opt.gathered_zero_state()
            res[f"{t}.fullrow"] = (full.mu if kind == "adam"
                                   else full.trace)[0][r].numpy()

# grads stage, with and without overlap, against the replicated optimizer.
for tag, overlap in (("mono", False), ("ovl", True)):
    if overlap:
        os.environ["HVDT_OVERLAP"] = "on"
    ov.reset()
    outs = []
    for zero in (None, "grads"):
        ps = [p.requires_grad_() for p in params0()]
        opt = hvd.DistributedOptimizer(torch.optim.SGD(ps, lr=0.1),
                                       threshold_bytes=TH, zero=zero)
        for s in range(2):
            opt.zero_grad()
            w = [torch.from_numpy(data[f"g{s}.{r}.{i}"].copy())
                 for i in range(len(SHAPES))]
            sum((p * wi).sum() for p, wi in zip(ps, w)).backward()
            opt.step()
        outs.append(ps)
        res[f"gr.{tag}.{zero}.type"] = np.array(type(opt).__name__)
        if opt._hooked is not None:
            opt._hooked.remove()
    for i, (a, b) in enumerate(zip(*outs)):
        res[f"gr.{tag}.repl.{i}"] = a.detach().numpy()
        res[f"gr.{tag}.zero.{i}"] = b.detach().numpy()
    os.environ.pop("HVDT_OVERLAP", None)
    ov.reset()

# The segmented backward under HVDT_ZERO=grads against the monolithic one.
def seg_model():
    g = torch.Generator().manual_seed(7)
    return [torch.randint(-3, 4, s, generator=g).float().requires_grad_()
            for s in ((8, 16), (16,), (16, 4), (4,))]
xs = torch.from_numpy(data["g0.%d.0" % r][:4, :8].copy())
stages = [lambda p, x: x @ p[0] + p[1],
          lambda p, x: ((x @ p[0] + p[1]) * 0.25).sum()]
ps = seg_model()
want = dev.fused_allreduce(list(torch.autograd.grad(
    stages[1](ps[2:], stages[0](ps[:2], xs)), ps)), threshold_bytes=64)
os.environ["HVDT_ZERO"] = "grads"
tz.reset()
_, grads = ov.overlap_value_and_grad(stages, threshold_bytes=64)(
    [ps[:2], ps[2:]], xs)
del os.environ["HVDT_ZERO"]
tz.reset()
for i, (g_, w) in enumerate(zip(grads[0] + grads[1], want)):
    res[f"seg.got.{i}"] = g_.numpy()
    res[f"seg.want.{i}"] = w.numpy()

# 4. A shard-count mismatch raises.
tx = tz.zero_sgd(0.1, momentum=0.9, stage="states", num_shards=2,
                 threshold_bytes=TH)
st = tx.init(params0())
try:
    tx.update(grads_of(0, r), st, params0())
    res["mismatch"] = np.array("")
except ValueError as e:
    res["mismatch"] = np.array(str(e))

# 5. A 2x2 ("dcn", "ici") mesh: hierarchical f32 and the int8 slow tier.
from horovod_tpu_torch.parallel import make_mesh
from horovod_tpu_torch.transport import policy
mesh = make_mesh(dcn=2, ici=2)
res["mesh.owner"] = np.array(dev.shard_owner_index(("dcn", "ici")))
x6 = torch.from_numpy(data["g0.%d.6" % r].copy())
sh = dev.reduce_scatter_flat(x6, ("dcn", "ici"))
res["mesh.rsflat"] = sh.numpy()
res["mesh.agflat"] = dev.allgather_flat_shards(sh, ("dcn", "ici")).numpy()
flat = tz.rs_exchange(g, threshold_bytes=TH)
for name, spec in (("f32", "ici:ring:f32,dcn:tree:f32"),
                   ("int8", "ici:ring:f32,dcn:tree:int8")):
    os.environ["HVDT_TRANSPORT"] = spec
    policy.reset()
    for i, y in enumerate(tz.rs_exchange(g, threshold_bytes=TH)):
        res[f"mesh.{name}.{i}"] = y.numpy()
    tx = tz.zero_sgd(0.1, momentum=0.9, stage="states", threshold_bytes=TH)
    ps = params0()
    st = tx.init(ps)
    upd, st = tx.update(grads_of(0, r), st, ps)
    for i, u in enumerate(upd):
        res[f"mesh.{name}.upd{i}"] = u.numpy()
del os.environ["HVDT_TRANSPORT"]
policy.reset()
for i, y in enumerate(flat):
    res[f"mesh.flat.{i}"] = y.numpy()
np.savez(sys.argv[2], **res)
hvd.shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _quarters(rng, shape):
    return (rng.integers(-64, 64, shape) / 4.0).astype(np.float32)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero4")
    rng = np.random.default_rng(11)
    data = {"th": np.array(TH), "steps": np.array(STEPS)}
    for i, s in enumerate(SHAPES):
        data[f"p{i}"] = _quarters(rng, s)
    for st in range(STEPS):
        for q in range(N):
            for i, s in enumerate(SHAPES):
                data[f"g{st}.{q}.{i}"] = _quarters(rng, s)
    np.savez(tmp / "in.npz", **data)
    env = dict(os.environ, HVDT_SIZE=str(N),
               HVDT_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for k in ("HVDT_ZERO", "HVDT_OVERLAP", "HVDT_TRANSPORT",
              "HVDT_FUSION_THRESHOLD", "HVDT_COMPRESSION", "HVDT_QUANT",
              "HVDT_QUANT_BLOCK"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(tmp / "in.npz"),
         str(tmp / f"out{r}.npz"), json.dumps(SHAPES)],
        env=dict(env, HVDT_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(N)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out.decode()[-3000:]
    return data, [dict(np.load(tmp / f"out{r}.npz"))
                  for r in range(N)]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8))


@pytest.mark.parametrize("tag", ["avg", "sum", "scaled", "bf16"])
def test_rs_exchange_equals_fused_allreduce(world4, tag):
    data, res = world4
    for r in range(N):
        for i in range(len(SHAPES) + (1 if tag in ("avg", "sum") else 0)):
            _same(res[r][f"ex.{tag}.rs.{i}"], res[r][f"ex.{tag}.fused.{i}"])
            if tag == "avg":
                _same(res[r][f"ex.ovl.{i}"] if i < len(SHAPES)
                      else res[r][f"ex.avg.rs.{i}"],
                      res[r][f"ex.avg.fused.{i}"])
    if tag == "avg":
        for i in range(len(SHAPES)):
            np.testing.assert_array_equal(
                res[0][f"ex.avg.rs.{i}"],
                sum(data[f"g0.{q}.{i}"] for q in range(N)) / N)


def test_rs_exchange_int8_within_block_bound(world4):
    """Stage 1 quantizes each rank's bucket (half a step of 1/127 of a
    block's absmax), stage 2 the reduced shard: the error of the mean is
    at most (sum of the ranks' half steps + half a step of the sum) / n,
    bounded here by the largest magnitudes."""
    data, res = world4
    gmax = max(np.abs(data[f"g0.{q}.{i}"]).max() for q in range(N)
               for i in range(len(SHAPES)))
    bound = (N * gmax / 127 / 2 + N * gmax / 127 / 2) / N
    for r in range(N):
        for i in range(len(SHAPES)):
            want = sum(data[f"g0.{q}.{i}"] for q in range(N)) / N
            err = np.abs(res[r][f"ex.int8.{i}"] - want).max()
            assert err <= bound, (i, err, bound)
            _same(res[r][f"ex.int8.{i}"], res[0][f"ex.int8.{i}"])


def _unbound_run(z, arr, kind, stage, data, **extra):
    """Package ``z``'s unbound zero_transform (no process group) fed the
    global mean gradient: its stacks and parameters after STEPS steps."""
    kw = dict(stage=stage, num_shards=N, threshold_bytes=TH, **extra)
    tx = (z.zero_sgd(0.1, momentum=0.9, **kw) if kind == "sgd"
          else z.zero_adam(1e-2, weight_decay=0.05, **kw))
    ps = [arr(data[f"p{i}"]) for i in range(len(SHAPES))]
    st = tx.init(ps)
    pshards = tx.shard_params(ps) if stage == "params" else None
    for s in range(STEPS):
        gs = [arr(sum(data[f"g{s}.{q}.{i}"] for q in range(N)) / N)
              for i in range(len(SHAPES))]
        if stage == "params":
            upd, st = tx.update(gs, st, pshards)
            pshards = tuple(a + b for a, b in zip(pshards, upd))
        else:
            upd, st = tx.update(gs, st, ps)
            ps = [a + b for a, b in zip(ps, upd)]
    if stage == "params":
        ps = tx.gather_params(pshards, ps)
    return st, ps


def _ref_run(kind, stage, data):
    """The reference's unbound run (use_kernels=False)."""
    return _unbound_run(jz, jnp.asarray, kind, stage, data,
                        use_kernels=False)


def _port_unbound_run(kind, stage, data):
    """The port's unbound run, in this process (no process group)."""
    return _unbound_run(tz, lambda a: torch.from_numpy(a.copy()), kind,
                        stage, data)


def _names(kind):
    return ("mu", "nu") if kind == "adam" else ("trace",)


@pytest.mark.parametrize("kind", ["sgd", "adam"])
@pytest.mark.parametrize("stage", ["states", "params"])
def test_sharded_rows_match_unbound_and_reference(world4, kind, stage):
    data, res = world4
    st, ps = _ref_run(kind, stage, data)
    ust, ups = _port_unbound_run(kind, stage, data)
    n_buckets = len(st.mu if kind == "adam" else st.trace)
    for r in range(N):
        got = res[r]
        for layout in ("local", "replicated"):
            tag = f"z.{kind}.{stage}.{layout}"
            for name in _names(kind):
                for bi in range(n_buckets):
                    # Every layout gives the unbound transform's row, bit
                    # for bit (exact sums).
                    _same(got[f"{tag}.{name}{bi}"],
                          getattr(ust, name)[bi][r].numpy())
            for i in range(len(SHAPES)):
                _same(got[f"{tag}.p{i}"], ups[i].numpy())
    for name in _names(kind):
        for bi in range(n_buckets):
            np.testing.assert_allclose(
                getattr(ust, name)[bi].numpy(),
                np.asarray(getattr(st, name)[bi]), rtol=_RTOL, atol=_ATOL,
                err_msg=f"{name}{bi}")
    for i in range(len(SHAPES)):
        np.testing.assert_allclose(ups[i].numpy(), np.asarray(ps[i]),
                                   rtol=_RTOL, atol=_ATOL)
    if kind == "adam":
        assert int(ust.count) == int(st.count) == STEPS
        for r in range(N):
            assert int(res[r][f"z.{kind}.{stage}.local.count"]) == STEPS


@pytest.mark.parametrize("kind", ["sgd", "adam"])
@pytest.mark.parametrize("stage", ["states", "params"])
@pytest.mark.parametrize("tag", ["mono", "ovl", "k2"])
def test_distributed_optimizer_zero_rows(world4, kind, stage, tag):
    """DistributedOptimizer(zero=stage) gives the transform's rows and
    parameters, bit for bit; under HVDT_OVERLAP=on the hooks issue the
    reduce-scatters (same bytes); with k = 2 (each pass the same
    gradients) the mean is the same."""
    _, res = world4
    n_buckets = len([k for k in res[0] if k.startswith(
        f"z.{kind}.{stage}.local.{_names(kind)[0]}")])
    for r in range(N):
        got = res[r]
        t = f"o.{kind}.{stage}.{tag}"
        assert bool(got[f"{t}.hooked"]) == (tag == "ovl")
        for name in _names(kind):
            for bi in range(n_buckets):
                _same(got[f"{t}.{name}{bi}"],
                      got[f"z.{kind}.{stage}.local.{name}{bi}"])
        for i in range(len(SHAPES)):
            _same(got[f"{t}.p{i}"], got[f"z.{kind}.{stage}.local.p{i}"])
        _same(got[f"{t}.fullrow"], got[f"{t}.{_names(kind)[0]}0"])


@pytest.mark.parametrize("tag", ["mono", "ovl"])
def test_grads_stage_equals_replicated(world4, tag):
    _, res = world4
    for r in range(N):
        assert str(res[r][f"gr.{tag}.None.type"]) == "_DistributedOptimizer"
        assert str(res[r][f"gr.{tag}.grads.type"]) == "_ZeroGradsOptimizer"
        for i in range(len(SHAPES)):
            _same(res[r][f"gr.{tag}.zero.{i}"], res[r][f"gr.{tag}.repl.{i}"])


@pytest.mark.parametrize("kind", ["sgd", "adam"])
def test_rs_wire_false_same_values_and_layout(world4, kind):
    _, res = world4
    for r in range(N):
        got = res[r]
        assert tuple(got[f"z.{kind}.arwire.shape0"])[0] == 1
        for k in got:
            if k.startswith(f"z.{kind}.arwire.") and not k.endswith("shape0"):
                _same(got[k], got[k.replace("arwire", "states.local")])


def test_state_bytes_are_a_quarter(world4):
    _, res = world4
    leaves = [torch.empty(s) for s in SHAPES]
    plan = tz._make_plan(leaves, TH, N)
    total = sum(plan.padded_sizes) * 4
    assert int(res[0]["z.adam.states.local.bytes"]) == 2 * total // N
    assert int(res[0]["z.sgd.states.local.bytes"]) == total // N


def test_segmented_backward_under_zero_grads(world4):
    _, res = world4
    for r in range(N):
        for i in range(4):
            _same(res[r][f"seg.got.{i}"], res[r][f"seg.want.{i}"])


def test_shard_count_mismatch_raises(world4):
    _, res = world4
    msg = str(res[0]["mismatch"])
    assert msg.startswith("ZeRO state was built for 2 shards but the bound "
                          "reduce group ('dp',) has size 4")


def test_hierarchical_and_int8_slow_tier(world4):
    """On the 2x2 mesh (dcn outer, ici inner; ici hops first, so rank
    (dcn=a, ici=b) owns chunk 2b + a, as ``reduce_scatter_flat`` and
    ``allgather_flat_shards`` place it) the hierarchical f32 exchange is
    the flat one bit for bit; the int8 slow tier quantizes each dcn
    member's ici sum, then the dcn sum: within half a step of 1/127 of
    each stage's absmax, over n."""
    data, res = world4
    assert [int(res[r]["mesh.owner"]) for r in range(N)] == [0, 2, 1, 3]
    total = sum(data[f"g0.{q}.6"] for q in range(N))
    for r in range(N):
        own = int(res[r]["mesh.owner"])
        np.testing.assert_array_equal(res[r]["mesh.rsflat"],
                                      total[own * 75:(own + 1) * 75])
        np.testing.assert_array_equal(res[r]["mesh.agflat"], total)
    gmax = max(np.abs(data[f"g0.{q}.{i}"]).max() for q in range(N)
               for i in range(len(SHAPES)))
    bound = (2 * (2 * gmax) / 127 / 2 + N * gmax / 127 / 2) / N
    for r in range(N):
        for i in range(len(SHAPES)):
            _same(res[r][f"mesh.f32.{i}"], res[r][f"mesh.flat.{i}"])
            err = np.abs(res[r][f"mesh.int8.{i}"]
                         - res[r][f"mesh.flat.{i}"]).max()
            assert err <= bound, (i, err, bound)
            _same(res[r][f"mesh.f32.upd{i}"], res[0][f"mesh.f32.upd{i}"])
            # SGD's first step: delta = -lr * mean gradient.
            np.testing.assert_allclose(res[r][f"mesh.f32.upd{i}"],
                                       -0.1 * res[r][f"mesh.flat.{i}"],
                                       rtol=1e-6)


def test_knob_unset_builds_the_replicated_optimizer(monkeypatch):
    hvd.init(device="cpu")
    try:
        p = torch.zeros(3, requires_grad=True)
        opt = hvd.DistributedOptimizer(hvd.fused_adam([p], 1e-3))
        assert type(opt).__name__ == "_DistributedOptimizer"
        assert opt._hooked is None and not hasattr(opt, "transform")
        assert "mu" in opt.optimizer.state[p]
        monkeypatch.setenv("HVDT_ZERO", "states")
        z = hvd.DistributedOptimizer(hvd.fused_adam([p], 1e-3))
        assert type(z).__name__ == "_ZeroStatesOptimizer"
        assert z.optimizer.state.get(p) is None
        for call in (z.state_dict, lambda: z.load_state_dict({}),
                     z.synchronize):
            with pytest.raises(RuntimeError):
                call()
        with pytest.raises(ValueError, match="SUM/AVERAGE"):
            hvd.DistributedOptimizer(hvd.fused_adam([p], 1e-3),
                                     op=hvd.Adasum)
        with pytest.raises(ValueError, match="fused_adam"):
            hvd.DistributedOptimizer(torch.optim.SGD([p], lr=0.1))
        monkeypatch.setenv("HVDT_ZERO", "grads")
        g = hvd.DistributedOptimizer(torch.optim.SGD([p], lr=0.1))
        assert type(g).__name__ == "_ZeroGradsOptimizer"
        monkeypatch.setenv("HVDT_ZERO", "bogus")
        tz.reset()
        with pytest.raises(ValueError, match="unknown HVDT_ZERO stage"):
            hvd.DistributedOptimizer(torch.optim.SGD([p], lr=0.1))
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("stage", ["states", "params"])
def test_missing_gradient_zero_filled(stage):
    """A sharded step updates every row: a parameter with no gradient is
    given a zero one (every rank sends the same buckets, as the
    reference's interop optimizer does), so the step equals FusedAdam
    stepping the same parameter on an explicit zero gradient, bit for
    bit."""
    hvd.init(device="cpu")
    try:
        def pair():
            g = torch.Generator().manual_seed(4)
            return [torch.randn(s, generator=g).requires_grad_()
                    for s in ((4, 3), (5,))]

        ps, ref = pair(), pair()
        opt = hvd.DistributedOptimizer(
            hvd.fused_adam(ps, 1e-2, weight_decay=0.1), zero=stage)
        plain = hvd.fused_adam(ref, 1e-2, weight_decay=0.1)
        for _ in range(2):
            opt.zero_grad()
            plain.zero_grad()
            (ps[0] * 2).sum().backward()
            assert ps[1].grad is None
            ref[0].grad = torch.full_like(ref[0], 2.0)
            ref[1].grad = torch.zeros_like(ref[1])
            opt.step()
            opt.gather_params()
            plain.step()
            for a, b in zip(ps, ref):
                assert torch.equal(a, b)
        assert not torch.equal(ps[1], pair()[1])   # weight decay moved it
    finally:
        hvd.shutdown()


def test_init_rejects_unknown_stage(monkeypatch):
    monkeypatch.setenv("HVDT_ZERO", "bogus")
    tz.reset()
    with pytest.raises(ValueError, match="valid: off, grads, states, params"):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()
