"""PyTorch port, ZeRO beside a model axis and the ZeRO exchange's
records (horovod_tpu_torch/ops/zero.py, optimizer.py) in a 4-process
gloo world.

* The records: under ``HVDT_TELEMETRY`` / ``HVDT_FLIGHT_RECORDER`` each
  ZeRO bucket's reduce-scatter and each all-gather (the ``grads``
  stage's gather, ``states``' delta gather, ``params``' gather before
  the forward) books one ``path="jit"`` record with the reference's op
  names (``reduce_scatter``, ``allgather``), axis, dtype and wire.  After
  3 eager steps the counters and bytes are 3 x one step's, the flight
  recorder holds 3 x its events; inside a (simulated) ``donated_step``
  capture nothing is booked, and each run of the collected replay hooks
  books one step's records.  The reference's ``_record_bucket`` labels
  are held on ``rs_exchange`` over the same leaves (its trace against
  one eager call).
* ZeRO ``states`` / ``params`` under ``HVDT_OVERLAP=on`` with a
  model-axis fold, pp 2 x dp 2 (``pipeline="pp"``: stage leaves sharded
  over ``pp``) and ep 2 x dp 2 (``expert="ep"``: the fold averages the
  replicated leaves over ``ep`` and divides the expert leaves by its
  size): the hooks reduce-scatter within the ``dp`` group and the fold
  runs on each reduced shard.  On exactly representable gradients
  (multiples of 1/4, so no sum rounds in any order) 3 fused-Adam steps
  equal the same steps without overlap in every byte, and the
  parameters equal the reference's unbound ``zero_transform``
  (use_kernels=False) fed each fiber's folded mean gradient within the
  replicated optimizer's port tolerance (rtol 1e-6, atol 1e-7).
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.ops import zero as jz
from horovod_tpu.telemetry import flight_recorder as jfr
from horovod_tpu.telemetry import instrument as jinst
from horovod_tpu.telemetry import metrics as jmet

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 4
SHAPES = [(24, 16), (16,), (16, 40), (300,)]
SHARDED = 2            # the leaf sharded over pp / ep
TH = 2048
STEPS = 3
_RTOL, _ATOL = 1e-6, 1e-7
_MESHES = {"pp2_dp2": ("pp", "pipeline"), "ep2_dp2": ("ep", "expert")}

_WORKER = r"""
import json, os, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import graphs
from horovod_tpu_torch.ops import overlap as ov
from horovod_tpu_torch.ops import zero as tz
from horovod_tpu_torch.parallel import make_mesh, mark_sharded
from horovod_tpu_torch.telemetry import flight_recorder as tfr
from horovod_tpu_torch.telemetry import instrument as tinst
from horovod_tpu_torch.telemetry import metrics as tmet

data = np.load(sys.argv[1])
hvd.init(device="cpu")
r = hvd.rank()
SHAPES = [tuple(s) for s in json.loads(sys.argv[3])]
TH, STEPS, SHARDED = int(data["th"]), int(data["steps"]), int(data["sharded"])
res = {}


def grads_of(step, rank):
    return [torch.from_numpy(data[f"g{step}.{rank}.{i}"].copy())
            for i in range(len(SHAPES))]


def params0(coord=0):
    return [torch.from_numpy(data[f"p{i}.{coord if i == SHARDED else 0}"]
                             .copy()).requires_grad_()
            for i in range(len(SHAPES))]


def step(opt, ps, w, stage):
    opt.zero_grad()
    if stage == "params":
        opt.gather_params()
    sum((p * wi).sum() for p, wi in zip(ps, w)).backward()
    opt.step()


# 1. The records, over the world (no mesh): one step, three steps, and a
#    simulated capture whose replay hooks run three times.
os.environ["HVDT_TELEMETRY"] = "1"
os.environ["HVDT_FLIGHT_RECORDER"] = "1"


def reset_recorders():
    tmet.reset_default_registry()
    tinst.reset()
    tfr.reset()


def series():
    reg = tmet.default_registry()
    out = {}
    for name in ("hvdt_collective_bytes_total", "hvdt_collectives_total"):
        m = reg.get(name)
        out[name] = sorted([sorted(lb.items()), v] for lb, v in m.items()) \
            if m else []
    fr = tfr.get_flight_recorder()
    out["events"] = [[e["op"], e["name"], e["dtype"], e["nbytes"],
                      e["wire"], e["count"], e["axis"]] for e in fr.events()]
    return out


def recorders_capturing():
    # The sharded update refuses a capture without the CUDA kernels, so
    # the capture is simulated for the recorders only.
    caller = sys._getframe(1).f_globals.get("__name__", "")
    return caller.endswith("telemetry.instrument")


for stage in ("grads", "states", "params"):
    ps = params0()
    inner = (torch.optim.SGD(ps, lr=0.1) if stage == "grads"
             else hvd.fused_adam(ps, 1e-2, weight_decay=0.05))
    opt = hvd.DistributedOptimizer(inner, threshold_bytes=TH, zero=stage)
    w = grads_of(0, r)
    step(opt, ps, w, stage)                 # warm: plans, state
    out = {}
    for tag, calls in (("one", 1), ("three", 3)):
        reset_recorders()
        for _ in range(calls):
            step(opt, ps, w, stage)
        out[tag] = series()
    reset_recorders()
    real = graphs.capturing
    graphs.capturing = recorders_capturing
    try:
        with graphs.collect_replay_hooks() as hooks:
            step(opt, ps, w, stage)
    finally:
        graphs.capturing = real
    out["captured"] = series()
    out["hooks"] = len(hooks)
    for _ in range(3):
        for h in hooks:
            h()
    out["replayed"] = series()
    res[f"rec.{stage}"] = np.array(json.dumps(out))
for k in ("HVDT_TELEMETRY", "HVDT_FLIGHT_RECORDER"):
    del os.environ[k]
reset_recorders()

# 2. ZeRO states / params with a model-axis fold, with and without the
#    hooked exchange.
for name, (axis, kw) in json.loads(sys.argv[4]).items():
    mesh = make_mesh(**{"dp": 2, axis: 2})
    coord = mesh.get_local_rank(axis)
    res[f"{name}.coord"] = np.array([mesh.get_local_rank("dp"), coord])
    for stage in ("states", "params"):
        for overlap in (False, True):
            if overlap:
                os.environ["HVDT_OVERLAP"] = "on"
            ov.reset()
            ps = params0(coord)
            mark_sharded(ps[SHARDED], axis)
            opt = hvd.DistributedOptimizer(
                hvd.fused_adam(ps, 1e-2, weight_decay=0.05),
                threshold_bytes=TH, zero=stage, axis="dp", **{kw: axis})
            tag = f"{name}.{stage}.{'ovl' if overlap else 'mono'}"
            res[tag + ".hooked"] = np.array(opt._hooked is not None)
            res[tag + ".fold"] = np.array(len(opt._axis_plan.plan))
            for s in range(STEPS):
                step(opt, ps, grads_of(s, r), stage)
            if stage == "params":
                opt.gather_params()
            for i, p in enumerate(ps):
                res[f"{tag}.p{i}"] = p.detach().numpy().copy()
            if opt._hooked is not None:
                opt._hooked.remove()
            os.environ.pop("HVDT_OVERLAP", None)
            ov.reset()
np.savez(sys.argv[2], **res)
hvd.shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero_fold")
    rng = np.random.default_rng(7)
    data = {"th": np.array(TH), "steps": np.array(STEPS),
            "sharded": np.array(SHARDED)}
    for i, s in enumerate(SHAPES):
        for c in range(2):
            data[f"p{i}.{c}"] = rng.integers(-8, 8, s).astype(
                np.float32) / 4
        for step in range(STEPS):
            for r in range(N):
                data[f"g{step}.{r}.{i}"] = rng.integers(-8, 8, s).astype(
                    np.float32) / 4
    np.savez(tmp / "in.npz", **data)
    cases = {name: (axis, kw) for name, (axis, kw) in _MESHES.items()}
    env = dict(os.environ, HVDT_SIZE=str(N),
               HVDT_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for k in ("HVDT_ZERO", "HVDT_OVERLAP", "HVDT_TRANSPORT",
              "HVDT_FUSION_THRESHOLD", "HVDT_TELEMETRY",
              "HVDT_FLIGHT_RECORDER", "HVDT_COMPRESSION", "HVDT_QUANT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(tmp / "in.npz"),
         str(tmp / f"out{r}.npz"), json.dumps(SHAPES), json.dumps(cases)],
        env=dict(env, HVDT_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(N)]
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out.decode()[-3000:]
    return data, [dict(np.load(tmp / f"out{r}.npz")) for r in range(N)]


def _times(series, k):
    return [[lb, k * v] for lb, v in series]


@pytest.mark.parametrize("stage", ["grads", "states", "params"])
def test_records_scale_with_calls_and_replays(world, stage):
    _, res = world
    for r in range(N):
        rec = json.loads(str(res[r][f"rec.{stage}"]))
        one, three = rec["one"], rec["three"]
        for name in ("hvdt_collective_bytes_total", "hvdt_collectives_total"):
            assert one[name], (stage, name)
            assert three[name] == _times(one[name], 3), (stage, name)
            assert rec["captured"][name] == [], (stage, name)
            assert rec["replayed"][name] == _times(one[name], 3)
        assert three["events"] == one["events"] * 3
        assert rec["captured"]["events"] == []
        assert rec["replayed"]["events"] == one["events"] * 3
        # Each bucket's reduce-scatter books one hook, and so does each
        # all-gather.
        assert rec["hooks"] == len(one["events"]) * 2
        ops = {e[0] for e in one["events"]}
        assert ops == {"reduce_scatter", "allgather"}, ops
        for e in one["events"]:
            assert e[6] == "dp" and e[4] == e[2] == "float32", e
        names = [e[1] for e in one["events"] if e[0] == "allgather"]
        want = ".params" if stage == "params" else ".ag"
        assert names and all(n.endswith(want) for n in names), names


def test_record_labels_match_reference(world):
    """The grads stage's records against the reference's ``rs_exchange``
    traced once over the same leaves (4 CPU devices): op, name, dtype,
    wire, bytes, count and axis of every event, in order."""
    _, res = world
    got = json.loads(str(res[0]["rec.grads"]))["one"]["events"]
    os.environ["HVDT_FLIGHT_RECORDER"] = "1"
    try:
        jmet.reset_default_registry()
        jinst.reset()
        jfr.reset()
        leaves = [jnp.zeros(s, jnp.float32) for s in SHAPES]
        mesh = Mesh(np.asarray(jax.devices()[:N]), ("dp",))

        def body(*xs):
            return jz.rs_exchange(list(xs), "dp", threshold_bytes=TH)

        jax.jit(jax.shard_map(body, mesh=mesh,
                              in_specs=tuple(P() for _ in leaves),
                              out_specs=[P() for _ in leaves],
                              check_vma=False))(*leaves)
        want = [[e["op"], e["name"], e["dtype"], e["nbytes"], e["wire"],
                 e["count"], e["axis"]]
                for e in jfr.get_flight_recorder().events()]
    finally:
        del os.environ["HVDT_FLIGHT_RECORDER"]
        jfr.reset()
        jinst.reset()
    assert got == want


def _folded(data, name, step, r, i, coords):
    """The fiber's folded mean gradient of leaf ``i`` for rank ``r``:
    the mean over ``dp``; under ep 2 x dp 2 the replicated leaves are
    also averaged over ``ep`` and the expert leaf divided by 2."""
    axis_coord = coords[r][1]
    fiber = [q for q in range(N) if coords[q][1] == axis_coord]
    g = sum(data[f"g{step}.{q}.{i}"] for q in fiber) / 2
    if name == "ep2_dp2":
        if i == SHARDED:
            g = g * 0.5
        else:
            g = sum(data[f"g{step}.{q}.{i}"] for q in range(N)) / N
    return g


def _reference(data, name, stage, r, coords):
    tx = jz.zero_adam(1e-2, weight_decay=0.05, stage=stage, num_shards=2,
                      threshold_bytes=TH, use_kernels=False)
    c = coords[r][1]
    ps = [jnp.asarray(data[f"p{i}.{c if i == SHARDED else 0}"])
          for i in range(len(SHAPES))]
    st = tx.init(ps)
    pshards = tx.shard_params(ps) if stage == "params" else None
    for s in range(STEPS):
        gs = [jnp.asarray(_folded(data, name, s, r, i, coords))
              for i in range(len(SHAPES))]
        if stage == "params":
            upd, st = tx.update(gs, st, pshards)
            pshards = tuple(a + b for a, b in zip(pshards, upd))
        else:
            upd, st = tx.update(gs, st, ps)
            ps = [a + b for a, b in zip(ps, upd)]
    if stage == "params":
        ps = tx.gather_params(pshards, ps)
    return [np.asarray(p) for p in ps]


@pytest.mark.parametrize("stage", ["states", "params"])
@pytest.mark.parametrize("name", list(_MESHES))
def test_overlap_with_fold_equals_unhooked_and_reference(world, name,
                                                          stage):
    data, res = world
    coords = [tuple(int(x) for x in res[r][f"{name}.coord"])
              for r in range(N)]
    for r in range(N):
        mono, ovl = f"{name}.{stage}.mono", f"{name}.{stage}.ovl"
        assert not bool(res[r][mono + ".hooked"])
        assert bool(res[r][ovl + ".hooked"])
        assert int(res[r][ovl + ".fold"]) == (2 if name == "ep2_dp2"
                                              else 0)
        want = _reference(data, name, stage, r, coords)
        for i in range(len(SHAPES)):
            a, b = res[r][f"{mono}.p{i}"], res[r][f"{ovl}.p{i}"]
            assert a.tobytes() == b.tobytes(), (name, stage, r, i)
            np.testing.assert_allclose(b, want[i], rtol=_RTOL, atol=_ATOL,
                                       err_msg=f"{name} {stage} {r} {i}")
