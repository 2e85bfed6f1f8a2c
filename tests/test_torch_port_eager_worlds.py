"""PyTorch port, the eager core in multi-process gloo worlds of 2 and 3.

Each world is started once per module (``HVDT_SIZE/RANK/
COORDINATOR_ADDR``, as test_torch_port_collectives.py starts its
worlds); every rank saves its seeded inputs and its outputs, and the
tests hold them against numpy's answer with the JAX package's semantics:
- named ops issued in a different order on every rank; results exact
  for integers, MIN/MAX, broadcast, allgather and alltoall (including
  int64 beyond 2^31, which the JAX package's default data plane cannot
  carry), rtol 1e-6 for f32 sums and averages;
- ragged allgather, broadcast from a set-relative root (0-d included),
  uneven alltoall with its receive splits, reducescatter's remainder
  rows;
- join with uneven step counts (a joined rank contributes the
  reduction's identity; join returns the last rank to join);
- process sets, including ``remove_process_set``;
- a mismatched shape failing on every rank with the reference's message;
- eager ops in flight while ``DistributedOptimizer`` steps run on the
  same ranks (the eager plane has its own group), with no hang;
- a second negotiation served from the response cache (cache bits on
  the wire), and one named alltoall called three times with send splits
  that differ from rank to rank (alltoall always negotiates in full);
- ``device.allgather_ragged`` / ``alltoall_uneven`` and
  ``sparse_allreduce_jit`` against the JAX functions under ``shard_map``
  on as many CPU devices.
A third, 2-process world runs a stall: the ``HVDT_STALL_CHECK_TIME_
SECONDS`` warning, then the ``HVDT_STALL_ABORT_TIME_SECONDS`` abort
raising ``HorovodInternalError`` on the ranks that submitted.
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

from horovod_tpu.ops import device as jdev
from horovod_tpu.ops import sparse as jsparse

ROOT = pathlib.Path(__file__).resolve().parents[1]

_WORKER = r"""
import json, sys, time
import numpy as np
import torch
import torch.distributed as dist
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import eager

out = sys.argv[1]
hvd.init(device="cpu")
r, n = hvd.rank(), hvd.size()
rng = np.random.default_rng(100 + r)
res, info = {}, {}
big = np.int64(2**40)

def f32(*s): return rng.standard_normal(s).astype(np.float32)
def i32(*s): return rng.integers(-100, 100, s).astype(np.int32)
def i64big(*s): return (rng.integers(-100, 100, s) * big
                        + rng.integers(-2**31, 2**31, s)).astype(np.int64)

splits = [(r + j) % 3 for j in range(n)]
ops = [
    ("allreduce", "o.sum", f32(5, 3), {"op": hvd.Sum}),
    ("allreduce", "o.avg", f32(4), {}),
    ("allreduce", "o.min_i32", i32(6), {"op": hvd.Min}),
    ("allreduce", "o.max_i64", i64big(4), {"op": hvd.Max}),
    ("allreduce", "o.min_i64", i64big(4), {"op": hvd.Min}),
    ("allreduce", "o.prod_i32", rng.integers(-3, 4, 5).astype(np.int32),
     {"op": hvd.Product}),
    ("allreduce", "o.sum_f64", rng.standard_normal((3, 2)), {"op": hvd.Sum}),
    ("allreduce", "o.scaled", f32(4), {"op": hvd.Sum, "prescale_factor": 0.5,
                                       "postscale_factor": 3.0}),
    ("allreduce", "o.avg_i32", i32(5), {"op": hvd.Average}),
    ("allreduce", "o.max_bf16", f32(6), {"op": hvd.Max}),
    ("allgather", "o.ag", f32(r + 1, 2), {}),
    ("allgather", "o.ag_i64", i64big(2 * r, 3), {}),
    ("broadcast", "o.bc", f32(3), {"root_rank": 1}),
    ("broadcast", "o.bc0d", np.array(big * (r + 1)), {"root_rank": n - 1}),
    ("alltoall", "o.a2a", f32(sum(splits), 2), {"splits": splits}),
    ("reducescatter", "o.rs", f32(7, 2), {}),
    ("reducescatter", "o.rs_avg", f32(5), {"op": hvd.Average}),
    ("reducescatter", "o.rs_max", i64big(n + 1, 2), {"op": hvd.Max}),
]
dist.barrier()
handles = {}
for k in rng.permutation(len(ops)):          # a different order on each rank
    fn, name, x, kw = ops[k]
    res[f"in.{name}"] = x
    if name == "o.max_bf16":
        x = torch.from_numpy(x).to(torch.bfloat16)
    elif k % 2:
        x = torch.from_numpy(x)
    handles[name] = (getattr(eager, fn + "_async")(x, name=name, **kw), x)
for name, (h, x) in handles.items():
    y = eager.synchronize(h)
    if isinstance(y, tuple):
        y, info[f"recv.{name}"] = y
    assert type(y) is type(x), (name, type(y), type(x))
    if isinstance(y, torch.Tensor):
        assert y.dtype == x.dtype and y.device == x.device, name
        y = (y.float() if y.dtype == torch.bfloat16 else y).numpy()
    res[f"out.{name}"] = y

grp = [f32(3), f32(2, 2), f32(1)]
res.update({f"in.grp{i}": g for i, g in enumerate(grp)})
for i, y in enumerate(hvd.grouped_allreduce(grp, name="grp", op=hvd.Sum)):
    res[f"out.grp{i}"] = y

for i in range(r + 1):                        # uneven step counts, then join
    res[f"out.js{i}"] = hvd.allreduce(np.full(3, r + 1 + i, np.float32),
                                      name=f"js{i}", op=hvd.Sum)
    res[f"out.jm{i}"] = hvd.allreduce(np.full(2, r + 10 * i, np.int32),
                                      name=f"jm{i}", op=hvd.Min)
info["join"] = hvd.join()

members = [0, n - 1] if n > 2 else [1]      # not the whole world
ps = hvd.add_process_set(members)
if r in members:
    res["out.ps"] = hvd.allreduce(np.full(2, r + 1.0, np.float32), name="ps",
                                  op=hvd.Sum, process_set=ps)
info["ps_id"] = ps.id
hvd.barrier()          # every rank is done with the set before removing it
hvd.remove_process_set(ps.id)
try:
    hvd.process_set_by_id(ps.id)
except Exception as e:
    info["removed"] = str(e)
ps2 = hvd.add_process_set(members)
info["ps2_id"] = ps2.id
if r in members:
    res["out.ps2"] = hvd.allreduce(torch.full((2,), r + 1.0), name="ps",
                                   op=hvd.Max, process_set=ps2).numpy()

try:
    hvd.allreduce(np.ones(2 + r, np.float32), name="mm")
except hvd.HorovodInternalError as e:
    info["mismatch"] = str(e)

ctl = eager._controller()
sent, orig = [], ctl.cp.gather
ctl.cp.gather = lambda p, c: (sent.append(p), orig(p, c))[1]
for step in range(3):
    res[f"out.cached{step}"] = hvd.allreduce(
        np.full(4, r + step, np.float32), name="cached", op=hvd.Sum)
ctl.cp.gather = orig
info["bits"] = [p.split("|")[0] for p in sent if p.split("|")[0]]

base = [j + 1 for j in range(n)]
a2a_splits = base[r:] + base[:r]      # they differ; the totals agree
for step in range(3):
    x = f32(sum(base), 2)
    res[f"in.a2a_rep{step}"] = x
    res[f"out.a2a_rep{step}"], info[f"recv.a2a_rep{step}"] = hvd.alltoall(
        x, splits=a2a_splits, name="a2a_rep")

p = torch.zeros(4, requires_grad=True)
opt = hvd.DistributedOptimizer(hvd.fused_sgd([p], 0.1))
inter = []
for step in range(5):
    names = [f"di.{step}.{k}" for k in range(3)]
    if r % 2:
        names = names[::-1]
    hs = [hvd.allreduce_async(torch.full((2,), float(r + step)), name=nm,
                              op=hvd.Sum) for nm in names]
    p.grad = torch.full((4,), float(r + 1 + step))
    opt.step()
    inter.append([hvd.synchronize(h).tolist() for h in hs])
info["interleaved"] = inter
res["out.dopt"] = p.detach().numpy()

sizes = [q + 1 for q in range(n)]
block = np.full((n, 2), -1.0, np.float32)
block[:r + 1] = f32(r + 1, 2)
res["in.ragged"] = block
res["out.ragged"] = hvd.device.allgather_ragged(torch.from_numpy(block),
                                                sizes).numpy()
m = [[(q + j) % 3 for j in range(n)] for q in range(n)]
rows = max(sum(row) for row in m)
for row in m:
    row[-1] += rows - sum(row)
x = f32(rows, 2)
res["in.uneven"] = x
y, cnt = hvd.device.alltoall_uneven(torch.from_numpy(x), m)
res["out.uneven"], info["uneven_count"] = y.numpy(), int(cnt)

idx = rng.integers(0, 10, r + 2).astype(np.int64)
vals = f32(r + 2, 3)
res["in.sp_idx"], res["in.sp_val"] = idx, vals
sp = hvd.sparse_allreduce(idx, vals, (10, 3), name="sp")
res["out.sp_idx"], res["out.sp_val"] = sp.indices, sp.values
res["out.sp_dense"] = sp.to_dense()
ji, jv = hvd.ops.sparse.sparse_allreduce_jit(torch.from_numpy(idx[:2]),
                                             torch.from_numpy(vals[:2]))
res["out.spj_idx"], res["out.spj_val"] = ji.numpy(), jv.numpy()
info["objects"] = hvd.allgather_object({"rank": r, "w": [r] * r})
info["devices"] = [hvd.num_devices(), hvd.is_homogeneous(),
                   [str(d) for d in hvd.local_devices()],
                   [str(d) for d in hvd.global_devices()],
                   hvd.gloo_enabled(),
                   hvd.nccl_built() == dist.is_nccl_available()]

c0, t0, rt0 = ctl.cycles, time.perf_counter(), ctl.cp.round_trips
time.sleep(0.5)
info["idle_cycles_per_s"] = (ctl.cycles - c0) / (time.perf_counter() - t0)
info["round_trips_per_cycle"] = (ctl.cp.round_trips - rt0) / max(
    ctl.cycles - c0, 1)
np.savez(out + ".npz", **res)
with open(out + ".json", "w") as f:
    json.dump(info, f)
hvd.shutdown()
"""

_STALL_WORKER = r"""
import json, sys, time
import numpy as np
import torch.distributed as dist
import horovod_tpu_torch as hvd

hvd.init(device="cpu")
r = hvd.rank()
dist.barrier()
hvd.allreduce(np.ones(2, np.float32), name="warmup")   # both controllers up
info = {}
if r == 0:
    t0 = time.perf_counter()
    try:
        hvd.allreduce(np.ones(2, np.float32), name="stalled")
        info["stalled"] = "completed"
    except hvd.HorovodInternalError as e:
        info["stalled"] = str(e)
    info["abort_after_s"] = time.perf_counter() - t0
else:
    # past the abort (2-3 s), and soon enough that rank 0's barrier does
    # not stall past the abort age itself
    time.sleep(3.5)
hvd.barrier()
info["after"] = hvd.allreduce(np.full(2, r, np.float32), name="after",
                              op=hvd.Sum).tolist()
with open(sys.argv[1] + ".json", "w") as f:
    json.dump(info, f)
hvd.shutdown()
"""


_CALLER_GROUP_WORKER = r"""
import json, os, sys
import numpy as np
import torch.distributed as dist
import horovod_tpu_torch as hvd

r, n = int(os.environ["HVDT_RANK"]), int(os.environ["HVDT_SIZE"])
dist.init_process_group(
    "gloo", init_method="tcp://" + os.environ["HVDT_COORDINATOR_ADDR"],
    rank=r, world_size=n)
hvd.init(device="cpu")          # adopts the group and its store
names = ["a", "b", "c"] if r == 0 else ["c", "a", "b"]
hs = {nm: hvd.allreduce_async(np.full(2, r + ord(nm), np.int64), name=nm,
                              op=hvd.Sum) for nm in names}
out = {nm: hvd.synchronize(h).tolist() for nm, h in hs.items()}
with open(sys.argv[1] + ".json", "w") as f:
    json.dump(out, f)
hvd.shutdown()
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_world(code, n, out_dir, extra_env=None):
    env = dict(os.environ, HVDT_SIZE=str(n),
               HVDT_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
               HVDT_CONTROL_PLANE_TIMEOUT_S="60",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""), **(extra_env or {}))
    env.pop("HVDT_FUSED_CONV1X1", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(out_dir / f"r{r}")],
        env=dict(env, HVDT_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=90)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return logs


@pytest.fixture(scope="module", params=[2, 3], ids=["world2", "world3"])
def world(request, tmp_path_factory):
    n = request.param
    out = tmp_path_factory.mktemp(f"eager{n}")
    _run_world(_WORKER, n, out)
    res = [dict(np.load(out / f"r{r}.npz")) for r in range(n)]
    info = [json.loads((out / f"r{r}.json").read_text()) for r in range(n)]
    return n, res, info


def _ins(res, name):
    return [r[f"in.{name}"] for r in res]


def _close_sum(got, want, x):
    """rtol 1e-6, with an atol of 1e-6 of the summands' magnitude: the
    backend may add the ranks in another order than numpy, and a sum that
    cancels has no relative precision."""
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(x).sum(0).max()))


_REDUCE = {"o.sum": np.sum, "o.avg": np.mean, "o.min_i32": np.min,
           "o.max_i64": np.max, "o.min_i64": np.min, "o.prod_i32": np.prod,
           "o.sum_f64": np.sum}


@pytest.mark.parametrize("name", sorted(_REDUCE))
def test_allreduce_any_order(world, name):
    n, res, _ = world
    x = np.stack(_ins(res, name))
    want = _REDUCE[name](x, axis=0).astype(x.dtype)
    for r in range(n):
        got = res[r][f"out.{name}"]
        assert got.dtype == x.dtype
        if x.dtype.kind == "f" and name in ("o.sum", "o.avg", "o.sum_f64"):
            _close_sum(got, want, x)
        else:
            np.testing.assert_array_equal(got, want)


def test_int64_beyond_32_bits_exact(world):
    n, res, _ = world
    x = np.stack(_ins(res, "o.max_i64"))
    assert np.abs(x).max() > 2**40
    for r in range(n):
        np.testing.assert_array_equal(res[r]["out.o.max_i64"], x.max(0))
        np.testing.assert_array_equal(res[r]["out.o.min_i64"],
                                      np.stack(_ins(res, "o.min_i64")).min(0))


def test_scaled_and_integer_average(world):
    n, res, _ = world
    x = np.stack(_ins(res, "o.scaled"))
    # each rank's contribution is scaled in f32 before the sum, as the JAX
    # package scales it (v * np.asarray(0.5, v.dtype))
    want = (x * np.float32(0.5)).sum(0) * np.float32(3.0)
    xi = np.stack(_ins(res, "o.avg_i32"))
    want_i = np.trunc(xi.sum(0) / n).astype(np.int32)
    xb = np.stack(_ins(res, "o.max_bf16"))
    import ml_dtypes
    want_b = xb.astype(ml_dtypes.bfloat16).astype(np.float32).max(0)
    for r in range(n):
        _close_sum(res[r]["out.o.scaled"], want, 1.5 * x)
        np.testing.assert_array_equal(res[r]["out.o.avg_i32"], want_i)
        np.testing.assert_array_equal(res[r]["out.o.max_bf16"], want_b)


def test_ragged_allgather(world):
    n, res, _ = world
    for name in ("o.ag", "o.ag_i64"):
        want = np.concatenate(_ins(res, name))
        for r in range(n):
            np.testing.assert_array_equal(res[r][f"out.{name}"], want)


def test_broadcast_set_relative_root(world):
    n, res, _ = world
    for r in range(n):
        np.testing.assert_array_equal(res[r]["out.o.bc"], res[1]["in.o.bc"])
        got = res[r]["out.o.bc0d"]
        assert got.shape == () and got == res[n - 1]["in.o.bc0d"]


def test_uneven_alltoall_and_splits(world):
    n, res, info = world
    ins = _ins(res, "o.a2a")
    splits = [[(q + j) % 3 for j in range(n)] for q in range(n)]
    for r in range(n):
        parts = [ins[q][sum(splits[q][:r]):sum(splits[q][:r + 1])]
                 for q in range(n)]
        np.testing.assert_array_equal(res[r]["out.o.a2a"],
                                      np.concatenate(parts))
        assert info[r]["recv.o.a2a"] == [splits[q][r] for q in range(n)]


def test_reducescatter_remainder_rows(world):
    n, res, _ = world
    for name, fn, exact in (("o.rs", np.sum, False), ("o.rs_avg", np.mean,
                                                       False),
                            ("o.rs_max", np.max, True)):
        x = np.stack(_ins(res, name))
        full = fn(x, axis=0)
        base, rem = divmod(full.shape[0], n)
        for r in range(n):
            start = r * base + min(r, rem)
            want = full[start:start + base + (r < rem)]
            got = res[r][f"out.{name}"]
            assert got.shape == want.shape
            if exact:
                np.testing.assert_array_equal(got, want)
            else:
                start_x = x[:, start:start + want.shape[0]]
                _close_sum(got, want, start_x)


def test_grouped_allreduce(world):
    n, res, _ = world
    for i in range(3):
        x = np.stack(_ins(res, f"grp{i}"))
        for r in range(n):
            _close_sum(res[r][f"out.grp{i}"], x.sum(0), x)


def test_join_uneven_steps(world):
    n, res, info = world
    for r in range(n):
        assert info[r]["join"] == n - 1
        for i in range(r + 1):
            live = [q for q in range(n) if q + 1 > i]
            np.testing.assert_array_equal(
                res[r][f"out.js{i}"],
                np.full(3, sum(q + 1 + i for q in live), np.float32))
            # a joined rank contributes MIN's identity, not a zero
            np.testing.assert_array_equal(
                res[r][f"out.jm{i}"],
                np.full(2, min(q + 10 * i for q in live), np.int32))


def test_process_sets_and_removal(world):
    n, res, info = world
    members = [0, n - 1] if n > 2 else [1]
    for r in members:
        np.testing.assert_array_equal(res[r]["out.ps"],
                                      [sum(q + 1.0 for q in members)] * 2)
        np.testing.assert_array_equal(res[r]["out.ps2"],
                                      [max(q + 1.0 for q in members)] * 2)
    for r in range(n):
        assert ("out.ps" in res[r]) == (r in members)
        assert info[r]["removed"] == f"Unknown process set id {info[r]['ps_id']}"
        assert info[r]["ps2_id"] != info[r]["ps_id"]
    assert len({i["ps_id"] for i in info}) == 1


def test_mismatched_shape_fails_every_rank(world):
    """Every rank gets the coordinator's one message, which names the
    first request to arrive against the first that disagrees with it."""
    n, _, info = world
    msgs = {i["mismatch"] for i in info}
    assert len(msgs) == 1
    shapes = [f"({2 + r},)" for r in range(n)]
    assert any(msgs == {f"Mismatched shape/params for tensor mm: {a} vs {b}."}
               for a in shapes for b in shapes if a != b), msgs


def test_second_cycle_from_response_cache(world):
    n, res, info = world
    for r in range(n):
        assert info[r]["bits"], "no request went out as a cache bit"
        for step in range(3):
            np.testing.assert_array_equal(
                res[r][f"out.cached{step}"],
                np.full(4, sum(q + step for q in range(n)), np.float32))


def test_alltoall_repeated_under_one_name(world):
    """The same named alltoall three times, each rank with its own send
    splits and the same shape every call: every call sends with each
    rank's own splits (a cached descriptor, alike on every rank, cannot
    carry them)."""
    n, res, info = world
    base = [j + 1 for j in range(n)]
    splits = [base[q:] + base[:q] for q in range(n)]
    for step in range(3):
        ins = _ins(res, f"a2a_rep{step}")
        for r in range(n):
            parts = [ins[q][sum(splits[q][:r]):sum(splits[q][:r + 1])]
                     for q in range(n)]
            np.testing.assert_array_equal(res[r][f"out.a2a_rep{step}"],
                                          np.concatenate(parts))
            assert info[r][f"recv.a2a_rep{step}"] == [splits[q][r]
                                                      for q in range(n)]


def test_interleaved_with_distributed_optimizer(world):
    n, res, info = world
    want_p = -0.1 * sum(np.mean([q + 1 + s for q in range(n)])
                        for s in range(5))
    for r in range(n):
        np.testing.assert_allclose(res[r]["out.dopt"], [want_p] * 4,
                                   rtol=1e-6)
        for step, vals in enumerate(info[r]["interleaved"]):
            for v in vals:
                assert v == [float(sum(q + step for q in range(n)))] * 2


def _jax_mesh(n):
    return Mesh(np.asarray(jax.devices()[:n], dtype=object), ("dp",))


def test_device_ragged_ops_match_jax(world):
    n, res, info = world
    mesh = _jax_mesh(n)
    sizes = [q + 1 for q in range(n)]
    blocks = jnp.stack(_ins(res, "ragged"))
    want = jax.jit(jax.shard_map(
        lambda t: jdev.allgather_ragged(t[0], sizes, "dp"), mesh=mesh,
        in_specs=(P("dp"),), out_specs=P("dp")))(blocks)
    total = sum(sizes)
    m = [[(q + j) % 3 for j in range(n)] for q in range(n)]
    rows = max(sum(row) for row in m)
    for row in m:
        row[-1] += rows - sum(row)

    def body(t):
        out, cnt = jdev.alltoall_uneven(t[0], m, "dp")
        return out, jnp.broadcast_to(cnt, (1,))

    uneven, cnts = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P("dp"),),
        out_specs=(P("dp"), P("dp"))))(jnp.stack(_ins(res, "uneven")))
    rows_out = uneven.shape[0] // n
    for r in range(n):
        np.testing.assert_array_equal(
            res[r]["out.ragged"], np.asarray(want)[r * total:(r + 1) * total])
        np.testing.assert_array_equal(
            res[r]["out.uneven"],
            np.asarray(uneven)[r * rows_out:(r + 1) * rows_out])
        assert info[r]["uneven_count"] == int(cnts[r])


def test_sparse_allreduce(world):
    n, res, info = world
    idx = np.concatenate(_ins(res, "sp_idx"))
    vals = np.concatenate(_ins(res, "sp_val"))
    want = (vals / n).astype(np.float32)
    dense = np.zeros((10, 3), np.float32)
    np.add.at(dense, idx, want)
    mesh = _jax_mesh(n)
    # op by op: under jax.jit XLA divides by n as a multiply by 1/n (an
    # ulp off the division the port and numpy do)
    ji, jv = jax.shard_map(
        lambda i, v: jsparse.sparse_allreduce_jit(i[0], v[0], "dp"),
        mesh=mesh, in_specs=(P("dp"), P("dp")), out_specs=(P(), P()),
        check_vma=False)(
        jnp.stack([x[:2] for x in _ins(res, "sp_idx")]).astype(jnp.int32),
        jnp.stack([x[:2] for x in _ins(res, "sp_val")]))
    for r in range(n):
        np.testing.assert_array_equal(res[r]["out.sp_idx"], idx)
        np.testing.assert_array_equal(res[r]["out.sp_val"], want)
        np.testing.assert_allclose(res[r]["out.sp_dense"], dense, rtol=1e-6)
        np.testing.assert_array_equal(res[r]["out.spj_idx"], np.asarray(ji))
        np.testing.assert_array_equal(res[r]["out.spj_val"], np.asarray(jv))
        assert info[r]["objects"] == [{"rank": q, "w": [q] * q}
                                      for q in range(n)]


def test_devices_and_flags(world):
    """One device a process (the CPU in a gloo world), every host alike
    (one host here), the gloo flag on."""
    n, _, info = world
    for r in range(n):
        assert info[r]["devices"] == [n, True, ["cpu"], ["cpu"] * n, True,
                                      True]


def test_control_plane_cycles_while_idle(world):
    """The controller keeps cycling while idle (with the JAX package's
    back-off of up to 2 ms a cycle).  Every rank writes its payload and
    deletes the one it wrote KEEP cycles before; rank 0 reads them all
    in one wait and one multi_get and writes and deletes the response,
    the others read it.  So no rank's count grows with the world."""
    n, _, info = world
    for r in range(n):
        # at least 10 cycles in the half-second window, at most one per
        # 0.1 ms of back-off
        assert 20 < info[r]["idle_cycles_per_s"] < 10000
    # (a window's edges cut a cycle's calls: 20% over >= 10 cycles)
    for r in range(1, n):
        assert info[r]["round_trips_per_cycle"] == pytest.approx(4.0,
                                                                 rel=0.2)
    assert info[0]["round_trips_per_cycle"] == pytest.approx(6.0, rel=0.2)


def test_group_made_by_the_caller(tmp_path):
    """init() adopts a process group the caller made, and the control
    plane reaches the store that group was made over."""
    _run_world(_CALLER_GROUP_WORKER, 2, tmp_path)
    for r in range(2):
        out = json.loads((tmp_path / f"r{r}.json").read_text())
        assert out == {nm: [2 * ord(nm) + 1] * 2 for nm in "abc"}


def test_stall_warns_then_aborts(tmp_path):
    logs = _run_world(_STALL_WORKER, 2, tmp_path, {
        "HVDT_STALL_CHECK_TIME_SECONDS": "1",
        "HVDT_STALL_ABORT_TIME_SECONDS": "2"})
    info = json.loads((tmp_path / "r0.json").read_text())
    assert info["stalled"] == (
        "collective stalled aborted: stalled past "
        "HVDT_STALL_ABORT_TIME_SECONDS (missing ranks never submitted)")
    # past the abort age (2 s); the coordinator checks once a second
    assert 2.0 < info["abort_after_s"] < 10.0
    assert "Stalled op: stalled [ready ranks: [0]] [missing ranks: [1]]" \
        in logs[0]
    for r in range(2):
        after = json.loads((tmp_path / f"r{r}.json").read_text())["after"]
        assert after == [1.0, 1.0]
