"""PyTorch port, the reference's 4D acceptance battery
(tests/test_parallel4d.py) at ``pp=2 x ep=2 x dp=2``.

One 8-process gloo world over ``make_mesh(dp=2, pp=2, ep=2)`` trains the
battery's model: each pipeline stage (``pipeline_1f1b`` over ``pp``) is
an in-projection and an MoE layer (``moe_dispatch_combine`` over ``ep``,
one expert a member, top-1, capacity factor 4.0: nothing dropped), under
``DistributedOptimizer(SGD(0.1), axis="dp", pipeline="pp",
expert="ep")``.  Each member holds only its stage's weights and its
expert (``mark_sharded``), and its own microbatches of the ``[dp, M,
ep * TOK, DIM]`` batch.

* 5 SGD steps: the loss averaged over the world and every member's
  parameters after the steps against the single-device dense reference
  (sequential stages, argmax top-1), computed with ``jax.grad`` on the
  same numpy weights: rtol 2e-4, the battery's bound.
* ``HVDT_TRANSPORT=ep:ring:int8:64M`` flips the expert wire to the
  block-scaled int8 one: the loss within 5% of the exact wire's, the
  battery's bound.
* The optimizer refuses an ``axis`` that names a sharded axis with the
  reference's ``ValueError``; ``parallel.fiber_group`` over two mesh
  dimensions holds the ranks that share the third coordinate.
* The trained per-stage Adam state, ZeRO-sharded 4 ways a stage, saved
  with ``checkpoint.save_zero_state_4d`` under (pp=2, dp=4) and restored
  by ``restore_zero_state_4d`` as one flat dp=8 state: the stage-major
  logical vector, exactly.

The battery's telemetry bubble histograms and cost-model pricing wait
for ROADMAP Queue 1 items 6 and 8.
"""

import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import checkpoint as tck
from horovod_tpu_torch.ops import zero as tz

ROOT = pathlib.Path(__file__).resolve().parents[1]
PP, EP, DP = 2, 2, 2
DIM, N_MB, TOK = 128, 4, 8
CAPACITY, LR, STEPS = 4.0, 0.1, 5


def _inputs():
    """The battery's weights and batch, drawn by jax.random as the
    reference's test draws them, as numpy."""
    kp, kx, kt = jax.random.split(jax.random.PRNGKey(42), 3)
    kw, kr, ke = jax.random.split(kp, 3)
    scale = 0.5 / np.sqrt(DIM)
    params = {
        "w": jax.random.normal(kw, (PP, DIM, DIM), jnp.float32) * scale,
        "rw": jax.random.normal(kr, (PP, DIM, EP), jnp.float32),
        "we": jax.random.normal(ke, (PP, EP, DIM, DIM), jnp.float32) * scale,
    }
    x = jax.random.normal(kx, (DP, N_MB, EP * TOK, DIM), jnp.float32)
    tgt = jax.random.normal(kt, (DP, N_MB, EP * TOK, DIM), jnp.float32) * 0.1
    return ({k: np.asarray(v) for k, v in params.items()}, np.asarray(x),
            np.asarray(tgt))


def _dense_reference(params, x, tgt):
    """The battery's single-device reference: sequential stages, argmax
    top-1 routing (at top_k 1 the renormalised gate is 1)."""
    out_mb = []
    for d in range(DP):
        for mb in range(N_MB):
            h = x[d, mb].reshape(EP * TOK, DIM)
            for s in range(PP):
                a = jnp.tanh(h @ params["w"][s])
                sel = jnp.argmax(a @ params["rw"][s], axis=-1)
                expert_out = jnp.stack([jnp.tanh(a @ params["we"][s, e])
                                        for e in range(EP)])
                h = h + jnp.take_along_axis(expert_out, sel[None, :, None],
                                            axis=0)[0]
            out_mb.append(jnp.mean(
                (h - tgt[d, mb].reshape(EP * TOK, DIM)) ** 2))
    return jnp.mean(jnp.stack(out_mb))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_WORKER = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist
import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel import (fiber_group, make_mesh, mark_sharded,
                                        moe_dispatch_combine, pipeline_1f1b)

PP, EP, DP, TOK, N_MB = 2, 2, 2, 8, 4
data = np.load(sys.argv[1])
hvd.init(device="cpu")
mesh = make_mesh(dp=DP, pp=PP, ep=EP)
s, e, d = (mesh.get_local_rank(a) for a in ("pp", "ep", "dp"))
w = mark_sharded(torch.tensor(data["w"][s], requires_grad=True), "pp")
rw = mark_sharded(torch.tensor(data["rw"][s], requires_grad=True), "pp")
we = mark_sharded(torch.tensor(data["we"][s, e], requires_grad=True), "pp",
                  "ep")
rows = slice(e * TOK, (e + 1) * TOK)
x = torch.from_numpy(data["x"][d, :, rows])
tgt = torch.from_numpy(data["tgt"][d, :, rows])

def stage_fn(p, h_in):
    h = torch.tanh(h_in @ p[0])
    y, _ = moe_dispatch_combine(
        h, h @ p[1],
        lambda blk: torch.tanh(torch.einsum("ecd,df->ecf", blk, p[2])),
        group=mesh, experts_per_rank=1, capacity_factor=4.0, top_k=1)
    return h_in + y

def local_loss():
    out = pipeline_1f1b(stage_fn, (w, rw, we), x, group=mesh)
    return ((out - tgt) ** 2).mean()

def world_mean(v):
    t = torch.tensor([float(v)], dtype=torch.float64)
    dist.all_reduce(t)
    return t.item() / dist.get_world_size()

res = {}
with torch.no_grad():
    base = local_loss()
os.environ["HVDT_TRANSPORT"] = "ep:ring:int8:64M"
with torch.no_grad():
    quant = local_loss()
del os.environ["HVDT_TRANSPORT"]
res["base"], res["quant"] = world_mean(base), world_mean(quant)

opt = hvd.DistributedOptimizer(torch.optim.SGD([w, rw, we], lr=0.1),
                               axis="dp", pipeline="pp", expert="ep")
losses = []
for _ in range(5):
    opt.zero_grad()
    loss = local_loss()
    loss.backward()
    opt.step()
    losses.append(world_mean(loss.detach()))
with torch.no_grad():
    losses.append(world_mean(local_loss()))
res["losses"] = np.array(losses)
res["w"], res["rw"], res["we"] = (t.detach().numpy() for t in (w, rw, we))
res["coords"] = np.array([s, e, d])
res["fiber_dp_ep"] = np.array(dist.get_process_group_ranks(
    fiber_group(mesh, ("dp", "ep"))))
np.savez(sys.argv[2], **res)
hvd.shutdown()
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("p4d")
    params, x, tgt = _inputs()
    np.savez(tmp / "in.npz", x=x, tgt=tgt, **params)
    n = PP * EP * DP
    env = dict(os.environ, HVDT_SIZE=str(n),
               HVDT_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
               OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for k in ("HVDT_TRANSPORT", "HVDT_OVERLAP", "HVDT_ZERO"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(tmp / "in.npz"),
         str(tmp / f"out{r}.npz")], env=dict(env, HVDT_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(n)]
    # The dense reference's 5 SGD steps meanwhile.
    loss_fn = jax.jit(_dense_reference)
    grad_fn = jax.jit(jax.grad(_dense_reference))
    p = {k: jnp.asarray(v) for k, v in params.items()}
    xs, ts = jnp.asarray(x), jnp.asarray(tgt)
    ref_losses = []
    for _ in range(STEPS):
        ref_losses.append(float(loss_fn(p, xs, ts)))
        g = grad_fn(p, xs, ts)
        p = jax.tree.map(lambda a, b: a - LR * b, p, g)
    ref_losses.append(float(loss_fn(p, xs, ts)))
    res = []
    for r, proc in enumerate(procs):
        log, _ = proc.communicate(timeout=240)
        assert proc.returncode == 0, log.decode()[-3000:]
        res.append(dict(np.load(tmp / f"out{r}.npz")))
    return res, np.array(ref_losses), {k: np.asarray(v) for k, v in
                                      p.items()}


def test_4d_training_matches_single_device_reference(world):
    res, ref_losses, ref_params = world
    for r in res:
        np.testing.assert_allclose(r["losses"], ref_losses, rtol=2e-4,
                                   atol=1e-6)
    assert ref_losses[-1] < ref_losses[0]
    seen = set()
    for r in res:
        s, e, d = (int(c) for c in r["coords"])
        seen.add((s, e, d))
        np.testing.assert_allclose(r["w"], ref_params["w"][s], rtol=2e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(r["rw"], ref_params["rw"][s],
                                   rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(r["we"], ref_params["we"][s, e],
                                   rtol=2e-4, atol=1e-6)
    assert len(seen) == PP * EP * DP


def test_fiber_groups(world):
    """A fiber over two mesh dimensions: the ranks that share this one's
    pp coordinate (the mesh lays ranks out dp, pp, ep, outermost
    first)."""
    res, _, _ = world
    for r in res:
        s = int(r["coords"][0])
        want = sorted(d * PP * EP + s * EP + e for d in range(DP)
                      for e in range(EP))
        assert sorted(r["fiber_dp_ep"].tolist()) == want


def test_int8_expert_wire_one_policy_line(world):
    res, _, _ = world
    for r in res:
        assert r["quant"] == pytest.approx(float(r["base"]), rel=0.05)
        assert r["quant"] != r["base"]


def test_reduce_axis_may_not_overlap_sharded_axes():
    params = [torch.zeros(2, requires_grad=True)]
    with pytest.raises(ValueError, match="parameter-SHARDED"):
        hvd.DistributedOptimizer(torch.optim.SGD(params, 0.1),
                                 axis=("dp", "pp"), pipeline="pp")
    with pytest.raises(ValueError, match="parameter-SHARDED"):
        hvd.DistributedOptimizer(torch.optim.SGD(params, 0.1),
                                 axis=("dp", "ep"), expert="ep")


def test_trained_4d_state_restores_flat(world, tmp_path):
    """The trained stages' Adam state, 4 ZeRO shards a stage under
    (pp=2, dp=4), restores as one flat dp=8 state: the logical vector is
    kept stage-major."""
    res, _, _ = world
    by_stage = {}
    for r in res:
        s, e, _ = (int(c) for c in r["coords"])
        by_stage.setdefault(s, {})["w"] = torch.from_numpy(r["w"])
        by_stage[s]["rw"] = torch.from_numpy(r["rw"])
        by_stage[s][f"we{e}"] = torch.from_numpy(r["we"])
    states, metas, trees = [], [], []
    for s in range(PP):
        tree = [by_stage[s][k] for k in ("w", "rw", "we0", "we1")]
        tx = tz.zero_adam(1e-3, num_shards=4, threshold_bytes=4096)
        st = tx.init(tree)
        tx.update([torch.ones_like(t) for t in tree], st, tree)
        states.append(st)
        metas.append(tz.state_metadata(tx, tree))
        trees.extend(tree)
    tck.save_zero_state_4d(str(tmp_path), states, metas, step=1)
    tx8 = tz.zero_adam(1e-3, num_shards=8, threshold_bytes=4096)
    out, out_metas, step = tck.restore_zero_state_4d(
        str(tmp_path), [tz.state_metadata(tx8, trees)])
    assert step == 1 and out_metas[0]["num_shards"] == 8
    got = tz.flatten_state_buffers(out[0], out_metas[0])
    want = np.concatenate([tz.flatten_state_buffers(st, me)["mu"]
                           for st, me in zip(states, metas)])
    np.testing.assert_array_equal(got["mu"], want)
    assert np.abs(want).max() > 0
