"""PyTorch port: the overlap scheduling layer (horovod_tpu_torch/ops/
overlap.py) against the JAX package's ops/overlap.py and against the
port's own monolithic exchange.

* The reverse-topological schedule equals the reference's
  ``overlap_schedule`` on the same shapes and dtypes, invalid thresholds
  included; ``exchange_fn`` is ``fused_allreduce`` itself with
  ``HVDT_OVERLAP`` unset or off, and ``DistributedOptimizer`` registers
  no hook then.
* ``overlap_fraction`` and ``last_schedule`` equal the reference's after
  the same exchange (the reference traced under ``shard_map`` over one
  device, the port in a world of one).
* In a 2-process gloo world, on exactly representable inputs (integers
  and dyadic fractions, so no sum rounds whatever its order): the
  scheduler's exchange, the hooked ``DistributedOptimizer`` step (k = 1
  and k = 2), ``pipelined_sgd`` and ``overlap_value_and_grad`` equal the
  monolithic path bit for bit; the int8 start/finish pipeline equals the
  flat quantized allreduce of the same buckets bit for bit, and so do
  Adasum buckets against ``adasum_allreduce``; with
  ``backward_passes_per_step=2`` only the boundary pass issues a
  collective; error feedback compensates in the hooks as it does in
  ``step()``.
"""

import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.ops import overlap as jov
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import device as tdev
from horovod_tpu_torch.ops import optim_kernels as tok
from horovod_tpu_torch.ops import overlap as tov

ROOT = pathlib.Path(__file__).resolve().parents[1]

_NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
       "float16": np.float16, "int32": np.int32}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "int32": torch.int32}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("HVDT_OVERLAP", "HVDT_TRANSPORT", "HVDT_FUSION_THRESHOLD",
              "HVDT_COMPRESSION", "HVDT_QUANT"):
        monkeypatch.delenv(k, raising=False)
    tov.reset()
    tov.reset_accounting()
    jov.reset()
    jov.reset_accounting()
    yield
    tov.reset()
    jov.reset()


def _leaf_lists(seed):
    rng = np.random.default_rng(seed)
    names = list(_NP)
    specs = [(tuple(int(d) for d in rng.integers(1, 40, rng.integers(1, 4))),
              names[rng.integers(len(names))]) for _ in range(30)]
    return ([np.zeros(s, _NP[d]) for s, d in specs],
            [torch.empty(s, dtype=_TORCH[d]) for s, d in specs])


@pytest.mark.parametrize("threshold", [64, 256, 1000, 4096, 1 << 20, None,
                                       0, -5, "garbage"])
@pytest.mark.parametrize("seed", [0, 1])
def test_schedule_matches_reference(seed, threshold, monkeypatch):
    monkeypatch.setenv("HVDT_FUSION_THRESHOLD", "512")
    jleaves, tleaves = _leaf_lists(seed)
    assert (tov.overlap_schedule(tleaves, threshold)
            == jov.overlap_schedule(jleaves, threshold))


def test_exchange_fn_identity_and_knob(monkeypatch):
    assert tov.get_scheduler() is None
    assert tov.exchange_fn() is tdev.fused_allreduce
    for off in ("", "0", "off", "false", "no"):
        monkeypatch.setenv("HVDT_OVERLAP", off)
        assert tov.exchange_fn() is tdev.fused_allreduce
        assert jov.exchange_fn() is not None
    monkeypatch.setenv("HVDT_OVERLAP", "on")
    sched = tov.get_scheduler()
    assert isinstance(sched, tov.OverlapScheduler)
    assert tov.exchange_fn() == sched.exchange
    assert tov.get_scheduler() is sched          # cached on the env string
    monkeypatch.setenv("HVDT_OVERLAP", "off")
    assert tov.exchange_fn() is tdev.fused_allreduce


def test_latency_hiding_knob(monkeypatch):
    for mode in ("auto", "on", "off", None):
        assert tov.enable_latency_hiding(mode) is None
    monkeypatch.setenv("HVDT_XLA_LATENCY_HIDING", "bogus")
    with pytest.raises(ValueError, match="valid: auto, on, off"):
        tov.enable_latency_hiding()


@pytest.fixture
def world1():
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def test_no_hooks_when_off(world1, monkeypatch):
    p = torch.zeros(3, requires_grad=True)
    opt = hvd.DistributedOptimizer(tok.fused_sgd([p], 0.1))
    assert opt._hooked is None and not p._post_accumulate_grad_hooks
    monkeypatch.setenv("HVDT_OVERLAP", "on")
    opt = hvd.DistributedOptimizer(tok.fused_sgd([p], 0.1))
    assert len(p._post_accumulate_grad_hooks) == 1
    opt._hooked.remove()
    assert not p._post_accumulate_grad_hooks


def _acct_leaves(seed=3):
    rng = np.random.default_rng(seed)
    shapes = [(64, 3), (300,), (17,), (8, 8), (5,)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("threshold", [256, 1024, 1 << 20])
def test_overlap_fraction_matches_reference(world1, threshold):
    leaves = _acct_leaves()
    mesh = Mesh(np.asarray(jax.devices()[:1], dtype=object), ("dp",))

    def body(*xs):
        return tuple(jov.OverlapScheduler().exchange(
            list(xs), axis="dp", threshold_bytes=threshold))

    jax.shard_map(body, mesh=mesh, in_specs=(P(),) * len(leaves),
                  out_specs=(P(),) * len(leaves), check_vma=False)(
        *[jnp.asarray(x) for x in leaves])
    got = tov.OverlapScheduler().exchange(
        [torch.from_numpy(x) for x in leaves], threshold_bytes=threshold)
    for g, x in zip(got, leaves):
        np.testing.assert_array_equal(g.numpy(), x)
    assert tov.last_schedule() == jov.last_schedule()
    assert tov.overlap_fraction() == pytest.approx(jov.overlap_fraction(),
                                                   abs=0)


# ---- a two-process gloo world ------------------------------------------------

_WORKER = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import device as dev
from horovod_tpu_torch.ops import overlap as ov
from horovod_tpu_torch.quant import collectives as qc

data = np.load(sys.argv[1])
hvd.init(device="cpu")
r = hvd.rank()
T = lambda k: torch.from_numpy(data[k][r].copy())
res = {}
TH = 256
leaves = [T(f"leaf{i}") for i in range(6)] + [torch.arange(5, dtype=torch.int32) + r]

# The scheduler's exchange against the monolithic one.
for tag, kw in (("avg", {}), ("sum", dict(op=hvd.Sum)),
                ("scaled", dict(prescale_factor=0.5, postscale_factor=2.0)),
                ("bf16wire", dict(wire_dtype=torch.bfloat16))):
    xs = leaves if tag in ("avg", "sum") else leaves[:6]   # int: no scale
    mono = dev.fused_allreduce(xs, threshold_bytes=TH, **kw)
    ovl = ov.OverlapScheduler().exchange(xs, threshold_bytes=TH, **kw)
    for i, (a, b) in enumerate(zip(mono, ovl)):
        res[f"mono.{tag}.{i}"] = a.numpy()
        res[f"ovl.{tag}.{i}"] = b.numpy()
res["fraction"] = np.float64(ov.overlap_fraction())

# The int8 start/finish pipeline against the flat quantized allreduce of
# the same buckets.
fl = [T(f"leaf{i}") for i in range(6)]
q = ov.OverlapScheduler().exchange(fl, threshold_bytes=TH,
                                   wire_dtype=qc.INT8_WIRE)
for i, v in enumerate(q):
    res[f"q8.pipe.{i}"] = v.numpy()
for ids in ov.overlap_schedule(fl, TH):
    flat = torch.cat([fl[i].reshape(-1) for i in ids])
    red = qc.quantized_allreduce_flat(flat, hvd.Average, wire="int8")
    off = 0
    for i in ids:
        n = fl[i].numel()
        res[f"q8.flat.{i}"] = red[off:off + n].view(fl[i].shape).numpy()
        off += n

# Adasum through the scheduler against adasum_allreduce of the same
# buckets (the "adasum" bucket kind, issued whole).
from horovod_tpu_torch.ops import adasum as ad
a = ov.OverlapScheduler().exchange(fl, op=hvd.Adasum, threshold_bytes=TH)
for i, v in enumerate(a):
    res[f"ada.pipe.{i}"] = v.numpy()
for ids in ov.overlap_schedule(fl, TH):
    flat = torch.cat([fl[i].reshape(-1) for i in ids])
    red = ad.adasum_allreduce(flat)
    off = 0
    for i in ids:
        n = fl[i].numel()
        res[f"ada.flat.{i}"] = red[off:off + n].view(fl[i].shape).numpy()
        off += n

# Whole steps: a two-layer linear model on integer inputs (every gradient
# and update is a dyadic fraction, so no sum rounds).
def model():
    g = torch.Generator().manual_seed(7)
    return [torch.randint(-3, 4, s, generator=g).float().requires_grad_()
            for s in ((8, 16), (16,), (16, 4), (4,))]

def loss_of(ps, x):
    h = x @ ps[0] + ps[1]
    return ((h @ ps[2] + ps[3]) * T("wout")[:x.shape[0]]).sum()

calls = {"n": 0}
real = dist.all_reduce
def counting(*a, **k):
    calls["n"] += 1
    return real(*a, **k)
dist.all_reduce = counting

def run(tag, k=1, steps=4, pipelined=False, ef=False):
    ps = model()
    if pipelined:
        opt = ov.pipelined_sgd(ps, 0.25, momentum=0.5, threshold_bytes=64)
    else:
        opt = hvd.DistributedOptimizer(
            hvd.fused_sgd(ps, 0.25, momentum=0.5), threshold_bytes=64,
            backward_passes_per_step=k,
            compression=hvd.Compression.int8 if ef else None)
        if ef:
            opt = hvd.quant.with_error_feedback(opt, block_size=64)
    issued, counts = [], []
    for s in range(steps):
        opt.zero_grad()
        calls["n"] = 0
        loss_of(ps, T("x")[s]).backward()
        inner = opt.optimizer if ef else opt
        hooked = getattr(inner, "_hooked", None)
        issued.append(-1 if hooked is None else hooked.next_issue)
        in_backward = calls["n"]
        calls["n"] = 0
        opt.step()
        counts.append((in_backward, calls["n"]))
    for i, p in enumerate(ps):
        res[f"step.{tag}.{i}"] = p.detach().numpy()
        res[f"grad.{tag}.{i}"] = p.grad.numpy()
    res[f"issued.{tag}"] = np.array(issued)
    res[f"calls.{tag}"] = np.array(counts)
    if hasattr(inner, "_hooked") and inner._hooked is not None:
        inner._hooked.remove()
    if ef:
        for i, p in enumerate(ps):
            res[f"resid.{tag}.{i}"] = opt.residual[p].numpy()

run("mono")
run("mono_k2", k=2)
run("mono_ef", ef=True)
os.environ["HVDT_OVERLAP"] = "on"
run("hook")
run("hook_k2", k=2)
run("hook_ef", ef=True)

# A second backward before step(), or zero_grad() between backward() and
# step(), raises; step() then still drains what the hooks issued.
def misuse(tag, between):
    ps = model()
    opt = hvd.DistributedOptimizer(hvd.fused_sgd(ps, 0.25),
                                   threshold_bytes=64)
    loss_of(ps, T("x")[0]).backward()
    try:
        between(opt, ps)
        res[f"raised.{tag}"] = np.array(False)
    except RuntimeError as e:
        res[f"raised.{tag}"] = np.array("before step()" in str(e))
    opt.step()
    res[f"drained.{tag}"] = np.array(not opt._hooked.in_flight())
    opt._hooked.remove()

misuse("twice", lambda opt, ps: loss_of(ps, T("x")[1]).backward())
misuse("zero", lambda opt, ps: opt.zero_grad())
del os.environ["HVDT_OVERLAP"]
run("pipe", pipelined=True)

# The segmented backward against autograd and the monolithic exchange.
ps = model()
stages = [lambda p, x: x @ p[0] + p[1],
          lambda p, x: ((x @ p[0] + p[1]) * T("wout")[:x.shape[0]]).sum()]
fn = ov.overlap_value_and_grad(stages, threshold_bytes=64)
loss, grads = fn([ps[:2], ps[2:]], T("x")[0])
want = torch.autograd.grad(loss_of(ps, T("x")[0]), ps)
want = dev.fused_allreduce(list(want), threshold_bytes=64)
for i, (g, w) in enumerate(zip(grads[0] + grads[1], want)):
    res[f"seg.got.{i}"] = g.numpy()
    res[f"seg.want.{i}"] = w.numpy()
np.savez(sys.argv[2], **res)
hvd.shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dyadic(rng, shape):
    return (rng.integers(-64, 64, shape) / 4.0).astype(np.float32)


@pytest.fixture(scope="module")
def two_proc(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("overlap2")
    rng = np.random.default_rng(40)
    shapes = [(7, 5), (33,), (4, 4, 3), (19,), (64,), (3,)]
    data = {f"leaf{i}": np.stack([_dyadic(rng, s) for _ in range(2)])
            for i, s in enumerate(shapes)}
    data["x"] = rng.integers(-2, 3, (2, 4, 3, 8)).astype(np.float32)
    data["wout"] = rng.integers(-2, 3, (2, 3, 4)).astype(np.float32)
    np.savez(tmp / "in.npz", **data)
    env = dict(os.environ, HVDT_SIZE="2",
               HVDT_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for k in ("HVDT_OVERLAP", "HVDT_TRANSPORT", "HVDT_FUSION_THRESHOLD",
              "HVDT_COMPRESSION", "HVDT_QUANT", "HVDT_QUANT_BLOCK"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(tmp / "in.npz"),
         str(tmp / f"out{r}.npz")], env=dict(env, HVDT_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out.decode()[-3000:]
    return data, [dict(np.load(tmp / f"out{r}.npz")) for r in range(2)]


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("tag", ["avg", "sum", "scaled", "bf16wire"])
def test_scheduler_exchange_equals_monolithic(two_proc, tag):
    data, res = two_proc
    for r in range(2):
        for i in range(7 if tag in ("avg", "sum") else 6):
            _same(res[r][f"ovl.{tag}.{i}"], res[r][f"mono.{tag}.{i}"])
    if tag == "avg":             # and the mean it should be, exactly
        for i in range(6):
            np.testing.assert_array_equal(res[0][f"mono.avg.{i}"],
                                          data[f"leaf{i}"].mean(0))
    assert 0 < res[0]["fraction"] < 1


@pytest.mark.parametrize("wire", ["q8", "ada"])
def test_int8_pipeline_equals_flat_quantized(two_proc, wire):
    """The int8 start/finish pipeline, and Adasum buckets issued whole,
    against the flat collective of the same buckets."""
    _, res = two_proc
    for r in range(2):
        for i in range(6):
            _same(res[r][f"{wire}.pipe.{i}"], res[r][f"{wire}.flat.{i}"])
    _same(res[0][f"{wire}.pipe.0"], res[1][f"{wire}.pipe.0"])


@pytest.mark.parametrize("tag,want", [("hook", "mono"),
                                      ("hook_k2", "mono_k2"),
                                      ("pipe", "mono")])
def test_overlapped_steps_equal_monolithic(two_proc, tag, want):
    _, res = two_proc
    for r in range(2):
        for i in range(4):
            _same(res[r][f"step.{tag}.{i}"], res[r][f"step.{want}.{i}"])
            _same(res[r][f"grad.{tag}.{i}"], res[r][f"grad.{want}.{i}"])
    for i in range(4):
        _same(res[0][f"step.{tag}.{i}"], res[1][f"step.{tag}.{i}"])


def test_hooks_issue_during_backward_and_only_on_the_boundary(two_proc):
    """all_reduce calls (one a plain bucket) in the backward and in
    step(), step by step."""
    _, res = two_proc
    shapes = ((8, 16), (16,), (16, 4), (4,))
    n_buckets = len(tov.overlap_schedule([torch.empty(s) for s in shapes],
                                         64))
    n_mono = len(tdev.fused_allreduce_buckets(
        [torch.empty(s) for s in shapes], 64))
    for r in range(2):
        # Without overlap every bucket goes out in step().
        assert (res[r]["issued.mono"] == -1).all()
        assert res[r]["calls.mono"].tolist() == [[0, n_mono]] * 4
        # k = 1: every bucket was issued by a hook, in the backward.
        assert (res[r]["issued.hook"] == n_buckets).all()
        assert res[r]["calls.hook"].tolist() == [[n_buckets, 0]] * 4
        # k = 2: the first pass of a cycle issues nothing.
        assert res[r]["issued.hook_k2"].tolist() == [0, n_buckets] * 2
        assert res[r]["calls.hook_k2"].tolist() == [
            [0, 0], [n_buckets, 0]] * 2
        assert res[r]["calls.mono_k2"].tolist() == [[0, 0], [0, n_mono]] * 2


def test_error_feedback_in_hooks(two_proc):
    """int8 wire with error feedback: the hooks compensate each gradient
    as step() does; the buckets differ (reverse order), so the residuals
    and parameters agree within the wire's error, not bit for bit."""
    _, res = two_proc
    for r in range(2):
        for i in range(4):
            a = res[r][f"step.hook_ef.{i}"]
            b = res[r][f"step.mono_ef.{i}"]
            assert np.abs(a - b).max() <= 0.05 * np.abs(b).max() + 1e-6
            assert np.abs(res[r][f"resid.hook_ef.{i}"]).max() > 0
    for i in range(4):
        _same(res[0][f"step.hook_ef.{i}"], res[1][f"step.hook_ef.{i}"])


def test_segmented_backward_equals_monolithic(two_proc):
    _, res = two_proc
    for r in range(2):
        for i in range(4):
            _same(res[r][f"seg.got.{i}"], res[r][f"seg.want.{i}"])


@pytest.mark.parametrize("tag", ["twice", "zero"])
def test_second_backward_or_zero_grad_before_step_raises(two_proc, tag):
    """Under HVDT_OVERLAP=on a bucket may be in flight once its hooks
    fired: a second gradient for a parameter before step() would be
    dropped, and zero_grad() would free what is being exchanged."""
    _, res = two_proc
    for r in range(2):
        assert res[r][f"raised.{tag}"]
        assert res[r][f"drained.{tag}"]
