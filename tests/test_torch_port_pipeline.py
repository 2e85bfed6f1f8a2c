"""PyTorch port, the 1F1B pipeline (horovod_tpu_torch/parallel/
pipeline.py) held against the JAX package's parallel/pipeline.py on the
same numpy inputs.

Two gloo worlds, of 2 and of 4 processes, run the port's
``pipeline_1f1b`` over the world (``pp`` = 2 and 4); the reference runs
under ``jax.shard_map`` over as many CPU devices.  Cases, at each ``pp``:

* ``seq`` — the reference's ``test_matches_sequential`` inputs (m 6,
  microbatch 2, dim 8, ``tanh(x @ w)``): the output against the
  reference's and against the stages run one after another;
* ``diff`` — the reference's ``test_differentiable`` inputs (m 4,
  microbatch 2, dim 4, ``x @ w`` with w = 0.5 I);
* ``nobcast`` — ``seq``'s inputs with ``broadcast_out=False``: the last
  stage's outputs, zeros on the others.

Each member's loss is ``sum(out ** 2)`` of its output.  With the
broadcast every member computes the same loss, and the reference's
gradient is ``jax.grad`` of it (the output is replicated over ``pp``);
each member's backward must give its own stage's slice of that
gradient, and every member the whole gradient of the microbatches.
Without the broadcast the reference's gradient is that of the sum of the
members' losses.  f32, within 1e-5 (rtol and atol).
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

from horovod_tpu.parallel import pipeline as jpipe
from horovod_tpu_torch.parallel import pipeline as tpipe

ROOT = pathlib.Path(__file__).resolve().parents[1]
_TOL = dict(rtol=1e-5, atol=1e-5)
_PP = (2, 4)
# name -> (microbatches, microbatch rows, dim, stage body, broadcast_out)
_CASES = {"seq": (6, 2, 8, "tanh", True), "diff": (4, 2, 4, "linear", True),
          "nobcast": (6, 2, 8, "tanh", False)}


def _inputs(p, name):
    m, mb, dim, body, _ = _CASES[name]
    if body == "linear":
        ws = np.stack([np.eye(dim, dtype=np.float32) * 0.5] * p)
        xs = np.ones((m, mb, dim), np.float32)
    else:
        rng = np.random.default_rng(p)
        ws = (rng.standard_normal((p, dim, dim)) * 0.3).astype(np.float32)
        xs = rng.standard_normal((m, mb, dim)).astype(np.float32)
    return ws, xs


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_WORKER = r"""
import json, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel import pipeline_1f1b

hvd.init(device="cpu")
r = hvd.rank()
data = np.load(sys.argv[1])
res = {}
for name, (m, mb, dim, body, bcast) in json.loads(sys.argv[3]).items():
    w = torch.tensor(data[name + ".ws"][r], requires_grad=True)
    xs = torch.tensor(data[name + ".xs"], requires_grad=True)
    if body == "linear":
        fn = lambda p, x: x @ p["w"]
    else:
        fn = lambda p, x: torch.tanh(x @ p["w"])
    out = pipeline_1f1b(fn, {"w": w}, xs, broadcast_out=bcast)
    (out ** 2).sum().backward()
    res[name + ".out"] = out.detach().numpy()
    res[name + ".dw"] = w.grad.numpy()
    res[name + ".dxs"] = xs.grad.numpy()
np.savez(sys.argv[2], **res)
hvd.shutdown()
"""


def _stage_jax(body):
    if body == "linear":
        return lambda w, x: x @ w[0]
    return lambda w, x: jnp.tanh(x @ w[0])


def _jax_case(p, name, ws, xs):
    """(per-member outputs [p, m, mb, dim], dws [p, ...], dxs)."""
    _, _, _, body, bcast = _CASES[name]
    mesh = Mesh(np.asarray(jax.devices()[:p]), ("pp",))

    def run(ws, xs):
        def local(w, x):
            out = jpipe.pipeline_1f1b(_stage_jax(body), w, x, axis="pp",
                                      broadcast_out=bcast)
            return out[None]
        return jax.shard_map(local, mesh=mesh, in_specs=(P("pp"), P()),
                             out_specs=P("pp"), check_vma=False)(ws, xs)

    def loss(ws, xs):
        outs = run(ws, xs)
        # Replicated output: every member's loss is the same one.
        return (outs[-1] ** 2).sum() if bcast else (outs ** 2).sum()

    outs = jax.jit(run)(jnp.asarray(ws), jnp.asarray(xs))
    dws, dxs = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(ws),
                                                       jnp.asarray(xs))
    return np.asarray(outs), np.asarray(dws), np.asarray(dxs)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    procs, want = {}, {}
    for p in _PP:
        inputs = {n: _inputs(p, n) for n in _CASES}
        np.savez(tmp / f"in{p}.npz",
                 **{f"{n}.ws": ws for n, (ws, _) in inputs.items()},
                 **{f"{n}.xs": xs for n, (_, xs) in inputs.items()})
        env = dict(os.environ, HVDT_SIZE=str(p),
                   HVDT_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
                   PYTHONPATH=str(ROOT) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs[p] = [subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(tmp / f"in{p}.npz"),
             str(tmp / f"out{p}_{r}.npz"), json.dumps(_CASES)],
            env=dict(env, HVDT_RANK=str(r)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for r in range(p)]
        want[p] = {n: (inputs[n], _jax_case(p, n, *inputs[n]))
                   for n in _CASES}
    got = {}
    for p in _PP:
        res = []
        for r, proc in enumerate(procs[p]):
            log, _ = proc.communicate(timeout=240)
            assert proc.returncode == 0, log.decode()[-3000:]
            res.append(dict(np.load(tmp / f"out{p}_{r}.npz")))
        got[p] = res
    return got, want


@pytest.mark.parametrize("p", _PP)
@pytest.mark.parametrize("name", list(_CASES))
def test_matches_reference(worlds, p, name):
    got, want = worlds
    (ws, xs), (outs, dws, dxs) = want[p][name]
    for r in range(p):
        np.testing.assert_allclose(got[p][r][name + ".out"], outs[r],
                                   err_msg=f"out rank {r}", **_TOL)
        np.testing.assert_allclose(got[p][r][name + ".dw"], dws[r],
                                   err_msg=f"dw rank {r}", **_TOL)
        # The microbatches' gradient reaches every member.
        np.testing.assert_allclose(got[p][r][name + ".dxs"], dxs,
                                   err_msg=f"dxs rank {r}", **_TOL)


@pytest.mark.parametrize("p", _PP)
def test_matches_sequential(worlds, p):
    """The reference's test: the stages run one after another."""
    got, want = worlds
    (ws, xs), _ = want[p]["seq"]
    seq = xs
    for i in range(p):
        seq = np.tanh(seq @ ws[i])
    for r in range(p):
        np.testing.assert_allclose(got[p][r]["seq.out"], seq, **_TOL)
    last = got[p][p - 1]["nobcast.out"]
    np.testing.assert_allclose(last, seq, **_TOL)
    for r in range(p - 1):
        assert not got[p][r]["nobcast.out"].any()


@pytest.mark.parametrize("p", _PP)
def test_differentiable(worlds, p):
    """The reference's test: every stage's parameters get a gradient."""
    got, _ = worlds
    for r in range(p):
        dw = got[p][r]["diff.dw"]
        assert np.isfinite(dw).all() and np.abs(dw).sum() > 0


def test_bubble_fraction_and_mfu(monkeypatch):
    for p, m in [(1, 1), (2, 6), (4, 4), (4, 1), (8, 32)]:
        assert tpipe.bubble_fraction(p, m) == jpipe.bubble_fraction(p, m)
    assert tpipe.bubble_fraction(4, 4) == 3 / 7
    for bad in [(0, 1), (1, 0)]:
        with pytest.raises(ValueError, match="need p >= 1"):
            tpipe.bubble_fraction(*bad)
    monkeypatch.delenv("HVDT_PEAK_FLOPS", raising=False)
    assert tpipe.report_pipeline_mfu(1e9, 0.01) == pytest.approx(0.1)
    assert tpipe.NOMINAL_SIM_PEAK_FLOPS == 1e12
    monkeypatch.setenv("HVDT_PEAK_FLOPS", "2e12")
    assert tpipe.report_pipeline_mfu(1e9, 0.01) == pytest.approx(0.05)
    assert tpipe.report_pipeline_mfu(1e9, 0.01, 1e11) == pytest.approx(1.0)


def test_group_of_one_runs_the_stage():
    """No process group: one stage, the microbatches through it."""
    import torch

    w = torch.randn(4, 4, requires_grad=True)
    xs = torch.randn(3, 2, 4, requires_grad=True)
    out = tpipe.pipeline_1f1b(lambda p, x: x @ p, w, xs)
    torch.testing.assert_close(out, xs @ w)
    out.sum().backward()
    torch.testing.assert_close(w.grad, (xs.reshape(-1, 4).t()
                                        @ torch.ones(6, 4)))
    with pytest.raises(ValueError, match="keep its input's shape"):
        tpipe.pipeline_1f1b(lambda p, x: x[..., :2], w, xs)
