"""PyTorch port, ring attention and the 1F1B pipeline under a CUDA-graph
capture (horovod_tpu_torch/parallel/ring_attention.py, pipeline.py),
what a 4-process gloo world on the CPU can show of it.

A capture cannot run here, so ``graphs.capturing`` is patched true
inside ``graphs.collect_replay_hooks``, as ``step_pipeline.donated_step``
opens it.  Ring attention over ``sp = 4`` (causal and not, forward and
backward) and the pipeline over ``pp = 4`` (4 microbatches, forward and
backward) then run as they do eagerly: the same step cases on every
member (each ring step's ``(src, my)`` and the kernel choice), the same
outputs and gradients, bit for bit.  With ``HVDT_TELEMETRY`` and
``HVDT_FLIGHT_RECORDER`` on, the captured call books nothing; one run of
its replay hooks renders the same metrics text and flight events as one
eager call, three runs the same as three eager calls.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 4

_WORKER = r"""
import importlib, json, os, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import graphs
from horovod_tpu_torch.parallel import make_mesh, pipeline_1f1b
from horovod_tpu_torch.telemetry import flight_recorder as tfr
from horovod_tpu_torch.telemetry import instrument as tinst
from horovod_tpu_torch.telemetry import metrics as tmet

rmod = importlib.import_module("horovod_tpu_torch.parallel.ring_attention")
os.environ["HVDT_TELEMETRY"] = "1"
os.environ["HVDT_FLIGHT_RECORDER"] = "1"
hvd.init(device="cpu")
r, n = hvd.rank(), hvd.size()
rng = np.random.default_rng(5)
res = {}


def reset_recorders():
    tmet.reset_default_registry()
    tinst.reset()
    tfr.reset()


def booked():
    events = [[e["op"], e["name"], e["dtype"], e["nbytes"], e["count"],
               e["axis"]] for e in tfr.get_flight_recorder().events()]
    return {"text": tmet.default_registry().render(), "events": events}


cases = []
real_fwd, real_bwd = rmod._forward_step, rmod._backward_step


def spy_fwd(*a, **kw):
    cases.append(["f", kw["src"], kw["my"], kw["use_pallas"]])
    return real_fwd(*a, **kw)


def spy_bwd(*a, **kw):
    cases.append(["b", kw["src"], kw["my"], kw["use_pallas"]])
    return real_bwd(*a, **kw)


rmod._forward_step, rmod._backward_step = spy_fwd, spy_bwd


def compare(tag, fn):
    # One eager call; the same call under a simulated capture, then its
    # replay hooks run once and three times; three eager calls.
    reset_recorders()
    cases.clear()
    want = fn()
    want_cases = list(cases)
    one = booked()
    reset_recorders()
    real = graphs.capturing
    graphs.capturing = lambda: True
    try:
        cases.clear()
        with graphs.collect_replay_hooks() as hooks:
            got = fn()
    finally:
        graphs.capturing = real
    got_cases = list(cases)
    captured = booked()
    for h in hooks:
        h()
    replay1 = booked()
    for _ in range(2):
        for h in hooks:
            h()
    replay3 = booked()
    reset_recorders()
    for _ in range(3):
        fn()
    three = booked()
    res[tag] = np.array(json.dumps({
        "same_values": all(torch.equal(a, b) for a, b in zip(want, got)),
        "cases_eager": want_cases, "cases_captured": got_cases,
        "hooks": len(hooks), "one": one, "captured": captured,
        "replay1": replay1, "replay3": replay3, "three": three}))


# The ring over sp = 4.
mesh = make_mesh(sp=n)
b, l, h, d = 1, 16, 2, 16
qkv = [torch.from_numpy(rng.standard_normal((b, l * n, h, d)).astype(
    np.float32)) for _ in range(3)]
w = torch.from_numpy(rng.standard_normal((b, l, h, d)).astype(np.float32))
mine = [x[:, r * l:(r + 1) * l].contiguous() for x in qkv]
for causal in (True, False):
    def ring():
        q, k, v = (x.clone().requires_grad_() for x in mine)
        out = rmod.ring_attention(q, k, v, group=mesh, causal=causal)
        grads = torch.autograd.grad((out * w).square().sum(), (q, k, v))
        return [out.detach(), *grads]
    compare(f"ring.causal_{causal}", ring)

# The pipeline over pp = 4, 4 microbatches.
mesh = make_mesh(pp=n)
mb = torch.from_numpy(rng.standard_normal((4, 2, 8)).astype(np.float32))
weights = [torch.from_numpy(rng.standard_normal((8, 8)).astype(
    np.float32) / 3) for _ in range(n)]


def pipe():
    wt = weights[r].clone().requires_grad_()
    x = mb.clone().requires_grad_()
    out = pipeline_1f1b(lambda p, a: torch.tanh(a @ p), wt, x, group=mesh)
    gw, gx = torch.autograd.grad(out.square().sum(), (wt, x))
    return [out.detach(), gw, gx]


compare("pipeline", pipe)
np.savez(sys.argv[1], **res)
hvd.shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("graphed_parallel")
    env = dict(os.environ, HVDT_SIZE=str(N),
               HVDT_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for k in ("HVDT_RING_PALLAS", "HVDT_TELEMETRY", "HVDT_FLIGHT_RECORDER",
              "HVDT_TRANSPORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(tmp / f"out{r}.npz")],
        env=dict(env, HVDT_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(N)]
    for p in procs:
        out, _ = p.communicate(timeout=180)
        assert p.returncode == 0, out.decode()[-3000:]
    return [{k: json.loads(str(v)) for k, v in
             np.load(tmp / f"out{r}.npz").items()} for r in range(N)]


@pytest.mark.parametrize("tag", ["ring.causal_True", "ring.causal_False",
                                 "pipeline"])
def test_captured_call_matches_eager(world, tag):
    for r in range(N):
        got = world[r][tag]
        assert got["same_values"], (tag, r)
        assert got["cases_captured"] == got["cases_eager"]
        if tag.startswith("ring"):
            # Every visiting block, forward then backward (under causal a
            # later member's block is a skipped case, still rotated), on
            # the CPU's plain step.
            assert len(got["cases_eager"]) == 2 * N, got["cases_eager"]
            assert [c[1] for c in got["cases_eager"][:N]] == [
                (r - s) % N for s in range(N)]
            assert all(c[2] == r and c[3] is False
                       for c in got["cases_eager"])
        # One hook a ring pass (forward, backward), one a pipeline call.
        assert got["hooks"] == (2 if tag.startswith("ring") else 1)


@pytest.mark.parametrize("tag", ["ring.causal_True", "ring.causal_False",
                                 "pipeline"])
def test_replay_hooks_book_what_eager_calls_book(world, tag):
    for r in range(N):
        got = world[r][tag]
        assert got["one"]["events"], (tag, r)
        assert "hvdt_collectives_total" in got["one"]["text"]
        assert got["captured"]["events"] == []
        assert "hvdt_collectives_total{" not in got["captured"]["text"]
        assert got["replay1"] == got["one"]
        assert got["replay3"] == got["three"]
        ops = {e[0] for e in got["one"]["events"]}
        assert ops == {"ppermute"}, ops
        axis = "pp" if tag == "pipeline" else "sp"
        assert all(e[5] == axis for e in got["one"]["events"])
