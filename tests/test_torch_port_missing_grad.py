"""PyTorch port: ranks that differ in which parameters have a gradient.

Two gloo processes hold parameters ``a`` (4), ``b`` (3) and ``c`` (5),
all ones, under SGD with lr 1.  The loss is ``(r+1)·(sum a + sum c)``,
plus ``10·sum b`` on rank 0 only, so rank 1 has no gradient for ``b``.
The reference (``horovod_tpu/interop/torch_optimizer.py``, ``_Hooks.
synchronize``) enqueues every optimized parameter on every rank, with
zeros where a rank has no gradient; so on both ranks the averaged
gradients are 1.5 for ``a`` and ``c`` and 5 for ``b``, and one step
gives ``a = c = -0.5`` and ``b = -4``, exactly.  Every exchange path of
the port is held to that: the default fused exchange,
``backward_passes_per_step=2``, ``HVDT_OVERLAP=on``, ZeRO ``grads``,
``states`` and ``params`` (each also under ``HVDT_OVERLAP=on``) and the
interop optimizer.  A last case gives no rank a gradient for ``b``:
under SGD with momentum 0.9 and weight decay 0.1 its two zero-filled
steps are held to numpy's.
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

_WORKER = r"""
import json, os, sys
import torch
import horovod_tpu_torch as hvd
import horovod_tpu_torch.interop.torch as ihvd

hvd.init(device="cpu")
r = hvd.rank()
out = {}

def params():
    return [torch.ones(n, requires_grad=True) for n in (4, 3, 5)]

def backward(ps, b_ranks=(0,)):
    a, b, c = ps
    loss = (r + 1) * (a.sum() + c.sum())
    if r in b_ranks:
        loss = loss + 10 * b.sum()
    loss.backward()

def build(mode, ps):
    zero = {"grads": "grads", "states": "states", "params": "params"}
    stage = zero.get(mode.replace("_overlap", ""))
    if mode == "interop":
        return ihvd.DistributedOptimizer(
            torch.optim.SGD(ps, lr=1.0),
            named_parameters=[(n, p) for n, p in zip("abc", ps)])
    if stage in ("states", "params"):
        return hvd.DistributedOptimizer(hvd.fused_sgd(ps, 1.0), zero=stage)
    return hvd.DistributedOptimizer(
        torch.optim.SGD(ps, lr=1.0), zero=stage,
        backward_passes_per_step=2 if mode == "k2" else 1)

for mode in ("default", "k2", "overlap", "grads", "states", "params",
             "grads_overlap", "states_overlap", "params_overlap",
             "interop"):
    if mode.endswith("overlap"):
        os.environ["HVDT_OVERLAP"] = "on"
    try:
        ps = params()
        opt = build(mode, ps)
        for _ in range(2 if mode == "k2" else 1):
            opt.zero_grad()
            backward(ps)
            opt.step()
        if hasattr(opt, "gather_params"):
            opt.gather_params()
        out[mode] = [p.detach().tolist() for p in ps]
    finally:
        os.environ.pop("HVDT_OVERLAP", None)
        hook = getattr(opt, "_hooked", None)
        if hook is not None:
            hook.remove()

# No rank has a gradient for b: two zero-filled steps of SGD with
# momentum and weight decay.
for mode in ("none", "none_interop"):
    ps = params()
    sgd = torch.optim.SGD(ps, lr=1.0, momentum=0.9, weight_decay=0.1)
    opt = (ihvd.DistributedOptimizer(
               sgd, named_parameters=[(n, p) for n, p in zip("abc", ps)])
           if mode == "none_interop" else hvd.DistributedOptimizer(sgd))
    for _ in range(2):
        opt.zero_grad()
        backward(ps, b_ranks=())
        opt.step()
    out[mode] = [p.detach().tolist() for p in ps]

with open(sys.argv[1], "w") as f:
    json.dump(out, f)
hvd.shutdown()
"""

MODES = ("default", "k2", "overlap", "grads", "states", "params",
         "grads_overlap", "states_overlap", "params_overlap", "interop")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("missing_grad")
    env = dict(os.environ, HVDT_SIZE="2",
               HVDT_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
               HVDT_CONTROL_PLANE_TIMEOUT_S="60",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for k in ("HVDT_OVERLAP", "HVDT_ZERO", "HVDT_COMPRESSION", "HVDT_QUANT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(out / f"r{r}.json")],
        env=dict(env, HVDT_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
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
    return [json.loads((out / f"r{r}.json").read_text()) for r in range(2)]


@pytest.mark.parametrize("mode", MODES)
def test_missing_gradient_is_zero_filled(world, mode):
    for rank in range(2):
        a, b, c = world[rank][mode]
        assert a == [-0.5] * 4, (rank, a)
        assert b == [-4.0] * 3, (rank, b)
        assert c == [-0.5] * 5, (rank, c)


def _numpy_sgd(grad, steps=2, lr=1.0, momentum=0.9, wd=0.1):
    """torch.optim.SGD's update (weight decay folded into the gradient,
    momentum buffer seeded with the first gradient) in float32."""
    p = np.ones_like(grad, dtype=np.float32)
    buf = None
    for _ in range(steps):
        g = (grad + np.float32(wd) * p).astype(np.float32)
        buf = g if buf is None else (np.float32(momentum) * buf + g)
        p = (p - np.float32(lr) * buf).astype(np.float32)
    return p


@pytest.mark.parametrize("mode", ["none", "none_interop"])
def test_gradient_missing_on_every_rank_steps_as_zeros(world, mode):
    want = {"a": _numpy_sgd(np.full(4, 1.5, np.float32)),
            "b": _numpy_sgd(np.zeros(3, np.float32)),
            "c": _numpy_sgd(np.full(5, 1.5, np.float32))}
    for rank in range(2):
        got = dict(zip("abc", world[rank][mode]))
        for name in "abc":
            np.testing.assert_allclose(got[name], want[name], rtol=1e-6,
                                       err_msg=f"rank {rank} {name}")
        assert got["b"][0] != 1.0        # the zero gradient stepped b
