"""PyTorch port: ``interop.torch_sync_batch_norm.SyncBatchNorm``.

The JAX package's ``tests/test_torch_sync_bn.py`` cases run against both
packages in a world of one (plain ``_BatchNorm``: outputs within 1e-6 of
``nn.BatchNorm1d``, picklable, ``momentum=None`` as a cumulative
average, half and bf16 inputs keeping their dtype).  A two-process gloo
world (started once) holds the port to plain BatchNorm over the whole
batch, computed with numpy in float64 from the formula: outputs, input
gradients and running statistics, for equal batches (4 + 4 rows, the
reference test's case) and ragged ones (5 + 3 rows, ``momentum=None``
over two steps).  The reference's own ragged test fails (its running
variance is off), so the port is held to the formula, not to it.
Tolerance: 1e-5 relative and absolute in float32 (the statistics are
summed in float64 on the device, the mean and variance formed in
float32); bf16 runs are held to their dtype only.
"""

import io
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
from horovod_tpu.interop import torch_sync_batch_norm as jsbn
import horovod_tpu_torch as hvd
from horovod_tpu_torch.interop import torch_sync_batch_norm as tsbn

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def worlds():
    jhvd.init()
    hvd.init(device="cpu")
    yield
    hvd.shutdown()
    jhvd.shutdown()


@pytest.fixture(params=["reference", "port"])
def SBN(request, worlds):
    return jsbn.SyncBatchNorm if request.param == "reference" \
        else tsbn.SyncBatchNorm


def test_single_process_matches_plain_bn(SBN):
    torch.manual_seed(0)
    x = torch.randn(8, 4, 5, requires_grad=True)
    np.testing.assert_allclose(SBN(4)(x).detach().numpy(),
                               torch.nn.BatchNorm1d(4)(x).detach().numpy(),
                               atol=1e-6)


def test_module_is_picklable_and_exported(SBN):
    import horovod_tpu_torch.interop.torch as tit

    assert tit.SyncBatchNorm is tsbn.SyncBatchNorm
    assert tsbn.SyncBatchNorm is not hvd.SyncBatchNorm
    m = SBN(3)
    assert isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
    buf = io.BytesIO()
    torch.save(m, buf)
    buf.seek(0)
    assert isinstance(torch.load(buf, weights_only=False), SBN)


def test_momentum_none_uses_cumulative_average(SBN):
    m = SBN(2, momentum=None)
    ref = torch.nn.BatchNorm1d(2, momentum=None)
    torch.manual_seed(0)
    for _ in range(3):
        x = torch.randn(6, 2)
        m(x)
        ref(x)
    np.testing.assert_allclose(m.running_mean.numpy(),
                               ref.running_mean.numpy(), atol=1e-6)


@pytest.mark.parametrize("dt", [torch.float16, torch.bfloat16])
def test_half_input_keeps_dtype(SBN, dt):
    sbn = SBN(3).to(dt)
    sbn.train()
    x = torch.randn(4, 3, dtype=dt, requires_grad=True)
    out = sbn(x)
    assert out.dtype == dt
    out.sum().backward()
    assert x.grad is not None and x.grad.dtype == dt


# ---- two processes ----------------------------------------------------------

_WORKER = r"""
import json, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.interop.torch_sync_batch_norm import SyncBatchNorm

hvd.init(device="cpu")
r = hvd.rank()
full = np.load(sys.argv[2])
out = {}
for case, rows, momentum, steps in (("equal", (4, 4), 0.1, 1),
                                    ("ragged", (5, 3), None, 2)):
    lo = sum(rows[:r])
    local = torch.from_numpy(full[lo:lo + rows[r]].copy()).requires_grad_()
    wgt = torch.arange(full.size, dtype=torch.float32).reshape(
        full.shape)[lo:lo + rows[r]] / full.size
    sbn = SyncBatchNorm(3, momentum=momentum)
    with torch.no_grad():
        sbn.weight.copy_(torch.tensor([1.5, 0.5, -1.0]))
        sbn.bias.copy_(torch.tensor([0.1, -0.2, 0.3]))
    for _ in range(steps):
        local.grad = None
        y = sbn(local)
        (y * wgt).sum().backward()
    out[case] = {"out": y.detach().tolist(), "dx": local.grad.tolist(),
                 "rm": sbn.running_mean.tolist(),
                 "rv": sbn.running_var.tolist(),
                 "dw": sbn.weight.grad.tolist()}
# bf16 keeps its dtype across ranks
xb = torch.from_numpy(full[4 * r:4 * r + 4].copy()).to(torch.bfloat16)
xb.requires_grad_()
yb = SyncBatchNorm(3).to(torch.bfloat16)(xb)
yb.float().sum().backward()
out["bf16"] = [str(yb.dtype), str(xb.grad.dtype)]
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
hvd.shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("sync_bn2")
    full = np.random.default_rng(7).standard_normal((8, 3, 4)).astype(
        np.float32)
    np.save(out / "full.npy", full)
    env = dict(os.environ, HVDT_SIZE="2",
               HVDT_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
               HVDT_CONTROL_PLANE_TIMEOUT_S="60",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(out / f"r{r}.json"),
         str(out / "full.npy")],
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
    return full, [json.loads((out / f"r{r}.json").read_text())
                  for r in range(2)]


def _numpy_bn(full, momentum, steps, eps=1e-5):
    """Plain training-mode BatchNorm over the whole batch in float64:
    output, input gradient of sum(y * wgt), weight gradient, running
    mean and (unbiased) running variance after ``steps`` forwards."""
    x = full.astype(np.float64)
    w = np.array([1.5, 0.5, -1.0])[None, :, None]
    b = np.array([0.1, -0.2, 0.3])[None, :, None]
    n = x.shape[0] * x.shape[2]
    mean = x.mean(axis=(0, 2), keepdims=True)
    xmu = x - mean
    var = (xmu ** 2).mean(axis=(0, 2), keepdims=True)
    inv = 1.0 / np.sqrt(var + eps)
    y = xmu * inv * w + b
    dy = np.arange(full.size, dtype=np.float64).reshape(full.shape) \
        / full.size
    dx = w * inv * (dy - dy.mean(axis=(0, 2), keepdims=True)
                    - xmu * inv ** 2 * (dy * xmu).mean(axis=(0, 2),
                                                       keepdims=True))
    dw = (dy * xmu * inv).sum(axis=(0, 2)) * steps
    rm, rv = np.zeros(3), np.ones(3)
    for t in range(1, steps + 1):
        m = 1.0 / t if momentum is None else momentum
        rm = (1 - m) * rm + m * mean.ravel()
        rv = (1 - m) * rv + m * var.ravel() * n / (n - 1)
    return {"out": y, "dx": dx, "dw": dw, "rm": rm, "rv": rv}


@pytest.mark.parametrize("case,rows,momentum,steps", [
    ("equal", (4, 4), 0.1, 1), ("ragged", (5, 3), None, 2)])
def test_two_processes_match_bn_on_the_whole_batch(two_ranks, case, rows,
                                                   momentum, steps):
    full, res = two_ranks
    want = _numpy_bn(full, momentum, steps)
    dw = 0.0
    for r in range(2):
        got = res[r][case]
        lo = sum(rows[:r])
        sl = slice(lo, lo + rows[r])
        np.testing.assert_allclose(got["out"], want["out"][sl], **TOL)
        np.testing.assert_allclose(got["dx"], want["dx"][sl], **TOL)
        np.testing.assert_allclose(got["rm"], want["rm"], **TOL)
        np.testing.assert_allclose(got["rv"], want["rv"], **TOL)
        dw = dw + np.asarray(got["dw"])
    # weight gradients stay local: their sum over ranks is the global one
    np.testing.assert_allclose(dw, want["dw"], **TOL)


def test_two_processes_bf16_keeps_dtype(two_ranks):
    for r in range(2):
        assert two_ranks[1][r]["bf16"] == ["torch.bfloat16"] * 2
