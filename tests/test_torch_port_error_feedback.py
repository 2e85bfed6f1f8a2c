"""PyTorch port, error feedback on a parameter without a gradient
(horovod_tpu_torch/quant/error_feedback.py) held against the JAX
package's ``with_error_feedback`` on the same numpy inputs.

A JAX gradient is never missing, so the reference compensates every
leaf, ``e = g + r``.  The port's rank that has no gradient for ``p``
compensates it as a zero gradient: it sends ``qdq(0 + r)`` in the slot
the wrapped optimizer would zero-fill and keeps ``r = e - qdq(e)``.

Input: two f32 ``[256]`` parameters ``p``, ``q`` at zero under
``with_error_feedback(DistributedOptimizer(SGD(lr=1.0),
compression=int8), block_size=256)``.  Step 1 gives both the same
gradient (per rank); step 2 gives ``q`` a zero gradient and ``p`` none
(in the two-rank world only rank 1 lacks it, rank 0 gives zeros).  So
``p == q`` in every byte, and each residual equals the reference's
error feedback (around ``optax.identity``, op by op) on the gradients
``[g, 0]`` within 1e-7.  In a world of one the parameters equal minus
the reference's summed updates within 1e-7.  Each case runs with and
without ``HVDT_OVERLAP=on`` (the hooked path: the hook never fires for
the missing gradient, so ``compensate()`` covers it before the inner
optimizer zero-fills the slot).
"""

import os
import pathlib
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu import quant as jquant
import horovod_tpu_torch as hvd

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 256


def _grad(rank: int) -> np.ndarray:
    return np.random.default_rng(rank).standard_normal(N).astype(np.float32)


def _reference(g: np.ndarray):
    """The reference's error feedback over two steps, ``[g, 0]`` on both
    leaves: (the summed updates, the residual after step 2)."""
    tx = jquant.with_error_feedback(optax.identity(), block_size=N)
    z = jnp.zeros(N, jnp.float32)
    state = tx.init({"p": z, "q": z})
    total = np.zeros(N, np.float32)
    for step_g in (jnp.asarray(g), z):
        u, state = tx.update({"p": step_g, "q": step_g}, state)
        total = total + np.asarray(u["p"])
    return total, np.asarray(state.residual["p"])


# The port's two steps; the same code runs in the pytest process (world
# of one) and in each rank of the gloo world.
_RUN = r"""
def run(hvd, torch, np, g, drop_p):
    p = torch.zeros(256, requires_grad=True)
    q = torch.zeros(256, requires_grad=True)
    opt = hvd.quant.with_error_feedback(
        hvd.DistributedOptimizer(torch.optim.SGD([p, q], lr=1.0),
                                 compression=hvd.Compression.int8),
        block_size=256)
    gt = torch.from_numpy(g)
    for step in range(2):
        opt.zero_grad()
        if step == 0:
            loss = (p * gt).sum() + (q * gt).sum()
        elif drop_p:
            loss = (q * 0.0).sum()
        else:
            loss = (p * 0.0).sum() + (q * 0.0).sum()
        loss.backward()
        assert (p.grad is None) == (step == 1 and drop_p)
        opt.step()
    if getattr(opt.optimizer, "_hooked", None) is not None:
        opt.optimizer._hooked.remove()
    return {"p": p.detach().numpy().copy(), "q": q.detach().numpy().copy(),
            "rp": opt.residual[p].numpy().copy(),
            "rq": opt.residual[q].numpy().copy()}
"""

_WORKER = _RUN + r"""
import os, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd

hvd.init(device="cpu")
r = hvd.rank()
g = np.random.default_rng(r).standard_normal(256).astype(np.float32)
out = {}
for overlap in ("off", "on"):
    os.environ["HVDT_OVERLAP"] = overlap
    for k, v in run(hvd, torch, np, g, drop_p=(r == 1)).items():
        out[f"{overlap}.{k}"] = v
np.savez(sys.argv[1], **out)
hvd.shutdown()
"""


def _port_run(g, drop_p):
    scope = {}
    exec(_RUN, scope)
    return scope["run"](hvd, torch, np, g, drop_p)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ef2")
    env = dict(os.environ, HVDT_SIZE="2",
               HVDT_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for k in ("HVDT_QUANT_KERNELS", "HVDT_COMPRESSION", "HVDT_QUANT",
              "HVDT_QUANT_BLOCK", "HVDT_FUSION_THRESHOLD", "HVDT_ZERO"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(tmp / f"out{r}.npz")],
        env=dict(env, HVDT_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out.decode()[-3000:]
    return [dict(np.load(tmp / f"out{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("overlap", ["off", "on"])
def test_missing_gradient_world_of_one(overlap, monkeypatch):
    for k in ("HVDT_QUANT_KERNELS", "HVDT_COMPRESSION", "HVDT_QUANT",
              "HVDT_ZERO"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HVDT_OVERLAP", overlap)
    hvd.init(device="cpu")
    try:
        g = _grad(0)
        got = _port_run(g, drop_p=True)
    finally:
        hvd.shutdown()
    total, residual = _reference(g)
    np.testing.assert_array_equal(got["p"], got["q"])
    np.testing.assert_array_equal(got["rp"], got["rq"])
    np.testing.assert_allclose(got["rp"], residual, rtol=0, atol=1e-7)
    np.testing.assert_allclose(got["p"], -total, rtol=0, atol=1e-7)
    # The fault: p's residual stayed at its step-1 value, ~1e-2.
    assert np.abs(got["rp"]).max() < 1e-3


@pytest.mark.parametrize("overlap", ["off", "on"])
@pytest.mark.parametrize("rank", [0, 1])
def test_missing_gradient_two_ranks(two_ranks, rank, overlap):
    got = {k.split(".", 1)[1]: v for k, v in two_ranks[rank].items()
           if k.startswith(overlap + ".")}
    _, residual = _reference(_grad(rank))
    np.testing.assert_array_equal(got["p"], got["q"])
    np.testing.assert_array_equal(got["rp"], got["rq"])
    np.testing.assert_allclose(got["rp"], residual, rtol=0, atol=1e-7)
    other = {k.split(".", 1)[1]: v for k, v in two_ranks[1 - rank].items()
             if k.startswith(overlap + ".")}
    np.testing.assert_array_equal(got["p"], other["p"])
