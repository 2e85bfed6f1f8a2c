"""PyTorch port: Adasum (horovod_tpu_torch/ops/adasum.py) in 2-, 4- and
3-process gloo worlds, held against the JAX package's host tree
``horovod_tpu.ops.adasum._np_adasum_tree`` (float64) over the gathered
per-rank inputs.  The reference's sharded ``adasum_allreduce`` is not
the yardstick: its own ``TestShardedAdasum::test_matches_host_tree[61]``
fails (ROADMAP, "Reference caveats").

Every entry point: the sharded ``adasum_allreduce`` (odd sizes, bf16),
``device.allreduce(op=Adasum)``, ``fused_allreduce(op=Adasum)`` (one
bucket: the dots span the bucket, as in the reference),
``DistributedOptimizer(op=hvd.Adasum)`` (one SGD step), and the eager
``hvd.allreduce`` / ``grouped_allreduce(op=hvd.Adasum)`` (``host_adasum``:
the gathered vectors' tree in float64).  A 3-process world raises
``ValueError`` from each.

Tolerances: f32 results, 1e-5 of the result's largest magnitude (the
sharded form sums its dots in f32 per shard, then across ranks); the
eager float64 tree, one f32 rounding (1e-6 of the largest); bf16
results, one bf16 rounding of each element (2^-8) plus 1e-5 of the
largest.
"""

import os
import pathlib
import socket
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu.ops.adasum import _np_adasum_tree as ref_tree
from horovod_tpu_torch.ops import adasum as tad

ROOT = pathlib.Path(__file__).resolve().parents[1]

_WORKER = r"""
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import adasum as ad
from horovod_tpu_torch.ops import device as dev

data = np.load(sys.argv[1])
hvd.init(device="cpu")
r = hvd.rank()
T = lambda k: torch.from_numpy(data[k][r].copy())
res = {}

def bf(k):
    return torch.from_numpy(data[k][r].copy()).to(torch.bfloat16)

calls = {
    "sharded.odd": lambda: ad.adasum_allreduce(T("odd")),
    "sharded.mat": lambda: ad.adasum_allreduce(T("mat")),
    "sharded.bf16": lambda: ad.adasum_allreduce(bf("odd")).float(),
    "device": lambda: dev.allreduce(T("mat"), op=hvd.Adasum),
    "fused": lambda: torch.cat([t.reshape(-1) for t in dev.fused_allreduce(
        [T("odd"), T("mat")], op=hvd.Adasum, threshold_bytes=1 << 20)]),
    "eager": lambda: torch.as_tensor(hvd.allreduce(T("odd"), op=hvd.Adasum,
                                                   name="ada")),
    "eager.grouped": lambda: torch.cat([torch.as_tensor(t).reshape(-1)
        for t in hvd.grouped_allreduce([T("odd"), T("mat")],
                                       op=hvd.Adasum, name="gada")]),
}

def opt_step():
    p = [T("p0").requires_grad_(), T("p1").requires_grad_()]
    opt = hvd.DistributedOptimizer(torch.optim.SGD(p, lr=1.0),
                                   op=hvd.Adasum, threshold_bytes=1 << 20)
    p[0].grad, p[1].grad = T("odd"), T("mat")
    opt.step()
    return torch.cat([x.detach().reshape(-1) for x in p])

calls["optimizer"] = opt_step
for name, fn in calls.items():
    try:
        res[name] = fn().numpy()
    except ValueError as e:
        res[name + ".error"] = np.array(str(e))
np.savez(sys.argv[2], **res)
hvd.shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.1, 10.0, (n, 1))
    odd = (rng.standard_normal((n, 37)) * scale).astype(np.float32)
    return {"odd": odd,
            "mat": (rng.standard_normal((n, 3, 5)) * scale[:, :, None]
                    ).astype(np.float32),
            "p0": rng.standard_normal((1, 37)).repeat(n, 0).astype(
                np.float32),
            "p1": rng.standard_normal((1, 3, 5)).repeat(n, 0).astype(
                np.float32)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{size: (inputs, per-rank results)} for worlds of 2, 4 and 3
    processes, run at once."""
    tmp = tmp_path_factory.mktemp("adasum")
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for k in ("HVDT_OVERLAP", "HVDT_TRANSPORT", "HVDT_FUSION_THRESHOLD",
              "HVDT_COMPRESSION", "HVDT_QUANT"):
        env.pop(k, None)
    runs, out = {}, {}
    for n in (2, 4, 3):
        data = _inputs(n, 50 + n)
        np.savez(tmp / f"in{n}.npz", **data)
        port = _free_port()
        runs[n] = (data, [subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(tmp / f"in{n}.npz"),
             str(tmp / f"out{n}_{r}.npz")],
            env=dict(env, HVDT_SIZE=str(n), HVDT_RANK=str(r),
                     HVDT_COORDINATOR_ADDR=f"127.0.0.1:{port}"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(n)])
    for n, (data, procs) in runs.items():
        for p in procs:
            log, _ = p.communicate(timeout=240)
            assert p.returncode == 0, log.decode()[-3000:]
        out[n] = (data, [dict(np.load(tmp / f"out{n}_{r}.npz"))
                         for r in range(n)])
    return out


def _tree(data, *keys, dtype=np.float32):
    vecs = [np.concatenate([data[k][r].astype(dtype).astype(np.float64)
                            .reshape(-1) for k in keys])
            for r in range(len(data[keys[0]]))]
    return ref_tree(vecs)


def _close(got, want, rel):
    top = np.abs(want).max()
    np.testing.assert_allclose(got.reshape(-1), want, rtol=0, atol=rel * top)


_CASES = {"sharded.odd": (("odd",), 1e-5), "sharded.mat": (("mat",), 1e-5),
          "device": (("mat",), 1e-5), "fused": (("odd", "mat"), 1e-5),
          "eager": (("odd",), 1e-6), "eager.grouped": (("odd", "mat"), 1e-6)}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", sorted(_CASES))
def test_matches_host_tree(worlds, n, name):
    data, res = worlds[n]
    keys, rel = _CASES[name]
    want = _tree(data, *keys)
    for r in range(n):
        _close(res[r][name], want, rel)
    for r in range(1, n):          # every rank holds the same answer
        np.testing.assert_array_equal(res[r][name], res[0][name])


@pytest.mark.parametrize("n", [2, 4])
def test_bf16(worlds, n):
    data, res = worlds[n]
    want = _tree(data, "odd", dtype=ml_dtypes.bfloat16)
    top = np.abs(want).max()
    for r in range(n):
        got = res[r]["sharded.bf16"]
        assert (np.abs(got - want) <= 2.0 ** -8 * np.abs(want)
                + 1e-5 * top).all()


@pytest.mark.parametrize("n", [2, 4])
def test_distributed_optimizer_step(worlds, n):
    data, res = worlds[n]
    g = _tree(data, "odd", "mat")
    p = np.concatenate([data["p0"][0].reshape(-1), data["p1"][0].reshape(-1)])
    for r in range(n):
        _close(res[r]["optimizer"], p - g, 1e-5)


@pytest.mark.parametrize("name", sorted(_CASES) + ["sharded.bf16",
                                                   "optimizer"])
def test_non_power_of_two_world_raises(worlds, name):
    _, res = worlds[3]
    for r in range(3):
        assert name not in res[r]
        assert "power-of-2" in str(res[r][name + ".error"])


def test_pair_and_tree_match_reference():
    from horovod_tpu.ops import adasum as jad

    rng = np.random.default_rng(9)
    vecs = [rng.standard_normal(11) for _ in range(8)]
    np.testing.assert_array_equal(tad._np_adasum_tree(vecs),
                                  jad._np_adasum_tree(vecs))
    # The tensor tree stays in float64; the reference's scale factors
    # come out float32 under numpy 2 (a Python float plus the np.float32
    # eps), so the two differ by about one f32 rounding of a scale.
    got = tad._tree([torch.from_numpy(v) for v in vecs]).numpy()
    want = jad._np_adasum_tree(vecs)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    a, b = vecs[0], vecs[1]
    np.testing.assert_array_equal(
        tad.adasum_pair(a, b, a @ b, a @ a, b @ b),
        jad.adasum_pair(a, b, a @ b, a @ a, b @ b))
    with pytest.raises(ValueError, match="power-of-2"):
        tad._np_adasum_tree(vecs[:3])
