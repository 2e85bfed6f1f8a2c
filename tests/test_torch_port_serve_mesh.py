"""PyTorch port, ``InferenceEngine(mesh=)`` in gloo worlds of 4 against the
one-process engine, and its batch split against the JAX package's.

Every member of a ``DeviceMesh`` calls ``infer`` on the same batch; a
bucket that the data axes divide is split over them (each member runs
its rows, then the rows are all-gathered), any other is run whole on
every member.  On dp 4 and on dp 2 x tp 2 (tp never splits the batch),
the MLP (6-16-3) and a 1-layer transformer (d 64, seq 128, f32,
``HVDT_FLASH_SMALLSEQ=on``: #12's plain version) answer on every member
with the one-process engine's outputs (within 1e-5), at sizes that pick
a replicated bucket, split buckets and a chunk past the top bucket.  The
split decision (``_batch_sharding``) equals the reference's
``PartitionSpec`` on a JAX mesh of the same shape.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from horovod_tpu.models import mlp as jmlp
from horovod_tpu.serve import InferenceEngine as JEngine
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.models.mlp import mlp_apply, mlp_init
from horovod_tpu_torch.serve import InferenceEngine

ROOT = Path(__file__).resolve().parents[1]
SIZES = (6, 16, 3)
BUCKETS = (2, 4, 8)
ROWS = (1, 3, 7, 11)
MESHES = {"dp4": {"dp": 4}, "dp2_tp2": {"dp": 2, "tp": 2}}
_TKW = dict(vocab=64, layers=1, d_model=64, heads=4, kv_heads=4, d_ff=128,
            max_seq=128)

_WORKER = r"""
import json, os, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.models.mlp import mlp_apply, mlp_init
from horovod_tpu_torch.parallel import make_mesh
from horovod_tpu_torch.serve import InferenceEngine

meshes, buckets, rows, tkw = (json.loads(a) for a in sys.argv[2:6])
hvd.init(device="cpu")
res = {}
cfg = tt.TransformerConfig(dtype=torch.float32, **tkw)
for name, sizes in meshes.items():
    mesh = make_mesh(**sizes)
    eng = InferenceEngine(mlp_apply, mlp_init(0, (6, 16, 3), device="cpu"),
                          buckets=buckets, mesh=mesh)
    for n in rows:
        x = np.random.default_rng(n).normal(size=(n, 6)).astype(np.float32)
        res[f"{name}.mlp.{n}"] = eng.infer(x)
    res[f"{name}.compiles"] = np.array(eng.compile_count())
    res[f"{name}.split"] = np.array(json.dumps(
        [eng._batch_sharding(b) for b in buckets]))
    teng = InferenceEngine(lambda p, x: tt.transformer_apply(p, x, cfg),
                           tt.transformer_init(0, cfg, device="cpu"),
                           buckets=(4,), mesh=mesh)
    x = np.random.default_rng(5).integers(0, 64, (3, 128)).astype(np.int32)
    res[f"{name}.transformer"] = teng.infer(x)
np.savez(sys.argv[1], **res)
hvd.shutdown()
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Each member's results, from one 4-process gloo world."""
    tmp = tmp_path_factory.mktemp("serve_mesh")
    env = dict(os.environ, HVDT_SIZE="4",
               HVDT_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
               HVDT_FLASH_SMALLSEQ="on", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("HVDT_FLASH_ATTENTION", None)
    args = [json.dumps(a) for a in (MESHES, BUCKETS, ROWS, _TKW)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(tmp / f"out{r}.npz"), *args],
        env=dict(env, HVDT_RANK=str(r), HVDT_LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(4)]
    out = []
    for r, p in enumerate(procs):
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, log.decode()[-3000:]
        out.append(dict(np.load(tmp / f"out{r}.npz")))
    return out


@pytest.fixture(scope="module")
def one_process(monkeypatch_module):
    monkeypatch_module.setenv("HVDT_FLASH_SMALLSEQ", "on")
    monkeypatch_module.delenv("HVDT_FLASH_ATTENTION", raising=False)
    eng = InferenceEngine(mlp_apply, mlp_init(0, SIZES, device="cpu"),
                          buckets=BUCKETS)
    want = {}
    for n in ROWS:
        x = np.random.default_rng(n).normal(size=(n, 6)).astype(np.float32)
        want[f"mlp.{n}"] = eng.infer(x)
    cfg = tt.TransformerConfig(dtype=torch.float32, **_TKW)
    teng = InferenceEngine(lambda p, x: tt.transformer_apply(p, x, cfg),
                           tt.transformer_init(0, cfg, device="cpu"),
                           buckets=(4,))
    x = np.random.default_rng(5).integers(0, 64, (3, 128)).astype(np.int32)
    want["transformer"] = teng.infer(x)
    return want


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_engine_matches_one_process(world, one_process, mesh):
    for res in world:
        for n in ROWS:
            np.testing.assert_allclose(res[f"{mesh}.mlp.{n}"],
                                       one_process[f"mlp.{n}"], rtol=1e-5,
                                       atol=1e-5)
        np.testing.assert_allclose(res[f"{mesh}.transformer"],
                                   one_process["transformer"], rtol=1e-5,
                                   atol=1e-5)
        assert int(res[f"{mesh}.compiles"]) == len(BUCKETS)
    # Every member returns the same bytes (the gathered rows).
    for key in world[0]:
        if key.startswith(mesh) and key != f"{mesh}.split":
            assert all(np.array_equal(r[key], world[0][key])
                       for r in world[1:]), key


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_split_matches_reference(world, mesh):
    """The split of each bucket: ``(axes,)`` or replicated, as the
    reference's ``_batch_sharding`` (dp/fsdp by the sharding rules; tp
    never) on a JAX mesh of the same shape; the gloo members decided the
    same."""
    sizes = MESHES[mesh]
    devices = np.array(jax.devices()[:4]).reshape(tuple(sizes.values()))
    jmesh = jax.sharding.Mesh(devices, tuple(sizes))
    ref = JEngine(jmlp.mlp_apply, jmlp.mlp_init(jax.random.PRNGKey(0),
                                                SIZES),
                  buckets=BUCKETS, mesh=jmesh)
    eng = InferenceEngine(mlp_apply, mlp_init(0, SIZES, device="cpu"),
                          buckets=BUCKETS, mesh=sizes)
    want = [tuple(ref._batch_sharding(b).spec) for b in BUCKETS]
    got = [eng._batch_sharding(b) for b in BUCKETS]
    assert got == want
    assert json.loads(str(world[0][f"{mesh}.split"])) == [
        list(s) for s in got]
    split = {"dp4": [(), ("dp",), ("dp",)], "dp2_tp2": [("dp",)] * 3}[mesh]
    assert got == split
