"""PyTorch port: checkpoints (horovod_tpu_torch/checkpoint.py) against
the JAX package's checkpoint.py.

* ``save_checkpoint`` / ``restore_checkpoint`` and ``CheckpointManager``
  follow tests/test_checkpoint.py (round trips, step None, force,
  interval and keep-N, discovery), plus the integrity layer: a corrupt
  step is detected by its manifest and skipped, ``LAST_GOOD`` advances
  only after a completed save, and ``save_async`` is ``save`` itself
  with ``HVDT_ASYNC_CKPT`` unset.
* ``save_async`` takes the snapshot before it returns: updating the
  tensors in place at once still restores the snapshot.  A queued
  snapshot is superseded by a newer one; a failing write is counted and
  logged, never raised, and ``LAST_GOOD`` stays put.
* f32 ZeRO checkpoints are read both ways: the reference's
  ``save_zero_state`` of an 8-shard state restored by the port as 4
  shards (equal to the reference's own restore), and the port's save
  restored by the reference; the files, ``.npz`` keys and manifest
  fields are the reference's.  A corrupt shard raises.  The ``_4d``
  layout changes (pp2·dp4 -> dp8 and back) give the reference's states.
* A 2-process gloo world: rank 0 saves, every rank restores the same
  tree (f32, bf16 and int64 leaves) through the broadcast, in place too.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from horovod_tpu import checkpoint as jck
from horovod_tpu.ops import zero as jz
from horovod_tpu_torch import checkpoint as tck
from horovod_tpu_torch.ops import zero as tz

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = [(24, 16), (16,), (16, 40), (40,), (40, 9), (9,), (300,)]
TH = 2048


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("HVDT_ASYNC_CKPT", raising=False)
    monkeypatch.delenv("HVDT_CKPT_SNAPSHOT_BUDGET_S", raising=False)


def _tree():
    return {"w": torch.arange(6.0).reshape(2, 3),
            "b": torch.ones(3) * 0.5,
            "nested": {"m": torch.zeros((4,)),
                       "h": torch.arange(5).to(torch.bfloat16)}}


class TestSaveRestore:
    def test_roundtrip_with_step(self, tmp_path):
        path = os.path.join(tmp_path, "ck")
        tree = _tree()
        tck.save_checkpoint(path, tree, step=42)
        tmpl = {"w": torch.zeros(2, 3), "b": torch.zeros(3),
                "nested": {"m": torch.ones(4),
                           "h": torch.zeros(5, dtype=torch.bfloat16)}}
        restored, step = tck.restore_checkpoint(path, tmpl)
        assert step == 42
        for k in ("w", "b"):
            assert torch.equal(restored[k], tree[k])
        assert torch.equal(restored["nested"]["m"], torch.zeros(4))
        assert restored["nested"]["h"].dtype == torch.bfloat16
        assert torch.equal(restored["nested"]["h"], tree["nested"]["h"])
        assert not torch.equal(tmpl["w"], tree["w"])     # not in place

    def test_in_place_keeps_storage(self, tmp_path):
        path = os.path.join(tmp_path, "ck")
        tck.save_checkpoint(path, _tree(), step=3)
        tmpl = {"w": torch.zeros(2, 3), "b": torch.zeros(3),
                "nested": {"m": torch.ones(4),
                           "h": torch.zeros(5, dtype=torch.bfloat16)}}
        ptr = tmpl["w"].data_ptr()
        got, step = tck.restore_checkpoint(path, tmpl, in_place=True)
        assert got is tmpl and step == 3 and tmpl["w"].data_ptr() == ptr
        assert torch.equal(tmpl["w"], _tree()["w"])

    def test_step_none_roundtrips(self, tmp_path):
        path = os.path.join(tmp_path, "ck2")
        tck.save_checkpoint(path, {"x": torch.ones(2)})
        restored, step = tck.restore_checkpoint(path, {"x": torch.zeros(2)})
        assert step is None
        assert torch.equal(restored["x"], torch.ones(2))

    def test_force_overwrites(self, tmp_path):
        path = os.path.join(tmp_path, "ck3")
        tck.save_checkpoint(path, {"x": torch.ones(2)}, step=1)
        tck.save_checkpoint(path, {"x": torch.full((2,), 7.0)}, step=2)
        restored, step = tck.restore_checkpoint(path, {"x": torch.zeros(2)})
        assert step == 2
        assert torch.equal(restored["x"], torch.full((2,), 7.0))

    def test_numpy_and_scalars(self, tmp_path):
        path = os.path.join(tmp_path, "ck4")
        tck.save_checkpoint(path, {"a": np.arange(3.0), "lr": 0.5,
                                   "epoch": 7}, step=1)
        got, _ = tck.restore_checkpoint(path)
        assert torch.equal(got["a"], torch.arange(3.0, dtype=torch.float64))
        assert got["lr"] == 0.5 and got["epoch"] == 7


class TestCheckpointManager:
    def test_interval_and_keep_n(self, tmp_path):
        mgr = tck.CheckpointManager(os.path.join(tmp_path, "ckpts"),
                                    save_interval_steps=10, max_to_keep=2)
        written = [s for s in range(35)
                   if mgr.save(s, {"x": torch.ones(3) * s})]
        assert written == [0, 10, 20, 30]
        assert mgr.all_steps() == [20, 30]
        restored, step = mgr.restore_latest({"x": torch.zeros(3)})
        assert step == 30
        assert torch.equal(restored["x"], torch.full((3,), 30.0))
        assert mgr.last_good_step() == 30

    def test_restore_empty_dir(self, tmp_path):
        mgr = tck.CheckpointManager(os.path.join(tmp_path, "empty"))
        assert mgr.restore_latest({"x": torch.zeros(1)}) == (None, None)

    def test_force_save_off_interval(self, tmp_path):
        mgr = tck.CheckpointManager(os.path.join(tmp_path, "f"),
                                    save_interval_steps=100)
        assert not mgr.save(7, {"x": torch.ones(1)})
        assert mgr.save(7, {"x": torch.ones(1)}, force=True)
        assert mgr.latest_step() == 7

    def test_discovery(self, tmp_path):
        mgr = tck.CheckpointManager(os.path.join(tmp_path, "d"),
                                    max_to_keep=10)
        for s in (30, 5, 12):
            mgr.save(s, {"x": torch.ones(2)}, force=True)
        open(os.path.join(mgr.directory, "step_000000000099"), "w").close()
        os.makedirs(os.path.join(mgr.directory, "notes"))
        os.makedirs(os.path.join(mgr.directory, "step_abc"))
        assert mgr.all_steps() == [5, 12, 30]
        assert os.path.basename(mgr.step_path(42)) == "step_000000000042"
        fresh = tck.CheckpointManager(os.path.join(tmp_path, "fresh"))
        os.rmdir(fresh.directory)
        assert fresh.all_steps() == [] and fresh.latest_step() is None

    def test_corrupt_step_falls_back(self, tmp_path):
        mgr = tck.CheckpointManager(os.path.join(tmp_path, "c"),
                                    max_to_keep=5)
        for s in (1, 2, 3):
            mgr.save(s, {"x": torch.full((4,), float(s))}, force=True)
        payload = os.path.join(mgr.step_path(3), "checkpoint.pt")
        with open(payload, "r+b") as f:
            f.seek(40)
            f.write(b"\x00garbage\x00")
        assert not mgr.verify_step(3) and mgr.verify_step(2)
        got, step = mgr.restore_latest({"x": torch.zeros(4)})
        assert step == 2 and torch.equal(got["x"], torch.full((4,), 2.0))
        assert mgr.corrupt_detected == 1

    def test_save_async_is_save_when_off(self, tmp_path):
        mgr = tck.CheckpointManager(os.path.join(tmp_path, "s"))
        assert mgr.save_async == mgr.save
        assert mgr._writer is None


class TestAsync:
    def test_snapshot_then_in_place_update(self, tmp_path, monkeypatch):
        monkeypatch.setenv("HVDT_ASYNC_CKPT", "1")
        mgr = tck.CheckpointManager(os.path.join(tmp_path, "a"))
        assert mgr.save_async != mgr.save
        tree = {"w": torch.arange(1000.0), "n": {"v": torch.ones(10)}}
        assert mgr.save_async(4, tree, force=True)
        tree["w"].mul_(-3.0)           # the next step, in place, at once
        tree["n"]["v"].zero_()
        assert mgr.wait_for_async(30)
        mgr.close()
        got, step = mgr.restore_latest()
        assert step == 4 and mgr.last_good_step() == 4
        assert torch.equal(got["w"], torch.arange(1000.0))
        assert torch.equal(got["n"]["v"], torch.ones(10))

    def test_superseded_and_failures(self, tmp_path, monkeypatch):
        monkeypatch.setenv("HVDT_ASYNC_CKPT", "1")
        mgr = tck.CheckpointManager(os.path.join(tmp_path, "b"))
        gate, started = threading.Event(), threading.Event()
        real = mgr._write_step_payload

        def slow(step, payload):
            started.set()
            gate.wait(10)
            if step == 3:
                raise OSError("disk full")
            real(step, payload)

        mgr._write_step_payload = slow
        m = mgr._async_metrics()
        sup0, fail0 = m["superseded"].value(), m["failures"].value()
        mgr.save_async(1, {"x": torch.ones(1)}, force=True)   # in flight
        assert started.wait(10)
        mgr.save_async(2, {"x": torch.ones(1) * 2}, force=True)  # queued
        mgr.save_async(3, {"x": torch.ones(1) * 3}, force=True)  # replaces
        gate.set()
        assert mgr.wait_for_async(30)
        assert m["superseded"].value() - sup0 == 1
        assert m["failures"].value() - fail0 == 1
        assert mgr.all_steps() == [1] and mgr.last_good_step() == 1
        mgr.close()


# ---------------------------------------------------------------------------
# ZeRO checkpoints across the two packages
# ---------------------------------------------------------------------------


def _zero_pair(n, seed=0, kind="adam"):
    """The same f32 state as a reference state and a port state, with its
    metadata (the reference's and the port's metadata agree)."""
    leaves = [torch.empty(s) for s in SHAPES]
    jl = [np.zeros(s, np.float32) for s in SHAPES]
    tx = (tz.zero_adam(1e-3, num_shards=n, threshold_bytes=TH)
          if kind == "adam" else
          tz.zero_sgd(0.1, momentum=0.9, num_shards=n, threshold_bytes=TH))
    jtx = (jz.zero_adam(1e-3, num_shards=n, threshold_bytes=TH)
           if kind == "adam" else
           jz.zero_sgd(0.1, momentum=0.9, num_shards=n, threshold_bytes=TH))
    meta = tz.state_metadata(tx, leaves)
    assert meta == jz.state_metadata(jtx, jl)
    rng = np.random.default_rng(seed)
    plan = tx.plan_for(leaves)
    names = ("mu", "nu") if kind == "adam" else ("trace",)
    bufs = {nm: [] for nm in names}
    for nm in names:
        for sz, sl in zip(plan.sizes, plan.shard_lens):
            flat = np.zeros(n * sl, np.float32)
            flat[:sz] = rng.standard_normal(sz)
            bufs[nm].append(flat.reshape(n, sl))
    if kind == "adam":
        t = tz.ZeroAdamState(torch.tensor(9, dtype=torch.int32),
                             tuple(map(torch.from_numpy, bufs["mu"])),
                             tuple(map(torch.from_numpy, bufs["nu"])))
        j = jz.ZeroAdamState(jnp.asarray(9, jnp.int32),
                             tuple(map(jnp.asarray, bufs["mu"])),
                             tuple(map(jnp.asarray, bufs["nu"])))
    else:
        t = tz.ZeroSgdState(tuple(map(torch.from_numpy, bufs["trace"])))
        j = jz.ZeroSgdState(tuple(map(jnp.asarray, bufs["trace"])))
    return t, j, meta


def _assert_same(t, j):
    tb = [s for _, ss in tz._state_stacks(t) for s in ss]
    jb = ([*j.mu, *j.nu] if hasattr(j, "mu") else list(j.trace))
    assert len(tb) == len(jb)
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if hasattr(j, "mu"):
        assert int(t.count) == int(j.count)


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_reference_zero_checkpoint_restored_by_port(tmp_path, kind):
    t, j, meta = _zero_pair(8, kind=kind)
    jck.save_zero_state(str(tmp_path), j, meta, step=11)
    for n in (8, 4, 2):
        got, gmeta, step = tck.restore_zero_state(str(tmp_path),
                                                  num_shards=n)
        want, wmeta, wstep = jck.restore_zero_state(str(tmp_path),
                                                    num_shards=n)
        assert step == wstep == 11 and gmeta == wmeta
        assert gmeta["num_shards"] == n
        _assert_same(got, want)


@pytest.mark.parametrize("kind", ["adam", "sgd"])
def test_port_zero_checkpoint_restored_by_reference(tmp_path, kind):
    t, j, meta = _zero_pair(4, seed=1, kind=kind)
    tck.save_zero_state(str(tmp_path / "port"), t, meta, step=5)
    jck.save_zero_state(str(tmp_path / "ref"), j, meta, step=5)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "ref"))
    tdoc = json.load(open(tmp_path / "port" / "zero_manifest.json"))
    jdoc = json.load(open(tmp_path / "ref" / "zero_manifest.json"))
    assert tdoc.keys() == jdoc.keys()
    assert {k: v for k, v in tdoc.items() if k != "shards"} == {
        k: v for k, v in jdoc.items() if k != "shards"}
    with np.load(tmp_path / "port" / "shard_0002.npz") as a, \
            np.load(tmp_path / "ref" / "shard_0002.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    for n in (4, 8):
        got, gmeta, step = jck.restore_zero_state(str(tmp_path / "port"),
                                                  num_shards=n)
        want, _, _ = tck.restore_zero_state(str(tmp_path / "port"),
                                            num_shards=n)
        assert step == 5 and gmeta["num_shards"] == n
        _assert_same(want, got)


def test_corrupt_zero_shard_raises(tmp_path):
    t, _, meta = _zero_pair(4)
    tck.save_zero_state(str(tmp_path), t, meta)
    with open(tmp_path / "shard_0001.npz", "r+b") as f:
        f.seek(100)
        f.write(b"\xff\xff\xff")
    with pytest.raises(ValueError, match="shard_0001.npz failed SHA-256"):
        tck.restore_zero_state(str(tmp_path))
    with pytest.raises(ValueError, match="failed SHA-256"):
        jck.restore_zero_state(str(tmp_path))


def test_rank_local_state_must_be_gathered(tmp_path):
    t, _, meta = _zero_pair(4)
    local = tz.ZeroAdamState(t.count, tuple(s[:1] for s in t.mu),
                             tuple(s[:1] for s in t.nu))
    with pytest.raises(ValueError, match="gather_state"):
        tck.save_zero_state(str(tmp_path), local, meta)


def _stage_meta(shapes, n):
    leaves = [torch.empty(s) for s in shapes]
    tx = tz.zero_adam(1e-3, num_shards=n, threshold_bytes=TH)
    return tx, leaves, tz.state_metadata(tx, leaves)


def test_4d_layout_changes_match_reference(tmp_path):
    """pp2·dp4 -> dp8 and dp8 -> pp2·dp4 through the global logical
    vector, on the port's and the reference's files alike."""
    stage_shapes = [SHAPES[:3], SHAPES[3:]]
    rng = np.random.default_rng(4)
    states, metas = [], []
    for shapes in stage_shapes:
        tx, leaves, meta = _stage_meta(shapes, 4)
        plan = tx.plan_for(leaves)
        mk = lambda: tuple(torch.from_numpy(
            rng.standard_normal((4, sl)).astype(np.float32)
            * (np.arange(4 * sl).reshape(4, sl) < sz))
            for sz, sl in zip(plan.sizes, plan.shard_lens))
        states.append(tz.ZeroAdamState(torch.tensor(3, dtype=torch.int32),
                                       mk(), mk()))
        metas.append(meta)
    tck.save_zero_state_4d(str(tmp_path / "pp"), states, metas, step=6)
    # dp8 target: the stage-major logical vector as one bucket list.
    cat, cmeta = tz.concat_states(states, metas)
    flat = tz.flatten_state_buffers(cat, cmeta)
    total = flat["mu"].size
    dp8 = {"num_shards": 8, "align": 256,
           "buckets": [{"size": total, "shard_len":
                        -(-total // (8 * 256)) * 256, "dtype": "float32"}]}
    got, gm, step = tck.restore_zero_state_4d(str(tmp_path / "pp"), [dp8])
    want, wm, wstep = jck.restore_zero_state_4d(str(tmp_path / "pp"), [dp8])
    assert step == wstep == 6 and gm == wm
    _assert_same(got[0], want[0])
    np.testing.assert_array_equal(
        tz.flatten_state_buffers(got[0], dp8)["nu"], flat["nu"])
    # And back: the dp8 state saved flat, restored onto the two stages.
    tck.save_zero_state(str(tmp_path / "flat"), got[0], dp8, step=7)
    back, bm, bstep = tck.restore_zero_state_4d(str(tmp_path / "flat"),
                                                metas)
    jback, _, _ = jck.restore_zero_state_4d(str(tmp_path / "flat"), metas)
    assert bstep == 7 and bm == metas
    for s, b, jb in zip(states, back, jback):
        _assert_same(b, jb)
        for x, y in zip(s.mu + s.nu, b.mu + b.nu):
            assert torch.equal(x, y)
    with pytest.raises(ValueError, match="different parameter sets"):
        tck.restore_zero_state_4d(str(tmp_path / "flat"), metas[:1])


# ---------------------------------------------------------------------------
# A 2-process world: rank 0 saves, every rank restores
# ---------------------------------------------------------------------------

_WORKER = r"""
import os, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import checkpoint as ck

hvd.init(device="cpu")
r = hvd.rank()
root = sys.argv[1]
tree = {"w": torch.arange(12.0).reshape(3, 4) * (r + 1),
        "h": (torch.arange(6) * (r + 1)).to(torch.bfloat16),
        "i": torch.arange(3, dtype=torch.int64) + r, "epoch": 2 + r}
ck.save_checkpoint(os.path.join(root, "c"), tree, step=9)
files = sorted(os.listdir(os.path.join(root, "c")))
got, step = ck.restore_checkpoint(os.path.join(root, "c"))
tmpl = {"w": torch.zeros(3, 4), "h": torch.zeros(6, dtype=torch.bfloat16),
        "i": torch.zeros(3, dtype=torch.int64), "epoch": 0}
ptr = tmpl["w"].data_ptr()
got2, _ = ck.restore_checkpoint(os.path.join(root, "c"), tmpl,
                                in_place=True)
mgr = ck.CheckpointManager(os.path.join(root, "m"))
mgr.save(3, tree, force=True)
mgr.save(4, tree, force=True)
got3, step3 = mgr.restore_latest(tmpl)
res = {"w": got["w"].numpy(), "h": got["h"].float().numpy(),
       "hdtype": str(got["h"].dtype), "i": got["i"].numpy(),
       "epoch": got["epoch"], "step": step, "files": ",".join(files),
       "w2": tmpl["w"].numpy(), "inplace": tmpl["w"].data_ptr() == ptr,
       "w3": got3["w"].numpy(), "step3": step3}
np.savez(sys.argv[2], **res)
hvd.shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_restore_broadcasts(tmp_path):
    env = dict(os.environ, HVDT_SIZE="2",
               HVDT_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("HVDT_ASYNC_CKPT", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(tmp_path),
         str(tmp_path / f"out{r}.npz")], env=dict(env, HVDT_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out.decode()[-3000:]
    res = [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(2)]
    for r in range(2):
        got = res[r]
        # Rank 0's tree everywhere.
        np.testing.assert_array_equal(got["w"],
                                      np.arange(12.0).reshape(3, 4))
        np.testing.assert_array_equal(got["h"], np.arange(6.0))
        assert str(got["hdtype"]) == "torch.bfloat16"
        np.testing.assert_array_equal(got["i"], np.arange(3))
        assert int(got["epoch"]) == 2 and int(got["step"]) == 9
        assert str(got["files"]) == "checkpoint.pt"
        np.testing.assert_array_equal(got["w2"], got["w"])
        assert bool(got["inplace"])
        np.testing.assert_array_equal(got["w3"], got["w"])
        assert int(got["step3"]) == 4
