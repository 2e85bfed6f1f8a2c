"""The port's peer-replicated snapshot tier and callbacks.

The ``HVPS1`` blob is byte-equal to the reference's for the same payload
and each package reads the other's; ``TensorState`` and
``interop.torch_elastic.TorchState`` restore through a ``PeerStore``
over the port's ``runner/http_kv`` server (host copies in the payload,
tensors back on their devices, equal bytes); a corrupted blob counts as
a miss and the disk commit serves; a newer disk commit wins over an
older peer one; ZeRO shard rows round-trip; and the callbacks act on
torch tensors in a world of one.
"""

from __future__ import annotations

import pickle

import numpy as np
import pytest
import torch

from horovod_tpu.resilience import peer_store as jpeer

import horovod_tpu_torch as hvd
from horovod_tpu_torch import callbacks as tcb
from horovod_tpu_torch import elastic as tel
from horovod_tpu_torch.interop.torch_elastic import TorchState
from horovod_tpu_torch.ops import zero as tzero
from horovod_tpu_torch.resilience import peer_store as tpeer
from horovod_tpu_torch.runner import http_kv
from horovod_tpu_torch.telemetry import instrument as tinst
from horovod_tpu_torch.telemetry import metrics as tmet


def test_blob_matches_reference():
    payload = pickle.dumps({"batch": 7, "w": np.arange(6, dtype=np.float32)},
                           protocol=pickle.HIGHEST_PROTOCOL)
    blob = tpeer._pack(3, 7, payload)
    assert blob == jpeer._pack(3, 7, payload)
    assert jpeer._unpack(blob) == tpeer._unpack(blob)
    header, body = tpeer._unpack(blob)
    assert header["step"] == 7 and body == payload
    torn = blob[:-1] + bytes([blob[-1] ^ 1])
    assert tpeer._unpack(torn) is None and jpeer._unpack(torn) is None


@pytest.fixture
def kv(monkeypatch):
    server = http_kv.RendezvousServer(addr="127.0.0.1")
    server.start()
    for k, v in {"HVDT_PEER_STORE": "1", "HVDT_RENDEZVOUS_ADDR": "127.0.0.1",
                 "HVDT_RENDEZVOUS_PORT": str(server.port),
                 "HVDT_SECRET": server.secret.hex(), "HVDT_RANK": "0",
                 "HVDT_SIZE": "2", "HVDT_TELEMETRY": "1"}.items():
        monkeypatch.setenv(k, v)
    tmet.reset_default_registry()
    tinst.reset()
    tpeer.reset()
    yield server
    tpeer.reset()
    tinst.reset()
    server.stop()


def _leaves_of(obj):
    if isinstance(obj, dict):
        return [x for v in obj.values() for x in _leaves_of(v)]
    if isinstance(obj, (list, tuple)):
        return [x for v in obj for x in _leaves_of(v)]
    return [obj]


def _count(name):
    m = tmet.default_registry().get(name)
    return m.total() if m is not None else 0.0


def _commit(state):
    """A commit without the launcher's notification channel."""
    state.save()
    state.persist()
    tpeer.get_peer_store().commit(state._commit_step(),
                                  tel._to_host(state._persisted()))


def test_tensor_state_restores_from_the_peer_tier(kv, tmp_path):
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    st = tel.TensorState(w=w, opt={"m": torch.ones(4)}, batch=0)
    assert st.restored_from is None and _count("hvdt_peer_miss_total") == 1
    st.batch = 5
    st.w.mul_(2)
    _commit(st)
    blob = kv.get_local("/peer/0")
    header, payload = tpeer._unpack(blob)
    snap = pickle.loads(payload)
    assert header["step"] == 5
    hosts = [v for v in _leaves_of(snap) if isinstance(v, tel._HostCopy)]
    assert hosts and all(h.tensor.device.type == "cpu" for h in hosts)
    st2 = tel.TensorState(w=torch.zeros(3, 4), opt={"m": torch.zeros(4)},
                          batch=0)
    assert st2.restored_from == "peer" and st2.batch == 5
    assert torch.equal(st2.w, w) and torch.equal(st2.opt["m"],
                                                 torch.ones(4))
    assert _count("hvdt_peer_restore_total") == 1
    assert _count("hvdt_peer_commit_total") == 1


def test_corrupt_blob_is_a_miss_and_disk_serves(kv, tmp_path):
    path = str(tmp_path / "s.pt")
    st = tel.TensorState(path=path, w=torch.ones(4), batch=0)
    st.batch = 3
    st.w.add_(1)
    _commit(st)
    blob = kv.get_local("/peer/0")
    kv.put_local("/peer/0", blob[:-1] + bytes([blob[-1] ^ 1]))
    st2 = tel.TensorState(path=path, w=torch.zeros(4), batch=0)
    assert st2.restored_from == "disk" and st2.batch == 3
    assert torch.equal(st2.w, torch.full((4,), 2.0))
    assert _count("hvdt_peer_miss_total") == 2   # the first build + torn


def test_newer_disk_commit_wins(kv, tmp_path):
    path = str(tmp_path / "s.pt")
    st = tel.TensorState(path=path, w=torch.ones(2), batch=4)
    _commit(st)
    st.batch = 9
    st.w.add_(5)
    st.save()
    st.persist()                         # disk at 9, the peer tier at 4
    st2 = tel.TensorState(path=path, w=torch.zeros(2), batch=0)
    assert st2.restored_from == "disk" and st2.batch == 9


def test_torch_state_restores_from_the_peer_tier(kv):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(5, 3), torch.nn.BatchNorm1d(3))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    model(torch.randn(8, 5)).square().mean().backward()
    opt.step()
    st = TorchState(model, opt, batch=10)
    _commit(st)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    want_opt = opt.state_dict()
    model2 = torch.nn.Sequential(torch.nn.Linear(5, 3),
                                 torch.nn.BatchNorm1d(3))
    opt2 = torch.optim.SGD(model2.parameters(), lr=0.1, momentum=0.9)
    st2 = TorchState(model2, opt2, batch=0)
    assert st2.restored_from == "peer" and st2.batch == 10
    for k, v in model2.state_dict().items():
        assert torch.equal(v, want[k]), k
    got_opt = opt2.state_dict()
    for p, s in want_opt["state"].items():
        assert torch.equal(got_opt["state"][p]["momentum_buffer"],
                           s["momentum_buffer"])


def test_zero_shard_rows_round_trip(kv):
    state = tzero.ZeroSgdState(trace=(torch.arange(8.).reshape(2, 4),
                                      torch.ones(2, 6)))
    ps = tpeer.get_peer_store()
    assert ps.commit_zero_shard(state, step=2)
    blank = tzero.ZeroSgdState(trace=(torch.zeros(2, 4), torch.zeros(2, 6)))
    got, step = ps.restore_zero_shard(blank)
    assert step == 2
    assert torch.equal(got.trace[0][0], state.trace[0][0])
    assert torch.equal(got.trace[0][1], torch.zeros(4))


def test_callbacks_in_a_world_of_one(tmp_path):
    hvd.init(device="cpu")
    try:
        out = tcb.average_metrics({"loss": torch.tensor(1.5), "acc": 0.25})
        assert out == {"acc": 0.25, "loss": 1.5}
        model = torch.nn.Linear(3, 2)
        assert tcb.broadcast_global_state(model) is model
        ck = tcb.BestModelCheckpoint(str(tmp_path / "best.pt"))
        assert ck({"val_loss": torch.tensor(2.0)}, model)
        assert not ck({"val_loss": 3.0}, model)
        saved = torch.load(str(tmp_path / "best.pt"))
        assert torch.equal(saved["weight"], model.weight)
        assert tcb.rank_zero_only(lambda: 7)() == 7
        assert float(tcb.warmup_schedule(0.1, 4)(2)) == pytest.approx(0.1)
    finally:
        hvd.shutdown()
