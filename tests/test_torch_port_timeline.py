"""PyTorch port: ``timeline.py`` and the eager controller's timeline hooks.

The same sequence of named eager ops (allreduce, allgather, broadcast,
a grouped allreduce, alltoall, reducescatter) runs in a world of one
through both packages with a timeline started; per tensor, the two JSON
files hold the same events: names, phases and order, and the end
markers' output shapes (times and the fusion count excluded).  Then:
``start_timeline`` / ``stop_timeline`` on a running controller (the
reference's ``test_dynamic_timeline_on_running_controller``),
``HVDT_TIMELINE`` read at controller start, ``HVDT_TIMELINE_MARK_CYCLES``
and the ``ERROR`` instant of a failed response.
"""

import collections
import json

import numpy as np
import pytest

import horovod_tpu as jhvd
from horovod_tpu import timeline as jtl
from horovod_tpu.ops import eager as jeager
import horovod_tpu_torch as hvd
from horovod_tpu_torch import timeline as ttl
from horovod_tpu_torch.ops import eager as teager
from horovod_tpu_torch.ops.messages import RequestType, Response


@pytest.fixture(scope="module")
def worlds():
    jhvd.init()
    hvd.init(device="cpu")
    yield
    hvd.shutdown()
    jhvd.shutdown()


def _ops(top):
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    top.allreduce(x, name="tl.allreduce")
    top.allgather(x, name="tl.allgather")
    top.broadcast(x, root_rank=0, name="tl.broadcast")
    top.grouped_allreduce([x, x[:1]], name="tl.group")
    top.alltoall(x, name="tl.alltoall")
    top.reducescatter(x, name="tl.reducescatter")
    top.allreduce(x[0], name="tl.allreduce")      # a second, cached round


def _record(top, tl, eager, path, **kw):
    tl.start_timeline(str(path), **kw)
    try:
        eager.shutdown_controller()               # a controller that reads it
        _ops(top)
    finally:
        eager.shutdown_controller()
        tl.stop_timeline()
    with open(path) as f:
        return json.load(f)


def _per_tensor(events):
    names = {e["pid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    rows = collections.defaultdict(list)
    for e in events:
        if e["ph"] == "M":
            continue
        rows[names[e["pid"]]].append(
            (e["ph"], e.get("name"), (e.get("args") or {}).get("shape")))
    return dict(rows)


def test_same_events_per_tensor_as_the_reference(worlds, tmp_path):
    ref = _per_tensor(_record(jhvd, jtl, jeager, tmp_path / "ref.json"))
    port = _per_tensor(_record(hvd, ttl, teager, tmp_path / "port.json"))
    assert port == ref
    assert port["tl.allreduce"] == [
        ("B", "NEGOTIATE_ALLREDUCE", None), ("E", None, None),
        ("B", "EXEC_ALLREDUCE", None), ("E", None, [3, 2]),
        ("B", "NEGOTIATE_ALLREDUCE", None), ("E", None, None),
        ("B", "EXEC_ALLREDUCE", None), ("E", None, [2])]
    assert {"tl.group.0", "tl.group.1", "tl.alltoall"} <= set(port)


def test_dynamic_timeline_on_running_controller(worlds, tmp_path):
    hvd.allreduce(np.ones(2, np.float32), name="before_tl")
    path = tmp_path / "dyn.json"
    hvd.start_timeline(str(path))
    hvd.allreduce(np.ones(2, np.float32), name="during_tl")
    hvd.stop_timeline()
    hvd.allreduce(np.ones(2, np.float32), name="after_tl")
    events = json.loads(path.read_text())
    names = {e["args"]["name"] for e in events if e["ph"] == "M"}
    assert names == {"during_tl"}
    assert ttl.current() is None


def test_env_timeline_and_cycle_marks(worlds, tmp_path, monkeypatch):
    path = tmp_path / "env.json"
    monkeypatch.setenv("HVDT_TIMELINE", str(path))
    monkeypatch.setenv("HVDT_TIMELINE_MARK_CYCLES", "1")
    teager.shutdown_controller()
    try:
        hvd.allreduce(np.ones(3, np.float32), name="env_tl")
        assert ttl.current() is not None and ttl.current().mark_cycles
        hvd.start_timeline(str(tmp_path / "second.json"))   # ignored
    finally:
        teager.shutdown_controller()
        hvd.stop_timeline()
    events = json.loads(path.read_text())
    names = {e["args"]["name"] for e in events if e["ph"] == "M"}
    assert {"env_tl", "_cycle"} <= names
    assert any(e.get("name") == "CYCLE" and e["ph"] == "i" for e in events)
    assert not (tmp_path / "second.json").exists()


def test_failed_response_records_an_error_instant(worlds, tmp_path):
    path = tmp_path / "err.json"
    hvd.start_timeline(str(path))
    try:
        teager._controller()._fail_response(
            Response(RequestType.ALLREDUCE, ["tl.failed"]), "boom")
    finally:
        hvd.stop_timeline()
    rows = _per_tensor(json.loads(path.read_text()))
    assert rows == {"tl.failed": [("i", "ERROR", None)]}
