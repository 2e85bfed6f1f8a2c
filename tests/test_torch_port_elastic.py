"""PyTorch port: elastic state and the retry loop (horovod_tpu_torch/
elastic.py, interop/torch_elastic.py) against the JAX package's.

* ``TorchState`` against the reference's ``horovod_tpu.interop.
  torch_elastic.TorchState`` over the same torch model (BatchNorm
  included), SGD with momentum and ``ElasticSampler``: commit, train and
  mutate, restore — every ``state_dict`` and attribute equal, exactly,
  and equal to the commit; handler routing on assignment; the port's
  ``DistributedOptimizer`` wrapper takes the optimizer handler; a
  ``path=`` commit resumes a fresh state (a respawned worker).
* ``run`` in a world of one, against the reference's ``elastic.run``:
  the calls of ``sync`` / ``restore`` / ``on_reset`` and the values each
  entry sees for ``HorovodInternalError`` (roll back) and
  ``HostsUpdatedInterrupt`` (keep, ``skip_sync``), a reset callback,
  an unrecoverable error; the port also restores on a
  ``torch.distributed.DistError``.
* ``TensorState`` (the counterpart of ``JaxState``): host snapshots,
  restore into the live tensors in place, a resize, ``path=`` resume
  and ``restored_from``, a broadcast ``sync``; ``HVDT_PEER_STORE``
  without the launcher's KV leaves the disk tier serving.
* ``WorkerNotificationManager`` of either package over one port
  ``RendezvousServer``: the same interrupts for the same KV script.
"""

import copy

import numpy as np
import pytest
import torch
import torch.distributed as dist

import horovod_tpu as jhvd
from horovod_tpu import elastic as jelastic
from horovod_tpu.data.sampler import ElasticSampler as JSampler
from horovod_tpu.interop import torch_elastic as jte
from horovod_tpu.runner.elastic import worker as jworker
import horovod_tpu_torch as thvd
from horovod_tpu_torch import elastic as telastic
from horovod_tpu_torch.common.exceptions import (HorovodInternalError,
                                                 HostsUpdatedInterrupt)
from horovod_tpu_torch.data.sampler import ElasticSampler as TSampler
from horovod_tpu_torch.interop import torch_elastic as tte
from horovod_tpu_torch.runner import http_kv as tkv
from horovod_tpu_torch.runner.elastic import worker as tworker


def _model_and_opt():
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 5),
                                torch.nn.BatchNorm1d(5),
                                torch.nn.Linear(5, 2))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    return model, opt


def _train(model, opt, sampler, steps, start):
    for i in range(steps):
        g = torch.Generator().manual_seed(start + i)
        x = torch.randn(8, 6, generator=g)
        loss = model(x).square().mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        sampler.record_batch(start + i, 8)


def _snapshot(state):
    return (copy.deepcopy(state.model.state_dict()),
            copy.deepcopy(state.optimizer.state_dict()),
            state.sampler.state_dict(), state.batch, state.epoch)


def _torch_state_round_trip(te, sampler_cls):
    model, opt = _model_and_opt()
    sampler = sampler_cls(64, shuffle=True, seed=3, rank=0, size=1)
    state = te.TorchState(model, opt, sampler=sampler, batch=0, epoch=0)
    _train(model, opt, sampler, 2, 0)
    state.batch = 2
    state.save()            # commit() without the host-update poll
    committed = _snapshot(state)
    _train(model, opt, sampler, 3, 2)
    state.batch, state.epoch = 5, 1
    mutated = _snapshot(state)
    state.restore()
    return committed, mutated, _snapshot(state)


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def test_torch_state_matches_reference():
    got = _torch_state_round_trip(tte, TSampler)
    want = _torch_state_round_trip(jte, JSampler)
    assert _same(got, want)
    committed, mutated, restored = got
    assert _same(restored, committed) and not _same(mutated, committed)


def test_torch_state_routes_assignments_through_handlers():
    model, opt = _model_and_opt()
    state = tte.TorchState(model, opt, batch=0)
    other, _ = _model_and_opt()
    with torch.no_grad():
        other[0].weight.add_(1.0)
    state.model = other        # set_value: the handler now saves `other`
    saved = copy.deepcopy(other.state_dict())
    with torch.no_grad():
        other[0].weight.zero_()
    state.restore()
    assert _same(other.state_dict(), saved) and state.model is other
    assert set(state._handlers) == {"model", "optimizer"}


def test_distributed_optimizer_wrapper_takes_the_optimizer_handler():
    thvd.init(device="cpu")
    try:
        model, opt = _model_and_opt()
        dopt = thvd.DistributedOptimizer(opt)
        state = tte.TorchState(model, dopt, batch=0)
        assert isinstance(state._handlers["optimizer"],
                          tte.OptimizerStateHandler)
        _train(model, dopt, TSampler(8, rank=0, size=1), 1, 0)
        state.save()
        saved = copy.deepcopy(opt.state_dict())
        _train(model, dopt, TSampler(8, rank=0, size=1), 2, 1)
        state.restore()
        assert _same(opt.state_dict(), saved)
    finally:
        thvd.shutdown()


def test_torch_state_path_resumes_a_fresh_state(tmp_path):
    path = str(tmp_path / "state.pt")
    model, opt = _model_and_opt()
    sampler = TSampler(64, rank=0, size=1)
    state = tte.TorchState(model, opt, sampler=sampler, batch=0, epoch=0,
                           path=path)
    assert state.restored_from is None
    _train(model, opt, sampler, 3, 0)
    state.batch = 3
    state.commit()
    committed = _snapshot(state)
    # A respawned worker builds everything afresh and finds the commit.
    model2, opt2 = _model_and_opt()
    state2 = tte.TorchState(model2, opt2,
                            sampler=TSampler(64, rank=0, size=1), batch=0,
                            epoch=0, path=path)
    assert state2.restored_from == "disk"
    assert _same(_snapshot(state2), committed)


# -- the retry loop against the reference's ------------------------------------

def _run_script(elastic_mod, exc_mod, script):
    """Drive ``elastic_mod.run`` over a scripted train function; record
    every sync / restore / reset and what each entry saw."""
    events = []

    class Recorded(elastic_mod.ObjectState):
        def sync(self):
            events.append(("sync", self.batch))
            super().sync()

        def restore(self):
            events.append(("restore", self.batch))
            super().restore()

        def reset(self):
            events.append(("reset", self.batch))

    state = Recorded(batch=1)
    state.register_reset_callbacks([lambda: events.append(("callback",))])
    entries = iter(script)

    @elastic_mod.run
    def train(st):
        what, batch = next(entries)
        events.append(("enter", st.batch))
        st.batch = batch
        if what == "internal":
            raise exc_mod.HorovodInternalError("peer died")
        if what == "hosts":
            raise exc_mod.HostsUpdatedInterrupt(skip_sync=batch == 60)
        if what == "bug":
            raise ValueError("real bug")
        st.save()
        return st.batch

    try:
        result = train(state)
    except ValueError as e:
        result = repr(e)
    return events, result


SCRIPTS = {
    "internal_then_done": [("internal", 77), ("done", 5)],
    "hosts_then_done": [("hosts", 50), ("done", 51)],
    "hosts_skip_sync": [("hosts", 60), ("internal", 61), ("done", 62)],
    "bug": [("internal", 9), ("bug", 10)],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_run_matches_reference(name, monkeypatch):
    from horovod_tpu.common import exceptions as jexc
    from horovod_tpu_torch.common import exceptions as texc

    for k in ("HVDT_ELASTIC", "HVDT_RENDEZVOUS_ADDR", "HVDT_FAULT_PLAN"):
        monkeypatch.delenv(k, raising=False)
    jhvd.init()
    try:
        want = _run_script(jelastic, jexc, SCRIPTS[name])
    finally:
        jhvd.shutdown()
    thvd.init(device="cpu")
    try:
        got = _run_script(telastic, texc, SCRIPTS[name])
        assert thvd.is_initialized() and thvd.topology().device.type == "cpu"
    finally:
        thvd.shutdown()
    assert got == want


def test_run_restores_on_a_dist_error(monkeypatch):
    monkeypatch.delenv("HVDT_ELASTIC", raising=False)
    thvd.init(device="cpu")
    calls = []
    try:
        @telastic.run
        def train(state):
            calls.append(state.batch)
            if len(calls) == 1:
                state.batch = 99
                raise dist.DistBackendError("NCCL communicator aborted")
            return state.batch

        assert train(telastic.ObjectState(batch=4)) == 4
        assert calls == [4, 4]
    finally:
        thvd.shutdown()


# -- TensorState -----------------------------------------------------------------

def test_tensor_state_snapshot_restore_and_resume(tmp_path, monkeypatch):
    path = str(tmp_path / "t.pt")
    w = torch.arange(6.0).reshape(2, 3)
    tree = {"a": torch.ones(3), "b": [torch.zeros(2), torch.full((1,), 7.)]}
    s = telastic.TensorState(path=path, w=w, tree=tree, batch=0,
                             meta={"lr": 0.1})
    assert s.restored_from is None
    assert s._saved["w"].device.type == "cpu"
    assert s._saved["w"].data_ptr() != w.data_ptr()     # a host copy
    with torch.no_grad():
        w.add_(1.0)
        tree["b"][1].fill_(0.0)
    s.batch, s.meta = 5, {"lr": 0.2}
    s.restore()
    assert s.w is w and torch.equal(w, torch.arange(6.0).reshape(2, 3))
    assert tree["b"][1].item() == 7.0 and s.tree is tree
    assert s.batch == 0 and s.meta == {"lr": 0.1}
    # A resized leaf cannot be written in place: a new tensor comes back.
    s.w = torch.zeros(4)
    s.restore()
    assert s.w.shape == (2, 3)
    # commit persists; a fresh state (a respawned worker) resumes.
    with torch.no_grad():
        w.mul_(2.0)
    s.w, s.batch = w, 3
    s.commit()
    fresh = telastic.TensorState(path=path, w=torch.zeros(2, 3),
                                 tree={"a": torch.zeros(3),
                                       "b": [torch.zeros(2),
                                             torch.zeros(1)]},
                                 batch=0, meta=None)
    assert fresh.restored_from == "disk" and fresh.batch == 3
    assert torch.equal(fresh.w, w) and fresh.tree["b"][1].item() == 7.0
    # The peer tier needs the launcher's rendezvous KV: without it the
    # store is off (as in the reference) and the disk commit serves.
    monkeypatch.setenv("HVDT_PEER_STORE", "1")
    monkeypatch.delenv("HVDT_RENDEZVOUS_ADDR", raising=False)
    again = telastic.TensorState(path=path, w=torch.zeros(2, 3))
    assert again.restored_from == "disk"


def test_tensor_state_sync_in_a_world_of_one():
    thvd.init(device="cpu")
    try:
        s = telastic.TensorState(w=torch.ones(3), step=np.int64(2))
        s.w.add_(1.0)
        s.sync()
        assert torch.equal(s.w, torch.full((3,), 2.0)) and s.step == 2
        assert torch.equal(s._saved["w"], s.w)
    finally:
        thvd.shutdown()


def test_elastic_is_reachable_from_the_package_roots():
    import horovod_tpu_torch.interop.torch as ti

    assert thvd.elastic is telastic
    assert ti.elastic is tte and ti.TorchState is tte.TorchState
    assert tte.run is telastic.run


# -- worker notification ------------------------------------------------------------

def test_worker_notification_matches_reference():
    server = tkv.RendezvousServer(addr="127.0.0.1")
    port = server.start()
    try:
        def managers(mod, kv):
            client = kv.KVClient("127.0.0.1", port, server.secret)
            m = mod.WorkerNotificationManager(client=client, generation=2)
            m.init()
            return m

        from horovod_tpu.runner import http_kv as jkv

        server.put_local("/rendezvous/2/pending_base", b"1")
        pair = [managers(tworker, tkv), managers(jworker, jkv)]
        out = [[], []]
        script = [("/rendezvous/version", b"2"), ("/rendezvous/pending", b"1"),
                  ("/rendezvous/pending", b"2"), None,
                  ("/rendezvous/version", b"3"), None]
        for step in script:
            if step is not None:
                server.put_local(*step)
            for i, m in enumerate(pair):
                try:
                    m.check_for_updates()
                    out[i].append("none")
                except (HostsUpdatedInterrupt, jhvd.HostsUpdatedInterrupt):
                    out[i].append("interrupt")
        assert out[0] == out[1]
        assert out[0].count("interrupt") == 2
    finally:
        server.stop()


def test_commit_outside_the_launcher_raises_nothing(monkeypatch):
    monkeypatch.delenv("HVDT_RENDEZVOUS_ADDR", raising=False)
    s = telastic.ObjectState(batch=1)
    s.commit()
    assert s._saved == {"batch": 1}
    with pytest.raises(HorovodInternalError):
        monkeypatch.setenv("HVDT_FAULT_PLAN", "exc@step=1")
        s.commit()
