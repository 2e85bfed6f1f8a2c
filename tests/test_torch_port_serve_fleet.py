"""PyTorch port, the serving fleet against the JAX package's: the serving
fault kinds, the batcher's deadline watchdog, graceful drain, the replica
registrar, the router, the autoscale policy and ``ServeDriver``.

The reference's ``tests/test_serve_elastic.py`` cases on the port's
classes (MLP replicas on the CPU, in process), plus what crosses the
packages: the fault grammar and its firing schedule under one seed, the
autoscale policy's decisions on the same heartbeats, and a reference
router in front of a port replica through one rendezvous KV (the
heartbeat document and the /predict JSON are the same).
"""

import http.client
import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from horovod_tpu.resilience import faults as jfaults
from horovod_tpu.runner import http_kv as jkv
from horovod_tpu.serve import autoscale as jautoscale
from horovod_tpu.serve import router as jrouter
from horovod_tpu_torch.models.mlp import mlp_apply, mlp_init
from horovod_tpu_torch.resilience import faults
from horovod_tpu_torch.resilience.faults import parse_plan
from horovod_tpu_torch.resilience.preempt import PREEMPT_EXIT_CODE
from horovod_tpu_torch.runner.http_kv import KVClient, RendezvousServer
from horovod_tpu_torch.serve import (DispatcherDied, DynamicBatcher,
                                     InferenceEngine, ModelServer,
                                     RequestDeadlineExceeded)
from horovod_tpu_torch.serve.autoscale import (AutoscalePolicy, ServeDriver,
                                               TARGET_KV_KEY,
                                               localhost_host_manager)
from horovod_tpu_torch.serve.replica import (DRAIN_KV_PREFIX,
                                             REPLICA_KV_PREFIX,
                                             ReplicaRegistrar)
from horovod_tpu_torch.serve.router import Router

SIZES = (6, 16, 3)


@pytest.fixture(scope="module")
def params():
    return mlp_init(0, SIZES, device="cpu")


@pytest.fixture()
def kv_server():
    server = RendezvousServer(addr="127.0.0.1")
    server.start()
    yield server
    server.stop()


def _kv_client(server) -> KVClient:
    return KVClient("127.0.0.1", server.port, server.secret, timeout=5.0)


def _post(port, doc, timeout=30, path="/predict", headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, json.dumps(doc),
                     {"Content-Type": "application/json", **(headers or {})})
        r = conn.getresponse()
        return r.status, json.loads(r.read()), dict(r.getheaders())
    finally:
        conn.close()


def _get(port, route, timeout=10):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", route)
        r = conn.getresponse()
        return r.status, r.read().decode()
    finally:
        conn.close()


def _row():
    return [0.5] * SIZES[0]


def _wait_until(cond, why, timeout=10.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(interval)
    pytest.fail(why)


# ---- the serving fault kinds ---------------------------------------------

_PLAN = ("serve_crash@step=40:rank=2,slow_replica@p=0.1:secs=2,"
         "slow_replica@p=1.0:secs=1:point=serve.dispatch,"
         "traffic_spike@step=20:rps=300:secs=120")


def test_serve_plan_parses_as_reference():
    got = [vars(s) for s in parse_plan(_PLAN)]
    want = [vars(s) for s in jfaults.parse_plan(_PLAN)]
    assert got == want
    assert [s["point"] for s in got] == ["serve.predict", "serve.predict",
                                         "serve.dispatch", "serve.traffic"]
    with pytest.raises(ValueError, match="serve_crash"):
        parse_plan("banana@step=1")


@pytest.mark.parametrize("kind", ["serve_crash", "slow_replica",
                                  "traffic_spike"])
def test_serving_kinds_fire_as_reference(kind):
    """Each kind fires at its default point as the reference's does: the
    same exits, sleeps and spike windows over the same schedule."""
    plan = {"serve_crash": "serve_crash@step=3:rank=1",
            "slow_replica": "slow_replica@p=0.5:secs=2",
            "traffic_spike": "traffic_spike@step=2:rps=300:secs=30"}[kind]

    def run(mod):
        exits, naps = [], []
        inj = mod.FaultInjector(mod.parse_plan(plan), seed=7,
                                sleep_fn=naps.append, exit_fn=exits.append)
        point = mod._DEFAULT_POINT[kind]
        rps = []
        for seq in range(1, 41):
            for rank in (0, 1):
                inj.fire(point, step=seq, rank=rank, now=100.0)
            rps.append(inj.extra_rps(now=100.0 + seq))
        return exits, naps, rps, dict(inj.counters)

    got, want = run(faults), run(jfaults)
    assert got == want
    exits, naps, rps, counters = got
    if kind == "serve_crash":
        assert exits == [1] and counters == {"serve_crash": 1}
    elif kind == "slow_replica":
        assert 10 < len(naps) < 70 and set(naps) == {2.0}
    else:
        assert (rps[0], rps[1], rps[-1]) == (0.0, 300.0, 0.0)


def test_predict_path_fires_injection_point(params, monkeypatch):
    monkeypatch.setenv("HVDT_FAULT_PLAN", "slow_replica@p=1.0:secs=0.0")
    inj = faults.get_injector()
    assert inj is not None
    server = ModelServer(InferenceEngine(mlp_apply, params, buckets=(1, 4)),
                         port=0)
    port = server.start()
    try:
        assert _post(port, {"inputs": [_row()]})[0] == 200
        assert inj.counters.get("slow_replica", 0) >= 1
    finally:
        server.stop()


# ---- the batcher's deadline watchdog and liveness ------------------------

def test_queued_request_fails_fast_when_dispatch_wedges():
    release = threading.Event()

    def wedged_infer(x):
        release.wait(10.0)
        return x

    b = DynamicBatcher(wedged_infer, max_batch_size=1, max_delay_ms=0.0,
                       max_queue_depth=64, deadline_s=0.3)
    try:
        f1 = b.submit(np.zeros((1, 4), np.float32))
        time.sleep(0.05)
        f2 = b.submit(np.zeros((1, 4), np.float32))
        with pytest.raises(RequestDeadlineExceeded):
            f2.result(timeout=2.0)
        assert b.metrics.get("serve_deadline_expired_total").total() >= 1
    finally:
        release.set()
        f1.result(timeout=5.0)
        b.close()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_dispatch_thread_death_fails_future_and_submit():
    def lethal_infer(x):
        raise SystemExit("engine took the thread down")

    b = DynamicBatcher(lethal_infer, max_batch_size=4, max_delay_ms=0.0,
                       max_queue_depth=64)
    f = b.submit(np.zeros((1, 4), np.float32))
    with pytest.raises(DispatcherDied):
        f.result(timeout=5.0)
    _wait_until(lambda: not b._thread.is_alive(),
                "dispatch thread survived SystemExit")
    with pytest.raises(DispatcherDied):
        b.submit(np.zeros((1, 4), np.float32))


def test_fail_pending_abandonment_is_typed():
    release = threading.Event()

    def slow_infer(x):
        release.wait(10.0)
        return x

    b = DynamicBatcher(slow_infer, max_batch_size=1, max_delay_ms=0.0,
                       max_queue_depth=64, deadline_s=30.0)
    try:
        f1 = b.submit(np.zeros((1, 4), np.float32))
        time.sleep(0.05)
        f2 = b.submit(np.zeros((1, 4), np.float32))
        assert b.fail_pending() == 1
        with pytest.raises(DispatcherDied):
            f2.result(timeout=1.0)
    finally:
        release.set()
        f1.result(timeout=5.0)
        b.close()


# ---- graceful drain ------------------------------------------------------

def _server(params, **kw):
    server = ModelServer(InferenceEngine(mlp_apply, params, buckets=(1, 4)),
                         port=0, **kw)
    server.engine.warmup((SIZES[0],))
    return server


def test_healthz_flips_and_predict_sheds_503(params):
    server = _server(params)
    port = server.start()
    try:
        assert json.loads(_get(port, "/healthz")[1])["status"] == "ok"
        server._draining.set()
        assert json.loads(_get(port, "/healthz")[1])["status"] == "draining"
        status, doc, headers = _post(port, {"inputs": [_row()]})
        assert status == 503 and doc == {"error": "replica draining"}
        assert headers.get("Retry-After") == "1"
    finally:
        server.stop()


def test_sigterm_installs_drain_flag(params):
    server = _server(params)
    server.start()
    try:
        server.install_drain_handlers()
        assert not server.draining
        signal.raise_signal(signal.SIGTERM)
        _wait_until(lambda: server.draining,
                    "SIGTERM did not set the drain flag")
    finally:
        server.uninstall_drain_handlers()
        server.stop()


def test_inflight_completes_before_socket_close(params):
    server = _server(params)
    orig = server.batcher._infer

    def slow_infer(x):
        time.sleep(0.4)
        return orig(x)

    server.batcher._infer = slow_infer
    port = server.start()
    result = {}
    t = threading.Thread(target=lambda: result.setdefault(
        "resp", _post(port, {"inputs": [_row()]})))
    t.start()
    time.sleep(0.1)
    t0 = time.monotonic()
    server.stop()
    t.join(timeout=10)
    assert result["resp"][0] == 200
    assert time.monotonic() - t0 >= 0.15


def test_zero_connection_resets_during_drain(params):
    """Sustained client fire across a drain sees only 200s and
    503 + Retry-After — never a reset."""
    server = _server(params)
    port = server.start()
    stop = threading.Event()
    statuses, resets = [], []

    def client():
        while not stop.is_set():
            try:
                status, _doc, headers = _post(port, {"inputs": [_row()]},
                                              timeout=10)
                statuses.append(status)
                if status == 503:
                    assert headers.get("Retry-After") == "1"
            except (ConnectionResetError, BrokenPipeError,
                    http.client.RemoteDisconnected) as e:
                resets.append(repr(e))
                return
            except OSError:
                return

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.4)
    assert server.drain(timeout=10.0) is True
    time.sleep(0.3)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    server.stop()
    assert not resets, f"connection resets during drain: {resets}"
    assert statuses.count(200) > 0
    assert set(statuses) <= {200, 503} and 503 in statuses


# ---- the replica registrar -----------------------------------------------

def test_heartbeat_carries_load_and_latency(params, kv_server):
    server = ModelServer(InferenceEngine(mlp_apply, params, buckets=(1, 4)),
                         port=0)
    port = server.start()
    reg = ReplicaRegistrar(_kv_client(kv_server), 7, "127.0.0.1", port,
                           server=server, heartbeat_s=0.3)
    try:
        reg.start()
        _post(port, {"inputs": [_row()]})
        _wait_until(lambda: reg.beats >= 3, "no heartbeats")
        doc = json.loads(kv_server.get_local(f"{REPLICA_KV_PREFIX}7"))
        assert doc["id"] == 7 and doc["port"] == port
        assert doc["draining"] is False and doc["engine"] == "static"
        assert doc["requests_total"] >= 1 and doc["model_version"] == 0
        assert "queue_depth" in doc and "ts" in doc
        assert doc.get("p99_ms") is not None
    finally:
        reg.deregister()
        server.stop()
    assert kv_server.get_local(f"{REPLICA_KV_PREFIX}7") is None


def test_drain_key_fires_callback_once(kv_server):
    fired = []
    reg = ReplicaRegistrar(_kv_client(kv_server), 3, "127.0.0.1", 1,
                           heartbeat_s=0.2, on_drain=lambda: fired.append(1))
    reg.start()
    try:
        assert not reg.drain_requested()
        kv_server.put_local(f"{DRAIN_KV_PREFIX}3", b"drain")
        _wait_until(lambda: fired, "drain callback never fired")
        time.sleep(0.4)
        assert fired == [1]
    finally:
        reg.deregister()


# ---- the router ----------------------------------------------------------

class _InProcReplica:
    """A real port ModelServer + registrar, in process."""

    def __init__(self, kv_server, rid, params, heartbeat_s=0.3):
        self.server = ModelServer(
            InferenceEngine(mlp_apply, params, buckets=(1, 4)), port=0)
        self.server.engine.warmup((SIZES[0],))
        self.port = self.server.start()
        self.reg = ReplicaRegistrar(_kv_client(kv_server), rid, "127.0.0.1",
                                    self.port, server=self.server,
                                    heartbeat_s=heartbeat_s)
        self.reg.start()

    def crash(self):
        """Abrupt death: socket gone, heartbeats stop, no goodbye."""
        self.reg._stop.set()
        self.server._httpd.shutdown()
        self.server._httpd.server_close()
        self.server._httpd = None

    def stop(self):
        self.reg.deregister()
        self.server.stop()


@pytest.mark.parametrize("router_mod", [None, jrouter],
                         ids=["port_router", "reference_router"])
def test_router_discovers_and_routes_a_port_replica(params, router_mod):
    """The port's router, and the reference's, in front of a port replica
    through one rendezvous KV server (the reference's for the reference
    router): discovery, routing and the replica tag."""
    kv = (jkv.RendezvousServer(addr="127.0.0.1") if router_mod
          else RendezvousServer(addr="127.0.0.1"))
    kv.start()
    rep = _InProcReplica(kv, 0, params)
    router = (router_mod or __import__(
        "horovod_tpu_torch.serve.router", fromlist=["Router"])).Router(
        kv, port=0, heartbeat_s=0.3, probe=False)
    try:
        rport = router.start()
        _wait_until(lambda: router._routable(), "no routable replica")
        status, doc, headers = _post(rport, {"inputs": [_row()]})
        assert status == 200 and len(doc["outputs"]) == 1
        assert doc["model_version"] == 0
        x = torch.tensor([_row()])
        with torch.no_grad():
            want = mlp_apply(params, x).numpy()
        np.testing.assert_allclose(doc["outputs"], want, rtol=1e-6)
        assert headers.get("X-HVDT-Replica") == "0"
        assert json.loads(_get(rport, "/healthz")[1])["routable"] == [0]
        assert "hvdt_router_requests_total" in _get(rport, "/metrics")[1]
    finally:
        router.stop()
        rep.stop()
        kv.stop()


def test_no_replica_is_clean_503(kv_server):
    router = Router(kv_server, port=0, heartbeat_s=0.2,
                    request_timeout_s=0.5, probe=False)
    try:
        rport = router.start()
        status, doc, headers = _post(rport, {"inputs": [_row()]}, timeout=10)
        assert status == 503 and headers.get("Retry-After") == "1"
    finally:
        router.stop()


def test_replica_crash_mid_load_drops_zero_requests(params, kv_server):
    reps = [_InProcReplica(kv_server, i, params) for i in (0, 1)]
    router = Router(kv_server, port=0, heartbeat_s=0.3, eject_cooldown_s=5.0,
                    hedge_ms=-1.0, probe=False)
    statuses, lock = [], threading.Lock()
    try:
        rport = router.start()
        _wait_until(lambda: len(router._routable()) == 2,
                    "both replicas never became routable")

        def client():
            for _ in range(30):
                status, _d, _h = _post(rport, {"inputs": [_row()]},
                                       timeout=30)
                with lock:
                    statuses.append(status)
                time.sleep(0.005)

        threads = [threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.2)
        reps[0].crash()
        for t in threads:
            t.join(timeout=60)
        assert statuses.count(200) == len(statuses) == 120, [
            s for s in statuses if s != 200]
        assert router.metrics.get("hvdt_router_ejections_total").total() >= 1
        _wait_until(lambda: [v.id for v in router._routable()] == [1],
                    "dead replica never aged out of routing", timeout=5.0)
    finally:
        router.stop()
        reps[1].stop()


def test_slo_breach_ejects_and_cooldown_readmits(kv_server):
    router = Router(kv_server, port=0, heartbeat_s=30.0, slo_p99_ms=100.0,
                    eject_cooldown_s=0.4, probe=False)

    def beat(p99):
        kv_server.put_local(f"{REPLICA_KV_PREFIX}5", json.dumps({
            "id": 5, "host": "127.0.0.1", "port": 1, "ts": time.time(),
            "p99_ms": p99, "queue_depth": 0}).encode())

    beat(20.0)
    router.refresh()
    assert [v.id for v in router._routable()] == [5]
    beat(500.0)
    router.refresh()
    assert router._routable() == []
    assert router.metrics.get("hvdt_router_ejections_total").value(
        reason="slo", tenant="control") == 1
    time.sleep(0.5)
    beat(20.0)
    router.refresh()
    assert [v.id for v in router._routable()] == [5]
    assert router.metrics.get("hvdt_router_readmissions_total").total() == 1


def test_missed_heartbeat_and_drained_leave(kv_server):
    """A stale heartbeat is an ejection event; a drained replica that
    deregisters is not."""
    router = Router(kv_server, port=0, heartbeat_s=0.2, probe=False)
    kv_server.put_local(f"{REPLICA_KV_PREFIX}9", json.dumps({
        "id": 9, "host": "127.0.0.1", "port": 1,
        "ts": time.time()}).encode())
    key = f"{REPLICA_KV_PREFIX}4"
    kv_server.put_local(key, json.dumps({
        "id": 4, "host": "127.0.0.1", "port": 1, "ts": time.time(),
        "draining": True}).encode())
    router.refresh()
    assert [v.id for v in router._routable()] == [9]
    with kv_server.lock:
        kv_server.store.pop(key)
    router.refresh()
    ejections = router.metrics.get("hvdt_router_ejections_total")
    assert ejections.total() == 0
    time.sleep(0.5)
    router.refresh()
    assert router._routable() == []
    assert ejections.value(reason="heartbeat", tenant="control") == 1


def test_hedge_duplicates_slow_primary(params, kv_server):
    slow = _InProcReplica(kv_server, 0, params)
    fast = _InProcReplica(kv_server, 1, params)
    orig = slow.server.batcher._infer

    def molasses(x):
        time.sleep(0.8)
        return orig(x)

    slow.server.batcher._infer = molasses
    router = Router(kv_server, port=0, heartbeat_s=0.3, hedge_ms=100.0,
                    probe=False)
    try:
        router.start()
        _wait_until(lambda: len(router._routable()) == 2,
                    "replicas never routable")
        view = next(v for v in router._routable() if v.id == 0)
        body = json.dumps({"inputs": [_row()]}).encode()
        t0 = time.perf_counter()
        status, payload, rid = router._forward_hedged(view, body, 10.0)
        assert status == 200 and rid == 1
        assert time.perf_counter() - t0 < 0.7
        assert router.metrics.get("hvdt_router_hedges_total").total() == 1
        assert router.metrics.get("hvdt_router_hedge_wins_total").total() \
            == 1
    finally:
        router.stop()
        fast.stop()
        slow.server.batcher._infer = orig
        slow.stop()


# ---- the autoscale policy ------------------------------------------------

def _snap(rid, queue=0.0, p99=None, draining=False):
    d = {"id": rid, "queue_depth": queue, "draining": draining}
    if p99 is not None:
        d["p99_ms"] = p99
    return rid, d


# (kwargs, [(clock, current, snapshots, want)]) — the reference's cases.
_POLICY_CASES = {
    "queue_up": ({}, [(0.0, 1, [_snap(0, queue=20.0)], 2)]),
    "p99_up": ({"slo_p99_ms": 250.0},
               [(0.0, 1, [_snap(0, queue=0.0, p99=900.0)], 2)]),
    "idle_down": ({"slo_p99_ms": 250.0},
                  [(0.0, 3, [_snap(0, p99=10.0), _snap(1, p99=12.0)], 2)]),
    "p99_warm_holds": ({"slo_p99_ms": 250.0},
                       [(0.0, 2, [_snap(0, p99=200.0)], 2)]),
    "cooldown": ({}, [(0.0, 1, [_snap(0, queue=20.0)], 2),
                      (5.0, 2, [_snap(0, queue=20.0)], 2),
                      (11.0, 2, [_snap(0, queue=20.0)], 3)]),
    "clamped": ({"max_replicas": 2},
                [(0.0, 2, [_snap(0, queue=100.0)], 2),
                 (0.0, 7, [_snap(0, queue=100.0)], 2),
                 (100.0, 1, [_snap(0)], 1)]),
    "draining_ignored": ({}, [(0.0, 2, [_snap(0, queue=50.0, draining=True),
                                        _snap(1, queue=2.0)], 2)]),
    "no_snapshots": ({}, [(0.0, 2, [], 2)]),
}


@pytest.mark.parametrize("case", list(_POLICY_CASES))
def test_autoscale_policy_matches_reference(case):
    kw, steps = _POLICY_CASES[case]
    kw = {"max_replicas": 4, "queue_hi": 8.0, "queue_lo": 1.0,
          "cooldown_s": 10.0, **kw}
    now = [0.0]
    got = AutoscalePolicy(clock=lambda: now[0], **kw)
    want = jautoscale.AutoscalePolicy(clock=lambda: now[0], **kw)
    for clock, current, snaps, expect in steps:
        now[0] = clock
        snaps = dict(snaps)
        assert got.decide(current, snaps) == want.decide(current, snaps) \
            == expect
        assert got.last_reason == want.last_reason


# ---- ServeDriver ---------------------------------------------------------

class _FakeFleet:
    """In-process replica "processes": each spawn heartbeats and polls its
    drain key, as run_replica does, without HTTP or a model."""

    def __init__(self, kv):
        self.kv = kv
        self.stops, self.exit_codes = {}, {}
        self.queue_depth = 0.0
        self.spawned = []

    def spawn(self, slot, rid):
        self.spawned.append((rid, slot.hostname, slot.local_rank))
        ev = self.stops[rid] = threading.Event()
        key = f"{REPLICA_KV_PREFIX}{rid}"
        while True:
            self.kv.put_local(key, json.dumps({
                "id": rid, "host": slot.hostname, "port": 1,
                "ts": time.time(), "queue_depth": self.queue_depth,
                "p99_ms": 10.0, "draining": False}).encode())
            if self.kv.get_local(f"{DRAIN_KV_PREFIX}{rid}") is not None:
                return PREEMPT_EXIT_CODE
            if ev.wait(0.05):
                return self.exit_codes.get(rid, 1)

    def kill(self, rid, code=1):
        self.exit_codes[rid] = code
        self.stops[rid].set()


def _driver(kv, fleet, **kw):
    kw.setdefault("replicas", 1)
    kw.setdefault("max_replicas", 3)
    kw.setdefault("interval", 0.05)
    return ServeDriver(kv, fleet.spawn, **kw)


def test_scale_up_and_graceful_scale_down(kv_server):
    fleet = _FakeFleet(kv_server)
    driver = _driver(kv_server, fleet)
    try:
        driver.start()
        _wait_until(lambda: len(driver.live_replicas()) == 1,
                    "initial replica never spawned")
        driver.set_target(3, reason="test")
        _wait_until(lambda: len(driver.live_replicas()) == 3
                    and len(fleet.spawned) == 3,
                    "scale-up to 3 never converged")
        # One card a replica: the slots' local ranks are distinct.
        assert sorted(lr for _, _, lr in fleet.spawned) == [0, 1, 2]
        driver.set_target(2, reason="test")
        _wait_until(lambda: len(driver.live_replicas()) == 2,
                    "scale-down to 2 never converged")
        assert driver.removal_events == 0
        assert any("scaling 1 -> 3" in e for e in driver.scale_events)
        assert any("scaling 3 -> 2" in e for e in driver.scale_events)
    finally:
        driver.stop(drain=True, timeout=5)


def test_crash_is_one_removal_event_and_respawn_on_its_card(kv_server,
                                                           monkeypatch):
    """A crashed replica is one removal event; after the host's cooldown
    the replacement takes the card the crashed replica left (its local
    rank), never a live replica's; the stale records are scrubbed and a
    drain tombstone fences the id."""
    monkeypatch.setenv("HVDT_ELASTIC_BLACKLIST_COOLDOWN_S", "0.3")
    fleet = _FakeFleet(kv_server)
    driver = _driver(kv_server, fleet, replicas=2)
    try:
        driver.start()
        _wait_until(lambda: len(driver.live_replicas()) == 2,
                    "fleet never reached 2")
        victim = driver.live_replicas()[0]
        victim_card = next(lr for r, _, lr in fleet.spawned if r == victim)
        fleet.kill(victim, code=1)
        _wait_until(lambda: driver.removal_events == 1,
                    "crash never became a removal event")
        assert kv_server.get_local(f"{DRAIN_KV_PREFIX}{victim}") == b"fence"
        _wait_until(lambda: len(driver.live_replicas()) == 2
                    and len(fleet.spawned) == 3,
                    "replacement never spawned after cooldown", timeout=10.0)
        assert victim not in driver.live_replicas()
        assert driver.removal_events == 1
        assert fleet.spawned[-1][2] == victim_card
        assert kv_server.get_local(f"{REPLICA_KV_PREFIX}{victim}") is None
    finally:
        driver.stop(drain=True, timeout=5)


def test_preempt_exit_drains_pod_from_placement(kv_server):
    fleet = _FakeFleet(kv_server)
    driver = _driver(kv_server, fleet, replicas=1)
    try:
        driver.start()
        _wait_until(lambda: len(driver.live_replicas()) == 1,
                    "replica never spawned")
        rid = driver.live_replicas()[0]
        fleet.kill(rid, code=PREEMPT_EXIT_CODE)
        _wait_until(lambda: rid not in driver.live_replicas(),
                    "preempted replica never removed")
        assert driver.removal_events == 0
        time.sleep(0.3)
        assert driver._free_slot() is None
    finally:
        driver.stop(drain=False)


@pytest.mark.parametrize("channel", ["kv_raw", "kv_doc", "target_file"])
def test_target_overrides(kv_server, tmp_path, channel):
    fleet = _FakeFleet(kv_server)
    target = os.path.join(tmp_path, "target")
    driver = _driver(kv_server, fleet, replicas=1,
                     target_file=target if channel == "target_file"
                     else None)
    try:
        driver.start()
        _wait_until(lambda: len(driver.live_replicas()) == 1,
                    "initial replica never spawned")
        if channel == "kv_raw":
            kv_server.put_local(TARGET_KV_KEY, b"3")
        elif channel == "kv_doc":
            kv_server.put_local(TARGET_KV_KEY, json.dumps(
                {"target": 3, "seq": 4, "writer": "fleet"}).encode())
        else:
            with open(target, "w") as f:
                f.write("3\n")
        _wait_until(lambda: len(driver.live_replicas()) == 3,
                    "override never adopted")
        assert driver.last_target_writer == (
            "fleet" if channel == "kv_doc" else "operator")
        assert driver.last_target_seq == (4 if channel == "kv_doc"
                                          else None)
    finally:
        driver.stop(drain=True, timeout=5)


def test_autoscale_loop_scales_on_queue_then_idles_down(kv_server):
    fleet = _FakeFleet(kv_server)
    fleet.queue_depth = 50.0
    driver = _driver(kv_server, fleet, replicas=1, autoscale=True,
                     policy=AutoscalePolicy(max_replicas=3, queue_hi=8.0,
                                            queue_lo=1.0, cooldown_s=0.1))
    try:
        driver.start()
        _wait_until(lambda: len(driver.live_replicas()) == 3,
                    "autoscaler never scaled to max under load", timeout=10)
        fleet.queue_depth = 0.0
        _wait_until(lambda: len(driver.live_replicas()) == 1,
                    "autoscaler never idled back down", timeout=10)
        assert driver.removal_events == 0
    finally:
        driver.stop(drain=True, timeout=5)


# ---- the CLI wiring ------------------------------------------------------

def test_serve_cli_flags_parse_as_reference():
    from horovod_tpu.serve.__main__ import parse_args as jparse
    from horovod_tpu.serve.__main__ import strip_control_flags as jstrip
    from horovod_tpu_torch.serve.__main__ import (parse_args,
                                                  strip_control_flags)

    argv = ["--checkpoint", "/c", "--replicas", "3", "--autoscale",
            "--slo-p99-ms", "250", "--max-replicas", "5", "--router-port",
            "0", "--model", "mlp", "--mlp-sizes", "6,16,3",
            "--target-file", "/t", "--buckets", "1,4"]
    got = vars(parse_args(argv + ["--device", "cpu"]))
    assert got.pop("device") == "cpu"
    assert got == vars(jparse(argv))
    assert strip_control_flags(argv) == jstrip(argv) == [
        "--checkpoint", "/c", "--model", "mlp", "--mlp-sizes", "6,16,3",
        "--buckets", "1,4"]


def test_localhost_host_manager_slots():
    hm = localhost_host_manager(3)
    hm.update_available_hosts()
    assert hm.current.available_slots == 3


def test_replica_picks_its_card_from_the_slot(monkeypatch, tmp_path):
    """run_replica without --device serves on cuda:<HVDT_LOCAL_RANK>
    (the slot's env): the engine asks for that card."""
    from horovod_tpu_torch.serve import replica
    from horovod_tpu_torch.serve.__main__ import parse_args

    seen = []

    def fake_build(args):
        seen.append(args.device)
        raise RuntimeError("stop here")

    monkeypatch.setenv("HVDT_LOCAL_RANK", "2")
    monkeypatch.setattr("horovod_tpu_torch.serve.__main__.build_server",
                        fake_build)
    with pytest.raises(RuntimeError, match="stop here"):
        replica.run_replica(parse_args(["--checkpoint", str(tmp_path)]))
    assert seen == ["cuda:2"]
