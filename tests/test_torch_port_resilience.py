"""PyTorch port: the resilience primitives (horovod_tpu_torch/resilience/)
against the JAX package's on the same inputs, and the fault points the
port threads through its own code.

* ``faults.parse_plan`` over the grammar (rank sets, point overrides,
  times, probabilities) and its refusals; the fired sequence of a seeded
  plan (``kv_drop@p=`` under ``HVDT_FAULT_SEED``, step and rank matches,
  hang sleeps, crash exits); ``times`` across a fired-fault journal, one
  package reading the other's; the serving kinds parse and raise when
  fired; ``instrument`` is the identity without a plan.
* ``Backoff`` delays with a seeded jitter and a deadline, ``retry``'s
  calls, callbacks and exhaustion.
* ``PreemptionGuard`` in a subprocess: SIGTERM runs the emergency save
  and the process exits with 83.
* ``request_elastic_reset`` posts the READY the reference's driver reads
  from a port ``RendezvousServer``.
* The recovery ledger: ``charge_phase`` against the reference's
  ``GoodputLedger``; None with telemetry off.
* The fault points: ``checkpoint.write`` (``slow_disk``) and
  ``checkpoint.save`` (``corrupt_ckpt``, both modes) on the port's
  ``CheckpointManager``; ``tcp.connect`` on the eager control plane's
  connect; the bench leg's chaos-audit mode.
"""

import importlib
import os
import random
import signal
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from horovod_tpu.resilience import faults as jfaults
from horovod_tpu.runner.elastic import discovery as jdisc
from horovod_tpu.runner.elastic import driver as jdriver
from horovod_tpu.runner.hosts import HostInfo
from horovod_tpu.telemetry import metrics as jmetrics
from horovod_tpu.telemetry import step_stats as jstats
from horovod_tpu_torch import checkpoint as tck
from horovod_tpu_torch.resilience import escalation as tesc
from horovod_tpu_torch.resilience import faults as tfaults
from horovod_tpu_torch.runner import http_kv as tkv
from horovod_tpu_torch.telemetry import metrics as tmetrics
from horovod_tpu_torch.telemetry import step_stats as tstats

# The modules, not the ``retry`` function their packages re-export.
jretry = importlib.import_module("horovod_tpu.resilience.retry")
tretry = importlib.import_module("horovod_tpu_torch.resilience.retry")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_plan(monkeypatch):
    for k in ("HVDT_FAULT_PLAN", "HVDT_FAULT_SEED", "HVDT_FAULT_JOURNAL",
              "HVDT_RANK", "HVDT_POD", "HVDT_TELEMETRY"):
        monkeypatch.delenv(k, raising=False)
    yield
    tfaults.configure(None)
    jfaults.configure(None)


def _spec(s):
    return ({f: getattr(s, f) for f in s.__dataclass_fields__}, s.ranks)


PLANS = [
    "crash@step=12:rank=1,hang@step=30:secs=20,corrupt_ckpt@step=40,"
    "kv_drop@p=0.1",
    "crash@step=12:rank=1,3-5,hang@step=30",
    "exc@step=5:times=3:point=custom.point",
    "pod_crash@step=10:pod=podB,pod_partition@step=10:pod=podB:secs=20",
    "slow_disk@step=8:secs=5,corrupt_ckpt@step=9:mode=truncate_manifest",
    "serve_crash@step=40:rank=2,slow_replica@p=0.1:secs=2,"
    "traffic_spike@step=20:rps=300:secs=120",
    " , exc@step=1 ,, crash@code=7",
]


@pytest.mark.parametrize("plan", PLANS)
def test_parse_plan_matches_reference(plan):
    got = [_spec(s) for s in tfaults.parse_plan(plan)]
    assert got == [_spec(s) for s in jfaults.parse_plan(plan)]


BAD_PLANS = ["explode@step=1", "crash@step", "crash@steps=1",
             "crash@rank=3-1", "corrupt_ckpt@mode=shred", "crash@step=x"]


@pytest.mark.parametrize("plan", BAD_PLANS)
def test_bad_plans_raise_in_both(plan):
    for mod in (tfaults, jfaults):
        with pytest.raises(ValueError):
            mod.parse_plan(plan)


FIRES = ([("kv", None, 0)] * 12
         + [("step", s, r) for s in range(1, 9) for r in (0, 1)]
         + [("checkpoint.write", 4, 0), ("checkpoint.save", 4, 0)]
         + [("kv", None, 1)] * 12)


def _fire_sequence(mod, monkeypatch, journal=None):
    """Fire a seeded plan over FIRES; record what each fire did."""
    monkeypatch.setenv("HVDT_FAULT_PLAN",
                       "kv_drop@p=0.3,exc@step=5:rank=1,"
                       "hang@step=3:secs=2:times=2,crash@step=7:rank=0:code=9,"
                       "slow_disk@step=4:secs=0.5")
    monkeypatch.setenv("HVDT_FAULT_SEED", "1234")
    if journal:
        monkeypatch.setenv("HVDT_FAULT_JOURNAL", journal)
        monkeypatch.setenv("HVDT_RANK", "0")
    inj = mod.FaultInjector.from_env()
    actions = []
    inj._sleep = lambda s: actions.append(("sleep", s))
    inj._exit = lambda c: actions.append(("exit", c))
    out = []
    for point, step, rank in FIRES:
        n = len(actions)
        try:
            inj.fire(point, step=step, rank=rank)
            what = None
        except Exception as e:   # noqa: BLE001 - the outcome is compared
            what = type(e).__name__
        out.append((what, actions[n:]))
    return out, dict(inj.counters), [s.fired for s in inj.specs]


def test_seeded_fire_sequence_matches_reference(monkeypatch):
    got = _fire_sequence(tfaults, monkeypatch)
    want = _fire_sequence(jfaults, monkeypatch)
    assert got == want
    assert got[1]["kv_drop"] > 0 and got[1]["exc"] == 1


def test_times_across_a_journal_both_ways(tmp_path, monkeypatch):
    """The fired-fault journal makes ``times`` a per-job bound: a fresh
    injector (a respawned worker) of either package reads the journal
    the other wrote and does not fire a spent fault again."""
    for first, second in ((tfaults, jfaults), (jfaults, tfaults)):
        journal = str(tmp_path / f"j_{first.__name__.split('.')[0]}")
        _, _, fired1 = _fire_sequence(first, monkeypatch, journal)
        assert os.path.exists(journal + ".rank0")
        monkeypatch.setenv("HVDT_FAULT_JOURNAL", journal)
        inj = second.FaultInjector.from_env()
        assert [s.fired for s in inj.specs] == fired1
        inj._exit = lambda c: pytest.fail("a spent crash fired again")
        inj.fire("step", step=100, rank=0)
        assert inj.counters.get("crash", 0) == 0


@pytest.mark.parametrize("kind", ["serve_crash", "slow_replica",
                                  "traffic_spike"])
def test_serving_kinds_raise_when_fired(kind):
    """Each serving kind fires at its default point as the reference's
    does (the serving plane is ported): serve_crash exits with its code,
    slow_replica sleeps its secs, traffic_spike opens a window of
    synthetic load that extra_rps reports until it expires."""
    plan = f"{kind}@step=1:secs=5:rps=40" if kind == "traffic_spike" \
        else f"{kind}@step=1:secs=2:code=7"

    def run(mod):
        exits, naps = [], []
        inj = mod.FaultInjector(mod.parse_plan(plan), exit_fn=exits.append,
                                sleep_fn=naps.append)
        inj.fire(mod._DEFAULT_POINT[kind], step=1, now=10.0)
        inj.fire(mod._DEFAULT_POINT[kind], step=2, now=11.0)
        return (exits, naps, inj.extra_rps(now=12.0),
                inj.extra_rps(now=16.0), dict(inj.counters))

    got = run(tfaults)
    assert got == run(jfaults)
    assert got[-1] == {kind: 1}
    assert got[:4] == {"serve_crash": ([7], [], 0.0, 0.0),
                       "slow_replica": ([], [2.0], 0.0, 0.0),
                       "traffic_spike": ([], [], 40.0, 0.0)}[kind]


def _arm(monkeypatch, plan):
    """Arm ``plan`` the way a run does (the env the injector is cached
    on) and return the port's injector."""
    monkeypatch.setenv("HVDT_FAULT_PLAN", plan)
    return tfaults.get_injector()


def test_idle_harness_is_a_no_op(monkeypatch):
    assert tfaults.get_injector() is None

    def fn():
        return 1

    assert tfaults.instrument(fn, "step") is fn
    inj = _arm(monkeypatch, "exc@step=2")
    wrapped = tfaults.instrument(fn, "step", step_from="step")
    assert wrapped is not fn and wrapped.__wrapped__ is fn
    with pytest.raises(tfaults.InjectedFault):
        wrapped(step=3)
    assert inj.fired_total() == 1


# -- retry ---------------------------------------------------------------------

@pytest.mark.parametrize("seed,kw", [
    (0, dict(first=0.05, factor=2.0, cap=2.0, jitter=0.5)),
    (7, dict(first=0.2, factor=3.0, cap=5.0, jitter=1.0)),
    (3, dict(first=0.1, factor=1.5, cap=0.4, jitter=0.0)),
    (11, dict(first=0.05, factor=2.0, cap=1.0, jitter=0.5,
              deadline_s=1.3)),
])
def test_backoff_matches_reference(seed, kw):
    def run(mod):
        t = [100.0]
        slept = []

        def sleep(s):
            slept.append(s)
            t[0] += s

        b = mod.Backoff(rng=random.Random(seed), sleep_fn=sleep,
                        clock=lambda: t[0], **kw)
        delays = [b.next_delay() for _ in range(4)]
        b.reset()
        oks = [b.sleep() for _ in range(10)]
        return delays, oks, slept, b.attempts, b.expired()

    assert run(tretry) == run(jretry)


def test_retry_matches_reference():
    def run(mod):
        calls, seen = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise ConnectionError(f"down {len(calls)}")
            return "up"

        b = mod.Backoff(jitter=0.0, sleep_fn=lambda s: None)
        ok = mod.retry(flaky, attempts=5, backoff=b,
                       on_retry=lambda n, e: seen.append((n, str(e))))
        with pytest.raises(mod.RetriesExhausted) as info:
            mod.retry(lambda: 1 / 0 if False else (_ for _ in ()).throw(
                OSError("gone")), attempts=2,
                backoff=mod.Backoff(jitter=0.0, sleep_fn=lambda s: None),
                describe="probe")
        with pytest.raises(ValueError):
            mod.retry(lambda: None)
        return ok, len(calls), seen, str(info.value)

    assert run(tretry) == run(jretry)


# -- preemption ------------------------------------------------------------------

def test_sigterm_runs_the_emergency_save_and_exits_83(tmp_path):
    marker = tmp_path / "saved"
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(f"""
        import sys, time
        sys.path.insert(0, {ROOT!r})
        from horovod_tpu_torch.resilience.preempt import PreemptionGuard
        def save():
            open({str(marker)!r}, "w").write("step")
        guard = PreemptionGuard(on_preempt=save).install()
        print("ready", flush=True)
        for step in range(6000):
            time.sleep(0.01)
            guard.check(step=step)
        sys.exit(3)
    """))
    proc = subprocess.Popen([sys.executable, str(script)],
                            stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "ready"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 83
    finally:
        proc.kill()
        proc.stdout.close()
    assert marker.read_text() == "step"


# -- the elastic reset request -------------------------------------------------

def test_request_elastic_reset_reaches_the_reference_driver(monkeypatch):
    assert tesc.request_elastic_reset() is False   # no rendezvous env
    server = tkv.RendezvousServer(addr="127.0.0.1")
    port = server.start()
    try:
        monkeypatch.setenv("HVDT_RENDEZVOUS_ADDR", "127.0.0.1")
        monkeypatch.setenv("HVDT_RENDEZVOUS_PORT", str(port))
        monkeypatch.setenv("HVDT_SECRET", server.secret.hex())
        monkeypatch.setenv("HVDT_GENERATION", "3")
        monkeypatch.setenv("HVDT_RANK", "1")
        assert tesc.request_elastic_reset("test") is True
        driver = jdriver.ElasticDriver(
            jdisc.HostManager(lambda: [HostInfo("localhost", 2)]), 2,
            kv_server=server)
        driver._generation = 3
        driver.registry.reset(2)
        driver._poll_worker_registry()
        assert driver.registry.count(jdriver.READY) == 1
        assert server.get_local("/registry/3/1") == b"READY"
    finally:
        server.stop()


# -- recovery ledger ---------------------------------------------------------------

def test_recovery_ledger_matches_reference(monkeypatch):
    def run(stats, metrics):
        t = [0.0]
        ledger = stats.GoodputLedger(registry=metrics.MetricsRegistry(),
                                     clock=lambda: t[0])
        ledger.charge_phase("restore", 1.5)
        ledger.charge_phase("checkpoint_write", 2.0, overlapped=True)
        with ledger.phase("rendezvous"):
            t[0] += 0.75
        ledger.charge("recompile", 0.25)
        t[0] += 10.0
        with pytest.raises(ValueError):
            ledger.charge_phase("restor", 1.0)
        return (ledger.recovery_snapshot(), ledger.recovery_seconds(),
                ledger.lost_seconds(), round(ledger.fraction(), 9))

    assert run(tstats, tmetrics) == run(jstats, jmetrics)
    assert tstats.RECOVERY_PHASES == jstats.RECOVERY_PHASES
    assert tstats.recovery_ledger() is None
    monkeypatch.setenv("HVDT_TELEMETRY", "1")
    tstats.reset_recovery_ledger()
    try:
        assert tstats.recovery_ledger() is tstats.recovery_ledger()
    finally:
        tstats.reset_recovery_ledger()


# -- fault points in the port's code -------------------------------------------

def _tree():
    return {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3)}


def test_slow_disk_fires_at_checkpoint_write(tmp_path, monkeypatch):
    inj = _arm(monkeypatch, "slow_disk@step=2:secs=0.4")
    mgr = tck.CheckpointManager(str(tmp_path), max_to_keep=5)
    t0 = time.perf_counter()
    mgr.save(1, _tree(), force=True)
    fast = time.perf_counter() - t0
    t0 = time.perf_counter()
    mgr.save(2, _tree(), force=True)
    slow = time.perf_counter() - t0
    assert inj.counters == {"slow_disk": 1}
    assert slow >= 0.4 > fast
    assert mgr.last_good_step() == 2


@pytest.mark.parametrize("mode", ["payload", "truncate_manifest"])
def test_corrupt_ckpt_fires_at_checkpoint_save(tmp_path, mode,
                                               monkeypatch):
    inj = _arm(monkeypatch, f"corrupt_ckpt@step=3:mode={mode}")
    mgr = tck.CheckpointManager(str(tmp_path), max_to_keep=5)
    tree = _tree()
    mgr.save(2, tree, force=True)
    tree["w"] += 1
    mgr.save(3, tree, force=True)
    assert inj.counters == {"corrupt_ckpt": 1}
    assert not mgr.verify_step(3) and mgr.verify_step(2)
    got, step = mgr.restore_latest(_tree(), broadcast=False)
    assert step == 2 and mgr.corrupt_detected == 1
    torch.testing.assert_close(got["w"], _tree()["w"], rtol=0, atol=0)


def test_async_checkpoint_charges_the_recovery_ledger(tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("HVDT_TELEMETRY", "1")
    monkeypatch.setenv("HVDT_ASYNC_CKPT", "1")
    tstats.reset_recovery_ledger()
    try:
        mgr = tck.CheckpointManager(str(tmp_path))
        mgr.save_async(1, _tree(), force=True)
        assert mgr.wait_for_async(30.0)
        mgr.close()
        phases = tstats.recovery_ledger().recovery_snapshot()
        assert set(phases) == {"checkpoint_snapshot", "checkpoint_write"}
    finally:
        tstats.reset_recovery_ledger()


def test_control_plane_connect_retries_injected_drops(monkeypatch):
    import torch.distributed as dist

    from horovod_tpu_torch.ops import control_plane

    inj = _arm(monkeypatch, "kv_drop@p=1:point=tcp.connect:times=2")
    plane = control_plane.StoreControlPlane(dist.HashStore(), 0, 2,
                                            timeout_s=30.0)
    assert inj.counters == {"kv_drop": 2}
    assert plane.rank() == 0
    _arm(monkeypatch, "kv_drop@p=1:point=tcp.connect")
    with pytest.raises(tretry.RetriesExhausted):
        control_plane.StoreControlPlane(dist.HashStore(), 0, 2,
                                        timeout_s=0.5)


def test_bench_chaos_audit_reports_recovered_faults(monkeypatch):
    from horovod_tpu_torch import bench

    monkeypatch.setenv("HVDT_FAULT_PLAN", "exc@step=2,exc@step=4")
    args = bench._parse_args(["--device", "cpu", "--batch-size", "1",
                              "--image-size", "32", "--num-iters", "1",
                              "--num-batches-per-iter", "5",
                              "--num-warmup", "0"])
    doc = bench.measure(args).doc
    assert doc["fault_plan"] == "exc@step=2,exc@step=4"
    assert doc["recovered_faults"] == 2 and doc["injected_faults"] == 2
    assert doc["value"] > 0
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
