"""PyTorch port: the launcher plane (horovod_tpu_torch/runner/) against the
JAX package's runner/ on the same inputs.

* ``hosts``: ``parse_hosts``, ``parse_host_files``,
  ``get_host_assignments`` (and its refusal), ``SlotInfo.to_env``,
  ``rank_env_from_hosts``;
* ``elastic/pods``: ``group_pods``, ``plan_assignments``,
  ``usable_slots``, ``pod_layout`` over flat, declared, chunked,
  incomplete and excluded pods;
* ``config_parser.env_from_args`` for every flag whose knob the port
  registers (the same env as the reference's), a raise for every flag
  whose knob it lacks, and a YAML file's precedence;
* every knob of the port's ``common/config.py`` against the reference's
  table (name and default);
* ``http_kv``: the port's client against the reference's server and the
  reverse, a wrong secret refused both ways;
* ``elastic/discovery.HostManager`` decisions (blacklist, cooldown and
  its doubling, pod-granular state) and ``WorkerStateRegistry``
  transitions over scripted sequences, step by step against the
  reference's;
* the port's ``ElasticDriver`` over a fake cluster: a failed worker ends
  its generation (the others are terminated and count READY), a world
  whose every worker failed is respawned only with a blacklist
  cooldown, all-success finishes 0;
* the launcher's card check and the unported subcommands.
"""

import argparse
import json
import os
import threading
import time

import pytest

from horovod_tpu.common import config as jconfig
from horovod_tpu.runner import config_parser as jcp
from horovod_tpu.runner import hosts as jhosts
from horovod_tpu.runner import http_kv as jkv
from horovod_tpu.runner import launch as jlaunch
from horovod_tpu.runner.elastic import discovery as jdisc
from horovod_tpu.runner.elastic import pods as jpods
from horovod_tpu.runner.elastic import registration as jreg
from horovod_tpu_torch.common import config as tconfig
from horovod_tpu_torch.runner import config_parser as tcp
from horovod_tpu_torch.runner import hosts as thosts
from horovod_tpu_torch.runner import http_kv as tkv
from horovod_tpu_torch.runner import launch as tlaunch
from horovod_tpu_torch.runner.elastic import discovery as tdisc
from horovod_tpu_torch.runner.elastic import driver as tdriver
from horovod_tpu_torch.runner.elastic import pods as tpods
from horovod_tpu_torch.runner.elastic import registration as treg


def _plain(x):
    """Dataclasses (HostInfo, SlotInfo, Pod) as comparable tuples."""
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if hasattr(x, "__dataclass_fields__"):
        return (type(x).__name__,
                tuple(_plain(getattr(x, f)) for f in x.__dataclass_fields__))
    return x


# -- hosts ----------------------------------------------------------------

HOST_STRINGS = ["localhost:2,h2:4", "a,b:3@podA,c@podA", "h1:1@p-1.x, h2",
                "node-7:8"]


@pytest.mark.parametrize("spec", HOST_STRINGS)
def test_parse_hosts_matches_reference(spec):
    assert _plain(thosts.parse_hosts(spec)) == _plain(jhosts.parse_hosts(spec))


def test_bad_host_string_raises_in_both():
    for mod in (thosts, jhosts):
        with pytest.raises(ValueError):
            mod.parse_hosts("a:b:c")


def test_parse_host_files_matches_reference(tmp_path):
    path = tmp_path / "hostfile"
    path.write_text("# cluster\nn1 slots=4\nn2   slots = 2  # two cards\n"
                    "\nn3\n")
    assert (_plain(thosts.parse_host_files(str(path)))
            == _plain(jhosts.parse_host_files(str(path))))


ASSIGN_CASES = [("a:2,b:2", 4, 0), ("a:2,b:2", 3, 0), ("a:4,b:4", 2, 6),
                ("a:1,b:3,c:2", 5, 6), ("a:2", 3, 0)]


@pytest.mark.parametrize("spec,min_np,max_np", ASSIGN_CASES)
def test_get_host_assignments_matches_reference(spec, min_np, max_np):
    def run(mod):
        try:
            slots = mod.get_host_assignments(mod.parse_hosts(spec), min_np,
                                             max_np)
        except ValueError as e:
            return ("raises", str(e))
        return [(_plain(s), s.to_env()) for s in slots]

    assert run(thosts) == run(jhosts)


@pytest.mark.parametrize("rank", [0, 1, 2, 3, 4])
def test_rank_env_from_hosts_matches_reference(rank):
    hosts = ["10.0.0.2", "10.0.0.1", "10.0.0.2", "10.0.0.3", "10.0.0.1"]
    base, extra = {"HVDT_X": "1"}, {"HVDT_GENERATION": "3"}
    assert (thosts.rank_env_from_hosts(rank, hosts, base, extra)
            == jhosts.rank_env_from_hosts(rank, hosts, base, extra))


def test_slot_env_with_pod_matches_reference():
    kw = dict(hostname="h", rank=3, local_rank=1, cross_rank=1, size=4,
              local_size=2, cross_size=2, pod="p1", pod_index=1, pod_rank=1,
              num_pods=2, pod_size=2)
    assert thosts.SlotInfo(**kw).to_env() == jhosts.SlotInfo(**kw).to_env()


# -- pods -----------------------------------------------------------------

POD_CASES = [
    ("flat", "a:2,b:2,c:1", 2, 4, 0, None),
    ("declared", "a:2@p0,b:2@p0,c:2@p1,d:2@p1", 4, 8, 0, None),
    ("declared_max", "a:2@p0,b:2@p0,c:2@p1,d:2@p1", 2, 4, 0, None),
    ("chunked", "a:2,b:2,c:2,d:2,e:1", 4, 8, 4, None),
    ("incomplete", "a:4@p0,b:2@p1,c:4@p2", 4, 8, 0, None),
    ("excluded", "a:2@p0,b:2@p1,c:2@p2", 2, 6, 0, {"p1"}),
    ("round_up", "a:3@p0,b:3@p1,c:3@p2", 4, 4, 0, None),
    ("too_few", "a:2@p0,b:1@p1", 4, 4, 0, None),
]


@pytest.mark.parametrize("name,spec,min_np,max_np,pod_slots,exclude",
                         POD_CASES, ids=[c[0] for c in POD_CASES])
def test_pods_match_reference(name, spec, min_np, max_np, pod_slots,
                              exclude):
    def run(pmod, hmod):
        hosts = hmod.parse_hosts(spec)
        out = {"groups": _plain(pmod.group_pods(hosts, pod_slots)),
               "usable": pmod.usable_slots(hosts, pod_slots, exclude)}
        try:
            slots = pmod.plan_assignments(hosts, min_np, max_np,
                                          pod_slots=pod_slots,
                                          exclude=exclude)
        except ValueError as e:
            out["plan"] = ("raises", str(e))
            return out
        out["plan"] = [(_plain(s), s.to_env()) for s in slots]
        out["layout"] = pmod.pod_layout(slots)
        return out

    assert run(tpods, thosts) == run(jpods, jhosts)


def test_pod_layout_of_nothing_matches_reference():
    assert tpods.pod_layout([]) == jpods.pod_layout([])


# Straggler windows of per-pod median step times (ms): p2 slow for a
# streak of three (evicted once, at the second), p1 slow once and
# recovered, then slow twice again (evicted); p3 exactly at the
# threshold (1.5 x the lower median 100: not slow); a window of one pod
# (no baseline) and a window with a zero median change nothing.
_POD_WINDOWS = [
    {"p0": 100.0, "p1": 160.0, "p2": 300.0, "p3": 100.0},
    {"p0": 100.0, "p1": 100.0, "p2": 310.0, "p3": 150.0},
    {"p0": 100.0, "p1": 170.0, "p2": 320.0, "p3": 100.0},
    {"p0": 100.0},
    {"p0": 0.0, "p1": 0.0},
    {"p0": 100.0, "p1": 180.0, "p2": 90.0, "p3": 150.0},
    {"p0": 100.0, "p1": 100.0, "p2": 300.0, "p3": 100.0},
    {"p0": 100.0, "p1": 100.0, "p2": 300.0, "p3": 100.0},
]
_SNAP_ROUNDS = [
    {0: {"steps": 10}, 1: {"steps": 10}},
    {0: {"steps": 10}, 1: {"steps": 10}},       # no new step data
    {0: {"steps": 20}, 1: {"steps": 10}},
    {1: {"steps": 10}, 0: {"steps": 20}},       # same, other order
    {0: {"steps": 20}, 1: {"steps": 10}, 2: {"steps": 5}},
    {},
]


def test_pod_tracker_matches_reference():
    """Exit correlation within the window, drains and their expiry, the
    straggler-eviction windows (a streak, a recovery, a tie at the
    threshold) and the snapshot fingerprints: the same answers at the
    same (virtual) times."""
    def run(pmod):
        tr = pmod.PodTracker(exit_window_s=10.0, drain_grace_s=60.0,
                             evict_windows=2, threshold=1.5)
        out = [tr.record_failure("p0", now=0.0),
               tr.record_failure("p0", now=5.0),
               tr.record_failure("p0", now=11.0),
               tr.record_failure("p1", now=11.0), tr.removal_events,
               tr.drain("p2", now=0.0), tr.drain("p2", now=1.0),
               sorted(tr.drained_pods(now=30.0)),
               sorted(tr.drained_pods(now=61.5))]
        out += [tr.observe_step_medians(w) for w in _POD_WINDOWS]
        out += [tr.snapshots_fingerprint(s) for s in _SNAP_ROUNDS]
        off = pmod.PodTracker(evict_windows=0, threshold=1.5)
        out += [off.observe_step_medians(w) for w in _POD_WINDOWS]
        return out

    got = run(tpods)
    assert got == run(jpods)
    assert [e for e in got[9:17] if e] == [["p2"], ["p1"], ["p2"]]


# -- config parser ----------------------------------------------------------

def _flag_value(f):
    if f.is_bool:
        return []
    if f.type is int:
        return ["3"]
    if f.type is float:
        return ["2.5"]
    return ["on" if "overlap" in f.dest else "x-value"]


PORTED_FLAGS = [f for f in jcp.KNOB_FLAGS if f.env in tconfig.KNOBS]
UNPORTED_FLAGS = [f for f in jcp.KNOB_FLAGS if f.env not in tconfig.KNOBS]


def test_flag_sets_agree():
    assert [f.flag for f in tcp.KNOB_FLAGS] == [f.flag for f in
                                                jcp.KNOB_FLAGS]
    assert {f.env for f in UNPORTED_FLAGS} == set(tcp.UNPORTED_KNOBS)


@pytest.mark.parametrize("flag", PORTED_FLAGS, ids=lambda f: f.flag)
def test_env_from_args_matches_reference(flag):
    argv = [flag.flag, *_flag_value(flag), "-np", "2", "--", "python",
            "train.py"]
    want = jcp.env_from_args(jlaunch.parse_args(argv), {}, base_env={})
    got = tcp.env_from_args(tlaunch.parse_args(argv), {}, base_env={})
    assert got == want and flag.env in got


@pytest.mark.parametrize("flag", UNPORTED_FLAGS, ids=lambda f: f.flag)
def test_unported_flag_raises_naming_its_item(flag):
    argv = [flag.flag, *_flag_value(flag), "-np", "2", "--", "python",
            "train.py"]
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1, item"):
        tcp.env_from_args(tlaunch.parse_args(argv), {}, base_env={})
    # Unset, the flag forwards nothing and raises nothing, even when the
    # caller's environment has its variable.
    args = tlaunch.parse_args(["-np", "1", "--", "python", "t.py"])
    assert flag.env not in tcp.env_from_args(args, {},
                                             base_env={flag.env: "1"})


def test_config_file_precedence_matches_reference(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text("params:\n  fusion_threshold_mb: 32\n  cycle_time_ms: "
                    "3.5\nresilience:\n  fault_plan: exc@step=4\n  "
                    "blacklist_cooldown_s: 1.5\nstall_check:\n  "
                    "warning_time_seconds: 30\nelastic:\n  pod_size: 4\n")
    argv = ["--config-file", str(path), "--cycle-time-ms", "7", "-np", "2",
            "--", "python", "t.py"]
    base = {"HVDT_STALL_CHECK_TIME_SECONDS": "90"}

    def run(cp, launch):
        args = launch.parse_args(argv)
        return cp.env_from_args(args, cp.apply_config_file(
            args, args.config_file), base_env=base)

    got, want = run(tcp, tlaunch), run(jcp, jlaunch)
    assert got == want
    assert got["HVDT_CYCLE_TIME"] == "7.0"            # CLI wins
    assert got["HVDT_STALL_CHECK_TIME_SECONDS"] == "90"   # then the env
    assert got["HVDT_FUSION_THRESHOLD"] == str(32 * 1024 * 1024)


def test_config_file_unported_entry_raises(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text("serve:\n  replicas: 2\n")
    args = tlaunch.parse_args(["--config-file", str(path), "--", "p"])
    with pytest.raises(NotImplementedError, match="item 7"):
        tcp.env_from_args(args, tcp.apply_config_file(args, str(path)),
                          base_env={})


@pytest.mark.parametrize("name", sorted(tconfig.KNOBS))
def test_knob_matches_reference(name):
    assert name in jconfig.KNOBS
    assert tconfig.KNOBS[name].default == jconfig.KNOBS[name].default
    assert (type(tconfig.KNOBS[name].read())
            == type(jconfig.KNOBS[name].default))


# -- rendezvous KV across packages -----------------------------------------

@pytest.mark.parametrize("server_mod,client_mod", [(jkv, tkv), (tkv, jkv)],
                         ids=["port_client", "port_server"])
def test_kv_interoperates(server_mod, client_mod):
    secret = server_mod.new_secret()
    server = server_mod.RendezvousServer(secret=secret, addr="127.0.0.1")
    port = server.start()
    try:
        client = client_mod.KVClient("127.0.0.1", port, secret)
        client.put("/rendezvous/1/spec", b"0,localhost,0")
        assert server.get_local("/rendezvous/1/spec") == b"0,localhost,0"
        server.put_local("/registry/1/0", b"READY")
        assert client.get("/registry/1/0") == b"READY"
        assert client.get("/missing") is None
        threading.Timer(0.2, server.put_local,
                        ("/late", b"\x00\x01")).start()
        assert client.wait("/late", timeout=10.0) == b"\x00\x01"
        client.delete("/late")
        assert server.get_local("/late") is None
        wrong = client_mod.KVClient("127.0.0.1", port, b"x" * 32)
        with pytest.raises(ConnectionError, match="403"):
            wrong.put("/rendezvous/1/spec", b"evil")
        with pytest.raises(ConnectionError, match="403"):
            wrong.get("/registry/1/0")
        assert server.get_local("/rendezvous/1/spec") == b"0,localhost,0"
    finally:
        assert server.stop()


# -- discovery, registry ------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_host_manager_decisions_match_reference(monkeypatch):
    """A scripted discovery sequence with blacklists and a 2 s cooldown:
    changed flags, usable hosts, blacklist state and pod failure counts
    after each event equal the reference's."""
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    monkeypatch.setenv("HVDT_ELASTIC_BLACKLIST_COOLDOWN_S", "2")
    script = [
        "a:2,b:2", "a:2,b:2", "a:2,b:2,c:2", "a:2,c:2",
        "x:1@p9,y:1@p9,a:2", "x:1@p9,y:1@p9,a:2", "x:1@p9,y:1@p9,a:2",
        "x:1@p9,y:1@p9,a:2",
    ]
    events = [None, ("blacklist", "b"), ("tick", 1.0), ("tick", 1.5),
              ("blacklist", "x"), ("tick", 2.5), ("blacklist", "y"),
              ("tick", 3.0)]

    def run(dmod, hmod):
        clock.t = 1000.0
        feed = iter(script)
        hm = dmod.HostManager(lambda: hmod.parse_hosts(next(feed)))
        out = []
        for ev in events:
            if ev is not None and ev[0] == "blacklist":
                hm.blacklist(ev[1])
            elif ev is not None:
                clock.t += ev[1]
            changed = hm.update_available_hosts()
            out.append((changed, _plain(hm.current.hosts),
                        hm.current.available_slots,
                        {h: hm.is_blacklisted(h) for h in "abcxy"},
                        {p: hm.pod_failures(p) for p in ("a", "b", "p9")}))
        return out

    assert run(tdisc, thosts) == run(jdisc, jhosts)


def test_default_blacklist_is_permanent_in_both(monkeypatch):
    monkeypatch.delenv("HVDT_ELASTIC_BLACKLIST_COOLDOWN_S", raising=False)
    for dmod in (tdisc, jdisc):
        st = dmod.HostState()
        st.blacklist()
        assert st.is_blacklisted and st.failures == 1


def test_registry_transitions_match_reference():
    script = [("reset", 3), ("success", 0), ("ready", 1), ("failure", 1),
              ("ready", 2), ("success", 1), ("reset", 2), ("ready", 0),
              ("ready", 1), ("ready", 1), ("reset", 2), ("failure", 0),
              ("failure", 1), ("reset", 1), ("ready", 0)]

    def run(rmod):
        fired = []
        reg = rmod.WorkerStateRegistry(
            lambda s: fired.append({k: sorted(v) for k, v in s.items()}),
            reset_limit=2)
        out = []
        for op, arg in script:
            if op == "reset":
                reg.reset(arg)
            else:
                getattr(reg, f"record_{op}")(arg)
            out.append((len(fired), reg.reset_count,
                        reg.reset_limit_reached(),
                        [reg.count(s) for s in (rmod.READY, rmod.SUCCESS,
                                                rmod.FAILURE)]))
        return out, fired

    assert run(treg) == run(jreg)


# -- the port's driver over a fake cluster -----------------------------------

class _Cluster:
    """Scripted discovery and workers: a worker runs until the driver
    terminates its generation or the test sets its exit code."""

    def __init__(self, hosts):
        self.hosts = dict(hosts)
        self.exit = {}
        self.started = []
        self.driver = None

    def discover(self):
        return [thosts.HostInfo(h, s) for h, s in sorted(self.hosts.items())]

    def spawn(self, slot, gen):
        self.started.append((gen, slot.rank))
        stop = self.driver.terminate_event(gen)
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            if (gen, slot.rank) in self.exit:
                return self.exit[(gen, slot.rank)]
            if stop.is_set():
                return -15     # SIGTERM
            time.sleep(0.01)
        return 0


def _driver(cluster, min_np, **kw):
    d = tdriver.ElasticDriver(tdisc.HostManager(cluster.discover), min_np,
                              spawn_fn=cluster.spawn,
                              discovery_interval=0.05, **kw)
    cluster.driver = d
    return d


def _until(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


def test_failed_worker_ends_its_generation(monkeypatch):
    monkeypatch.setenv("HVDT_ELASTIC_BLACKLIST_COOLDOWN_S", "0.3")
    cluster = _Cluster({"localhost": 3})
    d = _driver(cluster, 3)
    d.start()
    try:
        assert _until(lambda: len(cluster.started) == 3)
        cluster.exit[(1, 2)] = 1     # rank 2 crashes
        # The survivors are terminated and count READY: generation 2
        # comes once the host's cooldown ends, with every slot.
        assert _until(lambda: d.generation == 2)
        assert d.terminate_event(1).is_set()
        assert [s.rank for s in d.assignments] == [0, 1, 2]
        for r in range(3):
            cluster.exit[(2, r)] = 0
        assert d.wait(timeout=10.0) == 0
        assert d.registry.reset_count == 1
    finally:
        d.stop()


@pytest.mark.parametrize("cooldown,want", [("0.2", (2, 0)), ("0", (1, 1))],
                         ids=["cooldown", "permanent"])
def test_world_of_one_crash(monkeypatch, cooldown, want):
    """Every worker failed: respawned only while the blacklist has a
    cooldown (the reference ends the job either way)."""
    monkeypatch.setenv("HVDT_ELASTIC_BLACKLIST_COOLDOWN_S", cooldown)
    cluster = _Cluster({"localhost": 1})
    d = _driver(cluster, 1)
    d.start()
    try:
        cluster.exit[(1, 0)] = 1
        if want[0] == 2:
            assert _until(lambda: d.generation == 2)
            cluster.exit[(2, 0)] = 0
        assert d.wait(timeout=10.0) == want[1]
        assert d.generation == want[0]
    finally:
        d.stop()


def test_reset_limit_bounds_a_crash_loop(monkeypatch):
    monkeypatch.setenv("HVDT_ELASTIC_BLACKLIST_COOLDOWN_S", "0.05")
    cluster = _Cluster({"localhost": 1})
    d = _driver(cluster, 1, reset_limit=2)
    for g in range(1, 5):
        cluster.exit[(g, 0)] = 1
    d.start()
    try:
        assert d.wait(timeout=10.0) == 1
        assert d.generation == 3
    finally:
        d.stop()


def test_unported_driver_hooks_raise(monkeypatch):
    tdriver.refuse_unported_hooks({"HVDT_CONTROLLER": "off",
                                   "HVDT_TRACE_DIR": ""})
    for knob in ("HVDT_CONTROLLER", "HVDT_FLEET"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tdriver.refuse_unported_hooks({knob: "on"})
    # The telemetry hooks are ported: their knobs pass, and the
    # pod-straggler rung arms the driver's tracker.
    tdriver.refuse_unported_hooks({"HVDT_TRACE_DIR": "/tmp/t",
                                   "HVDT_EVENT_LOG": "/tmp/e.jsonl"})
    monkeypatch.setenv("HVDT_POD_STRAGGLER_EVICT", "3")
    d = _driver(_Cluster({"localhost": 1}), 1)
    assert d._pods.evict_windows == 3
    assert d.telemetry_snapshots() == {} and d.telemetry_rollup() == {}


class _FakeKV:
    """The two attributes the drivers read of a RendezvousServer."""

    def __init__(self):
        self.lock = threading.Lock()
        self.store = {}


# Rounds of per-rank step-time medians (ms) over pods A (ranks 0-1),
# B (2-3) and C (4-5): B slow in the first round only (recovered); C
# slow from the second; the third round republishes the second (no new
# steps, so no window); C's second slow window evicts it.
_STRAGGLER_ROUNDS = [
    [50, 51, 110, 112, 50, 52],
    [50, 52, 50, 51, 155, 150],
    [50, 52, 50, 51, 155, 150],
    [49, 50, 51, 50, 170, 150],
]


def test_pod_straggler_eviction_matches_reference(monkeypatch, capsys):
    """An armed HVDT_POD_STRAGGLER_EVICT: both drivers read the same KV
    snapshots round by round and blacklist the same pod at the same
    round, with the same hosts left and the same operator line."""
    from horovod_tpu.runner.elastic import driver as jdriver

    monkeypatch.setenv("HVDT_POD_STRAGGLER_EVICT", "2")
    monkeypatch.setenv("HVDT_STRAGGLER_THRESHOLD", "2.0")

    def run(dmod, dmod_disc, hmod):
        hosts = [hmod.HostInfo(f"h{i}", 2, f"pod{'ABC'[i]}")
                 for i in range(3)]
        hm = dmod_disc.HostManager(lambda: list(hosts))
        hm.update_available_hosts()
        kv, notes = _FakeKV(), []
        d = dmod.ElasticDriver(hm, 6, kv_server=kv,
                               hosts_updated_cb=notes.append)
        out = []
        for k, medians in enumerate(_STRAGGLER_ROUNDS):
            steps = 10 * min(k + 1, 2) if k < 3 else 40
            for rank, ms in enumerate(medians):
                kv.store[f"/telemetry/{rank}"] = json.dumps({
                    "rank": rank, "pod": f"pod{'ABC'[rank // 2]}",
                    "steps": steps, "step_time_p50_ms": float(ms),
                }).encode()
            d._check_pod_stragglers()
            out.append(([p for p in ("podA", "podB", "podC")
                         if hm.is_pod_blacklisted(p)],
                        hm.current.host_names(), list(notes)))
        return out, capsys.readouterr().err.splitlines()

    want = run(jdriver, jdisc, jhosts)
    got = run(tdriver, tdisc, thosts)
    assert got == want
    assert [r[0] for r in got[0]] == [[], [], [], ["podC"]]
    assert got[0][-1][1] == ["h0", "h1"]
    assert len(got[1]) == 1 and "pod podC evicted" in got[1][0]


# -- launcher ------------------------------------------------------------------

def test_card_check(monkeypatch):
    slots = thosts.get_host_assignments(thosts.parse_hosts("localhost:2"), 2)
    monkeypatch.setattr(tlaunch, "_card_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 local slot"):
        tlaunch.check_local_cards(slots, ["python", "train.py"])
    for cmd in (["python", "t.py", "--device", "cpu"],
                ["python", "t.py", "--device=cpu"]):
        tlaunch.check_local_cards(slots, cmd)
    monkeypatch.setattr(tlaunch, "_card_count", lambda: 2)
    tlaunch.check_local_cards(slots, ["python", "train.py"])
    remote = thosts.get_host_assignments(thosts.parse_hosts("n1:8"), 8)
    monkeypatch.setattr(tlaunch, "_card_count", lambda: 0)
    tlaunch.check_local_cards(remote, ["python", "train.py"])


@pytest.mark.parametrize("sub", ["serve", "top", "fleet", "lint"])
def test_unported_subcommands_raise(sub, capsys):
    if sub == "top":
        # Ported: one frame over an endpoint that answers nothing.
        assert tlaunch.main(["top", "--once", "--endpoints",
                             "127.0.0.1:1"]) == 0
        assert "hvdt top — 0/1 ranks" in capsys.readouterr().out
        return
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        tlaunch.main([sub])


def test_parse_args_matches_reference():
    argv = ["-np", "4", "-H", "a:2,b:2", "--min-np", "2", "--max-np", "4",
            "--host-discovery-script", "./d.sh", "--reset-limit", "3",
            "--elastic-timeout", "60", "--slots-per-host", "2", "--verbose",
            "--", "python", "train.py", "--lr", "0.1"]
    want, got = vars(jlaunch.parse_args(argv)), vars(tlaunch.parse_args(argv))
    want.pop("tcp_base_port")
    assert got == want
    assert isinstance(tlaunch.parse_args(argv), argparse.Namespace)
