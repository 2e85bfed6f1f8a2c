"""Replica autoscaler: the serving side of the pod-aware elastic driver.

The port's copy of the JAX package's ``serve/autoscale.py``.  Training
and serving share ONE control plane; this module is the driver half —
it reuses the elastic machinery piece by piece rather than forking it:

* **Discovery + blacklist-with-cooldown** —
  :class:`runner.elastic.discovery.HostManager`: the same
  ``host[:slots][@pod]`` discovery source, the same doubling cooldown
  for a host whose replica crashed (a flaky serve host converges toward
  exclusion; a transiently bad one rejoins).
* **Pod drains** — :class:`runner.elastic.pods.PodTracker`: a replica
  taking the preemption exit drains its whole pod from placement, so
  the autoscaler never scales *onto* a slice the platform is reclaiming.
* **Exit taxonomy** — :data:`resilience.preempt.PREEMPT_EXIT_CODE`
  (83) = clean removal (drained replica, preempted host: no blacklist,
  no removal event); anything else failing = a **replica-removal
  event** (host blacklisted with cooldown, replacement spawned),
  correlated per pod inside the PodTracker window so one dying host
  costs one event, not one per replica.

The scaling decision itself (:class:`AutoscalePolicy`) reads the same
KV heartbeats the router routes on (``/serve/replicas/<id>``: queue
depth + p99): queue rows per replica above ``HVDT_SERVE_QUEUE_HI``
or fleet p99 over the SLO scales up; an idle queue with healthy p99
scales down — one step per ``HVDT_SERVE_SCALE_COOLDOWN_S``, clamped to
``[min, HVDT_SERVE_MAX_REPLICAS]``.  Scale-down is **graceful by
construction**: the driver writes ``/serve/drain/<id>``, the replica
stops admitting, finishes its in-flight batches, deregisters, and exits
83 — the router re-routes from the first 503, so a resize drops zero
requests.

Operators can force a target by
writing ``/serve/target_replicas`` on the rendezvous KV; the policy
resumes from there when the key is cleared.

The key has two on-wire forms and a fixed precedence
(``fleet.scheduler.read_target`` decodes both): a **raw int** is the
operator's out-of-band override and beats everything, including the
``--target-file`` channel; a **seq-guarded JSON doc**
(``{"target": n, "seq": k, "writer": ...}``, written by a fleet
scheduler or a controller's ``scale_replicas`` hint) ranks between the
file override and the autoscale policy.  Every adoption stamps ``last_target_writer`` / ``last_target_seq`` —
the audit trail for "who scaled the fleet last".
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..common import config
from ..common.logging_util import get_logger
from ..runner import hosts as hosts_mod
from ..runner.elastic import pods as pods_mod
from ..runner.elastic.discovery import HostManager
from ..fleet.scheduler import TARGET_KV_KEY, read_target
from .replica import DRAIN_KV_PREFIX, REPLICA_KV_PREFIX

__all__ = ["AutoscalePolicy", "ServeDriver", "run_serve_elastic",
           "TARGET_KV_KEY"]

log = get_logger(__name__)

class AutoscalePolicy:
    """Pure scale decision over replica heartbeat snapshots.

    Deterministic and clock-injectable so tests drive it directly; the
    driver owns when it runs and what it does with the answer.
    """

    def __init__(self, *,
                 min_replicas: int = 1,
                 max_replicas: Optional[int] = None,
                 slo_p99_ms: Optional[float] = None,
                 queue_hi: Optional[float] = None,
                 queue_lo: Optional[float] = None,
                 cooldown_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = int(
            max_replicas if max_replicas is not None
            else config.get_int("HVDT_SERVE_MAX_REPLICAS"))
        self.slo_p99_ms = float(
            slo_p99_ms if slo_p99_ms is not None
            else config.get_float("HVDT_SERVE_SLO_P99_MS"))
        self.queue_hi = float(
            queue_hi if queue_hi is not None
            else config.get_float("HVDT_SERVE_QUEUE_HI"))
        self.queue_lo = float(
            queue_lo if queue_lo is not None
            else config.get_float("HVDT_SERVE_QUEUE_LO"))
        self.cooldown_s = float(
            cooldown_s if cooldown_s is not None
            else config.get_float("HVDT_SERVE_SCALE_COOLDOWN_S"))
        self._clock = clock
        self._last_change: Optional[float] = None
        self.last_reason = ""

    def decide(self, current: int,
               snapshots: Dict[int, Dict[str, Any]]) -> int:
        """Desired replica count given the live heartbeat snapshots.
        ``current`` is the driver's present target.  Returns a value in
        [min_replicas, max_replicas]; == ``current`` means hold."""
        now = self._clock()
        lo = max(self.min_replicas, 1)
        hi = max(self.max_replicas, lo)
        clamped = min(hi, max(lo, current))
        if clamped != current:
            self.last_reason = f"clamped to [{lo}, {hi}]"
            return clamped
        if self._last_change is not None and \
                now - self._last_change < self.cooldown_s:
            return current
        live = [s for s in snapshots.values() if not s.get("draining")]
        if not live:
            return current
        queue_per = sum(float(s.get("queue_depth") or 0.0)
                        for s in live) / max(1, len(live))
        p99s = [float(s["p99_ms"]) for s in live
                if s.get("p99_ms") is not None]
        worst_p99 = max(p99s) if p99s else None
        if current < hi and (
                queue_per > self.queue_hi
                or (self.slo_p99_ms > 0 and worst_p99 is not None
                    and worst_p99 > self.slo_p99_ms)):
            self._last_change = now
            self.last_reason = (
                f"queue {queue_per:.1f} rows/replica"
                if queue_per > self.queue_hi
                else f"p99 {worst_p99:.0f}ms > SLO {self.slo_p99_ms:.0f}ms")
            return current + 1
        if current > lo and queue_per < self.queue_lo and (
                self.slo_p99_ms <= 0 or worst_p99 is None
                or worst_p99 < 0.5 * self.slo_p99_ms):
            self._last_change = now
            self.last_reason = (f"idle: queue {queue_per:.1f} "
                                f"rows/replica")
            return current - 1
        return current


class _Replica:
    __slots__ = ("id", "slot", "thread", "started_at", "draining")

    def __init__(self, replica_id: int, slot: hosts_mod.SlotInfo,
                 thread: threading.Thread):
        self.id = replica_id
        self.slot = slot
        self.thread = thread
        self.started_at = time.monotonic()
        self.draining = False


def localhost_host_manager(slots: int) -> HostManager:
    """The default serve "fleet": one localhost entry with
    ``max_replicas`` slots — the single-box deploy.  Real fleets pass a
    discovery script exactly like elastic training."""
    return HostManager(
        lambda: [hosts_mod.HostInfo("localhost", max(1, int(slots)))])


class ServeDriver:
    """Drives replica worker lifecycles against a target count.

    ``spawn_fn(slot, replica_id)`` starts one replica worker and blocks
    until it exits, returning the exit code — injectable, so unit tests
    fake whole serve fleets in-process (the ElasticDriver test strategy).
    """

    def __init__(self, kv_server: Any,
                 spawn_fn: Callable[[hosts_mod.SlotInfo, int], int],
                 *,
                 host_manager: Optional[HostManager] = None,
                 replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 autoscale: Optional[bool] = None,
                 policy: Optional[AutoscalePolicy] = None,
                 pod_tracker: Optional[pods_mod.PodTracker] = None,
                 target_file: Optional[str] = None,
                 interval: float = 0.25):
        self._kv = kv_server
        self._spawn_fn = spawn_fn
        self.max_replicas = int(
            max_replicas if max_replicas is not None
            else config.get_int("HVDT_SERVE_MAX_REPLICAS"))
        self._hm = host_manager or localhost_host_manager(self.max_replicas)
        self._autoscale = bool(
            autoscale if autoscale is not None
            else config.get_bool("HVDT_SERVE_AUTOSCALE"))
        self.policy = policy or AutoscalePolicy(
            max_replicas=self.max_replicas)
        self._pods = pod_tracker or pods_mod.PodTracker()
        self._target_file = target_file
        self._interval = interval
        self._lock = threading.Lock()
        self._live: Dict[int, _Replica] = {}
        self._target = max(1, int(
            replicas if replicas is not None
            else config.get_int("HVDT_SERVE_REPLICAS")))
        self._target = min(self._target, self.max_replicas)
        self._next_id = 0
        self._shutdown = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._no_slot_warned = False
        self.removal_events = 0     # audit: replica-removal events
        self.scale_events: List[str] = []
        # Last adopted /serve/target_replicas writer (audit trail for
        # the one-key-many-writers reconciliation): "operator" for the
        # raw-int / --target-file channels, the doc's writer field
        # ("fleet", "controller", ...) otherwise.
        self.last_target_writer: Optional[str] = None
        self.last_target_seq: Optional[int] = None

    # -- introspection -----------------------------------------------------

    @property
    def target(self) -> int:
        with self._lock:
            return self._target

    def live_replicas(self) -> List[int]:
        with self._lock:
            return sorted(r.id for r in self._live.values()
                          if not r.draining)

    def replica_snapshots(self) -> Dict[int, Dict[str, Any]]:
        """The serve fleet's heartbeats out of the rendezvous KV — the
        serving analog of ``ElasticDriver.telemetry_snapshots``."""
        out: Dict[int, Dict[str, Any]] = {}
        with self._kv.lock:
            items = {k: v for k, v in self._kv.store.items()
                     if k.startswith(REPLICA_KV_PREFIX)}
        for key, raw in items.items():
            try:
                out[int(key[len(REPLICA_KV_PREFIX):])] = \
                    json.loads(raw.decode())
            except (ValueError, UnicodeDecodeError):
                continue
        return out

    # -- scaling -----------------------------------------------------------

    def set_target(self, n: int, reason: str = "operator") -> int:
        """Clamp + adopt a new replica target; logs the scale event (the
        control-plane audit line scenario tests assert on)."""
        n = min(self.max_replicas, max(1, int(n)))
        with self._lock:
            old = self._target
            if n == old:
                return old
            self._target = n
        msg = f"serve: scaling {old} -> {n} ({reason})"
        self.scale_events.append(msg)
        print(msg, file=sys.stderr)
        return n

    def _kv_target_doc(self) -> Optional[Dict[str, Any]]:
        """The decoded ``/serve/target_replicas`` doc (raw operator int
        or seq-guarded fleet doc), or None when unset/garbage."""
        return read_target(self._kv.get_local(TARGET_KV_KEY))

    def _kv_target_override(self) -> Optional[int]:
        """The raw-int operator form only — the highest-precedence
        channel (a fleet doc on the key is NOT an operator override)."""
        doc = self._kv_target_doc()
        if doc is not None and doc.get("seq") is None:
            return doc["target"]
        return None

    def _file_target_override(self) -> Optional[int]:
        """Operator override from ``--target-file`` (a plain int in a
        file): the out-of-band control channel for operators and
        harnesses outside the launcher's secret domain — ``echo 3 >
        target`` resizes the fleet."""
        if not self._target_file:
            return None
        try:
            with open(self._target_file) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    def _free_slot(self) -> Optional[hosts_mod.SlotInfo]:
        """A placement for one more replica: the first discovered,
        non-blacklisted host (skipping drained pods) with spare slots.
        The slot's ``local_rank`` is the lowest one no live replica of
        that host holds: a replica serves on card ``cuda:<local rank>``,
        so a replacement takes the card its predecessor left, never a
        card a live replica is on."""
        drained = self._pods.drained_pods()
        with self._lock:
            used: Dict[str, set] = {}
            for r in self._live.values():
                used.setdefault(r.slot.hostname, set()).add(
                    r.slot.local_rank)
        for h in self._hm.current.hosts:
            if self._hm.is_blacklisted(h.hostname):
                continue
            if self._hm.pod_of(h.hostname) in drained or \
                    (h.pod and h.pod in drained):
                continue
            taken = used.get(h.hostname, set())
            free = [i for i in range(h.slots) if i not in taken]
            if free:
                return hosts_mod.SlotInfo(
                    hostname=h.hostname, rank=0, local_rank=free[0],
                    cross_rank=0, size=self.target, local_size=h.slots,
                    cross_size=1, pod=h.pod or "")
        return None

    def _start_replica(self, slot: hosts_mod.SlotInfo) -> None:
        with self._lock:
            rid = self._next_id
            self._next_id += 1

        def _run():
            try:
                code = self._spawn_fn(slot, rid)
            except Exception as e:
                print(f"serve: replica {rid} spawn error: {e}",
                      file=sys.stderr)
                code = 1
            self.record_exit(rid, code)

        t = threading.Thread(target=_run, daemon=True,
                             name=f"hvdt-serve-replica-{rid}")
        with self._lock:
            self._live[rid] = _Replica(rid, slot, t)
        print(f"serve: replica {rid} starting on {slot.hostname}"
              f"[{slot.local_rank}]", file=sys.stderr)
        t.start()

    def _drain_replica(self, rid: int) -> None:
        with self._lock:
            rep = self._live.get(rid)
            if rep is None or rep.draining:
                return
            rep.draining = True
        print(f"serve: draining replica {rid} (scale-down)",
              file=sys.stderr)
        self._kv.put_local(f"{DRAIN_KV_PREFIX}{rid}", b"drain")

    def record_exit(self, rid: int, code: int) -> None:
        from ..resilience.preempt import PREEMPT_EXIT_CODE

        with self._lock:
            rep = self._live.pop(rid, None)
        if rep is None:
            return
        # Scrub the heartbeat (a crashed replica's stale record must not
        # linger a full liveness window) but leave a drain TOMBSTONE on
        # the id: a worker process that somehow outlived its wrapper
        # (orphaned `sh -c` child, split-brain respawn) keeps beating
        # and would re-enter routing as untracked capacity — the
        # tombstone makes it drain itself at its next beat.  Replica ids
        # are never reused, so tombstones cannot block a replacement.
        with self._kv.lock:
            self._kv.store.pop(f"{REPLICA_KV_PREFIX}{rid}", None)
            self._kv.store[f"{DRAIN_KV_PREFIX}{rid}"] = b"fence"
        if code == PREEMPT_EXIT_CODE:
            # Clean removal: a drained scale-down or a preempted host.
            # Preemption reclaims whole slices — drain the pod from
            # placement like the training driver does.
            if not rep.draining:
                pod = rep.slot.pod or self._hm.pod_of(rep.slot.hostname)
                if self._pods.drain(pod):
                    print(f"serve: pod {pod} draining (replica {rid} "
                          f"preempted on {rep.slot.hostname}, clean "
                          f"removal)", file=sys.stderr)
            print(f"serve: replica {rid} exited clean "
                  f"({'drained' if rep.draining else 'preempted'})",
                  file=sys.stderr)
            return
        if code == 0:
            print(f"serve: replica {rid} exited 0", file=sys.stderr)
            return
        # Failure: one replica-removal event, pod-correlated (the
        # PodTracker window folds a dying host's replicas into one),
        # host blacklisted with cooldown, replacement spawned by the
        # next reconcile pass.
        pod = rep.slot.pod or self._hm.pod_of(rep.slot.hostname)
        if self._pods.record_failure(pod):
            self.removal_events += 1
            print(f"serve: replica-removal event for replica {rid} "
                  f"(exit {code} on {rep.slot.hostname}); correlated "
                  f"exits within the window fold into this event",
                  file=sys.stderr)
            self._hm.blacklist(rep.slot.hostname)
            self._hm.update_available_hosts()
        else:
            print(f"serve: replica {rid} exit {code} folded into the "
                  f"open removal event for pod {pod}", file=sys.stderr)

    def reconcile(self) -> None:
        """One control pass: adopt overrides/policy, then converge the
        live set toward the target (spawn up, drain down)."""
        doc = self._kv_target_doc()
        override = doc["target"] if doc is not None \
            and doc.get("seq") is None else None
        if override is None:
            override = self._file_target_override()
            doc = None if override is not None else doc
        if override is not None:
            self.set_target(override, reason="operator override")
            self.last_target_writer = "operator"
            self.last_target_seq = None
        elif doc is not None:
            # The fleet scheduler's seq-guarded doc (or a controller
            # hint it routed): below the operator channels, above the
            # local autoscale policy.
            self.set_target(doc["target"],
                            reason=f"fleet: {doc.get('writer', '?')} "
                                   f"seq={doc.get('seq')}")
            self.last_target_writer = str(doc.get("writer", "?"))
            self.last_target_seq = doc.get("seq")
        elif self._autoscale:
            snaps = self.replica_snapshots()
            desired = self.policy.decide(self.target, snaps)
            if desired != self.target:
                self.set_target(desired,
                                reason=f"autoscale: "
                                       f"{self.policy.last_reason}")
                self.last_target_writer = "autoscale"
                self.last_target_seq = None
        with self._lock:
            live = [r for r in self._live.values() if not r.draining]
            target = self._target
        if len(live) < target:
            for _ in range(target - len(live)):
                slot = self._free_slot()
                if slot is None:
                    # Once per starvation episode, not once per 0.25s
                    # reconcile tick: the condition clears on its own
                    # (cooldown/drain-grace expiry), the log should not
                    # scroll the real events away while it does.
                    if not self._no_slot_warned:
                        self._no_slot_warned = True
                        log.warning("serve: want %d replicas, no "
                                    "placeable slot (blacklist/drained "
                                    "pods?)", target)
                    break
                self._no_slot_warned = False
                self._start_replica(slot)
        elif len(live) > target:
            # Drain the newest first: the oldest replicas have the
            # warmest compile caches and the longest uptime evidence.
            doomed = sorted(live, key=lambda r: r.started_at,
                            reverse=True)[:len(live) - target]
            for rep in doomed:
                self._drain_replica(rep.id)

    def _loop(self) -> None:
        while not self._shutdown.wait(self._interval):
            try:
                self._hm.update_available_hosts()
                self.reconcile()
            except Exception:   # pragma: no cover - defensive
                log.exception("serve driver control loop error")

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._hm.update_available_hosts()
        self.reconcile()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hvdt-serve-driver")
        self._thread.start()

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Shut the fleet down; with ``drain`` every replica finishes
        its in-flight work (exit 83) before the driver returns."""
        self._shutdown.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if drain:
            with self._lock:
                rids = list(self._live)
            for rid in rids:
                self._drain_replica(rid)
            from ..resilience.retry import Backoff

            drain_wait = Backoff(first=0.05, cap=0.5, deadline_s=timeout)
            while True:
                with self._lock:
                    if not self._live:
                        return
                if not drain_wait.sleep():
                    break
            with self._lock:
                leftover = sorted(self._live)
            if leftover:
                log.warning("serve driver stop: replicas %s did not "
                            "drain within %.0fs", leftover, timeout)


def run_serve_elastic(args, replica_argv: List[str]) -> int:
    """``hvdtrun serve --replicas N [--autoscale]`` — the elastic
    serving control plane: rendezvous KV + replica fleet + router, one
    process group.

    ``replica_argv`` is the serve CLI argv each replica worker re-parses
    (minus the control-plane flags, plus ``--replica-worker``)."""
    import shlex
    import signal as _signal
    import socket

    from ..runner.http_kv import RendezvousServer, new_secret
    from ..runner.safe_shell_exec import safe_execute
    from .router import Router

    server = RendezvousServer(secret=new_secret())
    port = server.start()
    addr = "127.0.0.1"
    try:
        addr = socket.gethostbyname(socket.gethostname())
    except OSError:
        pass

    max_replicas = int(args.max_replicas
                       if args.max_replicas is not None
                       else config.get_int("HVDT_SERVE_MAX_REPLICAS"))
    if args.host_discovery_script:
        hm = HostManager.from_script(args.host_discovery_script)
    else:
        hm = localhost_host_manager(max_replicas)

    worker_cmd = [sys.executable, "-m", "horovod_tpu_torch.serve",
                  *replica_argv, "--replica-worker"]

    def spawn_fn(slot: hosts_mod.SlotInfo, rid: int) -> int:
        env = dict(os.environ)
        env.update(slot.to_env())
        env.update({
            "HVDT_RENDEZVOUS_ADDR": addr,
            "HVDT_RENDEZVOUS_PORT": str(port),
            "HVDT_SECRET": server.secret.hex(),
            "HVDT_SERVE_REPLICA_ID": str(rid),
            "HVDT_RANK": str(rid),
        })
        cmd = " ".join(shlex.quote(c) for c in worker_cmd)
        return safe_execute(cmd, env=env, prefix=f"[replica {rid}]")

    slo = (args.slo_p99_ms if args.slo_p99_ms is not None
           else config.get_float("HVDT_SERVE_SLO_P99_MS"))
    driver = ServeDriver(
        server, spawn_fn, host_manager=hm,
        replicas=args.replicas, max_replicas=max_replicas,
        autoscale=args.autoscale or None,
        target_file=getattr(args, "target_file", None),
        policy=AutoscalePolicy(max_replicas=max_replicas,
                               slo_p99_ms=slo))
    router = Router(server, port=args.router_port, slo_p99_ms=slo)

    stop = threading.Event()
    for sig in (_signal.SIGTERM, _signal.SIGINT):
        try:
            _signal.signal(sig, lambda signum, frame: stop.set())
        except ValueError:
            pass

    try:
        driver.start()
        rport = router.start()
        print(f"serve: router on http://{router.host}:{rport} "
              f"(replicas={driver.target}, max={max_replicas}, "
              f"autoscale={'on' if driver._autoscale else 'off'}, "
              f"slo_p99_ms={slo or 'off'})", file=sys.stderr, flush=True)
        while not stop.wait(0.5):
            pass
        return 0
    finally:
        print("serve: control plane shutting down (draining replicas)",
              file=sys.stderr, flush=True)
        router.stop()
        driver.stop(drain=True)
        server.stop()
