"""Elastic driver: discovery loop, slot reassignment, worker lifecycle.

The port's counterpart of the JAX package's ``runner/elastic/driver.py``
(Horovod's runner/elastic/driver.py: ElasticDriver, the discovery thread
:181, host-assignment update :203-265, worker spawn :277, exit handling
:297).  Worker notification rides the rendezvous KV (workers poll a
version key at commit points), and re-rendezvous is a process restart:
every slot of a new generation is a fresh process that runs
``init()`` on the new topology and resumes from the persisted commit.

Where the port differs from the reference:

* A worker that fails ends its generation: the driver terminates the
  generation's other workers (SIGTERM, then SIGKILL after the grace of
  ``safe_shell_exec``) and records them READY.  A survivor blocked in an
  NCCL collective on a dead peer runs no Python handler and would wait
  for NCCL's watchdog; the driver does not wait for it.
* A generation whose every worker failed is respawned when the
  blacklist has a cooldown (``HVDT_ELASTIC_BLACKLIST_COOLDOWN_S`` > 0:
  the hosts come back) and ``--reset-limit`` allows; the reference ends
  the job.  A world of one has no survivor to report READY.
* The driver-side knobs given as flags (``--blacklist-cooldown``,
  ``--pod-size``) reach the driver's own discovery and pod tracking, not
  only the workers.
* Rank 0's host is every worker's coordinator (the ``torch.distributed``
  TCP store).  Generation 1's store listens on ``--coordinator-port``; a
  later generation whose coordinator is this host takes a port that is
  free when its rendezvous is planned, since a terminated worker of the
  generation before may still be exiting (its shell is gone, its SIGTERM
  handler runs) and hold the old listener.  A remote coordinator keeps
  ``--coordinator-port`` in every generation, as in the reference.
* The telemetry hooks are the reference's: the workers' KV snapshots
  (:meth:`ElasticDriver.telemetry_snapshots`, ``telemetry_rollup``),
  trace dumps and flight-recorder events; the cluster anomaly rules
  (``HVDT_EVENT_LOG``); the merged trace at the end of the run
  (``HVDT_TRACE_DIR``); and the pod-straggler eviction rung
  (``HVDT_POD_STRAGGLER_EVICT``).  The controller and fleet hooks are not
  ported: with their knob set (``HVDT_CONTROLLER``, ``HVDT_FLEET``) the
  driver raises ``NotImplementedError``; unset they do nothing, as in
  the reference.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ...common import config
from ...elastic import RESTART_EXIT_CODE
from ...resilience.preempt import PREEMPT_EXIT_CODE
from .. import hosts as hosts_mod
from ..http_kv import RendezvousServer, new_secret
from ..safe_shell_exec import safe_execute
from . import pods as pods_mod
from .discovery import HostManager
from .registration import WorkerStateRegistry, READY, SUCCESS, FAILURE

__all__ = ["ElasticDriver", "run_elastic", "RESTART_EXIT_CODE"]

_DISCOVERY_INTERVAL_S = 1.0

# The reference's driver hooks the port has not ported, by the knob that
# turns each on and the ROADMAP Queue 1 item that ports it.
_UNPORTED_HOOKS = {
    "HVDT_CONTROLLER": "item 8: control, analysis and the edges",
    "HVDT_FLEET": "item 8: control, analysis and the edges",
}


def _free_port() -> int:
    """A TCP port that is free on this host now."""
    with socket.socket() as sock:
        sock.bind(("", 0))
        return sock.getsockname()[1]


def refuse_unported_hooks(env: Dict[str, str]) -> None:
    """Raise ``NotImplementedError`` when ``env`` turns on a driver hook
    the port lacks (see the module docstring); do nothing otherwise."""
    for knob, item in _UNPORTED_HOOKS.items():
        value = env.get(knob, "").strip().lower()
        if value and value not in ("0", "off", "false", "no"):
            raise NotImplementedError(
                f"{knob}: the elastic driver's hook is not ported yet "
                f"(ROADMAP Queue 1, {item})")


@dataclasses.dataclass
class _WorkerProc:
    slot: hosts_mod.SlotInfo
    thread: threading.Thread
    generation: int


class ElasticDriver:
    """Drives elastic worker generations.

    ``spawn_fn(slot, generation)`` starts one worker and returns when it
    exits, reporting the exit code — injectable so unit tests can fake
    whole clusters (ref test strategy: test/single/test_elastic_driver.py,
    SURVEY.md §4 tier 2).
    """

    def __init__(self,
                 host_manager: HostManager,
                 min_np: int,
                 max_np: Optional[int] = None,
                 spawn_fn: Optional[Callable[..., int]] = None,
                 reset_limit: Optional[int] = None,
                 discovery_interval: float = _DISCOVERY_INTERVAL_S,
                 kv_server: Optional[RendezvousServer] = None,
                 hosts_updated_cb: Optional[Callable[[int], None]] = None,
                 elastic_timeout: float = 600.0,
                 pod_slots: int = 0,
                 pod_tracker: Optional[pods_mod.PodTracker] = None):
        self._hm = host_manager
        self._kv = kv_server
        self._hosts_updated_cb = hosts_updated_cb
        self._pending_updates = 0
        self._min_np = min_np
        self._max_np = max_np or min_np
        self._spawn_fn = spawn_fn or (lambda slot, gen: 0)
        self._interval = discovery_interval
        self._elastic_timeout = elastic_timeout
        # Pod-granular control plane (runner/elastic/pods.py): exit
        # correlation, preemption drains, straggler eviction.  With no
        # declared pods and pod_slots=0 everything degenerates to the
        # flat per-host semantics.
        self._pod_slots = pod_slots
        self._pods = pod_tracker or pods_mod.PodTracker()
        self.registry = WorkerStateRegistry(self._on_barrier,
                                            reset_limit=reset_limit)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._generation = 0
        self._assignments: List[hosts_mod.SlotInfo] = []
        self._workers: Dict[int, _WorkerProc] = {}
        self._shutdown = threading.Event()
        self._result: Optional[int] = None
        self._discovery_thread: Optional[threading.Thread] = None
        self._rendezvous_cb: Optional[Callable[[List[hosts_mod.SlotInfo],
                                                int], None]] = None
        self._reset_limit = reset_limit
        # Per generation: the event that terminates its workers, and the
        # ranks the driver terminated (their exits are READY, whatever
        # their code).
        self._terminate: Dict[int, threading.Event] = {}
        self._terminated: Dict[int, set] = {}
        self._failed_world_resets = 0
        # Cluster anomaly correlation (telemetry/anomaly.py): created
        # lazily on the first discovery tick that finds HVDT_EVENT_LOG
        # configured — cluster events (a pod-wide step-time shift is
        # ONE event) land in the driver's JSONL event log.
        self._cluster_anomalies = None

    # -- lifecycle ---------------------------------------------------------

    def start(self, rendezvous_cb=None) -> None:
        """rendezvous_cb(assignments, generation) publishes the new cluster
        spec (KV) before workers of that generation spawn."""
        self._rendezvous_cb = rendezvous_cb
        self._hm.update_available_hosts()
        self._discovery_thread = threading.Thread(
            target=self._discovery_loop, daemon=True, name="hvdt-elastic")
        self._discovery_thread.start()
        self._rendezvous()

    def stop(self) -> None:
        self._shutdown.set()
        with self._cond:
            self._cond.notify_all()

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        """Block until the job finishes; returns the exit code."""
        deadline = (time.monotonic() + timeout) if timeout else None
        with self._cond:
            while self._result is None and not self._shutdown.is_set():
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                self._cond.wait(remaining if remaining else 1.0)
            return self._result

    # -- discovery ---------------------------------------------------------

    def _discovery_loop(self) -> None:
        while not self._shutdown.wait(self._interval):
            try:
                changed = self._hm.update_available_hosts()
            except Exception as e:   # discovery scripts may flake
                print(f"elastic: discovery failed: {e}", file=sys.stderr)
                continue
            if changed:
                self._notify_hosts_updated()
            self._poll_worker_registry()
            self._check_pod_stragglers()
            self._check_cluster_anomalies()

    def _poll_worker_registry(self) -> None:
        """Feed KV-reported worker states (workers put
        /registry/<generation>/<rank> = READY|SUCCESS|FAILURE at commit
        points — the KV replaces the reference's in-worker RPC listener,
        ref: runner/elastic/worker.py WorkerNotificationService)."""
        if self._kv is None:
            return
        gen = self.generation
        prefix = f"/registry/{gen}/"
        with self._kv.lock:
            items = {k: v for k, v in self._kv.store.items()
                     if k.startswith(prefix)}
        for key, val in items.items():
            try:
                rank = int(key.rsplit("/", 1)[1])
            except ValueError:
                continue
            state = val.decode()
            if state == READY:
                self.registry.record_ready(rank)
            elif state == SUCCESS:
                self.registry.record_success(rank)
            elif state == FAILURE:
                self.registry.record_failure(rank)

    def record_ready(self, rank: int) -> None:
        """A live worker requests re-rendezvous (HostsUpdatedInterrupt or
        collective failure recovery in its training loop)."""
        self.registry.record_ready(rank)

    def telemetry_snapshots(self):
        """Aggregate worker telemetry snapshots from the rendezvous KV
        (workers publish /telemetry/<rank> every
        HVDT_TELEMETRY_PUBLISH_S when HVDT_TELEMETRY is on).  Returns
        {rank: snapshot_dict}; empty when no KV or nothing published —
        the driver-side half of the observability subsystem
        (telemetry/exporter.collect_driver_snapshots).  Each snapshot
        carries the worker's pod id plus its kv_retries_total /
        kv_errors_total counters, so control-plane flakiness is visible
        fleet-wide from the driver; the snapshots also feed the
        pod-straggler eviction rung (_check_pod_stragglers)."""
        if self._kv is None:
            return {}
        from ...telemetry.exporter import collect_driver_snapshots

        return collect_driver_snapshots(self._kv)

    def trace_dumps(self):
        """Per-rank Chrome-trace dumps published to the rendezvous KV
        (workers publish /trace/<rank> when HVDT_TRACE_DIR is set —
        merged into one rank-as-pid trace by telemetry.trace.merge_dumps
        / write_merged; run_elastic writes trace_merged.json under
        --trace-dir).  Returns {rank: dump}; empty without a KV."""
        if self._kv is None:
            return {}
        from ...telemetry.trace import collect_server_dumps

        return collect_server_dumps(self._kv)

    def flight_recorder_events(self):
        """Per-rank collective flight-recorder event lists from the
        rendezvous KV (/flightrecorder/<rank>) — the raw material of
        telemetry.flight_recorder.analyze_desync."""
        if self._kv is None:
            return {}
        from ...telemetry.flight_recorder import collect_server_events

        return collect_server_events(self._kv)

    def telemetry_rollup(self):
        """Step-aligned fleet roll-up over the latest KV snapshots
        (telemetry/aggregate.rollup): per-pod median/p99 step time,
        cluster wire-bytes-by-axis, goodput series, worst pod.  Ranks
        publishing the old snapshot schema (no step id / time series)
        are skipped and counted, never failed."""
        snaps = self.telemetry_snapshots()
        if not snaps:
            return {}
        from ...telemetry import aggregate as _aggregate

        return _aggregate.rollup(snaps)

    def _check_cluster_anomalies(self):
        """Run the cluster anomaly rules over the fleet snapshots each
        discovery tick (active only when HVDT_EVENT_LOG names a driver-
        side event log — the zero-overhead gate).  Returns the events
        that newly fired this tick — the controller's input."""
        if self._kv is None:
            return []
        events = []
        try:
            from ...telemetry import anomaly as _anomaly

            if self._cluster_anomalies is None:
                if _anomaly.get_event_log() is None:
                    return []
                self._cluster_anomalies = _anomaly.ClusterAnomalyMonitor()
            snaps = self.telemetry_snapshots()
            if not snaps:
                return []
            events = self._cluster_anomalies.observe(snaps)
            for ev in events:
                print(f"elastic: anomaly {ev.get('kind')} "
                      f"({ev.get('scope')}): {ev.get('message')}",
                      file=sys.stderr)
        except Exception as e:   # detection must never sink the driver
            print(f"elastic: cluster anomaly check failed: {e}",
                  file=sys.stderr)
        return events

    def _check_pod_stragglers(self) -> None:
        """The pod-granular escalation rung over the straggler
        gauges: aggregate per-rank step-time medians from the telemetry
        snapshots into per-pod medians; a pod slower than threshold x
        the cross-pod median for HVDT_POD_STRAGGLER_EVICT consecutive
        windows is EVICTED — blacklisted (cooldown applies, so a
        recovered pod can rejoin) and the run resizes down to the
        remaining pod multiple instead of limping at the slow pod's
        pace."""
        if self._pods.evict_windows <= 0 or self._kv is None:
            return
        snaps = self.telemetry_snapshots()
        if not snaps or not self._pods.snapshots_fingerprint(snaps):
            return
        rank_pod = {s.rank: s.pod for s in self.assignments}
        by_pod: Dict[str, List[float]] = {}
        for rank, snap in snaps.items():
            ms = snap.get("step_time_p50_ms")
            pod = snap.get("pod") or rank_pod.get(rank)
            if ms and pod:
                by_pod.setdefault(pod, []).append(float(ms))
        medians = {p: sorted(v)[(len(v) - 1) // 2]
                   for p, v in by_pod.items()}
        for pod in self._pods.observe_step_medians(medians):
            print(f"elastic: pod {pod} evicted as straggler "
                  f"(median step {medians[pod]:.1f} ms over "
                  f"{self._pods.evict_windows} windows)", file=sys.stderr)
            self._hm.blacklist_pod(pod)
            self._hm.update_available_hosts()
            self._notify_hosts_updated()

    def _notify_hosts_updated(self) -> None:
        with self._cond:
            self._cond.notify_all()
            self._pending_updates += 1
            n = self._pending_updates
        # Publish so live workers see the membership change at their next
        # commit and exit for respawn (the KV replaces the reference's
        # in-worker notification RPC, runner/elastic/worker.py).
        if self._hosts_updated_cb is not None:
            self._hosts_updated_cb(n)

    def _usable_slots(self) -> int:
        """Slots assignable at pod granularity: whole same-size pods
        only, minus drained (preempted) pods — so the rendezvous wait
        doesn't end on a half-discovered pod it can't place."""
        return pods_mod.usable_slots(self._hm.current.hosts,
                                     self._pod_slots,
                                     self._pods.drained_pods())

    def wait_for_available_slots(self, min_np: int,
                                 timeout: float = 600.0) -> None:
        """(ref: driver.py:145) block until discovery reports >= min_np
        pod-assignable slots."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._usable_slots() < min_np:
                if self._shutdown.is_set():
                    raise RuntimeError("driver shut down while waiting")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"timed out waiting for {min_np} slots; discovered "
                        f"{self._usable_slots()}")
                self._cond.wait(min(remaining, self._interval))

    # -- rendezvous / spawn ------------------------------------------------

    def _rendezvous(self) -> None:
        # Recovery-budget attribution, driver side: the rendezvous phase
        # starts the moment a new generation is needed and ends when
        # every slot of the new world has been handed to a spawner.
        # Workers attribute their own boot restore/replay; the driver
        # owns the slot-wait + assignment + publish window.
        t0 = time.monotonic()
        self.wait_for_available_slots(self._min_np,
                                      timeout=self._elastic_timeout)
        with self._lock:
            self._generation += 1
            gen = self._generation
            self._assignments = pods_mod.plan_assignments(
                self._hm.current.hosts, self._min_np, self._max_np,
                pod_slots=self._pod_slots,
                exclude=self._pods.drained_pods())
            self.registry.reset(len(self._assignments))
        layout = pods_mod.pod_layout(self._assignments)
        print(f"elastic: rendezvous generation {gen}: "
              f"{len(self._assignments)} slots in {layout['num_pods']} "
              f"pod(s) x {layout['pod_size']} "
              f"(dcn={layout['mesh']['dcn']}, ici={layout['mesh']['ici']})",
              file=sys.stderr)
        if self._rendezvous_cb:
            self._rendezvous_cb(self._assignments, gen)
        for slot in self._assignments:
            self._start_worker(slot, gen)
        self.last_rendezvous_seconds = time.monotonic() - t0
        self.rendezvous_seconds_total = getattr(
            self, "rendezvous_seconds_total", 0.0) \
            + self.last_rendezvous_seconds
        if gen > 1:
            # Generation 1 is job boot, not recovery; later generations
            # are the rendezvous leg of a recovery and are printed so
            # scenario harnesses (and operators reading driver logs) can
            # audit the budget without scraping worker metrics.
            print(f"elastic: generation {gen} rendezvous took "
                  f"{self.last_rendezvous_seconds:.2f}s", file=sys.stderr)

    def _start_worker(self, slot: hosts_mod.SlotInfo, gen: int) -> None:
        def _run():
            try:
                code = self._spawn_fn(slot, gen)
            except Exception as e:
                print(f"elastic: worker {slot.rank} spawn error: {e}",
                      file=sys.stderr)
                code = 1
            self.record_exit(slot, gen, code)

        t = threading.Thread(target=_run, daemon=True,
                             name=f"hvdt-worker-{slot.rank}")
        with self._lock:
            self._workers[slot.rank] = _WorkerProc(slot, t, gen)
        t.start()

    def terminate_event(self, gen: int) -> threading.Event:
        """The event whose setting terminates generation ``gen``'s
        workers (``safe_execute(terminate_event=)``: SIGTERM to each
        worker's process group, then SIGKILL after the grace)."""
        with self._lock:
            return self._terminate.setdefault(gen, threading.Event())

    def _terminate_generation(self, gen: int, failed_rank: int) -> None:
        """A worker of ``gen`` failed: end the generation.  Its other
        workers may be blocked in a collective on the dead peer, where no
        Python handler runs, so they are terminated and their exits
        recorded READY."""
        with self._lock:
            self._terminated[gen] = {s.rank for s in self._assignments
                                     if s.rank != failed_rank}
            event = self._terminate.setdefault(gen, threading.Event())
        print(f"elastic: terminating generation {gen} after rank "
              f"{failed_rank} failed", file=sys.stderr)
        event.set()

    def record_exit(self, slot: hosts_mod.SlotInfo, gen: int,
                    code: int) -> None:
        with self._lock:
            if gen != self._generation:
                return   # stale worker from a previous generation
            terminated = slot.rank in self._terminated.get(gen, ())
        pod = slot.pod or self._hm.pod_of(slot.hostname)
        if code == 0:
            self.registry.record_success(slot.rank)
            return
        if code == RESTART_EXIT_CODE or terminated:
            # Worker observed a membership change and exited for respawn,
            # or the driver ended its generation: it is READY for the
            # next rendezvous, not failed.
            self.registry.record_ready(slot.rank)
            return
        if code == PREEMPT_EXIT_CODE:
            # Clean preemption exit (resilience/preempt.py): the worker
            # checkpointed and its host is going away.  Preemption
            # reclaims whole pods, so ONE rank's grace-window exit
            # drains its entire pod: the next rendezvous won't place
            # workers on the pod's other hosts even while discovery
            # still lists them.  No blacklist, no failure count.
            if self._pods.drain(pod):
                print(f"elastic: pod {pod} draining (rank {slot.rank} "
                      f"preempted on {slot.hostname}, clean removal)",
                      file=sys.stderr)
            self.registry.record_ready(slot.rank)
            return
        # Failed worker ⇒ suspect POD (ref: driver.py:297 exit handling +
        # discovery blacklist).  Exits of one pod's ranks within
        # HVDT_POD_EXIT_WINDOW_S are one correlated loss: the first opens
        # the pod-removal event and blacklists the pod ONCE; the rest
        # fold into it (no cooldown doubling, no N independent recovery
        # decisions).
        if self._pods.record_failure(pod):
            print(f"elastic: pod-removal event for pod {pod} "
                  f"(rank {slot.rank} on {slot.hostname} exited "
                  f"{code}); correlated exits within the window "
                  f"fold into this event", file=sys.stderr)
            self._hm.blacklist_pod(pod)
            self._hm.update_available_hosts()
        self._terminate_generation(gen, slot.rank)
        self.registry.record_failure(slot.rank)

    # -- barrier -----------------------------------------------------------

    def _on_barrier(self, states: Dict[str, set]) -> None:
        if states[READY]:
            if self.registry.reset_limit_reached():
                self._finish(1)
                return
            threading.Thread(target=self._safe_rerendezvous,
                             daemon=True).start()
        elif states[FAILURE]:
            if (len(states[FAILURE]) < len(self._assignments)
                    or self._respawn_failed_world()):
                # Partial failure: survivors need a new, smaller
                # rendezvous; or every worker failed on hosts that come
                # back after their cooldown.
                threading.Thread(target=self._safe_rerendezvous,
                                 daemon=True).start()
            else:
                self._finish(1)
        else:
            self._finish(0)

    def _respawn_failed_world(self) -> bool:
        """Whether a generation whose every worker failed is respawned:
        only while the blacklist has a cooldown (the failed hosts come
        back) and the resets so far stay under ``--reset-limit``."""
        if config.get_float("HVDT_ELASTIC_BLACKLIST_COOLDOWN_S") <= 0:
            return False
        with self._lock:
            resets = self.registry.reset_count + self._failed_world_resets
            if self._reset_limit is not None and resets >= self._reset_limit:
                return False
            self._failed_world_resets += 1
        return True

    def _safe_rerendezvous(self) -> None:
        try:
            self._rendezvous()
        except (TimeoutError, RuntimeError) as e:
            print(f"elastic: cannot re-rendezvous: {e}", file=sys.stderr)
            self._finish(1)

    def _finish(self, code: int) -> None:
        with self._cond:
            if self._result is None:
                self._result = code
            self._cond.notify_all()

    # -- introspection (tests) --------------------------------------------

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    @property
    def assignments(self) -> List[hosts_mod.SlotInfo]:
        with self._lock:
            return list(self._assignments)


def run_elastic(args) -> int:
    """CLI entry for ``hvdtrun --host-discovery-script ...``
    (ref: launch.py:621 _run_elastic → gloo_run.py:340)."""
    from ..launch import _build_command, _is_local, check_local_cards
    from ..launch import knob_env_for

    knob_env = knob_env_for(args)
    refuse_unported_hooks({**os.environ, **knob_env})
    # The driver's own discovery and pod tracking read these knobs in
    # THIS process; knob_env alone only reaches the workers.
    for k in ("HVDT_ELASTIC_BLACKLIST_COOLDOWN_S", "HVDT_POD_SIZE",
              "HVDT_POD_EXIT_WINDOW_S", "HVDT_POD_DRAIN_GRACE_S",
              "HVDT_POD_STRAGGLER_EVICT"):
        if k in knob_env:
            os.environ[k] = knob_env[k]

    hm = HostManager.from_script(args.host_discovery_script,
                                 default_slots=args.slots_per_host)
    min_np = args.min_np or args.num_proc or 1
    max_np = args.max_np or args.num_proc or min_np

    server = RendezvousServer(secret=new_secret())
    port = server.start()

    def routable_addr() -> str:
        """This host's address as a remote worker reaches it."""
        if getattr(args, "nics", None):
            from ..launch import _nic_addr

            nic = _nic_addr(args.nics.split(","))
            if nic:
                return nic
        return socket.gethostbyname(socket.gethostname())

    pending_state = {"n": 0}
    coordinator: Dict[int, Tuple[str, int]] = {}

    def rendezvous_cb(slots: List[hosts_mod.SlotInfo], gen: int) -> None:
        import json as _json

        check_local_cards(slots, args.command)
        host = slots[0].hostname
        coordinator[gen] = (host, _free_port() if gen > 1 and _is_local(host)
                            else args.coordinator_port)
        spec = "\n".join(
            f"{s.rank},{s.hostname},{s.local_rank},{s.cross_rank},"
            f"{s.size},{s.local_size},{s.cross_size},"
            f"{s.pod},{s.pod_index},{s.pod_rank}" for s in slots)
        server.put_local(f"/rendezvous/{gen}/spec", spec.encode())
        # Freeze the pending-updates counter as of this rendezvous so
        # generation-gen workers baseline against it (worker.py init):
        # membership changes during their boot window stay visible.
        server.put_local(f"/rendezvous/{gen}/pending_base",
                         str(pending_state["n"]).encode())
        # The two-level pod layout next to the flat spec (the
        # reference's /rendezvous/<gen>/pods document).
        server.put_local(f"/rendezvous/{gen}/pods", _json.dumps(
            pods_mod.pod_layout(slots)).encode())
        server.put_local("/rendezvous/version", str(gen).encode())

    def hosts_updated_cb(n: int) -> None:
        pending_state["n"] = n
        server.put_local("/rendezvous/pending", str(n).encode())

    def spawn_fn(slot: hosts_mod.SlotInfo, gen: int) -> int:
        local = _is_local(slot.hostname)
        coord, coord_port = coordinator[gen]
        if _is_local(coord) and local:
            coord = "127.0.0.1"
        base_env = {
            "HVDT_RENDEZVOUS_ADDR": "127.0.0.1" if local
            else routable_addr(),
            "HVDT_RENDEZVOUS_PORT": str(port),
            "HVDT_SECRET": server.secret.hex(),
            "HVDT_COORDINATOR_ADDR": f"{coord}:{coord_port}",
            "HVDT_ELASTIC": "1",
            "HVDT_GENERATION": str(gen),
            **knob_env,
        }
        cmd, env = _build_command(args, slot, base_env, args.command)
        prefix = f"[{slot.rank}]" if args.verbose else ""
        return safe_execute(cmd, env=env, prefix=prefix,
                            terminate_event=driver.terminate_event(gen))

    def _int_knob(name: str) -> int:
        raw = knob_env.get(name) or os.environ.get(name) or "0"
        try:
            return int(raw)
        except ValueError:
            return 0

    tracker = pods_mod.PodTracker(
        evict_windows=_int_knob("HVDT_POD_STRAGGLER_EVICT") or None)
    # kv_server wires the driver-side KV consumers: worker state
    # publishes (/registry), telemetry snapshot aggregation, and the
    # pod-straggler eviction rung those snapshots feed.
    driver = ElasticDriver(hm, min_np, max_np, spawn_fn,
                           reset_limit=args.reset_limit,
                           kv_server=server,
                           hosts_updated_cb=hosts_updated_cb,
                           elastic_timeout=getattr(args, "elastic_timeout",
                                                   600.0),
                           pod_slots=config.get_int("HVDT_POD_SIZE"),
                           pod_tracker=tracker)
    try:
        driver.start(rendezvous_cb)
        code = driver.wait()
        return code if code is not None else 1
    finally:
        driver.stop()
        for gen in range(1, driver.generation + 1):
            driver.terminate_event(gen).set()
        try:
            # The fleet view over the workers' last KV snapshots (none
            # unless they run with HVDT_TELEMETRY on), as one line.
            rollup = driver.telemetry_rollup()
            if rollup:
                import json as _json

                print("elastic: telemetry roll-up "
                      + _json.dumps(rollup, sort_keys=True),
                      file=sys.stderr)
        except Exception as e:
            print(f"elastic: telemetry roll-up failed: {e}", file=sys.stderr)
        trace_dir = knob_env.get("HVDT_TRACE_DIR") or \
            os.environ.get("HVDT_TRACE_DIR", "")
        if trace_dir:
            # Driver-side merge (hvdtrun --trace-dir): pull every rank's
            # published dump from the KV before the server dies and emit
            # the single rank-as-pid Chrome trace.
            try:
                from ...telemetry.trace import write_merged

                merged = write_merged(server, trace_dir)
                if merged:
                    print(f"elastic: merged trace written to {merged}",
                          file=sys.stderr)
            except Exception as e:
                print(f"elastic: trace merge failed: {e}", file=sys.stderr)
        server.stop()
