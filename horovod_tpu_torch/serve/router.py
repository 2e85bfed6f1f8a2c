"""SLO-routing serving front tier: one endpoint over N elastic replicas.

The port's copy of the JAX package's ``serve/router.py`` (host-side
logic only).

The router is the piece that turns "a replica crashed" from a dropped
request into a retry nobody noticed.  It discovers live replicas from
the rendezvous KV the elastic driver already runs (``/serve/replicas/
<id>`` heartbeats, serve/replica.py), load-balances ``/predict`` across
them, and routes *around* trouble: utilization is won by not waiting on
slow or dead participants.

Routing policy, in the order it saves a request:

* **Least-inflight pick** — the router tracks its own in-flight count
  per replica (its view of load is fresher than any heartbeat) and
  routes to the least-loaded admitting replica.
* **Retry budget** — a dispatch that dies on the wire (connection
  refused/reset, 5xx) is retried on a *different* replica under a
  jittered :class:`~horovod_tpu_torch.resilience.retry.Backoff` bounded by
  the request deadline.  ``/predict`` is idempotent (pure inference);
  callers that disagree send ``X-HVDT-No-Retry: 1``.
* **Hedging** — a request still unanswered past the hedge threshold
  (``HVDT_SERVE_HEDGE_MS``; 0 = adaptive ~2x observed p99) is
  duplicated to a second replica and the first response wins — the
  tail-at-scale answer to one replica having a bad moment.
* **Ejection** — a replica is pulled from routing when its heartbeat
  goes stale (missed ``2 x HVDT_SERVE_HEARTBEAT_S``), its health probe
  fails, its reported p99 breaches ``HVDT_SERVE_SLO_P99_MS``, or a
  dispatch to it fails; ejections sit out
  ``HVDT_SERVE_EJECT_COOLDOWN_S`` (doubling per repeat — the elastic
  blacklist-cooldown idiom, reusing
  :class:`runner.elastic.discovery.HostState`) and re-admit once the
  heartbeat is fresh again.

Chaos seam: every dispatch fires the ``serve.dispatch`` fault point
(``HVDT_FAULT_PLAN=serve_crash@point=serve.dispatch`` /
``slow_replica@...``), so the router is testable under the same
deterministic fault plans as the training stack.
"""

from __future__ import annotations

import http.client
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from ..common import config
from ..common.logging_util import get_logger
from ..resilience import faults
from ..resilience.retry import Backoff
from ..runner.elastic.discovery import HostState
from .metrics import MetricsRegistry
from .replica import REPLICA_KV_PREFIX

__all__ = ["Router", "ReplicaView", "NoReplicaAvailable"]

log = get_logger(__name__)

# The SLO classes a continuous engine schedules (interactive, batch)
# plus the bucket everything else lands in — a fixed set so
# request bodies can't mint unbounded label cardinality.
_TENANTS = ("interactive", "batch", "default")


class NoReplicaAvailable(RuntimeError):
    """No admitting replica in the routing set (all dead, draining, or
    ejected) — the router's 503."""


class ReplicaView:
    """The router's working state for one discovered replica."""

    def __init__(self, replica_id: int, eject_cooldown_s: float):
        self.id = replica_id
        self.doc: Dict[str, Any] = {}
        self.inflight = 0
        self.fail_streak = 0
        self.state = HostState(cooldown_s=eject_cooldown_s)
        self.ejected = False          # currently serving an eject cooldown
        self.last_seen = 0.0          # monotonic at last fresh heartbeat

    @property
    def host(self) -> str:
        return self.doc.get("host", "")

    @property
    def port(self) -> int:
        return int(self.doc.get("port", 0))

    @property
    def draining(self) -> bool:
        return bool(self.doc.get("draining"))

    def describe(self) -> Dict[str, Any]:
        return {
            "id": self.id, "host": self.host, "port": self.port,
            "inflight": self.inflight, "draining": self.draining,
            "ejected": self.state.is_blacklisted,
            "p99_ms": self.doc.get("p99_ms"),
            "queue_depth": self.doc.get("queue_depth"),
        }


class _Handler(BaseHTTPRequestHandler):
    router: "Router"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        log.debug("router http: " + fmt, *args)

    def _reply(self, status: int, body: bytes,
               content_type: str = "application/json",
               extra_headers: Optional[dict] = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        rt = self.router
        route = self.path.split("?")[0]
        if route == "/healthz":
            self._reply(200, json.dumps(rt.describe()).encode())
        elif route == "/metrics":
            self._reply(200, rt.metrics.render().encode(),
                        content_type="text/plain; version=0.0.4")
        else:
            self._reply(404, json.dumps(
                {"error": f"no route {self.path!r}"}).encode())

    def do_POST(self):
        rt = self.router
        t0 = time.perf_counter()
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)   # always consume: keep-alive
        if self.path.split("?")[0] != "/predict":
            self._reply(404, json.dumps(
                {"error": f"no route {self.path!r}"}).encode())
            return
        retry_ok = self.headers.get("X-HVDT-No-Retry", "") not in ("1",
                                                                   "true")
        tenant = rt.tenant_of(body)
        try:
            status, payload, replica_id = rt.dispatch(body,
                                                      retry=retry_ok,
                                                      tenant=tenant)
        except NoReplicaAvailable as e:
            rt._no_replica.inc()
            self._reply(503, json.dumps({"error": str(e)}).encode(),
                        extra_headers={"Retry-After": "1"})
            rt._observe("predict", t0, 503, tenant=tenant)
            return
        headers = {}
        if replica_id is not None:
            headers["X-HVDT-Replica"] = str(replica_id)
        if status == 503:
            headers["Retry-After"] = "1"
        self._reply(status, payload, extra_headers=headers)
        rt._observe("predict", t0, status, tenant=tenant)


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = 256


class Router:
    """The assembled front tier.

    ``kv`` must expose the rendezvous server's ``lock``/``store`` (the
    router runs in the driver process, next to the
    :class:`~horovod_tpu_torch.runner.http_kv.RendezvousServer`) — replica
    discovery is a prefix scan, which the KV's HTTP client surface does
    not offer.
    """

    def __init__(self, kv: Any, *,
                 host: Optional[str] = None, port: Optional[int] = None,
                 heartbeat_s: Optional[float] = None,
                 slo_p99_ms: Optional[float] = None,
                 hedge_ms: Optional[float] = None,
                 eject_cooldown_s: Optional[float] = None,
                 request_timeout_s: Optional[float] = None,
                 probe: bool = True,
                 metrics: Optional[MetricsRegistry] = None):
        if not (hasattr(kv, "lock") and hasattr(kv, "store")):
            raise TypeError("Router needs the rendezvous KV *server* "
                            "(lock/store) for replica prefix scans")
        self._kv = kv
        self.host = host if host is not None \
            else config.get_str("HVDT_SERVE_HOST")
        self.port = int(port if port is not None
                        else config.get_int("HVDT_SERVE_ROUTER_PORT"))
        self.heartbeat_s = float(
            heartbeat_s if heartbeat_s is not None
            else config.get_float("HVDT_SERVE_HEARTBEAT_S"))
        self.slo_p99_ms = float(
            slo_p99_ms if slo_p99_ms is not None
            else config.get_float("HVDT_SERVE_SLO_P99_MS"))
        self.hedge_ms = float(
            hedge_ms if hedge_ms is not None
            else config.get_float("HVDT_SERVE_HEDGE_MS"))
        self.eject_cooldown_s = float(
            eject_cooldown_s if eject_cooldown_s is not None
            else config.get_float("HVDT_SERVE_EJECT_COOLDOWN_S"))
        self.request_timeout_s = float(
            request_timeout_s if request_timeout_s is not None
            else config.get_float("HVDT_SERVE_REQUEST_TIMEOUT_S"))
        self._probe = probe
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        self._requests = m.counter(
            "hvdt_router_requests_total",
            "Requests through the router by route, upstream status and "
            "tenant class")
        self._latency = m.summary(
            "hvdt_router_request_latency_ms",
            "End-to-end router /predict latency (ms), retries and "
            "hedges included")
        # Per-tenant latency rides the same name-family idiom as the
        # continuous engine's hvdt_engine_wait_ms_<tenant> (a Summary
        # carries no labels); tenant classes come from the request body
        # the continuous engine already carries.
        self._tenant_latency = {
            t: m.summary(f"hvdt_router_request_latency_ms_{t}",
                         f"End-to-end /predict latency, {t} tenant (ms)")
            for t in _TENANTS}
        self._upstream = m.summary(
            "hvdt_router_upstream_latency_ms",
            "Single-attempt replica round-trip latency (ms) — feeds "
            "the adaptive hedge threshold")
        self._retries = m.counter(
            "hvdt_router_retries_total",
            "Dispatch attempts retried on another replica after a "
            "wire/5xx failure, by tenant")
        self._hedges = m.counter(
            "hvdt_router_hedges_total",
            "Hedge requests issued past the hedge threshold, by tenant")
        self._hedge_wins = m.counter(
            "hvdt_router_hedge_wins_total",
            "Hedge requests that answered before the primary, by tenant")
        self._ejections = m.counter(
            "hvdt_router_ejections_total",
            "Replicas pulled from routing, labelled reason="
            "heartbeat|probe|slo|dispatch and the tenant whose traffic "
            "triggered it (tenant=control for control-loop ejections)")
        self._readmissions = m.counter(
            "hvdt_router_readmissions_total",
            "Ejected replicas re-admitted after cooldown with a fresh "
            "heartbeat")
        self._no_replica = m.counter(
            "hvdt_router_no_replica_total",
            "Requests shed 503 because no admitting replica existed")
        m.gauge(
            "hvdt_router_replicas_live",
            "Replicas currently admitting traffic through the router"
        ).set_function(lambda: float(len(self._routable())))
        m.gauge(
            "hvdt_router_inflight",
            "Requests currently in flight through the router"
        ).set_function(lambda: float(self._inflight_total()))

        self._lock = threading.Lock()
        self._replicas: Dict[int, ReplicaView] = {}
        self._seq = 0
        self._stop = threading.Event()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._control_thread: Optional[threading.Thread] = None

    # -- discovery / control ----------------------------------------------

    def _scan_kv(self) -> Dict[int, Dict[str, Any]]:
        with self._kv.lock:
            items = {k: v for k, v in self._kv.store.items()
                     if k.startswith(REPLICA_KV_PREFIX)}
        out: Dict[int, Dict[str, Any]] = {}
        for key, raw in items.items():
            try:
                rid = int(key[len(REPLICA_KV_PREFIX):])
                out[rid] = json.loads(raw.decode())
            except (ValueError, UnicodeDecodeError):
                continue
        return out

    def refresh(self) -> None:
        """One discovery pass: fold fresh heartbeats in, age out dead
        replicas, apply SLO ejection, count re-admissions."""
        docs = self._scan_kv()
        now = time.monotonic()
        liveness = 2.0 * self.heartbeat_s
        with self._lock:
            for rid, doc in docs.items():
                view = self._replicas.get(rid)
                if view is None:
                    view = ReplicaView(rid, self.eject_cooldown_s)
                    self._replicas[rid] = view
                    log.info("router: discovered replica %d at %s:%s",
                             rid, doc.get("host"), doc.get("port"))
                prev_ts = view.doc.get("ts")
                view.doc = doc
                if doc.get("ts") != prev_ts:
                    view.last_seen = now
                if view.last_seen == 0.0:
                    view.last_seen = now
            views = list(self._replicas.items())
        for rid, view in views:
            if rid not in docs or now - view.last_seen > liveness:
                # The replica left the KV (clean deregistration) or its
                # heartbeat went stale (it died without saying goodbye).
                # Remove it outright — a rejoin under the same id
                # re-enters through discovery.  Only the no-goodbye case
                # is an ejection event; a drained replica leaving is the
                # control plane working.
                with self._lock:
                    self._replicas.pop(rid, None)
                if rid not in docs and view.draining:
                    log.info("router: replica %d deregistered after "
                             "drain", rid)
                else:
                    self._ejections.inc(reason="heartbeat",
                                        tenant="control")
                    log.warning("router: replica %d heartbeat stale "
                                "(> %.1fs) — removed from routing",
                                rid, liveness)
                continue
            if view.ejected and not view.state.is_blacklisted:
                view.ejected = False
                view.fail_streak = 0
                self._readmissions.inc()
                log.info("router: replica %d re-admitted after eject "
                         "cooldown", rid)
            p99 = view.doc.get("p99_ms")
            if (self.slo_p99_ms > 0 and p99 and not view.ejected
                    and float(p99) > self.slo_p99_ms):
                self._eject(view, "slo",
                            f"reported p99 {float(p99):.1f}ms breaches "
                            f"SLO {self.slo_p99_ms:.1f}ms")

    def _eject(self, view: ReplicaView, reason: str, why: str,
               tenant: str = "control") -> None:
        view.state.blacklist()
        view.ejected = True
        self._ejections.inc(reason=reason, tenant=tenant)
        log.warning("router: ejecting replica %d (%s: %s; cooldown "
                    "%.1fs base)", view.id, reason, why,
                    self.eject_cooldown_s)

    def probe_replicas(self) -> None:
        """Active /healthz probes of routable replicas — catches a hung
        process whose heartbeat thread still beats."""
        for view in self._routable():
            try:
                conn = http.client.HTTPConnection(
                    view.host, view.port, timeout=max(1.0,
                                                      self.heartbeat_s))
                try:
                    conn.request("GET", "/healthz")
                    r = conn.getresponse()
                    r.read()
                    ok = r.status == 200
                finally:
                    conn.close()
            except (ConnectionError, OSError):
                ok = False
            if not ok:
                self._eject(view, "probe", "health probe failed")

    def _control_loop(self) -> None:
        period = max(0.05, self.heartbeat_s / 2.0)
        while not self._stop.wait(period):
            try:
                self.refresh()
                self._check_traffic_faults()
                if self._probe:
                    self.probe_replicas()
            except Exception:   # pragma: no cover - defensive
                log.exception("router control loop error")

    def _check_traffic_faults(self) -> None:
        """Fire the ``serve.traffic`` injection point (``traffic_spike``
        faults arm here; ``step`` = the dispatch count, matching the
        ``serve_crash`` convention) and account any open spike windows
        as synthetic offered load — the rps shows up in ``describe()``
        and the fleet scheduler's pressure picture, so a chaos plan can
        force a flash crowd without a load generator."""
        from ..resilience import faults

        inj = faults.get_injector()
        if inj is None:
            self.synthetic_rps = 0.0
            return
        with self._lock:
            seq = getattr(self, "_dispatch_seq", 0)
        inj.fire("serve.traffic", step=seq)
        self.synthetic_rps = inj.extra_rps()

    # -- routing -----------------------------------------------------------

    def _routable(self) -> List[ReplicaView]:
        with self._lock:
            return [v for v in self._replicas.values()
                    if v.doc and not v.draining
                    and not v.state.is_blacklisted]

    def _inflight_total(self) -> int:
        with self._lock:
            return sum(v.inflight for v in self._replicas.values())

    def _pick(self, exclude: Optional[set] = None
              ) -> Optional[ReplicaView]:
        """Least-inflight admitting replica (router-local view), ties
        broken by a rotating sequence so equal replicas share load."""
        candidates = [v for v in self._routable()
                      if not exclude or v.id not in exclude]
        if not candidates:
            return None
        with self._lock:
            self._seq += 1
            seq = self._seq
        return min(candidates,
                   key=lambda v: (v.inflight, (v.id + seq) % 997))

    def _hedge_delay(self) -> Optional[float]:
        """Seconds before a hedge fires, or None when hedging is off."""
        if self.hedge_ms < 0:
            return None
        if self.hedge_ms > 0:
            return self.hedge_ms / 1000.0
        # Adaptive: past ~2x the observed upstream p99, floored — but
        # only once there is enough signal to call anything "slow".
        if self._upstream.count < 20:
            return None
        p99 = self._upstream.quantile(0.99)
        if p99 is None:
            return None
        return max(0.05, 2.0 * p99 / 1000.0)

    def _forward_once(self, view: ReplicaView, body: bytes,
                      timeout: float) -> Tuple[int, bytes]:
        """One upstream round trip.  Raises ConnectionError/OSError on
        wire death (the retryable class); returns (status, payload)
        otherwise."""
        with self._lock:
            view.inflight += 1
        t0 = time.perf_counter()
        try:
            conn = http.client.HTTPConnection(view.host, view.port,
                                              timeout=timeout)
            try:
                conn.request("POST", "/predict", body=body,
                             headers={"Content-Type": "application/json"})
                r = conn.getresponse()
                payload = r.read()
                status = r.status
            finally:
                conn.close()
        except (ConnectionError, OSError):
            with self._lock:
                view.inflight -= 1
                view.fail_streak += 1
            raise
        ms = (time.perf_counter() - t0) * 1000.0
        self._upstream.observe(ms)
        with self._lock:
            view.inflight -= 1
            view.fail_streak = 0
        return status, payload

    def _forward_hedged(self, view: ReplicaView, body: bytes,
                        timeout: float, tenant: str = "default"
                        ) -> Tuple[int, bytes, int]:
        """Forward with tail hedging: fire a duplicate to a second
        replica past the hedge threshold; first completion wins, a
        failed first completion falls back to the other."""
        hedge_after = self._hedge_delay()
        if hedge_after is None or hedge_after >= timeout:
            status, payload = self._forward_once(view, body, timeout)
            return status, payload, view.id

        results: "queue.Queue" = queue.Queue()

        def attempt(v: ReplicaView, is_hedge: bool) -> None:
            try:
                results.put((v, self._forward_once(v, body, timeout),
                             None, is_hedge))
            except BaseException as e:
                results.put((v, None, e, is_hedge))

        threading.Thread(target=attempt, args=(view, False),
                         daemon=True).start()
        outstanding = 1
        deadline = time.monotonic() + timeout
        hedged = False
        first_err: Optional[BaseException] = None
        while outstanding > 0:
            budget = deadline - time.monotonic()
            if budget <= 0:
                break
            if not hedged:
                budget = min(budget, hedge_after)
            try:
                v, res, err, was_hedge = results.get(timeout=budget)
            except queue.Empty:
                if hedged:
                    break
                hedged = True
                second = self._pick(exclude={view.id})
                if second is None:
                    continue    # nobody to hedge to; keep waiting
                self._hedges.inc(tenant=tenant)
                threading.Thread(target=attempt, args=(second, True),
                                 daemon=True).start()
                outstanding += 1
                continue
            outstanding -= 1
            if err is None:
                # Any completed HTTP exchange wins the hedge race —
                # status handling (5xx retry-elsewhere) is dispatch()'s
                # job; the hedge only fights latency.
                status, payload = res
                if was_hedge:
                    self._hedge_wins.inc(tenant=tenant)
                return status, payload, v.id
            first_err = err
        if first_err is not None:
            raise first_err if isinstance(
                first_err, (ConnectionError, OSError)) else \
                ConnectionError(str(first_err))
        raise TimeoutError(f"no replica answered within "
                           f"{timeout:.1f}s")

    def dispatch(self, body: bytes, retry: bool = True,
                 tenant: Optional[str] = None
                 ) -> Tuple[int, bytes, Optional[int]]:
        """Route one /predict body.  Returns (status, payload,
        replica_id).  Raises :class:`NoReplicaAvailable` when the
        routing set is (and stays) empty."""
        if tenant is None:
            tenant = self.tenant_of(body)
        inj = faults.get_injector()
        if inj is not None:
            with self._lock:
                self._dispatch_seq = getattr(self, "_dispatch_seq", 0) + 1
                seq = self._dispatch_seq
            inj.fire("serve.dispatch", step=seq)
        deadline = time.monotonic() + self.request_timeout_s
        backoff = Backoff(first=0.02, cap=0.25,
                          deadline_s=self.request_timeout_s)
        tried: set = set()
        last_status: Optional[Tuple[int, bytes, int]] = None
        while True:
            view = self._pick(exclude=tried)
            if view is None and tried:
                # Every distinct replica failed once; widen back out —
                # a respawn/readmission may have landed meanwhile.
                tried = set()
                view = self._pick()
            if view is None:
                if time.monotonic() >= deadline or not backoff.sleep():
                    raise NoReplicaAvailable(
                        "no admitting replica (all dead, draining, or "
                        "ejected)")
                continue
            try:
                status, payload, rid = self._forward_hedged(
                    view, body, max(0.05, deadline - time.monotonic()),
                    tenant=tenant)
            except (ConnectionError, OSError, TimeoutError) as e:
                # Wire death mid-request: the replica is suspect — eject
                # (cooldown applies) and retry the request elsewhere.
                # This is THE zero-dropped-request path for a crash.
                if isinstance(e, (ConnectionError, OSError)):
                    self._eject(view, "dispatch", repr(e), tenant=tenant)
                tried.add(view.id)
                if not retry or time.monotonic() >= deadline:
                    return 502, json.dumps(
                        {"error": f"replica {view.id} failed: {e}"}
                    ).encode(), view.id
                self._retries.inc(tenant=tenant)
                backoff.sleep()
                continue
            if status >= 500 or status == 503:
                # Upstream said no (draining 503, engine 5xx): retryable
                # on another replica within the budget.
                last_status = (status, payload, rid)
                tried.add(view.id)
                if not retry or time.monotonic() >= deadline:
                    return last_status
                self._retries.inc(tenant=tenant)
                if not backoff.sleep():
                    return last_status
                continue
            return status, payload, rid

    # -- HTTP front --------------------------------------------------------

    @staticmethod
    def tenant_of(body: bytes) -> str:
        """The request's tenant class for metric attribution: the
        ``tenant`` field the continuous engine carries in the /predict
        JSON, folded into the fixed class set.  Bodies without one (the
        static engine, non-JSON payloads) attribute to ``default`` —
        and skip the JSON parse entirely."""
        if b'"tenant"' not in body:
            return "default"
        try:
            t = json.loads(body.decode("utf-8", "replace")).get("tenant")
        except (ValueError, AttributeError):
            return "default"
        return t if t in _TENANTS else "default"

    def _observe(self, route: str, t0: float, status: int,
                 tenant: str = "default") -> None:
        ms = (time.perf_counter() - t0) * 1000.0
        self._latency.observe(ms)
        lat = self._tenant_latency.get(tenant)
        if lat is not None:
            lat.observe(ms)
        self._requests.inc(route=route, status=str(status),
                           tenant=tenant)

    def describe(self) -> Dict[str, Any]:
        with self._lock:
            views = list(self._replicas.values())
        routable = {v.id for v in self._routable()}
        return {
            "status": "ok" if routable else "degraded",
            "replicas": [v.describe() for v in views],
            "routable": sorted(routable),
            "slo_p99_ms": self.slo_p99_ms,
            "synthetic_rps": getattr(self, "synthetic_rps", 0.0),
        }

    def start(self) -> int:
        handler = type("Handler", (_Handler,), {"router": self})
        self._httpd = _HTTPServer((self.host, self.port), handler)
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="hvdt-router-http",
            daemon=True)
        self._http_thread.start()
        self.refresh()
        self._control_thread = threading.Thread(
            target=self._control_loop, name="hvdt-router-control",
            daemon=True)
        self._control_thread.start()
        log.info("router on http://%s:%d (slo_p99_ms=%s)", self.host,
                 self.port, self.slo_p99_ms or "off")
        return self.port

    def stop(self) -> None:
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        for t in (self._http_thread, self._control_thread):
            if t is not None:
                t.join(timeout=5)
        self._http_thread = self._control_thread = None
