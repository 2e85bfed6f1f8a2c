"""Per-worker /metrics HTTP exporter + driver-side snapshot aggregation.

The port's copy of the JAX package's ``telemetry/exporter.py``; device
memory comes from ``torch.cuda``.  :func:`serve_snapshot_dict` is a
serving replica's heartbeat roll-up (``serve/replica.py``).

Every training worker gets its own scrape endpoint (stdlib
``ThreadingHTTPServer``, no dependency): ``/metrics`` renders the process-wide default registry as
Prometheus text, ``/healthz`` answers liveness with rank/step.  The bind
port is ``HVDT_METRICS_PORT + local_rank`` (ranks on one host must not
collide; different hosts can share the base port), falling back to an
ephemeral port — with a logged warning — when the slot is taken, because
a scrape endpoint must never be the reason training didn't start.

``hvd.init()`` starts the exporter automatically when ``HVDT_TELEMETRY``
is on (:func:`maybe_start_exporter`); ``hvd.shutdown()`` stops it.

Driver-side aggregation: under the elastic launcher, each worker also
publishes a compact JSON snapshot to the rendezvous KV
(``/telemetry/<rank>``) at most every ``HVDT_TELEMETRY_PUBLISH_S``
seconds, and :func:`collect_driver_snapshots` (used by
``ElasticDriver.telemetry_snapshots``) reads them back — so the driver
can answer "what is the fleet's goodput / who is the straggler" without
scraping N worker endpoints itself.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from ..common import config
from ..common.logging_util import get_logger
from .metrics import MetricsRegistry, default_registry

__all__ = ["MetricsExporter", "start_exporter", "stop_exporter",
           "get_exporter", "maybe_start_exporter", "snapshot_dict",
           "serve_snapshot_dict", "collect_driver_snapshots",
           "bind_process_gauges"]

log = get_logger(__name__)

KV_PREFIX = "/telemetry/"


def snapshot_dict(registry: Optional[MetricsRegistry] = None
                  ) -> Dict[str, Any]:
    """Compact, JSON-able roll-up of the headline training metrics — what
    workers publish to the driver and the bench embeds in its output."""
    reg = registry if registry is not None else default_registry()
    out: Dict[str, Any] = {}
    # Snapshot schema v2 (tolerant): wall_ts + the current step id let
    # the driver step-align cross-rank roll-ups (telemetry/aggregate);
    # v1 consumers ignore the extra keys, v1 producers are skipped by
    # the aligned roll-up with a counted hvdt_snapshot_unaligned_total.
    out["wall_ts"] = round(time.time(), 3)
    bytes_total = reg.get("hvdt_collective_bytes_total")
    if bytes_total is not None:
        out["bytes_on_wire_total"] = bytes_total.total()
    coll = reg.get("hvdt_collectives_total")
    if coll is not None:
        out["collectives_total"] = coll.total()
    step_counter = reg.get("hvdt_steps_total")
    if step_counter is not None:
        out["step"] = int(step_counter.total())
    steps = reg.get("hvdt_step_time_seconds")
    if steps is not None and steps.count:
        pct = steps.percentiles()
        out["steps"] = steps.count
        out["step_time_p50_ms"] = (round(pct[0.5] * 1e3, 3)
                                   if pct[0.5] is not None else None)
        out["step_time_p99_ms"] = (round(pct[0.99] * 1e3, 3)
                                   if pct[0.99] is not None else None)
    for gname, key in (("hvdt_mfu", "mfu"),
                       ("hvdt_examples_per_sec", "examples_per_sec"),
                       ("hvdt_goodput_fraction", "goodput_fraction"),
                       ("hvdt_straggler_rank", "straggler_rank"),
                       ("hvdt_step_time_skew", "step_time_skew"),
                       ("hvdt_straggler_pod", "straggler_pod"),
                       ("hvdt_pod_step_time_skew", "pod_step_time_skew")):
        g = reg.get(gname)
        if g is not None:
            v = g.value()
            out[key] = round(v, 4) if v == v else None   # NaN-safe
    anomalies = reg.get("hvdt_anomaly_total")
    if anomalies is not None:
        out["anomaly_total"] = anomalies.total()
    # Time-series tail (HVDT_HISTORY): a short recent slice so the
    # driver can join ranks on step id without scraping /timeseries.
    from . import history as _history

    hist = _history.get_history()
    if hist is not None:
        out["timeseries"] = hist.to_dict(max_points=64)
    # Control-plane flakiness counters (runner/http_kv.py) — surfaced so
    # ElasticDriver.telemetry_snapshots() sees KV retries/errors per
    # worker without scraping N endpoints.
    for cname, key in (("hvdt_kv_retries_total", "kv_retries_total"),
                       ("hvdt_kv_errors_total", "kv_errors_total")):
        c = reg.get(cname)
        if c is not None:
            out[key] = c.total()
    # Pod membership (launcher contract): lets the driver aggregate
    # snapshots per pod for the straggler-eviction rung.
    pod = os.environ.get("HVDT_POD")
    if pod:
        out["pod"] = pod
    return out


def serve_snapshot_dict(registry: MetricsRegistry) -> Dict[str, Any]:
    """Replica-side roll-up of one serving registry — the load + latency
    story a replica heartbeats to the rendezvous KV
    (``/serve/replicas/<id>``, serve/replica.py) and the router and
    autoscaler route/scale on.  The serving analog of
    :func:`snapshot_dict`: queue depth is the leading load signal,
    predict p50/p99 the SLO signal, the counters the audit trail."""
    out: Dict[str, Any] = {}
    depth = registry.get("serve_queue_depth")
    if depth is not None:
        v = depth.value()
        out["queue_depth"] = v if v == v else 0.0   # NaN-safe
    lat = registry.get("serve_request_latency_ms_predict")
    if lat is not None and lat.count:
        pct = lat.percentiles()
        out["p50_ms"] = (round(pct[0.5], 3)
                         if pct[0.5] is not None else None)
        out["p99_ms"] = (round(pct[0.99], 3)
                         if pct[0.99] is not None else None)
    for cname, key in (("serve_requests_total", "requests_total"),
                       ("serve_rejected_total", "rejected_total"),
                       ("serve_batches_total", "batches_total"),
                       ("serve_deadline_expired_total",
                        "deadline_expired_total")):
        c = registry.get(cname)
        if c is not None:
            out[key] = c.total()
    draining = registry.get("serve_draining")
    if draining is not None:
        out["draining"] = bool(draining.value() == 1.0)
    # A continuous engine's extras (decode throughput, KV occupancy)
    # ride the same heartbeat when its registry declares them.
    tps = registry.get("hvdt_engine_tokens_per_sec")
    if tps is not None:
        out["engine"] = "continuous"
        v = tps.value()
        out["tokens_per_sec"] = round(v, 3) if v == v else 0.0
        for gname, key in (("hvdt_engine_kv_blocks_in_use",
                            "kv_blocks_in_use"),
                           ("hvdt_engine_active_seqs", "active_seqs")):
            g = registry.get(gname)
            if g is not None:
                gv = g.value()
                out[key] = gv if gv == gv else 0.0
    return out


class _Handler(BaseHTTPRequestHandler):
    exporter: "MetricsExporter"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        log.debug("telemetry http: " + fmt, *args)

    def _reply(self, status: int, body: bytes, content_type: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        exp = self.exporter
        route = self.path.split("?")[0]
        if route == "/metrics":
            self._reply(200, exp.registry.render().encode(),
                        "text/plain; version=0.0.4")
        elif route == "/healthz":
            steps = exp.registry.get("hvdt_steps_total")
            payload = {
                "status": "ok",
                "rank": exp.rank,
                "steps": (int(steps.total()) if steps is not None else 0),
            }
            self._reply(200, json.dumps(payload).encode(),
                        "application/json")
        elif route == "/timeseries":
            from . import history as _history

            hist = _history.get_history()
            if hist is None:
                self._reply(404, json.dumps({
                    "error": "metric history disabled "
                             "(set HVDT_HISTORY=1)"}).encode(),
                    "application/json")
            else:
                doc = hist.to_dict()
                doc["rank"] = exp.rank
                pod = os.environ.get("HVDT_POD")
                if pod:
                    doc["pod"] = pod
                steps = exp.registry.get("hvdt_steps_total")
                doc["step"] = (int(steps.total())
                               if steps is not None else 0)
                self._reply(200, json.dumps(doc).encode(),
                            "application/json")
        elif route == "/flightrecorder":
            from . import flight_recorder as _frm

            fr = _frm.get_flight_recorder()
            if fr is None:
                self._reply(404, json.dumps({
                    "error": "flight recorder disabled "
                             "(set HVDT_FLIGHT_RECORDER=1)"}).encode(),
                    "application/json")
            else:
                self._reply(200, json.dumps(fr.dump()).encode(),
                            "application/json")
        else:
            self._reply(404, json.dumps(
                {"error": f"no route {self.path!r}"}).encode(),
                "application/json")


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    request_queue_size = 32


class MetricsExporter:
    """One worker's scrape endpoint (+ optional KV snapshot publisher)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 host: str = "0.0.0.0", port: Optional[int] = None,
                 rank: int = 0, port_offset: Optional[int] = None,
                 kv_client: Optional[Any] = None,
                 publish_interval_s: Optional[float] = None):
        self.registry = (registry if registry is not None
                         else default_registry())
        self.host = host
        base = int(port if port is not None
                   else config.get_int("HVDT_METRICS_PORT"))
        self.rank = int(rank)
        offset = int(port_offset if port_offset is not None else 0)
        # port 0 = ephemeral on purpose (tests, many workers per host
        # without a port plan); otherwise base + per-host offset.
        self.port = base + offset if base > 0 else 0
        self._kv = kv_client
        self.publish_interval_s = float(
            publish_interval_s if publish_interval_s is not None
            else config.get_float("HVDT_TELEMETRY_PUBLISH_S"))
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._publisher: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def start(self) -> int:
        """Bind and serve in a daemon thread; returns the bound port."""
        handler = type("Handler", (_Handler,), {"exporter": self})
        try:
            self._httpd = _HTTPServer((self.host, self.port), handler)
        except OSError as e:
            # The configured slot is taken (another worker, a stale
            # process) — an ephemeral port with a loud log beats dying.
            log.warning("metrics port %d unavailable (%s); "
                        "binding an ephemeral port", self.port, e)
            self._httpd = _HTTPServer((self.host, 0), handler)
        self.port = self._httpd.server_address[1]
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="hvdt-metrics-http",
            daemon=True)
        self._thread.start()
        if self._kv is not None and self.publish_interval_s > 0:
            self._publisher = threading.Thread(
                target=self._publish_loop, name="hvdt-metrics-publish",
                daemon=True)
            self._publisher.start()
        log.info("telemetry /metrics on http://%s:%d (rank %d)",
                 self.host, self.port, self.rank)
        return self.port

    def stop(self) -> None:
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self._publisher is not None:
            self._publisher.join(timeout=5)
            self._publisher = None

    # -- KV snapshot publishing (driver-side aggregation feed) -------------
    def publish_snapshot(self) -> bool:
        """Push one compact snapshot to the rendezvous KV (best-effort);
        also refreshes this rank's trace and flight-recorder dumps so
        the driver-side merge / desync gather sees recent data even from
        a worker that later dies without flushing."""
        if self._kv is None:
            return False
        try:
            doc = snapshot_dict(self.registry)
            doc["ts"] = time.time()
            self._kv.put(f"{KV_PREFIX}{self.rank}",
                         json.dumps(doc).encode())
        except Exception as e:
            log.debug("telemetry KV publish failed: %s", e)
            return False
        try:
            from . import flight_recorder as _frm
            from . import trace as _trace

            tracer = _trace.get_tracer()
            if tracer is not None:
                tracer.publish(self._kv, self.rank)
            fr = _frm.get_flight_recorder()
            if fr is not None:
                fr.publish(self._kv, self.rank)
        except Exception as e:
            log.debug("trace/flight KV publish failed: %s", e)
        return True

    def _publish_loop(self) -> None:
        while not self._stop.wait(self.publish_interval_s):
            self.publish_snapshot()


def _device_memory(stat) -> float:
    """One ``torch.cuda`` memory statistic of this process's device, or
    NaN without a CUDA device (the CPU, where the reference's
    ``memory_stats`` also gives none).  Reading it makes no CUDA call
    that a capture would refuse."""
    try:
        import torch

        from ..common import basics

        if not torch.cuda.is_available():
            return float("nan")
        dev = None
        if basics.is_initialized():
            dev = basics.topology().device
            if dev.type != "cuda":
                return float("nan")
        return float(stat(dev))
    except Exception:
        return float("nan")


def bind_process_gauges(registry: Optional[MetricsRegistry] = None) -> None:
    """Publish process resource usage as live-probe gauges: RSS, open
    file descriptors, and device memory in use.

    Live probes (``set_function``), read at scrape time.  Every probe is
    guarded: ``/proc`` may be absent (non-Linux), and a process without
    a CUDA device has no device memory — an unavailable number renders
    as ``nan``, never an exception.  Device memory is the caching
    allocator's view of the process's device
    (``torch.cuda.memory_allocated`` / ``max_memory_allocated``), the
    counterpart of the reference's ``bytes_in_use`` /
    ``peak_bytes_in_use``.  Idempotent (gauges are get-or-create;
    rebinding the probe is a no-op in effect)."""
    import os as _os

    reg = registry if registry is not None else default_registry()

    def _rss() -> float:
        try:
            with open("/proc/self/statm") as fh:
                pages = int(fh.read().split()[1])
            return float(pages * _os.sysconf("SC_PAGE_SIZE"))
        except (OSError, ValueError, IndexError):
            try:
                import resource

                # ru_maxrss is KiB on Linux (peak, not live — the
                # portable fallback when /proc is unavailable).
                return float(resource.getrusage(
                    resource.RUSAGE_SELF).ru_maxrss * 1024)
            except Exception:
                return float("nan")

    def _fds() -> float:
        try:
            return float(len(_os.listdir("/proc/self/fd")))
        except OSError:
            return float("nan")

    def _hbm() -> float:
        import torch

        return _device_memory(torch.cuda.memory_allocated)

    def _hbm_peak() -> float:
        import torch

        return _device_memory(torch.cuda.max_memory_allocated)

    reg.gauge(
        "hvdt_process_rss_bytes",
        "Resident set size of this worker process (live /proc probe; "
        "peak-RSS fallback where /proc is unavailable)"
    ).set_function(_rss)
    reg.gauge(
        "hvdt_process_open_fds",
        "Open file descriptors of this worker process (nan off-Linux)"
    ).set_function(_fds)
    reg.gauge(
        "hvdt_hbm_bytes_in_use",
        "Live device memory in use (torch.cuda.memory_allocated of the "
        "process's device; nan without a CUDA device)"
    ).set_function(_hbm)
    reg.gauge(
        "hvdt_hbm_peak_bytes",
        "Peak device memory in use since process start "
        "(torch.cuda.max_memory_allocated; nan without a CUDA device) — "
        "pair with hvdt_param_bytes / hvdt_optimizer_state_bytes to see "
        "the ZeRO/remat headroom"
    ).set_function(_hbm_peak)
    # Memory-accounting gauges (fed by step_stats.record_memory_
    # accounting — ops/zero.py reports per-rank post-sharding bytes):
    # registered here so they exist on /metrics from init, NaN until the
    # training loop reports.
    from .step_stats import _MEMORY_GAUGE_DOCS

    for name, doc in _MEMORY_GAUGE_DOCS.items():
        g = reg.gauge(name, doc)
        if g.value() == 0.0:
            g.set(float("nan"))


def collect_driver_snapshots(kv_server) -> Dict[int, Dict[str, Any]]:
    """Read every worker's published snapshot out of the rendezvous KV
    store (driver side).  ``kv_server`` is a RendezvousServer (has
    ``lock``/``store``)."""
    out: Dict[int, Dict[str, Any]] = {}
    with kv_server.lock:
        items = {k: v for k, v in kv_server.store.items()
                 if k.startswith(KV_PREFIX)}
    for key, raw in items.items():
        try:
            rank = int(key[len(KV_PREFIX):])
            out[rank] = json.loads(raw.decode())
        except (ValueError, UnicodeDecodeError):
            continue
    return out


# ---------------------------------------------------------------------------
# Process-wide exporter lifecycle (hvd.init() / hvd.shutdown() hooks)
# ---------------------------------------------------------------------------

_exp_lock = threading.Lock()
_exporter: Optional[MetricsExporter] = None


def get_exporter() -> Optional[MetricsExporter]:
    return _exporter


def start_exporter(**kwargs) -> MetricsExporter:
    """Start (or return) the process-wide exporter."""
    global _exporter
    with _exp_lock:
        if _exporter is None:
            _exporter = MetricsExporter(**kwargs)
            _exporter.start()
        return _exporter


def stop_exporter() -> None:
    global _exporter
    with _exp_lock:
        if _exporter is not None:
            _exporter.stop()
            _exporter = None


def maybe_start_exporter(topology=None) -> Optional[MetricsExporter]:
    """The ``hvd.init()`` hook: start the exporter iff telemetry is on.

    Never raises — observability must not sink init.  Uses local_rank as
    the port offset (ranks sharing a host need distinct ports; hosts can
    share the base), binds the KV publisher when the launcher's
    rendezvous env contract is present, and arms the resilience bridge
    gauges so one scrape carries the recovery story too."""
    from . import instrument

    if not instrument.enabled():
        return None
    try:
        rank = getattr(topology, "rank", 0) or 0
        local_rank = getattr(topology, "local_rank", 0) or 0
        kv = None
        if config.get_str("HVDT_RENDEZVOUS_ADDR"):
            try:
                from ..runner.http_kv import KVClient

                kv = KVClient.from_env()
            except Exception as e:
                log.debug("telemetry KV client unavailable: %s", e)
        from .step_stats import bind_resilience_gauges

        bind_resilience_gauges()
        bind_process_gauges()
        return start_exporter(rank=rank,
                              port_offset=max(0, int(local_rank)),
                              kv_client=kv)
    except Exception as e:   # pragma: no cover - defensive
        log.warning("telemetry exporter not started: %s", e)
        return None
