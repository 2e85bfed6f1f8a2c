"""HTTP serving front end: /predict, /healthz, /metrics, 503 backpressure.

The port's copy of the JAX package's ``serve/server.py``: the same
routes, status codes, headers and response JSON, so a client (or the
router) cannot tell the two packages' replicas apart.

Stdlib-only (``http.server.ThreadingHTTPServer``) — the serving plane
must not grow dependencies the training container doesn't have, and a
thread-per-connection front end is exactly right for this architecture:
handler threads only parse JSON and park on a batcher future; the real
concurrency problem (coalescing requests into bucket-shaped batches) is the
batcher's, and admission control is enforced *before* any memory is
committed to a request's batch slot.

Routes:

* ``POST /predict``  — body ``{"inputs": [[...], ...]}`` (one row per
  inner list).  200 → ``{"outputs": [...], "model_version": N}``;
  503 + ``Retry-After`` when admission control sheds the request;
  400 on malformed bodies; 504 when a request exceeds its deadline.
* ``GET /healthz``   — liveness/readiness: 200 once the engine has
  weights, with the served checkpoint step and params version.
* ``GET /metrics``   — Prometheus text (latency summaries per route,
  queue depth, batch fill, compile / reload counters).
"""

from __future__ import annotations

import concurrent.futures
import json
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

import numpy as np

from ..common import config
from ..common.logging_util import get_logger
from ..resilience import faults
from .batcher import (BackpressureError, DispatcherDied, DynamicBatcher,
                      RequestDeadlineExceeded)
from .engine import InferenceEngine
from .metrics import MetricsRegistry
from .reload import CheckpointWatcher

__all__ = ["ModelServer"]

log = get_logger(__name__)


class _Handler(BaseHTTPRequestHandler):
    # Set by ModelServer on the subclass it builds.
    server_ref: "ModelServer"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # route access logs to our logger
        log.debug("serve http: " + fmt, *args)

    # ---- helpers --------------------------------------------------------
    def _reply(self, status: int, payload: Any,
               content_type: str = "application/json",
               extra_headers: Optional[dict] = None) -> None:
        body = (payload if isinstance(payload, bytes)
                else json.dumps(payload).encode())
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _observe(self, route: str, t0: float, status: int) -> None:
        ms = (time.perf_counter() - t0) * 1000.0
        srv = self.server_ref
        srv.metrics.summary(
            f"serve_request_latency_ms_{route}",
            f"End-to-end {route} handler latency (ms)").observe(ms)
        srv.metrics.counter(
            "serve_http_responses_total",
            "HTTP responses by route and status").inc(
                route=route, status=str(status))

    # ---- routes ---------------------------------------------------------
    def do_GET(self):
        srv = self.server_ref
        t0 = time.perf_counter()
        if self.path.split("?")[0] == "/healthz":
            payload = {
                # "draining" tells the router/registrar to stop sending
                # work while in-flight batches finish; still HTTP 200 —
                # a draining replica is healthy, just leaving.
                "status": "draining" if srv.draining else "ok",
                "model_version": srv.engine.params_version,
                "checkpoint_step": (srv.watcher.current_step
                                    if srv.watcher else None),
                "buckets": list(srv.engine.buckets),
                "engine": "static",
            }
            self._reply(200, payload)
            self._observe("healthz", t0, 200)
        elif self.path.split("?")[0] == "/metrics":
            self._reply(200, srv.metrics.render().encode(),
                        content_type="text/plain; version=0.0.4")
            self._observe("metrics", t0, 200)
        else:
            self._reply(404, {"error": f"no route {self.path!r}"})

    def do_POST(self):
        if self.path.split("?")[0] != "/predict":
            self._reply(404, {"error": f"no route {self.path!r}"})
            return
        srv = self.server_ref
        t0 = time.perf_counter()
        # Admission gate BEFORE any parsing work: a draining replica
        # sheds with a retryable 503 (the router re-routes; a direct
        # client honors Retry-After) — never a dropped connection.  The
        # body is still consumed: leaving it unread would desync the
        # keep-alive stream (the next "request line" would be JSON).
        if srv.draining:
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            self._reply(503, {"error": "replica draining"},
                        extra_headers={"Retry-After": "1"})
            self._observe("predict", t0, 503)
            return
        srv._inflight_enter()
        try:
            self._do_predict(srv, t0)
        finally:
            srv._inflight_exit()

    def _do_predict(self, srv: "ModelServer", t0: float) -> None:
        try:
            length = int(self.headers.get("Content-Length", 0))
            doc = json.loads(self.rfile.read(length))
            inputs = np.asarray(doc["inputs"], dtype=srv.input_dtype)
            if inputs.ndim < 1 or inputs.shape[0] == 0:
                raise ValueError("inputs must hold >= 1 rows")
        except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
            self._reply(400, {"error": f"bad request: {e}"})
            self._observe("predict", t0, 400)
            return
        # Serving-plane chaos seam: serve_crash / slow_replica fire here
        # (step = this replica's admitted-request count) so replica
        # death and degradation are injected mid-request, exactly where
        # production failures land.
        inj = faults.get_injector()
        if inj is not None:
            inj.fire("serve.predict", step=srv.request_seq())
        try:
            version = srv.engine.params_version
            future = srv.batcher.submit(inputs)
        except BackpressureError as e:
            self._reply(503, {"error": str(e)},
                        extra_headers={"Retry-After": "1"})
            self._observe("predict", t0, 503)
            return
        except DispatcherDied as e:
            # Typed, retryable: this replica's dispatch plane is gone
            # (dying or torn down) — tell the caller to go elsewhere.
            self._reply(503, {"error": str(e)},
                        extra_headers={"Retry-After": "1"})
            self._observe("predict", t0, 503)
            return
        try:
            outputs = future.result(timeout=srv.request_timeout_s)
        except (concurrent.futures.TimeoutError, TimeoutError,
                RequestDeadlineExceeded):
            future.cancel()
            self._reply(504, {"error": "deadline exceeded"})
            self._observe("predict", t0, 504)
            return
        except DispatcherDied as e:
            self._reply(503, {"error": str(e)},
                        extra_headers={"Retry-After": "1"})
            self._observe("predict", t0, 503)
            return
        except Exception as e:
            self._reply(500, {"error": f"inference failed: {e}"})
            self._observe("predict", t0, 500)
            return
        self._reply(200, {"outputs": np.asarray(outputs).tolist(),
                          "model_version": version})
        self._observe("predict", t0, 200)


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # Default listen(5) drops connections the moment a traffic burst
    # outruns accept() — the kernel backlog must cover the concurrency
    # the admission queue is sized for (503s are OUR backpressure signal;
    # an RST from the TCP layer is just an outage).
    request_queue_size = 256


class ModelServer:
    """The assembled serving stack: engine + batcher + watcher + HTTP.

    ::

        engine = InferenceEngine(mlp_apply, params, buckets=(1, 8, 32))
        srv = ModelServer(engine, checkpoint_dir="/ckpts")
        port = srv.start()          # in-process, returns the bound port
        ...
        srv.stop()

    All sizing parameters default to the ``HVDT_SERVE_*`` knobs.  Pass
    ``port=0`` (default knob value) to bind an ephemeral port — the test
    rig and multi-replica launches both need collision-free binds.
    """

    def __init__(self, engine: InferenceEngine, *,
                 host: Optional[str] = None, port: Optional[int] = None,
                 checkpoint_dir: Optional[str] = None,
                 template: Any = None,
                 max_batch_size: Optional[int] = None,
                 max_delay_ms: Optional[float] = None,
                 max_queue_depth: Optional[int] = None,
                 request_timeout_s: Optional[float] = None,
                 input_dtype=np.float32,
                 metrics: Optional[MetricsRegistry] = None):
        self.engine = engine
        self.metrics = metrics if metrics is not None else engine.metrics
        self.host = host if host is not None \
            else config.get_str("HVDT_SERVE_HOST")
        self.port = int(port if port is not None
                        else config.get_int("HVDT_SERVE_PORT"))
        self.request_timeout_s = float(
            request_timeout_s if request_timeout_s is not None
            else config.get_float("HVDT_SERVE_REQUEST_TIMEOUT_S"))
        self.input_dtype = np.dtype(input_dtype)
        self.batcher = DynamicBatcher(
            engine.infer, max_batch_size=max_batch_size,
            max_delay_ms=max_delay_ms, max_queue_depth=max_queue_depth,
            metrics=self.metrics)
        self.watcher: Optional[CheckpointWatcher] = None
        if checkpoint_dir is not None:
            self.watcher = CheckpointWatcher(
                checkpoint_dir, engine, template, metrics=self.metrics)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # Graceful-drain state (resilience/preempt.py idiom: the signal
        # handler only sets a flag; the heavy work happens in main flow).
        self._draining = threading.Event()
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._inflight_zero = threading.Condition(self._inflight_lock)
        self._request_seq = 0
        self._prev_handlers: dict = {}
        self._drain_gauge = self.metrics.gauge(
            "serve_draining", "1 while this replica drains (admission "
            "closed, in-flight requests completing), else 0")
        self._drain_gauge.set_function(
            lambda: 1.0 if self.draining else 0.0)

    def start(self) -> int:
        """Bind + serve in a daemon thread; starts the reload watcher.
        Returns the bound port."""
        handler = type("Handler", (_Handler,), {"server_ref": self})
        self._httpd = _HTTPServer((self.host, self.port), handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="hvdt-serve-http",
            daemon=True)
        self._thread.start()
        if self.watcher is not None:
            self.watcher.start(load_initial=True)
        log.info("serving on http://%s:%d (buckets=%s)", self.host,
                 self.port, list(self.engine.buckets))
        return self.port

    # ---- graceful drain --------------------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def request_seq(self) -> int:
        """Monotone admitted-request count — the ``step`` coordinate of
        the serving fault plan (``serve_crash@step=N``)."""
        with self._inflight_lock:
            return self._request_seq

    def _inflight_enter(self) -> None:
        with self._inflight_lock:
            self._inflight += 1
            self._request_seq += 1

    def _inflight_exit(self) -> None:
        with self._inflight_zero:
            self._inflight -= 1
            if self._inflight <= 0:
                self._inflight_zero.notify_all()

    @property
    def inflight(self) -> int:
        with self._inflight_lock:
            return self._inflight

    def drain(self, timeout: float = 30.0) -> bool:
        """Flip to draining and wait for in-flight requests to finish.

        From the flip on: ``/healthz`` reports ``draining``, ``/predict``
        sheds with 503 + Retry-After, and requests already past
        admission run to completion.  The listener socket stays OPEN the
        whole time — a close here would RST exactly the connections the
        drain exists to protect.  Returns True when in-flight hit zero
        inside ``timeout``."""
        self._draining.set()
        deadline = time.monotonic() + timeout
        with self._inflight_zero:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    log.warning("serve drain: %d request(s) still in "
                                "flight after %.1fs", self._inflight,
                                timeout)
                    return False
                self._inflight_zero.wait(remaining)
        return True

    def install_drain_handlers(self,
                               signals=(signal.SIGTERM, signal.SIGINT)
                               ) -> None:
        """SIGTERM/SIGINT → drain flag (main thread only).  The handler
        is trivial by design; whoever owns the serving loop (the replica
        worker, ``serve_forever``) polls :attr:`draining` and performs
        the actual drain + exit in main flow."""
        for sig in signals:
            self._prev_handlers[sig] = signal.signal(
                sig, lambda signum, frame: self._draining.set())

    def uninstall_drain_handlers(self) -> None:
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):   # non-main thread / teardown
                pass
        self._prev_handlers.clear()

    def stop(self, drain_timeout: float = 30.0) -> None:
        """Graceful teardown: stop admitting (drain flag), let in-flight
        requests complete, then stop the watcher, the HTTP listener, and
        the batcher.  Ordering matters: the socket closes only after the
        last in-flight response was written — zero connection resets."""
        self._draining.set()
        self.drain(timeout=drain_timeout)
        if self.watcher is not None:
            self.watcher.stop()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self.batcher.close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def serve_forever(self) -> None:
        """start() + block until KeyboardInterrupt or a drain signal
        (the CLI entry path installs SIGTERM/SIGINT drain handlers, so a
        preempted replica finishes its in-flight work before exiting)."""
        self.start()
        try:
            self.install_drain_handlers()
        except ValueError:      # not the main thread (embedded use)
            pass
        try:
            while not self._draining.wait(1.0):
                pass
        except KeyboardInterrupt:
            pass
        finally:
            self.uninstall_drain_handlers()
            self.stop()
