"""Replica-side wiring into the elastic serving control plane.

The port's copy of the JAX package's ``serve/replica.py``: the same KV
keys and heartbeat document, so the two packages' replicas and routers
interoperate through one rendezvous KV.

A serve replica is one :class:`~horovod_tpu_torch.serve.server.ModelServer`
process registered with the rendezvous KV the elastic driver already
runs.  The contract mirrors the training worker's (heartbeats in,
membership decisions out) so training and serving share ONE control
plane:

* **Heartbeat** — :class:`ReplicaRegistrar` publishes
  ``/serve/replicas/<id>`` every ``HVDT_SERVE_HEARTBEAT_S / 3`` seconds:
  endpoint (host, port) plus the load/latency roll-up the router routes
  on and the autoscaler scales on
  (:func:`telemetry.exporter.serve_snapshot_dict` — queue depth, predict
  p50/p99, draining).  A heartbeat older than ``2 x HVDT_SERVE_HEARTBEAT_S``
  means the replica is dead: the router stops routing to it and the
  driver's exit handling takes over.
* **Drain** — the driver requests a scale-down by writing
  ``/serve/drain/<id>``; the registrar notices at its next beat, the
  worker drains (admission 503s, in-flight batches finish), deregisters,
  and exits :data:`~horovod_tpu_torch.resilience.preempt.PREEMPT_EXIT_CODE`
  (83) — the same "clean removal, don't blacklist me" convention the
  preemption guard established, so the serving driver reuses the
  training driver's exit taxonomy unchanged.
* **Preemption** — SIGTERM installs the drain flag
  (``ModelServer.install_drain_handlers``); the replica loop performs
  the same drain → deregister → exit-83 sequence, so a preempted serve
  host leaves without dropping a request.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, Optional

from ..common import config
from ..common.logging_util import get_logger

__all__ = ["REPLICA_KV_PREFIX", "DRAIN_KV_PREFIX", "ReplicaRegistrar",
           "run_replica"]

log = get_logger(__name__)

REPLICA_KV_PREFIX = "/serve/replicas/"
DRAIN_KV_PREFIX = "/serve/drain/"


class ReplicaRegistrar:
    """Publishes one replica's heartbeat to the rendezvous KV and polls
    its drain key.

    ``kv`` is any client with ``put/get/delete`` (``runner.http_kv
    .KVClient`` in workers; a ``RendezvousServer`` adapter in tests).
    Heartbeats are best-effort — a flaky control network must degrade to
    "router may briefly route stale", never to a replica crash — but
    consecutive failures are counted and logged once past a streak.
    """

    _FAIL_WARN_STREAK = 5

    def __init__(self, kv: Any, replica_id: int, host: str, port: int,
                 server: Any = None,
                 heartbeat_s: Optional[float] = None,
                 on_drain: Optional[Callable[[], None]] = None):
        self._kv = kv
        self.replica_id = int(replica_id)
        self.host = host
        self.port = int(port)
        self._server = server
        self.heartbeat_s = float(
            heartbeat_s if heartbeat_s is not None
            else config.get_float("HVDT_SERVE_HEARTBEAT_S"))
        self._on_drain = on_drain
        self._stop = threading.Event()
        self._drain_seen = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._fail_streak = 0
        self.beats = 0   # audit: successful heartbeats

    # -- heartbeat payload -------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        doc: Dict[str, Any] = {
            "id": self.replica_id,
            "host": self.host,
            "port": self.port,
            "pid": os.getpid(),
            "ts": time.time(),
        }
        pod = os.environ.get("HVDT_POD")
        if pod:
            doc["pod"] = pod
        if self._server is not None:
            from ..telemetry.exporter import serve_snapshot_dict

            doc.update(serve_snapshot_dict(self._server.metrics))
            doc["draining"] = bool(getattr(self._server, "draining",
                                           False) or doc.get("draining"))
            doc["model_version"] = self._server.engine.params_version
            doc["engine"] = "static"
        return doc

    # -- lifecycle ---------------------------------------------------------

    def publish(self) -> bool:
        """One heartbeat put (best-effort).  Returns True on success."""
        try:
            self._kv.put(f"{REPLICA_KV_PREFIX}{self.replica_id}",
                         json.dumps(self.snapshot()).encode())
        except Exception as e:
            self._fail_streak += 1
            if self._fail_streak == self._FAIL_WARN_STREAK:
                log.warning("replica %d: %d consecutive heartbeat "
                            "failures (%s) — router will treat this "
                            "replica as dead past the liveness window",
                            self.replica_id, self._fail_streak, e)
            return False
        self._fail_streak = 0
        self.beats += 1
        return True

    def drain_requested(self) -> bool:
        """True once the driver wrote this replica's drain key (sticky)."""
        if self._drain_seen.is_set():
            return True
        try:
            raw = self._kv.get(f"{DRAIN_KV_PREFIX}{self.replica_id}")
        except Exception:
            return False
        if raw is not None:
            self._drain_seen.set()
            return True
        return False

    def _loop(self) -> None:
        # Beat at a third of the liveness period: two beats may be lost
        # to control-network flakes before the router writes us off.
        period = max(0.05, self.heartbeat_s / 3.0)
        while not self._stop.wait(period):
            self.publish()
            if self.drain_requested() and self._on_drain is not None:
                cb, self._on_drain = self._on_drain, None   # fire once
                cb()

    def start(self) -> "ReplicaRegistrar":
        self.publish()   # registration beat — visible before traffic
        self._thread = threading.Thread(
            target=self._loop, name=f"hvdt-replica-hb-{self.replica_id}",
            daemon=True)
        self._thread.start()
        return self

    def deregister(self) -> None:
        """Stop beating and remove the KV record — the clean-exit half
        of the liveness contract (a crash leaves the record to age out)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        try:
            self._kv.delete(f"{REPLICA_KV_PREFIX}{self.replica_id}")
        except Exception as e:
            log.debug("replica %d deregister failed: %s",
                      self.replica_id, e)


def run_replica(args) -> int:
    """The ``--replica-worker`` entry: one serve replica under the
    elastic serving driver (spawned by ``serve/autoscale.py``).

    Env contract (set by the driver, mirrors the training worker's):
    ``HVDT_RENDEZVOUS_ADDR/PORT``, ``HVDT_SECRET``, ``HVDT_RANK`` (the
    replica id), ``HVDT_LOCAL_RANK`` (the slot on its host: without
    ``--device`` the replica serves on card ``cuda:<local rank>``, so
    the replicas of one host spread over its cards).  The replica binds
    an ephemeral port (the heartbeat publishes the real endpoint — no
    port plan needed), serves until drained (KV key or SIGTERM), then
    exits 83 for clean removal.
    """
    from ..resilience.preempt import PREEMPT_EXIT_CODE
    from ..runner.http_kv import KVClient
    from .__main__ import build_server

    replica_id = int(os.environ.get("HVDT_SERVE_REPLICA_ID",
                                    os.environ.get("HVDT_RANK", "0")))
    args.port = 0   # ephemeral: many replicas per host must not collide
    if getattr(args, "device", None) is None:
        local = config.get_int("HVDT_LOCAL_RANK")
        args.device = f"cuda:{max(local, 0)}"
    import torch

    if str(args.device).startswith("cuda") and torch.cuda.is_available():
        torch.cuda.set_device(torch.device(args.device))
    server, feat_shape = build_server(args)
    if server.watcher is not None:
        server.watcher.check_once()
    if not getattr(args, "no_warmup", False):
        import numpy as np

        server.engine.warmup(feat_shape, dtype=np.dtype(server.input_dtype))
    port = server.start()
    try:
        server.install_drain_handlers()
    except ValueError:          # not the main thread (test embedding)
        pass
    kv = KVClient.from_env()
    registrar = ReplicaRegistrar(kv, replica_id, server.host, port,
                                 server=server)
    registrar.start()
    log.info("replica %d serving on http://%s:%d", replica_id,
             server.host, port)
    print(f"serve-replica {replica_id}: ready on {server.host}:{port} "
          f"({server.engine.device})", flush=True)
    try:
        from ..resilience.retry import Backoff

        # Drain-wait poll: jittered 50ms -> 250ms cap keeps drain
        # latency low while a fleet of replicas decorrelates.
        drain_poll = Backoff(first=0.05, cap=0.25)
        while not (server.draining or registrar.drain_requested()):
            drain_poll.sleep()
    except KeyboardInterrupt:
        pass
    # Drain: admission 503s from here (server.draining), in-flight
    # batches complete, a last draining=true beat tells the router
    # explicitly, and only then does the endpoint leave the KV.
    log.info("replica %d draining", replica_id)
    server._draining.set()
    registrar.publish()
    server.drain()
    registrar.deregister()
    server.uninstall_drain_handlers()
    server.stop()
    print(f"serve-replica {replica_id}: drained, exiting {PREEMPT_EXIT_CODE}",
          flush=True)
    return PREEMPT_EXIT_CODE
