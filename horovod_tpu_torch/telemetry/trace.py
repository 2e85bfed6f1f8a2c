"""Distributed span tracing: per-rank Chrome-trace buffers + driver merge.

The port's copy of the JAX package's ``telemetry/trace.py`` (which
imports no JAX): the same buffer, trace ids, dump format and merge.

The timeline (``timeline.py``) answers "what did *this* rank's
collectives do, per tensor"; at pod scale the question that matters is
cross-rank: *which rank entered step N late, and which collective
diverged first* (the Horovod paper's Timeline, grown to the
multi-controller setting the TPU-concurrency study debugs at).  This
module is the span layer of that story:

* a :class:`Tracer` is a bounded per-rank buffer of Chrome-trace events
  (``X`` complete spans + ``i`` instants) stamped with **wall-clock**
  microseconds — ranks share no clock but NTP-level skew is enough to
  line up multi-millisecond steps in one merged view;
* every event carries a **deterministic per-step trace id**
  (``step-%08d`` from a counter advanced once per
  ``step_pipeline.donated_step`` call; the span times the host's call,
  not the device's work), so the merged trace can be
  filtered to one step across all ranks without any cross-rank
  coordination at record time;
* spans are fed from the instrumentation sites that already exist: the
  eager controller's execute path, the timeline writer's B/E pairs, and
  the ``wrap_step`` dispatch shim (telemetry/instrument.py);
* per-rank dumps ride the rendezvous KV (``/trace/<rank>``, published by
  the exporter's snapshot loop and flushed at ``hvd.shutdown()``), and
  :func:`merge_dumps` / :func:`write_merged` assemble the driver-side
  single-file view with **rank as pid** — ``hvdtrun --trace-dir`` wires
  it up end to end.

Zero-overhead contract (same idiom as ``instrument.get_recorder``):
with ``HVDT_TRACE_DIR`` unset, :func:`get_tracer` returns ``None`` — one
env read and a compare — and no site allocates anything.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..common import config
from ..common.logging_util import get_logger

__all__ = ["Tracer", "get_tracer", "reset", "step_trace_id", "flush",
           "merge_dumps", "collect_server_dumps", "write_merged",
           "TRACE_KV_PREFIX"]

log = get_logger(__name__)

TRACE_KV_PREFIX = "/trace/"

_DISABLED = ("", "0", "off", "none", "false")


def trace_dir() -> str:
    """The configured trace directory, or '' when tracing is off."""
    raw = config.get_str("HVDT_TRACE_DIR")
    return "" if raw.strip().lower() in _DISABLED else raw


def enabled() -> bool:
    return bool(trace_dir())


def step_trace_id(step: int) -> str:
    """Deterministic per-step trace id — every rank derives the same id
    for the same step number, so the merged trace groups without any
    record-time coordination."""
    return f"step-{int(step):08d}"


def _env_rank() -> int:
    try:
        return max(0, int(os.environ.get("HVDT_RANK", 0)))
    except ValueError:
        return 0


class Tracer:
    """Bounded per-rank buffer of Chrome-trace events.

    Recording is a dict build + deque append under a lock — cheap enough
    for the eager controller's per-response path.  The deque bound (``HVDT_TRACE_BUFFER``)
    keeps a long run's memory flat: forensics wants the *recent* spans.
    """

    def __init__(self, rank: Optional[int] = None,
                 capacity: Optional[int] = None):
        self.rank = _env_rank() if rank is None else int(rank)
        cap = int(capacity if capacity is not None
                  else config.get_int("HVDT_TRACE_BUFFER"))
        self._events: "deque[Dict[str, Any]]" = deque(maxlen=max(16, cap))
        self._lock = threading.Lock()
        self._tids: Dict[int, int] = {}
        self._step = 0

    # -- step bookkeeping ---------------------------------------------------
    def next_step(self) -> int:
        with self._lock:
            self._step += 1
            return self._step

    @property
    def step(self) -> int:
        with self._lock:
            return self._step

    def current_trace_id(self) -> str:
        return step_trace_id(self.step)

    # -- recording ----------------------------------------------------------
    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = len(self._tids)
            self._tids[ident] = tid
        return tid

    def _push(self, ev: Dict[str, Any],
              args: Optional[Dict[str, Any]]) -> None:
        with self._lock:
            a = dict(args) if args else {}
            a.setdefault("step", self._step)
            a.setdefault("trace_id", step_trace_id(self._step))
            ev["args"] = a
            ev["pid"] = self.rank
            ev["tid"] = self._tid()
            self._events.append(ev)

    def complete(self, name: str, dur_s: float, cat: str = "collective",
                 args: Optional[Dict[str, Any]] = None,
                 end_ts_us: Optional[float] = None) -> None:
        """Record a completed span ending now (or at ``end_ts_us``)."""
        end = time.time() * 1e6 if end_ts_us is None else float(end_ts_us)
        dur = max(0.0, float(dur_s)) * 1e6
        self._push({"ph": "X", "name": str(name), "cat": cat,
                    "ts": round(end - dur, 3), "dur": round(dur, 3)}, args)

    def instant(self, name: str, cat: str = "mark",
                args: Optional[Dict[str, Any]] = None) -> None:
        self._push({"ph": "i", "name": str(name), "cat": cat,
                    "ts": round(time.time() * 1e6, 3), "s": "p"}, args)

    def step_span(self, dur_s: float,
                  args: Optional[Dict[str, Any]] = None) -> None:
        """One training-step dispatch span; advances the step counter so
        the NEXT step's events carry the next deterministic trace id
        (called by instrument._TimedStep)."""
        self.complete("train.step", dur_s, cat="step", args=args)
        self.next_step()

    # -- export -------------------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def dump(self) -> Dict[str, Any]:
        """Chrome-trace JSON object for this rank (loadable standalone in
        ``chrome://tracing`` / Perfetto)."""
        return {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "metadata": {"rank": self.rank, "clock": "unix-epoch-us"},
        }

    def write(self, path: str) -> str:
        with open(path, "w") as fh:
            json.dump(self.dump(), fh)
        return path

    def publish(self, kv, rank: Optional[int] = None) -> bool:
        """Best-effort per-rank dump publish to the rendezvous KV."""
        r = self.rank if rank is None else int(rank)
        try:
            kv.put(f"{TRACE_KV_PREFIX}{r}", json.dumps(self.dump()).encode())
            return True
        except Exception as e:
            log.debug("trace KV publish failed: %s", e)
            return False


# ---------------------------------------------------------------------------
# Process-wide tracer (env-gated, cached on the raw env string — same idiom
# as instrument.get_recorder)
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_cached_env: Optional[str] = "\0unset"
_cached_tracer: Optional[Tracer] = None


def get_tracer() -> Optional[Tracer]:
    """The process-wide tracer, or ``None`` when ``HVDT_TRACE_DIR`` is
    unset — instrumentation sites branch on ``is None`` and touch
    nothing else."""
    global _cached_env, _cached_tracer
    raw = os.environ.get("HVDT_TRACE_DIR")
    if raw != _cached_env:
        with _lock:
            if raw != _cached_env:
                _cached_tracer = Tracer() if enabled() else None
                _cached_env = raw
    return _cached_tracer


def reset() -> None:
    """Drop the cached tracer (test isolation)."""
    global _cached_env, _cached_tracer
    with _lock:
        _cached_env = "\0unset"
        _cached_tracer = None


def flush(write_file: bool = True, publish: bool = True) -> Optional[str]:
    """Flush the active tracer: write ``<dir>/trace_rank<N>.json`` and
    publish the dump to the rendezvous KV when the launcher env is
    present.  Called from ``hvd.shutdown()``; never raises.  Returns the
    written path (or None)."""
    tracer = get_tracer()
    if tracer is None:
        return None
    path: Optional[str] = None
    d = trace_dir()
    if write_file and d:
        try:
            os.makedirs(d, exist_ok=True)
            path = tracer.write(
                os.path.join(d, f"trace_rank{tracer.rank}.json"))
            log.info("trace dump written to %s (%d events)", path,
                     len(tracer.events()))
        except OSError as e:
            log.warning("trace dump not written: %r", e)
    if publish and os.environ.get("HVDT_RENDEZVOUS_ADDR"):
        try:
            from ..runner.http_kv import KVClient

            tracer.publish(KVClient.from_env())
        except Exception as e:
            log.debug("trace KV flush skipped: %s", e)
    return path


# ---------------------------------------------------------------------------
# Driver-side merge: rank-as-pid single-file view
# ---------------------------------------------------------------------------

def merge_dumps(dumps: Dict[int, Dict[str, Any]]) -> Dict[str, Any]:
    """Merge per-rank Chrome-trace dumps into one document.

    Each rank becomes a Chrome-trace *process* (pid = rank, named
    ``rank N``), preserving per-rank thread rows underneath — the
    Horovod Timeline's "tensors as pids" idea turned sideways for
    cross-rank forensics.  Timestamps are rebased to the earliest event
    so the viewer opens at t=0."""
    events: List[Dict[str, Any]] = []
    min_ts: Optional[float] = None
    for rank in sorted(dumps):
        for ev in dumps[rank].get("traceEvents", []):
            ev = dict(ev)
            ev["pid"] = int(rank)
            events.append(ev)
            ts = ev.get("ts")
            if ts is not None:
                min_ts = ts if min_ts is None else min(min_ts, ts)
    base = min_ts or 0.0
    for ev in events:
        if "ts" in ev:
            ev["ts"] = round(ev["ts"] - base, 3)
    meta: List[Dict[str, Any]] = []
    for rank in sorted(dumps):
        meta.append({"ph": "M", "name": "process_name", "pid": int(rank),
                     "args": {"name": f"rank {int(rank)}"}})
        meta.append({"ph": "M", "name": "process_sort_index",
                     "pid": int(rank), "args": {"sort_index": int(rank)}})
    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "metadata": {"ranks": sorted(int(r) for r in dumps),
                     "merged": True},
    }


def collect_server_dumps(kv_server) -> Dict[int, Dict[str, Any]]:
    """Read every worker's published trace dump out of the rendezvous KV
    store (driver side; ``kv_server`` has ``lock``/``store``)."""
    out: Dict[int, Dict[str, Any]] = {}
    with kv_server.lock:
        items = {k: v for k, v in kv_server.store.items()
                 if k.startswith(TRACE_KV_PREFIX)}
    for key, raw in items.items():
        try:
            rank = int(key[len(TRACE_KV_PREFIX):])
            out[rank] = json.loads(raw.decode())
        except (ValueError, UnicodeDecodeError):
            continue
    return out


def write_merged(kv_server, out_dir: str) -> Optional[str]:
    """Driver-side merge entry point (``hvdtrun --trace-dir`` under the
    elastic launcher): pull per-rank dumps from the KV, write one
    ``trace_merged.json``.  Returns the path, or None when no rank
    published anything."""
    dumps = collect_server_dumps(kv_server)
    if not dumps:
        return None
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace_merged.json")
    with open(path, "w") as fh:
        json.dump(merge_dumps(dumps), fh)
    return path
