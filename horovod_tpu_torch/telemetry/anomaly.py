"""Windowed anomaly detection over the telemetry time series.

The port's copy of the JAX package's ``telemetry/anomaly.py`` (which
imports no JAX): the same detectors, event schema and cluster rules.

The detection layer of the live perf attribution plane: pure windowed
detectors (median-vs-median level shift, fractional drop, threshold
crossing, counter-rate drift) run over the ``telemetry/history.py``
series at the recording cadence, and every firing becomes

* one line in a structured JSONL event log (``HVDT_EVENT_LOG``) —
  ``{"ts", "kind", "scope", "step", "rank", "pod", "value",
  "baseline", "ratio", "message", ...}``, and
* an ``hvdt_anomaly_total{kind}`` counter increment.

Worker-side kinds (:class:`AnomalyMonitor`): ``step_time_shift`` (step
time level shift), ``goodput_drop``, ``mfu_regression``, ``wire_drift``
(per-axis wire-byte rate shift), ``straggler_onset`` (skew gauge crosses
the straggler threshold).  The reference's ``perf_deviation`` kind
(observed-vs-predicted step time past ``HVDT_PERF_DEVIATION_RATIO``)
waits for the cost model that publishes the ratio, ROADMAP Queue 1,
item 8.

Driver-side (:class:`ClusterAnomalyMonitor`, fed by
``ElasticDriver.telemetry_snapshots()``): the same signals correlated
across ranks — a step-time shift on EVERY rank of one pod collapses to
ONE pod-scoped event (the pod exit-correlation idiom), a single slow
rank is named individually.  Every detector is latched: it
fires once on entering the anomalous state and re-arms only after the
signal recovers, so a sustained regression is one event, not one per
sample.

Zero-overhead contract: with ``HVDT_EVENT_LOG`` unset,
:func:`get_event_log` returns ``None`` after one env read; detectors
only run at all when the history layer is on.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..common import config
from ..common.logging_util import get_logger
from .metrics import MetricsRegistry, default_registry

__all__ = [
    "ANOMALY_KINDS", "level_shift", "level_drop", "threshold_cross",
    "rate_shift", "EventLog", "get_event_log", "reset",
    "read_event_log", "AnomalyMonitor", "ClusterAnomalyMonitor",
]

log = get_logger(__name__)

ANOMALY_KINDS: Tuple[str, ...] = (
    "step_time_shift", "goodput_drop", "mfu_regression", "wire_drift",
    "straggler_onset")

EVENT_VERSION = 1

# Detector defaults: the window is in SAMPLES (the history cadence),
# the shift factor is deliberately below the straggler threshold — a
# level shift should page before the skew rung evicts.
DEFAULT_WINDOW = 8
DEFAULT_SHIFT_FACTOR = 1.5
DEFAULT_DROP_FRACTION = 0.25


def _median(values: Sequence[float]) -> float:
    ordered = sorted(values)
    return ordered[(len(ordered) - 1) // 2]   # lower median (detector bias)


def level_shift(values: Sequence[float], window: int = DEFAULT_WINDOW,
                factor: float = DEFAULT_SHIFT_FACTOR
                ) -> Optional[Dict[str, float]]:
    """Median-vs-median level shift: the most recent ``window`` samples
    against the ``window`` before them.  Robust to single-sample noise
    by construction (a lone spike moves the recent median by at most
    one rank); fires only when ``recent / baseline > factor``."""
    vals = list(values)
    if len(vals) < 2 * window:
        return None
    recent = _median(vals[-window:])
    baseline = _median(vals[-2 * window:-window])
    if baseline <= 0:
        return None
    ratio = recent / baseline
    if ratio <= factor:
        return None
    return {"value": recent, "baseline": baseline, "ratio": ratio}


def level_drop(values: Sequence[float], window: int = DEFAULT_WINDOW,
               fraction: float = DEFAULT_DROP_FRACTION
               ) -> Optional[Dict[str, float]]:
    """Fractional drop of the recent median below the preceding one
    (goodput, MFU — signals where DOWN is bad)."""
    vals = list(values)
    if len(vals) < 2 * window:
        return None
    recent = _median(vals[-window:])
    baseline = _median(vals[-2 * window:-window])
    if baseline <= 0 or recent >= baseline * (1.0 - fraction):
        return None
    return {"value": recent, "baseline": baseline,
            "ratio": recent / baseline}


def threshold_cross(values: Sequence[float], threshold: float
                    ) -> Optional[Dict[str, float]]:
    """Last value above a fixed threshold (skew / deviation gauges that
    are already ratios against their own baseline)."""
    vals = list(values)
    if not vals or threshold <= 0 or vals[-1] <= threshold:
        return None
    return {"value": vals[-1], "baseline": threshold,
            "ratio": vals[-1] / threshold}


def rate_shift(points: Sequence[Tuple[float, int, float]],
               window: int = DEFAULT_WINDOW,
               factor: float = DEFAULT_SHIFT_FACTOR
               ) -> Optional[Dict[str, float]]:
    """Level shift over the per-step RATE of a cumulative counter
    series (``(ts, step, cumulative_value)`` points -> bytes/step),
    in either direction: a schedule that suddenly moves 2x the wire
    bytes per step and one that silently stopped exchanging are both
    drift."""
    pts = list(points)
    rates: List[float] = []
    for prev, cur in zip(pts, pts[1:]):
        dstep = cur[1] - prev[1]
        if dstep <= 0:
            continue
        rates.append(max(0.0, (cur[2] - prev[2]) / dstep))
    if len(rates) < 2 * window:
        return None
    recent = _median(rates[-window:])
    baseline = _median(rates[-2 * window:-window])
    if baseline <= 0:
        return None
    ratio = recent / baseline
    if max(ratio, 1.0 / ratio if ratio > 0 else float("inf")) <= factor:
        return None
    return {"value": recent, "baseline": baseline, "ratio": ratio}


# ---------------------------------------------------------------------------
# JSONL event log
# ---------------------------------------------------------------------------


class EventLog:
    """Append-only JSONL anomaly event log (one JSON object per line,
    flushed per event so a crashed run keeps everything it saw).

    Bounded: when ``HVDT_EVENT_LOG_MAX_BYTES`` is set (> 0) and an
    append would push the file past it, the current file rotates to
    ``<path>.1`` (keep-1 — the previous ``.1`` is replaced) and the
    append starts a fresh file, so a long run with a chatty controller
    can't grow the log unboundedly while the newest window plus one
    rotation of history always survives."""

    def __init__(self, path: str, max_bytes: Optional[int] = None):
        self.path = str(path)
        self.max_bytes = int(
            config.get_int("HVDT_EVENT_LOG_MAX_BYTES")
            if max_bytes is None else max_bytes)
        self._lock = threading.Lock()

    def _maybe_rotate(self, incoming: int) -> None:
        """(lock held) keep-1 size rotation before an oversize append."""
        if self.max_bytes <= 0:
            return
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return
        if size and size + incoming > self.max_bytes:
            os.replace(self.path, self.path + ".1")

    def emit(self, event: Dict[str, Any]) -> Dict[str, Any]:
        doc = dict(event)
        doc.setdefault("v", EVENT_VERSION)
        doc.setdefault("ts", time.time())
        line = json.dumps(doc, sort_keys=True)
        with self._lock:
            try:
                self._maybe_rotate(len(line) + 1)
                with open(self.path, "a") as fh:
                    fh.write(line + "\n")
            except OSError as e:   # the log must never sink training
                log.warning("anomaly event log write failed: %s", e)
        return doc


def read_event_log(path: str) -> List[Dict[str, Any]]:
    """Parse a JSONL event log; unparseable lines are skipped (a crash
    mid-write leaves at most one torn tail line)."""
    out: List[Dict[str, Any]] = []
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        return []
    return out


_lock = threading.Lock()
_cached_env: Optional[str] = "\0unset"
_cached_log: Optional[EventLog] = None


def get_event_log() -> Optional[EventLog]:
    """The process-wide event log, or ``None`` when ``HVDT_EVENT_LOG``
    is unset (one env read, the zero-overhead contract)."""
    global _cached_env, _cached_log
    raw = os.environ.get("HVDT_EVENT_LOG")
    if raw != _cached_env:
        with _lock:
            if raw != _cached_env:
                path = (raw or "").strip()
                _cached_log = EventLog(path) if path else None
                _cached_env = raw
    return _cached_log


def reset() -> None:
    """Drop the cached event log (test isolation)."""
    global _cached_env, _cached_log
    with _lock:
        _cached_env = "\0unset"
        _cached_log = None


# ---------------------------------------------------------------------------
# Worker-side monitor
# ---------------------------------------------------------------------------


class _Latched:
    """Fire-once latching shared by both monitors: a detector key fires
    when its condition turns true and re-arms only after it turns false
    — a sustained anomaly is one event."""

    def __init__(self):
        self._active: set = set()

    def step(self, key: str, firing: bool) -> bool:
        """True exactly when ``key`` newly enters the firing state."""
        if firing:
            if key in self._active:
                return False
            self._active.add(key)
            return True
        self._active.discard(key)
        return False


class AnomalyMonitor:
    """Per-worker detector battery over the metric history, run after
    each recorded sample (``MetricHistory.sample`` calls
    :meth:`check`)."""

    def __init__(self, window: int = DEFAULT_WINDOW,
                 shift_factor: float = DEFAULT_SHIFT_FACTOR,
                 drop_fraction: float = DEFAULT_DROP_FRACTION,
                 skew_threshold: Optional[float] = None,
                 registry: Optional[MetricsRegistry] = None,
                 event_log: Optional[EventLog] = None,
                 rank: Optional[int] = None, pod: Optional[str] = None):
        self.window = int(window)
        self.shift_factor = float(shift_factor)
        self.drop_fraction = float(drop_fraction)
        self.skew_threshold = float(
            skew_threshold if skew_threshold is not None
            else config.get_float("HVDT_STRAGGLER_THRESHOLD"))
        reg = registry if registry is not None else default_registry()
        self._counter = reg.counter(
            "hvdt_anomaly_total",
            "Anomaly detector firings by kind (step_time_shift | "
            "goodput_drop | mfu_regression | wire_drift | "
            "straggler_onset | perf_deviation)")
        self._explicit_log = event_log
        self._latch = _Latched()
        self.rank = (int(rank) if rank is not None
                     else config.get_int("HVDT_RANK"))
        self.pod = pod if pod is not None else config.get_str("HVDT_POD")

    def _emit(self, kind: str, step: int, message: str,
              series: str = "", **fields: Any) -> Dict[str, Any]:
        doc: Dict[str, Any] = {
            "kind": kind, "scope": "rank", "step": int(step),
            "message": message,
        }
        if self.rank >= 0:
            doc["rank"] = self.rank
        if self.pod:
            doc["pod"] = self.pod
        if series:
            doc["series"] = series
        doc.update(fields)
        self._counter.inc(kind=kind)
        sink = (self._explicit_log if self._explicit_log is not None
                else get_event_log())
        if sink is not None:
            doc = sink.emit(doc)
        log.warning("anomaly: %s at step %d: %s", kind, step, message)
        return doc

    def check(self, history, step: int) -> List[Dict[str, Any]]:
        """Run every detector over the current window; returns the
        events that newly fired (latched)."""
        events: List[Dict[str, Any]] = []
        step = int(step)

        def run(series_name, kind, hit, message_fn, **extra):
            fired = self._latch.step(f"{kind}:{series_name}",
                                     hit is not None)
            if fired and hit is not None:
                events.append(self._emit(
                    kind, step, message_fn(hit), series=series_name,
                    value=round(hit["value"], 6),
                    baseline=round(hit["baseline"], 6),
                    ratio=round(hit["ratio"], 4), **extra))

        s = history.series("step_time")
        if s is not None:
            run("step_time", "step_time_shift",
                level_shift(s.values(), self.window, self.shift_factor),
                lambda h: (f"step time level shift: recent median "
                           f"{h['value']:.4f}s is {h['ratio']:.2f}x the "
                           f"preceding window's {h['baseline']:.4f}s"))
        s = history.series("goodput_fraction")
        if s is not None:
            run("goodput_fraction", "goodput_drop",
                level_drop(s.values(), self.window, self.drop_fraction),
                lambda h: (f"goodput fraction dropped to "
                           f"{h['value']:.3f} ({h['ratio']:.2f}x of "
                           f"{h['baseline']:.3f})"))
        s = history.series("mfu")
        if s is not None:
            run("mfu", "mfu_regression",
                level_drop(s.values(), self.window, self.drop_fraction),
                lambda h: (f"MFU regressed to {h['value']:.4f} "
                           f"({h['ratio']:.2f}x of {h['baseline']:.4f})"))
        s = history.series("step_time_skew")
        if s is not None:
            run("step_time_skew", "straggler_onset",
                threshold_cross(s.values(), self.skew_threshold),
                lambda h: (f"cross-rank step-time skew {h['value']:.2f} "
                           f"crossed the straggler threshold "
                           f"{h['baseline']:.2f}"))
        for name in history.names():
            if not name.startswith("wire_bytes."):
                continue
            ser = history.series(name)
            if ser is None:
                continue
            axis = name.split(".", 1)[1]
            run(name, "wire_drift",
                rate_shift(ser.points(), self.window, self.shift_factor),
                lambda h, _axis=axis: (
                    f"per-step wire bytes on axis {_axis!r} drifted "
                    f"{h['ratio']:.2f}x (recent {h['value']:.0f} B/step "
                    f"vs {h['baseline']:.0f})"),
                axis=axis)
        return events


# ---------------------------------------------------------------------------
# Driver-side cluster rules
# ---------------------------------------------------------------------------


class ClusterAnomalyMonitor:
    """Cross-rank anomaly correlation over the driver's aggregated KV
    snapshots: one pod-wide regression is ONE event, a lone slow rank
    is named."""

    def __init__(self, window: int = DEFAULT_WINDOW,
                 shift_factor: Optional[float] = None,
                 registry: Optional[MetricsRegistry] = None,
                 event_log: Optional[EventLog] = None):
        self.window = int(window)
        self.shift_factor = float(
            shift_factor if shift_factor is not None
            else config.get_float("HVDT_STRAGGLER_THRESHOLD"))
        reg = registry if registry is not None else default_registry()
        self._counter = reg.counter(
            "hvdt_anomaly_total",
            "Anomaly detector firings by kind")
        self._explicit_log = event_log
        self._latch = _Latched()

    def _emit(self, doc: Dict[str, Any]) -> Dict[str, Any]:
        self._counter.inc(kind=str(doc.get("kind", "")))
        sink = (self._explicit_log if self._explicit_log is not None
                else get_event_log())
        if sink is not None:
            doc = sink.emit(doc)
        log.warning("cluster anomaly: %s — %s", doc.get("kind"),
                    doc.get("message"))
        return doc

    def observe(self, snapshots: Dict[int, Dict[str, Any]]
                ) -> List[Dict[str, Any]]:
        """Correlate one round of per-rank snapshots; returns the
        cluster events that newly fired."""
        from . import aggregate

        events: List[Dict[str, Any]] = []
        means = aggregate.recent_step_means(snapshots, window=self.window)
        pods = {rank: (snapshots.get(rank) or {}).get("pod") or ""
                for rank in means}
        outliers: Dict[int, float] = {}
        if len(means) >= 2:
            median = _median(list(means.values()))
            if median > 0:
                outliers = {r: m / median for r, m in means.items()
                            if m / median > self.shift_factor}
        by_pod: Dict[str, List[int]] = {}
        for rank in sorted(means):
            by_pod.setdefault(pods[rank], []).append(rank)

        handled: set = set()
        for pod in sorted(by_pod):
            ranks = by_pod[pod]
            pod_wide = (bool(pod) and len(ranks) >= 2
                        and all(r in outliers for r in ranks))
            if self._latch.step(f"step_time_shift:pod:{pod}", pod_wide) \
                    and pod_wide:
                worst = max(ranks, key=lambda r: outliers[r])
                events.append(self._emit({
                    "kind": "step_time_shift", "scope": "pod",
                    "pod": pod, "rank": worst, "ranks": ranks,
                    "ratio": round(max(outliers[r] for r in ranks), 4),
                    "step": _latest_step(snapshots, ranks),
                    "message": (f"pod {pod} step time shifted "
                                f"{max(outliers[r] for r in ranks):.2f}x "
                                f"vs the cluster median (all of ranks "
                                f"{ranks})"),
                }))
            if pod_wide:
                handled.update(ranks)
        for rank in sorted(means):
            firing = rank in outliers and rank not in handled
            if self._latch.step(f"step_time_shift:rank:{rank}",
                                firing) and firing:
                events.append(self._emit({
                    "kind": "step_time_shift", "scope": "rank",
                    "rank": rank, "pod": pods.get(rank, ""),
                    "ratio": round(outliers[rank], 4),
                    "step": _latest_step(snapshots, [rank]),
                    "message": (f"rank {rank} (pod "
                                f"{pods.get(rank) or '?'}) step time is "
                                f"{outliers[rank]:.2f}x the cluster "
                                f"median"),
                }))
        return events


def _latest_step(snapshots: Dict[int, Dict[str, Any]],
                 ranks: Sequence[int]) -> int:
    return max((int((snapshots.get(r) or {}).get("step") or 0)
                for r in ranks), default=0)
