"""Bounded per-metric time series — the history layer of the live perf
attribution plane.

The port's copy of the JAX package's ``telemetry/history.py`` (which
imports no JAX).

Point-in-time gauges answer "what is the MFU *now*"; they cannot answer
"when did it drop, and was the drop a level shift or noise" — the
question the anomaly detectors (``telemetry/anomaly.py``) and a
post-mortem both need.  This module keeps a bounded ring buffer of
``(wall_ts, step, value)`` samples per tracked metric, recorded from the
:class:`~.step_stats.StepTimer` observation stream at a
``HVDT_HISTORY_SAMPLE_S`` cadence (steps arriving faster are coalesced
into one sample carrying their mean step time), so memory stays flat no
matter how long the run is.

Tracked series (all read from the process-wide registry at sample time):

* ``step_time``            — mean step seconds since the last sample
* ``examples_per_sec`` / ``mfu`` / ``goodput_fraction`` /
  ``step_time_skew`` — the headline gauges (the reference's
  ``perf_deviation_ratio`` series waits for the cost model that
  publishes it, ROADMAP Queue 1, item 8)
* ``wire_bytes.<axis>``    — per-mesh-axis cumulative wire bytes
  (``hvdt_wire_bytes_total`` split by axis label; detectors difference
  them into per-step rates)

Surfaces: the per-worker exporter serves the full window as
``/timeseries`` (the ``hvdtrun top`` feed); the KV telemetry snapshot
embeds a recent slice so :func:`~horovod_tpu.telemetry.aggregate.rollup`
can join ranks on step id driver-side.

Zero-overhead contract (the ``get_recorder()`` idiom): with
``HVDT_HISTORY`` unset, :func:`get_history` returns ``None`` after one
env read, and the StepTimer's feed site is a single ``is None`` branch.
Each recorded sample also runs the process-wide
:class:`~.anomaly.AnomalyMonitor` over the updated window, so detection
rides the same cadence as recording.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..common import config
from .metrics import MetricsRegistry, default_registry

__all__ = ["Series", "MetricHistory", "get_history", "reset",
           "TRACKED_GAUGES"]

# Gauge name -> series name.  Sampled when present in the registry.
TRACKED_GAUGES: Tuple[Tuple[str, str], ...] = (
    ("hvdt_examples_per_sec", "examples_per_sec"),
    ("hvdt_mfu", "mfu"),
    ("hvdt_goodput_fraction", "goodput_fraction"),
    ("hvdt_step_time_skew", "step_time_skew"),
)


class Series:
    """One bounded time series: a ring of ``(wall_ts, step, value)``."""

    __slots__ = ("name", "window", "_ring", "_next")

    def __init__(self, name: str, window: int):
        self.name = name
        self.window = max(1, int(window))
        self._ring: List[Tuple[float, int, float]] = []
        self._next = 0

    def append(self, wall_ts: float, step: int, value: float) -> None:
        point = (float(wall_ts), int(step), float(value))
        if len(self._ring) < self.window:
            self._ring.append(point)
        else:
            self._ring[self._next] = point
            self._next = (self._next + 1) % self.window

    def points(self) -> List[Tuple[float, int, float]]:
        """Samples in chronological order."""
        return self._ring[self._next:] + self._ring[:self._next]

    def values(self) -> List[float]:
        return [p[2] for p in self.points()]

    def steps(self) -> List[int]:
        return [p[1] for p in self.points()]

    def last(self) -> Optional[Tuple[float, int, float]]:
        pts = self.points()
        return pts[-1] if pts else None

    def __len__(self) -> int:
        return len(self._ring)


class MetricHistory:
    """The process-wide set of tracked series plus the sampling logic."""

    def __init__(self, window: Optional[int] = None,
                 sample_s: Optional[float] = None,
                 registry: Optional[MetricsRegistry] = None,
                 monitor: Optional[Any] = None,
                 clock=time.time):
        self.window = int(window if window is not None
                          else config.get_int("HVDT_HISTORY_WINDOW"))
        self.sample_s = float(
            sample_s if sample_s is not None
            else config.get_float("HVDT_HISTORY_SAMPLE_S"))
        self.registry = (registry if registry is not None
                         else default_registry())
        #: the anomaly monitor run after each recorded sample (may be
        #: None in unit tests that exercise recording alone)
        self.monitor = monitor
        self._clock = clock
        self._lock = threading.Lock()
        self._series: Dict[str, Series] = {}
        self._last_sample_ts: Optional[float] = None
        self._pending_step_s: List[float] = []
        self._samples = self.registry.counter(
            "hvdt_history_samples_total",
            "Time-series samples recorded by the metric history "
            "(HVDT_HISTORY)")

    # -- series access ------------------------------------------------------

    def series(self, name: str) -> Optional[Series]:
        with self._lock:
            return self._series.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def _get_or_create(self, name: str) -> Series:
        s = self._series.get(name)
        if s is None:
            s = Series(name, self.window)
            self._series[name] = s
        return s

    def record(self, name: str, step: int, value: float,
               wall_ts: Optional[float] = None) -> None:
        """Append one point to one series (detectors and tests; the
        training path goes through :meth:`observe_step`)."""
        ts = self._clock() if wall_ts is None else float(wall_ts)
        with self._lock:
            self._get_or_create(name).append(ts, step, value)

    # -- the StepTimer feed --------------------------------------------------

    def observe_step(self, step: int, step_seconds: float) -> bool:
        """Feed one observed step; records a sample when the cadence
        allows (``sample_s`` seconds since the last one; 0 = always).
        Returns True when a sample was recorded."""
        now = self._clock()
        with self._lock:
            self._pending_step_s.append(float(step_seconds))
            if (self._last_sample_ts is not None and self.sample_s > 0
                    and now - self._last_sample_ts < self.sample_s):
                return False
            self._last_sample_ts = now
            pending, self._pending_step_s = self._pending_step_s, []
        self.sample(step, wall_ts=now,
                    step_seconds=sum(pending) / len(pending))
        return True

    def sample(self, step: int, wall_ts: Optional[float] = None,
               step_seconds: Optional[float] = None) -> None:
        """Record one sample across every tracked series, then run the
        anomaly monitor over the updated window."""
        ts = self._clock() if wall_ts is None else float(wall_ts)
        step = int(step)
        with self._lock:
            if step_seconds is not None:
                self._get_or_create("step_time").append(
                    ts, step, float(step_seconds))
            for gname, sname in TRACKED_GAUGES:
                g = self.registry.get(gname)
                if g is None:
                    continue
                v = g.value()
                if v == v:   # NaN-safe: an unknown gauge is no sample
                    self._get_or_create(sname).append(ts, step, float(v))
            wire = self.registry.get("hvdt_wire_bytes_total")
            if wire is not None:
                by_axis: Dict[str, float] = {}
                for labels, v in wire.items():
                    axis = labels.get("axis", "")
                    if axis:
                        by_axis[axis] = by_axis.get(axis, 0.0) + v
                for axis in sorted(by_axis):
                    self._get_or_create(f"wire_bytes.{axis}").append(
                        ts, step, by_axis[axis])
        self._samples.inc()
        if self.monitor is not None:
            try:
                self.monitor.check(self, step)
            except Exception:   # detection must never sink training
                pass

    # -- serialization (/timeseries + KV snapshot) ---------------------------

    def to_dict(self, max_points: Optional[int] = None) -> Dict[str, Any]:
        """JSON-able view: ``{"window", "sample_s", "series": {name:
        [[wall_ts, step, value], ...]}}``.  ``max_points`` caps each
        series to its most recent slice (the KV snapshot embeds a short
        tail; ``/timeseries`` serves the full window)."""
        with self._lock:
            names = sorted(self._series)
            series = {n: self._series[n].points() for n in names}
        out: Dict[str, Any] = {
            "window": self.window,
            "sample_s": self.sample_s,
            "series": {},
        }
        for n, pts in series.items():
            if max_points is not None and len(pts) > max_points:
                pts = pts[-max_points:]
            out["series"][n] = [[round(ts, 3), step, value]
                                for ts, step, value in pts]
        return out

    @classmethod
    def from_dict(cls, doc: Dict[str, Any]) -> "MetricHistory":
        """Rebuild a history from its serialized form (driver-side
        aggregation and tests; the rebuilt instance records into a
        private registry so it never collides with the live one)."""
        h = cls(window=int(doc.get("window", 0) or 1),
                sample_s=float(doc.get("sample_s", 0.0)),
                registry=MetricsRegistry())
        for name, pts in (doc.get("series") or {}).items():
            for ts, step, value in pts:
                h.record(str(name), int(step), float(value),
                         wall_ts=float(ts))
        return h


# ---------------------------------------------------------------------------
# Process-wide history (env-gated, cached on the raw env string — the
# instrument.get_recorder idiom, so per-test monkeypatching rebuilds it)
# ---------------------------------------------------------------------------

_TRUTHY = ("1", "true", "yes", "on")

_lock = threading.Lock()
_cached_env: Optional[str] = "\0unset"
_cached_history: Optional[MetricHistory] = None


def enabled() -> bool:
    """Whether the history layer is on (``HVDT_HISTORY``)."""
    return os.environ.get("HVDT_HISTORY", "").strip().lower() in _TRUTHY


def get_history() -> Optional[MetricHistory]:
    """The process-wide metric history, or ``None`` when ``HVDT_HISTORY``
    is unset — the disabled steady state costs one environ read and a
    string compare, and feed sites branch on ``is None``."""
    global _cached_env, _cached_history
    raw = os.environ.get("HVDT_HISTORY")
    if raw != _cached_env:
        with _lock:
            if raw != _cached_env:
                if enabled():
                    from .anomaly import AnomalyMonitor

                    _cached_history = MetricHistory(
                        monitor=AnomalyMonitor())
                else:
                    _cached_history = None
                _cached_env = raw
    return _cached_history


def reset() -> None:
    """Drop the cached history so the next :func:`get_history` rebinds
    against the (possibly reset) default registry — test isolation."""
    global _cached_env, _cached_history
    with _lock:
        _cached_env = "\0unset"
        _cached_history = None
