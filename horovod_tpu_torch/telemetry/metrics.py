"""Metric primitives: counters, gauges, summaries → Prometheus text.

A copy of the JAX package's ``telemetry/metrics.py`` (which imports no
JAX either; the port keeps its own): the same classes, names, rendering
and nearest-rank percentiles, and a process-wide default registry that
the step statistics (``telemetry/step_stats.py``) publish into.  The
metric catalog and its lint rule wait for the rest of the telemetry
plane (ROADMAP Queue 1: runtime plane).

A :class:`Summary` keeps a bounded reservoir of recent samples and
renders pre-computed p50/p95/p99 quantiles (the Prometheus *summary*
type).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Summary", "MetricsRegistry",
           "default_registry", "reset_default_registry"]


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    if f != f:
        return "NaN"    # Prometheus-canonical (live probes with no data)
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return str(int(f)) if f == int(f) else repr(f)


class _Metric:
    """Base: name/help/type plus per-metric lock."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()

    def _header(self) -> List[str]:
        lines = []
        if self.help:
            lines.append(f"# HELP {self.name} {self.help}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        return lines

    def render(self) -> List[str]:  # pragma: no cover - abstract
        raise NotImplementedError


class Counter(_Metric):
    """Monotonic counter (optionally labelled)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            return self._values.get(key, 0.0)

    def items(self) -> List[Tuple[Dict[str, str], float]]:
        """Every (labels, value) series — the per-label view harnesses
        (time-series sampling, anomaly-count roll-ups) read without
        reparsing the rendered text."""
        with self._lock:
            return [(dict(k), v) for k, v in sorted(self._values.items())]

    def total(self) -> float:
        """Sum across every label combination — the scrape-independent
        aggregate harnesses (the bench JSON, roll-ups) report."""
        with self._lock:
            return sum(self._values.values())

    def render(self) -> List[str]:
        lines = self._header()
        with self._lock:
            items = sorted(self._values.items()) or [((), 0.0)]
            for key, v in items:
                lines.append(
                    f"{self.name}{_fmt_labels(dict(key))} {_fmt_value(v)}")
        return lines


class Gauge(_Metric):
    """Point-in-time value; ``set_function`` makes it a live probe (queue
    depth is read from the batcher at scrape time, not shadowed).

    Optionally labelled: ``set(v, axis="dcn")`` keeps one value per
    label combination (``hvdt_expected_wire_bytes{axis=...}``); without
    labels the gauge stays the scalar it always was, and live probes
    are scalar-only."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {(): 0.0}
        self._fn = None

    def set(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)

    def set_function(self, fn) -> None:
        with self._lock:
            self._fn = fn

    def value(self, **labels: str) -> float:
        key = tuple(sorted(labels.items()))
        with self._lock:
            fn = self._fn
            if fn is None or key:
                return self._values.get(key, 0.0 if not key
                                        else float("nan"))
        try:
            return float(fn())
        except Exception:
            return float("nan")

    def items(self) -> List[Tuple[Dict[str, str], float]]:
        """Every labelled (labels, value) series (the scalar slot is
        omitted unless it is the only one or was explicitly set)."""
        with self._lock:
            labelled = [(dict(k), v) for k, v in sorted(
                self._values.items()) if k]
            if labelled:
                return labelled
            return [({}, self._values.get((), 0.0))]

    def render(self) -> List[str]:
        with self._lock:
            fn = self._fn
            labelled = sorted((k, v) for k, v in self._values.items() if k)
        if fn is not None or not labelled:
            return self._header() + [
                f"{self.name} {_fmt_value(self.value())}"]
        return self._header() + [
            f"{self.name}{_fmt_labels(dict(k))} {_fmt_value(v)}"
            for k, v in labelled]


class Summary(_Metric):
    """Latency summary: cumulative count/sum plus streaming quantiles over
    a bounded reservoir of the most recent ``window`` observations.

    The reservoir is a plain ring buffer — recent-window quantiles are
    what an operator wants from a scrape (a p99 diluted by yesterday's
    warmup spike is useless), and the bound keeps a long-lived server's
    memory flat.
    """

    kind = "summary"

    QUANTILES: Sequence[float] = (0.5, 0.95, 0.99)

    def __init__(self, name: str, help: str = "", window: int = 2048):
        super().__init__(name, help)
        self._window = max(1, int(window))
        self._ring: List[float] = []
        self._next = 0
        self._count = 0
        self._sum = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._count += 1
            self._sum += v
            if len(self._ring) < self._window:
                self._ring.append(v)
            else:
                self._ring[self._next] = v
                self._next = (self._next + 1) % self._window

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def mean(self) -> Optional[float]:
        """Mean over the retained window (None before any observation)."""
        with self._lock:
            if not self._ring:
                return None
            return float(sum(self._ring) / len(self._ring))

    def _sorted_window(self) -> List[float]:
        """The ONE sort per render/percentile pass.  Every quantile
        consumer goes through here so a 3-quantile scrape costs one
        O(n log n), not three."""
        with self._lock:
            return sorted(self._ring)

    @staticmethod
    def _nearest_rank(data: List[float], q: float) -> float:
        idx = min(len(data) - 1, max(0, int(q * len(data) + 0.5) - 1))
        return data[idx]

    def quantile(self, q: float) -> Optional[float]:
        """Nearest-rank quantile over the retained window (None if no
        observations yet).  For several quantiles at once use
        :meth:`percentiles`, which sorts the window once."""
        data = self._sorted_window()
        if not data:
            return None
        return self._nearest_rank(data, q)

    def percentiles(self) -> Dict[float, Optional[float]]:
        data = self._sorted_window()
        if not data:
            return {q: None for q in self.QUANTILES}
        return {q: self._nearest_rank(data, q) for q in self.QUANTILES}

    def percentile(self, q: float) -> float:
        """Like :meth:`quantile` but TOTAL: an empty window reads 0.0,
        never ``None`` (callers that need to tell "no data yet" apart
        keep :meth:`quantile`'s ``None``)."""
        v = self.quantile(q)
        return 0.0 if v is None else float(v)

    def render(self) -> List[str]:
        lines = self._header()
        data = self._sorted_window()
        with self._lock:
            count, total = self._count, self._sum
        for q in self.QUANTILES:
            if data:
                lines.append(f'{self.name}{{quantile="{q}"}} '
                             f"{_fmt_value(self._nearest_rank(data, q))}")
            else:
                lines.append(f'{self.name}{{quantile="{q}"}} NaN')
        lines.append(f"{self.name}_sum {_fmt_value(total)}")
        lines.append(f"{self.name}_count {count}")
        return lines


class MetricsRegistry:
    """Named metric collection rendering the Prometheus text format.

    ``counter``/``gauge``/``summary`` are get-or-create (idempotent), so
    independent components can reference the same metric by name without
    plumbing object handles."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kwargs)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def summary(self, name: str, help: str = "",
                window: int = 2048) -> Summary:
        return self._get_or_create(Summary, name, help, window=window)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def render(self) -> str:
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Process-wide default registry — what the step statistics publish into.
# ---------------------------------------------------------------------------

_default_lock = threading.Lock()
_default: Optional[MetricsRegistry] = None


def default_registry() -> MetricsRegistry:
    """The process-wide registry the training-side statistics share.
    Created on first use."""
    global _default
    with _default_lock:
        if _default is None:
            _default = MetricsRegistry()
        return _default


def reset_default_registry() -> MetricsRegistry:
    """Swap in a fresh default registry (tests — counters are cumulative
    and process-wide, so isolation requires an explicit reset)."""
    global _default
    with _default_lock:
        _default = MetricsRegistry()
        return _default
