"""Serving metrics — a re-export of :mod:`horovod_tpu_torch.telemetry.metrics`.

The JAX package's serving code imports its metric primitives from
``serve.metrics``; the port keeps the same import path, and the classes
are the telemetry module's own.

Serving builds a registry **per engine** (a replica scrapes its own
engine), while training instrumentation shares the process-wide
``telemetry.metrics.default_registry()`` behind the per-worker
``/metrics`` exporter.  ``Summary.quantile(q)`` is None while the window
is empty (the router's SLO ejection tells "no data yet" apart);
``Summary.percentile(q)`` reads 0.0 there.
"""

from __future__ import annotations

from ..telemetry.metrics import (  # noqa: F401
    Counter,
    Gauge,
    MetricsRegistry,
    Summary,
)

__all__ = ["Counter", "Gauge", "Summary", "MetricsRegistry"]
