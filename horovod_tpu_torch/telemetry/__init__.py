"""Telemetry: metric primitives and step statistics.

The part of the JAX package's ``telemetry/`` that the bench leg needs:
``metrics.py`` (counters, gauges, summaries, the default registry) and
``step_stats.py`` (step timer, MFU, goodput).  The exporter, traces, the
flight recorder, straggler detection and the rest wait for ROADMAP
Queue 1: runtime plane.
"""

from __future__ import annotations

from ..common import config
from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    MetricsRegistry,
    Summary,
    default_registry,
    reset_default_registry,
)
from .step_stats import (  # noqa: F401
    PEAK_BY_DEVICE_KIND,
    RECOVERY_PHASES,
    GoodputLedger,
    StepTimer,
    peak_flops_for,
    recovery_ledger,
    reset_recovery_ledger,
    tree_bytes,
)


def enabled() -> bool:
    """Whether the telemetry subsystem is on (``HVDT_TELEMETRY``)."""
    return config.get_bool("HVDT_TELEMETRY")
