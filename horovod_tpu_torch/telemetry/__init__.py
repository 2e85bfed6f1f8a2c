"""Telemetry: metrics, instrumentation, tracing, forensics and roll-ups.

The port of the JAX package's ``telemetry/``, module for module, with
the same knob names, defaults, metric names and labels.  Layering,
bottom up:

* :mod:`~horovod_tpu_torch.telemetry.metrics` — Counter / Gauge /
  Summary primitives, the process-wide :func:`default_registry` and the
  metric catalog;
* :mod:`~horovod_tpu_torch.telemetry.instrument` — per-collective hook
  points threaded through the eager and device data planes (one record
  per collective the device executes, a CUDA-graph replay included);
  zero-overhead identity objects when ``HVDT_TELEMETRY`` is off;
* :mod:`~horovod_tpu_torch.telemetry.step_stats` — :class:`StepTimer`
  (step time, examples/s, MFU), :class:`GoodputLedger`, the resilience
  and memory-accounting gauges;
* :mod:`~horovod_tpu_torch.telemetry.straggler` — cross-rank
  step-duration skew detection;
* :mod:`~horovod_tpu_torch.telemetry.exporter` — per-worker
  ``/metrics`` + ``/healthz`` + ``/flightrecorder`` + ``/timeseries``
  HTTP endpoint (started by ``hvd.init()`` when enabled) and the KV
  snapshot publisher the elastic driver aggregates;
* :mod:`~horovod_tpu_torch.telemetry.trace` — distributed span tracing
  with deterministic per-step trace ids, merged driver-side into one
  rank-as-pid trace (``hvdtrun --trace-dir``);
* :mod:`~horovod_tpu_torch.telemetry.flight_recorder` — ring of recent
  collective events + the cross-rank desync analyzer that names the
  first divergent collective on stall-abort;
* :mod:`~horovod_tpu_torch.telemetry.history` — bounded per-metric time
  series (``HVDT_HISTORY``), served as ``/timeseries``;
* :mod:`~horovod_tpu_torch.telemetry.anomaly` — windowed detectors, the
  JSONL event log (``HVDT_EVENT_LOG``) and the driver-side cluster
  rules;
* :mod:`~horovod_tpu_torch.telemetry.aggregate` — step-id-joined
  cross-rank roll-ups;
* :mod:`~horovod_tpu_torch.telemetry.top` — the ``hvdtrun top`` view.

Not ported yet (ROADMAP Queue 1, item 8, which needs the cost model):
``PerfExpectation``, ``DeviationTracker``, the expected-cost publisher,
``expected_vs_observed_doc``, and what reads their gauges: the
``perf_deviation`` anomaly rules, ``HVDT_PERF_DEVIATION_RATIO``, the
history's ``perf_deviation_ratio`` series and ``top``'s ``dev`` column.

Knobs: ``HVDT_TELEMETRY``, ``HVDT_METRICS_PORT``,
``HVDT_STRAGGLER_WINDOW``, ``HVDT_STRAGGLER_THRESHOLD``,
``HVDT_TELEMETRY_PUBLISH_S``, ``HVDT_HISTORY``/``HVDT_HISTORY_*``,
``HVDT_EVENT_LOG``/``HVDT_EVENT_LOG_MAX_BYTES``, ``HVDT_TRACE_DIR``,
``HVDT_TRACE_BUFFER``, ``HVDT_FLIGHT_RECORDER``,
``HVDT_FLIGHT_RECORDER_EVENTS`` (common/config.py).
"""

from .metrics import (  # noqa: F401
    Counter,
    Gauge,
    MetricsRegistry,
    Summary,
    default_registry,
    reset_default_registry,
)
from .instrument import (  # noqa: F401
    CollectiveRecorder,
    enabled,
    get_recorder,
    wrap_step,
)
from .step_stats import (  # noqa: F401
    PEAK_BY_DEVICE_KIND,
    RECOVERY_PHASES,
    GoodputLedger,
    StepTimer,
    bind_resilience_gauges,
    peak_flops_for,
    record_memory_accounting,
    recovery_ledger,
    reset_recovery_ledger,
    tree_bytes,
)
from .straggler import StragglerMonitor  # noqa: F401
from .history import (  # noqa: F401
    MetricHistory,
    Series,
    get_history,
)
from .anomaly import (  # noqa: F401
    AnomalyMonitor,
    ClusterAnomalyMonitor,
    EventLog,
    get_event_log,
    read_event_log,
)
from .aggregate import rollup  # noqa: F401
from .exporter import (  # noqa: F401
    MetricsExporter,
    bind_process_gauges,
    collect_driver_snapshots,
    get_exporter,
    maybe_start_exporter,
    snapshot_dict,
    start_exporter,
    stop_exporter,
)
from .trace import (  # noqa: F401
    Tracer,
    get_tracer,
    merge_dumps,
    step_trace_id,
)
from .flight_recorder import (  # noqa: F401
    FlightRecorder,
    analyze_desync,
    emit_desync_report,
    get_flight_recorder,
)

__all__ = [
    "Counter", "Gauge", "Summary", "MetricsRegistry",
    "default_registry", "reset_default_registry",
    "CollectiveRecorder", "enabled", "get_recorder", "wrap_step",
    "StepTimer", "GoodputLedger", "bind_resilience_gauges",
    "record_memory_accounting", "peak_flops_for", "tree_bytes",
    "PEAK_BY_DEVICE_KIND", "RECOVERY_PHASES", "recovery_ledger",
    "reset_recovery_ledger", "StragglerMonitor",
    "MetricHistory", "Series", "get_history",
    "AnomalyMonitor", "ClusterAnomalyMonitor", "EventLog",
    "get_event_log", "read_event_log", "rollup",
    "MetricsExporter", "start_exporter", "stop_exporter", "get_exporter",
    "maybe_start_exporter", "snapshot_dict", "collect_driver_snapshots",
    "bind_process_gauges",
    "Tracer", "get_tracer", "merge_dumps", "step_trace_id",
    "FlightRecorder", "analyze_desync", "emit_desync_report",
    "get_flight_recorder",
]
