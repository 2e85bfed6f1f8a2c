"""Metric primitives: counters, gauges, summaries → Prometheus text.

A copy of the JAX package's ``telemetry/metrics.py`` (which imports no
JAX either; the port keeps its own): the same classes, names, rendering
and nearest-rank percentiles, a process-wide default registry that
every instrumentation site and the per-worker ``/metrics`` exporter
share, and the metric catalog (:data:`CATALOG`, :func:`declared_metric`).

A :class:`Summary` keeps a bounded reservoir of recent samples and
renders pre-computed p50/p95/p99 quantiles (the Prometheus *summary*
type).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Summary", "MetricsRegistry",
           "default_registry", "reset_default_registry",
           "MetricSpec", "CATALOG", "declared_metric"]


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
# Process-wide default registry — what /metrics on a training worker serves.
# ---------------------------------------------------------------------------

_default_lock = threading.Lock()
_default: Optional[MetricsRegistry] = None


def default_registry() -> MetricsRegistry:
    """The process-wide registry every training-side instrumentation site
    and the worker ``/metrics`` exporter share.  Created on first use."""
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


# ---------------------------------------------------------------------------
# Metric catalog — the declared universe of metric names.
#
# The JAX package's catalog, entry for entry (names, kinds, label sets),
# so a dashboard or roll-up reads the same keys from either package.
# Every Counter/Gauge/Summary the port constructs is declared here; the
# entries of subsystems the port does not have yet (LLM serving, the
# controller, the fleet scheduler) stay declared.  Names ending in `*`
# are prefix wildcards for dynamically-formatted families
# (hvdt_phase_<PHASE>_seconds).  The lint rule that checks constructions
# against it is the JAX package's analysis layer (ROADMAP Queue 1,
# item 8).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One declared metric: name (or `prefix*` wildcard), kind
    (counter|gauge|summary), label names, and a docs line."""

    name: str
    kind: str
    labels: Tuple[str, ...]
    doc: str


def _m(name: str, kind: str, labels: Sequence[str], doc: str) -> MetricSpec:
    return MetricSpec(name, kind, tuple(labels), doc)


CATALOG: Dict[str, MetricSpec] = {
    s.name: s
    for s in [
        # -- collectives (telemetry/instrument.py) --
        _m("hvdt_collective_bytes_total", "counter",
           ("op", "dtype", "wire", "path", "axis"),
           "Bytes on the wire per collective (path=eager counts "
           "executions; path=jit counts traced programs)"),
        _m("hvdt_collectives_total", "counter",
           ("op", "dtype", "wire", "path", "axis"),
           "Collectives recorded, labelled op/dtype/wire/path"),
        _m("hvdt_wire_bytes_total", "counter", ("axis", "wire"),
           "Bytes on the wire per mesh axis — the per-tier view of "
           "hierarchical transport policies"),
        _m("hvdt_collective_negotiate_seconds", "summary", (),
           "Eager-path announce -> negotiated-response latency"),
        _m("hvdt_collective_queue_seconds", "summary", (),
           "Eager-path enqueue -> announce latency"),
        _m("hvdt_collective_execute_seconds", "summary", (),
           "Eager-path response dispatch duration"),
        _m("hvdt_fusion_fill_ratio", "summary", (),
           "Fused-allreduce bucket occupancy: bucket bytes / "
           "HVDT_FUSION_THRESHOLD"),
        _m("hvdt_step_dispatch_seconds", "summary", (),
           "donated_step call duration (async dispatch interval)"),
        _m("hvdt_overlap_hidden_bytes_total", "counter", (),
           "Collective bytes issued with compute still scheduled under "
           "their flight window (ops/overlap)"),
        _m("hvdt_overlap_bytes_total", "counter", (),
           "Total collective bytes scheduled by the overlap scheduler"),
        _m("hvdt_overlap_fraction", "gauge", (),
           "Hidden / total collective bytes across overlapped exchange "
           "schedules"),
        _m("hvdt_phase_*", "summary", (),
           "Timeline span durations per phase (hvdt_phase_<PHASE>_"
           "seconds, from the timeline writer's B/E pairs)"),
        # -- step stats / goodput (telemetry/step_stats.py) --
        _m("hvdt_step_time_seconds", "summary", (),
           "Host-observed training step duration"),
        _m("hvdt_steps_total", "counter", (),
           "Training steps observed by the StepTimer"),
        _m("hvdt_examples_per_sec", "gauge", (),
           "Windowed training throughput (examples/s, EWMA)"),
        _m("hvdt_mfu", "gauge", (),
           "Model-flops utilization (published only when caller flops "
           "and the device peak are both known)"),
        _m("hvdt_goodput_fraction", "gauge", (),
           "(elapsed - lost) / elapsed since ledger start"),
        _m("hvdt_goodput_lost_seconds_total", "counter", ("reason",),
           "Wall-clock seconds lost to non-training work, by reason"),
        _m("hvdt_recovery_seconds", "counter", ("phase",),
           "Recovery-time-budget seconds by phase (checkpoint_snapshot "
           "| checkpoint_write | rendezvous | compile | restore | "
           "replay)"),
        _m("hvdt_injected_faults", "gauge", (),
           "Faults the HVDT_FAULT_PLAN injector has fired"),
        _m("hvdt_emergency_checkpoints", "gauge", (),
           "Preemption-guard emergency checkpoints taken"),
        _m("hvdt_param_bytes", "gauge", (),
           "Per-rank parameter bytes (post-sharding)"),
        _m("hvdt_optimizer_state_bytes", "gauge", (),
           "Per-rank optimizer-state bytes (post-sharding)"),
        # -- perf attribution (predicted vs observed) --
        _m("hvdt_expected_step_comm_seconds", "gauge", (),
           "Cost-model-predicted exposed (non-overlapped) communication "
           "seconds per step for the expected schedule fingerprint on "
           "the ambient topology (published by hvd.init when "
           "HVDT_EXPECTED_SCHEDULE is set)"),
        _m("hvdt_expected_wire_bytes", "gauge", ("axis",),
           "Cost-model-predicted wire bytes per step per transport "
           "tier for the expected schedule fingerprint"),
        _m("hvdt_perf_deviation_ratio", "gauge", (),
           "Observed EWMA step seconds / predicted step seconds "
           "(predicted exposed comm + compute anchor) — >1 means the "
           "live run is slower than the cost model says it should be; "
           "the perf_deviation anomaly fires past "
           "HVDT_PERF_DEVIATION_RATIO"),
        _m("hvdt_anomaly_total", "counter", ("kind",),
           "Anomaly detector firings by kind (step_time_shift | "
           "goodput_drop | mfu_regression | wire_drift | "
           "straggler_onset | perf_deviation)"),
        _m("hvdt_history_samples_total", "counter", (),
           "Time-series samples recorded by the metric history "
           "(HVDT_HISTORY)"),
        _m("hvdt_snapshot_unaligned_total", "counter", (),
           "Driver-side roll-ups that skipped a rank whose KV snapshot "
           "carried no step id / time series (old snapshot schema or "
           "history off on that worker)"),
        # -- online policy controller (horovod_tpu/control) --
        _m("hvdt_controller_decisions_total", "counter",
           ("action", "outcome"),
           "Controller decisions by action kind (flip_transport | "
           "retune_bucket | toggle_overlap | toggle_zero | evict_pod | "
           "resize | scale_replicas) and outcome (applied | observed | "
           "recovered | rolled_back)"),
        _m("hvdt_controller_suppressed_total", "counter", ("reason",),
           "Controller decisions suppressed by guardrail (budget | "
           "hysteresis | cooldown | no_gain | apply_failed)"),
        _m("hvdt_controller_rollbacks_total", "counter", (),
           "Never-worse rollbacks: applied actions whose deviation "
           "ratio failed to recover inside the window"),
        _m("hvdt_controller_pending", "gauge", (),
           "Applied actions currently awaiting deviation-recovery "
           "verification"),
        _m("hvdt_controller_predicted_delta_s", "gauge", (),
           "Cost-model-predicted step-seconds gain of the last applied "
           "action"),
        _m("hvdt_controller_observed_delta_s", "gauge", (),
           "Observed deviation-ratio improvement of the last verified "
           "action (predicted-vs-observed closes the audit loop)"),
        # -- fleet scheduler (horovod_tpu/fleet) --
        _m("hvdt_fleet_decisions_total", "counter",
           ("move", "outcome"),
           "Fleet-scheduler decisions by move kind (reclaim | "
           "backfill) and outcome (applied | observed | recovered | "
           "rolled_back)"),
        _m("hvdt_fleet_suppressed_total", "counter", ("reason",),
           "Fleet moves suppressed by guardrail (budget | hysteresis | "
           "cooldown | no_gain | hint_not_growth | apply_failed)"),
        _m("hvdt_fleet_rollbacks_total", "counter", (),
           "Never-worse rollbacks: fleet moves whose serving pressure "
           "got worse than at decision time inside the window"),
        _m("hvdt_fleet_pending", "gauge", (),
           "Applied fleet moves currently awaiting pressure-recovery "
           "verification"),
        _m("hvdt_fleet_pressure", "gauge", (),
           "Serving-pressure ratio the scheduler last acted on "
           "(max of queue-depth and p99 ratios; 1.0 = at SLO)"),
        _m("hvdt_fleet_train_pods", "gauge", (),
           "Pods currently leased to the training workload"),
        _m("hvdt_fleet_serve_units", "gauge", (),
           "Pods currently leased to the serving workload"),
        # -- straggler (telemetry/straggler.py) --
        _m("hvdt_straggler_rank", "gauge", (),
           "Worst straggler rank over the last window (-1 = none)"),
        _m("hvdt_step_time_skew", "gauge", (),
           "max(rank mean step time) / median over the last window"),
        _m("hvdt_straggler_checks_total", "counter", (),
           "Cross-rank straggler checks performed"),
        _m("hvdt_straggler_flags_total", "counter", ("rank", "pod"),
           "Straggler detections by offending rank (and pod)"),
        _m("hvdt_straggler_pod", "gauge", (),
           "Worst straggler pod over the last window (-1 = none)"),
        _m("hvdt_pod_step_time_skew", "gauge", (),
           "max(pod mean step time) / cross-pod median"),
        # -- process gauges (telemetry/exporter.py) --
        _m("hvdt_process_rss_bytes", "gauge", (),
           "Resident set size of this worker process"),
        _m("hvdt_process_open_fds", "gauge", (),
           "Open file descriptors of this worker process"),
        _m("hvdt_hbm_bytes_in_use", "gauge", (),
           "Live device memory in use (nan where unavailable)"),
        _m("hvdt_hbm_peak_bytes", "gauge", (),
           "Peak device memory in use since process start"),
        # -- checkpointing (checkpoint.py) --
        _m("hvdt_ckpt_snapshot_seconds", "summary", (),
           "Commit-point device->host checkpoint snapshot duration"),
        _m("hvdt_ckpt_write_seconds", "summary", (),
           "Background checkpoint write+fsync duration"),
        _m("hvdt_ckpt_snapshot_over_budget_total", "counter", (),
           "Snapshots exceeding HVDT_CKPT_SNAPSHOT_BUDGET_S"),
        _m("hvdt_ckpt_superseded_total", "counter", (),
           "Queued async snapshots superseded by a newer one"),
        _m("hvdt_ckpt_write_failures_total", "counter", (),
           "Async checkpoint writes that failed (logged, never raised)"),
        # -- peer snapshot tier (resilience/peer_store.py) --
        _m("hvdt_peer_restore_total", "counter", (),
           "Recoveries served from the peer-replicated RAM tier"),
        _m("hvdt_peer_commit_total", "counter", (),
           "Commit-point snapshot publications to the peer tier"),
        _m("hvdt_peer_miss_total", "counter", (),
           "Peer-tier restore attempts that fell back to disk"),
        _m("hvdt_peer_replica_bytes", "gauge", (),
           "Host-RAM bytes holding peer snapshot replicas"),
        # -- control plane (runner/http_kv.py, optimizer.py) --
        _m("hvdt_kv_retries_total", "counter", (),
           "Rendezvous-KV bootstrap-wait retries"),
        _m("hvdt_kv_errors_total", "counter", ("op",),
           "Rendezvous-KV client op failures by op"),
        _m("hvdt_distributed_optimizer_builds_total", "counter",
           ("op", "compression", "backward_passes", "pipeline", "expert"),
           "DistributedOptimizer/GradientTransformation constructions, "
           "labelled reduce op / wire compression / accumulation and "
           "the declared pipeline/expert sharded axes (off when pure "
           "data-parallel)"),
        # -- 4D parallel substrate (parallel/moe.py, parallel/pipeline.py) --
        _m("hvdt_moe_capacity_slots", "gauge", (),
           "Per-expert dispatch slots of the last traced MoE layer "
           "(ceil(T*k/E * capacity_factor) — the static-shape capacity "
           "every dispatch tensor is sized by)"),
        _m("hvdt_moe_expansion_ratio", "gauge", (),
           "Dispatch slots / routed assignments of the last traced MoE "
           "layer (capacity head-room; < 1 guarantees dropped tokens)"),
        _m("hvdt_moe_load_balance_loss", "gauge", (),
           "Switch-transformer load-balance aux loss of the last "
           "reported step (E * sum_e f_e * P_e; report_moe_aux)"),
        _m("hvdt_moe_dropped_fraction", "gauge", (),
           "Fraction of routed token assignments dropped over expert "
           "capacity in the last reported step (report_moe_aux)"),
        _m("hvdt_pipeline_mfu", "gauge", (),
           "Model FLOPs utilization of the last reported pipeline step "
           "(achieved model FLOP/s / peak; report_pipeline_mfu)"),
        # -- serving router (serve/router.py) --
        _m("hvdt_router_requests_total", "counter",
           ("route", "status", "tenant"),
           "Requests admitted by the serving router front tier, by "
           "route, upstream status and tenant class (interactive | "
           "batch | default)"),
        _m("hvdt_router_request_latency_ms", "summary", (),
           "Router end-to-end /predict latency (ms), all tenants"),
        _m("hvdt_router_request_latency_ms_*", "summary", (),
           "Per-tenant router /predict latency "
           "(hvdt_router_request_latency_ms_<tenant>; Summary carries "
           "no labels)"),
        _m("hvdt_router_upstream_latency_ms", "summary", (),
           "Router upstream (replica) dispatch latency (ms)"),
        _m("hvdt_router_retries_total", "counter", ("tenant",),
           "Wire-death retries dispatched to another replica, by "
           "tenant class"),
        _m("hvdt_router_hedges_total", "counter", ("tenant",),
           "Hedge requests issued past the hedge threshold"),
        _m("hvdt_router_hedge_wins_total", "counter", ("tenant",),
           "Hedge requests that answered before the primary"),
        _m("hvdt_router_ejections_total", "counter", ("reason", "tenant"),
           "Replica ejections by reason (probe | slo | dispatch) and "
           "the tenant whose traffic triggered them (control-loop "
           "ejections carry tenant=control)"),
        _m("hvdt_router_readmissions_total", "counter", (),
           "Ejected replicas re-admitted after a fresh heartbeat"),
        _m("hvdt_router_no_replica_total", "counter", (),
           "Requests that found no live replica"),
        _m("hvdt_router_inflight", "gauge", (),
           "Requests currently in flight through the router"),
        _m("hvdt_router_replicas_live", "gauge", (),
           "Live replicas the router currently sees"),
        # -- serving plane (serve/*) --
        _m("serve_queue_depth", "gauge", (),
           "Rows queued but not yet dispatched (live probe)"),
        _m("serve_requests_total", "counter", (),
           "Rows admitted to the dynamic batcher"),
        _m("serve_rejected_total", "counter", (),
           "Rows shed at the admission bound (HTTP 503)"),
        _m("serve_batches_total", "counter", (),
           "Batches dispatched by the batcher"),
        _m("serve_deadline_expired_total", "counter", (),
           "Requests failed by the per-request deadline watchdog"),
        _m("serve_queue_wait_seconds", "summary", (),
           "Row wait from admission to dispatch"),
        _m("serve_batch_fill", "summary", (),
           "Dispatched batch rows / max_batch_size"),
        _m("serve_compiles_total", "counter", (),
           "Engine jit compiles (flat in steady state)"),
        _m("serve_engine_batches_total", "counter", (),
           "Batches executed by the inference engine"),
        _m("serve_pad_rows_total", "counter", (),
           "Pad rows added to reach the shape bucket"),
        _m("serve_http_responses_total", "counter", ("route", "status"),
           "HTTP responses by route and status"),
        _m("serve_request_latency_ms_*", "summary", (),
           "End-to-end handler latency per route "
           "(serve_request_latency_ms_<route>)"),
        _m("serve_draining", "gauge", (),
           "1 while the server drains (admission closed)"),
        _m("serve_reloads_total", "counter", (),
           "Hot weight reloads applied"),
        _m("serve_reload_failures_total", "counter", (),
           "Failed reload attempts (kept serving)"),
        _m("serve_skipped_unverified_total", "counter", (),
           "Checkpoint steps skipped by manifest verification"),
        _m("serve_checkpoint_step", "gauge", (),
           "Checkpoint step currently served"),
        _m("serve_last_good_step", "gauge", (),
           "Newest verified checkpoint step seen by the watcher"),
        # --- continuous-batching LLM engine (serve/llm) ---
        _m("hvdt_engine_iterations_total", "counter", (),
           "Continuous-batching scheduler iterations executed"),
        _m("hvdt_engine_decode_tokens_total", "counter", (),
           "Tokens emitted by the paged decode step"),
        _m("hvdt_engine_prefill_tokens_total", "counter", (),
           "Prompt tokens written into the paged KV cache"),
        _m("hvdt_engine_preemptions_total", "counter", (),
           "Sequences evicted under block pressure (recompute on "
           "return)"),
        _m("hvdt_engine_prefix_hits_total", "counter", (),
           "Admissions served by forking a live prompt's block table "
           "(copy-on-write prefix sharing)"),
        _m("hvdt_engine_admissions_total", "counter", ("tenant",),
           "Sequences admitted to the block budget, by tenant"),
        _m("hvdt_engine_tokens_per_sec", "gauge", (),
           "Decode throughput (EMA over iterations)"),
        _m("hvdt_engine_kv_blocks_total", "gauge", (),
           "Allocatable KV blocks (sink block excluded)"),
        _m("hvdt_engine_kv_blocks_in_use", "gauge", (),
           "KV blocks held by live block tables (live probe)"),
        _m("hvdt_engine_active_seqs", "gauge", (),
           "Admitted (prefilling or decoding) sequences (live probe)"),
        _m("hvdt_engine_batch_quota_slots", "gauge", (),
           "Decode slots the batch tenant may hold (adapts off the "
           "interactive-wait time series)"),
        _m("hvdt_engine_queue_depth", "gauge", ("tenant",),
           "Waiting (not yet admitted) sequences, by tenant"),
        _m("hvdt_engine_decode_step_seconds", "summary", (),
           "Wall time of one paged decode iteration"),
        _m("hvdt_engine_prefill_chunk_seconds", "summary", (),
           "Wall time of one prefill chunk (or ring prefill shot)"),
        _m("hvdt_engine_wait_ms_*", "summary", (),
           "Submit-to-first-token latency by tenant "
           "(hvdt_engine_wait_ms_<tenant>; Summary carries no labels)"),
    ]
}


def declared_metric(name: str) -> bool:
    """Whether a metric name is declared in the CATALOG (exact match, or
    covered by a `prefix*` wildcard family)."""
    if name in CATALOG:
        return True
    for spec_name in CATALOG:
        if spec_name.endswith("*") and name.startswith(spec_name[:-1]):
            return True
    return False
