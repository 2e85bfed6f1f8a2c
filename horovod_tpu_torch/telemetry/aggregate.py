"""Driver-side step-aligned aggregation of worker telemetry snapshots.

The port's copy of the JAX package's ``telemetry/aggregate.py``.

``ElasticDriver.telemetry_snapshots()`` returns each rank's latest KV
snapshot; with the history layer on (``HVDT_HISTORY``) every snapshot
also embeds ``wall_ts``, the current ``step`` id, and a recent
``timeseries`` slice.  This module joins those per-rank series **on
step id** (wall clocks skew across hosts; deterministic step ids — the
trace-id convention of ``trace.py`` — do not) and rolls them up:

* :func:`step_join` — ``{step: {rank: value}}`` for one series across
  the fleet;
* :func:`rollup` — the full driver-side view: aligned step range,
  per-pod median/p99 step time, cluster wire-bytes-by-axis, mean
  goodput fraction, and a per-step cluster step-time series;
* :func:`recent_step_means` — per-rank recent mean step seconds, the
  input of the cluster anomaly rules.

Schema tolerance: snapshots from workers running an older schema (no
``step``/``timeseries`` — history off, or a pre-upgrade binary) are
skipped from the step-aligned roll-up and counted in
``hvdt_snapshot_unaligned_total``; their scalar fields still aggregate.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from .metrics import MetricsRegistry, default_registry

__all__ = ["aligned_snapshots", "step_join", "recent_step_means",
           "rollup"]


def _series_points(snap: Dict[str, Any], name: str
                   ) -> List[Tuple[float, int, float]]:
    series = ((snap.get("timeseries") or {}).get("series") or {})
    pts = series.get(name) or []
    out: List[Tuple[float, int, float]] = []
    for p in pts:
        try:
            ts, step, value = p
            out.append((float(ts), int(step), float(value)))
        except (TypeError, ValueError):
            continue
    return out


def aligned_snapshots(snapshots: Dict[int, Dict[str, Any]],
                      registry: Optional[MetricsRegistry] = None
                      ) -> Tuple[Dict[int, Dict[str, Any]], List[int]]:
    """Split snapshots into step-alignable ones (carry ``step`` +
    ``timeseries``) and the unaligned rest; unaligned ranks are counted
    in ``hvdt_snapshot_unaligned_total`` (and skipped by the join, not
    failed — old workers keep reporting their scalars)."""
    aligned: Dict[int, Dict[str, Any]] = {}
    unaligned: List[int] = []
    for rank in sorted(snapshots):
        snap = snapshots[rank] or {}
        if snap.get("step") is not None and _series_points(
                snap, "step_time"):
            aligned[rank] = snap
        else:
            unaligned.append(rank)
    if unaligned:
        reg = registry if registry is not None else default_registry()
        reg.counter(
            "hvdt_snapshot_unaligned_total",
            "Driver-side roll-ups that skipped a rank whose KV "
            "snapshot carried no step id / time series (old snapshot "
            "schema or history off on that worker)"
        ).inc(len(unaligned))
    return aligned, unaligned


def step_join(snapshots: Dict[int, Dict[str, Any]],
              series: str = "step_time") -> Dict[int, Dict[int, float]]:
    """Join one series across ranks on step id: ``{step: {rank:
    value}}`` (only alignable snapshots contribute; pass the
    ``aligned_snapshots`` output to also get the skip accounting)."""
    out: Dict[int, Dict[int, float]] = {}
    for rank in sorted(snapshots):
        for _, step, value in _series_points(snapshots[rank], series):
            out.setdefault(step, {})[rank] = value
    return out


def recent_step_means(snapshots: Dict[int, Dict[str, Any]],
                      window: int = 8) -> Dict[int, float]:
    """Per-rank mean step seconds over each rank's most recent
    ``window`` samples — the cluster anomaly rules' input.  Ranks
    without a step series fall back to their scalar
    ``step_time_p50_ms`` so an old-schema worker still participates in
    outlier detection."""
    out: Dict[int, float] = {}
    for rank in sorted(snapshots):
        snap = snapshots[rank] or {}
        pts = _series_points(snap, "step_time")
        if pts:
            vals = [v for _, _, v in pts[-window:]]
            out[rank] = sum(vals) / len(vals)
            continue
        p50 = snap.get("step_time_p50_ms")
        if p50:
            out[rank] = float(p50) / 1e3
    return out


def _median(values: Sequence[float]) -> float:
    ordered = sorted(values)
    return ordered[(len(ordered) - 1) // 2]


def _p99(values: Sequence[float]) -> float:
    ordered = sorted(values)
    idx = min(len(ordered) - 1, max(0, int(0.99 * len(ordered) + 0.5) - 1))
    return ordered[idx]


def rollup(snapshots: Dict[int, Dict[str, Any]],
           registry: Optional[MetricsRegistry] = None) -> Dict[str, Any]:
    """The driver-side fleet view over one round of snapshots.

    Returns::

        {"ranks": [...], "unaligned_ranks": [...],
         "aligned_steps": [first, last] | None,
         "per_pod": {pod: {"ranks", "step_time_p50_ms",
                           "step_time_p99_ms"}},
         "cluster": {"step_time_series": {step: {"median_ms",
                                                 "p99_ms", "ranks"}},
                     "wire_bytes_by_axis": {axis: bytes},
                     "goodput_fraction_mean": float | None,
                     "goodput_series": {step: mean_fraction},
                     "worst_pod": pod | None}}
    """
    aligned, unaligned = aligned_snapshots(snapshots, registry=registry)
    joined = step_join(aligned, "step_time")
    all_ranks = sorted(snapshots)

    # Steps every aligned rank reported — the strictly comparable range.
    full_steps = sorted(s for s, per_rank in joined.items()
                        if len(per_rank) == len(aligned)) if aligned else []

    step_series: Dict[int, Dict[str, Any]] = {}
    for step in sorted(joined):
        vals = sorted(joined[step].values())
        step_series[step] = {
            "median_ms": round(_median(vals) * 1e3, 3),
            "p99_ms": round(_p99(vals) * 1e3, 3),
            "ranks": len(vals),
        }

    # Per-pod roll-up over each rank's recent window.
    means = recent_step_means(snapshots)
    by_pod: Dict[str, List[int]] = {}
    for rank in sorted(snapshots):
        pod = (snapshots[rank] or {}).get("pod") or ""
        by_pod.setdefault(pod, []).append(rank)
    per_pod: Dict[str, Dict[str, Any]] = {}
    for pod in sorted(by_pod):
        if not pod:
            continue
        vals = [means[r] for r in by_pod[pod] if r in means]
        if not vals:
            continue
        per_pod[pod] = {
            "ranks": by_pod[pod],
            "step_time_p50_ms": round(_median(vals) * 1e3, 3),
            "step_time_p99_ms": round(_p99(vals) * 1e3, 3),
        }
    worst_pod = max(per_pod,
                    key=lambda p: per_pod[p]["step_time_p50_ms"],
                    default=None)

    # Cluster wire bytes by axis: sum each rank's latest cumulative
    # per-axis sample (series "wire_bytes.<axis>").
    wire_by_axis: Dict[str, float] = {}
    for rank in sorted(aligned):
        series = ((aligned[rank].get("timeseries") or {})
                  .get("series") or {})
        for name in sorted(series):
            if not name.startswith("wire_bytes."):
                continue
            pts = _series_points(aligned[rank], name)
            if pts:
                axis = name.split(".", 1)[1]
                wire_by_axis[axis] = wire_by_axis.get(axis, 0.0) \
                    + pts[-1][2]

    # Goodput: scalar mean + a step-joined series when present.
    goodputs = [float(s["goodput_fraction"]) for s in snapshots.values()
                if s and s.get("goodput_fraction") is not None]
    gp_joined = step_join(aligned, "goodput_fraction")
    goodput_series = {
        step: round(sum(per.values()) / len(per), 4)
        for step, per in sorted(gp_joined.items())}

    return {
        "ranks": all_ranks,
        "unaligned_ranks": unaligned,
        "aligned_steps": ([full_steps[0], full_steps[-1]]
                          if full_steps else None),
        "per_pod": per_pod,
        "cluster": {
            "step_time_series": step_series,
            "wire_bytes_by_axis": {a: int(v) for a, v in
                                   sorted(wire_by_axis.items())},
            "goodput_fraction_mean": (round(sum(goodputs)
                                            / len(goodputs), 4)
                                      if goodputs else None),
            "goodput_series": goodput_series,
            "worst_pod": worst_pod,
        },
    }
