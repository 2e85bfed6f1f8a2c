"""The port's attribution plane against the JAX package's: the windowed
detectors, ``AnomalyMonitor`` over a metric history, the driver's
``ClusterAnomalyMonitor`` and ``rollup`` over the same KV snapshots, the
event log, and ``hvdtrun top``'s frame — equal outputs on equal inputs
(exact: JSON and text)."""

from __future__ import annotations

import json

import numpy as np
import pytest

from horovod_tpu.telemetry import aggregate as jagg
from horovod_tpu.telemetry import anomaly as janom
from horovod_tpu.telemetry import history as jhist
from horovod_tpu.telemetry import metrics as jmet
from horovod_tpu.telemetry import top as jtop

from horovod_tpu_torch.telemetry import aggregate as tagg
from horovod_tpu_torch.telemetry import anomaly as tanom
from horovod_tpu_torch.telemetry import history as thist
from horovod_tpu_torch.telemetry import metrics as tmet
from horovod_tpu_torch.telemetry import top as ttop

PKGS = [(janom, jhist, jmet), (tanom, thist, tmet)]

rng = np.random.default_rng(20)
FLAT = list(0.05 + 0.001 * rng.standard_normal(16))
SHIFT = FLAT + list(0.12 + 0.001 * rng.standard_normal(8))
DROP = [0.9] * 8 + [0.5] * 8
PTS = [(float(i), 10 * i, float(1000 * i * i if i > 12 else 1000 * i))
       for i in range(30)]


@pytest.mark.parametrize("series", ["flat", "shift", "drop"])
def test_detectors_match_reference(series):
    vals = {"flat": FLAT, "shift": SHIFT, "drop": DROP}[series]
    for fn in ("level_shift", "level_drop"):
        assert getattr(tanom, fn)(vals, 8) == getattr(janom, fn)(vals, 8)
    assert tanom.threshold_cross(vals, 0.1) == janom.threshold_cross(vals,
                                                                     0.1)
    assert tanom.rate_shift(PTS, 6) == janom.rate_shift(PTS, 6)


def _monitor_run(anom, hist, met, path):
    reg = met.MetricsRegistry()
    log = anom.EventLog(str(path), max_bytes=0)
    mon = anom.AnomalyMonitor(window=4, registry=reg, event_log=log,
                              rank=3, pod="podB")
    h = hist.MetricHistory(window=64, sample_s=0.0, registry=reg,
                           monitor=mon, clock=lambda: 1000.0)
    gp = reg.gauge("hvdt_goodput_fraction", "")
    skew = reg.gauge("hvdt_step_time_skew", "")
    wb = reg.counter("hvdt_wire_bytes_total", "")
    for step in range(1, 25):
        gp.set(0.95 if step < 14 else 0.5)
        skew.set(1.0 if step < 18 else 3.0)
        wb.inc(100.0 if step < 12 else 400.0, axis="dcn", wire="int8")
        h.observe_step(step, 0.05 if step < 10 else 0.2)
    events = anom.read_event_log(str(path))
    for e in events:
        e.pop("ts")
    return events, reg.render()


def test_anomaly_monitor_matches_reference(tmp_path):
    (jev, jtext), (tev, ttext) = [
        _monitor_run(*pkg, tmp_path / f"{i}.jsonl")
        for i, pkg in enumerate(PKGS)]
    assert {e["kind"] for e in tev} == {"step_time_shift", "goodput_drop",
                                        "straggler_onset", "wire_drift"}
    assert json.dumps(tev) == json.dumps(jev)
    assert ttext == jtext


def _snap(rank, pod, base, slow=1.0, steps=range(1, 33)):
    ts = [[1e9 + s, s, base * slow * (1 + 0.01 * ((s * 7 + rank) % 5))]
          for s in steps]
    return {"wall_ts": 1e9, "step": max(steps), "pod": pod,
            "steps": len(ts), "step_time_p50_ms": base * slow * 1e3,
            "goodput_fraction": 0.9 - 0.01 * rank,
            "timeseries": {"window": 64, "sample_s": 0.0, "series": {
                "step_time": ts,
                "goodput_fraction": [[p[0], p[1], 0.9] for p in ts],
                "wire_bytes.dp": [[p[0], p[1], 1e6 * p[1]] for p in ts]}}}


def _snapshots():
    snaps = {r: _snap(r, "podA" if r < 2 else "podB" if r < 4 else "podC",
                      0.05, slow=3.0 if r in (2, 3) else 1.0)
             for r in range(6)}
    snaps[6] = {"step_time_p50_ms": 400.0, "pod": "podC"}   # old schema
    return snaps


def test_rollup_matches_reference():
    for name in ("step_join", "recent_step_means"):
        assert (getattr(tagg, name)(_snapshots())
                == getattr(jagg, name)(_snapshots()))
    got = tagg.rollup(_snapshots(), registry=tmet.MetricsRegistry())
    want = jagg.rollup(_snapshots(), registry=jmet.MetricsRegistry())
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert got["unaligned_ranks"] == [6]
    assert got["cluster"]["worst_pod"] == "podB"


def test_cluster_anomalies_match_reference(tmp_path):
    out = []
    for i, (anom, _, met) in enumerate(PKGS):
        path = tmp_path / f"c{i}.jsonl"
        mon = anom.ClusterAnomalyMonitor(
            window=8, registry=met.MetricsRegistry(),
            event_log=anom.EventLog(str(path)))
        first = mon.observe(_snapshots())
        again = mon.observe(_snapshots())          # latched: nothing new
        evs = anom.read_event_log(str(path))
        for e in evs:
            e.pop("ts")
        out.append((len(first), again, evs))
    assert out[1] == out[0]
    # No perf_deviation_ratio in the snapshots: the port publishes none
    # until its cost model is ported, so neither package fires that rule.
    assert {(e["kind"], e["scope"]) for e in out[1][2]} == {
        ("step_time_shift", "pod"), ("step_time_shift", "rank")}


def test_event_log_rotation_matches_reference(tmp_path):
    kept = []
    for i, anom in enumerate((janom, tanom)):
        path = tmp_path / f"r{i}.jsonl"
        log = anom.EventLog(str(path), max_bytes=100)
        for k in range(6):
            log.emit({"kind": "x", "step": k, "ts": 1.0})
        kept.append([[e["step"] for e in anom.read_event_log(str(p))]
                     for p in (path, str(path) + ".1")])
    assert kept[1] == kept[0] == [[4, 5], [2, 3]]


def _docs():
    docs = {}
    for r in range(3):
        snap = _snap(r, f"pod{r // 2}", 0.05, slow=2.0 if r == 2 else 1.0)
        docs[f"10.0.0.{r}:9090"] = dict(snap["timeseries"], rank=r,
                                        pod=snap["pod"], step=32)
    docs["10.0.0.9:9090"] = None
    return docs


def test_top_frame_matches_reference():
    events = [
        {"kind": "step_time_shift", "step": 20, "rank": 2, "pod": "pod1",
         "message": "rank 2 slow"},
        {"kind": "controller_decision", "step": 21,
         "event": {"kind": "step_time_shift"},
         "chosen": {"action": {"kind": "evict_pod",
                               "params": {"pod": "pod1"}},
                    "predicted_delta_s": -0.012}, "outcome": "applied"},
        {"kind": "fleet_outcome", "step": 22,
         "move": {"kind": "reclaim", "pod": "pod3"}, "outcome": "recovered",
         "pressure_before": 1.4, "pressure_after": 0.9},
    ]
    # The reference's frame less its dev column (the perf-deviation
    # ratio, which the documents do not carry: "-" on every rank row).
    want = []
    for line in jtop.render_frame(_docs(), events).splitlines():
        for cell in ("   dev", "     -"):
            if line.startswith(("rank", "   ")) and line.endswith(cell):
                line = line[:-len(cell)]
                break
        want.append(line)
    assert ttop.render_frame(_docs(), events) == "\n".join(want)
    assert ttop.sparkline([1, 2, 3, 2, 1]) == jtop.sparkline([1, 2, 3, 2, 1])
