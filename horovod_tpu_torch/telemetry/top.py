"""``hvdtrun top`` — a live terminal view over worker ``/timeseries``.

The port's copy of the JAX package's ``telemetry/top.py``: the same
frame from the same documents, less the reference's ``dev`` column
(the perf-deviation ratio, which the port publishes once its cost model
is ported, ROADMAP Queue 1, item 8).  The controller and fleet lines
render the ``controller_*`` / ``fleet_*`` records of an event log as
the reference does (the port writes none yet: those planes are item 8
too).

The operator's "why is this job slow" glance without a Grafana stack:
polls one or more workers' ``/timeseries`` endpoints (the history layer,
``HVDT_HISTORY``) and renders, per refresh,

* a per-rank step-time sparkline with current/median step time,
* goodput fraction and MFU,
* the worst pod by recent step time,
* the tail of the anomaly event log (``--event-log``),
* the last few policy-controller decisions (``controller_decision`` /
  ``controller_outcome`` records in the same event log): event ->
  chosen action -> predicted delta -> outcome.

Example frame::

    hvdt top — 2 ranks, step 128
    rank  pod    step time                         last     p50
       0  podA   ▂▂▂▁▂▂▂▂▂▂▂▂▂▂▂▂▂▂▂▂▂▂▂▂       50.1ms  50.0ms
       1  podB   ▂▂▂▂▂▂▂▂█▂▂▂▂▂▂▂▂▂▂▂▂▂▂▂       50.3ms  50.2ms
    goodput 0.98   worst pod: podB
    anomalies:
      [step 88] step_time_shift rank=1 pod=podB: ...

Pure stdlib (urllib); ``--once`` prints a single frame and exits — the
scriptable/testable mode.  The refresh loop waits on an Event, not a
sleep poll, so Ctrl-C lands immediately.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import urllib.request
from typing import Any, Dict, List, Optional

__all__ = ["main", "sparkline", "render_frame", "fetch_timeseries",
           "controller_lines", "fleet_lines"]

_CONTROLLER_KINDS = ("controller_decision", "controller_outcome")
_FLEET_KINDS = ("fleet_decision", "fleet_outcome")

_BLOCKS = "▁▂▃▄▅▆▇█"


def sparkline(values: List[float], width: int = 24) -> str:
    """Unicode block sparkline of the most recent ``width`` values,
    scaled to the window's own min/max (a flat series renders flat)."""
    vals = [float(v) for v in values][-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return _BLOCKS[1] * len(vals)
    out = []
    for v in vals:
        idx = int((v - lo) / (hi - lo) * (len(_BLOCKS) - 1) + 0.5)
        out.append(_BLOCKS[max(0, min(len(_BLOCKS) - 1, idx))])
    return "".join(out)


def fetch_timeseries(endpoint: str, timeout: float = 3.0
                     ) -> Optional[Dict[str, Any]]:
    """One worker's ``/timeseries`` doc, or None when unreachable /
    disabled (a dead worker must not kill the view)."""
    url = endpoint.rstrip("/")
    if not url.startswith("http"):
        url = "http://" + url
    if not url.endswith("/timeseries"):
        url = url + "/timeseries"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return json.loads(resp.read().decode())
    except Exception:
        return None


def _series_values(doc: Dict[str, Any], name: str) -> List[float]:
    pts = ((doc.get("series") or {}).get(name)) or []
    out = []
    for p in pts:
        try:
            out.append(float(p[2]))
        except (TypeError, ValueError, IndexError):
            continue
    return out


def _median(vals: List[float]) -> Optional[float]:
    if not vals:
        return None
    ordered = sorted(vals)
    return ordered[(len(ordered) - 1) // 2]


def _action_str(action: Optional[Dict[str, Any]]) -> str:
    if not action:
        return "?"
    params = action.get("params") or {}
    inner = ",".join(f"{k}={v}" for k, v in sorted(params.items()))
    return f"{action.get('kind', '?')}({inner})" if inner \
        else str(action.get("kind", "?"))


def controller_lines(events: List[Dict[str, Any]], last: int = 4
                     ) -> List[str]:
    """Render the last ``last`` controller records from the event log —
    one line each: what fired, what was chosen at what predicted delta,
    and how it ended (applied/suppressed/recovered/rolled back)."""
    recs = [e for e in events if e.get("kind") in _CONTROLLER_KINDS]
    out = []
    for r in recs[-last:]:
        step = r.get("step", "?")
        if r.get("kind") == "controller_decision":
            chosen = r.get("chosen") or {}
            delta = chosen.get("predicted_delta_s")
            deltas = (f" pred {delta * 1e3:+.1f}ms"
                      if isinstance(delta, (int, float)) else "")
            out.append(
                f"  [step {step}] {(r.get('event') or {}).get('kind', '?')}"
                f" -> {_action_str(chosen.get('action'))}{deltas}"
                f" [{r.get('outcome', '?')}]")
        else:
            before, after = r.get("deviation_before"), \
                r.get("deviation_after")
            dev = (f" dev {before:.2f}->{after:.2f}"
                   if isinstance(before, (int, float))
                   and isinstance(after, (int, float)) else "")
            out.append(
                f"  [step {step}] {_action_str(r.get('action'))}"
                f" -> {r.get('outcome', '?')}{dev}")
    return out


def _move_str(move: Optional[Dict[str, Any]]) -> str:
    if not move:
        return "?"
    return f"{move.get('kind', '?')}({move.get('pod', '?')})"


def fleet_lines(events: List[Dict[str, Any]], last: int = 4
                ) -> List[str]:
    """Render the last ``last`` fleet-scheduler records from the event
    log — one line each: the trigger, the chosen move at its predicted
    gain, and the outcome (applied/suppressed/recovered/rolled back)."""
    recs = [e for e in events if e.get("kind") in _FLEET_KINDS]
    out = []
    for r in recs[-last:]:
        step = r.get("step", "?")
        if r.get("kind") == "fleet_decision":
            chosen = r.get("chosen") or {}
            gain = chosen.get("predicted_gain")
            gains = (f" gain {gain:+.3f}"
                     if isinstance(gain, (int, float)) else "")
            out.append(
                f"  [step {step}] "
                f"{(r.get('trigger') or {}).get('kind', '?')}"
                f" -> {_move_str(chosen.get('move'))}{gains}"
                f" [{r.get('outcome', '?')}]")
        else:
            before, after = r.get("pressure_before"), \
                r.get("pressure_after")
            press = (f" pressure {before:.2f}->{after:.2f}"
                     if isinstance(before, (int, float))
                     and isinstance(after, (int, float)) else "")
            out.append(
                f"  [step {step}] {_move_str(r.get('move'))}"
                f" -> {r.get('outcome', '?')}{press}")
    return out


def render_frame(docs: Dict[str, Optional[Dict[str, Any]]],
                 events: Optional[List[Dict[str, Any]]] = None,
                 width: int = 24) -> str:
    """One frame of the top view from fetched ``/timeseries`` docs
    (keyed by endpoint) and the anomaly event tail."""
    live = {ep: d for ep, d in docs.items() if d is not None}
    max_step = max((int(d.get("step") or 0) for d in live.values()),
                   default=0)
    lines = [f"hvdt top — {len(live)}/{len(docs)} ranks, "
             f"step {max_step}"]
    lines.append(f"{'rank':>4}  {'pod':<6} {'step time':<{width}}  "
                 f"{'last':>8} {'p50':>8}")
    pod_means: Dict[str, List[float]] = {}
    goodputs: List[float] = []
    for ep in sorted(docs):
        doc = docs[ep]
        if doc is None:
            lines.append(f"{'?':>4}  {'-':<6} "
                         f"{'(unreachable: ' + ep + ')':<{width}}")
            continue
        rank = doc.get("rank", "?")
        pod = str(doc.get("pod") or "-")
        steps = _series_values(doc, "step_time")
        spark = sparkline(steps, width)
        last = f"{steps[-1] * 1e3:.1f}ms" if steps else "-"
        p50 = _median(steps[-width:])
        p50s = f"{p50 * 1e3:.1f}ms" if p50 is not None else "-"
        lines.append(f"{rank:>4}  {pod:<6} {spark:<{width}}  "
                     f"{last:>8} {p50s:>8}")
        if steps:
            # Worst-pod ranking uses the recent MEAN, not the median:
            # a single multi-second hiccup is exactly what the operator
            # wants surfaced, and a median hides it.
            recent = steps[-width:]
            pod_means.setdefault(pod, []).append(
                sum(recent) / len(recent))
        gp = _series_values(doc, "goodput_fraction")
        if gp:
            goodputs.append(gp[-1])
    footer = []
    if goodputs:
        footer.append(f"goodput {sum(goodputs) / len(goodputs):.2f}")
    if pod_means:
        worst = max(sorted(pod_means),
                    key=lambda p: _median(pod_means[p]) or 0.0)
        footer.append(f"worst pod: {worst} "
                      f"({(_median(pod_means[worst]) or 0) * 1e3:.1f}ms)")
    if footer:
        lines.append("   ".join(footer))
    if events:
        anomalies = [e for e in events
                     if e.get("kind") not in _CONTROLLER_KINDS
                     and e.get("kind") not in _FLEET_KINDS]
        if anomalies:
            lines.append("anomalies:")
            for ev in anomalies[-5:]:
                who = []
                if ev.get("rank") is not None:
                    who.append(f"rank={ev['rank']}")
                if ev.get("pod"):
                    who.append(f"pod={ev['pod']}")
                lines.append(f"  [step {ev.get('step', '?')}] "
                             f"{ev.get('kind', '?')} {' '.join(who)}: "
                             f"{ev.get('message', '')}")
        ctl = controller_lines(events)
        if ctl:
            lines.append("controller:")
            lines.extend(ctl)
        flt = fleet_lines(events)
        if flt:
            lines.append("fleet:")
            lines.extend(flt)
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="hvdtrun top",
        description="Live terminal view over worker /timeseries "
                    "endpoints (requires HVDT_TELEMETRY + HVDT_HISTORY "
                    "on the workers).")
    p.add_argument("--endpoints", default="127.0.0.1:9090",
                   help="Comma list of worker exporter endpoints "
                        "(host:port; the /timeseries path is implied). "
                        "Default: the local worker's default metrics "
                        "port.")
    p.add_argument("--interval", type=float, default=2.0,
                   help="Refresh period in seconds.")
    p.add_argument("--once", action="store_true",
                   help="Print a single frame and exit (scriptable).")
    p.add_argument("--event-log", default=None,
                   help="Anomaly event log (HVDT_EVENT_LOG JSONL) to "
                        "tail into the frame.")
    args = p.parse_args(argv)

    endpoints = [e.strip() for e in args.endpoints.split(",") if e.strip()]
    stop = threading.Event()
    while True:
        docs = {ep: fetch_timeseries(ep) for ep in endpoints}
        events = None
        if args.event_log:
            from .anomaly import read_event_log

            events = read_event_log(args.event_log)
        frame = render_frame(docs, events)
        if args.once:
            print(frame)
            return 0
        # Full-frame refresh: clear + home (ANSI), then the frame.
        sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
        sys.stdout.flush()
        try:
            if stop.wait(max(0.2, args.interval)):
                return 0
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":
    sys.exit(main())
