"""Per-tensor Chrome-tracing timeline of the eager collectives.

The counterpart of the JAX package's ``timeline.py`` (Horovod's
``common/timeline.{h,cc}``).  Each tensor name is a "pid" row of the
JSON; the eager controller records, per tensor, ``NEGOTIATE_<OP>`` from
enqueue until its response is ready, then ``EXEC_<OP>`` until the
collective is done (the end marker carries the output shape), and an
``ERROR`` instant when it fails; under ``HVDT_TIMELINE_MARK_CYCLES`` a
``CYCLE`` instant on the ``_cycle`` row marks each negotiation cycle.
Events go onto a queue that a writer thread drains into the file, so the
controller never waits on file IO.  The writer also books each span's
duration into ``hvdt_phase_<PHASE>_seconds`` (``HVDT_TELEMETRY``) and
the distributed tracer (``HVDT_TRACE_DIR``).

Enable with ``HVDT_TIMELINE=<path>`` (read when the controller starts) or
at any time with :func:`start_timeline` / :func:`stop_timeline`, which a
running controller picks up at its next event.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from typing import Dict, Optional

from .common import config

__all__ = ["Timeline", "current", "get_timeline", "start_timeline",
           "stop_timeline"]

log = logging.getLogger(__name__)


class _Event:
    __slots__ = ("phase", "tensor", "marker", "args", "ts")

    def __init__(self, phase: str, tensor: str, marker: str,
                 args: Optional[dict], ts: float):
        self.phase = phase      # 'B' begin, 'E' end, 'i' instant
        self.tensor = tensor
        self.marker = marker
        self.args = args
        self.ts = ts


class Timeline:
    """Chrome-tracing JSON writer with a writer thread; each tensor gets
    its own pid row and its activities nest as duration events."""

    def __init__(self, path: str, mark_cycles: bool = False):
        self.path = path
        self.mark_cycles = mark_cycles
        self._queue: "queue.Queue[Optional[_Event]]" = queue.Queue()
        self._tensor_pids: Dict[str, int] = {}
        self._next_pid = 1
        self._start = time.perf_counter()
        self._file = open(path, "w")
        self._file.write("[\n")
        self._first = True
        self._closed = False
        self._writer = threading.Thread(target=self._writer_loop,
                                        name="hvdt-timeline-writer",
                                        daemon=True)
        self._writer.start()

    # -- recording (the controller's side: enqueue only) ---------------------
    def _now_us(self) -> float:
        return (time.perf_counter() - self._start) * 1e6

    def start_activity(self, tensor: str, activity: str,
                       args: Optional[dict] = None) -> None:
        self._queue.put(_Event("B", tensor, activity, args, self._now_us()))

    def end_activity(self, tensor: str, args: Optional[dict] = None) -> None:
        self._queue.put(_Event("E", tensor, "", args, self._now_us()))

    def instant(self, tensor: str, marker: str,
                args: Optional[dict] = None) -> None:
        self._queue.put(_Event("i", tensor, marker, args, self._now_us()))

    def mark_cycle(self) -> None:
        if self.mark_cycles:
            self.instant("_cycle", "CYCLE")

    # -- writer thread --------------------------------------------------------
    def _pid_for(self, tensor: str) -> int:
        pid = self._tensor_pids.get(tensor)
        if pid is None:
            pid = self._next_pid
            self._next_pid += 1
            self._tensor_pids[tensor] = pid
            self._emit({"name": "process_name", "ph": "M", "pid": pid,
                        "args": {"name": tensor}})
        return pid

    def _emit(self, record: dict) -> None:
        if not self._first:
            self._file.write(",\n")
        self._first = False
        self._file.write(json.dumps(record))

    def _writer_loop(self) -> None:
        from .telemetry.instrument import get_recorder
        from .telemetry.trace import get_tracer

        open_spans: Dict[int, list] = {}
        while True:
            ev = self._queue.get()
            if ev is None:
                break
            pid = self._pid_for(ev.tensor)
            rec = {"ph": ev.phase, "pid": pid,
                   "tid": 0, "ts": round(ev.ts, 3)}
            if ev.phase in ("B", "i"):
                rec["name"] = ev.marker
            if ev.phase == "i":
                rec["s"] = "p"
            if ev.args:
                rec["args"] = ev.args
            self._emit(rec)
            # Each B/E span also goes into hvdt_phase_<PHASE>_seconds
            # (HVDT_TELEMETRY) and the distributed tracer's buffer
            # (HVDT_TRACE_DIR), which feeds the driver's merged trace.
            if ev.phase == "B":
                open_spans.setdefault(pid, []).append((ev.marker, ev.ts))
            elif ev.phase == "E":
                stack = open_spans.get(pid)
                if stack:
                    marker, t0 = stack.pop()
                    dur_s = (ev.ts - t0) / 1e6
                    recorder = get_recorder()
                    if recorder is not None:
                        recorder.observe_phase(marker, dur_s)
                    tracer = get_tracer()
                    if tracer is not None:
                        tracer.complete(marker, dur_s, cat="timeline",
                                        args={"tensor": ev.tensor})

    def close(self) -> None:
        """Write what is queued, close the JSON array and the file."""
        if self._closed:
            return
        self._closed = True
        self._queue.put(None)
        self._writer.join(timeout=5)
        self._file.write("\n]\n")
        self._file.close()


# -- the process's timeline -----------------------------------------------------

_timeline: Optional[Timeline] = None
_tl_lock = threading.Lock()


def current() -> Optional[Timeline]:
    """The active timeline, if any: a read without a lock for the
    controller's hot path (no start from the environment)."""
    return _timeline


def get_timeline() -> Optional[Timeline]:
    """The active timeline, started from ``HVDT_TIMELINE`` (and
    ``HVDT_TIMELINE_MARK_CYCLES``) if none is active and the path is
    set."""
    global _timeline
    with _tl_lock:
        if _timeline is None:
            path = config.get_str("HVDT_TIMELINE")
            if path:
                _timeline = Timeline(
                    path, config.get_bool("HVDT_TIMELINE_MARK_CYCLES"))
        return _timeline


def start_timeline(path: str, mark_cycles: bool = False) -> None:
    """Start recording to ``path`` (Horovod's ``hvd.start_timeline``); a
    second start while one is active is ignored with a warning."""
    global _timeline
    with _tl_lock:
        if _timeline is not None:
            log.warning("timeline already active; ignoring start_timeline")
            return
        _timeline = Timeline(path, mark_cycles)


def stop_timeline() -> None:
    """Stop recording and close the file."""
    global _timeline
    with _tl_lock:
        if _timeline is not None:
            _timeline.close()
            _timeline = None
