"""Pod-granular topology planning + failure correlation for the elastic
driver.

The port's copy of the JAX package's ``runner/elastic/pods.py``.  At
scale the dominant failure mode is *correlated*: a pod (a group of hosts
that fail and are reclaimed together) going away takes every one of its
hosts at once.  A driver that models a flat host set sees N unrelated
crashes and makes N independent blacklist/recovery decisions; this
module gives it the pod view:

* :func:`group_pods` — hosts → ordered pods, from the discovery
  script's ``@pod`` column, or chunked to ``HVDT_POD_SIZE`` slots, or
  (default) one pod per host — which degenerates to the PR-4 host
  semantics, so single-host jobs behave exactly as before.
* :func:`plan_assignments` — whole-pod slot assignment: the world size
  is always a multiple of the pod slot size, ranks are contiguous
  within a pod (the layout the hierarchical transport policies assume:
  pod-local ranks ride the fast links, cross-pod hops the slow tier),
  and every slot carries the two-level contract
  (``HVDT_NUM_PODS``/``HVDT_POD_SIZE``; the reference's ``(dcn, ici)``
  layout document, :func:`pod_layout`).
* :class:`PodTracker` — the driver-side failure correlator: exits of one
  pod's ranks within ``HVDT_POD_EXIT_WINDOW_S`` collapse into ONE
  pod-removal event (one blacklist entry, one cooldown clock),
  and preemption of any rank drains the whole pod; and the
  straggler-eviction rung over the per-pod step-time medians the driver
  aggregates from the workers' telemetry snapshots.
"""

from __future__ import annotations

import logging
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ...common import config
from ..hosts import HostInfo, SlotInfo, get_host_assignments

__all__ = ["Pod", "group_pods", "plan_assignments", "usable_slots",
           "pod_layout", "PodTracker"]

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Pod:
    """One pod: an ordered host group that joins/leaves as a unit."""
    name: str
    hosts: Tuple[HostInfo, ...]

    @property
    def slots(self) -> int:
        return sum(h.slots for h in self.hosts)


def group_pods(hosts: Sequence[HostInfo],
               pod_slots: int = 0) -> List[Pod]:
    """Group discovered hosts into pods, preserving discovery order.

    Precedence: a host's declared ``@pod`` column wins; with
    ``pod_slots`` > 0, undeclared hosts are chunked (in order) into pods
    of exactly that many slots (a partial trailing chunk forms an
    *incomplete* pod — selection skips it until the rest of the slice is
    discovered); otherwise each undeclared host is its own pod, keyed by
    hostname — the flat PR-4 behavior.
    """
    pods: Dict[str, List[HostInfo]] = {}
    order: List[str] = []
    chunk: List[HostInfo] = []
    chunk_slots = 0
    chunk_idx = 0

    def flush_chunk():
        nonlocal chunk, chunk_slots, chunk_idx
        if chunk:
            name = f"pod{chunk_idx}"
            chunk_idx += 1
            pods[name] = list(chunk)
            order.append(name)
            chunk, chunk_slots = [], 0

    for h in hosts:
        if h.pod:
            if h.pod not in pods:
                pods[h.pod] = []
                order.append(h.pod)
            pods[h.pod].append(h)
        elif pod_slots > 0:
            chunk.append(h)
            chunk_slots += h.slots
            if chunk_slots >= pod_slots:
                flush_chunk()
        else:
            name = h.hostname
            if name not in pods:
                pods[name] = []
                order.append(name)
            pods[name].append(h)
    flush_chunk()
    return [Pod(name, tuple(pods[name])) for name in order]


def _eligible(pods: List[Pod], pod_slots: int,
              exclude: Optional[set] = None) -> Tuple[List[Pod], int]:
    """Filter to same-size pods eligible for assignment.

    The uniform pod slot count is ``pod_slots`` when set, else the
    maximum observed (a pod never has MORE slots than the real slice, so
    a smaller group is a partially-discovered or degraded pod — skipped,
    with a log line, rather than allowed to break the world-size-
    multiple-of-pod-size invariant).  Heterogeneous per-host "pods"
    (nothing declared, no pod size) keep the flat legacy semantics via
    ``plan_assignments``'s fallback, not this path.
    """
    exclude = exclude or set()
    pods = [p for p in pods if p.name not in exclude]
    if not pods:
        return [], 0
    size = pod_slots if pod_slots > 0 else max(p.slots for p in pods)
    kept = [p for p in pods if p.slots == size]
    skipped = [p.name for p in pods if p.slots != size]
    if skipped:
        log.info("elastic: skipping incomplete pods %s (expected %d "
                 "slots each)", skipped, size)
    return kept, size


def usable_slots(hosts: Sequence[HostInfo], pod_slots: int = 0,
                 exclude: Optional[set] = None) -> int:
    """Slots available at pod granularity (whole same-size pods only) —
    what :meth:`ElasticDriver.wait_for_available_slots` should count so
    the wait doesn't end on a half-discovered pod."""
    pods = group_pods(hosts, pod_slots)
    if not _pods_declared(hosts, pod_slots):
        return sum(h.slots for h in hosts)
    kept, size = _eligible(pods, pod_slots, exclude)
    return len(kept) * size


def _pods_declared(hosts: Sequence[HostInfo], pod_slots: int) -> bool:
    return pod_slots > 0 or any(h.pod for h in hosts)


def plan_assignments(hosts: Sequence[HostInfo], min_np: int,
                     max_np: int = 0, pod_slots: int = 0,
                     exclude: Optional[set] = None) -> List[SlotInfo]:
    """Whole-pod slot assignment (the pod-granular
    ``get_host_assignments``).

    Selects the largest pod count whose total slots fit ``max_np``
    (never fewer than ``min_np`` rounded up to a pod multiple), assigns
    contiguous ranks pod-by-pod, and annotates every slot with the
    two-level contract.  Without declared pods (and no ``pod_slots``)
    this defers to the flat assignment and annotates each host as its
    own pod, so the driver's pod logic is uniform either way.
    """
    if not _pods_declared(hosts, pod_slots):
        flat = get_host_assignments(hosts, min_np, max_np)
        return _annotate_per_host(flat)
    pods = group_pods(hosts, pod_slots)
    kept, size = _eligible(pods, pod_slots, exclude)
    total = len(kept) * size
    if total < min_np:
        raise ValueError(
            f"requested {min_np} processes but only {total} slots "
            f"available in {len(kept)} complete pods "
            f"(pod size {size or '?'})")
    want_pods = max(1, min(len(kept), (max_np or min_np) // size))
    if want_pods * size < min_np:
        want_pods = -(-min_np // size)   # ceil to a pod multiple
    chosen = kept[:want_pods]
    flat = get_host_assignments(
        [h for p in chosen for h in p.hosts], want_pods * size)
    out: List[SlotInfo] = []
    for slot in flat:
        pi, pr = divmod(slot.rank, size)
        out.append(dataclasses.replace(
            slot, pod=chosen[pi].name, pod_index=pi, pod_rank=pr,
            num_pods=want_pods, pod_size=size))
    return out


def _annotate_per_host(slots: List[SlotInfo]) -> List[SlotInfo]:
    """Flat assignment with each host as its own pod (degenerate case:
    pod semantics == the PR-4 host semantics)."""
    return [dataclasses.replace(
        s, pod=s.hostname, pod_index=s.cross_rank, pod_rank=s.local_rank,
        num_pods=s.cross_size, pod_size=s.local_size) for s in slots]


def pod_layout(slots: Sequence[SlotInfo]) -> Dict[str, object]:
    """JSON-able two-level layout summary published to the rendezvous KV
    (``/rendezvous/<gen>/pods``) next to the flat spec: what a worker —
    or an operator scraping the KV — needs to build a two-level mesh
    (the reference's ``(dcn, ici)`` document, key for key)."""
    if not slots:
        return {"num_pods": 0, "pod_size": 0, "pods": []}
    pods: List[Dict[str, object]] = []
    for s in slots:
        if not pods or pods[-1]["name"] != s.pod:
            pods.append({"name": s.pod, "ranks": []})
        pods[-1]["ranks"].append(s.rank)
    return {"num_pods": slots[0].num_pods or len(pods),
            "pod_size": slots[0].pod_size or len(slots) // max(1, len(pods)),
            "mesh": {"dcn": slots[0].num_pods or len(pods),
                     "ici": slots[0].pod_size
                     or len(slots) // max(1, len(pods))},
            "pods": pods}


class PodTracker:
    """Driver-side pod state: exit correlation, preemption drains and
    straggler eviction."""

    def __init__(self,
                 exit_window_s: Optional[float] = None,
                 drain_grace_s: Optional[float] = None,
                 evict_windows: Optional[int] = None,
                 threshold: Optional[float] = None):
        self._exit_window_s = (
            exit_window_s if exit_window_s is not None
            else config.get_float("HVDT_POD_EXIT_WINDOW_S"))
        self._drain_grace_s = (
            drain_grace_s if drain_grace_s is not None
            else config.get_float("HVDT_POD_DRAIN_GRACE_S"))
        self.evict_windows = (
            evict_windows if evict_windows is not None
            else config.get_int("HVDT_POD_STRAGGLER_EVICT"))
        self.threshold = (
            threshold if threshold is not None
            else config.get_float("HVDT_STRAGGLER_THRESHOLD"))
        self._lock = threading.Lock()
        self._failure_events: Dict[str, float] = {}   # pod -> opened at
        self._drained: Dict[str, float] = {}          # pod -> drained at
        self._slow_windows: Dict[str, int] = {}       # pod -> consecutive
        self._last_fingerprint: Optional[tuple] = None
        self.removal_events = 0   # audit: collapsed pod-removal count

    # -- exit correlation ---------------------------------------------------

    def record_failure(self, pod: str, now: Optional[float] = None) -> bool:
        """Record one rank's failure exit for ``pod``.  Returns True when
        this OPENS a pod-removal event — the caller blacklists the pod
        exactly once; the pod's remaining ranks falling over inside the
        window are folded into the same event (no extra blacklist entry,
        no cooldown doubling for one correlated loss)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            opened = self._failure_events.get(pod)
            if opened is not None and now - opened < self._exit_window_s:
                return False
            self._failure_events[pod] = now
            self.removal_events += 1
            return True

    # -- preemption drains --------------------------------------------------

    def drain(self, pod: str, now: Optional[float] = None) -> bool:
        """Mark ``pod`` draining (a rank took the clean preemption exit:
        the platform is reclaiming the whole slice, so the next
        rendezvous must not re-place workers on its other hosts even if
        discovery still lists them).  Returns True the first time."""
        now = time.monotonic() if now is None else now
        with self._lock:
            fresh = pod not in self._drained
            self._drained[pod] = now
            return fresh

    def drained_pods(self, now: Optional[float] = None) -> set:
        """Pods currently excluded from assignment.  Drains expire after
        ``HVDT_POD_DRAIN_GRACE_S`` — if the platform never reclaims the
        hosts, the pod becomes placeable again rather than stranded."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._drained = {p: t for p, t in self._drained.items()
                             if now - t < self._drain_grace_s}
            return set(self._drained)

    # -- straggler eviction -------------------------------------------------

    def observe_step_medians(self, pod_medians: Dict[str, float]
                             ) -> List[str]:
        """Feed one window of per-pod median step times (driver-side,
        from the aggregated telemetry snapshots).  A pod whose median
        exceeds ``threshold`` x the cross-pod median for
        ``evict_windows`` consecutive windows is returned for eviction
        (at most once per streak).  Empty unless the rung is armed."""
        if self.evict_windows <= 0 or len(pod_medians) < 2:
            return []
        ordered = sorted(pod_medians.values())
        # Lower median, matching telemetry/straggler.py: with half the
        # pods slow the upper median can BE the straggler.
        baseline = ordered[(len(ordered) - 1) // 2]
        if baseline <= 0:
            return []
        evict: List[str] = []
        with self._lock:
            for pod, med in pod_medians.items():
                if med / baseline > self.threshold:
                    n = self._slow_windows.get(pod, 0) + 1
                    self._slow_windows[pod] = n
                    if n == self.evict_windows:
                        evict.append(pod)
                else:
                    self._slow_windows.pop(pod, None)
        return evict

    def snapshots_fingerprint(self, snaps: Dict[int, dict]) -> bool:
        """True when ``snaps`` carries NEW step data since the last call
        — the discovery loop ticks every second, but a straggler window
        should only be counted when workers actually published fresh
        step statistics."""
        fp = tuple(sorted((r, s.get("steps")) for r, s in snaps.items()))
        with self._lock:
            if fp == self._last_fingerprint:
                return False
            self._last_fingerprint = fp
            return True
