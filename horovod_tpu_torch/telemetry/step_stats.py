"""Step-level training statistics: step time, throughput, MFU, goodput.

The PyTorch counterpart of the JAX package's ``telemetry/step_stats.py``
(its own copy: that module imports JAX for :func:`tree_bytes`).  A
:class:`StepTimer` wraps the training loop (the bench, user loops) and
publishes:

* ``hvdt_step_time_seconds``  — host-fenced step duration summary
* ``hvdt_examples_per_sec``   — windowed throughput gauge
* ``hvdt_mfu``                — model-flops utilization gauge, from the
  caller's flops-per-step against the device's peak
  (:func:`peak_flops_for`)
* ``hvdt_steps_total``        — monotonic step counter

A :class:`GoodputLedger` charges wall-clock lost to recompiles, restores
and recovered faults against total elapsed time and publishes
``hvdt_goodput_fraction``.

The recovery-time budget rides on the ledger: :meth:`GoodputLedger.
charge_phase` books seconds against one of :data:`RECOVERY_PHASES`
(``hvdt_recovery_seconds{phase=...}``), and :func:`recovery_ledger` is
the process-wide instance the elastic loop, the checkpoint writer and
the loaders' ``seek`` charge (None with telemetry off).

:func:`bind_resilience_gauges` publishes the fault injector's and the
preemption guard's counters as live gauges, and
:func:`record_memory_accounting` feeds the per-rank memory gauges
(``hvdt_param_bytes`` / ``hvdt_optimizer_state_bytes``).  A StepTimer
also feeds an optional :class:`~.straggler.StragglerMonitor` and the
metric history (``HVDT_HISTORY``).

Not ported yet: the deviation tracker, ``PerfExpectation`` and the
expected-cost publisher, which price with the cost model (ROADMAP
Queue 1, item 8: control, analysis and the edges).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Optional

from .metrics import Gauge, MetricsRegistry, default_registry

__all__ = ["StepTimer", "GoodputLedger", "peak_flops_for", "tree_bytes",
           "PEAK_BY_DEVICE_KIND", "RECOVERY_PHASES", "recovery_ledger",
           "reset_recovery_ledger", "bind_resilience_gauges",
           "record_memory_accounting"]

# bf16 peak FLOP/s and memory byte/s by device (device-kind substring,
# lowercase).  The TPU rows are the JAX package's.  The one GPU row is
# the H100 SXM part's published dense peaks, matched on its full
# torch.cuda.get_device_name(); other H100 parts (PCIe, NVL) have other
# peaks and stay unknown, so their MFU is None rather than borrowed.
PEAK_BY_DEVICE_KIND = (
    ("nvidia h100 80gb hbm3", 989e12, 3.35e12),
    ("v6", 918e12, 1640e9), ("trillium", 918e12, 1640e9),
    ("v5p", 459e12, 2765e9),
    ("v5 lite", 197e12, 819e9), ("v5e", 197e12, 819e9),
    ("v5litepod", 197e12, 819e9),
    ("v4", 275e12, 1228e9), ("v3", 123e12, 900e9), ("v2", 46e12, 700e9),
)


def _positive_or_none(value) -> Optional[float]:
    """Finite positive float, else None — the 'is MFU publishable' test
    (0, NaN, inf, and unparsable values all mean 'unknown')."""
    try:
        v = float(value)
    except (TypeError, ValueError):
        return None
    return v if (v > 0 and v != float("inf")) else None


def peak_flops_for(device_kind: str):
    """(peak_flops, peak_memory_bw) for a device kind, or (None, None)
    when unknown (the CPU, other GPUs) — MFU is then unpublishable, not
    faked."""
    dk = (device_kind or "").lower()
    for sub, flops, bw in PEAK_BY_DEVICE_KIND:
        if sub in dk:
            return flops, bw
    return None, None


class StepTimer:
    """Times training steps and publishes throughput/MFU metrics.

    Usage::

        timer = StepTimer(examples_per_step=batch,
                          flops_per_step=flops,
                          device_kind=torch.cuda.get_device_name())
        for batch in loader:
            with timer.step():
                run_one_step(batch)   # must end with a host fence

    or call :meth:`observe` with externally measured durations (the
    bench times whole iterations and divides).  ``straggler`` optionally
    chains a :class:`~horovod_tpu_torch.telemetry.straggler.
    StragglerMonitor` so the cross-rank skew check rides the same
    observation stream.
    """

    def __init__(self, examples_per_step: int = 0,
                 flops_per_step: Optional[float] = None,
                 peak_flops: Optional[float] = None,
                 device_kind: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None,
                 ewma_alpha: float = 0.2,
                 straggler=None):
        reg = registry if registry is not None else default_registry()
        self.registry = reg
        self.examples_per_step = int(examples_per_step)
        # An unknown device peak, zero/absent caller flops or a
        # non-finite value make MFU unpublishable: the gauge is then
        # never registered (rather than rendering a misleading 0).
        self.flops_per_step = _positive_or_none(flops_per_step)
        if peak_flops is None and device_kind:
            peak_flops, _ = peak_flops_for(device_kind)
        self.peak_flops = _positive_or_none(peak_flops)
        self.straggler = straggler
        self._alpha = float(ewma_alpha)
        self._ewma: Optional[float] = None
        self._lock = threading.Lock()
        self._summary = reg.summary(
            "hvdt_step_time_seconds",
            "Host-observed training step duration")
        self._steps = reg.counter(
            "hvdt_steps_total", "Training steps observed by the StepTimer")
        self._examples = reg.gauge(
            "hvdt_examples_per_sec",
            "Windowed training throughput (examples/s, EWMA of step time)")
        self._mfu: Optional[Gauge] = None
        if self.flops_per_step is not None and self.peak_flops is not None:
            self._mfu = reg.gauge(
                "hvdt_mfu",
                "Model-flops utilization: flops_per_step / (step_time * "
                "peak_flops); only published when caller flops and the "
                "device peak are both known")

    def step(self):
        """Context manager timing one step."""
        return _StepScope(self)

    def observe(self, seconds: float) -> None:
        """Record one step's duration (externally timed)."""
        s = float(seconds)
        self._summary.observe(s)
        self._steps.inc()
        with self._lock:
            self._ewma = s if self._ewma is None else (
                self._alpha * s + (1.0 - self._alpha) * self._ewma)
            ewma = self._ewma
        if ewma > 0:
            if self.examples_per_step:
                self._examples.set(self.examples_per_step / ewma)
            if self._mfu is not None:
                self._mfu.set(
                    self.flops_per_step / (ewma * self.peak_flops))
        if self.straggler is not None:
            self.straggler.observe(s)
        # The history layer records the time-series sample (None when
        # off — one module lookup).
        from . import history as _history

        h = _history.get_history()
        if h is not None:
            h.observe_step(self._summary.count, s)

    @property
    def count(self) -> int:
        return self._summary.count

    def mean_step_seconds(self) -> Optional[float]:
        return self._summary.mean()

    def mfu(self) -> Optional[float]:
        if self._mfu is None:
            return None
        v = self._mfu.value()
        return v if v > 0 else None

    def snapshot(self) -> Dict[str, Optional[float]]:
        """The compact dict harnesses (the bench JSON) embed."""
        pct = self._summary.percentiles()
        return {
            "steps": self._summary.count,
            "step_time_p50_ms": (round(pct[0.5] * 1e3, 3)
                                 if pct[0.5] is not None else None),
            "step_time_p99_ms": (round(pct[0.99] * 1e3, 3)
                                 if pct[0.99] is not None else None),
            "examples_per_sec": (round(self._examples.value(), 2)
                                 if self._summary.count else None),
            "mfu": (round(self._mfu.value(), 4)
                    if self._mfu is not None and self._mfu.value() > 0
                    else None),
        }


class _StepScope:
    __slots__ = ("_timer", "_t0")

    def __init__(self, timer: StepTimer):
        self._timer = timer
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self._timer.observe(time.perf_counter() - self._t0)
        return False


# The recovery-time budget's phase vocabulary: every non-training
# second of a detect→restore→resume cycle is attributed to exactly one
# of these (the reference's names).
RECOVERY_PHASES = ("checkpoint_snapshot", "checkpoint_write", "rendezvous",
                   "compile", "restore", "replay")


class GoodputLedger:
    """Wall-clock accounting: where did the non-training time go?

    ``charge(reason, seconds)`` books lost time under a reason label
    (``recompile``, ``restore``, ``fault_recovery``, ...); the published
    ``hvdt_goodput_fraction`` gauge is ``(elapsed - lost) / elapsed``
    live-probed at scrape time, and
    ``hvdt_goodput_lost_seconds_total{reason=...}`` itemizes the bill.

    The recovery-time budget rides on top: :meth:`charge_phase` books
    seconds against one of :data:`RECOVERY_PHASES` and publishes them as
    ``hvdt_recovery_seconds{phase=...}``.  A phase marked ``overlapped``
    (the async checkpoint write, which runs under training) is attributed
    but not charged against goodput.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 clock=time.monotonic, already_elapsed: float = 0.0):
        """``already_elapsed`` backdates the ledger start — a harness
        that constructs the ledger after a compile it intends to charge
        must include that time in the elapsed denominator too, or the
        fraction double-penalizes."""
        reg = registry if registry is not None else default_registry()
        self.registry = reg
        self._clock = clock
        self._start = clock() - max(0.0, float(already_elapsed))
        self._lock = threading.Lock()
        self._lost: Dict[str, float] = {}
        self._phases: Dict[str, float] = {}
        self._lost_counter = reg.counter(
            "hvdt_goodput_lost_seconds_total",
            "Wall-clock seconds lost to non-training work, by reason")
        self._phase_counter = reg.counter(
            "hvdt_recovery_seconds",
            "Non-training wall-clock attributed to the recovery-time "
            "budget, by phase (checkpoint_snapshot | checkpoint_write | "
            "rendezvous | compile | restore | replay)")
        reg.gauge(
            "hvdt_goodput_fraction",
            "(elapsed - lost) / elapsed since ledger start"
        ).set_function(self.fraction)

    def charge(self, reason: str, seconds: float) -> None:
        s = max(0.0, float(seconds))
        with self._lock:
            self._lost[reason] = self._lost.get(reason, 0.0) + s
        self._lost_counter.inc(s, reason=str(reason))

    def charge_phase(self, phase: str, seconds: float,
                     overlapped: bool = False) -> None:
        """Attribute ``seconds`` to a recovery phase.  Unknown phases
        raise — a typo'd phase would silently fall out of the budget
        audit.  ``overlapped`` phases (background checkpoint writes)
        appear in ``hvdt_recovery_seconds`` but do NOT reduce the
        goodput fraction: training kept running under them."""
        if phase not in RECOVERY_PHASES:
            raise ValueError(
                f"unknown recovery phase {phase!r}; valid: "
                f"{', '.join(RECOVERY_PHASES)}")
        s = max(0.0, float(seconds))
        with self._lock:
            self._phases[phase] = self._phases.get(phase, 0.0) + s
        self._phase_counter.inc(s, phase=phase)
        if not overlapped:
            self.charge(phase, s)

    @contextlib.contextmanager
    def phase(self, name: str, overlapped: bool = False):
        """Context manager timing one recovery phase::

            with ledger.phase("restore"):
                state.restore()
        """
        t0 = self._clock()
        try:
            yield
        finally:
            self.charge_phase(name, self._clock() - t0,
                              overlapped=overlapped)

    def recovery_seconds(self, phase: Optional[str] = None) -> float:
        with self._lock:
            if phase is not None:
                return self._phases.get(phase, 0.0)
            return sum(self._phases.values())

    def recovery_snapshot(self) -> Dict[str, float]:
        """Per-phase totals (the bench JSON / scenario-test handle)."""
        with self._lock:
            return dict(self._phases)

    def lost_seconds(self, reason: Optional[str] = None) -> float:
        with self._lock:
            if reason is not None:
                return self._lost.get(reason, 0.0)
            return sum(self._lost.values())

    def elapsed_seconds(self) -> float:
        return max(0.0, self._clock() - self._start)

    def fraction(self) -> float:
        elapsed = self.elapsed_seconds()
        if elapsed <= 0:
            return 1.0
        return max(0.0, (elapsed - self.lost_seconds()) / elapsed)


# ---------------------------------------------------------------------------
# Process-wide recovery ledger (the instance elastic.py / checkpoint.py
# charge into; None when telemetry is off — the zero-overhead contract)
# ---------------------------------------------------------------------------

_recovery_lock = threading.Lock()
_recovery: Optional[GoodputLedger] = None


def recovery_ledger() -> Optional[GoodputLedger]:
    """The process-wide ledger recovery phases are charged into, created
    on first use — or None when telemetry is off (``HVDT_TELEMETRY``),
    so the steady-state cost at every charge site is one None-check."""
    from . import instrument

    if not instrument.enabled():
        return None
    global _recovery
    with _recovery_lock:
        if _recovery is None:
            _recovery = GoodputLedger()
        return _recovery


def reset_recovery_ledger() -> None:
    """Drop the process-wide recovery ledger (tests; pairs with
    ``metrics.reset_default_registry``, which orphans the old instance's
    metric objects)."""
    global _recovery
    with _recovery_lock:
        _recovery = None


def tree_bytes(tree) -> int:
    """Total array bytes of a nested structure (dicts, lists, tuples and
    an ``nn.Module``'s parameters and buffers; leaves with ``shape`` and
    ``dtype``, torch or numpy): host-side shape math, no device access."""
    import numpy as np
    import torch

    if isinstance(tree, torch.nn.Module):
        tree = [*tree.parameters(), *tree.buffers()]
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    shape = getattr(tree, "shape", None)
    dtype = getattr(tree, "dtype", None)
    if shape is None or dtype is None:
        return 0
    itemsize = (dtype.itemsize if isinstance(dtype, torch.dtype)
                else np.dtype(dtype).itemsize)
    return int(np.prod(tuple(shape) or (1,))) * int(itemsize)


def bind_resilience_gauges(registry: Optional[MetricsRegistry] = None
                           ) -> None:
    """Publish the resilience subsystem's ad-hoc counters as live gauges.

    Live probes (``set_function``) rather than shadow copies: the fault
    injector and preemption guard keep their own state; a scrape reads
    it at scrape time.  Safe to call repeatedly (gauges are
    get-or-create and rebinding the probe is idempotent)."""
    reg = registry if registry is not None else default_registry()

    def _injected() -> float:
        from ..resilience import faults

        inj = faults.get_injector()
        return float(inj.fired_total()) if inj is not None else 0.0

    def _emergency() -> float:
        from ..resilience.preempt import PreemptionGuard

        return float(PreemptionGuard.emergency_checkpoints)

    reg.gauge(
        "hvdt_injected_faults",
        "Faults the HVDT_FAULT_PLAN injector has fired in this process"
    ).set_function(_injected)
    reg.gauge(
        "hvdt_emergency_checkpoints",
        "Preemption-guard emergency checkpoints taken in this process"
    ).set_function(_emergency)


_MEMORY_GAUGE_DOCS = {
    "hvdt_param_bytes":
        "Per-rank parameter bytes (post-sharding: the replicated full "
        "tree, or 1/n of it under HVDT_ZERO=params)",
    "hvdt_optimizer_state_bytes":
        "Per-rank optimizer-state bytes (post-sharding: ~1/n of the "
        "replicated moments under HVDT_ZERO=states/params — the "
        "ZeRO memory win, observable from one scrape)",
}


def record_memory_accounting(param_bytes: Optional[float] = None,
                             optimizer_state_bytes: Optional[float] = None,
                             *, params=None, opt_state=None,
                             num_shards: int = 1,
                             zero_stage: str = "off",
                             registry: Optional[MetricsRegistry] = None
                             ) -> None:
    """Feed the per-rank memory-accounting gauges (``hvdt_param_bytes``,
    ``hvdt_optimizer_state_bytes``).

    Callers pass either precomputed byte counts or the live structures
    (``params=`` / ``opt_state=``, measured with :func:`tree_bytes` and
    divided by ``num_shards`` for sharded layouts).  No-op when the
    telemetry subsystem is off — the gauges themselves are registered
    (NaN) by ``hvd.init()``'s :func:`..telemetry.exporter.
    bind_process_gauges` so they always appear on /metrics."""
    from . import instrument

    if instrument.get_recorder() is None and registry is None:
        return
    reg = registry if registry is not None else default_registry()
    n = max(1, int(num_shards))
    if param_bytes is None and params is not None:
        param_bytes = tree_bytes(params)
        if zero_stage == "params":
            param_bytes //= n
    if optimizer_state_bytes is None and opt_state is not None:
        optimizer_state_bytes = tree_bytes(opt_state)
        if zero_stage in ("states", "params"):
            optimizer_state_bytes //= n
    if param_bytes is not None:
        reg.gauge("hvdt_param_bytes",
                  _MEMORY_GAUGE_DOCS["hvdt_param_bytes"]).set(
                      float(param_bytes))
    if optimizer_state_bytes is not None:
        reg.gauge("hvdt_optimizer_state_bytes",
                  _MEMORY_GAUGE_DOCS["hvdt_optimizer_state_bytes"]).set(
                      float(optimizer_state_bytes))
