"""Hot checkpoint reload: watch a ``CheckpointManager`` directory, swap
weights into a live engine between batches.

The port's copy of the JAX package's ``serve/reload.py``.  The steps it
reloads are the port's own (``step_NNN/checkpoint.pt`` written by
:class:`~horovod_tpu_torch.checkpoint.CheckpointManager`); it does not
read the JAX package's checkpoints.

A production endpoint cannot restart to pick up a new model — a restart
drops every in-flight request and repays every graph capture.  The watcher
closes the training→serving loop instead: training keeps writing
``step_NNN`` checkpoints with :class:`~horovod_tpu_torch.checkpoint.
CheckpointManager`; the serving process polls the same directory
(``CheckpointManager.latest_step()`` discovery), restores any newer step
with ``broadcast=False`` (a serving replica is its own process — no
training collective to ride), and hands the tree to
``InferenceEngine.swap_params``.  The swap copies the new weights into
the served parameters in place once the batches in flight have
finished: they finish on the old weights, the next batch sees the new
ones, and because the captured graphs read the same storage a reload
triggers **zero** recaptures.

Failure policy: a half-written or corrupt checkpoint must never kill the
serving loop.  Restore errors are logged, counted
(``serve_reload_failures_total``), and retried; consecutive failures
back the poll off exponentially (capped) instead of hammering a broken
directory at ``poll_interval_s``, and the ``serve_last_good_step`` gauge
exposes the training side's LAST_GOOD pointer so operators can see the
newest checkpoint that *fully* saved next to the failure counter.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional, Union

from ..checkpoint import CheckpointManager, restore_checkpoint
from ..common import config
from ..common.logging_util import get_logger
from ..resilience import faults
from ..resilience.retry import Backoff
from .metrics import MetricsRegistry

__all__ = ["CheckpointWatcher"]

log = get_logger(__name__)


class CheckpointWatcher:
    """Poll a checkpoint directory; hot-swap newer steps into the engine.

    ``directory`` may be a path or an existing
    :class:`~horovod_tpu_torch.checkpoint.CheckpointManager`.  ``template``
    supplies the restore tree structure (by default the engine's
    ``params_template()``: its served tensors by name, as a
    ``state_dict``).  ``on_reload(tree, step)`` — by default the
    engine's ``swap_params`` — may be any callable, so the watcher also
    drives non-engine consumers (e.g. an eval worker).
    """

    def __init__(self, directory: Union[str, CheckpointManager],
                 engine: Optional[Any] = None, template: Any = None, *,
                 poll_interval_s: Optional[float] = None,
                 on_reload: Optional[Callable[[Any, int], None]] = None,
                 metrics: Optional[MetricsRegistry] = None):
        if isinstance(directory, CheckpointManager):
            self.manager = directory
        else:
            self.manager = CheckpointManager(directory)
        if on_reload is None:
            if engine is None:
                raise ValueError("need an engine or an on_reload callback")
            on_reload = lambda tree, step: engine.swap_params(tree)  # noqa: E731
        self._on_reload = on_reload
        if template is None and engine is not None:
            template = engine.params_template()
        self._template = template
        self.poll_interval_s = float(
            poll_interval_s if poll_interval_s is not None
            else config.get_float("HVDT_SERVE_RELOAD_INTERVAL_S"))
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._reloads = self.metrics.counter(
            "serve_reloads_total", "Successful hot weight reloads")
        self._failures = self.metrics.counter(
            "serve_reload_failures_total",
            "Reload attempts that failed (serving continues on the "
            "previous weights)")
        self._skipped_unverified = self.metrics.counter(
            "serve_skipped_unverified_total",
            "Steps skipped because their integrity manifest failed "
            "verification (fell back to the previous good step without "
            "charging the reload-failure backoff)")
        self._step_gauge = self.metrics.gauge(
            "serve_checkpoint_step", "Step of the currently served weights")
        last_good = self.metrics.gauge(
            "serve_last_good_step",
            "Training-side LAST_GOOD pointer: newest step whose save "
            "fully completed (manifest + pointer); -1 when none")
        last_good.set_function(self._last_good_value)
        self.current_step: Optional[int] = None
        self._fail_streak = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _last_good_value(self) -> float:
        try:
            step = self.manager.last_good_step()
        except OSError:
            step = None
        return float(step) if step is not None else -1.0

    def check_once(self) -> Optional[int]:
        """One poll: reload if a newer *verified* step exists.  Returns
        the step loaded, or None when already current / nothing to load
        / the restore failed (failure is counted and logged, never
        raised — the polling loop and the serving path share this
        method).

        A step whose integrity manifest fails verification is SKIPPED —
        counted in ``serve_skipped_unverified_total`` and logged, but
        not charged against the reload-failure backoff: a corrupt
        newest step means "fall back to the previous good step now",
        not "probe the directory ever more slowly"."""
        try:
            candidates = self.manager.all_steps()
        except OSError as e:
            log.warning("serve reload: cannot list %s: %r",
                        self.manager.directory, e)
            return None
        latest = None
        for cand in reversed(candidates):
            if self.current_step is not None and cand <= self.current_step:
                break
            if self.manager.verify_step(cand):
                latest = cand
                break
            self._skipped_unverified.inc()
            log.warning("serve reload: step %d failed manifest "
                        "verification; falling back to an older step",
                        cand)
        if latest is None:
            return None
        path = self.manager.step_path(latest)
        try:
            inj = faults.get_injector()
            if inj is not None:
                inj.fire("serve.reload", step=latest, path=path)
            tree, step = restore_checkpoint(path, self._template,
                                            broadcast=False)
            self._on_reload(tree, latest)
        except Exception as e:
            self._failures.inc()
            self._fail_streak += 1
            log.warning("serve reload of %s failed (still serving step "
                        "%s): %r", path, self.current_step, e)
            return None
        self.current_step = latest
        self._fail_streak = 0
        self._step_gauge.set(latest)
        self._reloads.inc()
        log.info("serve: hot-reloaded weights from step %d", latest)
        return latest

    def _loop(self) -> None:
        # Healthy polling runs at poll_interval_s; consecutive reload
        # failures back off exponentially (capped at 16x) so a broken
        # checkpoint writer is probed, not hammered.  Any success (or a
        # quiet no-op poll) snaps back to the base interval.
        backoff: Optional[Backoff] = None
        while True:
            if self._fail_streak:
                if backoff is None:
                    backoff = Backoff(first=self.poll_interval_s,
                                      cap=self.poll_interval_s * 16,
                                      jitter=0.25)
                delay = backoff.next_delay()
            else:
                backoff = None
                delay = self.poll_interval_s
            if self._stop.wait(delay):
                return
            self.check_once()

    def start(self, load_initial: bool = False) -> "CheckpointWatcher":
        """Start the polling thread (idempotent).  ``load_initial`` does a
        synchronous first check before the thread spins up, so callers can
        fail fast when the directory holds nothing loadable."""
        if load_initial:
            self.check_once()
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="hvdt-serve-reload", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
