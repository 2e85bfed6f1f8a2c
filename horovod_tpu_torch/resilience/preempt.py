"""Preemption-safe shutdown: SIGTERM → emergency checkpoint → clean exit.

The port's copy of the JAX package's ``resilience/preempt.py``.

On preemptible machines preemption is the norm, not the exception:
they get a SIGTERM and a short grace window before the host
disappears.  Without a handler that window is wasted — the default action kills the process mid-step and the
job pays a full rollback to the last periodic commit.

:class:`PreemptionGuard` converts the signal into a *flag* (handlers must
stay trivial — Python runs them between bytecodes on the main thread, and
heavy work inside one deadlocks on locks the interrupted code holds).
The training loop polls ``check()`` at step/commit boundaries; on a
pending preemption it runs the registered emergency-checkpoint callback
and exits with :data:`PREEMPT_EXIT_CODE` — distinct from both failure
(non-zero) and the elastic restart code, so the elastic driver treats it
as a *clean host removal*: no blacklist, no failure count, just a
re-rendezvous without the departing host (``runner/elastic/driver.py
record_exit``).
"""

from __future__ import annotations

import logging
import os
import signal
import sys
import threading
from typing import Callable, Optional, Sequence


__all__ = ["PREEMPT_EXIT_CODE", "Preempted", "PreemptionGuard"]

log = logging.getLogger(__name__)

# Worker exit code meaning "preempted, state saved, do not blacklist me".
# Distinct from runner/elastic/driver.py RESTART_EXIT_CODE (79): a restart
# means "respawn me here", preemption means "this host is going away".
PREEMPT_EXIT_CODE = 83


class Preempted(SystemExit):
    """Raised by ``check(exit=False)`` so callers that need unwinding
    (context managers, finally blocks) can run before the process ends.
    Subclasses SystemExit: an uncaught Preempted still exits with the
    preemption code instead of a traceback."""

    def __init__(self) -> None:
        super().__init__(PREEMPT_EXIT_CODE)


class PreemptionGuard:
    """SIGTERM/SIGINT → emergency checkpoint at the next safe point.

    ::

        guard = PreemptionGuard(
            on_preempt=lambda: mgr.save(step, tree, force=True))
        with guard:
            for step in ...:
                train_step(...)
                guard.check(step=step)   # exits 83 after saving if signaled

    ``on_preempt`` runs in the *main flow* (not the signal handler), so it
    may safely touch the device, locks, and the filesystem.  The class-level
    ``emergency_checkpoints`` counter feeds bench/chaos audit output.
    """

    emergency_checkpoints = 0   # process-wide audit counter

    def __init__(self, on_preempt: Optional[Callable[[], None]] = None,
                 signals: Sequence[int] = (signal.SIGTERM, signal.SIGINT),
                 exit_code: int = PREEMPT_EXIT_CODE):
        self._on_preempt = on_preempt
        self._signals = tuple(signals)
        self._exit_code = exit_code
        self._triggered = threading.Event()
        self._prev_handlers: dict = {}
        self._installed = False
        self.signum: Optional[int] = None

    # -- lifecycle ---------------------------------------------------------

    def install(self) -> "PreemptionGuard":
        """Register handlers (main thread only — signal.signal enforces
        this).  Idempotent; previous handlers are restored by
        :meth:`uninstall`."""
        if self._installed:
            return self
        for sig in self._signals:
            self._prev_handlers[sig] = signal.signal(sig, self._handler)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):   # non-main thread / teardown
                pass
        self._prev_handlers.clear()
        self._installed = False

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # -- signal side (keep trivial) ---------------------------------------

    def _handler(self, signum, frame) -> None:
        self.signum = signum
        self._triggered.set()

    # -- main-flow side ----------------------------------------------------

    @property
    def triggered(self) -> bool:
        return self._triggered.is_set()

    def check(self, step: Optional[int] = None, exit: bool = True) -> bool:
        """Poll at a safe point.  Returns False when no signal is pending.
        Otherwise: run the emergency checkpoint, then ``sys.exit`` with
        the preemption code (or raise :class:`Preempted` when
        ``exit=False`` so the caller unwinds first)."""
        if not self._triggered.is_set():
            return False
        sig_name = (signal.Signals(self.signum).name
                    if self.signum is not None else "?")
        log.warning("preemption signal %s received — emergency checkpoint"
                    "%s", sig_name, f" at step {step}" if step is not None
                    else "")
        # Forensics first, inside the grace window: persist the
        # collective flight recorder before the host disappears (no-op
        # when the recorder is off; never raises).
        from ..telemetry.flight_recorder import dump_on_preempt

        dump_on_preempt()
        if self._on_preempt is not None:
            try:
                self._on_preempt()
                PreemptionGuard.emergency_checkpoints += 1
            except Exception as e:
                # A failed emergency save must not turn a clean preemption
                # exit into a crash-with-traceback: the periodic commit is
                # still on disk; log and take the clean exit anyway.
                log.error("emergency checkpoint failed: %r — exiting on "
                          "the last periodic commit", e)
        else:
            PreemptionGuard.emergency_checkpoints += 1
        if exit:
            # os._exit, not sys.exit: interpreter teardown would destroy
            # the process group, which can block on dying peers (an NCCL
            # communicator waits in its watchdog) for longer than a
            # preemption grace window.  The emergency checkpoint is on
            # disk; leave immediately.
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(self._exit_code)
            return True   # unreachable; keeps stubbed _exit tests sane
        raise Preempted()
