"""Resilience: deterministic fault injection, shared retry/backoff,
preemption-safe shutdown and stall escalation (the JAX package's
``resilience/`` for the port).

* :mod:`.faults` — declarative fault plans (``HVDT_FAULT_PLAN``) fired
  at injection points in the elastic loop, the rendezvous KV, the
  checkpoint writer and the eager control plane; a strict no-op when
  unset.
* :mod:`.retry` — the one exponential-backoff-with-jitter primitive.
* :mod:`.preempt` — SIGTERM/SIGINT → emergency checkpoint → exit code
  83, which the elastic driver treats as host removal, not failure.
* :mod:`.escalation` — the stall ladder (warn → abort → elastic reset).

The peer-replicated RAM tier (``peer_store.py``, ``HVDT_PEER_STORE``)
is not ported yet (ROADMAP Queue 1, item 6, part 2): setting the knob
makes :func:`get_peer_store` raise.
"""

from .escalation import (ABORT, RESET, WARN, EscalationPolicy, Escalator,
                         request_elastic_reset)
from .faults import (FaultInjector, FaultSpec, InjectedFault, configure,
                     get_injector, instrument, parse_plan)
from .preempt import PREEMPT_EXIT_CODE, Preempted, PreemptionGuard
from .retry import Backoff, RetriesExhausted, retry

__all__ = [
    "FaultInjector", "FaultSpec", "InjectedFault", "parse_plan",
    "get_injector", "configure", "instrument",
    "Backoff", "retry", "RetriesExhausted",
    "PreemptionGuard", "Preempted", "PREEMPT_EXIT_CODE",
    "Escalator", "EscalationPolicy", "WARN", "ABORT", "RESET",
    "request_elastic_reset", "get_peer_store",
]


def get_peer_store():
    """None while ``HVDT_PEER_STORE`` is off, as in the reference; the
    peer store itself is not ported, so turning the knob on raises."""
    from ..common import config

    if not config.get_bool("HVDT_PEER_STORE"):
        return None
    raise NotImplementedError(
        "HVDT_PEER_STORE: the peer-replicated snapshot tier is not ported "
        "yet (ROADMAP Queue 1, item 6, part 2: peer store)")
