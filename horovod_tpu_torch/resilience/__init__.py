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
* :mod:`.peer_store` — the peer-replicated RAM snapshot tier
  (``HVDT_PEER_STORE``): commit-point snapshots over the rendezvous KV,
  restored before the disk tier is consulted.
"""

from .escalation import (ABORT, RESET, WARN, EscalationPolicy, Escalator,
                         request_elastic_reset)
from .faults import (FaultInjector, FaultSpec, InjectedFault, configure,
                     get_injector, instrument, parse_plan)
from .peer_store import PeerStore, get_peer_store
from .preempt import PREEMPT_EXIT_CODE, Preempted, PreemptionGuard
from .retry import Backoff, RetriesExhausted, retry

__all__ = [
    "FaultInjector", "FaultSpec", "InjectedFault", "parse_plan",
    "get_injector", "configure", "instrument",
    "Backoff", "retry", "RetriesExhausted",
    "PreemptionGuard", "Preempted", "PREEMPT_EXIT_CODE",
    "Escalator", "EscalationPolicy", "WARN", "ABORT", "RESET",
    "request_elastic_reset", "PeerStore", "get_peer_store",
]

