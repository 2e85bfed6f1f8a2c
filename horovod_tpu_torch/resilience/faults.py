"""Deterministic fault injection for chaos testing the elastic stack.

The port's own copy of the JAX package's ``resilience/faults.py``: the
same plan grammar, kinds, match keys, seeded RNG and fired-fault
journal, so one ``HVDT_FAULT_PLAN`` drives either package.  A *fault
plan* names what to break, where, and when; injection points threaded
through the production code paths (the elastic commit, the rendezvous
KV client, the checkpoint writer, the eager control plane's connect)
fire it without test-only forks of the code under test.

Plan grammar (``HVDT_FAULT_PLAN`` or programmatic)::

    crash@step=12:rank=1,hang@step=30:secs=20,corrupt_ckpt@step=40,kv_drop@p=0.1

i.e. comma-separated ``kind@key=value:key=value`` entries.  Kinds:

* ``crash``   — ``os._exit(code)`` (default 1): a hard worker death, the
  SIGKILL/preemption analog.  Match: ``step``/``rank``.
* ``hang``    — block the injection point for ``secs`` (default 30): a
  stuck worker, the stall-escalation trigger.
* ``exc``     — raise :class:`InjectedFault` (a ``HorovodInternalError``
  subclass, so the elastic retry loop takes its restore path).
* ``corrupt_ckpt`` — flip bytes in a just-written checkpoint (fires at
  the ``checkpoint.save`` point, which passes the step directory): the
  torn-write / disk-rot case the manifest verification must catch.
  ``mode=truncate_manifest`` instead truncates the step's integrity
  manifest mid-file — the torn-manifest case a host crash between the
  manifest write and its fsync leaves behind.
* ``kv_drop`` — raise ``ConnectionError`` from rendezvous-KV client ops
  with probability ``p``: a flaky control network.
* ``pod_crash``  — ``crash`` scoped to a pod: every rank whose
  ``HVDT_POD`` matches ``pod=`` dies, e.g.
  ``pod_crash@step=10:pod=podB`` — the correlated whole-slice loss that
  dominates multi-pod fleets (the elastic driver must collapse it into
  ONE pod-removal event).
* ``pod_partition`` — the pod drops off the network for ``secs``: its
  ranks block at the injection point, so peers see stalled heartbeats /
  collectives, e.g. ``pod_partition@step=10:pod=podB:secs=20``.
* ``slow_disk`` — sleep ``secs`` at the checkpoint writer's write/fsync
  seam (``checkpoint.write`` point), e.g. ``slow_disk@step=8:secs=5``:
  a degraded filesystem.  Under the synchronous save the step loop
  stalls for the full sleep; under ``HVDT_ASYNC_CKPT`` only the
  background writer does — the testable form of the non-blocking claim.
* ``serve_crash``, ``slow_replica``, ``traffic_spike`` — the serving
  plane's kinds.  They parse, with the reference's default points
  (``serve.predict``, ``serve.traffic``); firing one raises
  ``NotImplementedError``: the serving plane is not ported (ROADMAP
  Queue 1, item 7).

Match keys: ``step`` (fires once at the first point whose step >= it —
commits are periodic, so exact equality would silently never fire),
``rank`` (default: any; accepts sets and ranges — ``rank=1,3`` /
``rank=0-3`` / ``rank=1,4-6`` — so targeted multi-rank faults and pod
faults share one parser), ``pod`` (default: any; matched against the
firing rank's ``HVDT_POD``), ``point`` (override the kind's default
injection point), ``p`` (probability per hit, deterministic under
``HVDT_FAULT_SEED``), ``times`` (max fires; default 1 for step-matched
faults, unlimited for probabilistic ones), plus per-kind params
(``secs``, ``code``).

Injection points in production code::

    inj = faults.get_injector()
    if inj is not None:
        inj.fire("step", step=batch, rank=rank)

The unset-plan path is two dict-free loads and an ``is None`` branch —
and wrapping helpers return their argument **unchanged**
(``instrument(fn, ...) is fn``), so an idle harness adds zero wrappers
to hot paths (verified by test).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import random
import re
import time
from typing import Any, Callable, Dict, List, Optional

from ..common.exceptions import HorovodInternalError

__all__ = ["InjectedFault", "FaultSpec", "FaultInjector", "parse_plan",
           "parse_rank_set", "get_injector", "instrument", "configure"]

log = logging.getLogger(__name__)

KINDS = ("crash", "hang", "exc", "corrupt_ckpt", "kv_drop",
         "pod_crash", "pod_partition", "slow_disk",
         "serve_crash", "slow_replica", "traffic_spike")

# The serving plane's kinds: parsed, and raising when fired.
_SERVE_KINDS = ("serve_crash", "slow_replica", "traffic_spike")

# Default injection point per kind (spec may override with point=).
_DEFAULT_POINT = {
    "crash": "step",
    "hang": "step",
    "exc": "step",
    "corrupt_ckpt": "checkpoint.save",
    "kv_drop": "kv",
    "pod_crash": "step",
    "pod_partition": "step",
    "slow_disk": "checkpoint.write",
    "serve_crash": "serve.predict",
    "slow_replica": "serve.predict",
    "traffic_spike": "serve.traffic",
}


class InjectedFault(HorovodInternalError):
    """Raised by ``exc`` faults.  Subclasses ``HorovodInternalError`` so
    the elastic run() loop treats it exactly like a real collective
    failure (restore-from-commit), while tests can still catch the
    injected case specifically."""


def parse_rank_set(val: Any) -> frozenset:
    """``1`` / ``"1,3"`` / ``"0-3"`` / ``"1,4-6"`` → frozenset of ranks
    (shared by targeted multi-rank faults and tests)."""
    if isinstance(val, int):
        return frozenset((val,))
    if isinstance(val, (set, frozenset, list, tuple)):
        return frozenset(int(v) for v in val)
    out = set()
    for part in str(val).split(","):
        part = part.strip()
        if not part:
            continue
        lo, sep, hi = part.partition("-")
        try:
            if sep:
                lo_i, hi_i = int(lo), int(hi)
                if hi_i < lo_i:
                    raise ValueError
                out.update(range(lo_i, hi_i + 1))
            else:
                out.add(int(part))
        except ValueError:
            raise ValueError(
                f"bad rank set {val!r}: expected ranks like '1', '1,3' "
                f"or '0-3', got {part!r}") from None
    if not out:
        raise ValueError(f"bad rank set {val!r}: empty")
    return frozenset(out)


@dataclasses.dataclass
class FaultSpec:
    kind: str
    point: str
    step: Optional[int] = None
    rank: Any = None        # int | "1,3" | "0-3" | iterable; see ranks
    pod: Optional[str] = None
    p: Optional[float] = None
    secs: float = 30.0
    code: int = 1
    rps: float = 0.0        # traffic_spike: synthetic offered load
    mode: str = "payload"   # corrupt_ckpt: payload | truncate_manifest
    times: Optional[int] = None   # None = resolved default (see __post_init__)
    fired: int = 0

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; valid: {', '.join(KINDS)}")
        if self.mode not in ("payload", "truncate_manifest"):
            raise ValueError(
                f"unknown corrupt_ckpt mode {self.mode!r}; valid: "
                f"payload, truncate_manifest")
        self.ranks: Optional[frozenset] = (
            parse_rank_set(self.rank) if self.rank is not None else None)
        if self.ranks is not None and len(self.ranks) == 1:
            # Singleton sets stay a plain int on .rank — the pre-set-
            # grammar surface every existing caller reads.
            self.rank = next(iter(self.ranks))
        if self.times is None:
            self.times = 1 if self.p is None else None  # None = unlimited

    def matches(self, point: str, step: Optional[int],
                rank: Optional[int], rng: random.Random,
                pod: Optional[str] = None) -> bool:
        if self.times is not None and self.fired >= self.times:
            return False
        if point != self.point:
            return False
        if self.ranks is not None and rank not in self.ranks:
            return False
        if self.pod is not None and (pod is None
                                     or str(pod) != str(self.pod)):
            return False
        if self.step is not None and (step is None or step < self.step):
            return False
        if self.p is not None and rng.random() >= self.p:
            return False
        return True


def _split_entries(plan: str) -> List[str]:
    """Split the comma-separated plan into entries, keeping rank
    sets/ranges intact: a fragment that is purely digits/ranges (no
    ``@``, no ``=``) continues the previous entry's rank list —
    ``crash@step=12:rank=1,3-5,hang@step=30`` is two entries."""
    entries: List[str] = []
    for frag in plan.split(","):
        frag = frag.strip()
        if not frag:
            continue
        if entries and re.fullmatch(r"[\d]+(-[\d]+)?", frag):
            entries[-1] += f",{frag}"
        else:
            entries.append(frag)
    return entries


def parse_plan(plan: str) -> List[FaultSpec]:
    """Parse the comma-separated plan grammar into specs (see module
    docstring).  Raises ValueError on malformed entries — a silently
    dropped fault would void the chaos run's evidence."""
    specs: List[FaultSpec] = []
    for entry in _split_entries(plan):
        kind, _, rest = entry.partition("@")
        kind = kind.strip()
        kwargs: Dict[str, Any] = {}
        if rest:
            for pair in rest.split(":"):
                key, sep, val = pair.partition("=")
                if not sep:
                    raise ValueError(
                        f"fault plan entry {entry!r}: expected key=value, "
                        f"got {pair!r}")
                key = key.strip()
                val = val.strip()
                if key in ("step", "code", "times"):
                    kwargs[key] = int(val)
                elif key == "rank":
                    kwargs[key] = parse_rank_set(val)
                elif key in ("p", "secs", "rps"):
                    kwargs[key] = float(val)
                elif key in ("point", "pod", "mode"):
                    kwargs[key] = val
                else:
                    raise ValueError(
                        f"fault plan entry {entry!r}: unknown key {key!r}; "
                        f"valid: step, rank, pod, point, p, secs, code, "
                        f"mode, times, rps")
        point = kwargs.pop("point", None) or _DEFAULT_POINT.get(kind)
        if point is None:
            raise ValueError(f"fault plan entry {entry!r}: unknown fault "
                             f"kind {kind!r}; valid: {', '.join(KINDS)}")
        specs.append(FaultSpec(kind=kind, point=point, **kwargs))
    return specs


def _env_rank() -> Optional[int]:
    raw = os.environ.get("HVDT_RANK")
    try:
        return int(raw) if raw is not None else None
    except ValueError:
        return None


def _env_pod() -> Optional[str]:
    """The firing rank's pod id (launcher contract HVDT_POD; the
    discovery ``@pod`` column on the host side)."""
    return os.environ.get("HVDT_POD") or None


class FaultInjector:
    """Executes a fault plan at named injection points.

    Deterministic: probabilistic faults draw from a seeded RNG
    (``HVDT_FAULT_SEED``, default 0), and step-matched faults fire
    exactly ``times`` times.  ``counters`` records every fire by kind so
    harnesses (bench, chaos tests) can audit what actually happened.
    """

    def __init__(self, specs: List[FaultSpec], seed: int = 0,
                 journal_path: Optional[str] = None,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 exit_fn: Callable[[int], None] = os._exit):
        self.specs = specs
        self._rng = random.Random(seed)
        self._sleep = sleep_fn
        self._exit = exit_fn
        self.counters: Dict[str, int] = {}
        # Fired-fault journal: the elastic model is PROCESS RESTART, so a
        # respawned worker builds a fresh injector — without persisted
        # fire counts, a once-only crash@step=N would kill the worker
        # again at its first commit past N in every generation.  The
        # journal (one spec index per line, appended BEFORE the action so
        # a crash is recorded) reloads each spec's fired count, making
        # `times` a per-JOB bound.  Ranks must not share one file: the
        # launcher contract appends .rank<N>.
        self._journal_path = journal_path
        if journal_path:
            try:
                with open(journal_path) as f:
                    for line in f:
                        idx = int(line)
                        if 0 <= idx < len(specs):
                            specs[idx].fired += 1
            except (OSError, ValueError):
                pass

    @classmethod
    def from_env(cls) -> Optional["FaultInjector"]:
        plan = os.environ.get("HVDT_FAULT_PLAN", "")
        if not plan.strip():
            return None
        seed = int(os.environ.get("HVDT_FAULT_SEED", "0") or 0)
        journal = os.environ.get("HVDT_FAULT_JOURNAL", "") or None
        if journal:
            rank = _env_rank()
            if rank is not None:
                journal = f"{journal}.rank{rank}"
        return cls(parse_plan(plan), seed=seed, journal_path=journal)

    @property
    def active(self) -> bool:
        return bool(self.specs)

    def fired_total(self) -> int:
        return sum(self.counters.values())

    def fire(self, point: str, step: Optional[int] = None,
             rank: Optional[int] = None, pod: Optional[str] = None,
             **ctx: Any) -> None:
        """Run every armed spec matching this injection point.  ``ctx``
        carries point-specific payload (``path=`` for checkpoint
        corruption)."""
        if rank is None:
            rank = _env_rank()
        if pod is None:
            pod = _env_pod()
        for i, spec in enumerate(self.specs):
            if spec.matches(point, step, rank, self._rng, pod=pod):
                spec.fired += 1
                self.counters[spec.kind] = self.counters.get(spec.kind, 0) + 1
                self._journal(i)
                self._execute(spec, point, step, rank, ctx)

    def _journal(self, spec_index: int) -> None:
        if not self._journal_path:
            return
        try:
            with open(self._journal_path, "a") as f:
                f.write(f"{spec_index}\n")
                f.flush()
                os.fsync(f.fileno())
        except OSError:
            pass

    # -- fault actions -----------------------------------------------------

    def _execute(self, spec: FaultSpec, point: str, step: Optional[int],
                 rank: Optional[int], ctx: Dict[str, Any]) -> None:
        log.warning("FAULT INJECTION: %s at point=%s step=%s rank=%s",
                    spec.kind, point, step, rank)
        if spec.kind in _SERVE_KINDS:
            raise NotImplementedError(
                f"fault kind {spec.kind!r} fires in the serving plane, "
                "which is not ported yet (ROADMAP Queue 1, item 7: "
                "serving)")
        if spec.kind in ("crash", "pod_crash"):
            # os._exit, not sys.exit: a real crash runs no finalizers, no
            # atexit checkpointing, no graceful shutdown — that is the
            # point.  pod_crash is the same hard death, pod-scoped: each
            # rank of the matched pod dies at its own injection point,
            # producing the correlated whole-slice loss.
            self._exit(spec.code)
        elif spec.kind in ("hang", "pod_partition", "slow_disk"):
            # pod_partition: the matched pod's ranks block here — peers
            # outside the pod observe stalled heartbeats/collectives,
            # exactly what a network partition of the slice looks like.
            # slow_disk: same sleep, fired at the checkpoint writer's
            # write/fsync seam — whoever performs the write (the step
            # loop under sync saves, the background writer thread under
            # HVDT_ASYNC_CKPT) eats the stall.
            self._sleep(spec.secs)
        elif spec.kind == "exc":
            raise InjectedFault(
                f"injected fault at point={point} step={step} rank={rank}")
        elif spec.kind == "corrupt_ckpt":
            if spec.mode == "truncate_manifest":
                manifest = ctx.get("manifest")
                if manifest:
                    truncate_file(manifest)
            else:
                path = ctx.get("path")
                if path:
                    corrupt_checkpoint_dir(path)
        elif spec.kind == "kv_drop":
            raise ConnectionError(
                f"injected kv drop at point={point} (p={spec.p})")


def truncate_file(path: str, keep_fraction: float = 0.5) -> bool:
    """Truncate ``path`` mid-file (the torn-write a crash between write
    and fsync leaves) — shared by the ``corrupt_ckpt`` truncate-manifest
    mode and tests.  Returns True when the file was actually cut."""
    try:
        size = os.path.getsize(path)
        if size <= 1:
            return False
        with open(path, "r+b") as f:
            f.truncate(max(1, int(size * keep_fraction)))
    except OSError:
        return False
    log.warning("FAULT INJECTION: truncated %s to %d%% of %d bytes",
                path, int(keep_fraction * 100), size)
    return True


def corrupt_checkpoint_dir(path: str) -> Optional[str]:
    """Flip bytes in the largest regular file under ``path`` (the tensor
    payload, not metadata stubs) — returns the corrupted file, or None
    when nothing was writable.  Shared by the injector and tests."""
    victim, size = None, -1
    for root, _dirs, files in os.walk(path):
        for name in files:
            p = os.path.join(root, name)
            try:
                s = os.path.getsize(p)
            except OSError:
                continue
            if s > size:
                victim, size = p, s
    if victim is None or size <= 0:
        return None
    with open(victim, "r+b") as f:
        f.seek(max(0, size // 2))
        chunk = f.read(64) or b"\x00"
        f.seek(max(0, size // 2))
        f.write(bytes(b ^ 0xFF for b in chunk))
    log.warning("FAULT INJECTION: corrupted %d bytes of %s",
                len(chunk), victim)
    return victim


# ---------------------------------------------------------------------------
# Process-wide injector (env-configured, cached on the raw plan string)
# ---------------------------------------------------------------------------

_cached_plan: Optional[str] = None
_cached_injector: Optional[FaultInjector] = None


def get_injector() -> Optional[FaultInjector]:
    """The env-configured injector, or None when ``HVDT_FAULT_PLAN`` is
    unset/empty.  Cached on the raw env string so per-test monkeypatching
    rebuilds it, while the steady-state cost is one dict lookup and a
    string compare."""
    global _cached_plan, _cached_injector
    plan = os.environ.get("HVDT_FAULT_PLAN")
    if plan != _cached_plan:
        _cached_plan = plan
        # Explicit None-when-unset path (zero-overhead identity
        # contract): an empty plan never even parses.
        _cached_injector = (FaultInjector.from_env()
                            if plan and plan.strip() else None)
    return _cached_injector


def configure(plan: Optional[str], seed: int = 0) -> Optional[FaultInjector]:
    """Programmatic plan installation (tests, harnesses).  ``None``/empty
    disarms.  Returns the installed injector."""
    global _cached_plan, _cached_injector
    _cached_plan = plan
    _cached_injector = (FaultInjector(parse_plan(plan), seed=seed)
                        if plan and plan.strip() else None)
    return _cached_injector


def instrument(fn: Callable, point: str, step_from: Optional[str] = None):
    """Wrap ``fn`` so the injector fires at ``point`` before each call.

    The zero-overhead contract: with no plan configured this returns
    ``fn`` ITSELF (identity — no wrapper object, no indirection on the
    hot path).  ``step_from`` optionally names a kwarg of ``fn`` to
    forward as the fault step.
    """
    inj = get_injector()
    if inj is None:
        return fn

    def wrapped(*args: Any, **kwargs: Any):
        step = kwargs.get(step_from) if step_from else None
        inj.fire(point, step=step)
        return fn(*args, **kwargs)

    wrapped.__name__ = getattr(fn, "__name__", "instrumented")
    wrapped.__wrapped__ = fn
    return wrapped
