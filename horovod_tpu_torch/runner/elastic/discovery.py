"""Host discovery + blacklisting for elastic mode.

Re-conception of ref: runner/elastic/discovery.py:1-186 (HostManager,
HostDiscoveryScript, blacklisting).  The discovery source is a user
executable printing one "host[:slots]" line per available host (a
cloud API's instance list, a scheduler's allocation, or ``echo
localhost:4``).  The port's copy of the JAX package's module.
"""

from __future__ import annotations

import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional

from ...common import config
from ..hosts import HostInfo

__all__ = ["HostState", "HostManager", "DiscoveredHosts"]


class HostState:
    """Per-host blacklist state (ref: discovery.py HostState), with an
    optional cooldown (ref: the reference's cooldown_range blacklisting).

    ``HVDT_ELASTIC_BLACKLIST_COOLDOWN_S`` = 0 (default) keeps the
    permanent blacklist.  A positive cooldown makes a failed host
    *suspect* instead of dead: it re-enters discovery after the cooldown,
    which doubles per repeated failure (capped at 8x) so a genuinely bad
    host converges toward exclusion while a transient crash — the common
    case on preemptible fleets, and the only host of a small job — can
    rejoin."""

    def __init__(self, cooldown_s: Optional[float] = None) -> None:
        if cooldown_s is None:
            cooldown_s = config.get_float("HVDT_ELASTIC_BLACKLIST_COOLDOWN_S")
        self._cooldown_s = cooldown_s
        self._failures = 0
        self._until: Optional[float] = None   # None = not blacklisted
        self._lock = threading.Lock()

    def blacklist(self) -> None:
        with self._lock:
            self._failures += 1
            if self._cooldown_s <= 0:
                self._until = float("inf")
            else:
                backoff = min(2.0 ** (self._failures - 1), 8.0)
                self._until = time.monotonic() + self._cooldown_s * backoff

    @property
    def failures(self) -> int:
        with self._lock:
            return self._failures

    @property
    def is_blacklisted(self) -> bool:
        with self._lock:
            return self._until is not None and time.monotonic() < self._until


class DiscoveredHosts:
    """Immutable snapshot of discovery output minus blacklisted hosts."""

    def __init__(self, hosts: List[HostInfo]):
        self.hosts = hosts

    @property
    def available_slots(self) -> int:
        return sum(h.slots for h in self.hosts)

    def host_names(self) -> List[str]:
        return [h.hostname for h in self.hosts]

    def __eq__(self, other) -> bool:
        return isinstance(other, DiscoveredHosts) and \
            self.hosts == other.hosts

    def __repr__(self) -> str:
        return f"DiscoveredHosts({self.hosts})"


class HostManager:
    """Runs the discovery function, applies the blacklist, reports diffs
    (ref: discovery.py HostManager.update_available_hosts).

    Blacklisting is **pod-granular**: a pod (declared via the discovery
    script's ``@pod`` column, ``host[:slots][@pod]``) shares one
    :class:`HostState`, so one correlated pod loss costs one cooldown
    clock — N ranks of a dying slice must not double the cooldown N
    times.  Hosts with no declared pod key their state by hostname,
    which is exactly the PR-4 per-host behavior."""

    def __init__(self, discover: Callable[[], List[HostInfo]],
                 default_slots: int = 1):
        self._discover = discover
        self._default_slots = default_slots
        self._states: Dict[str, HostState] = {}   # keyed per pod
        self._pod_of: Dict[str, str] = {}         # hostname -> pod key
        self.current = DiscoveredHosts([])

    @classmethod
    def from_script(cls, script: str, default_slots: int = 1
                    ) -> "HostManager":
        def discover() -> List[HostInfo]:
            out = subprocess.run(
                script, shell=True, capture_output=True, text=True,
                timeout=60)
            if out.returncode != 0:
                raise RuntimeError(
                    f"discovery script failed ({out.returncode}): "
                    f"{out.stderr.strip()}")
            hosts = []
            for line in out.stdout.splitlines():
                line = line.strip()
                if line:
                    h = HostInfo.from_string(line)
                    if h.slots == 1 and ":" not in line:
                        h = HostInfo(h.hostname, default_slots, h.pod)
                    hosts.append(h)
            return hosts
        return cls(discover, default_slots)

    def pod_of(self, hostname: str) -> str:
        """The blacklist key for ``hostname``: its declared pod, or the
        hostname itself when no pod was declared."""
        return self._pod_of.get(hostname, hostname)

    def blacklist(self, hostname: str) -> None:
        self.blacklist_pod(self.pod_of(hostname))

    def blacklist_pod(self, pod: str) -> None:
        self._states.setdefault(pod, HostState()).blacklist()

    def is_blacklisted(self, hostname: str) -> bool:
        return self.is_pod_blacklisted(self.pod_of(hostname))

    def is_pod_blacklisted(self, pod: str) -> bool:
        st = self._states.get(pod)
        return st is not None and st.is_blacklisted

    def pod_failures(self, pod: str) -> int:
        """Blacklist entries recorded against ``pod`` — the audit the
        pod-removal correlation is judged by (one correlated pod loss
        must cost exactly one entry)."""
        st = self._states.get(pod)
        return st.failures if st is not None else 0

    def update_available_hosts(self) -> bool:
        """Re-run discovery; returns True if the usable host set changed."""
        raw = self._discover()
        for h in raw:
            if h.pod:
                self._pod_of[h.hostname] = h.pod
        usable = [h for h in raw if not self.is_blacklisted(h.hostname)]
        snapshot = DiscoveredHosts(usable)
        changed = snapshot != self.current
        self.current = snapshot
        return changed
