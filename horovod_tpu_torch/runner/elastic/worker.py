"""Worker-side host-update notification.

The port's copy of the JAX package's ``runner/elastic/worker.py``
(Horovod's runner/elastic/worker.py WorkerNotificationService/Manager —
an RPC listener inside the worker).  Workers *poll* the rendezvous KV's
``/rendezvous/version`` key at commit points; a version newer than the
worker's generation means the driver re-keyed the cluster ⇒
``HostsUpdatedInterrupt`` (consumed by ``horovod_tpu_torch.elastic.run``).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

from ...common.exceptions import HostsUpdatedInterrupt
from ..http_kv import KVClient

__all__ = ["WorkerNotificationManager"]

log = logging.getLogger(__name__)

# Consecutive failed KV polls before the worker warns that it is flying
# blind on membership changes (each poll failure is individually benign —
# commit-point polling retries — but a long streak means rendezvous loss).
_POLL_FAIL_WARN_STREAK = 10


class WorkerNotificationManager:
    def __init__(self, client: Optional[KVClient] = None,
                 generation: Optional[int] = None):
        self._client = client
        self._generation = generation
        self._lock = threading.Lock()
        self._pending = False
        self._latest: Optional[int] = None
        self._last_pending: Optional[int] = None
        self._poll_failures = 0   # consecutive; reset on any success

    def init(self) -> None:
        if self._client is None and "HVDT_RENDEZVOUS_ADDR" in os.environ:
            self._client = KVClient.from_env()
        if self._generation is None:
            self._generation = int(os.environ.get("HVDT_GENERATION", 0))
        # Baseline the pending-updates counter: host changes that led to
        # OUR generation's rendezvous are already accounted for.  Prefer
        # the generation-scoped base the driver froze AT our rendezvous
        # (/rendezvous/<gen>/pending_base): baselining on the *current*
        # counter instead would swallow any membership change that lands
        # between our spawn and our first commit — e.g. a blacklisted
        # pod rejoining after cooldown while this generation is still
        # booting, which must trigger a scale-up, not be ignored.
        base = None
        if self._client is not None:
            try:
                raw = self._client.get(
                    f"/rendezvous/{self._generation}/pending_base")
            except (ConnectionError, OSError):
                raw = None
            if raw is not None:
                base = int(raw)
        self._last_pending = base if base is not None \
            else self._read_pending()

    def _read_pending(self) -> int:
        if self._client is None:
            return 0
        try:
            raw = self._client.get("/rendezvous/pending")
        except (ConnectionError, OSError):
            return 0
        return int(raw) if raw is not None else 0

    def poll(self) -> bool:
        """True when the driver published a newer generation OR a pending
        membership change (host added/removed since our rendezvous).

        A failed poll is individually benign (the next commit retries),
        but a long streak means the worker is blind to membership changes
        — warn once per streak so rendezvous loss is visible in logs."""
        if self._client is None:
            return False
        try:
            raw = self._client.get("/rendezvous/version")
        except (ConnectionError, OSError) as e:
            self._poll_failures += 1
            if self._poll_failures == _POLL_FAIL_WARN_STREAK:
                log.warning(
                    "elastic: %d consecutive rendezvous-KV poll failures "
                    "(last: %r) — membership changes are not being "
                    "observed", self._poll_failures, e)
            return False
        self._poll_failures = 0
        with self._lock:
            if raw is not None:
                version = int(raw)
                if version > (self._generation or 0):
                    self._latest = version
                    self._pending = True
            pending_now = self._read_pending()
            if pending_now > (self._last_pending or 0):
                self._last_pending = pending_now
                self._pending = True
            return self._pending

    def check_for_updates(self) -> None:
        """Raise HostsUpdatedInterrupt when a newer generation exists
        (called from State.commit — ref: common/elastic.py:73-97).

        Adopts the observed version as the new generation before raising,
        so after the re-rendezvous the next commits don't re-trigger on the
        same version (the env's HVDT_GENERATION is stale by then)."""
        if self.poll():
            with self._lock:
                self._pending = False
                if self._latest is not None:
                    self._generation = self._latest
            raise HostsUpdatedInterrupt()
