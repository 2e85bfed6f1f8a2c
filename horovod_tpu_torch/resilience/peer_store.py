"""Peer-replicated in-memory snapshot tier (``HVDT_PEER_STORE``).

The port's copy of the JAX package's ``resilience/peer_store.py``: the
same wire format, keys, metrics and restore rules.  A payload holds host
copies (``elastic.py`` turns every tensor into a CPU copy before a
commit and puts a restored one back on the device it came from), never
CUDA tensors.

At pod scale the crash itself is cheap — the filesystem round trip to
restore is what eats the recovery budget.  This module adds the
in-memory redundancy tier: at every commit point each rank publishes its committed snapshot over the rendezvous
KV (the HMAC-authenticated control-plane path that already survives
worker death — it lives in the driver process) and mirrors peer
``(rank + 1) % n``'s newest snapshot in host RAM.  A single-rank or
single-pod loss then restores the lost state entirely over the KV/TCP
path — ``hvdt_peer_restore_total`` counts it — without touching the
filesystem; the manifest-verified ``CheckpointManager`` disk path
remains the fallback tier when the replica is gone or corrupt.

The ZeRO tie-in is what makes replication cheap: under
``HVDT_ZERO=states|params`` each rank's optimizer state is a 1/n row of
the ``[n, shard_len]`` flat stacks (ops/zero.py), so a peer copy is one
allgather slice, not a full-state clone —
:func:`~horovod_tpu.ops.zero.extract_shard_rows` /
``implant_shard_rows`` extract and re-implant exactly that row.

Wire format (KV value at ``/peer/<rank>``)::

    b"HVPS1" + len(header) as 4 big-endian bytes + header JSON + payload

where the header carries ``{step, sha256, rank}`` and the payload is a
pickle of the committed snapshot.  The SHA-256 is verified before
unpickling; a mismatch counts as a miss, never a crash.

Zero-overhead contract (faults/telemetry idiom): with ``HVDT_PEER_STORE``
unset, :func:`get_peer_store` returns ``None`` and every integration
point is a single None-check.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import threading
from typing import Any, Dict, Optional, Tuple

from ..common.logging_util import get_logger

__all__ = ["PeerStore", "get_peer_store", "reset"]

log = get_logger(__name__)

_MAGIC = b"HVPS1"


def _pack(rank: int, step: int, payload: bytes) -> bytes:
    header = json.dumps({
        "rank": int(rank), "step": int(step),
        "sha256": hashlib.sha256(payload).hexdigest(),
    }).encode()
    return _MAGIC + len(header).to_bytes(4, "big") + header + payload


def _unpack(blob: bytes) -> Optional[Tuple[Dict[str, Any], bytes]]:
    """(header, payload) of a packed replica, or None when the blob is
    torn or fails its SHA-256 — corruption is a miss, not a crash."""
    try:
        if not blob or not blob.startswith(_MAGIC):
            return None
        hlen = int.from_bytes(blob[5:9], "big")
        header = json.loads(blob[9:9 + hlen])
        payload = blob[9 + hlen:]
        if hashlib.sha256(payload).hexdigest() != header["sha256"]:
            return None
        return header, payload
    except (ValueError, KeyError, IndexError):
        return None


class PeerStore:
    """Commit-point snapshot replication over the rendezvous KV.

    ``kv`` is any object with the ``KVClient`` get/put surface.  Every
    :meth:`commit` pushes this rank's snapshot to ``/peer/<rank>`` and
    refreshes the RAM mirror of the watched peer ``(rank + 1) % size``;
    :meth:`restore` is the recovery side — a respawned rank pulls its
    own last published snapshot back before considering disk.
    """

    def __init__(self, kv, rank: int, size: int,
                 registry=None):
        from ..telemetry.metrics import default_registry

        self.kv = kv
        self.rank = int(rank)
        self.size = max(1, int(size))
        self._lock = threading.Lock()
        # rank -> raw packed blob, refreshed at each commit: the host-RAM
        # replica tier (served back to the KV by serve_replicas when the
        # control plane lost it).
        self._replicas: Dict[int, bytes] = {}
        reg = registry if registry is not None else default_registry()
        self._restores = reg.counter(
            "hvdt_peer_restore_total",
            "Recoveries served from the peer-replicated RAM tier "
            "(no filesystem touched)")
        self._commits = reg.counter(
            "hvdt_peer_commit_total",
            "Commit-point snapshot publications to the peer tier")
        self._misses = reg.counter(
            "hvdt_peer_miss_total",
            "Peer-tier restore attempts that fell back to disk "
            "(no replica, torn blob, or SHA-256 mismatch)")
        self._replica_bytes = reg.gauge(
            "hvdt_peer_replica_bytes",
            "Host-RAM bytes holding peer snapshot replicas")
        self._replica_bytes.set_function(self._ram_bytes)

    # -- topology ----------------------------------------------------------

    def watched_peer(self) -> int:
        """The peer whose snapshot THIS rank mirrors in RAM."""
        return (self.rank + 1) % self.size

    def _ram_bytes(self) -> float:
        with self._lock:
            return float(sum(len(b) for b in self._replicas.values()))

    @staticmethod
    def _key(rank: int) -> str:
        return f"/peer/{rank}"

    # -- commit side -------------------------------------------------------

    def commit(self, step: int, snapshot: Any) -> bool:
        """Publish this rank's committed ``snapshot`` (any picklable
        tree of host values — an elastic state's snapshot, a ZeRO
        shard-row payload)
        and refresh the watched peer's RAM replica.  KV failures are
        logged and swallowed: the peer tier is redundancy, and a flaky
        control network must not fail a commit that already persisted."""
        payload = pickle.dumps(snapshot, protocol=pickle.HIGHEST_PROTOCOL)
        blob = _pack(self.rank, step, payload)
        ok = True
        try:
            self.kv.put(self._key(self.rank), blob)
            self._commits.inc()
        except (ConnectionError, OSError) as e:
            log.warning("peer store: publish of step %s failed: %r", step, e)
            ok = False
        self.refresh_replica()
        return ok

    def refresh_replica(self) -> Optional[int]:
        """Pull the watched peer's newest snapshot into host RAM.
        Returns the replicated step, or None when nothing was fetched
        (solo world, missing key, or control-plane error)."""
        peer = self.watched_peer()
        if peer == self.rank:
            return None
        try:
            blob = self.kv.get(self._key(peer))
        except (ConnectionError, OSError):
            return None
        if blob is None:
            return None
        parsed = _unpack(blob)
        if parsed is None:
            return None
        with self._lock:
            self._replicas[peer] = blob
        return int(parsed[0]["step"])

    def serve_replicas(self) -> int:
        """Re-publish every RAM replica whose KV entry went missing (a
        restarted control plane) — the serving half of "peer RAM over
        the KV/TCP path".  Returns how many replicas were re-offered."""
        served = 0
        with self._lock:
            replicas = dict(self._replicas)
        for rank, blob in replicas.items():
            try:
                if self.kv.get(self._key(rank)) is None:
                    self.kv.put(self._key(rank), blob)
                    served += 1
            except (ConnectionError, OSError):
                continue
        return served

    # -- restore side ------------------------------------------------------

    def peek_step(self, rank: Optional[int] = None) -> Optional[int]:
        """Step of the newest replica published for ``rank`` (default:
        this rank), without unpickling the payload."""
        r = self.rank if rank is None else int(rank)
        try:
            blob = self.kv.get(self._key(r))
        except (ConnectionError, OSError):
            return None
        parsed = _unpack(blob) if blob is not None else None
        return int(parsed[0]["step"]) if parsed is not None else None

    def restore(self, rank: Optional[int] = None
                ) -> Optional[Tuple[Any, int]]:
        """(snapshot, step) of the newest verified replica for ``rank``
        (default: this rank), or None — the caller then falls back to
        the manifest-verified disk tier.  A served restore increments
        ``hvdt_peer_restore_total``; misses increment
        ``hvdt_peer_miss_total``."""
        r = self.rank if rank is None else int(rank)
        try:
            blob = self.kv.get(self._key(r))
        except (ConnectionError, OSError) as e:
            log.warning("peer store: restore probe failed: %r", e)
            blob = None
        parsed = _unpack(blob) if blob is not None else None
        if parsed is None:
            self._misses.inc()
            return None
        header, payload = parsed
        snapshot = pickle.loads(payload)
        self._restores.inc()
        log.info("peer store: restored rank %d from the RAM tier at "
                 "step %s (no filesystem touched)", r, header["step"])
        return snapshot, int(header["step"])

    def restore_count(self) -> int:
        return int(self._restores.total())

    # -- ZeRO shard-row convenience ---------------------------------------

    def commit_zero_shard(self, state, step: int,
                          shard_index: Optional[int] = None) -> bool:
        """Publish only this rank's ``[n, shard_len]`` row of a ZeRO
        state (ops/zero.py flat layout) — a one-allgather-slice
        replica."""
        from ..ops import zero as zero_mod

        s = self.rank if shard_index is None else int(shard_index)
        rows = zero_mod.extract_shard_rows(state, s)
        return self.commit(step, {"zero_shard": s, "rows": rows})

    def restore_zero_shard(self, state, shard_index: Optional[int] = None):
        """Re-implant this rank's replicated ZeRO row into ``state``;
        returns ``(state, step)`` with the row restored (on the stacks'
        devices), or None."""
        from ..ops import zero as zero_mod

        got = self.restore(shard_index if shard_index is not None
                           else self.rank)
        if got is None:
            return None
        snapshot, step = got
        if not isinstance(snapshot, dict) or "rows" not in snapshot:
            return None
        s = int(snapshot.get("zero_shard", self.rank))
        return zero_mod.implant_shard_rows(state, s, snapshot["rows"]), step


# ---------------------------------------------------------------------------
# Process-wide store (env-configured, cached on the env tuple)
# ---------------------------------------------------------------------------

_cached_env: Optional[tuple] = None
_cached_store: Optional[PeerStore] = None
_cache_lock = threading.Lock()


def _env_tuple() -> tuple:
    return (os.environ.get("HVDT_PEER_STORE"),
            os.environ.get("HVDT_RENDEZVOUS_ADDR"),
            os.environ.get("HVDT_RENDEZVOUS_PORT"),
            os.environ.get("HVDT_RANK"),
            os.environ.get("HVDT_SIZE"))


def get_peer_store() -> Optional[PeerStore]:
    """The env-configured peer store, or None when ``HVDT_PEER_STORE``
    is unset (or the rendezvous KV env is absent — there is no transport
    to replicate over).  Cached on the env tuple so elastic respawns and
    per-test monkeypatching rebuild it."""
    from ..common import config

    global _cached_env, _cached_store
    env = _env_tuple()
    with _cache_lock:
        if env == _cached_env:
            return _cached_store
        _cached_env = env
        _cached_store = None
        if config.get_bool("HVDT_PEER_STORE") and env[1]:
            try:
                from ..runner.http_kv import KVClient

                _cached_store = PeerStore(
                    KVClient.from_env(),
                    rank=int(os.environ.get("HVDT_RANK", "0") or 0),
                    size=int(os.environ.get("HVDT_SIZE", "1") or 1))
            except (KeyError, ValueError) as e:
                log.warning("peer store: HVDT_PEER_STORE set but the "
                            "rendezvous env is incomplete (%r); disabled", e)
        return _cached_store


def reset() -> None:
    """Drop the cached store (tests)."""
    global _cached_env, _cached_store
    with _cache_lock:
        _cached_env = None
        _cached_store = None
