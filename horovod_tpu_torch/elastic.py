"""Elastic training: State snapshot/commit/restore and the run() retry loop.

The port's counterpart of the JAX package's ``elastic.py`` (Horovod's
common/elastic.py: State, ObjectState, the run_fn retry loop
:151-175).  The contract (Horovod's docs/elastic.rst)::

    state = hvd.elastic.TensorState(params=params, batch=0)

    @hvd.elastic.run
    def train(state):
        while state.batch < N:
            step(state.params, ...)
            state.batch += 1
            if state.batch % 100 == 0:
                state.commit()

* ``HorovodInternalError`` (a collective died — a peer was lost), or a
  ``torch.distributed.DistError`` (an NCCL / gloo failure or a store
  timeout, bounded by the process group's timeout,
  ``HVDT_CONTROL_PLANE_TIMEOUT_S``): restore from the last commit,
  re-initialize, continue.
* ``HostsUpdatedInterrupt`` (the driver announced a membership change at
  a commit point): keep the current state, re-initialize, continue.

Under ``hvdtrun --elastic`` (``HVDT_ELASTIC`` with a rendezvous address)
re-rendezvous is a process restart: the worker persists its commit and
exits with :data:`RESTART_EXIT_CODE` (79); the driver respawns every
slot, and a state built with ``path=`` resumes from the persisted
commit.  A peer that died inside an NCCL collective leaves the survivors
blocked where no Python handler runs, so the driver terminates them
(SIGTERM, then SIGKILL) and the new generation resumes from the last
*persisted* commit, never from an emergency save that may not have
happened.

A step captured in a CUDA graph (``step_pipeline.donated_step``) reads
the storages it was captured with: :class:`TensorState` restores into
the live tensors in place (``copy_``), and a model restored through
``load_state_dict`` keeps its parameter storages too.  An optimizer
whose state tensors are replaced by ``load_state_dict`` must be captured
again after a restore (a new ``donated_step``), as after an LR change.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import logging
import os
import sys
from typing import Any, Callable, Dict, List, Optional

import torch

from .common.basics import is_initialized
from .common.exceptions import HorovodInternalError, HostsUpdatedInterrupt
from .resilience import faults

log = logging.getLogger(__name__)

__all__ = ["State", "ObjectState", "TensorState", "run", "RESTART_EXIT_CODE"]

# Worker exit code meaning "ready for the next rendezvous" (the
# reference's runner/elastic/driver.py RESTART_EXIT_CODE).
RESTART_EXIT_CODE = 79


class State:
    """Base elastic state (ref: common/elastic.py:26 State).

    Subclasses implement save/restore/sync of their payload; this class
    carries the reset-callback machinery and host-update polling.
    """

    def __init__(self) -> None:
        self._reset_callbacks: List[Callable[[], None]] = []
        self._notification_manager = None

    def register_reset_callbacks(self, callbacks) -> None:
        self._reset_callbacks.extend(callbacks)

    def on_reset(self) -> None:
        self._host_messages_pending = False
        self.reset()
        for cb in self._reset_callbacks:
            cb()

    def on_hosts_updated(self) -> None:
        pass

    def commit(self) -> None:
        """Snapshot + check for pending host updates
        (ref: common/elastic.py:60-71 commit/check_host_updates)."""
        self.save()
        self._resilience_check()
        self.check_host_updates()

    def _resilience_check(self) -> None:
        """Commit-point hook for the resilience machinery: fire the
        ``step`` fault-injection point and poll the preemption guard
        (SIGTERM since the last commit → emergency persist + clean exit).
        Both are None-checks when idle."""
        step = getattr(self, "batch", None)
        if not isinstance(step, int):
            step = None
        inj = faults.get_injector()
        if inj is not None:
            inj.fire("step", step=step)
        guard = getattr(self, "_preempt_guard", None)
        if guard is not None:
            guard.check(step=step)

    def check_host_updates(self) -> None:
        if self._notification_manager is None:
            from .runner.elastic.worker import WorkerNotificationManager

            self._notification_manager = WorkerNotificationManager()
            self._notification_manager.init()
        self._notification_manager.check_for_updates()

    # -- subclass payload hooks -------------------------------------------

    def save(self) -> None:
        raise NotImplementedError

    def restore(self) -> None:
        raise NotImplementedError

    def sync(self) -> None:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class ObjectState(State):
    """Elastic state of arbitrary picklable attributes
    (ref: common/elastic.py:101 ObjectState)."""

    def __init__(self, **kwargs: Any):
        super().__init__()
        self._saved: Dict[str, Any] = {}
        for k, v in kwargs.items():
            setattr(self, k, v)
        self.save()

    def _payload_keys(self) -> List[str]:
        return [k for k in self.__dict__
                if not k.startswith("_")]

    def save(self) -> None:
        self._saved = {k: copy.deepcopy(getattr(self, k))
                       for k in self._payload_keys()}

    def restore(self) -> None:
        for k, v in self._saved.items():
            setattr(self, k, copy.deepcopy(v))

    def sync(self) -> None:
        """Broadcast payload from rank 0 so joining workers align
        (ref: ObjectState.sync → broadcast_object)."""
        if not is_initialized():
            return
        from .functions import broadcast_object

        payload = {k: getattr(self, k) for k in self._payload_keys()}
        payload = broadcast_object(payload, root_rank=0)
        for k, v in payload.items():
            setattr(self, k, v)
        self.save()


class _HostCopy:
    """A tensor of a peer-tier payload: its CPU copy and the device it
    came from (a payload carries host copies, never CUDA tensors)."""

    __slots__ = ("tensor", "device")

    def __init__(self, tensor: torch.Tensor, device: str):
        self.tensor, self.device = tensor, device


def _to_host(obj: Any) -> Any:
    """``obj`` with every tensor (in dicts, lists, tuples) replaced by a
    :class:`_HostCopy`."""
    if isinstance(obj, torch.Tensor):
        return _HostCopy(obj.detach().to("cpu", copy=True), str(obj.device))
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _from_host(obj: Any) -> Any:
    """Inverse of :func:`_to_host`: each tensor back on its device."""
    if isinstance(obj, _HostCopy):
        return obj.tensor.to(obj.device)
    if isinstance(obj, dict):
        return {k: _from_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_host(v) for v in obj)
    return obj


class _Persistent:
    """Commit tiers for a state: ``persist()`` writes the committed
    snapshot to ``path`` atomically (a temporary file, then a rename);
    with ``HVDT_PEER_STORE`` set every commit also publishes it to the
    peer-replicated RAM tier (``resilience/peer_store.py``) as host
    copies; and ``_resume()`` at construction restores a freshly spawned
    worker from whichever tier holds the newer commit — ties go to the
    peer tier, so a healthy recovery never uses the disk copy.  Used by
    :class:`TensorState` and ``interop.torch_elastic.TorchState``; the
    snapshot format is the subclass's (``_persisted`` /
    ``_load_persisted``), and the step a commit is filed under is the
    state's ``batch`` attribute (0 without one)."""

    _state_path: Optional[str] = None
    restored_from: Optional[str] = None

    def _persisted(self) -> Any:
        return self._saved

    def _load_persisted(self, saved: Any) -> None:
        self._saved = saved

    def _commit_step(self) -> int:
        step = getattr(self, "batch", None)
        return step if isinstance(step, int) else 0

    @staticmethod
    def _saved_step(saved: Any) -> Optional[int]:
        """The ``batch`` a persisted snapshot was committed at, or None."""
        if not isinstance(saved, dict):
            return None
        inner = saved.get("saved", saved.get("objects", saved))
        step = inner.get("batch") if isinstance(inner, dict) else None
        return step if isinstance(step, int) else None

    def persist(self) -> None:
        """Write the committed snapshot to ``path`` (atomic rename)."""
        if not self._state_path:
            return
        tmp = f"{self._state_path}.tmp.{os.getpid()}"
        torch.save(self._persisted(), tmp)
        os.replace(tmp, self._state_path)

    def _resume(self) -> None:
        """Boot-time restore: the newest of {peer RAM tier, disk commit},
        charged to the recovery ledger's ``restore`` phase."""
        import time

        from .resilience import get_peer_store
        from .telemetry import step_stats

        t0 = time.perf_counter()
        disk_saved = None
        if self._state_path and os.path.exists(self._state_path):
            # This program's own file (persist above): weights_only=False
            # admits the arbitrary picklable attributes a state carries.
            disk_saved = torch.load(self._state_path, weights_only=False)
        ps = get_peer_store()
        peer = ps.restore() if ps is not None else None
        if peer is not None:
            peer_saved, peer_step = peer
            disk_step = self._saved_step(disk_saved)
            if disk_step is None or peer_step >= disk_step:
                self._load_persisted(_from_host(peer_saved))
                self.restore()
                self.restored_from = "peer"
                log.info("elastic state resumed from the peer RAM tier "
                         "at step %s", peer_step)
                disk_saved = None
        if disk_saved is not None:
            self._load_persisted(disk_saved)
            self.restore()
            self.restored_from = "disk"
            log.info("elastic state resumed from %s", self._state_path)
        ledger = step_stats.recovery_ledger()
        if ledger is not None and self.restored_from is not None:
            ledger.charge_phase("restore", time.perf_counter() - t0)

    def commit(self) -> None:
        self.save()
        self.persist()
        # The peer tier rides the same commit point: publish this
        # commit's snapshot (host copies) over the rendezvous KV and
        # refresh the watched peer's RAM replica (one None-check when
        # HVDT_PEER_STORE is unset).
        from .resilience import get_peer_store

        ps = get_peer_store()
        if ps is not None:
            ps.commit(self._commit_step(), _to_host(self._persisted()))
        # After persist: an injected crash or a preemption exit at the
        # commit point leaves this commit restorable on disk.
        self._resilience_check()
        self.check_host_updates()


def _is_tensor_tree(v: Any) -> bool:
    """A tensor, or a non-empty dict / list / tuple whose leaves are all
    tensors."""
    if isinstance(v, torch.Tensor):
        return True
    if isinstance(v, dict):
        return bool(v) and all(_is_tensor_tree(x) for x in v.values())
    if isinstance(v, (list, tuple)):
        return bool(v) and all(_is_tensor_tree(x) for x in v)
    return False


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return type(tree)(_tree_map(fn, x) for x in tree)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [leaf for v in vals for leaf in _leaves(v)]


class TensorState(_Persistent, ObjectState):
    """Elastic state whose tensor-valued attributes are trees of tensors
    (a tensor, or dicts / lists / tuples of them) — the port's
    counterpart of the JAX package's ``JaxState`` (ref:
    torch/elastic/state.py TorchState's handlers, for plain tensor
    trees; whole modules and optimizers go through
    ``interop.torch_elastic.TorchState``).

    A snapshot is a host copy of every tensor (``.to("cpu", copy=True)``,
    the ``jax.device_get`` of the reference), so a committed state
    survives the loss of the device's contents; ``restore`` writes it
    back into the live tensors in place when shapes and dtypes still
    match (so a captured CUDA graph keeps reading valid storage), and
    otherwise onto the device each leaf was snapshotted from.

    ``path``: optional disk location for commits.  Under the launcher's
    elastic mode re-rendezvous is a process restart, so a commit must
    outlive the process: with ``path`` set every commit also writes the
    snapshot there atomically, and a freshly spawned worker finding the
    file resumes from it (rank consistency comes from the usual sync()
    broadcast).  With ``HVDT_PEER_STORE`` set, every commit also goes to
    the peer-replicated RAM tier, and a respawned worker restores from
    whichever tier holds the newer commit.  ``restored_from`` records
    which tier served (``"peer"``, ``"disk"`` or None).
    """

    def __init__(self, path: Optional[str] = None, **kwargs: Any):
        self._state_path = path
        self.restored_from = None
        self._devices: Dict[str, List[str]] = {}
        super().__init__(**kwargs)
        self._resume()

    def _payload_keys(self) -> List[str]:
        return [k for k in super()._payload_keys() if k != "restored_from"]

    def _split(self, payload: Dict[str, Any]):
        arrays, objects = {}, {}
        for k, v in payload.items():
            (arrays if _is_tensor_tree(v) else objects)[k] = v
        return arrays, objects

    def save(self) -> None:
        payload = {k: getattr(self, k) for k in self._payload_keys()}
        arrays, objects = self._split(payload)
        saved = {k: copy.deepcopy(v) for k, v in objects.items()}
        for k, v in arrays.items():
            saved[k] = _tree_map(lambda t: t.detach().to("cpu", copy=True),
                                 v)
        self._saved = saved
        self._devices = {k: [str(t.device) for t in _leaves(v)]
                         for k, v in arrays.items()}

    def _persisted(self) -> Any:
        return {"saved": self._saved, "devices": self._devices}

    def _load_persisted(self, saved: Any) -> None:
        self._saved, self._devices = saved["saved"], saved["devices"]

    def restore(self) -> None:
        for k, v in self._saved.items():
            if k not in self._devices:
                setattr(self, k, copy.deepcopy(v))
                continue
            live = getattr(self, k, None)
            if _same_layout(live, v):
                with torch.no_grad():
                    for dst, src in zip(_leaves(live), _leaves(v)):
                        dst.copy_(src)
                continue
            devices = iter(self._devices[k])
            setattr(self, k, _tree_map(
                lambda t: t.to(next(devices), copy=True), v))

    def sync(self) -> None:
        if not is_initialized():
            return
        from .functions import broadcast_object, broadcast_parameters

        payload = {k: getattr(self, k) for k in self._payload_keys()}
        arrays, objects = self._split(payload)
        if objects:
            objects = broadcast_object(objects, root_rank=0)
            for k, v in objects.items():
                setattr(self, k, v)
        for v in arrays.values():
            broadcast_parameters(_leaves(v), root_rank=0)
        self.save()


def _same_layout(live: Any, snap: Any) -> bool:
    """Whether ``live`` is a tensor tree of the snapshot's structure,
    leaf by leaf of the same shape and dtype (its device may differ: a
    respawned worker's card)."""
    if not _is_tensor_tree(live) or type(live) is not type(snap):
        return False
    if isinstance(live, dict) and live.keys() != snap.keys():
        return False
    a, b = _leaves(live), _leaves(snap)
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype for x, y in zip(a, b))


def run(func: Callable) -> Callable:
    """Elastic retry-loop decorator (ref: common/elastic.py:151 run_fn).

    ``func(state, *args, **kwargs)`` is re-entered after recoverable
    failures: ``HorovodInternalError`` or a ``torch.distributed.DistError``
    ⇒ restore-from-commit; ``HostsUpdatedInterrupt`` ⇒ continue with the
    current state.  Each re-entry re-initializes the framework and calls
    ``state.on_reset()`` / ``sync()``.
    """

    @functools.wraps(func)
    def wrapper(state: State, *args, **kwargs):
        _install_preemption_guard(state)
        skip_sync = False
        while True:
            if not skip_sync:
                state.sync()
            try:
                return func(state, *args, **kwargs)
            except (HorovodInternalError,
                    torch.distributed.DistError) as e:
                log.info("collective failure (%r) — restoring last commit",
                         e)
                with _recovery_phase("restore"):
                    state.restore()
                skip_sync = False
                if _launcher_managed():
                    _exit_for_respawn(state)
            except HostsUpdatedInterrupt as e:
                log.info("hosts updated — re-rendezvous without rollback")
                skip_sync = e.skip_sync
                if _launcher_managed():
                    _exit_for_respawn(state)
            with _recovery_phase("rendezvous"):
                _reset(state)

    return wrapper


def _recovery_phase(name: str):
    """Recovery-budget attribution for the in-process retry path — a
    null context when telemetry is off (the launcher-managed path
    attributes in the respawned process instead, see
    ``_Persistent._resume``)."""
    from .telemetry import step_stats

    ledger = step_stats.recovery_ledger()
    if ledger is None:
        return contextlib.nullcontext()
    return ledger.phase(name)


def _install_preemption_guard(state: State):
    """Under the elastic launcher, arm a SIGTERM/SIGINT preemption guard
    for the worker: the grace window becomes an emergency save+persist
    and a clean PREEMPT_EXIT_CODE exit that the driver treats as host
    removal, not failure (resilience/preempt.py).  Plain (non-launcher)
    runs keep default signal semantics."""
    if not _launcher_managed():
        return None
    from .resilience.preempt import PreemptionGuard

    def emergency():
        state.save()
        persist = getattr(state, "persist", None)
        if persist is not None:
            persist()

    guard = PreemptionGuard(on_preempt=emergency)
    try:
        guard.install()
    except ValueError:      # not the main thread — guard unavailable
        return None
    state._preempt_guard = guard
    return guard


def _launcher_managed() -> bool:
    """True under `hvdtrun --elastic`: the driver owns worker lifecycles
    and re-rendezvous means PROCESS RESTART (the driver respawns every
    slot each generation; a fresh process gets the new topology via the
    env contract and resumes from the disk commit)."""
    from .common import config

    return (config.get_bool("HVDT_ELASTIC")
            and bool(config.get_str("HVDT_RENDEZVOUS_ADDR")))


def _exit_for_respawn(state: State) -> None:
    persist = getattr(state, "persist", None)
    if persist is not None:
        persist()
    log.info("exiting for respawn under the new generation")
    sys.stdout.flush()
    sys.stderr.flush()
    # os._exit, not sys.exit: interpreter teardown would destroy the
    # process group, which on the collective-failure path waits on a
    # DEAD peer (NCCL's watchdog, gloo's timeout) and turns a clean
    # restart into a hang or a failure exit.  The commit is already
    # persisted; the process is being replaced, not torn down.
    os._exit(RESTART_EXIT_CODE)


def _reset(state: State) -> None:
    """Tear down and re-initialize the runtime for the new cluster
    (ref: common/elastic.py reset() → shutdown + re-init): the eager
    controller stops, the process group is destroyed and made again on
    the same kind of device (the card of the local rank, or the CPU)."""
    from .common import basics
    from .ops import eager

    device = None
    if basics.is_initialized():
        if basics.topology().device.type == "cpu":
            device = "cpu"
    try:
        eager.shutdown_controller()
    except Exception:  # noqa: BLE001 - a dead controller must not block
        log.warning("eager controller shutdown failed during reset",
                    exc_info=True)
    if basics.is_initialized():
        basics.shutdown()
    basics.init(device=device)
    state.on_reset()
