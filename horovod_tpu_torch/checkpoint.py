"""Checkpoint / resume: the rank-0 save and broadcast-on-restore pattern.

The PyTorch counterpart of the JAX package's ``checkpoint.py``:

* :func:`save_checkpoint` — rank 0 writes the tree and its step, then
  every rank meets at a barrier so none races ahead of a half-written
  save.
* :func:`restore_checkpoint` — rank 0 reads, and the tree is broadcast
  (its structure and each leaf's shape and dtype by name with
  ``broadcast_object``, bf16 included, then the leaves with
  ``broadcast_parameters``), so only rank 0 needs the file.
  ``in_place=True`` copies the values into the template's tensors,
  keeping their storages: a step that ``donated_step`` captured over
  them replays from the restored state (rebinding would leave the graph
  on the old tensors).
* ZeRO checkpoints (:func:`save_zero_state`, :func:`restore_zero_state`
  and the ``_4d`` pair): one ``shard_NNNN.npz`` per shard row, a
  ``zero_manifest.json`` with the layout and a SHA-256 a shard, the
  reference's file names, ``.npz`` keys and manifest fields exactly, so
  each package reads the other's f32 ZeRO checkpoints, resharded onto
  another shard count on restore.
* :class:`CheckpointManager` — interval and keep-N over the above, a
  SHA-256 manifest a step (fsynced, directory fsynced), an atomically
  advanced ``LAST_GOOD`` pointer, ``restore_latest`` falling back step
  by step past corrupt checkpoints; ``save_async`` (``HVDT_ASYNC_CKPT``)
  hands a host snapshot to one background writer (queue depth 1).

Payload format.  The reference writes with Orbax, which the port does
not have.  A step directory holds one ``checkpoint.pt``: ``torch.save``
of ``{"tree": ..., "step": int}`` with every tensor on the host, read
back with ``torch.load(weights_only=True)`` (no pickled code runs on
load).  The tree may nest dicts, lists and tuples of tensors, numpy
arrays (saved as tensors) and Python scalars; it comes back with
tensors on the host, or on the template's devices.

The async snapshot.  A JAX array is immutable, so the reference can
hand a live tree to its writer thread.  A PyTorch tensor is updated in
place by the next step (a ``donated_step`` replay rewrites the same
storages), so :meth:`CheckpointManager.save_async` copies every tensor
to the host before it returns (timed against
``HVDT_CKPT_SNAPSHOT_BUDGET_S``); the writer only serializes.

The reference's fault-injection points are here too: ``checkpoint.write``
at the manifest's write/fsync seam (``slow_disk``) and
``checkpoint.save`` after the manifest, before ``LAST_GOOD`` advances
(``corrupt_ckpt``); and the snapshot and background-write seconds are
charged to the recovery ledger (``telemetry/step_stats.
recovery_ledger``, None with telemetry off).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .resilience import faults

__all__ = ["save_checkpoint", "restore_checkpoint", "CheckpointManager",
           "save_zero_state", "restore_zero_state",
           "save_zero_state_4d", "restore_zero_state_4d"]

log = logging.getLogger(__name__)

_LAST_GOOD = "LAST_GOOD"
_PAYLOAD = "checkpoint.pt"


def _fsync_dir(path: str) -> None:
    """fsync a directory so a rename inside it is durable; filesystems
    that refuse directory fsync are tolerated."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _rank_size():
    from .common import basics

    if basics.is_initialized():
        return basics.rank(), basics.size()
    return 0, 1


def _barrier():
    from .common import basics

    if basics.is_initialized() and basics.size() > 1:
        import torch.distributed as dist

        dist.barrier()


def _host(leaf):
    """A leaf as the payload holds it: a host copy of a tensor (never a
    view of the caller's storage), numpy as a tensor, scalars as they
    are."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(np.array(leaf))
    return leaf


def _snapshot(tree):
    return pytree.tree_map(_host, tree)


def _write_payload(path: str, payload: dict) -> None:
    os.makedirs(path, exist_ok=True)
    fpath = os.path.join(path, _PAYLOAD)
    tmp = f"{fpath}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, fpath)


def save_checkpoint(path: str, tree: Any, step: Optional[int] = None,
                    force: bool = True) -> None:
    """Rank 0 saves ``tree`` (tensors copied to the host) and ``step``
    under the directory ``path``; then every rank meets at a barrier."""
    rank, _ = _rank_size()
    if rank == 0:
        path = os.path.abspath(path)
        if force and os.path.exists(path):
            shutil.rmtree(path)
        _write_payload(path, {"tree": _snapshot(tree),
                              "step": int(step) if step is not None else -1})
    _barrier()


class _Leaf:
    """A leaf's shape and dtype by name (the broadcast skeleton)."""

    def __init__(self, shape, dtype: str):
        self.shape, self.dtype = tuple(shape), dtype


def _dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


def restore_checkpoint(path: str, template: Any = None,
                       broadcast: bool = True, *, in_place: bool = False):
    """Restore a tree saved by :func:`save_checkpoint`; returns ``(tree,
    step)`` (step None when absent).

    With ``broadcast`` rank 0 reads and the tree is broadcast (its
    structure and leaf dtypes by name first, then the leaves).  With a
    ``template`` (a tree of the same structure) each tensor comes back
    on its template leaf's device; ``in_place=True`` copies the values
    into the template's tensors and returns the template."""
    from .common import basics

    rank, size = _rank_size()
    tree, step = None, None
    if rank == 0 or not broadcast:
        payload = torch.load(os.path.join(os.path.abspath(path), _PAYLOAD),
                             map_location="cpu", weights_only=True)
        tree = payload["tree"]
        step = None if payload["step"] < 0 else int(payload["step"])
    if broadcast and size > 1:
        from .functions import broadcast_object, broadcast_parameters

        if rank == 0:
            skeleton = pytree.tree_map(
                lambda t: _Leaf(t.shape, str(t.dtype).rsplit(".", 1)[-1])
                if isinstance(t, torch.Tensor) else t, tree)
        else:
            skeleton = None
        skeleton, step = broadcast_object((skeleton, step), root_rank=0)
        device = basics.topology().device
        leaves, spec = pytree.tree_flatten(
            skeleton, is_leaf=lambda x: isinstance(x, _Leaf))
        if rank == 0:
            got = pytree.tree_leaves(tree)
            leaves = [g.to(device) if isinstance(s, _Leaf) else s
                      for g, s in zip(got, leaves)]
        else:
            leaves = [torch.zeros(s.shape, dtype=_dtype_of(s.dtype),
                                  device=device) if isinstance(s, _Leaf)
                      else s for s in leaves]
        broadcast_parameters([t for t in leaves
                              if isinstance(t, torch.Tensor)], root_rank=0)
        tree = pytree.tree_unflatten(leaves, spec)
    if template is not None:
        got = pytree.tree_leaves(tree)
        want, spec = pytree.tree_flatten(template)
        if len(got) != len(want):
            raise ValueError(f"checkpoint holds {len(got)} leaves, the "
                             f"template {len(want)}")
        out = []
        with torch.no_grad():
            for g, w in zip(got, want):
                if isinstance(w, torch.Tensor) and isinstance(g,
                                                              torch.Tensor):
                    if in_place:
                        w.copy_(g)
                        g = w
                    else:
                        g = g.to(w.device)
                out.append(g)
        tree = template if in_place else pytree.tree_unflatten(out, spec)
    return tree, step


# ---------------------------------------------------------------------------
# ZeRO checkpoints: the reference's layout, byte for byte in names and keys
# ---------------------------------------------------------------------------

_ZERO_MANIFEST = "zero_manifest.json"


def _sha256(data: bytes) -> str:
    h = hashlib.sha256()
    h.update(data)
    return h.hexdigest()


def save_zero_state(path: str, state, meta: dict,
                    step: Optional[int] = None) -> None:
    """Persist a ZeRO-sharded optimizer state (``ops/zero.py``) as one
    ``shard_NNNN.npz`` a shard row (keys ``mu_<bucket>``,
    ``nu_<bucket>`` or ``trace_<bucket>``) and ``zero_manifest.json``
    (the layout ``meta``, the step, Adam's count, the buffer names and a
    SHA-256 a shard file).  Rank 0 writes; every rank meets at a
    barrier.  The stacks must be whole (``[n, shard_len]``): a
    rank-local state is gathered first
    (``ZeroTransformation.gather_state``)."""
    from .ops import zero as _zero

    rank, _ = _rank_size()
    n = int(meta["num_shards"])
    stacks = _zero._state_stacks(state)
    for _, bufs in stacks:
        for stack in bufs:
            if int(stack.shape[0]) != n:
                raise ValueError(
                    f"save_zero_state needs whole [{n}, shard_len] stacks, "
                    f"got {int(stack.shape[0])} rows: gather a rank-local "
                    "state first (ZeroTransformation.gather_state)")
    if rank == 0:
        os.makedirs(path, exist_ok=True)
        host = [(name, [_zero._np(s) for s in bufs]) for name, bufs in stacks]
        digests = {}
        for s in range(n):
            arrays = {}
            for name, bufs in host:
                for bi, stack in enumerate(bufs):
                    arrays[f"{name}_{bi}"] = stack[s]
            fname = f"shard_{s:04d}.npz"
            fpath = os.path.join(path, fname)
            tmp = f"{fpath}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                np.savez(f, **arrays)
            os.replace(tmp, fpath)
            with open(fpath, "rb") as f:
                digests[fname] = _sha256(f.read())
        doc = {"meta": dict(meta),
               "step": int(step) if step is not None else None,
               "count": (int(state.count) if hasattr(state, "mu")
                         else None),
               "buffers": [name for name, _ in stacks],
               "shards": digests}
        tmp = os.path.join(path, f".{_ZERO_MANIFEST}.tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, os.path.join(path, _ZERO_MANIFEST))
    _barrier()


def restore_zero_state(path: str, num_shards: Optional[int] = None):
    """Restore a state saved by :func:`save_zero_state` (by either
    package), every shard file verified against its SHA-256 first (a
    mismatch raises ``ValueError``), resharded onto ``num_shards`` when
    that differs from the saved count.  Returns ``(state, meta, step)``
    with whole ``[n, shard_len]`` host stacks and ``meta`` describing
    the restored layout."""
    from .ops import zero as _zero

    with open(os.path.join(path, _ZERO_MANIFEST)) as f:
        doc = json.load(f)
    meta = doc["meta"]
    n_saved = int(meta["num_shards"])
    per_buffer: dict = {name: {} for name in doc["buffers"]}
    for fname, digest in doc["shards"].items():
        fpath = os.path.join(path, fname)
        with open(fpath, "rb") as f:
            data = f.read()
        if _sha256(data) != digest:
            raise ValueError(
                f"zero checkpoint shard {fname} failed SHA-256 "
                f"verification")
        s = int(fname[len("shard_"):-len(".npz")])
        with np.load(fpath) as z:
            for key in z.files:
                name, bi = key.rsplit("_", 1)
                per_buffer[name].setdefault(int(bi), {})[s] = z[key]
    nbuckets = len(meta["buckets"])

    def stack_buffer(name):
        return tuple(
            _zero._tensor(np.stack([per_buffer[name][bi][s]
                                    for s in range(n_saved)]))
            for bi in range(nbuckets))

    if "mu" in per_buffer:
        state = _zero.ZeroAdamState(
            count=torch.as_tensor(doc.get("count") or 0, dtype=torch.int32),
            mu=stack_buffer("mu"), nu=stack_buffer("nu"))
    else:
        state = _zero.ZeroSgdState(trace=stack_buffer("trace"))
    if num_shards is not None and int(num_shards) != n_saved:
        state, meta = _zero.reshard_state(state, meta, int(num_shards))
    return state, meta, doc.get("step")


_ZERO_LAYOUT = "zero_layout.json"


def save_zero_state_4d(path: str, stage_states, stage_metas,
                       step: Optional[int] = None) -> None:
    """Persist a pipeline-sharded ZeRO state: one :func:`save_zero_state`
    checkpoint per pipeline stage (``stage_0000/``, ...) and a top-level
    ``zero_layout.json`` naming the saved layout."""
    stage_states = list(stage_states)
    stage_metas = list(stage_metas)
    if len(stage_states) != len(stage_metas):
        raise ValueError("one meta per stage state required")
    rank, _ = _rank_size()
    for si, (st, me) in enumerate(zip(stage_states, stage_metas)):
        save_zero_state(os.path.join(path, f"stage_{si:04d}"), st, me, step)
    if rank == 0:
        doc = {"layout": {"pp": len(stage_states),
                          "dp": int(stage_metas[0]["num_shards"])},
               "stages": len(stage_states),
               "step": int(step) if step is not None else None}
        tmp = os.path.join(path, f".{_ZERO_LAYOUT}.tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, os.path.join(path, _ZERO_LAYOUT))
    _barrier()


def restore_zero_state_4d(path: str, target_metas):
    """Restore a (possibly pipeline-sharded) ZeRO checkpoint into another
    parallelism layout through the global logical vector
    (``ops.zero.concat_states`` + the re-split): ``(pp=2, dp=4) ->
    (dp=8)``, ``(dp=8) -> (pp=2, dp=4)`` and dp-only resharding.
    ``target_metas``: one ``ops.zero.state_metadata`` per stage of the
    new layout.  Returns ``(states, metas, step)``, one entry a new
    stage."""
    from .ops import zero as _zero

    layout_doc = os.path.join(path, _ZERO_LAYOUT)
    if os.path.exists(layout_doc):
        with open(layout_doc) as f:
            doc = json.load(f)
        n_stages = int(doc.get("stages", 1))
        saved = [restore_zero_state(os.path.join(path, f"stage_{s:04d}"))
                 for s in range(n_stages)]
        states = [s for s, _, _ in saved]
        metas = [m for _, m, _ in saved]
        step = saved[0][2]
    else:
        state, meta, step = restore_zero_state(path)
        states, metas = [state], [meta]
    combined, combined_meta = _zero.concat_states(states, metas)
    flats = _zero.flatten_state_buffers(combined, combined_meta)
    total = next(iter(flats.values())).size
    want = sum(int(b["size"]) for tm in target_metas
               for b in tm["buckets"])
    if want != total:
        raise ValueError(
            f"target layout covers {want} logical elements but the "
            f"checkpoint holds {total} — different parameter sets")
    out_states, out_metas = [], []
    off = 0
    for tm in target_metas:
        span = sum(int(b["size"]) for b in tm["buckets"])
        piece = {name: flat[off:off + span] for name, flat in flats.items()}
        off += span
        n = int(tm["num_shards"])
        if "mu" in piece:
            st = _zero.ZeroAdamState(
                count=torch.as_tensor(int(combined.count), dtype=torch.int32),
                mu=_zero._split_logical(piece["mu"], tm["buckets"], n),
                nu=_zero._split_logical(piece["nu"], tm["buckets"], n))
        else:
            st = _zero.ZeroSgdState(
                trace=_zero._split_logical(piece["trace"], tm["buckets"], n))
        out_states.append(st)
        out_metas.append(dict(tm))
    return out_states, out_metas, step


# ---------------------------------------------------------------------------
# The manager
# ---------------------------------------------------------------------------


class CheckpointManager:
    """Interval and keep-N checkpointing over save / restore::

        mgr = CheckpointManager("/ckpts", save_interval_steps=100,
                                max_to_keep=3)
        for step in ...:
            ...
            mgr.save(step, {"model": model.state_dict(), "step": step})
        tree, step = mgr.restore_latest(template)
    """

    def __init__(self, directory: str, save_interval_steps: int = 1,
                 max_to_keep: int = 3):
        from .common import config

        self.directory = os.path.abspath(directory)
        self.save_interval_steps = max(1, save_interval_steps)
        self.max_to_keep = max_to_keep
        # Corrupt checkpoints detected and skipped during restore.
        self.corrupt_detected = 0
        os.makedirs(self.directory, exist_ok=True)
        self._async = config.get_bool("HVDT_ASYNC_CKPT")
        self._snapshot_budget_s = config.get_float(
            "HVDT_CKPT_SNAPSHOT_BUDGET_S")
        self._writer: Optional[_AsyncCheckpointWriter] = None
        if not self._async:
            # With the knob unset save_async IS the synchronous save.
            self.save_async = self.save

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:012d}")

    def step_path(self, step: int) -> str:
        """Directory a given step is (or would be) stored at."""
        return self._step_dir(step)

    def all_steps(self):
        """Sorted steps present on disk: only ``step_N`` directories
        count (stray files, foreign names and temporaries are skipped)."""
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        out = []
        for name in names:
            if name.startswith("step_"):
                try:
                    step = int(name[5:])
                except ValueError:
                    continue
                if os.path.isdir(os.path.join(self.directory, name)):
                    out.append(step)
        return sorted(out)

    def should_save(self, step: int) -> bool:
        return step % self.save_interval_steps == 0

    # -- integrity manifest / last-good pointer ---------------------------

    def _manifest_path(self, step: int) -> str:
        return self._step_dir(step) + ".manifest.json"

    @staticmethod
    def _hash_file(path: str) -> str:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        return h.hexdigest()

    def _write_manifest(self, step: int) -> None:
        """Checksum every file of a just-written step; the manifest is
        fsynced before its rename and the directory after it."""
        root = self._step_dir(step)
        files = {}
        for dirpath, _dirs, names in os.walk(root):
            for name in names:
                p = os.path.join(dirpath, name)
                rel = os.path.relpath(p, root)
                files[rel] = [os.path.getsize(p), self._hash_file(p)]
        tmp = f"{self._manifest_path(step)}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"step": step, "files": files}, f)
            f.flush()
            # The write/fsync seam: slow_disk@step=N:secs=S sleeps here,
            # in whichever thread performs the durable write.
            inj = faults.get_injector()
            if inj is not None:
                inj.fire("checkpoint.write", step=step)
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path(step))
        _fsync_dir(self.directory)

    def verify_step(self, step: int) -> bool:
        """True when the step's files match its manifest.  A step without
        a manifest passes."""
        root = self._step_dir(step)
        if not os.path.isdir(root):
            return False
        try:
            with open(self._manifest_path(step)) as f:
                manifest = json.load(f)
        except FileNotFoundError:
            log.debug("checkpoint step %d has no manifest; accepting", step)
            return True
        except (OSError, ValueError) as e:
            log.warning("checkpoint step %d manifest unreadable: %r", step, e)
            return False
        for rel, (size, digest) in manifest.get("files", {}).items():
            p = os.path.join(root, rel)
            try:
                if os.path.getsize(p) != size or self._hash_file(p) != digest:
                    return False
            except OSError:
                return False
        return True

    def _advance_last_good(self, step: int) -> None:
        tmp = os.path.join(self.directory, f".{_LAST_GOOD}.tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.directory, _LAST_GOOD))
        _fsync_dir(self.directory)

    def last_good_step(self) -> Optional[int]:
        """Newest step whose save fully completed; falls back to the
        newest on-disk step when the pointed-at one was pruned."""
        try:
            with open(os.path.join(self.directory, _LAST_GOOD)) as f:
                step = int(f.read().strip())
        except (OSError, ValueError):
            return self.latest_step()
        if os.path.isdir(self._step_dir(step)):
            return step
        steps = [s for s in self.all_steps() if s < step]
        return steps[-1] if steps else self.latest_step()

    def _finalize_step(self, step: int) -> None:
        """The durability tail of the sync save and the async writer:
        manifest, the ``checkpoint.save`` fault point, ``LAST_GOOD``,
        keep-N pruning."""
        self._write_manifest(step)
        inj = faults.get_injector()
        if inj is not None:
            inj.fire("checkpoint.save", step=step,
                     path=self._step_dir(step),
                     manifest=self._manifest_path(step))
        self._advance_last_good(step)
        steps = self.all_steps()
        for old in steps[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)
            try:
                os.remove(self._manifest_path(old))
            except OSError:
                pass

    def save(self, step: int, tree: Any, force: bool = False) -> bool:
        """Save if the interval says so (or ``force``); prunes old steps.
        True when a checkpoint was written.  ``LAST_GOOD`` advances only
        after the payload and the manifest are durable."""
        if not force and not self.should_save(step):
            return False
        save_checkpoint(self._step_dir(step), tree, step=step)
        rank, _ = _rank_size()
        if rank == 0:
            self._finalize_step(step)
        return True

    # -- async saves ------------------------------------------------------

    def save_async(self, step: int, tree: Any, force: bool = False) -> bool:
        """Non-blocking save (``HVDT_ASYNC_CKPT``; otherwise this very
        attribute is :meth:`save`).  The caller pays the device→host
        snapshot, complete before this returns, so the next step may
        update the tensors in place; it is timed into
        ``hvdt_ckpt_snapshot_seconds`` against
        ``HVDT_CKPT_SNAPSHOT_BUDGET_S``.  The single background writer
        (depth 1: a newer snapshot replaces a queued one) serializes,
        writes the manifest, fsyncs and then advances ``LAST_GOOD``.
        Rank 0 only, no barrier.  True when a snapshot was scheduled."""
        if not force and not self.should_save(step):
            return False
        rank, _ = _rank_size()
        if rank != 0:
            return True
        t0 = time.perf_counter()
        payload = {"tree": _snapshot(tree), "step": int(step)}
        self._observe_snapshot(time.perf_counter() - t0)
        self._writer_handle().submit(step, payload)
        return True

    def _writer_handle(self) -> "_AsyncCheckpointWriter":
        if self._writer is None:
            self._writer = _AsyncCheckpointWriter(self)
        return self._writer

    def _observe_snapshot(self, seconds: float) -> None:
        m = self._async_metrics()
        m["snapshot"].observe(seconds)
        if seconds > self._snapshot_budget_s:
            m["over_budget"].inc()
            log.warning(
                "checkpoint snapshot took %.3fs, over the %.1fs "
                "HVDT_CKPT_SNAPSHOT_BUDGET_S stall budget", seconds,
                self._snapshot_budget_s)
        ledger = _recovery_ledger()
        if ledger is not None:
            ledger.charge_phase("checkpoint_snapshot", seconds)

    def _async_metrics(self):
        metrics = getattr(self, "_async_metrics_cache", None)
        if metrics is None:
            from .telemetry.metrics import default_registry

            reg = default_registry()
            metrics = {
                "snapshot": reg.summary(
                    "hvdt_ckpt_snapshot_seconds",
                    "Commit-point device->host checkpoint snapshot "
                    "duration — the only stall the step loop pays under "
                    "HVDT_ASYNC_CKPT"),
                "write": reg.summary(
                    "hvdt_ckpt_write_seconds",
                    "Background checkpoint write duration (serialize + "
                    "manifest + fsync + LAST_GOOD advance)"),
                "over_budget": reg.counter(
                    "hvdt_ckpt_snapshot_over_budget_total",
                    "Snapshots exceeding HVDT_CKPT_SNAPSHOT_BUDGET_S"),
                "superseded": reg.counter(
                    "hvdt_ckpt_superseded_total",
                    "Queued async snapshots replaced by a newer one "
                    "before the writer got to them"),
                "failures": reg.counter(
                    "hvdt_ckpt_write_failures_total",
                    "Background checkpoint writes that raised (logged; "
                    "LAST_GOOD not advanced)"),
            }
            self._async_metrics_cache = metrics
        return metrics

    def _write_step_payload(self, step: int, payload: dict) -> None:
        """Writer-thread body: write a host payload (no barrier), then
        the shared durability tail."""
        path = self._step_dir(step)
        if os.path.exists(path):
            shutil.rmtree(path)
        _write_payload(path, payload)
        self._finalize_step(step)

    def wait_for_async(self, timeout: Optional[float] = None) -> bool:
        """Block until the writer has drained; True when idle within
        ``timeout`` (trivially when async mode is off or unused)."""
        if self._writer is None:
            return True
        return self._writer.wait_idle(timeout)

    def close(self) -> None:
        """Stop the background writer after draining pending work."""
        if self._writer is not None:
            self._writer.close()
            self._writer = None

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_latest(self, template: Any = None, broadcast: bool = True,
                       *, in_place: bool = False):
        """``(tree, step)`` of the newest intact checkpoint, or ``(None,
        None)``.  A checkpoint that fails its manifest (or whose restore
        raises) is counted in ``corrupt_detected``, logged and skipped.
        In a multi-rank broadcast restore rank 0 picks the step and the
        choice is broadcast."""
        rank, size = _rank_size()
        if broadcast and size > 1:
            step = None
            if rank == 0:
                for cand in reversed(self.all_steps()):
                    if self.verify_step(cand):
                        step = cand
                        break
                    self.corrupt_detected += 1
                    log.warning("checkpoint step %d failed verification; "
                                "falling back", cand)
            from .functions import broadcast_object

            step = broadcast_object(step, root_rank=0)
            if step is None:
                return None, None
            return restore_checkpoint(self._step_dir(step), template,
                                      broadcast=True, in_place=in_place)
        for cand in reversed(self.all_steps()):
            if not self.verify_step(cand):
                self.corrupt_detected += 1
                log.warning("checkpoint step %d failed verification; "
                            "falling back", cand)
                continue
            try:
                return restore_checkpoint(self._step_dir(cand), template,
                                          broadcast=broadcast,
                                          in_place=in_place)
            except Exception as e:
                self.corrupt_detected += 1
                log.warning("checkpoint step %d restore failed (%r); "
                            "falling back", cand, e)
        return None, None


def _recovery_ledger():
    """The process-wide recovery ledger, or None with telemetry off
    (the zero-overhead contract of ``step_stats.recovery_ledger``)."""
    from .telemetry import step_stats

    return step_stats.recovery_ledger()


class _AsyncCheckpointWriter:
    """One background checkpoint writer with a depth-1 slot: a newer
    snapshot replaces a queued older one (the write in flight is never
    abandoned); write errors are logged and counted, never raised into
    the training loop, and ``LAST_GOOD`` stays on the previous step."""

    def __init__(self, manager: CheckpointManager):
        self._manager = manager
        self._cond = threading.Condition()
        self._pending: Optional[tuple] = None
        self._busy = False
        self._stopping = False
        self.last_written_step: Optional[int] = None
        self._thread = threading.Thread(
            target=self._run, name="hvdt-ckpt-writer", daemon=True)
        self._thread.start()

    def submit(self, step: int, payload: dict) -> None:
        with self._cond:
            if self._stopping:
                raise RuntimeError("async checkpoint writer is closed")
            if self._pending is not None:
                self._manager._async_metrics()["superseded"].inc()
                log.info("async checkpoint: step %s superseded by step %s "
                         "before write started", self._pending[0], step)
            self._pending = (step, payload)
            self._cond.notify_all()

    def _run(self) -> None:
        while True:
            with self._cond:
                while self._pending is None and not self._stopping:
                    self._cond.wait()
                if self._pending is None:
                    return
                step, payload = self._pending
                self._pending = None
                self._busy = True
            t0 = time.perf_counter()
            try:
                self._manager._write_step_payload(step, payload)
                self.last_written_step = step
            except Exception as e:  # noqa: BLE001 - must not kill training
                self._manager._async_metrics()["failures"].inc()
                log.warning("async checkpoint write of step %d failed "
                            "(LAST_GOOD unchanged): %r", step, e)
            finally:
                elapsed = time.perf_counter() - t0
                self._manager._async_metrics()["write"].observe(elapsed)
                ledger = _recovery_ledger()
                if ledger is not None:
                    ledger.charge_phase("checkpoint_write", elapsed,
                                        overlapped=True)
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        with self._cond:
            while self._pending is not None or self._busy:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                self._cond.wait(remaining)
            return True

    def close(self, timeout: float = 30.0) -> None:
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        self._thread.join(timeout)
        if self._thread.is_alive():
            log.warning("async checkpoint writer did not drain within "
                        "%.1fs of close()", timeout)
