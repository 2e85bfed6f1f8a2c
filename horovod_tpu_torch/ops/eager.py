"""Eager named-collective path: negotiation controller and public async API.

The PyTorch counterpart of the JAX package's ``ops/eager.py``.
Framework threads enqueue *named* tensors in any order; a controller
matches names across ranks, checks shapes and dtypes, fuses small
allreduces, and executes them, with joined ranks contributing the
reduction's identity, stall detection and a response cache.

One background thread owns all cross-rank communication; framework
threads only touch the tensor queue and the handle table.  Negotiation
runs over the control plane (``ops/control_plane.py``: the process
group's c10d store); the data moves over each process set's eager group
(``ops/host_collectives.py``: NCCL on the card, gloo on the CPU), never
over the group the main thread's collectives use.

Tensors stay where the group computes.  A CUDA tensor is reduced on the
card, on the controller's own CUDA stream, which first waits for an
event recorded on the caller's stream at enqueue; a numpy array or a CPU
tensor in an NCCL world is copied to the card and back.  A CUDA tensor
in a gloo world raises at the call site.  A handle is done only once its
collective has finished on the device, so ``poll`` is true only then and
``synchronize`` returns a result valid on any stream.  The result has
the input's type: a torch tensor on the input's device and dtype, or a
numpy array.

Inside a CUDA-graph capture an eager call raises; the controller's
thread holds ``graphs.capture_lock`` around its CUDA work, which
``step_pipeline.donated_step`` holds across a capture.  So only a
``donated_step`` capture is safe while eager ops are in flight.  Any
other capture (``torch.cuda.graph``, ``make_graphed_callables``; both
capture in the "global" error mode, which a CUDA call from the
controller's thread invalidates) must first ``synchronize`` every
outstanding handle, or hold ``graphs.capture_lock`` across the capture.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import logging
import math
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import basics, config, graphs
from ..common.exceptions import HorovodInternalError, NotInitializedError
from ..common.process_sets import ProcessSet, global_process_set
from ..common.types import (DUPLICATE_NAME_ERROR, ReduceOp, Status,
                            data_type_of, torch_dtype_of)
from .. import timeline as _timeline
from . import host_collectives as hostc
from .control_plane import ControlPlane, default_control_plane
from .handles import HandleManager
from .messages import (Request, RequestType, Response, decode_request_list,
                       decode_response_list, encode_request_list,
                       encode_response_list)

__all__ = [
    "allreduce", "allreduce_async", "grouped_allreduce",
    "grouped_allreduce_async", "allgather", "allgather_async", "broadcast",
    "broadcast_async", "alltoall", "alltoall_async", "reducescatter",
    "reducescatter_async", "barrier", "join", "poll", "synchronize",
    "shutdown_controller",
]

log = logging.getLogger(__name__)

# A gather payload and a response outside the JSON wire format: a rank
# whose controller is shutting down sends it, and the coordinator answers
# with it, so every rank's controller stops in the same cycle instead of
# waiting on the control plane for a peer that has stopped.
_SHUTDOWN = "shutdown"



# ---------------------------------------------------------------------------
# Local bookkeeping structures
# ---------------------------------------------------------------------------

class _Entry:
    """Local in-flight tensor."""

    __slots__ = ("request", "tensor", "handle", "np_dtype", "ready",
                 "enqueue_ts", "announce_ts", "fr_seq")

    def __init__(self, request: Request, tensor: Optional[torch.Tensor],
                 handle: int, np_dtype: Optional[np.dtype] = None,
                 ready: Optional[torch.cuda.Event] = None,
                 fr_seq: Optional[int] = None):
        self.request = request
        self.tensor = tensor
        self.handle = handle
        # Telemetry: enqueue -> announce -> execute latencies
        # (announce_ts is stamped only while the recorder is on) and the
        # flight-recorder event opened at enqueue.
        self.enqueue_ts = time.monotonic()
        self.announce_ts: Optional[float] = None
        self.fr_seq = fr_seq
        # The input's numpy dtype when it was a numpy array (the result is
        # one too); None for a torch tensor.
        self.np_dtype = np_dtype
        # Recorded on the caller's current stream at enqueue (CUDA inputs):
        # the controller's stream waits on it before reading the tensor.
        self.ready = ready


class ResponseCache:
    """LRU cache of negotiated request descriptors, coherent across ranks:
    every rank applies identical updates in response-execution order, so
    cache bit positions agree without extra synchronization."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        # name -> Request (insertion-ordered for LRU)
        self._entries: "collections.OrderedDict[str, Request]" = \
            collections.OrderedDict()

    def lookup_bit(self, req: Request) -> Optional[int]:
        if req.group_id >= 0:
            # grouped requests always fully negotiate: group membership is
            # not carried by cached descriptors, and the all-or-nothing
            # gate must see the live group id
            return None
        if req.request_type == RequestType.ALLTOALL:
            # alltoall always fully negotiates: its send splits differ
            # from rank to rank, so a descriptor cached alike on every
            # rank cannot carry them (the coordinator would rebuild each
            # rank's request with its own splits)
            return None
        cached = self._entries.get(req.tensor_name)
        if cached is None:
            return None
        if cached.descriptor() != req.descriptor() or \
                cached.prescale_factor != req.prescale_factor or \
                cached.postscale_factor != req.postscale_factor or \
                cached.tensor_shape != req.tensor_shape:
            # descriptor changed → treat as uncached; will be re-inserted
            return None
        return list(self._entries).index(req.tensor_name)

    def request_for_bit(self, bit: int) -> Optional[Request]:
        names = list(self._entries)
        if 0 <= bit < len(names):
            return self._entries[names[bit]]
        return None

    def insert(self, req: Request) -> None:
        if self.capacity <= 0:
            return
        name = req.tensor_name
        if name in self._entries:
            self._entries.pop(name)
        self._entries[name] = req
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)


class _MessageTable:
    """Coordinator-side readiness table (arrival-ordered)."""

    def __init__(self) -> None:
        # key -> {rank: Request}; insertion order = first-arrival order
        self.pending: "collections.OrderedDict[Tuple[int, str], Dict[int, Request]]" = \
            collections.OrderedDict()

    def add(self, req: Request) -> None:
        key = (req.process_set_id, req.tensor_name)
        self.pending.setdefault(key, {})[req.request_rank] = req


def _dtype_label(tensor_type: int) -> str:
    """numpy-style dtype name of a wire tensor type ("float32"), the
    telemetry label the reference uses."""
    try:
        return str(torch_dtype_of(tensor_type)).rsplit(".", 1)[-1]
    except (ValueError, KeyError):
        return "unknown"


def _itemsize(tensor_type: int) -> int:
    try:
        return torch_dtype_of(tensor_type).itemsize
    except (ValueError, KeyError):
        return 4


# ---------------------------------------------------------------------------
# Controller
# ---------------------------------------------------------------------------

class EagerController:
    def __init__(self, control_plane: Optional[ControlPlane] = None):
        from ..resilience.escalation import EscalationPolicy, Escalator
        from ..stall import StallInspector
        from ..timeline import get_timeline

        get_timeline()      # start HVDT_TIMELINE's, once

        self.cp = control_plane or default_control_plane()
        self.handles = HandleManager()
        self._lock = threading.Lock()
        # (ps_id, name) -> _Entry   (duplicate-name check)
        self._entries: Dict[Tuple[int, str], _Entry] = {}
        self._to_announce: List[Request] = []
        self._cache = ResponseCache(config.get_int("HVDT_CACHE_CAPACITY"))
        self._message_table = _MessageTable()
        self._group_members: Dict[int, set] = {}   # group_id -> names
        self._next_group_id = itertools.count()
        self._joined: Dict[int, Dict[int, int]] = {}  # ps_id -> {rank: join order}
        self._local_join_handles: Dict[int, int] = {}  # ps_id -> handle
        self._cycle = 0
        self._running = True
        self._stop_requested = False
        # Set by an enqueue: ends the loop's idle back-off at once.
        self._wake = threading.Event()
        # Stall policy ladder (warn → abort collective → request elastic
        # reset).  Only built when an escalation rung is configured, so
        # the default path keeps the plain warn-only inspector.
        policy = EscalationPolicy.from_env()
        self._escalator = (Escalator(policy)
                           if (policy.abort_s or policy.reset_s) else None)
        self._stall = StallInspector(self.cp.size(),
                                     escalator=self._escalator)
        self._cycle_time_s = config.get_float("HVDT_CYCLE_TIME") / 1000.0
        self.device = basics.topology().device
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._thread = threading.Thread(target=self._loop,
                                        name="hvdt-controller", daemon=True)
        self._thread.start()

    @property
    def cycles(self) -> int:
        """Negotiation cycles run so far."""
        return self._cycle

    # -- framework-thread API ----------------------------------------------
    def enqueue(self, request: Request, tensor: Optional[torch.Tensor],
                np_dtype: Optional[np.dtype] = None,
                ready: Optional[torch.cuda.Event] = None) -> int:
        return self.enqueue_all([(request, tensor, np_dtype, ready)])[0]

    def enqueue_all(self, items: Sequence[tuple]) -> List[int]:
        """Enqueue (request, tensor, np_dtype, ready) items at once: one
        cycle announces them all (a group is then negotiated in one
        cycle, not re-gated in each cycle while it is being enqueued)."""
        from ..telemetry import flight_recorder as _frm

        flight = _frm.get_flight_recorder()
        seqs: List[Optional[int]] = [None] * len(items)
        if flight is not None:
            # Begin at enqueue, end at completion: a hung rank's peers
            # show its collectives stuck "inflight".
            for i, (request, *_) in enumerate(items):
                shape = tuple(request.tensor_shape or ())
                seqs[i] = flight.record_begin(
                    op=RequestType(request.request_type).name.lower(),
                    name=request.tensor_name,
                    dtype=_dtype_label(request.tensor_type), shape=shape,
                    nbytes=math.prod(shape) * _itemsize(request.tensor_type),
                    path="eager")
        with self._lock:
            error = None
            if not self._running:
                error = HorovodInternalError("controller is shut down")
            for request, *_ in items:
                if error is None and (request.process_set_id,
                                      request.tensor_name) in self._entries:
                    error = ValueError(DUPLICATE_NAME_ERROR +
                                       f" (tensor: {request.tensor_name})")
            if error is not None:
                if flight is not None:
                    for seq in seqs:
                        flight.record_end(seq, status="error")
                raise error
            handles = []
            for (request, tensor, np_dtype, ready), seq in zip(items, seqs):
                handle = self.handles.allocate()
                self._entries[(request.process_set_id,
                               request.tensor_name)] = _Entry(
                    request, tensor, handle, np_dtype, ready, fr_seq=seq)
                self._to_announce.append(request)
                handles.append(handle)
        tl = _timeline.current()
        if tl is not None:
            for request, *_ in items:
                tl.start_activity(
                    request.tensor_name,
                    f"NEGOTIATE_{RequestType(request.request_type).name}")
        self._wake.set()
        return handles

    def enqueue_join(self, ps: ProcessSet) -> int:
        req = Request(self.cp.rank(), RequestType.JOIN, f"join.{ps.id}",
                      0, (), process_set_id=ps.id)
        with self._lock:
            if not self._running:
                raise HorovodInternalError("controller is shut down")
            if ps.id in self._local_join_handles:
                raise ValueError(f"join already pending for process set {ps.id}")
            handle = self.handles.allocate()
            self._local_join_handles[ps.id] = handle
            self._to_announce.append(req)
        self._wake.set()
        return handle

    def next_group_id(self) -> int:
        return next(self._next_group_id)

    # -- background loop ------------------------------------------------------
    def _loop(self) -> None:
        if self._stream is not None:
            with graphs.capture_lock:
                torch.cuda.set_device(self.device)
        idle_sleep = 0.0001
        while self._running:
            if self._cycle_time_s > 0:
                time.sleep(self._cycle_time_s)
            try:
                did_work = self._run_cycle()
            except Exception as e:
                with self._lock:
                    # Idle = nothing in flight anywhere this rank knows
                    # about: no local entries/announcements/joins AND (on
                    # the coordinator) no other rank's requests mid-
                    # negotiation.
                    idle = (not self._entries and not self._to_announce
                            and not self._local_join_handles
                            and not self._message_table.pending
                            and not any(self._joined.values()))
                if not self._running or idle:
                    # Teardown raced a blocking control-plane call (our
                    # own shutdown, or a peer's store going away while
                    # this rank idles).  Nothing was in flight, but the
                    # controller is dead: later enqueues raise.
                    log.debug("controller loop exiting on teardown: %s", e)
                    self._fail_all(
                        f"controller shut down (control plane gone: {e})")
                    return
                log.exception("controller cycle failed: %s", e)
                self._fail_all(f"controller cycle failed: {e}")
                return
            tl = _timeline.current()
            if tl is not None:
                tl.mark_cycle()
            if not did_work and self._cycle_time_s == 0:
                # back off while idle, but not past a local enqueue
                self._wake.wait(idle_sleep)
                self._wake.clear()
                idle_sleep = min(idle_sleep * 2, 0.002)
            else:
                idle_sleep = 0.0001

    def _run_cycle(self) -> bool:
        from ..telemetry import instrument as _ti

        with self._lock:
            to_send = self._to_announce
            self._to_announce = []
            stop = self._stop_requested
            if to_send and _ti.get_recorder() is not None:
                now = time.monotonic()
                for req in to_send:
                    e = self._entries.get(
                        (req.process_set_id, req.tensor_name))
                    if e is not None:
                        e.announce_ts = now
        multi = self.cp.size() > 1
        if not multi:
            if stop:
                self._fail_all("controller shut down")
                return False
            if not to_send:
                return False

        # -- announce: cache bits for hits, full requests for misses
        bits: List[int] = []
        misses: List[Request] = []
        for req in to_send:
            if req.request_type == RequestType.JOIN:
                misses.append(req)
                continue
            bit = self._cache.lookup_bit(req)
            if bit is not None:
                bits.append(bit)
            else:
                misses.append(req)
        payload = encode_request_list(misses)
        payload = f"{','.join(map(str, bits))}|{payload}"
        if stop:
            payload = _SHUTDOWN

        gathered = self.cp.gather(payload, self._cycle)

        # -- coordinator: build response list
        resp_payload: Optional[str] = None
        if gathered is not None:
            if _SHUTDOWN in gathered:
                resp_payload = _SHUTDOWN
            else:
                responses = self._construct_response_list(gathered)
                resp_payload = encode_response_list(responses)
        resp_payload = self.cp.broadcast(resp_payload, self._cycle)
        self._cycle += 1
        if resp_payload == _SHUTDOWN:
            self._fail_all("controller shut down")
            return False
        responses = decode_response_list(resp_payload)
        if responses:
            self._execute_response_list(responses)
        return bool(to_send) or bool(responses)

    # -- coordinator logic ------------------------------------------------------
    def _construct_response_list(self, gathered: List[str]) -> List[Response]:
        for rank, raw in enumerate(gathered):
            bits_part, _, req_part = raw.partition("|")
            reqs = decode_request_list(req_part)
            if bits_part:
                for bit in map(int, bits_part.split(",")):
                    cached = self._cache.request_for_bit(bit)
                    if cached is not None:
                        reqs.append(dataclasses.replace(cached,
                                                        request_rank=rank))
            for req in reqs:
                req.request_rank = rank
                if req.request_type == RequestType.JOIN:
                    joined = self._joined.setdefault(req.process_set_id, {})
                    if rank not in joined:
                        joined[rank] = len(joined)
                    continue
                self._message_table.add(req)
                self._stall.record(req.tensor_name, rank)

        responses: List[Response] = []
        ready_keys: List[Tuple[int, str]] = []
        for key, by_rank in self._message_table.pending.items():
            ps_id = key[0]
            try:
                ps = basics._global_state().process_set_table.get(ps_id)
                ps_size = ps.size()
            except Exception:
                ps_size = self.cp.size()
            joined = self._joined.get(ps_id, {})
            if len(by_rank) + len([r for r in joined if r not in by_rank]) \
                    >= ps_size:
                ready_keys.append(key)

        # group all-or-nothing gate
        ready_group_names: Dict[int, set] = {}
        for key in ready_keys:
            req = next(iter(self._message_table.pending[key].values()))
            if req.group_id >= 0:
                ready_group_names.setdefault(req.group_id, set()).add(key[1])
        gated: List[Tuple[int, str]] = []
        for key in ready_keys:
            req = next(iter(self._message_table.pending[key].values()))
            if req.group_id >= 0:
                members = self._group_members.get(req.group_id)
                if members is not None and \
                        ready_group_names.get(req.group_id, set()) != members:
                    continue
            gated.append(key)

        for key in gated:
            by_rank = self._message_table.pending.pop(key)
            self._stall.resolve(key[1])
            responses.append(self._construct_response(key, by_rank))

        # JOIN responses: all ranks of a set joined and nothing pending
        for ps_id, joined in list(self._joined.items()):
            try:
                ps = basics._global_state().process_set_table.get(ps_id)
                ps_size = ps.size()
            except Exception:
                ps_size = self.cp.size()
            has_pending = any(k[0] == ps_id
                              for k in self._message_table.pending)
            if len(joined) >= ps_size and not has_pending:
                last = max(joined, key=lambda r: joined[r])
                responses.append(Response(RequestType.JOIN, [f"join.{ps_id}"],
                                          process_set_id=ps_id,
                                          last_joined_rank=last))
                del self._joined[ps_id]

        self._stall.check()
        responses.extend(self._abort_escalated_stalls())
        return self._fuse_responses(responses)

    def _abort_escalated_stalls(self) -> List[Response]:
        """Consume the escalation ladder (coordinator side): tensors past
        the abort threshold get an error response, so every waiting rank's
        synchronize() raises HorovodInternalError instead of the job
        hanging on one wedged rank."""
        if self._escalator is None:
            return []
        out: List[Response] = []
        names = self._escalator.drain_aborts()
        if names:
            for key in [k for k in list(self._message_table.pending)
                        if k[1] in names]:
                req = next(iter(self._message_table.pending.pop(key).values()))
                self._stall.resolve(key[1])
                out.append(Response(
                    req.request_type, [key[1]], process_set_id=key[0],
                    error_message=(
                        f"collective {key[1]} aborted: stalled past "
                        f"HVDT_STALL_ABORT_TIME_SECONDS (missing ranks "
                        f"never submitted)")))
        if self._escalator.reset_requested():
            from ..resilience.escalation import request_elastic_reset

            request_elastic_reset("stalled collective escalation")
        return out

    def _construct_response(self, key: Tuple[int, str],
                            by_rank: Dict[int, Request]) -> Response:
        """Validate cross-rank agreement and emit a Response."""
        ps_id, name = key
        reqs = list(by_rank.values())
        first = reqs[0]
        for other in reqs[1:]:
            if other.request_type != first.request_type:
                return Response(first.request_type, [name],
                                error_message=f"Mismatched collective type for "
                                f"tensor {name}.")
            if other.tensor_type != first.tensor_type:
                return Response(first.request_type, [name],
                                error_message=f"Mismatched data type for tensor "
                                f"{name}.")
            if other.descriptor() != first.descriptor():
                return Response(first.request_type, [name],
                                error_message=f"Mismatched shape/params for "
                                f"tensor {name}: {first.tensor_shape} vs "
                                f"{other.tensor_shape}.")
        rt = first.request_type
        resp = Response(rt, [name], tensor_type=first.tensor_type,
                        reduce_op=first.reduce_op,
                        prescale_factor=first.prescale_factor,
                        postscale_factor=first.postscale_factor,
                        root_rank=first.root_rank, process_set_id=ps_id)
        if rt in (RequestType.ALLGATHER, RequestType.ALLTOALL):
            try:
                ps = basics._global_state().process_set_table.get(ps_id)
                set_ranks = ps.ranks
            except Exception:
                set_ranks = list(range(self.cp.size()))
        if rt == RequestType.ALLGATHER:
            # per-set-rank dim0 sizes, joined ranks contribute 0 rows
            resp.tensor_shapes = [
                tuple(by_rank[r].tensor_shape) if r in by_rank
                else (0,) + tuple(first.tensor_shape[1:])
                for r in set_ranks]
        elif rt == RequestType.ALLTOALL:
            resp.recv_splits = [tuple(by_rank[r].splits) if r in by_rank
                                else (0,) * len(set_ranks)
                                for r in set_ranks]
            resp.tensor_shapes = [tuple(first.tensor_shape)]
        else:
            resp.tensor_shapes = [tuple(first.tensor_shape)]
        return resp

    def _fuse_responses(self, responses: List[Response]) -> List[Response]:
        """Pack compatible allreduce responses into fused responses up to the
        fusion threshold."""
        threshold = config.get_int("HVDT_FUSION_THRESHOLD")
        if not config.get_bool("HVDT_BATCH_COLLECTIVES"):
            return responses
        fused: List[Response] = []
        pending: Optional[Response] = None
        pending_bytes = 0

        def flush():
            nonlocal pending, pending_bytes
            if pending is not None:
                fused.append(pending)
            pending, pending_bytes = None, 0

        for resp in responses:
            fusible = (resp.response_type in (RequestType.ALLREDUCE,
                                              RequestType.ADASUM)
                       and not resp.error_message)
            if not fusible:
                flush()
                fused.append(resp)
                continue
            # A 0-d tensor counts 0 bytes, as in the JAX package.
            nbytes = (math.prod(resp.tensor_shapes[0])
                      * _itemsize(resp.tensor_type)
                      if resp.tensor_shapes[0] else 0)
            compatible = (
                pending is not None
                and pending.response_type == resp.response_type
                and pending.tensor_type == resp.tensor_type
                and pending.reduce_op == resp.reduce_op
                and pending.prescale_factor == resp.prescale_factor
                and pending.postscale_factor == resp.postscale_factor
                and pending.process_set_id == resp.process_set_id
                and pending_bytes + nbytes <= threshold)
            if compatible:
                pending.tensor_names.extend(resp.tensor_names)
                pending.tensor_shapes.extend(resp.tensor_shapes)
                pending_bytes += nbytes
            else:
                flush()
                pending = resp
                pending_bytes = nbytes
        flush()
        return fused

    # -- execution ----------------------------------------------------------
    def _execute_response_list(self, responses: List[Response]) -> None:
        for resp in responses:
            try:
                self._execute_response(resp)
            except Exception as e:
                log.exception("execution failed for %s", resp.tensor_names)
                self._fail_response(resp, f"{type(e).__name__}: {e}")

    def _pop_entries(self, resp: Response) -> List[Optional[_Entry]]:
        entries = []
        with self._lock:
            for name in resp.tensor_names:
                entries.append(self._entries.pop((resp.process_set_id, name),
                                                 None))
        return entries

    def _execute_response(self, resp: Response) -> None:
        # Profiler range per fused response, named by op and batch size
        # (HVDT_DISABLE_PROFILER_RANGES turns it off).
        if not config.get_bool("HVDT_DISABLE_PROFILER_RANGES"):
            label = (f"hvdt.{RequestType(resp.response_type).name}"
                     f".x{len(resp.tensor_names)}")
            with torch.profiler.record_function(label):
                self._execute_response_inner(resp)
            return
        self._execute_response_inner(resp)

    def _execute_response_inner(self, resp: Response) -> None:
        rt = resp.response_type
        if rt == RequestType.JOIN:
            with self._lock:
                handle = self._local_join_handles.pop(resp.process_set_id, None)
            if handle is not None:
                self.handles.mark_done(handle, Status.ok(),
                                       resp.last_joined_rank)
            return
        if rt == RequestType.BARRIER:
            for entry in self._pop_entries(resp):
                if entry is not None:
                    self._fr_close([entry])
                    self.handles.mark_done(entry.handle, Status.ok(), None)
            return
        if resp.error_message:
            self._fail_response(resp, resp.error_message)
            return

        entries = self._pop_entries(resp)
        tl = _timeline.current()
        if tl is not None:          # negotiation over, execution begins
            for name in resp.tensor_names:
                tl.end_activity(name)
                tl.start_activity(name, f"EXEC_{rt.name}",
                                  {"fused": len(resp.tensor_names)})
        from ..telemetry import instrument as _ti
        from ..telemetry import trace as _trace

        rec = _ti.get_recorder()
        tracer = _trace.get_tracer()
        t_exec0 = time.monotonic() if (rec is not None or
                                       tracer is not None) else 0.0
        if rec is not None:
            # Queue (enqueue -> announce), negotiate (announce ->
            # response) and execute summaries, and the response's bytes.
            item = _itemsize(resp.tensor_type)
            nbytes = sum(math.prod(shape) * item
                         for shape in (resp.tensor_shapes or []))
            dname = _dtype_label(resp.tensor_type)
            rec.record_collective(rt.name, dname, dname, nbytes,
                                  count=len(resp.tensor_names),
                                  path="eager")
            for entry in entries:
                if entry is None:
                    continue
                if entry.announce_ts is not None:
                    rec.observe_queue(entry.announce_ts - entry.enqueue_ts)
                    rec.observe_negotiate(t_exec0 - entry.announce_ts)
                else:
                    rec.observe_negotiate(t_exec0 - entry.enqueue_ts)
        try:
            with torch.profiler.record_function(
                    f"hvdt.{rt.name}.{resp.tensor_names[0]}"
                    + (f"+{len(resp.tensor_names)-1}" if
                       len(resp.tensor_names) > 1 else "")):
                self._dispatch(resp, entries)
        except Exception as e:
            # Entries are already popped here, so the outer
            # _fail_response cannot find them: fail their handles
            # directly or the callers' synchronize() would hang forever.
            self._fr_close(entries, status="error")
            for entry in entries:
                if entry is not None and not self.handles.poll(entry.handle):
                    self.handles.mark_done(
                        entry.handle,
                        Status.unknown(f"{type(e).__name__}: {e}"))
            raise
        else:
            self._fr_close(entries)
        finally:
            if rec is not None:
                rec.observe_execute(time.monotonic() - t_exec0)
            if tracer is not None:
                tracer.complete(
                    f"EXEC_{rt.name}:{resp.tensor_names[0]}",
                    time.monotonic() - t_exec0, cat="collective",
                    args={"fused": len(resp.tensor_names),
                          "tensors": list(resp.tensor_names[:4])})
            if tl is not None:
                for name, shape in zip(resp.tensor_names,
                                       resp.tensor_shapes or
                                       [()] * len(resp.tensor_names)):
                    tl.end_activity(name, {"shape": list(shape)})
        # coherent cache update on every rank, in execution order
        for name, shape in zip(resp.tensor_names, resp.tensor_shapes):
            req = Request(0, rt, name, resp.tensor_type, tuple(shape),
                          resp.reduce_op, resp.prescale_factor,
                          resp.postscale_factor, resp.root_rank,
                          (), resp.process_set_id, -1)
            self._cache.insert(req)

    @contextlib.contextmanager
    def _device_work(self):
        """Where the controller issues CUDA work: on its own stream, and
        never while a donated_step capture is open."""
        if self._stream is None:
            yield
            return
        with graphs.capture_lock, torch.cuda.stream(self._stream):
            yield

    def _input(self, entry: Optional[_Entry]) -> Optional[torch.Tensor]:
        """The entry's tensor on the set's device (None for a joined
        rank)."""
        if entry is None or entry.tensor is None:
            return None
        if entry.ready is not None:
            self._stream.wait_event(entry.ready)
        t = entry.tensor
        return t if t.device == self.device else t.to(self.device)

    def _dispatch(self, resp: Response, entries: List[Optional[_Entry]]) -> None:
        ps = basics._global_state().process_set_table.get(resp.process_set_id)
        if not ps.included():
            # responses broadcast to all ranks; non-members just skip
            return
        with self._device_work():
            done = self._compute(resp, entries, ps)
            results = [(entry, self._result(entry, out))
                       for entry, out in done if entry is not None]
            if self._stream is not None:
                self._stream.synchronize()
        for entry, result in results:
            self.handles.mark_done(entry.handle, Status.ok(), result)

    def _compute(self, resp: Response, entries: List[Optional[_Entry]],
                 ps: ProcessSet) -> List[Tuple[Optional[_Entry], Any]]:
        """Run the response's collective; returns (entry, output on the
        set's device) pairs."""
        rt = resp.response_type
        dtype = torch_dtype_of(resp.tensor_type)
        dev = self.device
        single = ps.size() == 1

        def zeros(shape):
            return torch.zeros(tuple(shape), dtype=dtype, device=dev)

        if rt in (RequestType.ALLREDUCE, RequestType.ADASUM):
            op = ReduceOp(resp.reduce_op)
            values = []
            for shape, entry in zip(resp.tensor_shapes, entries):
                v = self._input(entry)
                if v is None:
                    # joined rank: contribute the reduction's identity
                    v = torch.full(tuple(shape),
                                   hostc._identity_value(op, dtype),
                                   dtype=dtype, device=dev)
                values.append(v)
            pre, post = resp.prescale_factor, resp.postscale_factor
            if pre != 1.0:
                values = [_scaled(v, pre) for v in values]
            # a fused response is one flat buffer (a copy: the results
            # never alias the inputs) and one collective
            red = torch.cat([v.reshape(-1) for v in values])
            if not single and op == ReduceOp.ADASUM:
                from .adasum import host_adasum

                red = host_adasum(red, ps)
            elif not single:
                red = hostc.host_allreduce(red, ps, op)
            outs = []
            off = 0
            for shape in resp.tensor_shapes:
                n = math.prod(shape)
                outs.append(red[off:off + n].view(tuple(shape)))
                off += n
            if post != 1.0:
                outs = [_scaled(o, post) for o in outs]
            return list(zip(entries, outs))
        entry = entries[0]
        v = self._input(entry)
        if rt == RequestType.ALLGATHER:
            if single:
                out = v.clone() if v is not None else zeros((0,))
            else:
                my = v if v is not None else \
                    zeros((0,) + tuple(resp.tensor_shapes[0][1:]))
                out = hostc.host_allgather(
                    my, ps, [s[0] for s in resp.tensor_shapes])
        elif rt == RequestType.BROADCAST:
            shape = tuple(resp.tensor_shapes[0])
            if single:
                out = v.clone() if v is not None else zeros(shape)
            else:
                out = hostc.host_broadcast(v, resp.root_rank, ps, shape,
                                           dtype, dev)
        elif rt == RequestType.ALLTOALL:
            all_splits = [list(s) for s in resp.recv_splits]
            if single:
                out = v.clone() if v is not None else zeros((0,))
                recv = [out.shape[0]] if out.ndim else [0]
            else:
                # joined rank: zero-row contribution with zero splits
                my = v if v is not None else \
                    zeros((0,) + tuple(resp.tensor_shapes[0][1:]))
                out, recv = hostc.host_alltoall(my, all_splits[ps.rank()],
                                                ps, all_splits)
            out = (out, recv)
        elif rt == RequestType.REDUCESCATTER:
            op = ReduceOp(resp.reduce_op)
            if single:
                out = v.clone() if v is not None else zeros((0,))
            else:
                my = v if v is not None else torch.full(
                    tuple(resp.tensor_shapes[0]),
                    hostc._identity_value(op, dtype), dtype=dtype,
                    device=dev)
                out = hostc.host_reducescatter(my, ps, op)
        else:
            raise HorovodInternalError(f"Unknown response type {rt}")
        return [(entry, out)]

    @staticmethod
    def _result(entry: _Entry, out: Any) -> Any:
        """``out`` in the input's type: a tensor on the input's device, or
        a numpy array; alltoall's (output, recv_splits) pair keeps its
        splits."""
        if isinstance(out, tuple):
            return (EagerController._result(entry, out[0]), out[1])
        if entry.np_dtype is not None:
            return _to_numpy(out, entry.np_dtype)
        want = entry.tensor.device
        return out if out.device == want else out.to(want)

    def _fr_close(self, entries, status: str = "done") -> None:
        """Close the flight-recorder events opened at enqueue for these
        entries (no-op when the recorder is off)."""
        from ..telemetry import flight_recorder as _frm

        flight = _frm.get_flight_recorder()
        if flight is None:
            return
        for e in entries:
            if e is not None and e.fr_seq is not None:
                flight.record_end(e.fr_seq, status=status)
                e.fr_seq = None

    def _fail_response(self, resp: Response, message: str) -> None:
        for entry in self._pop_entries(resp):
            if entry is not None:
                self._fr_close([entry], status="error")
                self.handles.mark_done(entry.handle,
                                       Status.unknown(message))
        tl = _timeline.current()
        if tl is not None:
            for name in resp.tensor_names:
                tl.instant(name, "ERROR", {"message": message})

    def _fail_all(self, message: str) -> None:
        with self._lock:
            self._running = False
            entries = list(self._entries.values())
            self._entries.clear()
        self._fr_close(entries, status="error")
        for e in entries:
            self.handles.mark_done(e.handle, Status.unknown(message))
        self.handles.abort_all(message)

    # -- group registration -------------------------------------------------
    def register_group(self, group_id: int, names: Sequence[str]) -> None:
        self._group_members[group_id] = set(names)

    def shutdown(self) -> None:
        """Stop the controller.  With peers, its last cycle tells every
        rank's controller to stop too (pending collectives fail)."""
        with self._lock:
            self._stop_requested = True
        self._wake.set()
        self._thread.join(timeout=5)
        self._running = False
        self.handles.abort_all("controller shut down")
        self.cp.shutdown()


def _scaled(t: torch.Tensor, factor: float) -> torch.Tensor:
    """``t * factor`` with the factor first cast to ``t``'s dtype, as the
    JAX package's ``v * np.asarray(factor, v.dtype)`` does (an integer
    tensor's factor truncates)."""
    return t * torch.tensor(factor, dtype=t.dtype)


def _to_numpy(t: torch.Tensor, np_dtype: np.dtype) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:       # numpy's bfloat16 is ml_dtypes'
        return t.view(torch.int16).numpy().view(np_dtype)
    return t.numpy()


# ---------------------------------------------------------------------------
# Module-level controller lifecycle
# ---------------------------------------------------------------------------

def _controller() -> EagerController:
    """The process's controller, started by the first eager call.  Every
    eager call comes here first, so one inside a CUDA-graph capture
    raises before it touches the card."""
    state = basics._global_state()
    if not state.initialized:
        raise NotInitializedError()
    if graphs.capturing():
        raise RuntimeError(
            "an eager collective cannot run inside a CUDA graph capture: "
            "its negotiation happens on the host, which a replay does not "
            "re-run; use horovod_tpu_torch.device collectives (or "
            "DistributedOptimizer) in a captured step")
    with state.lock:
        if state.eager_controller is None:
            state.eager_controller = EagerController()
        return state.eager_controller


def shutdown_controller() -> None:
    state = basics._global_state()
    with state.lock:
        if state.eager_controller is not None:
            state.eager_controller.shutdown()
            state.eager_controller = None


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

_name_counters: Dict[str, Any] = collections.defaultdict(itertools.count)


def _auto_name(kind: str, name: Optional[str]) -> str:
    """Deterministic auto-naming — identical across ranks as long as ops are
    issued in the same order."""
    if name is not None:
        return name
    return f"{kind}.noname.{next(_name_counters[kind])}"


def _prep(tensor, events: Optional[Dict] = None
          ) -> Tuple[torch.Tensor, Optional[np.dtype],
                     Optional[torch.cuda.Event]]:
    """(the tensor to send, the numpy dtype of a numpy input, the event a
    CUDA input's producer stream reached).  ``events`` shares one event
    per stream among the tensors of one call."""
    if isinstance(tensor, torch.Tensor):
        t = tensor.detach()
        data_type_of(t)
        if t.is_cuda and basics.topology().device.type != "cuda":
            raise ValueError(
                f"a CUDA tensor ({t.device}) in a CPU (gloo) world: the "
                "eager plane carries CUDA tensors over NCCL only; init() "
                "on the card, or pass a CPU tensor")
        t = t.contiguous()
        ready = None
        if t.is_cuda:
            stream = torch.cuda.current_stream(t.device)
            ready = (events or {}).get(stream)
            if ready is None:
                ready = torch.cuda.Event()
                ready.record(stream)
                if events is not None:
                    events[stream] = ready
        return t, None, ready
    value = np.array(tensor, order="C")     # a copy the caller cannot touch
    data_type_of(value)
    if value.dtype.name == "bfloat16":
        return (torch.from_numpy(value.view(np.int16)).view(torch.bfloat16),
                value.dtype, None)
    return torch.from_numpy(value), value.dtype, None


def _resolve_op(op, average):
    if op is not None and average is not None:
        raise ValueError("Specify either op or average, not both")
    if op is None:
        if average is None or average:
            return ReduceOp.AVERAGE
        return ReduceOp.SUM
    return ReduceOp(op)


def _check_adasum(op: ReduceOp, ps: ProcessSet) -> None:
    """Adasum over a set whose size is not a power of two raises here,
    at the call site and before anything is enqueued, on every rank."""
    n = ps.size()
    if op == ReduceOp.ADASUM and n & (n - 1):
        raise ValueError(
            f"Adasum requires a power-of-2 rank count, got {n}")


def _no_adasum(op: ReduceOp) -> None:
    """Adasum is an allreduce: a reducescatter asking for it raises
    here, at the call site and before anything is enqueued, so no peer
    is left waiting in a negotiation."""
    if op == ReduceOp.ADASUM:
        raise ValueError("Adasum is an allreduce (hvd.allreduce / "
                         "grouped_allreduce); reducescatter takes Sum, "
                         "Average, Min, Max or Product")


def allreduce_async(tensor, average=None, name: Optional[str] = None,
                    op=None, prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0,
                    process_set: Optional[ProcessSet] = None) -> int:
    """Asynchronously allreduce a named tensor across ranks."""
    ctl = _controller()
    ps = process_set or global_process_set()
    rop = _resolve_op(op, average)
    _check_adasum(rop, ps)
    value, np_dtype, ready = _prep(tensor)
    req = Request(ctl.cp.rank(),
                  RequestType.ADASUM if rop == ReduceOp.ADASUM
                  else RequestType.ALLREDUCE,
                  _auto_name("allreduce", name), int(data_type_of(value)),
                  tuple(value.shape), int(rop), prescale_factor,
                  postscale_factor, process_set_id=ps.id)
    return ctl.enqueue(req, value, np_dtype, ready)


def allreduce(tensor, average=None, name: Optional[str] = None, op=None,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0,
              process_set: Optional[ProcessSet] = None):
    return synchronize(allreduce_async(tensor, average, name, op,
                                       prescale_factor, postscale_factor,
                                       process_set))


def grouped_allreduce_async(tensors: Sequence, average=None,
                            name: Optional[str] = None, op=None,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0,
                            process_set: Optional[ProcessSet] = None,
                            group_id: Optional[int] = None) -> List[int]:
    """Grouped allreduce: all-or-nothing fusion.

    ``group_id`` lets callers with a fixed group structure reuse a stable
    id: the coordinator's all-or-nothing gate keys member-name sets by
    group id, so a caller whose groups may be ISSUED in different orders
    on different ranks must pre-allocate ids deterministically instead of
    taking a fresh one per call."""
    ctl = _controller()
    ps = process_set or global_process_set()
    rop = _resolve_op(op, average)
    _check_adasum(rop, ps)
    events: Dict = {}
    prepped = [_prep(t, events) for t in tensors]
    gid = ctl.next_group_id() if group_id is None else int(group_id)
    base = _auto_name("grouped_allreduce", name)
    names = [f"{base}.{i}" for i in range(len(prepped))]
    ctl.register_group(gid, names)
    return ctl.enqueue_all([
        (Request(ctl.cp.rank(), RequestType.ALLREDUCE, nm,
                 int(data_type_of(value)), tuple(value.shape), int(rop),
                 prescale_factor, postscale_factor, process_set_id=ps.id,
                 group_id=gid), value, np_dtype, ready)
        for nm, (value, np_dtype, ready) in zip(names, prepped)])


def grouped_allreduce(tensors: Sequence, **kwargs) -> List:
    return [synchronize(h) for h in grouped_allreduce_async(tensors, **kwargs)]


def allgather_async(tensor, name: Optional[str] = None,
                    process_set: Optional[ProcessSet] = None) -> int:
    ctl = _controller()
    ps = process_set or global_process_set()
    value, np_dtype, ready = _prep(tensor)
    req = Request(ctl.cp.rank(), RequestType.ALLGATHER,
                  _auto_name("allgather", name), int(data_type_of(value)),
                  tuple(value.shape), process_set_id=ps.id)
    return ctl.enqueue(req, value, np_dtype, ready)


def allgather(tensor, name: Optional[str] = None,
              process_set: Optional[ProcessSet] = None):
    return synchronize(allgather_async(tensor, name, process_set))


def broadcast_async(tensor, root_rank: int, name: Optional[str] = None,
                    process_set: Optional[ProcessSet] = None) -> int:
    ctl = _controller()
    ps = process_set or global_process_set()
    value, np_dtype, ready = _prep(tensor)
    req = Request(ctl.cp.rank(), RequestType.BROADCAST,
                  _auto_name("broadcast", name), int(data_type_of(value)),
                  tuple(value.shape), root_rank=root_rank,
                  process_set_id=ps.id)
    return ctl.enqueue(req, value, np_dtype, ready)


def broadcast(tensor, root_rank: int, name: Optional[str] = None,
              process_set: Optional[ProcessSet] = None):
    return synchronize(broadcast_async(tensor, root_rank, name, process_set))


def alltoall_async(tensor, splits: Optional[Sequence[int]] = None,
                   name: Optional[str] = None,
                   process_set: Optional[ProcessSet] = None) -> int:
    ctl = _controller()
    ps = process_set or global_process_set()
    value, np_dtype, ready = _prep(tensor)
    if splits is None:
        n = value.shape[0]
        p = ps.size()
        base, rem = divmod(n, p)
        splits = [base + (1 if i < rem else 0) for i in range(p)]
    if int(sum(splits)) != value.shape[0]:
        raise ValueError(
            f"splits sum ({sum(splits)}) != tensor dim0 ({value.shape[0]})")
    req = Request(ctl.cp.rank(), RequestType.ALLTOALL,
                  _auto_name("alltoall", name), int(data_type_of(value)),
                  tuple(value.shape), splits=tuple(int(s) for s in splits),
                  process_set_id=ps.id)
    return ctl.enqueue(req, value, np_dtype, ready)


def alltoall(tensor, splits: Optional[Sequence[int]] = None,
             name: Optional[str] = None,
             process_set: Optional[ProcessSet] = None):
    """Returns (output, recv_splits)."""
    return synchronize(alltoall_async(tensor, splits, name, process_set))


def reducescatter_async(tensor, op=ReduceOp.SUM, name: Optional[str] = None,
                        process_set: Optional[ProcessSet] = None) -> int:
    ctl = _controller()
    ps = process_set or global_process_set()
    _no_adasum(ReduceOp(op))
    value, np_dtype, ready = _prep(tensor)
    req = Request(ctl.cp.rank(), RequestType.REDUCESCATTER,
                  _auto_name("reducescatter", name),
                  int(data_type_of(value)), tuple(value.shape),
                  int(ReduceOp(op)), process_set_id=ps.id)
    return ctl.enqueue(req, value, np_dtype, ready)


def reducescatter(tensor, op=ReduceOp.SUM, name: Optional[str] = None,
                  process_set: Optional[ProcessSet] = None):
    return synchronize(reducescatter_async(tensor, op, name, process_set))


def barrier(process_set: Optional[ProcessSet] = None) -> None:
    """Block until all ranks reach the barrier."""
    ctl = _controller()
    ps = process_set or global_process_set()
    req = Request(ctl.cp.rank(), RequestType.BARRIER,
                  _auto_name("barrier", None), 0, (), process_set_id=ps.id)
    synchronize(ctl.enqueue(req, None))


def join(process_set: Optional[ProcessSet] = None) -> int:
    """Signal this rank has no more work; block until all ranks join.
    Returns the last rank to join."""
    ps = process_set or global_process_set()
    return synchronize(_controller().enqueue_join(ps))


def poll(handle: int) -> bool:
    """True once the handle's collective has finished on the device."""
    return _controller().handles.poll(handle)


def synchronize(handle: int, timeout: Optional[float] = None):
    """Wait for the handle's result.  A CUDA result is handed over to the
    caller's current stream (its memory is not reused by the controller's
    stream until the caller's work queued so far is done)."""
    out = _controller().handles.synchronize(handle, timeout)
    t = out[0] if isinstance(out, tuple) else out
    if isinstance(t, torch.Tensor) and t.is_cuda:
        t.record_stream(torch.cuda.current_stream(t.device))
    return out
