"""Process model, topology and lifecycle — the ``init()`` layer.

The PyTorch counterpart of the JAX package's ``common/basics.py``.  The
process group is ``torch.distributed``: NCCL when the process runs on a
CUDA device, gloo when the caller asks for ``device="cpu"``.

``init`` reads the same launcher env contract as the JAX package
(``HVDT_SIZE``, ``HVDT_RANK``, ``HVDT_LOCAL_*``, ``HVDT_CROSS_*``,
``HVDT_COORDINATOR_ADDR``) and falls back to torchrun's ``RANK`` /
``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR``.  With neither set it
makes a one-process world over an in-process store, with no networking.
It also resolves ``HVDT_COMPRESSION`` / ``HVDT_QUANT`` and parses
``HVDT_TRANSPORT``, so an unknown compressor name or transport
vocabulary fails at init.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import os
import threading
from typing import List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from . import config
from .exceptions import NotInitializedError

__all__ = [
    "init",
    "shutdown",
    "is_initialized",
    "rank",
    "size",
    "local_rank",
    "local_size",
    "cross_rank",
    "cross_size",
    "Topology",
    "topology",
    "num_devices",
    "local_devices",
    "global_devices",
    "is_homogeneous",
    "resolve_device",
    "current_mesh",
    "set_mesh",
]

DeviceLike = Union[str, torch.device, None]


@dataclasses.dataclass(frozen=True)
class Topology:
    """Static process topology, fixed at init."""

    rank: int
    size: int
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int
    device: torch.device


class _GlobalState:
    def __init__(self) -> None:
        self.lock = threading.RLock()
        self.initialized = False
        self.topology: Optional[Topology] = None
        self.process_set_table = None
        self.owns_group = False
        # The c10d store the process group was made over: the eager
        # control plane's transport (ops/control_plane.py).
        self.store: Optional[dist.Store] = None
        self.eager_controller = None
        # The DeviceMesh parallel.mesh.make_mesh (or set_mesh) recorded.
        self.mesh = None

    def reset(self) -> None:
        self.initialized = False
        self.topology = None
        self.process_set_table = None
        self.owns_group = False
        self.store = None
        self.eager_controller = None
        self.mesh = None


_state = _GlobalState()


def _global_state() -> _GlobalState:
    return _state


def resolve_device(device: DeviceLike = None,
                   index: Optional[int] = None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another device.  Raises when no card is present and the caller
    did not ask for the CPU — the port never carries on there silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device(
            "cuda", torch.cuda.current_device() if index is None else index)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev


def _env_int(*names: str) -> int:
    """First of ``names`` set in the environment, as an int; -1 if none."""
    for name in names:
        raw = os.environ.get(name)
        if raw:
            try:
                return int(raw)
            except ValueError:
                continue
    return -1


def _mesh_axes_from_env(world: int):
    """``HVDT_MESH_AXES`` ('dp=2,tp=2') as ``(names, sizes)`` in the order
    given, or None when unset; its product must be the world size."""
    spec = config.get_str("HVDT_MESH_AXES")
    if not spec:
        return None
    names, sizes = [], []
    for part in spec.split(","):
        name, _, sz = part.strip().partition("=")
        names.append(name)
        sizes.append(int(sz))
    total = 1
    for n in sizes:
        total *= n
    if total != world:
        raise ValueError(
            f"HVDT_MESH_AXES product {total} != device count {world}")
    return tuple(names), tuple(sizes)


def init(*, device: DeviceLike = None,
         coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None,
         process_sets: Optional[Sequence[Sequence[int]]] = None) -> None:
    """Initialize the framework: join (or make) the process group and
    build the process-set table.

    Args:
      device: where this process computes.  Default: the CUDA card of the
        local rank (NCCL); ``"cpu"`` selects gloo.
      coordinator_address: ``host:port`` of the rendezvous store for a
        multi-process world.  Defaults to ``HVDT_COORDINATOR_ADDR``, then
        to torchrun's ``MASTER_ADDR``/``MASTER_PORT``.
      num_processes / process_id: override the env contract.
      process_sets: rank lists to register as process sets at init.

    With ``HVDT_MESH_AXES`` set ('dp=2,tp=2'), a ``DeviceMesh`` over the
    world with those dimensions, in that order, becomes the current mesh
    (:func:`current_mesh`), as ``parallel.make_mesh`` would make it.
    """
    with _state.lock:
        if _state.initialized:
            return
        # Resolve the wire compression now, so that an unknown
        # HVDT_COMPRESSION fails here with the valid list and not at the
        # first optimizer step on some rank.
        from ..ops.compression import Compression

        Compression.from_env()
        # HVDT_TRANSPORT too: unknown vocabulary fails here, on every
        # rank, with the valid lists.
        from ..transport import validate_env

        validate_env()
        # HVDT_ZERO likewise: an unknown stage fails here.
        from ..ops import zero

        zero.validate_env()
        env_size = config.get_int("HVDT_SIZE")
        if env_size <= 0:
            env_size = _env_int("WORLD_SIZE")
        env_rank = config.get_int("HVDT_RANK")
        if env_rank < 0:
            env_rank = _env_int("RANK")
        n_proc = num_processes if num_processes is not None else (
            env_size if env_size > 0 else 1)
        proc_id = process_id if process_id is not None else (
            env_rank if env_rank >= 0 else 0)
        mesh_axes = _mesh_axes_from_env(
            dist.get_world_size() if dist.is_initialized() else n_proc)

        local_rank_ = config.get_int("HVDT_LOCAL_RANK")
        local_size_ = config.get_int("HVDT_LOCAL_SIZE")
        cross_rank_ = config.get_int("HVDT_CROSS_RANK")
        cross_size_ = config.get_int("HVDT_CROSS_SIZE")
        if local_rank_ < 0 and _env_int("LOCAL_RANK") >= 0:
            local_rank_ = _env_int("LOCAL_RANK")
            local_size_ = max(_env_int("LOCAL_WORLD_SIZE"), 1)
            cross_size_ = max(n_proc // local_size_, 1)
            cross_rank_ = proc_id // local_size_
        if local_rank_ < 0:
            local_rank_, local_size_ = 0, 1
            cross_rank_, cross_size_ = proc_id, n_proc

        dev = resolve_device(
            device, index=local_rank_ % max(torch.cuda.device_count(), 1))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        # Failure detection is bounded: a collective on a dead peer fails
        # after HVDT_CONTROL_PLANE_TIMEOUT_S, and NCCL's watchdog then
        # aborts the communicator and raises (mode 2, "clean up only")
        # rather than killing the process, so elastic.run can restore.
        pg_timeout = datetime.timedelta(
            seconds=config.get_float("HVDT_CONTROL_PLANE_TIMEOUT_S"))
        if backend == "nccl":
            os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "2")

        owns = False
        if dist.is_initialized():
            proc_id, n_proc = dist.get_rank(), dist.get_world_size()
            # The caller made the group: reach the store it was made over
            # through torch.distributed.distributed_c10d._get_default_store
            # (PyTorch's own accessor for the default group's store).
            store = dist.distributed_c10d._get_default_store()
        elif n_proc > 1:
            coord = (coordinator_address
                     or config.get_str("HVDT_COORDINATOR_ADDR"))
            if coord:
                host, port = coord.rsplit(":", 1)
            elif os.environ.get("MASTER_ADDR"):
                host = os.environ["MASTER_ADDR"]
                port = os.environ.get("MASTER_PORT", "29500")
            else:
                raise ValueError(
                    f"a {n_proc}-process world needs a rendezvous: set "
                    "HVDT_COORDINATOR_ADDR (host:port) or MASTER_ADDR/"
                    "MASTER_PORT")
            store = dist.TCPStore(host, int(port), n_proc,
                                  is_master=proc_id == 0,
                                  timeout=dist.constants.default_pg_timeout)
            dist.init_process_group(backend, store=store, rank=proc_id,
                                    world_size=n_proc, timeout=pg_timeout)
            owns = True
        else:
            store = dist.HashStore()
            dist.init_process_group(backend, store=store, rank=0,
                                    world_size=1, timeout=pg_timeout)
            owns = True

        topo = Topology(rank=proc_id, size=n_proc, local_rank=local_rank_,
                        local_size=local_size_, cross_rank=cross_rank_,
                        cross_size=cross_size_, device=dev)
        from . import process_sets as ps

        _state.topology = topo
        _state.owns_group = owns
        _state.store = store
        _state.process_set_table = ps.ProcessSetTable(topo)
        for ranks in process_sets or ():
            _state.process_set_table.add(list(ranks))
        _state.initialized = True
        if mesh_axes is not None:
            from torch.distributed.device_mesh import init_device_mesh

            names, sizes = mesh_axes
            _state.mesh = init_device_mesh(dev.type, sizes,
                                           mesh_dim_names=names)

        # Telemetry exporter (HVDT_TELEMETRY=1): per-worker /metrics +
        # /healthz on HVDT_METRICS_PORT + local_rank.  No-op when the
        # subsystem is off; never raises (observability must not sink
        # init).
        from ..telemetry.exporter import maybe_start_exporter

        maybe_start_exporter(topology=topo)


def shutdown() -> None:
    """Tear down: flushes the span trace (``HVDT_TRACE_DIR``), stops the
    telemetry exporter and the eager controller, then destroys the
    process group if ``init`` made it."""
    from ..ops.eager import shutdown_controller
    from ..telemetry import trace as _trace
    from ..telemetry.exporter import stop_exporter

    try:
        # Final span flush: the per-rank Chrome-trace file into
        # HVDT_TRACE_DIR and the KV publish for the driver-side merge
        # (no-op when tracing is off; never sinks shutdown).
        _trace.flush()
    except Exception:
        pass
    stop_exporter()
    shutdown_controller()
    with _state.lock:
        if not _state.initialized:
            return
        owns = _state.owns_group
        _state.reset()
    if owns and dist.is_initialized():
        dist.destroy_process_group()


atexit.register(shutdown)


def current_mesh():
    """The ``DeviceMesh`` :func:`parallel.mesh.make_mesh` (or
    :func:`set_mesh`) recorded, or None."""
    return _state.mesh


def set_mesh(mesh) -> None:
    """Adopt ``mesh`` (a ``DeviceMesh`` over the world, or None) as the
    current mesh: its dimension names are the reduce group a transport
    policy resolves for ``fused_allreduce``."""
    with _state.lock:
        _state.mesh = mesh


def _topo() -> Topology:
    t = _state.topology
    if t is None:
        raise NotInitializedError()
    return t


def is_initialized() -> bool:
    return _state.initialized


def topology() -> Topology:
    return _topo()


def rank() -> int:
    return _topo().rank


def size() -> int:
    return _topo().size


def local_rank() -> int:
    return _topo().local_rank


def local_size() -> int:
    return _topo().local_size


def cross_rank() -> int:
    return _topo().cross_rank


def cross_size() -> int:
    return _topo().cross_size


def num_devices() -> int:
    """Devices of the world: one a process (its CUDA card, or the CPU in
    a gloo world)."""
    return _topo().size


def is_homogeneous() -> bool:
    """Whether every host runs the same number of processes."""
    t = _topo()
    return t.size == t.local_size * t.cross_size or t.size == 1


def local_devices() -> List[torch.device]:
    """The devices of this process: its CUDA card, or the CPU."""
    return [_topo().device]


def global_devices() -> List[torch.device]:
    """The device of every rank, in rank order, for ranks laid out host
    by host (rank = cross_rank * local_size + local_rank, as the
    launchers lay them out)."""
    t = _topo()
    if t.device.type != "cuda":
        return [t.device] * t.size
    n = max(torch.cuda.device_count(), 1)
    return [torch.device("cuda", (r % t.local_size) % n)
            for r in range(t.size)]
