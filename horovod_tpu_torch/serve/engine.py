"""Shape-bucketed inference engine: one CUDA graph a bucket, pad-to-bucket,
hot swap.

The port's counterpart of the JAX package's ``serve/engine.py``.  Serving
latency on an accelerator is lost on the host: a request path whose batch
size floats freely re-launches a forward op by op (or, in the reference,
recompiles it) for every new shape.  The engine's contract engineers that
away:

* **Shape buckets** — ``apply_fn`` runs at a small fixed ladder of batch
  sizes (default 1/8/32, knob ``HVDT_SERVE_BUCKETS``); every batch is
  padded up to the smallest admitting bucket.  On the card each
  ``(bucket, feature shape, dtype)`` key is captured once as a CUDA graph:
  its first use runs eagerly under ``torch.inference_mode`` (that creates
  the cuBLAS workspaces and builds the kernels), its second use captures,
  and every later call copies the padded batch into the graph's static
  input, replays, and copies the real rows of the static output to host
  numpy.  ``serve_compiles_total`` counts captures, one a key; on the CPU,
  where nothing is captured, it counts the first use of a key, as the
  reference counts its compiles.  Steady-state traffic touches only
  captured keys: the counter stays flat.
* **Hot weight swap** — :meth:`swap_params` copies new weights into the
  served tensors in place (a graph reads the storage it captured:
  rebinding the parameters would leave every graph serving the old
  weights).  It checks names, shapes and dtypes first and raises
  ``ValueError`` on a mismatch, then waits for the replays in flight and
  copies on the replay stream while no replay runs.  A batch therefore
  sees the old weights whole or the new weights whole, as in the
  reference, and a swap never recaptures.
* **Mesh** — given a ``DeviceMesh`` (``parallel.make_mesh``), every member
  calls :meth:`infer` on the same batch.  When the bucket divides the
  data axes of ``batch_spec(mesh, rules=transformer_rules(fsdp=True))``
  each member runs its rows through its own capture and the rows are
  all-gathered over those axes; otherwise every member runs the whole
  bucket.  ``tp`` never splits the batch.  The parameters are the
  caller's: replicated, one copy a member.

Concurrency: any number of threads may call :meth:`infer`.  A key's
copy-in → replay → copy-out runs under that key's lock (its static input
and output are shared), and every replay holds the engine's gate shared;
a swap or a capture holds it exclusively.  What a capture freezes: every
host read inside ``apply_fn`` (knobs such as ``HVDT_FLASH_SMALLSEQ`` and
``HVDT_FLASH_ATTENTION``) is read when the key is captured.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, \
    Sequence, Tuple

import numpy as np
import torch

from ..common import config
from ..common.logging_util import get_logger
from .metrics import MetricsRegistry

__all__ = ["InferenceEngine", "parse_buckets"]

log = get_logger(__name__)


def parse_buckets(spec: Optional[str] = None) -> Tuple[int, ...]:
    """Bucket ladder from a comma list (default: the HVDT_SERVE_BUCKETS
    knob).  Sorted ascending, deduplicated, all >= 1."""
    if spec is None:
        spec = config.get_str("HVDT_SERVE_BUCKETS")
    sizes = sorted({int(s) for s in str(spec).split(",") if s.strip()})
    if not sizes or sizes[0] < 1:
        raise ValueError(f"invalid bucket spec {spec!r}: need sizes >= 1")
    return tuple(sizes)


class _Gate:
    """Shared / exclusive gate: replays run shared; a swap or a capture
    runs exclusively, after the replays in flight and before new ones."""

    def __init__(self):
        self._cond = threading.Condition()
        self._shared = 0
        self._exclusive = False

    @contextlib.contextmanager
    def shared(self) -> Iterator[None]:
        with self._cond:
            while self._exclusive:
                self._cond.wait()
            self._shared += 1
        try:
            yield
        finally:
            with self._cond:
                self._shared -= 1
                if not self._shared:
                    self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self) -> Iterator[None]:
        with self._cond:
            while self._exclusive:
                self._cond.wait()
            self._exclusive = True          # new replays wait from here
            while self._shared:
                self._cond.wait()
        try:
            yield
        finally:
            with self._cond:
                self._exclusive = False
                self._cond.notify_all()


class _Key:
    """One ``(bucket, feature shape, dtype)``: its lock, its use count and,
    on the card, its graph with the static input and output."""

    __slots__ = ("lock", "uses", "graph", "x", "y")

    def __init__(self):
        self.lock = threading.Lock()
        self.uses = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.x: Optional[torch.Tensor] = None
        self.y: Optional[torch.Tensor] = None


def _leaves(params: Any) -> Dict[str, torch.Tensor]:
    """The served tensors by name: a module's ``state_dict`` (its tensors
    share the parameters' storage) or a mapping's tensor values."""
    if isinstance(params, torch.nn.Module):
        return dict(params.state_dict())
    if isinstance(params, Mapping):
        return {str(k): v for k, v in params.items()
                if isinstance(v, torch.Tensor)}
    raise TypeError(f"params must be a torch.nn.Module or a mapping of "
                    f"tensors, got {type(params).__name__}")


def _host(y: torch.Tensor) -> np.ndarray:
    """Host numpy of ``y``.  A card's output lands in pinned memory from
    PyTorch's caching host allocator (a pageable copy runs at a fraction
    of the link's rate); the array keeps its block alive until it dies."""
    if y.dtype in (torch.bfloat16, torch.float16):
        y = y.float()
    if not y.is_cuda:
        return y.numpy()
    out = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
    out.copy_(y, non_blocking=True)
    torch.cuda.current_stream(y.device).synchronize()
    return out.numpy()


class InferenceEngine:
    """Serve ``apply_fn(params, x) -> y`` with bucketed batch shapes.

    ``params`` is a ``torch.nn.Module`` (``models.mlp_init``,
    ``models.transformer_init``) or a mapping of tensors; the engine
    serves on the device they lie on.  ``apply_fn`` must be
    shape-polymorphic over the leading (batch) dimension of ``x`` — as
    ``models.mlp_apply`` and ``models.transformer_apply`` are — and
    free of host synchronization, so that it can be captured.

    :meth:`infer` takes and returns host numpy, as the reference's does.
    """

    def __init__(self, apply_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                 params: Any, *,
                 buckets: Optional[Sequence[int]] = None,
                 mesh: Optional[Any] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 compile_cache: Optional[str] = None):
        from ..step_pipeline import enable_compilation_cache

        enable_compilation_cache(compile_cache)
        self._apply_fn = apply_fn
        self.buckets = parse_buckets(",".join(map(str, buckets))
                                     if buckets is not None else None)
        self.mesh = mesh
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._compiles = self.metrics.counter(
            "serve_compiles_total",
            "Bucket captures (one CUDA graph a key; first uses of a key "
            "on the CPU) — flat after warmup means the shape buckets "
            "are doing their job")
        self._infers = self.metrics.counter(
            "serve_engine_batches_total", "Batches executed by the engine")
        self._pad_rows = self.metrics.counter(
            "serve_pad_rows_total",
            "Padding rows added to reach bucket sizes (wasted compute)")
        self._params = params
        self._leaves = _leaves(params)
        if not self._leaves:
            raise ValueError("params hold no tensor to serve from")
        self.device = next(iter(self._leaves.values())).device
        self._graphed = self.device.type == "cuda"
        self._stream = (torch.cuda.Stream(self.device) if self._graphed
                        else None)
        self._pool = None
        self._lock = threading.Lock()
        self._gate = _Gate()
        self._keys: Dict[tuple, _Key] = {}
        self._version = 0

    # ---- params ---------------------------------------------------------
    def params_template(self) -> Dict[str, torch.Tensor]:
        """The served tensors by name — the tree a checkpoint of these
        weights holds (``model.state_dict()``) and the restore template
        of :class:`~horovod_tpu_torch.serve.reload.CheckpointWatcher`."""
        return dict(self._leaves)

    def swap_params(self, params: Any) -> int:
        """Copy new weights into the served tensors; returns the new
        version.

        ``params`` is a module or a mapping (a ``state_dict``; numpy
        values are taken as tensors) with the served names, shapes and
        dtypes; anything else raises ``ValueError`` before a byte is
        copied.  The copy waits for the replays in flight, runs while
        no replay does, and is complete on the device before the next
        batch starts: batches finish on the weights they started with.
        """
        new = (_leaves(params) if isinstance(params, torch.nn.Module) else
               {str(k): torch.as_tensor(v) for k, v in params.items()})
        if set(new) != set(self._leaves):
            raise ValueError(
                f"swap_params: names differ from the served weights "
                f"(missing {sorted(set(self._leaves) - set(new))}, "
                f"unexpected {sorted(set(new) - set(self._leaves))})")
        for name, cur in self._leaves.items():
            got = new[name]
            if tuple(got.shape) != tuple(cur.shape) or got.dtype != cur.dtype:
                raise ValueError(
                    f"swap_params: {name} is {got.dtype} "
                    f"{tuple(got.shape)}, the served weight "
                    f"{cur.dtype} {tuple(cur.shape)}")
        with self._gate.exclusive(), torch.no_grad():
            with self._on_stream():
                for name, cur in self._leaves.items():
                    cur.copy_(new[name])
            if self._stream is not None:
                self._stream.synchronize()
            with self._lock:
                self._version += 1
                return self._version

    @property
    def params_version(self) -> int:
        with self._lock:
            return self._version

    # ---- inference ------------------------------------------------------
    def bucket_for(self, n: int) -> int:
        """Smallest bucket admitting ``n`` rows (the largest bucket when
        ``n`` exceeds the ladder — callers then chunk)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _on_stream(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def _batch_sharding(self, bucket: int) -> Tuple[Any, ...]:
        """The padded batch's spec under the mesh, in the reference's
        terms (a ``PartitionSpec`` as a tuple): ``("dp",)`` or
        ``(("dp", "fsdp"),)`` when the bucket splits over the
        data-parallel axes (dp/fsdp — the ``parallel/sharding.py`` rule
        table, as for training inputs), ``()`` when it is replicated.
        Parameter axes (tp/…) never split the batch."""
        if self.mesh is None:
            return ()
        from ..parallel.sharding import (_axes_of, _sizes, batch_spec,
                                         transformer_rules)

        spec = batch_spec(self.mesh, rules=transformer_rules(fsdp=True))
        axes = _axes_of(spec[0]) if len(spec) else ()
        if axes:
            sizes = _sizes(self.mesh)
            total = math.prod(sizes[a] for a in axes)
            if total > 1 and bucket % total == 0:
                return (axes[0] if len(axes) == 1 else axes,)
        return ()

    def _split(self, bucket: int):
        """(group, this member's index, parts) of a split bucket, or
        None when every member runs the whole bucket."""
        spec = self._batch_sharding(bucket)
        if not spec:
            return None
        import torch.distributed as dist

        from ..parallel.mesh import fiber_group
        from ..parallel.sharding import _axes_of

        group = fiber_group(self.mesh, _axes_of(spec[0]))
        return (group, dist.get_group_rank(group, dist.get_rank()),
                dist.get_world_size(group))

    def _key(self, key: tuple) -> _Key:
        with self._lock:
            k = self._keys.get(key)
            if k is None:
                k = self._keys[key] = _Key()
            return k

    def _eager(self, x: np.ndarray) -> torch.Tensor:
        with self._on_stream(), torch.inference_mode():
            xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            return self._apply_fn(self._params, xt)

    def _capture(self, k: _Key, x: np.ndarray) -> None:
        from ..common import graphs

        with self._on_stream(), torch.inference_mode():
            k.x = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        graph = torch.cuda.CUDAGraph()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        with graphs.capture_lock, torch.inference_mode(), \
                torch.cuda.device(self.device), \
                torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                                 capture_error_mode="thread_local"):
            k.y = self._apply_fn(self._params, k.x)
        k.graph = graph

    def _replay(self, k: _Key, x: np.ndarray) -> torch.Tensor:
        with self._on_stream(), torch.inference_mode():
            k.x.copy_(torch.from_numpy(np.ascontiguousarray(x)))
            k.graph.replay()
        return k.y

    def _forward(self, key: tuple, x: np.ndarray, n: int, split
                 ) -> np.ndarray:
        """Run ``x`` (this member's rows of a padded bucket) through the
        key and return host numpy of the bucket's first ``n`` rows."""
        k = self._key(key)
        with k.lock:
            k.uses += 1
            if not self._graphed or k.uses == 1:
                if not self._graphed and k.uses == 1:
                    self._compiles.inc()
                    log.info("serve: first use of bucket key %s", key)
                with self._gate.shared():
                    return self._rows(self._eager(x), n, split)
            if k.graph is None:
                with self._gate.exclusive():
                    self._capture(k, x)
                self._compiles.inc()
                log.info("serve: captured bucket key %s", key)
            with self._gate.shared():
                return self._rows(self._replay(k, x), n, split)

    def _rows(self, y: torch.Tensor, n: int, split) -> np.ndarray:
        """Host numpy of the first ``n`` rows of the bucket's output:
        this member's rows all-gathered first when the bucket is
        split."""
        if split is not None:
            import torch.distributed as dist

            group, _, parts = split
            with self._on_stream():
                chunks = [torch.empty_like(y) for _ in range(parts)]
                dist.all_gather(chunks, y.contiguous(), group=group)
                y = torch.cat(chunks)
        with self._on_stream():
            return _host(y[:n])

    def _run_bucket(self, x: np.ndarray) -> np.ndarray:
        """One padded-bucket execution; returns host outputs for the
        un-padded prefix."""
        n = x.shape[0]
        bucket = self.bucket_for(n)
        if n < bucket:
            pad = np.zeros((bucket - n,) + x.shape[1:], x.dtype)
            xb = np.concatenate([x, pad], axis=0)
            self._pad_rows.inc(bucket - n)
        else:
            xb = x
        split = self._split(bucket)
        if split is not None:
            _, idx, parts = split
            rows = bucket // parts
            xb = xb[idx * rows:(idx + 1) * rows]
        y = self._forward((bucket, x.shape[1:], x.dtype.str), xb, n, split)
        self._infers.inc()
        return y

    def infer(self, x) -> np.ndarray:
        """Run a batch of ``n`` rows; rows past the largest bucket are
        chunked through it.  Returns host numpy of shape [n, ...]."""
        x = np.asarray(x)
        if x.ndim < 1 or x.shape[0] == 0:
            raise ValueError(f"infer needs a non-empty batch, got shape "
                             f"{x.shape}")
        top = self.buckets[-1]
        if x.shape[0] <= top:
            return self._run_bucket(x)
        outs = [self._run_bucket(x[i:i + top])
                for i in range(0, x.shape[0], top)]
        return np.concatenate(outs, axis=0)

    def captured(self, bucket: int, feat_shape: Tuple[int, ...],
                 dtype=np.float32) -> bool:
        """Whether the key is ready for steady traffic: captured on the
        card, used once on the CPU."""
        key = (bucket, tuple(feat_shape), np.dtype(dtype).str)
        with self._lock:
            k = self._keys.get(key)
        if k is None:
            return False
        return k.graph is not None if self._graphed else k.uses > 0

    def warmup(self, feat_shape: Tuple[int, ...],
               dtype=np.float32) -> None:
        """Capture every bucket for one feature shape (on the card: an
        eager first use, then the capture) so the first real request
        never pays for either."""
        for b in self.buckets:
            while not self.captured(b, feat_shape, dtype):
                self._run_bucket(np.zeros((b,) + tuple(feat_shape), dtype))

    def compile_count(self) -> int:
        return int(self._compiles.value())
