"""Framework bindings: Horovod's per-framework APIs over the port.

The counterpart of the JAX package's ``interop/``.  ``interop.torch`` is
the drop-in for ``import horovod.torch as hvd``: in-place and async
collectives on torch tensors, the grad-hook ``DistributedOptimizer`` and
a ``_BatchNorm`` ``SyncBatchNorm``, all over the port's eager controller.
``interop.tf`` and ``interop.mxnet`` are not ported (ROADMAP Queue 1,
item 8).
"""

import importlib


def __getattr__(name):
    # `hvd.interop.torch` resolves without an explicit submodule import.
    if name == "torch":
        return importlib.import_module(".torch", __name__)
    if name in ("tf", "mxnet"):
        raise NotImplementedError(
            f"interop.{name} is not ported yet (ROADMAP Queue 1, item 8: "
            "control, analysis and the edges)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


#: Core names every Horovod framework module re-exports, resolved from the
#: port's top level, so ``import horovod_tpu_torch.interop.torch as hvd``
#: is drop-in for ``import horovod.torch as hvd``.
CORE_NAMES = (
    "init", "shutdown", "is_initialized",
    "rank", "size", "local_rank", "local_size", "cross_rank",
    "cross_size", "is_homogeneous",
    "Average", "Sum", "Adasum", "Min", "Max", "Product", "ReduceOp",
    "ProcessSet", "global_process_set", "add_process_set",
    "remove_process_set", "process_set_by_id",
    "mpi_built", "mpi_enabled", "mpi_threads_supported",
    "gloo_built", "gloo_enabled", "nccl_built", "ddl_built", "ccl_built",
    "cuda_built", "rocm_built", "xla_built", "tpu_available",
    "start_timeline", "stop_timeline",
    "HorovodInternalError", "HostsUpdatedInterrupt",
)


def core_attr(name):
    """Resolve a core-API name against the port's top level, or None."""
    if name in CORE_NAMES:
        import horovod_tpu_torch

        return getattr(horovod_tpu_torch, name)
    return None
