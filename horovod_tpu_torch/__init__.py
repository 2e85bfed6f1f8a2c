"""horovod_tpu_torch — the PyTorch/CUDA port of horovod_tpu.

Synchronous data-parallel training over ``torch.distributed`` (NCCL on
the card, gloo on the CPU), with the JAX package's public names, knobs
and numerics, and its TPU kernels rewritten by hand for Hopper.

Typical use::

    import horovod_tpu_torch as hvd
    hvd.init()
    opt = hvd.DistributedOptimizer(hvd.fused_adam(model.parameters(), 1e-3))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

The int8 gradient wire with error feedback::

    opt = hvd.quant.with_error_feedback(hvd.DistributedOptimizer(
        hvd.fused_sgd(model.parameters(), 0.01, momentum=0.9),
        compression=hvd.Compression.int8))

Named, negotiated eager collectives (Horovod's own API), e.g. metric
averaging and an epoch broadcast::

    avg_loss = hvd.allreduce(loss, name="avg_loss")
    start_epoch = int(hvd.broadcast(torch.tensor(start_epoch), root_rank=0,
                                    name="start_epoch"))

A Horovod PyTorch script keeps its own names through
``horovod_tpu_torch.interop.torch``, the drop-in for ``import
horovod.torch as hvd`` (in-place and async ops, the grad-hook
``DistributedOptimizer(opt, named_parameters=...)``, a ``_BatchNorm``
``SyncBatchNorm``)::

    import horovod_tpu_torch.interop.torch as hvd
    hvd.init()
    opt = hvd.DistributedOptimizer(opt,
                                   named_parameters=model.named_parameters())
    hvd.allreduce_(metric, name="metric")

``start_timeline(path)`` / ``stop_timeline()`` (or ``HVDT_TIMELINE``)
record the eager collectives as a Chrome-tracing timeline.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``.  Importing the package starts no thread: the eager
controller starts at the first eager call.
"""

from __future__ import annotations

__version__ = "0.1.0"

from .common.basics import (  # noqa: F401
    init,
    shutdown,
    is_initialized,
    rank,
    size,
    local_rank,
    local_size,
    cross_rank,
    cross_size,
    topology,
    num_devices,
    local_devices,
    global_devices,
    is_homogeneous,
)
from .common.process_sets import (  # noqa: F401
    ProcessSet,
    add_process_set,
    global_process_set,
    process_set_by_id,
    remove_process_set,
)
from .common.types import ReduceOp, Status  # noqa: F401
from .common.exceptions import (  # noqa: F401
    HorovodInternalError,
    HostsUpdatedInterrupt,
)

Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT

from . import ops  # noqa: F401,E402
from . import quant  # noqa: F401,E402
from .ops import device  # noqa: F401,E402
from .ops.compression import Compression  # noqa: F401,E402
from .ops.optim_kernels import fused_adam, fused_sgd  # noqa: F401,E402
from .optimizer import (  # noqa: F401,E402
    DistributedOptimizer,
    allreduce_gradients,
    microbatch_gradients,
)
from .sync_batch_norm import SyncBatchNorm, sync_batch_stats  # noqa: F401,E402
from .functions import (  # noqa: F401,E402
    allgather_object,
    broadcast_object,
    broadcast_optimizer_state,
    broadcast_parameters,
)
from .ops.eager import (  # noqa: F401,E402
    allgather,
    allgather_async,
    allreduce,
    allreduce_async,
    alltoall,
    alltoall_async,
    barrier,
    broadcast,
    broadcast_async,
    grouped_allreduce,
    grouped_allreduce_async,
    join,
    poll,
    reducescatter,
    reducescatter_async,
    synchronize,
)
from .ops.sparse import (  # noqa: F401,E402
    sparse_allreduce,
    sparse_allreduce_async,
)
from .timeline import start_timeline, stop_timeline  # noqa: F401,E402
from . import elastic  # noqa: F401,E402
from . import callbacks  # noqa: F401,E402
from .common.util import (  # noqa: F401,E402
    ccl_built,
    cuda_built,
    ddl_built,
    gloo_built,
    gloo_enabled,
    mpi_built,
    mpi_enabled,
    mpi_threads_supported,
    native_built,
    nccl_built,
    rocm_built,
    tcp_enabled,
    tpu_available,
    xla_built,
)
