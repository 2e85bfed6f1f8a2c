"""horovod_tpu_torch — the PyTorch/CUDA port of horovod_tpu.

Synchronous data-parallel training over ``torch.distributed`` (NCCL on
the card, gloo on the CPU), with the JAX package's public names, knobs
and numerics, and its TPU kernels rewritten by hand for Hopper.

Typical use::

    import horovod_tpu_torch as hvd
    hvd.init()
    opt = hvd.DistributedOptimizer(hvd.fused_adam(model.parameters(), 1e-3))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
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
)
from .common.process_sets import (  # noqa: F401
    ProcessSet,
    add_process_set,
    global_process_set,
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
from .ops import device  # noqa: F401,E402
from .ops.compression import Compression  # noqa: F401,E402
from .ops.optim_kernels import fused_adam, fused_sgd  # noqa: F401,E402
from .optimizer import (  # noqa: F401,E402
    DistributedOptimizer,
    allreduce_gradients,
)
from .functions import (  # noqa: F401,E402
    broadcast_object,
    broadcast_optimizer_state,
    broadcast_parameters,
)
