"""Parallelism substrate of the port: mesh axes, sharding rules, and
tensor, fully-sharded, sequence, expert and pipeline parallelism.

The PyTorch counterpart of the JAX package's ``parallel/``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the world's ranks in
the canonical axis order, and a mesh axis is the process group of its
dimension (``mesh.get_group("sp")``).

Canonical axis names (any subset may be present, size-1 axes are free):

* ``dp`` — data parallel (gradient allreduce over the whole world)
* ``fsdp`` — fully-sharded data parallel (the transformer's per-layer
  all-gather of its ``embed``-sharded leaves over ``fsdp_group=``)
* ``pp`` — pipeline stages (``pipeline_1f1b``)
* ``ep`` — expert parallel (``moe_dispatch_combine``)
* ``sp`` — sequence/context parallel (ring attention)
* ``tp`` — tensor (Megatron-style) parallel within a layer (the
  transformer's ``tp_group=``)

``sharding.py`` holds the logical-axis rule table and its mapping
(``transformer_rules``, ``logical_to_mesh``, ``local_part``, ...).
``mark_sharded`` records which of these axes a parameter is sharded
over, for ``DistributedOptimizer(axis=, pipeline=, expert=)``.
"""

from .mesh import (  # noqa: F401
    AXIS_DP,
    AXIS_FSDP,
    AXIS_PP,
    AXIS_TP,
    AXIS_SP,
    AXIS_EP,
    CANONICAL_AXES,
    TRANSPORT_ICI,
    TRANSPORT_DCN,
    TRANSPORT_CLASSES,
    axis_transport_class,
    split_transport_axes,
    MeshSpec,
    make_mesh,
    mesh_shape_for,
    pod_mesh_spec,
    pod_axis_tiers,
    mark_sharded,
    sharded_axes,
    fiber_group,
)
from .sharding import (  # noqa: F401
    batch_spec,
    fsdp_shardings,
    local_part,
    logical_to_mesh,
    named_sharding,
    pcast_to_union,
    transformer_rules,
)
from .moe import (  # noqa: F401
    MoEAux,
    moe_capacity,
    moe_dispatch_combine,
    report_moe_aux,
)
from .pipeline import (  # noqa: F401
    bubble_fraction,
    pipeline_1f1b,
    pipeline_spmd,
    report_pipeline_mfu,
)
from .ring_attention import ring_attention  # noqa: F401
