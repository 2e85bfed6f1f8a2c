"""Topology-aware transport policies for the gradient exchange.

The PyTorch counterpart of the JAX package's ``transport/``: every mesh
axis gets its own algorithm (``ring | tree | 2d_ring``), wire dtype
(``f32 | bf16 | fp16 | int8 | int4``) and fusion threshold, chosen by
``HVDT_TRANSPORT`` (:mod:`.policy`) and applied by the hierarchical
allreduce (:mod:`.hierarchy`): reduce-scatter over the fast tier, the
shard exchanged over the slow tier (on the quantized wire when the slow
policy says so), all-gather back.

With ``HVDT_TRANSPORT`` unset :func:`get_policy` returns None and
``ops.device.fused_allreduce`` and the overlap scheduler run their flat
path unchanged.  The reference's ``pin_inflight`` orders XLA's schedule
with optimization barriers; the port issues collectives in program
order, so it has no counterpart here.
"""

from .policy import (AxisPolicy, ResolvedTransport, TransportPolicy,
                     bucket_threshold, enabled, get_policy, parse_transport,
                     reset, resolve_axis, validate_env)
from .hierarchy import (InflightHierarchical, hierarchical_allreduce_finish,
                        hierarchical_allreduce_flat,
                        hierarchical_allreduce_start, tier_sizes,
                        wire_bytes_estimate)

__all__ = [
    "AxisPolicy", "ResolvedTransport", "TransportPolicy",
    "parse_transport", "get_policy", "resolve_axis", "bucket_threshold",
    "enabled", "reset", "validate_env",
    "InflightHierarchical", "hierarchical_allreduce_start",
    "hierarchical_allreduce_finish", "hierarchical_allreduce_flat",
    "wire_bytes_estimate", "tier_sizes",
]
