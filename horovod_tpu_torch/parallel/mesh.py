"""Device-mesh construction for multi-axis parallelism.

The PyTorch counterpart of the JAX package's ``parallel/mesh.py``: the
axis names, their canonical order, :class:`MeshSpec` and
:func:`mesh_shape_for` are copies of the reference's, and
:func:`make_mesh` lays the world's ranks out on a
``torch.distributed.device_mesh.DeviceMesh`` where the reference lays
devices out on a ``jax.sharding.Mesh``.

Axis order follows the reference's convention: outermost axes change
slowest across ranks, so the bandwidth-hungry axes (``tp``, ``sp``) are
innermost and their members are neighbouring ranks (on one host, the
cards that share NVLink), and the latency-tolerant axes (``dp``, ``pp``)
are outermost.

Transport classes (the reference's ``ici``/``dcn``) follow the same
convention: the innermost axis of a reduce group is the fast tier (on
the card: NVLink within a host), every outer axis the slow one (across
hosts).  The transport-policy layer (``horovod_tpu_torch/transport``)
keys its per-axis choices on them.  :func:`make_mesh` records the mesh
it builds as the process's current mesh (``common.basics.current_mesh``),
whose dimensions name the reduce group of a policy-routed
``fused_allreduce``.  :func:`pod_mesh_spec` and :func:`pod_axis_tiers`
are the reference's pod contract: a spec whose axis names are the
transport classes, ``(pp, dcn, ici, ep)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

import torch.distributed as dist

AXIS_DP = "dp"
AXIS_FSDP = "fsdp"
AXIS_PP = "pp"
AXIS_TP = "tp"
AXIS_SP = "sp"
AXIS_EP = "ep"

# Outer-to-inner canonical ordering (latency-tolerant → bandwidth-hungry).
CANONICAL_AXES: Tuple[str, ...] = (
    AXIS_DP, AXIS_PP, AXIS_FSDP, AXIS_EP, AXIS_SP, AXIS_TP)

# Transport classes: the interconnect tier a mesh axis rides.  The
# innermost axis of a group is the fast tier, every outer axis the slow
# one.
TRANSPORT_ICI = "ici"
TRANSPORT_DCN = "dcn"
TRANSPORT_CLASSES: Tuple[str, ...] = (TRANSPORT_ICI, TRANSPORT_DCN)

__all__ = [
    "AXIS_DP", "AXIS_FSDP", "AXIS_PP", "AXIS_TP", "AXIS_SP", "AXIS_EP",
    "CANONICAL_AXES", "TRANSPORT_ICI", "TRANSPORT_DCN",
    "TRANSPORT_CLASSES", "axis_transport_class", "split_transport_axes",
    "MeshSpec", "make_mesh", "mesh_shape_for", "pod_mesh_spec",
    "pod_axis_tiers", "mark_sharded", "sharded_axes", "fiber_group",
]


def axis_transport_class(axis: str, axes: Sequence[str]) -> str:
    """Transport tier of ``axis`` within the ordered reduce group
    ``axes`` (outermost first): the innermost axis of a multi-axis group
    is ``ici`` (neighbouring ranks share the fastest links), every outer
    axis ``dcn``; a single-axis group is one ``ici`` domain."""
    axes = tuple(axes)
    if axis not in axes:
        raise ValueError(f"axis {axis!r} not in reduce group {axes}")
    if len(axes) == 1 or axis == axes[-1]:
        return TRANSPORT_ICI
    return TRANSPORT_DCN


def split_transport_axes(axes: Sequence[str], fast_width: int = 1
                         ) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """Split an ordered reduce group into ``(slow_axes, fast_axes)``:
    the ``fast_width`` innermost axes are the tier the hierarchical
    allreduce reduce-scatters over, the rest the tier the shard crosses.
    At least one axis stays slow when the group has more than one."""
    axes = tuple(axes)
    if not axes:
        raise ValueError("empty reduce group")
    width = max(1, min(int(fast_width), len(axes) - 1 or 1))
    return axes[:-width], axes[-width:]


def pod_mesh_spec(num_pods: Optional[int] = None,
                  pod_size: Optional[int] = None,
                  *,
                  pp: Optional[int] = None,
                  ep: Optional[int] = None) -> "MeshSpec":
    """The data-parallel mesh of the elastic pod contract, axes
    ``("dcn", "ici")`` sized ``(num_pods, pod_size)``, optionally
    extended with pipeline and expert degrees.

    Defaults come from the launcher's worker env (``HVDT_NUM_PODS``,
    ``HVDT_POD_SIZE``, else ``HVDT_SIZE // num_pods``; ``HVDT_PP`` /
    ``HVDT_EP``).  The axis names are the transport classes, so
    :func:`split_transport_axes` puts ``ici`` in the fast tier and the
    policy grammar's ``dcn:`` entries match the cross-pod exchange.
    ``pp`` carves pod groups out of the ``dcn`` tier (it must divide
    ``num_pods``), ``ep`` carves ranks out of each pod's ``ici`` tier
    (it must divide ``pod_size``); the order ``(pp, dcn, ici, ep)``
    keeps the data-parallel reduce group at ``("dcn", "ici")``.
    """
    import os

    if num_pods is None:
        num_pods = int(os.environ.get("HVDT_NUM_PODS", "1") or 1)
    if pod_size is None:
        pod_size = int(os.environ.get("HVDT_POD_SIZE", "0") or 0)
        if pod_size <= 0:
            pod_size = int(os.environ.get("HVDT_SIZE", "1") or 1) \
                // max(1, num_pods)
    if pp is None:
        pp = int(os.environ.get("HVDT_PP", "1") or 1)
    if ep is None:
        ep = int(os.environ.get("HVDT_EP", "1") or 1)
    if num_pods < 1 or pod_size < 1:
        raise ValueError(
            f"pod mesh needs num_pods >= 1 and pod_size >= 1, got "
            f"({num_pods}, {pod_size})")
    if pp < 1 or ep < 1:
        raise ValueError(f"pp and ep must be >= 1, got ({pp}, {ep})")
    if pp == 1 and ep == 1:
        return MeshSpec(axes=((TRANSPORT_DCN, int(num_pods)),
                              (TRANSPORT_ICI, int(pod_size))))
    if num_pods % pp:
        raise ValueError(
            f"pipeline degree pp={pp} must divide num_pods={num_pods} "
            "(stages are pod groups on the DCN tier)")
    if pod_size % ep:
        raise ValueError(
            f"expert degree ep={ep} must divide pod_size={pod_size} "
            "(experts share a pod's ICI tier)")
    axes: List[Tuple[str, int]] = []
    if pp > 1:
        axes.append((AXIS_PP, int(pp)))
    axes.append((TRANSPORT_DCN, int(num_pods // pp)))
    axes.append((TRANSPORT_ICI, int(pod_size // ep)))
    if ep > 1:
        axes.append((AXIS_EP, int(ep)))
    return MeshSpec(axes=tuple(axes))


def pod_axis_tiers(spec: "MeshSpec") -> Dict[str, str]:
    """The physical tier of each axis of a pod-contract spec: axes at or
    outside ``dcn`` cross pods (``pp`` hops ride DCN), axes at or inside
    ``ici`` stay within a pod (``ep`` all-to-alls ride ICI)."""
    names = spec.names
    boundary = names.index(TRANSPORT_ICI) if TRANSPORT_ICI in names \
        else len(names) - 1
    return {name: (TRANSPORT_ICI if i >= boundary else TRANSPORT_DCN)
            for i, name in enumerate(names)}


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A validated mesh layout: ordered (axis, size) pairs.

    ``MeshSpec.create(dp=2, tp=4)`` fills unspecified axes with size 1 and
    orders axes canonically; total size must divide the device count.
    """

    axes: Tuple[Tuple[str, int], ...]

    @classmethod
    def create(cls, *, devices_total: Optional[int] = None,
               **sizes: int) -> "MeshSpec":
        for name, n in sizes.items():
            if n < 1:
                raise ValueError(f"axis {name!r} must have size >= 1, got {n}")
        ordered: List[Tuple[str, int]] = []
        for name in CANONICAL_AXES:
            if name in sizes:
                ordered.append((name, sizes.pop(name)))
        # Unknown (user-defined) axes go last, in given order.
        for name, n in sizes.items():
            ordered.append((name, n))
        spec = cls(tuple(ordered))
        if devices_total is not None:
            want = spec.total
            if want > devices_total or devices_total % want:
                raise ValueError(
                    f"mesh spec {spec.shape} (total {want}) does not divide "
                    f"{devices_total} devices")
        return spec

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.axes)

    @property
    def total(self) -> int:
        return math.prod(n for _, n in self.axes)


def mesh_shape_for(n_devices: int,
                   *,
                   tp: int = 1,
                   pp: int = 1,
                   sp: int = 1,
                   ep: int = 1,
                   fsdp: int = 1) -> MeshSpec:
    """Fill the ``dp`` axis with whatever devices remain after the model
    axes (the reference's default-layout helper)."""
    model = tp * pp * sp * ep * fsdp
    if n_devices % model:
        raise ValueError(
            f"model-parallel degree {model} (tp={tp} pp={pp} sp={sp} ep={ep} "
            f"fsdp={fsdp}) does not divide {n_devices} devices")
    return MeshSpec.create(dp=n_devices // model, pp=pp, fsdp=fsdp,
                           ep=ep, sp=sp, tp=tp)


def make_mesh(spec: Optional[MeshSpec] = None, **sizes: int):
    """A ``DeviceMesh`` over the whole world from a spec or axis sizes.

    ``make_mesh(dp=2, sp=4)`` lays ranks 0-7 out as ``[[0, 1, 2, 3], [4,
    5, 6, 7]]`` with dims ("dp", "sp"): the canonical order, ``sp``
    inside ``dp``, so ``mesh.get_group("sp")`` is a ring of neighbouring
    ranks.  Every rank must call it (each dimension's process groups are
    made collectively).  The mesh's device type is ``"cuda"`` on an NCCL
    world and ``"cpu"`` otherwise.  The spec's total must equal the world
    size.  The mesh becomes the process's current mesh
    (``common.basics.current_mesh``) until the next ``make_mesh``,
    ``set_mesh`` or ``shutdown``.
    """
    from torch.distributed.device_mesh import init_device_mesh

    if spec is None:
        spec = MeshSpec.create(**sizes)
    elif sizes:
        raise TypeError("pass either spec= or axis sizes, not both")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(horovod_tpu_torch.init())")
    world = dist.get_world_size()
    if spec.total != world:
        raise ValueError(f"mesh {spec.shape} has {spec.total} members, the "
                         f"world has {world} ranks")
    from ..common.basics import set_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    shape = tuple(n for _, n in spec.axes)
    mesh = init_device_mesh(device_type, shape, mesh_dim_names=spec.names)
    set_mesh(mesh)
    return mesh


def mark_sharded(tensor: torch.Tensor, *axes: str) -> torch.Tensor:
    """Record that ``tensor`` (a parameter) is sharded over the mesh axes
    ``axes``: each member of such an axis holds a different slice (its
    experts under ``ep``, its stage's layers under ``pp``, its heads or
    MLP columns under ``tp``, its part of the ``embed`` dimension under
    ``fsdp``), so its gradient must never be averaged over them.  This is
    what a ``PartitionSpec`` naming the axis says in the reference;
    ``DistributedOptimizer(axis=, pipeline=, expert=)`` reads it (``tp``
    and ``fsdp`` need no keyword there).  Returns ``tensor``."""
    tensor.hvdt_sharded_axes = tuple(axes)
    return tensor


def sharded_axes(tensor: torch.Tensor) -> Tuple[str, ...]:
    """The axes :func:`mark_sharded` recorded for ``tensor`` (none: it is
    replicated over every axis)."""
    return tuple(getattr(tensor, "hvdt_sharded_axes", ()))


def fiber_group(mesh, dims: Sequence[str]):
    """The process group of this rank's fiber of ``mesh`` over the
    dimensions ``dims``: the ranks that differ from this one only in
    those coordinates.  One dimension is ``mesh.get_group(dim)``; several
    make one ``dist.new_group`` per fiber, collectively (every rank calls
    this with the same arguments in the same order), kept on the mesh."""
    dims = tuple(dims)
    if len(dims) == 1:
        return mesh.get_group(dims[0])
    fibers = mesh.__dict__.setdefault("_hvdt_fibers", {})
    if dims not in fibers:
        names = tuple(mesh.mesh_dim_names)
        layout = mesh.mesh
        idx = [names.index(d) for d in dims]
        rest = [i for i in range(layout.dim()) if i not in idx]
        rows = layout.permute(*rest, *idx).reshape(
            -1, math.prod(layout.shape[i] for i in idx))
        me = dist.get_rank()
        for row in rows.tolist():
            group = dist.new_group(row)
            if me in row:
                fibers[dims] = group
    return fibers[dims]
