"""Logical-axis sharding rules → mesh-axis specs and local parts.

The PyTorch counterpart of the JAX package's ``parallel/sharding.py``.
Models name their parameter dimensions with *logical* axes ("embed",
"mlp", "heads", "batch", "seq", ...) and a rule table maps those to mesh
axes.  The reference turns the result into a ``PartitionSpec`` and lets
GSPMD insert the collectives; here a spec is a plain tuple of mesh-axis
entries (one per tensor dimension: None, an axis name, or a tuple of
them), :func:`named_sharding` gives the ``torch.distributed.tensor``
placements of the same layout on a ``DeviceMesh``, and :func:`local_part`
cuts a global leaf to the part one member holds, which is what a module
built for that member keeps as its parameter (the transformer over
``tp`` / ``fsdp`` / ``pp`` / ``ep``, ``convert.transformer_params_from_jax``).

A ``mesh`` argument is a ``DeviceMesh`` (its dimension names and sizes),
a mapping of axis name to size, or None (no axis is dropped).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

from .mesh import AXIS_DP, AXIS_EP, AXIS_FSDP, AXIS_PP, AXIS_SP, AXIS_TP

__all__ = [
    "pcast_to_union",
    "transformer_rules", "logical_to_mesh", "named_sharding", "batch_spec",
    "fsdp_shardings", "local_part",
]

MeshAxes = Union[None, str, Tuple[str, ...]]


def transformer_rules(*, fsdp: bool = False) -> Dict[str, MeshAxes]:
    """Default logical→mesh rules for a Megatron-style transformer (the
    reference's table):

    * ``embed`` (the model/hidden dim) is replicated across ``tp`` —
      or sharded over ``fsdp`` when ZeRO-style sharding is on;
    * ``mlp``/``heads`` (the per-layer wide dims) shard over ``tp``;
      ``kv`` and ``vocab`` stay replicated;
    * ``batch`` shards over (dp, fsdp), ``seq`` over ``sp``;
    * ``experts`` shard over ``ep``; ``stages`` over ``pp``.
    """
    return {
        "batch": (AXIS_DP, AXIS_FSDP) if fsdp else AXIS_DP,
        "seq": AXIS_SP,
        "embed": AXIS_FSDP if fsdp else None,
        "mlp": AXIS_TP,
        "heads": AXIS_TP,
        "kv": None,
        "vocab": None,
        "experts": AXIS_EP,
        "stages": AXIS_PP,
        "unmodeled": None,
    }


def _sizes(mesh) -> Optional[Dict[str, int]]:
    """Axis name → size of a ``DeviceMesh`` or a mapping (None: None)."""
    if mesh is None:
        return None
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.mesh.shape)))


def _axes_of(entry: MeshAxes) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def logical_to_mesh(logical: Sequence[Optional[str]],
                    rules: Mapping[str, MeshAxes],
                    mesh=None) -> Tuple[MeshAxes, ...]:
    """Map a tuple of logical axis names to a spec: one entry per
    dimension (None, a mesh axis, or a tuple of them, outermost first),
    trailing Nones dropped, as the reference's ``PartitionSpec``.

    Mesh axes absent from ``mesh`` (or of size 1) are dropped so one rule
    table works across mesh shapes.  A mesh axis may be consumed at most
    once (``ValueError``)."""
    present = _sizes(mesh)
    used = set()
    out = []
    for name in logical:
        kept = []
        for ax in _axes_of(rules.get(name) if name is not None else None):
            if present is not None and present.get(ax, 1) <= 1:
                continue
            if ax in used:
                raise ValueError(
                    f"mesh axis {ax!r} consumed twice in logical spec "
                    f"{tuple(logical)}")
            used.add(ax)
            kept.append(ax)
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def named_sharding(mesh, logical: Sequence[Optional[str]],
                   rules: Optional[Mapping[str, MeshAxes]] = None):
    """The ``torch.distributed.tensor`` placements of a logical spec on
    the ``DeviceMesh`` ``mesh``: one per mesh dimension, ``Shard(d)``
    where the spec shards tensor dimension ``d`` over it, ``Replicate()``
    elsewhere (the counterpart of the reference's ``NamedSharding``).
    Rules default to :func:`transformer_rules`."""
    from torch.distributed.tensor import Replicate, Shard

    if rules is None:
        rules = transformer_rules()
    names = tuple(mesh.mesh_dim_names)
    placements = [Replicate() for _ in names]
    for dim, entry in enumerate(logical_to_mesh(logical, rules, mesh)):
        for ax in _axes_of(entry):
            placements[names.index(ax)] = Shard(dim)
    return tuple(placements)


def batch_spec(mesh=None, *, seq_sharded: bool = False,
               rules: Optional[Mapping[str, MeshAxes]] = None
               ) -> Tuple[MeshAxes, ...]:
    """The spec of an input batch ``[batch, seq, ...]``."""
    if rules is None:
        rules = transformer_rules()
    logical = ("batch", "seq" if seq_sharded else None)
    return logical_to_mesh(logical, rules, mesh)


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def _tree_map(fn, tree):
    if _is_logical(tree):
        return fn(tree)
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    raise TypeError(f"not a logical axis tuple: {tree!r}")


def fsdp_shardings(mesh, logical_tree,
                   rules: Optional[Mapping[str, MeshAxes]] = None):
    """Per-leaf placements (:func:`named_sharding`) that shard parameters
    over the ``fsdp`` mesh axis: ``logical_tree`` is a dict / list tree of
    logical axis tuples (``models.transformer_logical_axes``); rules
    default to ``transformer_rules(fsdp=True)``, so ``embed`` dims land
    on ``fsdp``.  The transformer's ``fsdp_group=`` path is the port's
    per-layer ZeRO-3 with this layout: each block all-gathers its leaves
    just before use and frees them after (``models/transformer.py``)."""
    if rules is None:
        rules = transformer_rules(fsdp=True)
    return _tree_map(lambda lg: named_sharding(mesh, lg, rules),
                     logical_tree)


def local_part(leaf: Any, logical: Sequence[Optional[str]],
               rules: Mapping[str, MeshAxes], mesh,
               coords: Optional[Mapping[str, int]] = None) -> Any:
    """The part of the global ``leaf`` (a tensor or a numpy array) that
    the mesh member at ``coords`` (axis name → index; default: this
    process's coordinate on the ``DeviceMesh`` ``mesh``) holds under the
    spec ``logical_to_mesh(logical, rules, mesh)``.

    A dimension sharded over axes ``(a, b)`` is cut into ``size(a) *
    size(b)`` equal blocks and the member takes block ``coord(a) *
    size(b) + coord(b)`` (the first axis outermost, as a
    ``PartitionSpec`` lays a tuple of axes out).  A view or a numpy slice,
    not a copy; ``ValueError`` if a dimension does not divide."""
    sizes = _sizes(mesh)
    if coords is None:
        names = tuple(mesh.mesh_dim_names)
        coords = dict(zip(names, mesh.get_coordinate()))
    index = []
    for dim, entry in enumerate(logical_to_mesh(logical, rules, sizes)):
        axes = _axes_of(entry)
        if not axes:
            index.append(slice(None))
            continue
        n = math.prod(sizes[a] for a in axes)
        block = 0
        for a in axes:
            block = block * sizes[a] + int(coords.get(a, 0))
        length = leaf.shape[dim]
        if length % n:
            raise ValueError(
                f"dimension {dim} ({logical[dim]!r}, length {length}) of a "
                f"leaf does not divide over {axes} ({n} members)")
        per = length // n
        index.append(slice(block * per, (block + 1) * per))
    return leaf[tuple(index)] if index else leaf


def pcast_to_union(x, *operands, extra=()):
    """The reference promotes ``x``'s varying-manual-axes (vma) type to
    the union of the operands' inside a ``shard_map`` island, so scan
    carries and accumulators type-check.  PyTorch tensors carry no such
    type (a process holds its local values, varying or not), so this
    returns ``x`` unchanged; it exists so code written against the
    reference's API runs here."""
    del operands, extra
    return x
