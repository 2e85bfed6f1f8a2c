"""Per-mesh-axis transport policy: grammar, resolution, env engagement.

The PyTorch counterpart of the JAX package's ``transport/policy.py``;
the grammar, the vocabulary and the resolution rules are its own.
``HVDT_TRANSPORT`` (strict: unknown vocabulary raises at ``hvd.init()``,
as ``HVDT_COMPRESSION`` does)::

    HVDT_TRANSPORT = entry ("," entry)*  |  "auto"
    entry          = axis ":" algorithm ":" wire [":" threshold]
    axis           = "ici" | "dcn"            (transport class)
                   | dp|pp|fsdp|ep|sp|tp      (exact mesh-axis name)
    algorithm      = "ring" | "tree" | "2d_ring"
    wire           = "f32" | "bf16" | "fp16" | "int8" | "int4"
    threshold      = digits [K|M|G]           (fusion bucket bytes)

e.g. ``ici:ring:f32:64M,dcn:tree:int8:8M``.  The quantized wires ride
the slow (``dcn``) tier only.  ``auto`` is ICI rings at f32 with the
global fusion threshold and DCN trees at f32 with 8 MiB buckets.  Exact
mesh-axis names win over their class (``parallel.mesh.
axis_transport_class``).  Thresholds parse strictly here and clamp
through ``ops.device._validated_threshold`` at use.

On the card the classes map to the interconnect: ``ici`` is the fast
tier (NVLink within a host), ``dcn`` the slow one (across hosts); a
mesh axis's tier follows the mesh convention (innermost = fast).
Algorithms: ``ring`` reduce-scatters over the fast tier so the slow tier
moves 1/n of the bytes; ``tree`` makes the fast tier one all-reduce (the
slow tier then moves the whole vector); ``2d_ring`` reduce-scatters over
the two innermost axes when the group has three or more.  NCCL picks the
wire-level ring or tree inside each collective.

With ``HVDT_TRANSPORT`` unset :func:`get_policy` returns None and every
call site keeps its flat path unchanged.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import threading
from typing import Dict, Optional, Tuple, Union

from ..parallel import mesh as _mesh

log = logging.getLogger(__name__)

__all__ = ["AxisPolicy", "ResolvedTransport", "TransportPolicy",
           "parse_transport", "get_policy", "resolve_axis",
           "bucket_threshold", "enabled", "reset", "validate_env",
           "ALGORITHMS", "WIRES", "QUANT_WIRES", "VALID_AXES"]

ALGORITHMS: Tuple[str, ...] = ("ring", "tree", "2d_ring")
WIRES: Tuple[str, ...] = ("f32", "bf16", "fp16", "int8", "int4")
# Block-scaled quantized wires: slow-axis (dcn) only, single slow axis.
QUANT_WIRES: Tuple[str, ...] = ("int8", "int4")
VALID_AXES: Tuple[str, ...] = _mesh.TRANSPORT_CLASSES + _mesh.CANONICAL_AXES

_AUTO_DCN_THRESHOLD = 8 * 1024 * 1024
_SIZE_RE = re.compile(r"^(\d+)([KkMmGg]?)$")
_SIZE_MULT = {"": 1, "k": 1 << 10, "m": 1 << 20, "g": 1 << 30}


@dataclasses.dataclass(frozen=True)
class AxisPolicy:
    """One axis entry: algorithm, wire dtype, optional fusion threshold."""

    algorithm: str = "ring"
    wire: str = "f32"
    threshold_bytes: Optional[int] = None

    def describe(self) -> str:
        t = (f":{self.threshold_bytes}"
             if self.threshold_bytes is not None else "")
        return f"{self.algorithm}:{self.wire}{t}"


@dataclasses.dataclass(frozen=True)
class ResolvedTransport:
    """A policy applied to one reduce group (mesh axes, outermost
    first): ``hierarchical`` when the group splits into a slow and a
    fast tier, ``flat`` when a single-axis group only carries a wire /
    threshold override."""

    kind: str                       # "hierarchical" | "flat"
    axes: Tuple[str, ...]
    fast_axes: Tuple[str, ...]
    slow_axes: Tuple[str, ...]
    fast: AxisPolicy
    slow: Optional[AxisPolicy]
    threshold_bytes: Optional[int]


def _parse_threshold(tok: str, entry: str) -> int:
    m = _SIZE_RE.match(tok.strip())
    if not m:
        raise ValueError(
            f"invalid HVDT_TRANSPORT threshold {tok!r} in entry "
            f"{entry!r}; expected digits with an optional K/M/G suffix "
            f"(e.g. 64M)")
    return int(m.group(1)) * _SIZE_MULT[m.group(2).lower()]


def parse_transport(spec: str) -> Dict[str, AxisPolicy]:
    """Parse an ``HVDT_TRANSPORT`` spec into {axis: AxisPolicy}.  Unknown
    axis / algorithm / wire names and malformed thresholds raise
    ``ValueError`` listing the valid vocabulary."""
    entries: Dict[str, AxisPolicy] = {}
    for raw in spec.split(","):
        entry = raw.strip()
        if not entry:
            continue
        fields = [f.strip().lower() for f in entry.split(":")]
        if len(fields) not in (3, 4):
            raise ValueError(
                f"invalid HVDT_TRANSPORT entry {entry!r}; expected "
                f"axis:algorithm:wire[:threshold] (e.g. ici:ring:f32:64M)")
        axis, algorithm, wire = fields[:3]
        if axis not in VALID_AXES:
            raise ValueError(
                f"unknown HVDT_TRANSPORT axis {axis!r}; valid: "
                f"{', '.join(VALID_AXES)}")
        if algorithm not in ALGORITHMS:
            raise ValueError(
                f"unknown HVDT_TRANSPORT algorithm {algorithm!r} for axis "
                f"{axis!r}; valid: {', '.join(ALGORITHMS)}")
        if wire not in WIRES:
            raise ValueError(
                f"unknown HVDT_TRANSPORT wire {wire!r} for axis {axis!r}; "
                f"valid: {', '.join(WIRES)}")
        if axis == _mesh.TRANSPORT_ICI and wire in QUANT_WIRES:
            raise ValueError(
                f"HVDT_TRANSPORT: {wire} rides the slow (dcn) axis — "
                f"the fast-axis reduce-scatter leg has no quantized "
                f"wire format; put {wire} on dcn (e.g. "
                f"dcn:tree:{wire}:8M).  Valid wires: {', '.join(WIRES)} "
                f"(quantized: {', '.join(QUANT_WIRES)}, dcn-only)")
        if axis in entries:
            raise ValueError(f"duplicate HVDT_TRANSPORT axis {axis!r}")
        threshold = (_parse_threshold(fields[3], entry)
                     if len(fields) == 4 else None)
        entries[axis] = AxisPolicy(algorithm, wire, threshold)
    if not entries:
        raise ValueError(
            "empty HVDT_TRANSPORT spec; expected "
            "axis:algorithm:wire[:threshold] entries or 'auto'")
    return entries


class TransportPolicy:
    """Per-axis transport choices and the resolution that applies them
    to a reduce group."""

    def __init__(self, entries: Dict[str, AxisPolicy], spec: str = ""):
        self.entries = dict(entries)
        self.spec = spec

    @classmethod
    def parse(cls, spec: str) -> "TransportPolicy":
        spec = spec.strip()
        if spec.lower() == "auto":
            return cls.auto()
        return cls(parse_transport(spec), spec)

    @classmethod
    def auto(cls) -> "TransportPolicy":
        """Ring at f32 with the global fusion threshold on the fast tier;
        tree at f32 with 8 MiB buckets on the slow tier.  Only the
        schedule changes, never the math."""
        return cls({
            _mesh.TRANSPORT_ICI: AxisPolicy("ring", "f32", None),
            _mesh.TRANSPORT_DCN: AxisPolicy("tree", "f32",
                                            _AUTO_DCN_THRESHOLD),
        }, "auto")

    def _lookup(self, axis: str, cls_name: str) -> Optional[AxisPolicy]:
        """An exact mesh-axis entry wins over its transport class."""
        pol = self.entries.get(axis)
        if pol is None:
            pol = self.entries.get(cls_name)
        return pol

    def resolve(self, axis: Union[str, Tuple[str, ...]]
                ) -> Optional[ResolvedTransport]:
        """Apply this policy to a reduce group.

        A multi-axis group (outermost first) goes hierarchical: the
        innermost axis (the two innermost under ``2d_ring`` with three
        or more axes) is the fast reduce-scatter tier, the rest the slow
        tier.  A single-axis group resolves to a flat override when an
        entry (its exact name, else ``ici``) exists; None means the
        policy has nothing to say and the call site keeps its flat path.
        """
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        if len(axes) >= 2:
            fast = self._lookup(axes[-1], _mesh.TRANSPORT_ICI) \
                or AxisPolicy()
            width = 2 if (fast.algorithm == "2d_ring"
                          and len(axes) > 2) else 1
            slow_axes, fast_axes = _mesh.split_transport_axes(axes, width)
            slow = self._lookup(slow_axes[0], _mesh.TRANSPORT_DCN) \
                or AxisPolicy("tree")
            if slow.wire in QUANT_WIRES and len(slow_axes) != 1:
                raise ValueError(
                    f"{slow.wire} slow-axis wire needs exactly one slow "
                    f"axis, got {slow_axes} (quantized allreduce reduces "
                    f"over ONE mesh axis)")
            threshold = (fast.threshold_bytes
                         if fast.threshold_bytes is not None
                         else slow.threshold_bytes)
            return ResolvedTransport(
                kind="hierarchical", axes=axes, fast_axes=fast_axes,
                slow_axes=slow_axes, fast=fast, slow=slow,
                threshold_bytes=threshold)
        pol = self._lookup(axes[0], _mesh.TRANSPORT_ICI)
        if pol is None:
            return None
        return ResolvedTransport(
            kind="flat", axes=axes, fast_axes=axes, slow_axes=(),
            fast=pol, slow=None, threshold_bytes=pol.threshold_bytes)

    def describe(self) -> str:
        body = ",".join(f"{a}:{p.describe()}"
                        for a, p in sorted(self.entries.items()))
        return f"TransportPolicy({body})"


# ---------------------------------------------------------------------------
# The process-wide policy, cached on the raw env string (so a test that
# changes the variable gets a fresh one).
# ---------------------------------------------------------------------------

_TRUTHY_OFF = ("", "0", "off", "none", "false", "no")

_lock = threading.Lock()
_cached_env: Optional[str] = "\0unset"   # sentinel != any real env value
_cached_policy: Optional[TransportPolicy] = None


def enabled() -> bool:
    """Whether the transport-policy layer is on (``HVDT_TRANSPORT``)."""
    return os.environ.get("HVDT_TRANSPORT",
                          "").strip().lower() not in _TRUTHY_OFF


def get_policy() -> Optional[TransportPolicy]:
    """The process-wide transport policy, or None when off (one environ
    read and a string compare).  A malformed spec raises here, and so at
    ``hvd.init()`` through :func:`validate_env`."""
    global _cached_env, _cached_policy
    raw = os.environ.get("HVDT_TRANSPORT")
    if raw != _cached_env:
        with _lock:
            if raw != _cached_env:
                _cached_policy = (TransportPolicy.parse(raw)
                                  if enabled() else None)
                _cached_env = raw
    return _cached_policy


def resolve_axis(axis) -> Optional[ResolvedTransport]:
    """The active policy resolved against a reduce group; None when the
    layer is off or the policy has no entry for the group."""
    pol = get_policy()
    return None if pol is None else pol.resolve(axis)


def bucket_threshold(axis, explicit: Optional[int] = None) -> Optional[int]:
    """The fusion threshold a bucketed exchange over ``axis`` plans with:
    an explicit value wins, else the policy's per-axis threshold, else
    None (the env default)."""
    if explicit is not None:
        return explicit
    res = resolve_axis(axis)
    return None if res is None else res.threshold_bytes


def reset() -> None:
    """Drop the cached policy (test isolation)."""
    global _cached_env, _cached_policy
    with _lock:
        _cached_env = "\0unset"
        _cached_policy = None


def validate_env() -> Optional[TransportPolicy]:
    """Parse ``HVDT_TRANSPORT`` now (``hvd.init()`` calls this), so that
    unknown vocabulary fails at init with the valid lists."""
    pol = get_policy()
    if pol is not None:
        log.info("transport policy from env: %s", pol.describe())
    return pol
