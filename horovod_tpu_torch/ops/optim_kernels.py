"""Fused optimizer updates: one pass over the parameters per step.

The PyTorch counterpart of the JAX package's ``ops/optim_kernels.py``.
A stock Adam step is some ten elementwise passes over every parameter
(moment decay, moment update, two bias corrections, sqrt, divide,
scale, apply); these kernels run the whole recurrence in f32 registers
and touch each parameter's bytes once.

Two multi-tensor CUDA kernels for Hopper in ``csrc/optim.cu``, built at
first use:

* ``hvdt_adam_multi`` (replaces the TPU kernel ``_adam_kernel``):
  Adam/AdamW — ``m, v`` update, bias-corrected ``u``, additive weight
  decay, ``delta = -lr * u``;
* ``hvdt_sgd_multi`` (replaces ``_sgd_kernel``): the momentum/nesterov
  trace, ``delta = -lr * u``.

One launch walks every leaf of a table: per leaf its pointers, element
count, first chunk and an alignment flag (:data:`_LEAF`), carried in the
kernel's parameters.  ``FusedSGD.step()`` and ``FusedAdam.step()``
launch once for each (param group, device, dtype combination) of the
leaves that have a grad, cut into tables of at most :data:`_TABLE_CAP`
leaves: for ResNet-50's 161 leaves and the transformer LM's 11, one
launch a step.  What does not change from step to step (the params' and
moments' device, dtype, layout and pointers) is checked once, when the
tables are built, and the tables are cached on the optimizer; a step
gathers only the grads' pointers and layouts.  The cache is dropped by
``load_state_dict`` and ``add_param_group``; a parameter or moment given
new storage some other way (``p.data = ...``) needs a new optimizer.

The scalars follow the JAX package exactly: lr comes from the
pre-increment step count, the bias corrections from the incremented
count, ``eps_root`` sits inside the sqrt and ``eps`` outside it, weight
decay is additive; the kernels use IEEE-rounded sqrt and division and
no fused multiply-add, so they round as the plain versions do.

Each update takes the plain PyTorch version for tensors on the CPU, or
when the caller passes ``use_kernels=False``; on a CUDA tensor it
launches its kernel or raises.  ``launches`` on ``_sgd_multi`` and
``_adam_multi`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import (Any, Callable, Dict, Hashable, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

__all__ = ["fused_adam", "fused_sgd", "fused_update_eligible",
           "sgd_leaf_update", "adam_leaf_update", "FusedAdam", "FusedSGD"]

# The table layout of csrc/optim.cu (checked against the library when it
# loads): one record per leaf, after a 64-byte header of scalars and
# counts, all inside CUDA's 32,764 bytes of kernel parameters.
_LEAF = np.dtype([("p", "<u8"), ("g", "<u8"), ("m", "<u8"), ("v", "<u8"),
                  ("d", "<u8"), ("n", "<i8"), ("chunk0", "<i4"),
                  ("aligned", "<i4")])
_OPERANDS = ("p", "g", "m", "v", "d")
_HEADER_BYTES = 64
_PARAM_BYTES = 32764
_TABLE_CAP = (_PARAM_BYTES - _HEADER_BYTES) // _LEAF.itemsize
_CHUNK = 16384          # elements a CTA
_ALIGN = 16             # bytes a vector access needs
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_APPLY, _NESTEROV, _WEIGHT_DECAY = 1, 2, 4


def fused_update_eligible(leaf: torch.Tensor, *extra_dtypes) -> bool:
    """True when ``leaf`` can take the fused kernel: a non-empty floating
    tensor of 2 bytes or more, with ``extra_dtypes`` (the moments') the
    same kind.  The TPU's 128-lane and sublane tiling floors do not
    apply on the card."""
    for d in (leaf.dtype, *extra_dtypes):
        if not d.is_floating_point or d.itemsize < 2:
            return False
    return leaf.numel() > 0


# ---- the host side of a launch: tables of leaves ---------------------------


@dataclass
class _Table:
    """The leaves of one launch: ``rec`` is the kernel's table, ``index``
    each record's position in the caller's list of leaves."""
    group: Hashable
    dtypes: int
    index: np.ndarray
    rec: np.ndarray
    nchunks: int

    def set_grads(self, gptrs: np.ndarray) -> None:
        """Take the grads' pointers (indexed like the caller's leaves)
        and recompute the alignment flags."""
        self.rec["g"] = gptrs[self.index]
        self.rec["aligned"] = np.logical_and.reduce(
            [self.rec[name] % _ALIGN == 0 for name in _OPERANDS])


def _pack_dtypes(codes: Sequence[int]) -> int:
    """The kernel's dtype word: 4-bit codes of p, g, m, v, d."""
    return sum(c << (4 * i) for i, c in enumerate(codes))


def _build_tables(groups: Sequence[Hashable], codes: Sequence[Tuple[int, ...]],
                  numels: Sequence[int], ptrs: np.ndarray,
                  cap: Optional[int] = None) -> List[_Table]:
    """Tables for leaves ``i`` with group ``groups[i]``, dtype codes
    ``codes[i]`` (p, g, m, v, d; 0 where unused), ``numels[i]`` elements
    and pointers ``ptrs[i]`` (uint64 [n, 5], 0 where unused).  Leaves are
    grouped by (group, codes) in order of first appearance, each group
    cut into runs of at most ``cap`` (default :data:`_TABLE_CAP`)
    leaves; each leaf's first chunk is the running sum of the chunks
    before it in its table."""
    cap = cap or _TABLE_CAP
    ptrs = np.asarray(ptrs, np.uint64).reshape(-1, len(_OPERANDS))
    numels = np.asarray(numels, np.int64)
    order: Dict[Tuple[Hashable, Tuple[int, ...]], List[int]] = {}
    for i, key in enumerate(zip(groups, map(tuple, codes))):
        order.setdefault(key, []).append(i)
    tables = []
    for (group, code), members in order.items():
        for start in range(0, len(members), cap):
            index = np.asarray(members[start:start + cap], np.int64)
            chunks = -(-numels[index] // _CHUNK)
            rec = np.zeros(len(index), _LEAF)
            for col, name in enumerate(_OPERANDS):
                rec[name] = ptrs[index, col]
            rec["n"] = numels[index]
            rec["chunk0"] = np.cumsum(chunks) - chunks
            table = _Table(group, _pack_dtypes(code), index, rec,
                           int(chunks.sum()))
            table.set_grads(ptrs[:, 1])
            tables.append(table)
    return tables


def _chunk_owner(rec: np.ndarray, block: int) -> Tuple[int, int, int]:
    """What CTA ``block`` of a launch over ``rec`` updates, as the kernel
    computes it: (leaf, first element, end element)."""
    leaf = int(np.searchsorted(rec["chunk0"], block, side="right")) - 1
    start = (block - int(rec["chunk0"][leaf])) * _CHUNK
    return leaf, start, min(start + _CHUNK, int(rec["n"][leaf]))


def _same_layout(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same shape and the same element order in memory (strides agree on
    every dimension longer than 1)."""
    return a.shape == b.shape and all(
        sa == sb for sa, sb, n in zip(a.stride(), b.stride(), a.shape)
        if n > 1)


def _in_layout_of(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``g`` with ``p``'s memory layout (a copy only when they differ)."""
    return g if _same_layout(g, p) else torch.empty_like(p).copy_(g)


def _check_cuda_leaf(*ts: torch.Tensor) -> None:
    """Operands the kernels can take: on CUDA, and :func:`_check_leaf`."""
    if ts[0].device.type != "cuda":
        raise ValueError(f"fused optimizer kernels run on CUDA, got "
                         f"{ts[0].device}")
    _check_leaf(*ts)


def _check_leaf(*ts: torch.Tensor) -> None:
    """The kernels walk every operand as one flat, dense buffer in the
    same element order: same device, shape and layout, dense, and of a
    type the kernels take."""
    ref = ts[0]
    if any(t.dtype not in _DTYPE_CODE for t in ts):
        raise TypeError("fused optimizer kernels take float32, bfloat16 or "
                        f"float16 tensors, got {[t.dtype for t in ts]}")
    for t in ts:
        if t.device != ref.device or not _same_layout(t, ref):
            raise ValueError("fused optimizer operands must share device, "
                             "shape and memory layout")
    if not (ref.is_contiguous()
            or ref.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError("fused optimizer operands must be dense")


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _one_leaf(p=None, g=None, m=None, v=None, d=None) -> _Table:
    """The table of one CUDA leaf (operands that are None are unused)."""
    ops = (p, g, m, v, d)
    codes = [0 if t is None else _DTYPE_CODE[t.dtype] for t in ops]
    ptrs = np.array([[0 if t is None else t.data_ptr() for t in ops]],
                    np.uint64)
    return _build_tables([None], [codes], [g.numel()], ptrs)[0]


# ---- the launches ----------------------------------------------------------


def _lib() -> ctypes.CDLL:
    from .._build import load_library

    lib = load_library("optim")
    if not getattr(lib, "_hvdt_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        for name in ("hvdt_sgd_multi", "hvdt_adam_multi"):
            fn = getattr(lib, name)
            fn.argtypes = [p, i, i, i, i, p, p]
            fn.restype = i
        lib.hvdt_optim_layout.argtypes = [p]
        lib.hvdt_optim_layout.restype = i
        got = (ctypes.c_int * 4)()
        lib.hvdt_optim_layout(got)
        want = (_TABLE_CAP, _LEAF.itemsize, _HEADER_BYTES, _CHUNK)
        if tuple(got) != want:
            raise RuntimeError(f"csrc/optim.cu table layout {tuple(got)} "
                               f"differs from the wrapper's {want}")
        lib._hvdt_typed = True
    return lib


def _launch(entry: str, table: _Table, scalars: Sequence[float], flags: int,
            device: torch.device) -> None:
    """Call the C entry on ``device``'s current stream; raises on a CUDA
    error.  The scalars round to f32 as PyTorch rounds a Python scalar."""
    sc = np.asarray(scalars, np.float32)
    with torch.cuda.device(device):
        rc = getattr(_lib(), entry)(
            table.rec.ctypes.data, len(table.rec), table.nchunks,
            table.dtypes, flags, sc.ctypes.data,
            torch.cuda.current_stream(device).cuda_stream)
    if rc:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")


def _sgd_multi(table: _Table, lr: float, momentum: float, *, nesterov: bool,
               apply: bool, device: torch.device) -> None:
    """#2: one launch of ``hvdt_sgd_multi`` over every leaf of ``table``."""
    flags = (_APPLY if apply else 0) | (_NESTEROV if nesterov else 0)
    _launch("hvdt_sgd_multi", table, [lr, momentum], flags, device)
    _sgd_multi.launches += 1


def _adam_multi(table: _Table, scalars: Sequence[float], *, b1: float,
                b2: float, eps: float, eps_root: float, wd: float,
                apply: bool, device: torch.device) -> None:
    """#1: one launch of ``hvdt_adam_multi`` over every leaf of ``table``;
    ``scalars`` is ``[lr, 1/(1-b1^t), 1/(1-b2^t)]``."""
    flags = (_APPLY if apply else 0) | (_WEIGHT_DECAY if wd else 0)
    _launch("hvdt_adam_multi", table,
            [*scalars, b1, 1.0 - b1, b2, 1.0 - b2, eps, eps_root, wd],
            flags, device)
    _adam_multi.launches += 1


_sgd_multi.launches = 0
_adam_multi.launches = 0


class _Plan:
    """The kernel side of an optimizer step for one set of leaves with a
    grad: their tables, checked and built once.  ``leaves`` is a list of
    (position in the step's grads, param group index, p, moments)."""

    def __init__(self, leaves):
        self.pos = [pos for pos, _, _, _ in leaves]
        self.params = [p for _, _, p, _ in leaves]
        self.strides = [p.stride() for p in self.params]
        self._moments = [st for _, _, _, st in leaves]   # kept alive
        groups, codes, numels, ptrs = [], [], [], []
        for _, gi, p, (m, v) in leaves:
            _check_cuda_leaf(p, m, *(() if v is None else (v,)))
            groups.append((gi, p.device))
            codes.append((_DTYPE_CODE[p.dtype], _DTYPE_CODE[p.dtype],
                          _DTYPE_CODE[m.dtype],
                          0 if v is None else _DTYPE_CODE[v.dtype], 0))
            numels.append(p.numel())
            ptrs.append((p.data_ptr(), 0, m.data_ptr(),
                         0 if v is None else v.data_ptr(), 0))
        self.tables = _build_tables(groups, codes, numels,
                                    np.array(ptrs, np.uint64))

    def set_grads(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Put this step's grads into the tables; returns the copies made
        for grads in another layout than their param, which must live
        until the launches are enqueued.  (PyTorch's ``.grad`` setter
        keeps a grad's dtype, device and shape those of its param.)"""
        gs = [grads[pos] for pos in self.pos]
        copies = []
        if [g.stride() for g in gs] != self.strides:
            for j, (g, p) in enumerate(zip(gs, self.params)):
                if g.stride() != self.strides[j]:
                    gs[j] = _in_layout_of(g, p)
                    copies.append(gs[j])
        gptrs = np.array([g.data_ptr() for g in gs], np.uint64)
        for t in self.tables:
            t.set_grads(gptrs)
        return copies


class _MultiTensorOptimizer(torch.optim.Optimizer):
    """What FusedSGD and FusedAdam share: the flat list of leaves and the
    cached :class:`_Plan` per set of leaves that have a grad."""

    _MAX_PLANS = 8

    def _moments(self, gi: int, p) -> Optional[Tuple[torch.Tensor, Any]]:
        """(m, v or None) of leaf ``p`` of group ``gi`` if the kernel
        takes it, else None."""
        raise NotImplementedError

    def _plan(self, grads, key: tuple) -> Tuple[_Plan, List[int]]:
        """(plan, positions of the leaves the plain version takes) for
        this step's ``grads``, built on first sight of ``key``."""
        hit = self._plans.get(key)
        if hit is None:
            leaves, plain = [], []
            for pos, ((gi, p), g) in enumerate(zip(self._leaves, grads)):
                if g is None:
                    continue
                st = (self._moments(gi, p) if self.use_kernels
                      and not _on_cpu(p) and p.numel() else None)
                if st is None:
                    plain.append(pos)
                else:
                    leaves.append((pos, gi, p, st))
            if len(self._plans) >= self._MAX_PLANS:
                self._plans.clear()
            hit = self._plans[key] = (_Plan(leaves), plain)
        return hit

    def _grads(self):
        """This step's grads in leaf order, and the key of their plan."""
        grads = [p.grad for _, p in self._leaves]
        missing = tuple(i for i, g in enumerate(grads) if g is None)
        return grads, (self.use_kernels, missing)

    def _init_state(self, group: dict) -> None:
        """Zero moments for every parameter of ``group``."""
        raise NotImplementedError

    def add_param_group(self, param_group: dict) -> None:
        """Add a group and create its state (also for the groups given at
        construction, which ``torch.optim.Optimizer.__init__`` adds
        through here)."""
        super().add_param_group(param_group)
        self._init_state(self.param_groups[-1])
        self._leaves = [(gi, p) for gi, group in enumerate(self.param_groups)
                        for p in group["params"]]
        self._plans: Dict[tuple, Tuple[_Plan, List[int]]] = {}

    def load_state_dict(self, state_dict: dict) -> None:
        """Load as ``torch.optim.Optimizer`` does, but keep each state
        tensor in its saved dtype (the base class casts it to its
        parameter's, which would turn a bf16 ``mu`` into f32)."""
        ids = [i for g in state_dict["param_groups"] for i in g["params"]]
        super().load_state_dict(state_dict)
        for i, (_, p) in zip(ids, self._leaves):
            for key, v in state_dict["state"].get(i, {}).items():
                if isinstance(v, torch.Tensor):
                    self.state[p][key] = v.detach().to(p.device, copy=True)
        self._plans = {}


# ---- SGD (momentum) ------------------------------------------------------


def _sgd_leaf_plain(g, m, lr: float, *, momentum: float, nesterov: bool,
                    p: Optional[torch.Tensor] = None):
    """Plain version of ``hvdt_sgd_multi`` over one leaf: the same f32
    formulas; m is updated in place; with ``p`` the delta is applied to
    it in place."""
    g32 = g.float()
    m_new = g32 + momentum * m.float()
    u = g32 + momentum * m_new if nesterov else m_new
    m.copy_(m_new)
    if p is not None:
        p.add_((-lr * u).to(p.dtype))
        return None, m
    return (-lr * u).to(g.dtype), m


def sgd_leaf_update(g: torch.Tensor, m: torch.Tensor,
                    scalars: Sequence[float], *, momentum: float,
                    nesterov: bool = False, use_kernels: bool = True):
    """Per-leaf SGD-momentum update ``(delta, new_trace)``; ``scalars``
    is ``[lr]``.  The trace ``m`` is updated in place and returned."""
    lr = float(scalars[0])
    if g.numel() == 0 or _on_cpu(g) or not use_kernels:
        return _sgd_leaf_plain(g, m, lr, momentum=momentum,
                               nesterov=nesterov)
    _check_cuda_leaf(g, m)
    d = torch.empty_like(g)
    _sgd_multi(_one_leaf(g=g, m=m, d=d), lr, momentum, nesterov=nesterov,
               apply=False, device=g.device)
    return d, m


class FusedSGD(_MultiTensorOptimizer):
    """``optax.sgd`` semantics as a ``torch.optim.Optimizer``: with
    ``momentum`` one ``hvdt_sgd_multi`` launch a step updates every CUDA
    leaf (trace update and apply); without it there is no state and the
    step is one plain scale-and-add per leaf, as in the JAX package.
    State per parameter: ``{"trace": m}``, zeros from construction or
    from ``add_param_group`` (optax's ``TraceState``)."""

    def __init__(self, params, learning_rate: float, momentum: float = 0.0,
                 nesterov: bool = False, *, use_kernels: bool = True):
        if callable(learning_rate):
            raise ValueError(
                "fused_sgd takes a float learning_rate (its state carries "
                "no step count for a schedule); use fused_adam for "
                "schedule support")
        self.use_kernels = use_kernels
        super().__init__(params, dict(lr=float(learning_rate),
                                      momentum=float(momentum),
                                      nesterov=bool(nesterov)))

    def _init_state(self, group):
        if group["momentum"]:
            for p in group["params"]:
                self.state[p]["trace"] = torch.zeros_like(p)

    def _moments(self, gi, p):
        if not self.param_groups[gi]["momentum"]:
            return None
        return self.state[p]["trace"], None

    @torch.no_grad()
    def step(self, closure: Optional[Callable[[], Any]] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        grads, key = self._grads()
        key += (tuple(bool(g["momentum"]) for g in self.param_groups),)
        plan, plain = self._plan(grads, key)
        for pos in plain:
            gi, p = self._leaves[pos]
            group = self.param_groups[gi]
            lr, mom = group["lr"], group["momentum"]
            if not mom:
                p.add_((-lr * grads[pos].float()).to(p.dtype))
                continue
            _sgd_leaf_plain(_in_layout_of(grads[pos], p),
                            self.state[p]["trace"], lr, momentum=mom,
                            nesterov=group["nesterov"], p=p)
        copies = plan.set_grads(grads)
        for t in plan.tables:
            gi, device = t.group
            group = self.param_groups[gi]
            _sgd_multi(t, group["lr"], group["momentum"],
                       nesterov=group["nesterov"], apply=True, device=device)
        del copies
        return loss


def fused_sgd(params, learning_rate: float, momentum: float = 0.0,
              nesterov: bool = False, *, use_kernels: bool = True
              ) -> FusedSGD:
    """``optax.sgd`` drop-in over ``params`` (see :class:`FusedSGD`)."""
    return FusedSGD(params, learning_rate, momentum, nesterov,
                    use_kernels=use_kernels)


# ---- Adam ----------------------------------------------------------------


def _adam_scalars(count: int, learning_rate, b1: float, b2: float):
    """``[lr, 1/(1-b1^t), 1/(1-b2^t)]`` in f32: lr at the pre-increment
    count, the bias corrections at the incremented count t."""
    f32 = np.float32
    lr = learning_rate(count) if callable(learning_rate) else learning_rate
    t = f32(count + 1)
    one = f32(1.0)
    return [float(f32(lr)),
            float(one / (one - np.power(f32(b1), t))),
            float(one / (one - np.power(f32(b2), t)))]


def _adam_leaf_plain(p, g, m, v, scalars, *, b1, b2, eps, eps_root, wd,
                     apply: bool):
    """Plain version of ``hvdt_adam_multi`` over one leaf: the same f32
    formulas; m, v updated in place; with ``apply`` the delta goes into
    p in place."""
    lr, bc1, bc2 = scalars
    g32 = g.float()
    m_new = b1 * m.float() + (1.0 - b1) * g32
    v_new = b2 * v.float() + (1.0 - b2) * (g32 * g32)
    u = (m_new * bc1) / (torch.sqrt(v_new * bc2 + eps_root) + eps)
    if wd:
        u = u + wd * p.float()
    m.copy_(m_new)
    v.copy_(v_new)
    if apply:
        p.add_((-lr * u).to(p.dtype))
        return None, m, v
    return (-lr * u).to(p.dtype), m, v


def adam_leaf_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                     v: torch.Tensor, scalars: Sequence[float], *,
                     b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                     eps_root: float = 0.0, weight_decay: float = 0.0,
                     use_kernels: bool = True):
    """Per-leaf Adam update ``(delta, m_new, v_new)``; ``scalars`` is
    ``[lr, 1/(1-b1^t), 1/(1-b2^t)]``.  m and v are updated in place."""
    scalars = [float(s) for s in scalars]
    kw = dict(b1=b1, b2=b2, eps=eps, eps_root=eps_root, wd=weight_decay)
    if g.numel() == 0 or _on_cpu(g) or not use_kernels:
        return _adam_leaf_plain(p, g, m, v, scalars, apply=False, **kw)
    _check_cuda_leaf(p, g, m, v)
    d = torch.empty_like(p)
    _adam_multi(_one_leaf(p, g, m, v, d), scalars, apply=False,
                device=g.device, **kw)
    return d, m, v


class FusedAdam(_MultiTensorOptimizer):
    """``optax.adam``/``adamw`` semantics as a ``torch.optim.Optimizer``:
    one ``hvdt_adam_multi`` launch a step updates every CUDA leaf
    (moments, bias correction, decay and apply).  ``learning_rate`` may
    be a float or a schedule ``count -> lr``, evaluated at the
    pre-increment count.  State per parameter: ``{"mu", "nu"}``, zeros
    (``mu`` in ``mu_dtype``) from construction or from
    ``add_param_group``, kept in their dtypes through
    ``load_state_dict``; the step count (optax's
    ``ScaleByAdamState.count``) is ``group["count"]``, and a group added
    later starts at 0.
    """

    def __init__(self, params, learning_rate: Union[float, Callable],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0, *, weight_decay: float = 0.0,
                 mu_dtype: Optional[torch.dtype] = None,
                 use_kernels: bool = True):
        self.use_kernels = use_kernels
        self.mu_dtype = mu_dtype
        super().__init__(params, dict(
            learning_rate=learning_rate, b1=float(b1), b2=float(b2),
            eps=float(eps), eps_root=float(eps_root),
            weight_decay=float(weight_decay), count=0))

    def _init_state(self, group):
        for p in group["params"]:
            self.state[p]["mu"] = torch.zeros_like(
                p, dtype=self.mu_dtype or p.dtype)
            self.state[p]["nu"] = torch.zeros_like(p)

    def _moments(self, gi, p):
        st = self.state[p]
        return st["mu"], st["nu"]

    @torch.no_grad()
    def step(self, closure: Optional[Callable[[], Any]] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        grads, key = self._grads()
        plan, plain = self._plan(grads, key)
        scalars = [_adam_scalars(g["count"], g["learning_rate"], g["b1"],
                                 g["b2"]) for g in self.param_groups]

        def hyper(group):
            return dict(b1=group["b1"], b2=group["b2"], eps=group["eps"],
                        eps_root=group["eps_root"],
                        wd=group["weight_decay"])

        for pos in plain:
            gi, p = self._leaves[pos]
            st = self.state[p]
            _adam_leaf_plain(p, _in_layout_of(grads[pos], p), st["mu"],
                             st["nu"], scalars[gi], apply=True,
                             **hyper(self.param_groups[gi]))
        copies = plan.set_grads(grads)
        for t in plan.tables:
            gi, device = t.group
            _adam_multi(t, scalars[gi], apply=True, device=device,
                        **hyper(self.param_groups[gi]))
        del copies
        for group in self.param_groups:
            group["count"] += 1
        return loss


def fused_adam(params, learning_rate: Union[float, Callable],
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               eps_root: float = 0.0, *, weight_decay: float = 0.0,
               mu_dtype: Optional[torch.dtype] = None,
               use_kernels: bool = True) -> FusedAdam:
    """``optax.adam``/``adamw`` drop-in over ``params`` (see
    :class:`FusedAdam`)."""
    return FusedAdam(params, learning_rate, b1, b2, eps, eps_root,
                     weight_decay=weight_decay, mu_dtype=mu_dtype,
                     use_kernels=use_kernels)
