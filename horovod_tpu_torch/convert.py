"""Carry model weights and optimizer state from the JAX package's numpy
pytrees into the PyTorch port (numpy in, tensors out; no JAX needed).

ResNet:
* conv weights HWIO → OIHW;
* ``fc_w`` ``[cin, classes]`` → ``[classes, cin]``;
* BN ``scale``/``bias`` and running ``mean``/``var`` copied.

Transformer: every leaf copied under its dotted name (``embed``,
``ln_f``, ``block.wq``, ...): the port keeps ``x @ w`` with ``w`` as
[in, out] and the block leaves stacked [layers, ...], as the reference
does, the MoE leaves too (``block.w_router`` [L, d, E], ``block.w_up``
[L, E, d, f], ``block.w_down`` [L, E, f, d]).  ``pp=(rank, pp)`` /
``ep=(rank, ep)`` / ``tp=(rank, tp)`` / ``fsdp=(rank, fsdp)`` keep one
member's part: its stage's layers, its experts, its heads and MLP
columns, its part of the ``embed`` dimension.

VGG-16: ``conv{i}.w`` HWIO → OIHW; ``fc{j}.w`` stays [in, out] (the
port flattens in the reference's H, W, C order, so ``fc1``'s rows need
no permutation); biases copied.  MLP: every leaf copied.  SyncBN adds no
parameters: a ResNet with ``bn_axis`` loads the same state.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

__all__ = ["resnet_params_from_jax", "transformer_params_from_jax",
           "vgg_params_from_jax", "mlp_params_from_jax",
           "optimizer_state_from_jax"]


def _tensor(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def _param_tensors(params: Dict) -> Dict[str, torch.Tensor]:
    """A params-shaped tree (params, or an optimizer moment of them) →
    the port's parameter names, in the port's layouts."""
    out: Dict[str, torch.Tensor] = {}

    def put(name: str, leaf: Any) -> None:
        a = np.asarray(leaf)
        if name.rsplit(".", 1)[-1].startswith("conv"):
            a = a.transpose(3, 2, 0, 1)          # HWIO → OIHW
        elif name == "fc_w":
            a = a.T                        # [cin, classes] → [classes, cin]
        out[name] = _tensor(np.ascontiguousarray(a))

    def walk(prefix: str, node: Any) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}.{k}" if prefix else k, v)
        else:
            put(prefix, node)

    walk("", params)
    return out


def resnet_params_from_jax(params_np: Dict, stats_np: Dict
                           ) -> Dict[str, torch.Tensor]:
    """The JAX package's ResNet ``(params, batch_stats)`` numpy pytrees →
    a ``state_dict`` for :class:`horovod_tpu_torch.models.resnet.ResNet`
    (load it with ``model.load_state_dict``)."""
    sd = _param_tensors(params_np)

    def walk(prefix: str, node: Dict) -> None:
        for k, v in node.items():
            name = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                walk(name, v)
            else:
                sd[name] = _tensor(v)

    walk("", stats_np)
    return sd


def transformer_params_from_jax(params_np: Dict, *, pp=None, ep=None,
                                tp=None, fsdp=None
                                ) -> Dict[str, torch.Tensor]:
    """The JAX package's transformer ``params`` numpy pytree → a
    ``state_dict`` for :class:`horovod_tpu_torch.models.transformer.
    Transformer` (copies, same layouts).  ``pp=(pp_rank, pp)``,
    ``ep=(ep_rank, ep)``, ``tp=(tp_rank, tp)`` and ``fsdp=(fsdp_rank,
    fsdp)`` keep one member's part of every leaf under the reference's
    rules (``parallel.local_part``): its ``layers / pp`` layers, its ``E /
    ep`` experts of ``w_up`` / ``w_down``, its ``heads`` / ``mlp`` columns
    or rows under ``tp`` and its ``d_model / fsdp`` of every ``embed``
    dimension, so that the module of that member holds exactly its part
    of the global parameters."""
    from .models.transformer import _logical_axes
    from .parallel.sharding import local_part, transformer_rules

    out = _param_tensors(params_np)
    moe = "w_router" in params_np.get("block", {})
    axes = _logical_axes(moe)
    given = {"pp": pp, "ep": ep if moe else None, "tp": tp, "fsdp": fsdp}
    sizes = {a: int(v[1]) for a, v in given.items() if v is not None}
    coords = {a: int(v[0]) for a, v in given.items() if v is not None}
    rules = transformer_rules(fsdp=fsdp is not None)
    for name in list(out):
        logical = (axes["block"][name[6:]] if name.startswith("block.")
                   else axes[name])
        out[name] = local_part(out[name], logical, rules, sizes,
                               coords).contiguous().clone()
    return out


def vgg_params_from_jax(params_np: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's VGG ``params`` numpy pytree → a ``state_dict``
    for :class:`horovod_tpu_torch.models.vgg.VGG`."""
    out: Dict[str, torch.Tensor] = {}
    for layer, leaves in params_np.items():
        for k, v in leaves.items():
            a = np.asarray(v)
            if layer.startswith("conv") and k == "w":
                a = a.transpose(3, 2, 0, 1)          # HWIO → OIHW
            out[f"{layer}.{k}"] = _tensor(np.ascontiguousarray(a))
    return out


def mlp_params_from_jax(params_np: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's MLP ``params`` (``w{i}``, ``b{i}``) → a
    ``state_dict`` for :class:`horovod_tpu_torch.models.mlp.MLP`."""
    return {k: _tensor(v) for k, v in params_np.items()}


def _moments_state(opt_state: Any) -> Any:
    """The ``TraceState`` / ``ScaleByAdamState`` inside ``opt_state``: the
    state itself, or the first such member of an optax chain's tuple
    (``optax.adamw``'s is ``opt_state[0]``)."""
    if hasattr(opt_state, "trace") or hasattr(opt_state, "mu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for member in opt_state:
            found = _moments_state(member)
            if found is not None:
                return found
    return None


def optimizer_state_from_jax(opt_state: Any, model: torch.nn.Module,
                             optimizer: torch.optim.Optimizer) -> None:
    """Copy an optax ``TraceState`` (``trace``) or ``ScaleByAdamState``
    (``count``, ``mu``, ``nu``) of the model's params into the port's
    ``fused_sgd`` / ``fused_adam`` state, in place.  A chain's state (a
    tuple, as ``optax.adamw`` gives) is searched for its first such
    member."""
    named = dict(model.named_parameters())
    state = _moments_state(opt_state)
    # A NamedTuple always has .count (tuple.count): key on the fields.
    if state is None:
        raise TypeError(f"unsupported optimizer state {type(opt_state)!r}")
    if hasattr(state, "trace"):
        fields = {"trace": state.trace}
    else:
        fields = {"mu": state.mu, "nu": state.nu}
        for group in optimizer.param_groups:
            group["count"] = int(np.asarray(state.count))
    with torch.no_grad():
        for field, tree in fields.items():
            for name, t in _param_tensors(tree).items():
                dst = optimizer.state[named[name]][field]
                dst.copy_(t.to(dst.device))
