"""Carry ResNet weights and optimizer state from the JAX package's numpy
pytrees into the PyTorch port (numpy in, tensors out; no JAX needed).

* conv weights HWIO → OIHW;
* ``fc_w`` ``[cin, classes]`` → ``[classes, cin]``;
* BN ``scale``/``bias`` and running ``mean``/``var`` copied.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

__all__ = ["resnet_params_from_jax", "optimizer_state_from_jax"]


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


def optimizer_state_from_jax(opt_state: Any, model: torch.nn.Module,
                             optimizer: torch.optim.Optimizer) -> None:
    """Copy an optax ``TraceState`` (``trace``) or ``ScaleByAdamState``
    (``count``, ``mu``, ``nu``) of ResNet params into the port's
    ``fused_sgd`` / ``fused_adam`` state, in place."""
    named = dict(model.named_parameters())
    # A NamedTuple always has .count (tuple.count): key on the fields.
    if hasattr(opt_state, "trace"):
        fields = {"trace": opt_state.trace}
    elif hasattr(opt_state, "mu"):
        fields = {"mu": opt_state.mu, "nu": opt_state.nu}
        for group in optimizer.param_groups:
            group["count"] = int(np.asarray(opt_state.count))
    else:
        raise TypeError(f"unsupported optimizer state {type(opt_state)!r}")
    with torch.no_grad():
        for field, tree in fields.items():
            for name, t in _param_tensors(tree).items():
                state = optimizer.state[named[name]][field]
                state.copy_(t.to(state.device))
