"""Small MLP classifier (the MNIST-class example model): the PyTorch
counterpart of the JAX package's ``models/mlp.py``.

Sizes 784-256-128-10 by default; parameters ``w{i}`` ``[in, out]`` and
``b{i}``, as the reference names them; ``x @ w + b`` with ReLU between
layers, in the parameters' dtype (f32); loss f32 log-softmax mean NLL.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..common.basics import DeviceLike, resolve_device

__all__ = ["MLP", "mlp_init", "mlp_apply", "mlp_loss"]


class MLP(nn.Module):
    """Layers ``w0``/``b0`` ... ``w{n-1}``/``b{n-1}``."""

    def __init__(self, sizes: Sequence[int], generator: torch.Generator,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.layers = len(sizes) - 1
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            setattr(self, f"w{i}", nn.Parameter(
                torch.randn((a, b), generator=generator) * a ** -0.5))
            setattr(self, f"b{i}", nn.Parameter(torch.zeros(b)))
        self.to(dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.layers):
            x = x @ getattr(self, f"w{i}") + getattr(self, f"b{i}")
            if i < self.layers - 1:
                x = torch.relu(x)
        return x


def mlp_init(seed: Union[int, torch.Generator],
             sizes: Sequence[int] = (784, 256, 128, 10),
             device: DeviceLike = None) -> MLP:
    """An MLP of ``sizes`` with random weights drawn on the CPU from
    ``seed`` (normal scaled by ``fan_in ** -0.5``, zero biases), placed
    on ``device`` (the card unless the caller names another)."""
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    return MLP(sizes, gen, device)


def mlp_apply(model: MLP, x: torch.Tensor) -> torch.Tensor:
    """x: [N, sizes[0]] -> logits [N, sizes[-1]]."""
    return model(x)


def mlp_loss(model: MLP, x: torch.Tensor, labels: torch.Tensor
             ) -> torch.Tensor:
    """Cross-entropy loss."""
    logp = F.log_softmax(mlp_apply(model, x), -1)
    return -logp.gather(1, labels[:, None].long()).mean()
