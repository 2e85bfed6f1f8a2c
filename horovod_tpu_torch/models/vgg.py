"""VGG-16 as an ``nn.Module``: the PyTorch counterpart of the JAX
package's ``models/vgg.py``.

The communication-heavy model of the reference's benchmark table: 138M
parameters at 224x224, most of them in the FC layers, so the gradient
exchange dominates a data-parallel step.  Same configuration (D: thirteen
3x3 convolutions, "SAME" padding, with bias and ReLU; five 2x2 max pools;
FC 4096-4096-classes), parameter names and numerics as the reference:

* public inputs are NHWC ``[N, H, W, 3]``; inside, activations are NCHW
  tensors in ``torch.channels_last`` memory;
* compute in ``cfg.dtype`` (bf16 by default) with f32 parameters cast at
  use; each bias is added after the convolution or matmul has been
  rounded to the compute dtype, then ReLU, as the reference's
  ``relu(conv(x) + b)``;
* the classifier flattens in H, W, C order, as the reference flattens
  its NHWC activations: ``fc1``'s rows are (h, w, c);
* FC weights are ``[in, out]`` (``x @ w``), conv weights OIHW; the logits
  are f32, the loss f32 log-softmax mean NLL.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..common.basics import DeviceLike, resolve_device

__all__ = ["VGGConfig", "VGG", "vgg16_init", "vgg_apply", "vgg_loss"]

# Configuration D (VGG-16): conv channels per layer, "M" = 2x2 max pool.
_VGG16 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
          512, 512, 512, "M", 512, 512, 512, "M")


@dataclasses.dataclass(frozen=True)
class VGGConfig:
    num_classes: int = 1000
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    image_size: int = 224


class _Layer(nn.Module):
    """One weight ``w`` and bias ``b``."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


class VGG(nn.Module):
    """VGG-16 with the reference's parameter names: ``conv{i}.w`` /
    ``conv{i}.b`` (``i`` the layer's index in configuration D, pools
    counted) and ``fc1``-``fc3``.  ``forward`` takes NHWC images and
    returns f32 logits."""

    def __init__(self, cfg: VGGConfig,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator()
        self.cfg = cfg
        pd = cfg.param_dtype
        cin = 3
        for i, c in enumerate(_VGG16):
            if c == "M":
                continue
            w = (torch.randn((c, cin, 3, 3), generator=gen)
                 * math.sqrt(2.0 / (9 * cin))).to(
                     dtype=pd, memory_format=torch.channels_last)
            setattr(self, f"conv{i}", _Layer(w, torch.zeros(c, dtype=pd)))
            cin = c
        flat = (cfg.image_size // 32) ** 2 * 512      # five 2x pools
        for name, (fi, fo) in (("fc1", (flat, 4096)), ("fc2", (4096, 4096)),
                               ("fc3", (4096, cfg.num_classes))):
            w = (torch.randn((fi, fo), generator=gen) * fi ** -0.5).to(pd)
            setattr(self, name, _Layer(w, torch.zeros(fo, dtype=pd)))
        self.to(dev)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.dtype
        x = images.to(dt).permute(0, 3, 1, 2)        # NCHW, channels_last
        for i, c in enumerate(_VGG16):
            if c == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            layer = getattr(self, f"conv{i}")
            x = F.conv2d(x, layer.w.to(dt), padding=1)
            x = torch.relu(x + layer.b.to(dt).view(1, -1, 1, 1))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)    # (h, w, c)
        for name, act in (("fc1", True), ("fc2", True), ("fc3", False)):
            layer = getattr(self, name)
            x = x @ layer.w.to(dt) + layer.b.to(dt)
            if act:
                x = torch.relu(x)
        return x.float()


def vgg16_init(seed: Union[int, torch.Generator], cfg: VGGConfig,
               device: DeviceLike = None) -> VGG:
    """VGG-16 with random weights drawn on the CPU from ``seed`` (He
    normal convolutions, FC scaled by ``fan_in ** -0.5``, zero biases, as
    the reference's init draws them), placed on ``device`` (the card
    unless the caller names another)."""
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    return VGG(cfg, generator=gen, device=device)


def vgg_apply(model: VGG, images: torch.Tensor) -> torch.Tensor:
    """images: [N, H, W, 3] -> f32 logits [N, classes]."""
    return model(images)


def vgg_loss(model: VGG, images: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy loss in f32."""
    logp = F.log_softmax(vgg_apply(model, images), -1)
    return -logp.gather(1, labels[:, None].long()).mean()
