"""ResNet-50 (v1.5) as an ``nn.Module``: the PyTorch counterpart of the
JAX package's ``models/resnet.py``.

Same configuration, stage layouts (depth 26/50/101), parameter names and
numerics as the reference:

* public inputs are NHWC ``[N, H, W, 3]``; inside, activations are NCHW
  tensors in ``torch.channels_last`` memory, so a 1x1 conv's
  ``[B*H*W, C]`` view needs no copy;
* convolutions pad as JAX's ``"SAME"`` does — a stride-2 3x3 conv on an
  even size pads (0, 1), not (1, 1) — and the stem max pool pads (0, 1)
  with -inf; both pads are explicit;
* BatchNorm takes its batch statistics in f32 with the biased variance
  ``E[x²] - mean²``, folds the coefficients in f32, casts them to the
  activation dtype and applies ``y = x*a + b`` there; the running-stat
  EMA takes the biased variance (``nn.BatchNorm2d`` differs on all three
  counts and is not used);
* the stem is the exact space-to-depth rewrite of the 7x7/2 conv;
* the head averages bf16 activations, then works in f32; the loss is
  f32 log-softmax mean NLL;
* ``bn_axis`` (SyncBatchNorm, the reference's ``cfg.bn_axis``): train
  mode takes the batch statistics of the global batch over the model's
  ``bn_group`` (a process group, a ``DeviceMesh`` whose ``bn_axis``
  dimension is taken, or None for the world): the unfused BN averages
  its moments with ``sync_batch_norm.sync_batch_stats``, the fused 1x1
  convs sum their partial sums (``conv1x1_bn_train(axis=...)``);
* ``HVDT_FUSED_CONV1X1=1`` routes the same 1x1 convs as the reference
  (:func:`_fused_1x1_eligible`) through the fused conv kernels
  (``ops/conv_fused.py``) — 26 per forward at ResNet-50.  The 3x3
  convs, the stem and the FC layer are plain PyTorch, as XLA computed
  them in the reference.

The module holds parameters and the running statistics (buffers); a
train-mode forward updates the running statistics in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..common import config
from ..common.basics import DeviceLike, resolve_device
from ..ops.conv_fused import conv1x1_bn_relu, conv1x1_bn_train
from ..sync_batch_norm import sync_batch_stats

__all__ = ["ResNetConfig", "ResNet", "resnet50_init", "resnet_apply",
           "resnet_loss"]

# (blocks, mid-channels) per stage.
_STAGES = {
    26: ((1, 64), (1, 128), (1, 256), (1, 512)),
    50: ((3, 64), (4, 128), (6, 256), (3, 512)),
    101: ((3, 64), (4, 128), (23, 256), (3, 512)),
}


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 1000
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5
    bn_axis: Optional[str] = None  # mesh axis for cross-rank SyncBN
    depth: int = 50              # 26, 50 or 101 (bottleneck stage layouts)


def _conv_init(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int,
               dtype: torch.dtype) -> torch.Tensor:
    """OIHW weight in channels_last memory, the layout of the gradients
    cuDNN returns for channels_last activations (the fused optimizers
    walk a weight, its gradient and its moments as one flat buffer)."""
    fan_in = kh * kw * cin
    return (torch.randn((cout, cin, kh, kw), generator=gen)
            * math.sqrt(2.0 / fan_in)).to(
                dtype=dtype, memory_format=torch.channels_last)


class _BN(nn.Module):
    """BatchNorm parameters (``scale``, ``bias``) and running statistics
    (``mean``, ``var`` buffers, f32)."""

    def __init__(self, c: int, dtype: torch.dtype):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(c, dtype=dtype))
        self.register_buffer("mean", torch.zeros(c, dtype=torch.float32))
        self.register_buffer("var", torch.ones(c, dtype=torch.float32))

    @torch.no_grad()
    def update_stats(self, mean: torch.Tensor, var: torch.Tensor,
                     momentum: float) -> None:
        self.mean.copy_(momentum * self.mean + (1 - momentum) * mean)
        self.var.copy_(momentum * self.var + (1 - momentum) * var)


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """(low, high) padding of JAX's "SAME" for one spatial dim."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    w = w.to(x.dtype)
    ph = _same_pads(x.shape[2], w.shape[2], stride)
    pw = _same_pads(x.shape[3], w.shape[3], stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=stride)


def _stem_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The 7x7/2 stem with pad (3, 3) on NHWC ``x``; returns NCHW.

    On even sizes it is the exact space-to-depth rewrite the reference
    uses by default: pack 2x2 pixel blocks into channels (224²x3 ->
    112²x12, channel (dy, dx, k)) and convolve with the 4x4 repack of
    the 7x7 kernel, W4[u, v, (dy, dx, k)] = w[2u+dy-1, 2v+dx-1, k] (zero
    where the index underflows), stride 1, pad (2, 1): the same sum.
    Odd sizes take the literal conv, as there."""
    w = w.to(x.dtype)
    n, h, wd, c = x.shape
    if h % 2 or wd % 2:
        return F.conv2d(x.permute(0, 3, 1, 2), w, stride=2, padding=3)
    xs = x.reshape(n, h // 2, 2, wd // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    xs = xs.reshape(n, h // 2, wd // 2, 4 * c).permute(0, 3, 1, 2)
    cout = w.shape[0]
    wp = F.pad(w.permute(2, 3, 1, 0), (0, 0, 0, 0, 1, 0, 1, 0))  # HWIO
    w4 = wp.reshape(4, 2, 4, 2, c, cout).permute(0, 2, 1, 3, 4, 5)
    w4 = w4.reshape(4, 4, 4 * c, cout).permute(3, 2, 0, 1)
    return F.conv2d(F.pad(xs, (2, 1, 2, 1)), w4)


def _batch_norm(x: torch.Tensor, bn: _BN, cfg: ResNetConfig,
                train: bool, group=None) -> torch.Tensor:
    """Batch statistics (train; over ``group`` too under
    ``cfg.bn_axis``) or running statistics (eval), folded into one
    per-channel ``x*a + b`` in the activation dtype; a train call updates
    the running statistics."""
    if train:
        xf = x.float()
        if cfg.bn_axis is not None:
            # Sync the moments, then form the variance: averaging
            # per-rank variances would drop the between-rank term.
            mean, var = sync_batch_stats(xf, group, (0, 2, 3),
                                         axis=cfg.bn_axis)
        else:
            mean = xf.mean((0, 2, 3))
            var = (xf * xf).mean((0, 2, 3)) - mean * mean
        bn.update_stats(mean.detach(), var.detach(), cfg.bn_momentum)
    else:
        mean, var = bn.mean, bn.var
    inv = torch.rsqrt(var + cfg.bn_eps)
    scale = bn.scale.float()
    a = (scale * inv).to(x.dtype)
    b = (bn.bias.float() - mean * scale * inv).to(x.dtype)
    return x * a.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)


def _fused_1x1_eligible(w: torch.Tensor, stride: int,
                        x: torch.Tensor) -> bool:
    """HVDT_FUSED_CONV1X1 gate, the same layers as the reference's:
    1x1, stride 1, Cin % 128 == 0 and Cout % 128 == 0, and M = B*H*W
    whose largest power-of-2 divisor clears the per-dtype row floor (8
    rows f32 / 16 bf16 / 32 one-byte).  SyncBN (``cfg.bn_axis``) stays
    eligible.  w is OIHW, x NCHW."""
    cout, cin, kh, kw = w.shape
    m = x.shape[0] * x.shape[2] * x.shape[3]
    floor = {4: 8, 2: 16, 1: 32}.get(x.element_size(), 8)
    if (m & -m) < floor:
        return False
    return (config.get_bool("HVDT_FUSED_CONV1X1") and kh == 1 and kw == 1
            and stride == 1 and cout % 128 == 0 and cin % 128 == 0)


def _conv_bn(x: torch.Tensor, w: torch.Tensor, bn: _BN, cfg: ResNetConfig,
             train: bool, *, stride: int = 1, relu: bool = False,
             group=None) -> torch.Tensor:
    """conv + BN (+ReLU), through the fused kernels where eligible."""
    if _fused_1x1_eligible(w, stride, x):
        w2 = w.view(w.shape[0], w.shape[1]).t().to(x.dtype)  # [Cin, Cout]
        xh = x.permute(0, 2, 3, 1)                             # NHWC view
        if train:
            y, mean, var = conv1x1_bn_train(xh, w2, bn.scale, bn.bias,
                                            eps=cfg.bn_eps, relu=relu,
                                            axis=cfg.bn_axis, group=group)
            bn.update_stats(mean.detach(), var.detach(), cfg.bn_momentum)
        else:
            scale = bn.scale.float() * torch.rsqrt(bn.var + cfg.bn_eps)
            bias = bn.bias.float() - bn.mean * scale
            y = conv1x1_bn_relu(xh, w2, scale, bias, relu=relu)
        return y.permute(0, 3, 1, 2)
    y = _batch_norm(_conv(x, w, stride), bn, cfg, train, group)
    return torch.relu(y) if relu else y


class _Bottleneck(nn.Module):
    def __init__(self, cin: int, mid: int, proj: bool,
                 gen: torch.Generator, cfg: ResNetConfig):
        super().__init__()
        pd = cfg.param_dtype
        cout = mid * 4
        self.conv1 = nn.Parameter(_conv_init(gen, 1, 1, cin, mid, pd))
        self.bn1 = _BN(mid, pd)
        self.conv2 = nn.Parameter(_conv_init(gen, 3, 3, mid, mid, pd))
        self.bn2 = _BN(mid, pd)
        self.conv3 = nn.Parameter(_conv_init(gen, 1, 1, mid, cout, pd))
        self.bn3 = _BN(cout, pd)
        if proj:
            self.conv_proj = nn.Parameter(_conv_init(gen, 1, 1, cin, cout, pd))
            self.bn_proj = _BN(cout, pd)
        else:
            self.conv_proj = None

    def forward(self, x: torch.Tensor, cfg: ResNetConfig, stride: int,
                group=None) -> torch.Tensor:
        train = self.training
        y = _conv_bn(x, self.conv1, self.bn1, cfg, train, relu=True,
                     group=group)
        # v1.5: the stride lives on the 3x3 conv.
        y = _conv_bn(y, self.conv2, self.bn2, cfg, train, stride=stride,
                     relu=True, group=group)
        y = _conv_bn(y, self.conv3, self.bn3, cfg, train, group=group)
        if self.conv_proj is not None:
            sc = _conv_bn(x, self.conv_proj, self.bn_proj, cfg, train,
                          stride=stride, group=group)
        else:
            sc = x
        return torch.relu(y + sc)


class ResNet(nn.Module):
    """ResNet-26/50/101 with the reference's parameter names:
    ``conv_stem``, ``bn_stem.{scale,bias,mean,var}``, ``s{i}b{j}.conv1``
    ... ``s{i}b{j}.bn_proj.*``, ``fc_w`` ``[classes, cin]``, ``fc_b``.
    Conv weights are OIHW.  ``forward`` takes NHWC images and returns
    f32 logits.  ``bn_group`` is the SyncBN group under ``cfg.bn_axis``
    (a process group, a ``DeviceMesh`` or None for the world)."""

    def __init__(self, cfg: ResNetConfig,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None, bn_group=None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator()
        self.cfg = cfg
        self.bn_group = bn_group
        pd = cfg.param_dtype
        self.conv_stem = nn.Parameter(_conv_init(gen, 7, 7, 3, 64, pd))
        self.bn_stem = _BN(64, pd)
        cin = 64
        self._blocks = []
        for si, (blocks, mid) in enumerate(_STAGES[cfg.depth]):
            for bi in range(blocks):
                name = f"s{si}b{bi}"
                setattr(self, name, _Bottleneck(cin, mid, bi == 0, gen, cfg))
                self._blocks.append((name, 2 if (bi == 0 and si > 0) else 1))
                cin = mid * 4
        self.fc_w = nn.Parameter((torch.randn((cfg.num_classes, cin),
                                              generator=gen)
                                  * cin ** -0.5).to(pd))
        self.fc_b = nn.Parameter(torch.zeros(cfg.num_classes, dtype=pd))
        self.to(dev)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = _stem_conv(images.to(cfg.dtype), self.conv_stem)
        x = torch.relu(_batch_norm(x, self.bn_stem, cfg, self.training,
                                   self.bn_group))
        ph = _same_pads(x.shape[2], 3, 2)
        pw = _same_pads(x.shape[3], 3, 2)
        x = F.max_pool2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1]),
                               value=float("-inf")), 3, 2)
        for name, stride in self._blocks:
            x = getattr(self, name)(x, cfg, stride, self.bn_group)
        x = x.mean(dim=(2, 3)).float()
        return x @ self.fc_w.float().t() + self.fc_b.float()

    def batch_stats(self) -> Dict[str, Dict]:
        """The running statistics as the reference's nested
        ``batch_stats`` dict (copies)."""
        out: Dict[str, Dict] = {}
        for mod_name, mod in self.named_modules():
            if isinstance(mod, _BN):
                node = out
                *path, leaf = mod_name.split(".")
                for part in path:
                    node = node.setdefault(part, {})
                node[leaf] = {"mean": mod.mean.clone(),
                              "var": mod.var.clone()}
        return out


def resnet50_init(seed: Union[int, torch.Generator], cfg: ResNetConfig,
                  device: DeviceLike = None, bn_group=None) -> ResNet:
    """A ResNet of ``cfg.depth`` (50 by default) with random weights drawn
    on the CPU from ``seed`` (an int or a ``torch.Generator``), placed on
    ``device`` (the card unless the caller names another); ``bn_group``
    as :class:`ResNet`'s."""
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    return ResNet(cfg, generator=gen, device=device, bn_group=bn_group)


def resnet_apply(model: ResNet, images: torch.Tensor, train: bool = True
                 ) -> Tuple[torch.Tensor, Dict]:
    """images: [N, H, W, 3] → (logits [N, classes], new batch_stats)."""
    model.train(train)
    logits = model(images)
    return logits, model.batch_stats()


def resnet_loss(model: ResNet, images: torch.Tensor, labels: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict]:
    """Cross-entropy loss in f32; returns (loss, new batch_stats)."""
    logits, new_stats = resnet_apply(model, images, True)
    logp = F.log_softmax(logits, -1)
    loss = -logp.gather(1, labels[:, None].long()).mean()
    return loss, new_stats
