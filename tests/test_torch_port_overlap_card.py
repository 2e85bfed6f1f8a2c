"""PyTorch port on the card: the overlapped exchange (ops/overlap.py) in
an NCCL world of one.

Every test is marked ``cuda`` and skips without a card.  This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda \\
        tests/test_torch_port_overlap_card.py

* The hooks fire on autograd's device thread and issue the buckets
  there (the thread on which a kernel's first launch once failed):
  the exact wire, and the int8 wire with error feedback, whose
  quantize kernels launch from that thread.
* A graphed overlapped step (``donated_step``) equals the eager
  overlapped step, and both equal the monolithic step (a world of one's
  sum is a copy): ResNet-26 (10 classes, 64x64, batch 8, bf16 compute,
  f32 parameters) with deterministic cuDNN, for the exact wire, k = 2
  accumulation, the int8 and int4 wires with error feedback, and
  pipelined_sgd.
  Tolerance: none.
"""

import threading

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import step_pipeline as sp
from horovod_tpu_torch.models import ResNetConfig, resnet50_init, resnet_loss
from horovod_tpu_torch.ops import overlap as ov
from horovod_tpu_torch.quant import kernels as qk

pytestmark = pytest.mark.cuda

_STEPS = 4


@pytest.fixture
def world(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    monkeypatch.setenv("HVDT_FUSION_THRESHOLD", str(1024 * 1024))
    monkeypatch.delenv("HVDT_OVERLAP", raising=False)
    ov.reset()
    hvd.init()
    yield torch.device("cuda")
    hvd.shutdown()
    ov.reset()


def _model():
    return resnet50_init(0, ResNetConfig(depth=26, num_classes=10))


def _batch(seed=3):
    g = torch.Generator(device="cuda").manual_seed(seed)
    images = torch.randn((8, 64, 64, 3), generator=g, device="cuda",
                         dtype=torch.bfloat16)
    labels = torch.randint(0, 10, (8,), generator=g, device="cuda")
    return images, labels


def _step(model, opt, images, labels):
    opt.zero_grad(set_to_none=True)
    loss, _ = resnet_loss(model, images, labels)
    loss.backward()
    opt.step()
    return loss.detach()


def _opt(model, k=1, wire=None, pipelined=False):
    if pipelined:
        return ov.pipelined_sgd(model.parameters(), 0.01, momentum=0.9)
    comp = getattr(hvd.Compression, wire or "none")
    opt = hvd.DistributedOptimizer(
        hvd.fused_sgd(model.parameters(), 0.01, momentum=0.9),
        compression=comp, backward_passes_per_step=k)
    return hvd.quant.with_error_feedback(opt, wire=wire) if wire else opt


def _state(model, opt, losses):
    out = [torch.stack(losses)]
    out += [v.detach().clone() for v in model.state_dict().values()]
    inner = opt
    while not isinstance(inner, torch.optim.Optimizer):
        if "residual" in vars(inner):
            out += [r.clone() for r in inner.residual.values()]
        inner = inner.optimizer
    out += [v.clone() for st in inner.state.values() for v in st.values()
            if isinstance(v, torch.Tensor)]
    return out


def _drop(opt):
    while opt is not None and not isinstance(opt, torch.optim.Optimizer):
        if vars(opt).get("_hooked") is not None:
            opt._hooked.remove()
        opt = vars(opt).get("optimizer")


def _run(monkeypatch, overlap, graphed, **kw):
    if overlap:
        monkeypatch.setenv("HVDT_OVERLAP", "on")
    else:
        monkeypatch.delenv("HVDT_OVERLAP", raising=False)
    model = _model()
    opt = _opt(model, **kw)
    step = sp.donated_step(_step) if graphed else _step
    batch = _batch()
    losses = [step(model, opt, *batch).clone() for _ in range(_STEPS)]
    torch.cuda.synchronize()
    out = _state(model, opt, losses)
    _drop(opt)
    return out


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.reshape(-1).view(torch.uint8),
                           y.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("wire", [None, "int8"])
def test_hooks_issue_from_autograd_device_thread(world, monkeypatch, wire):
    monkeypatch.setenv("HVDT_OVERLAP", "on")
    model = _model()
    opt = _opt(model, wire=wire)
    inner = opt.optimizer if wire else opt
    threads = []
    real = ov._Pipeline.issue

    def issue(self, ids, parts):
        threads.append(threading.get_ident())
        return real(self, ids, parts)

    monkeypatch.setattr(ov._Pipeline, "issue", issue)
    qk._quantize_cuda.launches = 0
    images, labels = _batch()
    opt.zero_grad(set_to_none=True)
    resnet_loss(model, images, labels)[0].backward()
    n_buckets = len(inner._hooked.plan)
    assert inner._hooked.next_issue == n_buckets     # all, in the backward
    assert len(threads) == n_buckets
    assert threading.get_ident() not in threads      # autograd's thread
    if wire:
        assert qk._quantize_cuda.launches >= n_buckets
    opt.step()
    torch.cuda.synchronize()
    assert all(torch.isfinite(p).all() for p in model.parameters())
    _drop(opt)


@pytest.mark.parametrize("case", ["exact", "k2", "int8", "int4",
                                  "pipelined"])
def test_graphed_overlapped_step_equals_eager(world, monkeypatch, case):
    kw = {"exact": {}, "k2": {"k": 2}, "int8": {"wire": "int8"},
          "int4": {"wire": "int4"}, "pipelined": {"pipelined": True}}[case]
    overlap = case != "pipelined"
    graphed = _run(monkeypatch, overlap, True, **kw)
    eager = _run(monkeypatch, overlap, False, **kw)
    _same(graphed, eager)
    if case in ("exact", "k2", "pipelined"):
        # ... and the monolithic exchange (fused_sgd, no overlap).
        mono_kw = {"k": 2} if case == "k2" else {}
        _same(eager, _run(monkeypatch, False, False, **mono_kw))
