"""PyTorch port on the card: SyncBatchNorm, gradient accumulation and the
int8/int4 wire inside a CUDA graph (``step_pipeline.donated_step``),
each against the same steps run eagerly, in an NCCL world of one.

Every test is marked ``cuda`` and skips without a card.  This file
imports neither JAX nor the JAX package, so it runs where only PyTorch
is installed:

    python -m pytest --noconftest -m cuda \\
        tests/test_torch_port_sync_bn_card.py

ResNet-26 (10 classes, 64x64, batch 8, bf16 compute, f32 parameters)
with the fused 1x1 convs on (HVDT_FUSED_CONV1X1=1, kernel #4) under
``DistributedOptimizer(fused_sgd)`` (#2), built twice from one seed.
One copy takes its steps through ``donated_step``, the other eagerly.
Tolerance: none.  A replay runs the kernels and collectives the eager
step launches, in the same order, on the same inputs, with cuDNN held to
deterministic algorithms: losses, parameters, BatchNorm running
statistics, optimizer state and error-feedback residuals hold the same
bytes.
"""

import threading

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import step_pipeline as sp
from horovod_tpu_torch.models import ResNetConfig, resnet50_init, resnet_loss
from horovod_tpu_torch.ops import optim_kernels as ok
from horovod_tpu_torch.quant import kernels as qk

pytestmark = pytest.mark.cuda

_STEPS = 6
_INT_OF_SIZE = {8: torch.int64, 4: torch.int32, 2: torch.int16,
                1: torch.uint8}


@pytest.fixture
def world(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setenv("HVDT_FUSED_CONV1X1", "1")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    hvd.init()
    yield torch.device("cuda")
    hvd.shutdown()


def _step(model, opt, images, labels):
    opt.zero_grad(set_to_none=True)
    loss, _ = resnet_loss(model, images, labels)
    loss.backward()
    opt.step()
    return loss.detach()


def _batch(device):
    g = torch.Generator(device=device).manual_seed(1)
    images = torch.randn((8, 64, 64, 3), generator=g, device=device)
    labels = torch.randint(0, 10, (8,), generator=g, device=device)
    return images, labels


def _assert_same(a, b, name=""):
    """The same bytes (so NaNs and signed zeros count too)."""
    assert a.dtype == b.dtype and a.shape == b.shape, name
    it = _INT_OF_SIZE[a.element_size()]
    assert torch.equal(a.contiguous().view(it), b.contiguous().view(it)), name


def _run(device, graphed, *, bn_axis=None, k=1, wire=None, steps=_STEPS):
    """``steps`` steps of one ResNet-26 copy; returns the tensors to
    compare (losses, the state dict, optimizer state, residuals) and the
    graphed step."""
    cfg = ResNetConfig(num_classes=10, depth=26, bn_axis=bn_axis)
    model = resnet50_init(0, cfg, device=device)
    comp = {None: hvd.Compression.none, "int8": hvd.Compression.int8,
            "int4": hvd.Compression.int4}[wire]
    opt = hvd.DistributedOptimizer(
        ok.fused_sgd(model.parameters(), 0.05, momentum=0.9),
        compression=comp, backward_passes_per_step=k)
    if wire is not None:
        opt = hvd.quant.with_error_feedback(opt, wire=wire)
    images, labels = _batch(device)
    step = sp.donated_step(_step) if graphed else _step
    losses = torch.stack([step(model, opt, images, labels).clone()
                          for _ in range(steps)])
    torch.cuda.synchronize()
    out = {"losses": losses, **model.state_dict()}
    inner = opt.optimizer.optimizer if wire else opt.optimizer
    for i, st in enumerate(inner.state.values()):
        out.update({f"state{i}.{n}": v for n, v in st.items()})
    if wire is not None:
        out.update({f"residual{i}": r
                    for i, r in enumerate(opt.residual.values())})
    return out, step


def _assert_runs_equal(got, want):
    assert got.keys() == want.keys()
    for name in got:
        _assert_same(got[name], want[name], name)


def test_captured_sync_bn_equals_eager(world):
    """SyncBN (bn_axis="dp", fused and unfused BN layers) graphed equals
    eager, and in a world of one both equal bn_axis=None."""
    got, step = _run(world, True, bn_axis="dp")
    assert step.graphed
    want, _ = _run(world, False, bn_axis="dp")
    _assert_runs_equal(got, want)
    plain, _ = _run(world, False)
    _assert_runs_equal(got, plain)


@pytest.mark.parametrize("k", [2, 3])
def test_captured_accumulation_equals_eager(world, k):
    """k graphs (one a pass of the cycle) equal the eager passes, and a
    non-boundary replay launches no NCCL kernel."""
    got, step = _run(world, True, k=k, steps=3 * k)
    assert len(step._graphs) == k
    want, _ = _run(world, False, k=k, steps=3 * k)
    _assert_runs_equal(got, want)
    from torch.profiler import ProfilerActivity, profile

    for key, cap in step._graphs.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            cap.graph.replay()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()]
        nccl = [n for n in names if "nccl" in n.lower()]
        assert names, key
        if key != (k - 1,):
            assert not nccl, (key, nccl)


@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_captured_wire_equals_eager(world, wire):
    """with_error_feedback(DistributedOptimizer(compression=int8/int4))
    graphed equals eager: parameters, momentum and residuals; the wire
    kernels (#5-#8) run inside the graph."""
    qk._quantize_cuda.launches = qk._quantize4_cuda.launches = 0
    got, step = _run(world, True, wire=wire)
    assert step.graphed
    want, _ = _run(world, False, wire=wire)
    _assert_runs_equal(got, want)
    launched = (qk._quantize4_cuda if wire == "int4"
                else qk._quantize_cuda).launches
    assert launched > 0


def test_sync_bn_backward_captured_on_a_fresh_thread(world):
    """A graphed SyncBN step whose every call (the eager one, the capture,
    the replays) is made on a thread that never touched the card before:
    autograd's backward thread issues the SyncBN collectives inside the
    capture.  Equals eager steps on the main thread."""
    out = {}

    def body():
        out["run"], out["step"] = _run(world, True, bn_axis="dp")

    t = threading.Thread(target=body)
    t.start()
    t.join()
    assert "run" in out and out["step"].graphed
    want, _ = _run(world, False, bn_axis="dp")
    _assert_runs_equal(out["run"], want)


def test_sync_batch_norm_module_captured(world):
    """The SyncBatchNorm module's forward and backward inside a graph
    equal eager calls."""
    g = torch.Generator(device=world).manual_seed(2)
    x = torch.randn((16, 7, 7, 64), generator=g, device=world)
    runs = []
    for graphed in (True, False):
        bn = hvd.SyncBatchNorm(64)
        xs = x.clone().requires_grad_()

        def fwd_bwd(bn, xs):
            xs.grad = None
            y = bn(xs)
            (y * y).sum().backward()
            return y.detach()

        step = sp.donated_step(fwd_bwd) if graphed else fwd_bwd
        ys = torch.stack([step(bn, xs).clone() for _ in range(4)])
        torch.cuda.synchronize()
        runs.append([ys, xs.grad, bn.scale.grad, bn.mean, bn.var])
    for a, b in zip(*runs):
        _assert_same(a, b)
