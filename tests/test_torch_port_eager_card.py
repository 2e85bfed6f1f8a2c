"""PyTorch port, the eager core on the card (NCCL world of one).

Every test is marked ``cuda`` and skips without a card.  This file
imports neither JAX nor the JAX package, so it runs where only PyTorch
is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_eager_card.py

- CUDA in, CUDA out: every eager op returns a tensor on the input's
  device with its dtype, bit-identical to the world-of-one answer (the
  input, scaled where asked).  Tolerance: none.
- The producer-stream case: the input is still being computed by a
  chain of matmuls on a side stream when the call is made; the result
  must hold the finished values, and ``poll`` is false until then.
- An eager call inside a CUDA-graph capture raises; a ``donated_step``
  capture taken while eager ops are in flight replays bit-identically to
  the eager step, and so does a ``torch.cuda.graph`` capture that holds
  ``graphs.capture_lock``.
- A numpy array in an NCCL world is reduced on the card and comes back
  as numpy.
"""

import math

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import step_pipeline as sp
from horovod_tpu_torch.common import graphs
from horovod_tpu_torch.ops import eager

pytestmark = pytest.mark.cuda

_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.int32,
           torch.int64]


@pytest.fixture
def world(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    hvd.init()
    yield torch.device("cuda", torch.cuda.current_device())
    hvd.shutdown()


def _tensor(dtype, shape, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    if dtype.is_floating_point:
        return torch.randn(shape, generator=g, device=device).to(dtype)
    return torch.randint(-50, 50, shape, generator=g, device=device,
                         dtype=dtype)


def _same(got, want):
    assert isinstance(got, torch.Tensor)
    assert got.device == want.device and got.dtype == want.dtype
    assert got.shape == want.shape
    assert torch.equal(got, want)


def _times(x, f):
    return x * torch.tensor(f, dtype=x.dtype) if f != 1.0 else x


@pytest.mark.parametrize("dtype", _DTYPES, ids=str)
def test_every_op_cuda_in_cuda_out(world, dtype):
    tag = str(dtype)
    x = _tensor(dtype, (40, 7), 0, world)
    for op in ("AVERAGE", "SUM", "MIN", "MAX", "PRODUCT"):
        _same(hvd.allreduce(x, op=getattr(hvd.ReduceOp, op),
                            name=f"{tag}.{op}"), x)
    for pre, post in ((2.0, 1.0), (1.0, 0.5), (0.5, 3.0)):
        _same(hvd.allreduce(x, op=hvd.Sum, prescale_factor=pre,
                            postscale_factor=post, name=f"{tag}.{pre}.{post}"),
              _times(_times(x, pre), post))
    parts = [x[:3], x[3:], x[:1]]
    for g, p in zip(hvd.grouped_allreduce(parts, op=hvd.Sum,
                                          name=f"{tag}.grp"), parts):
        _same(g, p)
    _same(hvd.allgather(x[:9], name=f"{tag}.ag"), x[:9])
    _same(hvd.broadcast(x, 0, name=f"{tag}.bc"), x)
    out, splits = hvd.alltoall(x, name=f"{tag}.a2a")
    _same(out, x)
    assert splits == [40]
    _same(hvd.reducescatter(x, name=f"{tag}.rs"), x)


def test_producer_stream_and_poll(world):
    """The input is the last of a chain of large matmuls, enqueued on a
    side stream just before the call: the controller's stream must wait
    for it, and the handle is not done before it is."""
    n = 4096
    g = torch.Generator(device=world).manual_seed(1)
    a = torch.randn((n, n), generator=g, device=world) / math.sqrt(n)
    x = torch.randn((n, n), generator=g, device=world)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        for _ in range(16):
            x = x @ a
        h = hvd.allreduce_async(x, name="producer")
        assert not hvd.poll(h)
        got = hvd.synchronize(h)
    torch.cuda.synchronize()
    _same(got, x)       # x's finished values


def test_call_inside_capture_raises(world):
    x = torch.ones(8, device=world)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="cannot run inside a CUDA graph"):
        with torch.cuda.graph(graph):
            hvd.allreduce(x, name="in.capture")


def test_capture_with_eager_ops_in_flight(world, monkeypatch):
    """A donated_step capture taken while eager allreduces are in flight
    (their input still being produced) replays bit-identically to the
    eager step, and the eager results hold."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    torch.manual_seed(0)
    w0 = torch.randn(256, 256, device=world) / 16

    def step(w, opt, x):
        opt.zero_grad(set_to_none=True)
        loss = torch.tanh(x @ w).square().mean()
        loss.backward()
        opt.step()
        return loss.detach()

    x = torch.randn(512, 256, device=world)
    a = torch.randn(4096, 4096, device=world) / 64
    out = []
    for graphed in (True, False):
        w = w0.clone().requires_grad_(True)
        opt = hvd.DistributedOptimizer(hvd.fused_sgd([w], 0.1, momentum=0.9))
        fn = sp.donated_step(step) if graphed else step
        losses, pending = [], []
        for i in range(4):
            if graphed and i == 1:          # the call that captures
                big = torch.randn(4096, 4096, device=world)
                for _ in range(8):
                    big = big @ a
                pending = [(big, hvd.allreduce_async(big, name=f"cap.{k}"))
                           for k in range(3)]
            losses.append(fn(w, opt, x).clone())
        for big, h in pending:
            _same(hvd.synchronize(h), big)
        torch.cuda.synchronize()
        out.append((torch.stack(losses), w.detach().clone()))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


def test_user_capture_under_capture_lock(world):
    """A torch.cuda.graph capture (global error mode) taken while eager
    allreduces are in flight holds graphs.capture_lock, so the
    controller's CUDA work waits for it: the capture is not invalidated,
    the replay equals the eager computation, and the eager results
    hold."""
    g = torch.Generator(device=world).manual_seed(2)
    a = torch.randn(4096, 4096, generator=g, device=world) / 64
    x = torch.randn(1024, 4096, generator=g, device=world)
    want = torch.tanh(x @ a)
    big = torch.randn(4096, 4096, generator=g, device=world)
    for _ in range(8):
        big = big @ a
    pending = [hvd.allreduce_async(big, name=f"lock.{k}") for k in range(3)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm up outside the capture
        torch.tanh(x @ a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with graphs.capture_lock, torch.cuda.graph(graph):
        y = torch.tanh(x @ a)
    graph.replay()
    for h in pending:
        _same(hvd.synchronize(h), big)
    torch.cuda.synchronize()
    assert torch.equal(y, want)


def test_numpy_in_nccl_world_goes_through_the_card(world, monkeypatch):
    seen = []
    orig = eager.EagerController._input

    def spy(ctl, entry):
        t = orig(ctl, entry)
        seen.append(None if t is None else t.device.type)
        return t

    monkeypatch.setattr(eager.EagerController, "_input", spy)
    a = np.arange(24, dtype=np.float32).reshape(4, 6)
    out = hvd.allreduce(a, op=hvd.Max, name="numpy.in")
    assert isinstance(out, np.ndarray) and out.dtype == a.dtype
    np.testing.assert_array_equal(out, a)
    cpu = torch.arange(5, dtype=torch.int64)
    got = hvd.broadcast(cpu, 0, name="cpu.tensor.in")
    assert got.device.type == "cpu" and torch.equal(got, cpu)
    assert seen == ["cuda", "cuda"]
