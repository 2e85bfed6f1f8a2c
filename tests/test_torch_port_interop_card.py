"""PyTorch port, Horovod's torch API on the card (NCCL world of one).

Every test is marked ``cuda`` and skips without a card.  This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_port_interop_card.py

- In-place and async ops on CUDA tensors stay on the card: the result is
  the argument itself, on its device, and no tensor is copied to the
  host (``Tensor.cpu`` / ``Tensor.numpy`` raise while they run).
- The int8 hook path: each leaf's reduced gradient equals
  ``quant.kernels.quantize_dequantize`` of its local gradient bit for
  bit, with one launch of the quantize and of the dequantize kernel a
  float leaf.
- SyncBatchNorm on CUDA in bf16 keeps its dtype; its synchronized
  function (the statistics summed in f64 on the card) matches plain
  BatchNorm in f32 within 1e-5.
"""

import pytest
import torch

import horovod_tpu_torch as hvd
import horovod_tpu_torch.interop.torch as ihvd
from horovod_tpu_torch.interop import torch_sync_batch_norm as tsbn
from horovod_tpu_torch.quant import kernels as qk

pytestmark = pytest.mark.cuda


@pytest.fixture
def world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    hvd.init()
    yield torch.device("cuda", torch.cuda.current_device())
    hvd.shutdown()


@pytest.fixture
def no_host_copy(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a tensor was copied to the host")

    monkeypatch.setattr(torch.Tensor, "cpu", refuse)
    monkeypatch.setattr(torch.Tensor, "numpy", refuse)


def test_inplace_ops_stay_on_the_card(world, no_host_copy):
    x = torch.arange(12, dtype=torch.float32, device=world).reshape(3, 4)
    want = x.clone()
    assert ihvd.allreduce_(x, name="c.ar") is x
    assert x.is_cuda and torch.equal(x, want)
    p = torch.nn.Parameter(torch.ones(5, device=world, dtype=torch.bfloat16))
    assert ihvd.synchronize(ihvd.broadcast_async_(p, 0, name="c.bc")) is p
    assert p.is_cuda and p.requires_grad and p.dtype == torch.bfloat16
    ts = [torch.ones(3, device=world), torch.full((2,), 2.0, device=world)]
    outs = ihvd.grouped_allreduce_(ts, name="c.grp")
    assert all(o is t and o.is_cuda for o, t in zip(outs, ts))
    out = ihvd.allreduce(x, name="c.ar2", op=hvd.Sum)
    assert out.is_cuda and out is not x and torch.equal(out, want)
    got, splits = ihvd.alltoall(x, name="c.a2a")
    assert got.is_cuda and list(splits) == [3]


def test_int8_hook_path_launches_and_grid(world):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(512, 64),
                                torch.nn.Linear(64, 8)).to(world)
    opt = ihvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(),
        compression=hvd.Compression.int8)
    x = torch.randn(16, 512, device=world)
    q0, d0 = qk._quantize_cuda.launches, qk._dequantize_cuda.launches
    model(x).pow(2).sum().backward()
    assert qk._quantize_cuda.launches - q0 == 4
    assert qk._dequantize_cuda.launches - d0 == 4
    local = [p.grad.detach().clone() for p in model.parameters()]
    opt.synchronize()
    for p, g in zip(model.parameters(), local):
        want = qk.quantize_dequantize(g)
        assert p.grad.is_cuda
        assert torch.equal(p.grad.view(torch.int32), want.view(torch.int32))
    opt.step()
    opt._hvdt.remove()


def test_sync_batch_norm_on_the_card(world):
    x = torch.randn(8, 16, 5, 5, device=world)
    sbn = tsbn.SyncBatchNorm(16).to(world, torch.bfloat16)
    y = sbn(x.to(torch.bfloat16).requires_grad_())
    assert y.dtype == torch.bfloat16 and y.is_cuda
    w = torch.randn(16, device=world, requires_grad=True)
    b = torch.randn(16, device=world, requires_grad=True)
    xs = x.clone().requires_grad_()
    out, mean, var, count = tsbn._SyncBNFunction.apply(xs, w, b, 1e-5)
    xr = x.clone().requires_grad_()
    ref = torch.nn.functional.batch_norm(xr, None, None, w, b, True, 0.0,
                                         1e-5)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    dy = torch.randn_like(out)
    gx = torch.autograd.grad(out, xs, dy)[0]
    gr = torch.autograd.grad(ref, xr, dy)[0]
    torch.testing.assert_close(gx, gr, rtol=1e-4, atol=1e-5)
    assert float(count) == 8 * 25
