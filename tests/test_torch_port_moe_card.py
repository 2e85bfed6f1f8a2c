"""PyTorch port, expert and pipeline parallelism on the card, in a group
of one (an NCCL world of one process): the pytest form of chip_smoke.py's
moe_dispatch phase at a small size.

* ``moe_dispatch_combine`` on CUDA tensors (T 512, d 128, 8 experts,
  f32 and bf16, top_k 1 and 2, capacity factors 0.5 and 1.25) against a
  float64 reference of the same routing written here: the f32 softmax's
  top-k, gates renormalised over the chosen k, k-major capacity, each
  kept choice's expert output times its gate, in float64.  f32 within
  1e-5 of each row's norm; bf16 within 2^-6 (the expert products round
  their inputs and the hidden layer to bf16).
* ``HVDT_TRANSPORT=ep:ring:int8:64M`` routes both all-to-alls through
  kernels #5 and #6: two quantize and two dequantize launches a forward
  and as many a backward; the output within 2e-2 relative L2 of the
  exact wire's.
* ``pipeline_1f1b`` in a group of one equals the stage applied to each
  microbatch: the output and the microbatches' gradient in every byte,
  the weight's (a sum over microbatches in another order) within 1e-6.

Every test is marked ``cuda`` and skips without a card.  This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_port_moe_card.py
"""

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel import moe_dispatch_combine, pipeline_1f1b
from horovod_tpu_torch.quant import kernels as qk

pytestmark = pytest.mark.cuda

_T, _D, _F, _E = 512, 128, 256, 8


@pytest.fixture
def world1():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    hvd.init()
    yield torch.Generator(device="cuda").manual_seed(0)
    hvd.shutdown()


def _experts(gen, dtype):
    w_up = torch.randn((_E, _D, _F), generator=gen,
                       device="cuda") * _D ** -0.5
    w_down = torch.randn((_E, _F, _D), generator=gen,
                         device="cuda") * _F ** -0.5
    return w_up.to(dtype), w_down.to(dtype)


def _expert_fn(w_up, w_down):
    return lambda x: torch.bmm(torch.nn.functional.silu(torch.bmm(x, w_up)),
                               w_down)


def reference_f64(tokens, logits, w_up, w_down, k, cf):
    """The same routing (the f32 softmax's top-k, as the port chooses)
    with the gates and experts in float64: (out [T, D], dropped
    fraction)."""
    x, up, down = (t.double() for t in (tokens, w_up, w_down))
    vals, idx = torch.topk(torch.softmax(logits.float(), -1), k, dim=-1)
    vals = vals.double()
    gates = vals / vals.sum(-1, keepdim=True)
    t, e = logits.shape
    cap = max(1, int(-(-(t * k * cf) // e)))
    out = torch.zeros_like(x)
    used = [0] * e
    kept = 0
    for j in range(k):                       # primary choices first
        for i in range(t):
            ex = int(idx[i, j])
            if used[ex] < cap:
                used[ex] += 1
                kept += 1
                y = torch.nn.functional.silu(x[i] @ up[ex]) @ down[ex]
                out[i] += gates[i, j] * y
    return out, 1.0 - kept / (t * k)


def _row_err(got, want):
    return float(((got.double() - want).norm(dim=-1)
                  / want.norm(dim=-1).clamp_min(1e-30)).max())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2.0 ** -6)])
@pytest.mark.parametrize("k,cf", [(1, 1.25), (2, 1.25), (2, 0.5)])
def test_dispatch_combine_against_float64(world1, dtype, tol, k, cf):
    gen = world1
    tokens = torch.randn((_T, _D), generator=gen, device="cuda").to(dtype)
    logits = torch.randn((_T, _E), generator=gen, device="cuda") * 2
    w_up, w_down = _experts(gen, dtype)
    out, aux = moe_dispatch_combine(tokens, logits.to(dtype),
                                    _expert_fn(w_up, w_down),
                                    experts_per_rank=_E, capacity_factor=cf,
                                    top_k=k)
    want, dropped = reference_f64(tokens, logits.to(dtype), w_up, w_down,
                                  k, cf)
    assert out.dtype == dtype and out.device.type == "cuda"
    kept = want.norm(dim=-1) > 0
    assert torch.equal(out.norm(dim=-1) > 0, kept)
    assert _row_err(out[kept], want[kept]) <= tol
    assert float(aux.dropped_fraction) == pytest.approx(dropped, abs=1e-6)


def test_int8_wire_launches_kernels(world1, monkeypatch):
    gen = world1
    tokens = torch.randn((_T, _D), generator=gen, device="cuda",
                         requires_grad=True)
    logits = torch.randn((_T, _E), generator=gen, device="cuda")
    w_up, w_down = _experts(gen, torch.float32)
    fn = _expert_fn(w_up, w_down)
    exact, _ = moe_dispatch_combine(tokens, logits, fn, experts_per_rank=_E,
                                    capacity_factor=1.25, top_k=2)
    monkeypatch.setenv("HVDT_TRANSPORT", "ep:ring:int8:64M")
    qk._quantize_cuda.launches = qk._dequantize_cuda.launches = 0
    out, _ = moe_dispatch_combine(tokens, logits, fn, experts_per_rank=_E,
                                  capacity_factor=1.25, top_k=2)
    assert (qk._quantize_cuda.launches, qk._dequantize_cuda.launches) == \
        (2, 2)
    out.sum().backward()
    assert (qk._quantize_cuda.launches, qk._dequantize_cuda.launches) == \
        (4, 4)
    # Two block-scaled int8 roundings (1/254 of a block's largest
    # value at most, each): well within 2e-2 relative L2.
    err = float((out - exact).norm() / exact.norm())
    assert 0 < err <= 2e-2
    assert tokens.grad is not None and torch.isfinite(tokens.grad).all()


def test_pipeline_group_of_one_is_the_stage(world1):
    gen = world1
    w = torch.randn((_D, _D), generator=gen, device="cuda",
                    requires_grad=True)
    xs = torch.randn((4, 16, _D), generator=gen, device="cuda",
                     requires_grad=True)
    out = pipeline_1f1b(lambda p, x: torch.tanh(x @ p), w, xs)
    out.square().sum().backward()
    gw, gx = w.grad.clone(), xs.grad.clone()
    w.grad = xs.grad = None
    want = torch.stack([torch.tanh(x @ w) for x in xs])
    want.square().sum().backward()
    assert torch.equal(out, want)
    torch.testing.assert_close(gw, w.grad, rtol=1e-6, atol=1e-6)
    assert torch.equal(gx, xs.grad)
