"""PyTorch port on the card: the fp8 (e4m3) matmul of quant/fp8.py
(``torch._scaled_mm``) against its plain version.

Every test is marked ``cuda`` and skips without a card.  This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_port_fp8_card.py

* The e4m3 operands cast on the card are bit-identical to the plain
  version's on the CPU.
* The forward against the plain product computed on the card in f32
  (TF32 off).  The plain version sums the exact e4m3 products in f32;
  Hopper's e4m3 tensor-core GEMM keeps partial sums in less than f32
  between its promotions to f32.  Tolerance: one ulp of the output
  dtype of each element plus 2^-10 of the sum of its products'
  magnitudes (``|qx| @ |qw|`` times the scales).
* The straight-through backward against the plain f32 formula: the same
  rule.
* K or N off a multiple of 16 raises; the probe is true on the card;
  the transformer with HVDT_FP8=matmul on the card matches its CPU run
  on the same weights (loss rtol 1e-3: activations differ by the GEMMs'
  rounding, which can move an e4m3 rounding).
"""

import pytest
import torch

from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.quant import fp8

pytestmark = pytest.mark.cuda

_ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10,
        torch.float32: 2.0 ** -20}


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, dtype, abs_sum=None):
    got, want = got.float(), want.float()
    floor = (1e-5 * want.abs().max() if abs_sum is None
             else 2.0 ** -10 * abs_sum)
    tol = _ULP[dtype] * want.abs() + floor
    assert ((got - want).abs() <= tol).all(), (got - want).abs().max()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("mkn", [(64, 256, 128), (300, 1024, 4096),
                                 (2 * 77, 64, 48)])
def test_forward_matches_plain(card, dtype, mkn):
    m, k, n = mkn
    x = (torch.randn((m, k), generator=card, device="cuda") * 3).to(dtype)
    w = torch.randn((k, n), generator=card, device="cuda") * 0.02
    sx = fp8._scale_for(x.abs().amax())
    sw = fp8._scale_for(w.abs().amax())
    qx, qw = fp8._cast_e4m3(x, sx), fp8._cast_e4m3(w, sw)
    for t, s, q in ((x, sx, qx), (w, sw, qw)):
        assert torch.equal(q.view(torch.uint8).cpu(), fp8._cast_e4m3(
            t.cpu(), s.cpu()).view(torch.uint8))
    got = fp8.fp8_matmul(x, w)
    assert got.dtype == dtype and got.shape == (m, n)
    want = ((qx.float() @ qw.float()) * (sx * sw)).to(dtype)
    abs_sum = (qx.float().abs() @ qw.float().abs()) * (sx * sw)
    _close(got, want, dtype, abs_sum)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_matches_plain(card, dtype):
    m, k, n = 512, 256, 384
    x = torch.randn((m, k), generator=card, device="cuda").to(dtype)
    w = torch.randn((k, n), generator=card, device="cuda") * 0.05
    g = (torch.randn((m, n), generator=card, device="cuda") * 1e-3).to(dtype)
    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    fp8.fp8_matmul(xs, ws).backward(g)
    sx, sw = fp8._scale_for(x.abs().amax()), fp8._scale_for(w.abs().amax())
    qx, mx = fp8._cast_and_mask(x, sx)
    qw, mw = fp8._cast_and_mask(w, sw)
    want_dx = ((g.float() @ qw.float().t()) * sw * mx).to(dtype)
    want_dw = (qx.float().t() @ g.float()) * sx * mw
    _close(xs.grad, want_dx, dtype)
    _close(ws.grad, want_dw, torch.bfloat16 if dtype == torch.bfloat16
           else torch.float32)
    assert (xs.grad != 0).float().mean() > 0.99   # no e4m3 flush


def test_shapes_and_probe(card):
    assert fp8.fp8_available()
    x = torch.randn((32, 40), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 16"):
        fp8.fp8_matmul(x, torch.randn((40, 32), device="cuda"))
    with pytest.raises(ValueError, match="multiples of 16"):
        fp8.fp8_matmul(x[:, :32], torch.randn((32, 24), device="cuda"))


def test_transformer_on_the_card_matches_cpu(card, monkeypatch):
    monkeypatch.setenv("HVDT_FP8", "matmul")
    monkeypatch.setenv("HVDT_FLASH_ATTENTION", "off")
    cfg = tt.TransformerConfig(vocab=128, layers=2, d_model=64, heads=4,
                               kv_heads=2, d_ff=128, max_seq=128,
                               dtype=torch.float32)
    cpu = tt.transformer_init(0, cfg, device="cpu")
    gpu = tt.transformer_init(0, cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, 128, (2, 128), generator=torch.Generator()
                           .manual_seed(1))
    want = tt.transformer_loss(cpu, tokens, cfg)
    got = tt.transformer_loss(gpu, tokens.cuda(), cfg)
    got.backward()
    assert torch.isfinite(got)
    assert abs(got.item() - want.item()) <= 1e-3 * abs(want.item())
    assert all(torch.isfinite(p.grad).all() for p in gpu.parameters())
