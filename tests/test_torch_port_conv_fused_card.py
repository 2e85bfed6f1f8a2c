"""PyTorch port, the fused 1x1-conv CUDA kernels (csrc/conv_fused.cu: #3
``_mm_forward`` and #4 ``matmul_batch_stats``, one persistent wgmma + TMA
GEMM) held against their plain PyTorch versions on the card.

Every test is marked ``cuda`` and skips without a card.  This file
imports neither JAX nor the JAX package, so it runs where only PyTorch
is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_conv_fused_card.py

Tolerances, those of chip_smoke.py: an output within one ulp of its
type (2^-7 bf16, 2^-10 fp16) of the largest wanted value, since kernel
and plain version round the same f32 sum, added in another order; the
partial sums s1/s2 within 1e-4 of their largest value (sums of 128 f32
values, differently associated).
"""

import pytest
import torch

from horovod_tpu_torch.ops import conv_fused as cf

pytestmark = pytest.mark.cuda

_ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _operands(gen, m, k, n, dtype=torch.bfloat16):
    a = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    # The model's form: w is the transpose of a contiguous [N, K] weight.
    w = (torch.randn((n, k), generator=gen, device="cuda")
         / k ** 0.5).to(dtype).t()
    scale = 1.0 + 0.1 * torch.randn(n, generator=gen, device="cuda")
    bias = 0.1 * torch.randn(n, generator=gen, device="cuda")
    return a, w, scale, bias


def _close(got, want, rel):
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.float() - want.float()).abs().max().item() if got.numel() else 0
    tol = rel * (want.float().abs().max().item() if want.numel() else 0)
    assert err <= tol, (err, tol)


def _check_mm(a, w, scale, bias, relu):
    before = cf._mm_forward.launches
    got = cf._mm_forward(a, w, scale, bias, relu)
    assert cf._mm_forward.launches == before + 1
    want = cf._mm_forward_plain(a, w, scale, bias, relu)
    torch.cuda.synchronize()
    _close(got, want, _ULP[a.dtype])


def _check_stats(a, w):
    before = cf.matmul_batch_stats.launches
    z, s1, s2 = cf.matmul_batch_stats(a, w)
    assert cf.matmul_batch_stats.launches == before + 1
    zw, s1w, s2w = cf._mm_stats_plain(a, w)
    torch.cuda.synchronize()
    assert s1.shape == (-(-a.shape[0] // cf.BLOCK_M), w.shape[1])
    _close(z, zw, _ULP[a.dtype])
    _close(s1, s1w, 1e-4)
    _close(s2, s2w, 1e-4)
    return z, s1, s2


@pytest.mark.parametrize("k", [8, 72, 136, 2048])
@pytest.mark.parametrize("m", [1, 127, 129, 3136])
def test_ragged_m_and_k(card, m, k):
    """K ragged against the 64-wide TMA box, M against the 128-row tile."""
    a, w, scale, bias = _operands(card, m, k, 200)
    _check_mm(a, w, scale, bias, True)
    _check_stats(a, w)


@pytest.mark.parametrize("n", [8, 200, 264])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_ragged_n(card, n, dtype):
    a, w, scale, bias = _operands(card, 3136, 136, n, dtype)
    _check_mm(a, w, scale, bias, True)
    _check_stats(a, w)


@pytest.mark.parametrize("m, n", [(3136, 512), (12544, 256), (3136, 2048)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_tiles_per_cta(card, m, n, dtype):
    """ResNet-50 output shapes whose 100, 196 and 400 tiles of 128 x 128
    give a CTA (one an SM) one tile (its second consumer warpgroup
    idle), one or two, and three or four (an odd count: the warpgroups'
    turns end unevenly)."""
    a, w, scale, bias = _operands(card, m, 512, n, dtype)
    _check_mm(a, w, scale, bias, True)
    _check_stats(a, w)


@pytest.mark.parametrize("relu", [True, False])
def test_relu_and_zero_scale(card, relu):
    a, w, scale, bias = _operands(card, 300, 256, 136)
    _check_mm(a, w, scale, bias, relu)
    # scale 0: the output is relu(bias) in every row, exactly.
    zero = torch.zeros_like(scale)
    got = cf._mm_forward(a, w, zero, bias, relu)
    want = bias.clamp_min(0.0) if relu else bias
    assert torch.equal(got, want.to(a.dtype).expand(300, -1))


def test_non_contiguous_a_is_copied(card):
    a, w, scale, bias = _operands(card, 256, 192, 128)
    wide = a[:, :128]                   # rows 384 bytes apart
    assert not wide.is_contiguous()
    got = cf._mm_forward(wide, w[:128], scale, bias, True)
    want = cf._mm_forward_plain(wide.contiguous(), w[:128], scale, bias, True)
    torch.cuda.synchronize()
    _close(got, want, _ULP[a.dtype])
    z, _, _ = cf.matmul_batch_stats(wide, w[:128])
    assert torch.equal(z, cf.matmul_batch_stats(wide.contiguous(),
                                                w[:128])[0])


def test_misaligned_operand_raises(card):
    flat = torch.randn(1 + 64 * 64, generator=card, device="cuda").to(
        torch.bfloat16)
    a = flat[1:].view(64, 64)           # contiguous, 2 bytes off 16
    w = torch.randn((64, 64), generator=card, device="cuda").to(
        torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        cf._mm_forward(a, w, torch.ones(64, device="cuda"),
                       torch.zeros(64, device="cuda"), True)
    with pytest.raises(ValueError, match="aligned"):
        cf.matmul_batch_stats(a, w)


def test_rejects_what_the_kernel_does_not_take(card):
    a = torch.zeros((64, 12), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        cf.matmul_batch_stats(a, torch.zeros((12, 64), device="cuda",
                                             dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="bf16 or fp16"):
        cf.matmul_batch_stats(a.float()[:, :8], torch.zeros(
            (8, 64), device="cuda"))
    with pytest.raises(TypeError, match="one type"):
        cf.matmul_batch_stats(a[:, :8], torch.zeros(
            (8, 64), device="cuda", dtype=torch.float16))


def test_partial_sums_bit_identical_across_calls(card):
    a, w, _, _ = _operands(card, 3136, 512, 264)
    first = cf.matmul_batch_stats(a, w)
    for _ in range(3):
        again = cf.matmul_batch_stats(a, w)
        for x, y in zip(first, again):
            assert torch.equal(x, y)


def test_rows_past_m_add_nothing(card):
    """The last tile's rows past M are never read: huge values stored
    right after the operand's last row change no output bit."""
    m, k, n = 129, 136, 264
    big = torch.randn((256, k), generator=card, device="cuda").to(
        torch.bfloat16)
    big[m:] = 1e4
    w = _operands(card, 1, k, n)[1]
    z, s1, s2 = _check_stats(big[:m], w)
    z0, s10, s20 = cf.matmul_batch_stats(big[:m].clone(), w)
    for x, y in ((z, z0), (s1, s10), (s2, s20)):
        assert torch.equal(x, y)
    # The last partial is the one row's values alone.
    _close(s1[1], z[128].float(), 2.0 ** -7)
