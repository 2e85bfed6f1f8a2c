"""PyTorch port, fused 1x1 conv + BN (horovod_tpu_torch/ops/conv_fused.py)
held against the JAX package's ops/conv_fused.py.

The same numpy inputs go through both: the JAX side runs its Pallas
kernels in interpret mode, the port its plain PyTorch versions (the CPU
path of every wrapper), and the port must not launch a kernel.

Tolerances: f32 forward rtol 1e-4 / atol 1e-4, gradients rtol 2e-3 /
atol 1e-4 — the ones tests/test_models.py holds the fused path to
against XLA, for the same reason: the products and the batch
statistics are summed in another order (the port takes its partial sums
over 128-row tiles, the JAX kernel over its own row blocks), and the
batch-stat BN backward amplifies those ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import conv_fused as jcf
from horovod_tpu_torch.ops import conv_fused as tcf

FWD = dict(rtol=1e-4, atol=1e-4)
GRAD = dict(rtol=2e-3, atol=1e-4)

# (batch, H, W, Cin, Cout): M = 128 (whole tiles) and M = 200 (ragged).
_CASES = [(2, 8, 8, 128, 256), (2, 10, 10, 128, 128)]


def _inputs(case, seed=0):
    b, h, w, cin, cout = case
    rng = np.random.default_rng(seed)
    return {
        "x": rng.standard_normal((b, h, w, cin)).astype(np.float32),
        "w": (rng.standard_normal((cin, cout)) / np.sqrt(cin)
              ).astype(np.float32),
        "scale": (1.0 + 0.1 * rng.standard_normal(cout)).astype(np.float32),
        "bias": (0.1 * rng.standard_normal(cout)).astype(np.float32),
        "r": rng.standard_normal((b, h, w, cout)).astype(np.float32),
        "rm": rng.standard_normal(cout).astype(np.float32),
        "rv": rng.standard_normal(cout).astype(np.float32),
    }


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


@pytest.fixture(autouse=True)
def _no_launches():
    tcf._mm_forward.launches = 0
    tcf.matmul_batch_stats.launches = 0
    yield
    assert tcf._mm_forward.launches == 0
    assert tcf.matmul_batch_stats.launches == 0


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("case", _CASES)
def test_conv1x1_bn_relu_and_grads(case, relu):
    d = _inputs(case)

    def jloss(x, w, s, b):
        y = jcf.conv1x1_bn_relu(x, w, s, b, relu=relu)
        return jnp.sum(y * d["r"]), y

    (_, jy), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                     has_aux=True)(
        *(jnp.asarray(d[k]) for k in ("x", "w", "scale", "bias")))
    ts = [_t(d[k], True) for k in ("x", "w", "scale", "bias")]
    ty = tcf.conv1x1_bn_relu(*ts, relu=relu)
    (ty * _t(d["r"])).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **FWD)
    for got, want in zip(ts, jg):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), **GRAD)
    # The oracle agrees too.
    np.testing.assert_allclose(
        tcf.conv1x1_bn_relu_reference(*(t.detach() for t in ts),
                                      relu=relu).numpy(),
        np.asarray(jcf.conv1x1_bn_relu_reference(
            *(jnp.asarray(d[k]) for k in ("x", "w", "scale", "bias")),
            relu=relu)), **FWD)


@pytest.mark.parametrize("case", _CASES)
def test_matmul_batch_stats(case):
    d = _inputs(case)
    b, h, w, cin, cout = case
    a = d["x"].reshape(-1, cin)
    jz, js1, js2 = jcf.matmul_batch_stats(jnp.asarray(a), jnp.asarray(d["w"]))
    tz, ts1, ts2 = tcf.matmul_batch_stats(_t(a), _t(d["w"]))
    assert ts1.shape == (-(-a.shape[0] // tcf.BLOCK_M), cout)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **FWD)
    np.testing.assert_allclose(ts1.sum(0).numpy(), np.asarray(js1).sum(0),
                               **FWD)
    np.testing.assert_allclose(ts2.sum(0).numpy(), np.asarray(js2).sum(0),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("case", _CASES)
def test_conv1x1_bn_train_and_grads(case, relu):
    """Forward (y, mean, var) and gradients, with cotangents arriving on
    mean and var as well as on y."""
    d = _inputs(case)

    def jloss(x, w, g, b):
        y, mean, var = jcf.conv1x1_bn_train(x, w, g, b, eps=1e-5, relu=relu)
        loss = (jnp.sum(y * d["r"]) + jnp.sum(mean * d["rm"])
                + jnp.sum(var * d["rv"]))
        return loss, (y, mean, var)

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                       has_aux=True)(
        *(jnp.asarray(d[k]) for k in ("x", "w", "scale", "bias")))
    ts = [_t(d[k], True) for k in ("x", "w", "scale", "bias")]
    ty, tm, tv = tcf.conv1x1_bn_train(*ts, eps=1e-5, relu=relu)
    ((ty * _t(d["r"])).sum() + (tm * _t(d["rm"])).sum()
     + (tv * _t(d["rv"])).sum()).backward()
    for got, want in zip((ty, tm, tv), jout):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **FWD)
    for got, want in zip(ts, jg):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), **GRAD)
    ref = tcf.conv1x1_bn_train_reference(*(t.detach() for t in ts),
                                         relu=relu)
    jref = jcf.conv1x1_bn_train_reference(
        *(jnp.asarray(d[k]) for k in ("x", "w", "scale", "bias")), relu=relu)
    for got, want in zip(ref, jref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


_F16_ULP = 2.0 ** -10


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("case", _CASES)
def test_fp16_matches_jax(case, relu):
    """fp16 operands, which the kernels take beside bf16: the JAX
    package's Pallas kernels (interpret mode) and the port's plain
    versions both round an f32 product, sum and affine to fp16 once, so
    they differ by at most one fp16 ulp of the largest output (the f32
    sums are added in another order); the partial sums as in
    test_matmul_batch_stats."""
    d = _inputs(case)
    b, h, w, cin, cout = case
    a = d["x"].reshape(-1, cin).astype(np.float16)
    wt = d["w"].astype(np.float16)
    jy = np.asarray(jcf.matmul_bn_relu(
        jnp.asarray(a), jnp.asarray(wt), jnp.asarray(d["scale"]),
        jnp.asarray(d["bias"]), relu=relu)).astype(np.float32)
    ty = tcf.matmul_bn_relu(_t(a), _t(wt), _t(d["scale"]), _t(d["bias"]),
                            relu=relu)
    assert ty.dtype == torch.float16
    np.testing.assert_allclose(ty.float().numpy(), jy, rtol=0,
                               atol=_F16_ULP * np.abs(jy).max())
    jz, js1, js2 = jcf.matmul_batch_stats(jnp.asarray(a), jnp.asarray(wt))
    tz, ts1, ts2 = tcf.matmul_batch_stats(_t(a), _t(wt))
    assert tz.dtype == torch.float16 and ts1.dtype == torch.float32
    jz = np.asarray(jz).astype(np.float32)
    np.testing.assert_allclose(tz.float().numpy(), jz, rtol=0,
                               atol=_F16_ULP * np.abs(jz).max())
    np.testing.assert_allclose(ts1.sum(0).numpy(), np.asarray(js1).sum(0),
                               **FWD)
    np.testing.assert_allclose(ts2.sum(0).numpy(), np.asarray(js2).sum(0),
                               rtol=1e-4, atol=1e-3)


def test_partials_follow_block_m():
    """s1/s2 row i sums z over rows [i BLOCK_M, (i+1) BLOCK_M) — the CUDA
    kernel's tile height, which the library reports and the wrapper
    checks (``hvdt_conv_fused_block_m``) — and a ragged last block sums
    only the rows that exist."""
    assert tcf.BLOCK_M == 128
    rng = np.random.default_rng(1)
    m, k, n = 2 * tcf.BLOCK_M + 44, 16, 24
    a = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    z, s1, s2 = tcf.matmul_batch_stats(_t(a), _t(w))
    assert s1.shape == s2.shape == (3, n)
    zf = z.double().numpy()
    for i in range(3):
        block = zf[i * tcf.BLOCK_M:(i + 1) * tcf.BLOCK_M]
        np.testing.assert_allclose(s1[i].numpy(), block.sum(0), **FWD)
        np.testing.assert_allclose(s2[i].numpy(), (block ** 2).sum(0), **FWD)


def test_matmul_bn_relu_relu_grad_at_zero_is_zero():
    """relu'(0) = 0 from the y > 0 mask, as the JAX package's kernel
    path: a unit whose pre-activation is exactly 0 passes no gradient."""
    a = torch.zeros(16, 8, requires_grad=True)
    w = torch.ones(8, 8, requires_grad=True)
    s = torch.ones(8, requires_grad=True)
    b = torch.zeros(8, requires_grad=True)
    tcf.matmul_bn_relu(a, w, s, b, relu=True).sum().backward()
    assert float(b.grad.abs().sum()) == 0.0


def test_sync_bn_axis_not_ported():
    x = torch.zeros(1, 2, 2, 8)
    with pytest.raises(NotImplementedError, match="SyncBN"):
        tcf.conv1x1_bn_train(x, torch.zeros(8, 8), torch.ones(8),
                             torch.zeros(8), axis="dp")
