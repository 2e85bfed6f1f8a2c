"""PyTorch port: the fp8 (e4m3) matmul of ``quant/fp8.py`` held against
the JAX package's ``horovod_tpu/quant/fp8.py`` on the same numpy inputs.

* The quantized operands (scale, clip, e4m3 cast) are bit-identical to
  the reference's ``_scale_for`` / ``_cast_e4m3``.
* The forward equals ``fp8_matmul`` and ``fp8_matmul_delayed`` (state
  included) up to f32 accumulation order: 1e-6 of the output's largest
  magnitude for f32 outputs, one bf16 rounding (2^-8 of each element's
  magnitude, plus 1e-6 of the largest) for bf16 outputs.
* The backward is held against ``jax.vjp`` of a straight-through variant
  built here from the reference's own scale and cast (dequantize, then
  the f32 dot), the clip boundary's 1/2 tie included: 1e-5 of each
  gradient's largest magnitude (the port scales after the product, the
  variant before it).  The reference's own vjp rounds its cotangents to
  e4m3; a test records that at cotangent std 1e-3 it flushes every
  element of dx and dw to zero where the port's does not.
* The transformer LM (2 layers, d_model 64, f32) with HVDT_FP8=matmul:
  loss against the reference's (rtol 1e-5) and gradients against the
  reference with its fp8_matmul swapped for the straight-through variant
  (relative L2 per tensor: 2e-2, or 1e-5 with the clip's gradient taken
  as 1 on both sides; see the test for why).

Every case here runs the plain version (CPU tensors).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax import lax

from horovod_tpu.models import transformer as jt
from horovod_tpu.quant import fp8 as jf
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.quant import fp8 as tf
from horovod_tpu_torch.convert import _param_tensors
from test_torch_port_transformer import (_assert_rel, _jcfg, _np,
                                         _numpy_params, _port, _tcfg,
                                         _tokens)

_DT = {"f32": (np.float32, torch.float32, jnp.float32),
       "bf16": (ml_dtypes.bfloat16, torch.bfloat16, jnp.bfloat16)}


def _arr(rng, shape, std, dtype="f32"):
    return (rng.standard_normal(shape) * std).astype(_DT[dtype][0])


def _t(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _n(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _ste_matmul(x, w, amax_x=None, amax_w=None):
    """The reference's scale and cast with a straight-through f32
    gradient: the dequantized operands enter an f32 dot, and the e4m3
    rounding is a stop_gradient offset."""
    if amax_x is None:
        amax_x = lax.stop_gradient(jnp.max(jnp.abs(x)))
    if amax_w is None:
        amax_w = lax.stop_gradient(jnp.max(jnp.abs(w)))
    sx = jf._scale_for(jnp.asarray(amax_x))
    sw = jf._scale_for(jnp.asarray(amax_w))

    def dq(t, s):
        y = jnp.clip(t.astype(jnp.float32) / s, -jf.E4M3_MAX, jf.E4M3_MAX)
        q = y.astype(jnp.float8_e4m3fn).astype(jnp.float32)
        return (y + lax.stop_gradient(q - y)) * s

    return (dq(x, sx) @ dq(w, sw)).astype(x.dtype)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("HVDT_FP8", raising=False)
    for knob in ("HVDT_FLASH_ATTENTION", "HVDT_FLASH_BWD"):
        monkeypatch.delenv(knob, raising=False)


# ---- operands ----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape,std,amax", [
    ((64, 256), 1.0, None), ((256, 128), 0.02, None),
    ((3, 5, 48), 30.0, None), ((32, 32), 1e-4, None),
    ((32, 32), 1.0, 0.5),          # an amax under max|x|: the clip acts
    ((16, 16), 0.0, None)])        # all zero: scale 1
def test_quantized_operands_bit_identical(dtype, shape, std, amax):
    x = _arr(np.random.default_rng(3), shape, std, dtype)
    a = np.float32(np.abs(x.astype(np.float32)).max()) if amax is None \
        else np.float32(amax)
    sj = jf._scale_for(jnp.asarray(a))
    st = tf._scale_for(torch.tensor(a))
    assert np.asarray(sj).view(np.uint32) == st.numpy().view(np.uint32)
    qj = np.asarray(jf._cast_e4m3(jnp.asarray(x), sj)).view(np.uint8)
    qt = tf._cast_e4m3(_t(x), st).view(torch.uint8).numpy()
    np.testing.assert_array_equal(qt, qj)
    q2, mask = tf._cast_and_mask(_t(x), st)
    np.testing.assert_array_equal(q2.view(torch.uint8).numpy(), qj)
    assert set(np.unique(mask.numpy())) <= {0.0, 0.5, 1.0}


def test_gate_and_probe(monkeypatch):
    assert tf.fp8_available()
    assert not tf.matmul_enabled()
    monkeypatch.setenv("HVDT_FP8", "matmul")
    assert tf.fp8_mode() == "matmul" and tf.matmul_enabled()
    monkeypatch.setenv("HVDT_FP8", "bogus")
    with pytest.raises(ValueError, match="valid: off, matmul"):
        tf.fp8_mode()


# ---- forward -----------------------------------------------------------------


def _close_fwd(got, want, dtype):
    got = _n(got).astype(np.float32)
    want = np.asarray(want).astype(np.float32)
    top = np.abs(want).max()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * top)
    else:
        assert (np.abs(got - want)
                <= 2.0 ** -8 * np.abs(want) + 1e-6 * top).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("xshape,n,amaxes", [
    ((64, 256), 128, None), ((2, 24, 64), 48, None),
    ((64, 256), 128, (1.5, 0.03))])
def test_forward_matches_reference(dtype, xshape, n, amaxes):
    rng = np.random.default_rng(7)
    x = _arr(rng, xshape, 1.0, dtype)
    w = _arr(rng, (xshape[-1], n), 0.02)
    kw_j, kw_t = {}, {}
    if amaxes is not None:
        kw_j = dict(amax_x=jnp.float32(amaxes[0]),
                    amax_w=jnp.float32(amaxes[1]))
        kw_t = dict(amax_x=torch.tensor(amaxes[0]),
                    amax_w=torch.tensor(amaxes[1]))
    want = jf.fp8_matmul(jnp.asarray(x), jnp.asarray(w), **kw_j)
    got = tf.fp8_matmul(_t(x), _t(w), **kw_t)
    assert got.dtype == _DT[dtype][1] and got.shape == want.shape
    _close_fwd(got, want, dtype)


def test_delayed_matches_reference_with_state():
    rng = np.random.default_rng(11)
    sj = jf.init_amax_state(4)
    st = tf.init_amax_state(4, device="cpu")
    for step in range(6):
        x = _arr(rng, (32, 64), 1.0 + 2.0 * (step == 3))
        w = _arr(rng, (64, 32), 0.05)
        oj, sj = jf.fp8_matmul_delayed(jnp.asarray(x), jnp.asarray(w), sj)
        ot, st = tf.fp8_matmul_delayed(_t(x), _t(w), st)
        _close_fwd(ot, oj, "f32")
        np.testing.assert_array_equal(st.x.numpy(), np.asarray(sj.x))
        np.testing.assert_array_equal(st.w.numpy(), np.asarray(sj.w))


# ---- backward ----------------------------------------------------------------


def _tie_inputs():
    """x whose largest element lands exactly on 448 after the scale (the
    tie) and w with an amax override under max|w| (the clip acts)."""
    rng = np.random.default_rng(5)
    x = _arr(rng, (32, 64), 1.0)
    x[3, 7] = 448.0          # scale = 448 * f32(1/448) = 1.0 exactly
    w = _arr(rng, (64, 48), 0.05)
    return x, w


@pytest.mark.parametrize("case", ["plain", "tie_and_clip", "bf16", "3d"])
def test_backward_matches_straight_through_reference(case):
    rng = np.random.default_rng(13)
    amax_w = None
    if case == "tie_and_clip":
        x, w = _tie_inputs()
        amax_w = np.float32(np.abs(w).max() * 0.5)
    elif case == "3d":
        x, w = _arr(rng, (2, 16, 64), 1.0), _arr(rng, (64, 32), 0.02)
    else:
        dtype = "bf16" if case == "bf16" else "f32"
        x, w = _arr(rng, (64, 256), 1.0, dtype), _arr(rng, (256, 128), 0.02)
    g = _arr(rng, x.shape[:-1] + (w.shape[1],), 1e-3, _dtype_of(x))

    def ref(xx, ww):
        return _ste_matmul(xx, ww, amax_w=None if amax_w is None
                           else jnp.float32(amax_w))

    _, vjp = jax.vjp(ref, jnp.asarray(x), jnp.asarray(w))
    dxj, dwj = vjp(jnp.asarray(g))

    xt = _t(x).requires_grad_()
    wt = _t(w).requires_grad_()
    out = tf.fp8_matmul(xt, wt, amax_w=None if amax_w is None
                        else torch.tensor(amax_w))
    out.backward(_t(g))
    for got, want in ((xt.grad, dxj), (wt.grad, dwj)):
        want = np.asarray(want).astype(np.float32)
        got = _n(got).astype(np.float32)
        top = np.abs(want).max()
        assert top > 0
        if got.dtype == np.float32 and _dtype_of(x) == "f32":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * top)
        else:      # a bf16 dx: each side rounds once, maybe apart
            assert (np.abs(got - want)
                    <= 2.0 ** -7 * np.abs(want) + 1e-5 * top).all()
    if case == "tie_and_clip":
        sx = tf._scale_for(torch.tensor(np.abs(x).max()))
        mx = tf._cast_and_mask(_t(x), sx)[1].numpy()
        mw = tf._cast_and_mask(_t(w), tf._scale_for(
            torch.tensor(amax_w)))[1].numpy()
        assert (mx == 0.5).sum() == 1 and (mw == 0.0).any()
        # The tie's element gets half of the unclipped gradient.
        sw = tf._scale_for(torch.tensor(amax_w))
        qw = tf._cast_e4m3(_t(w), sw).float().numpy()
        full = (g @ qw.T) * float(sw)
        np.testing.assert_allclose(_n(xt.grad)[3, 7], 0.5 * full[3, 7],
                                   rtol=1e-5)


def _dtype_of(x):
    return "bf16" if x.dtype == ml_dtypes.bfloat16 else "f32"


def test_reference_vjp_flushes_where_the_port_does_not():
    """x [64, 256] standard normal, w [256, 128] at std 0.02, cotangent
    std 1e-3: the reference's vjp gives dx and dw all zero (its
    cotangents are rounded to e4m3), the port gives the straight-through
    gradient."""
    rng = np.random.default_rng(0)
    x = _arr(rng, (64, 256), 1.0)
    w = _arr(rng, (256, 128), 0.02)
    g = _arr(rng, (64, 128), 1e-3)
    _, vjp = jax.vjp(jf.fp8_matmul, jnp.asarray(x), jnp.asarray(w))
    dxr, dwr = vjp(jnp.asarray(g))
    assert not np.asarray(dxr).any() and not np.asarray(dwr).any()
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    tf.fp8_matmul(xt, wt).backward(_t(g))
    assert (xt.grad != 0).float().mean() > 0.99
    assert (wt.grad != 0).float().mean() > 0.99
    _, vjp_ste = jax.vjp(_ste_matmul, jnp.asarray(x), jnp.asarray(w))
    dxs, _ = vjp_ste(jnp.asarray(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dxs), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(dxs)).max())


# ---- the transformer ------------------------------------------------------------


def _ste_unclipped(x, w):
    """_ste_matmul with the clip's gradient taken as 1 everywhere."""
    sx = jf._scale_for(lax.stop_gradient(jnp.max(jnp.abs(x))))
    sw = jf._scale_for(lax.stop_gradient(jnp.max(jnp.abs(w))))

    def dq(t, s):
        y = t.astype(jnp.float32) / s
        q = jnp.clip(y, -jf.E4M3_MAX, jf.E4M3_MAX).astype(
            jnp.float8_e4m3fn).astype(jnp.float32)
        return (y + lax.stop_gradient(q - y)) * s

    return (dq(x, sx) @ dq(w, sw)).astype(x.dtype)


@pytest.mark.parametrize("clip_grad", ["clip", "unclipped"])
def test_transformer_fp8_matches_reference(monkeypatch, clip_grad):
    """The loss against the reference's fp8 loss, and the gradients
    against the reference with the straight-through fp8_matmul.

    With the clip's gradient as it is, each activation's largest element
    lands on 448 or one ulp beside it depending on the last bit of its
    amax (448 * f32(1/448) rounding), so its gradient weight (1, 1/2 or
    0) is decided by rounding the two frameworks do not share after the
    first layer: up to 2e-2 relative L2 per tensor (1.8e-2 measured, on
    ln2).  With the clip's gradient taken as 1 on both sides, the rest
    of the backward agrees to 1e-5 (8e-7 measured)."""
    params = _numpy_params(2)
    tokens = _tokens(3)
    monkeypatch.setenv("HVDT_FLASH_ATTENTION", "off")
    monkeypatch.setenv("HVDT_FP8", "matmul")
    jcfg, tcfg = _jcfg(), _tcfg()
    jparams = jax.tree.map(jnp.asarray, params)
    loss_j = jax.jit(lambda p, t: jt.transformer_loss(p, t, jcfg))(
        jparams, jnp.asarray(tokens))
    monkeypatch.setattr(jf, "fp8_matmul", _ste_matmul
                        if clip_grad == "clip" else _ste_unclipped)
    _, grads_j = jax.jit(jax.value_and_grad(
        lambda p, t: jt.transformer_loss(p, t, jcfg)))(
            jparams, jnp.asarray(tokens))
    if clip_grad == "unclipped":
        real = tf._cast_and_mask
        monkeypatch.setattr(tf, "_cast_and_mask", lambda x, s, dt: (
            real(x, s, dt)[0], torch.ones(x.shape, dtype=dt)))
    model = _port(params, tcfg)
    loss_t = tt.transformer_loss(model, torch.from_numpy(tokens), tcfg)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    monkeypatch.delenv("HVDT_FP8")
    loss_off = tt.transformer_loss(_port(params, tcfg),
                                   torch.from_numpy(tokens), tcfg)
    assert loss_off.item() != loss_t.item()
    _assert_rel({n: p.grad.numpy() for n, p in model.named_parameters()},
                {n: g.numpy() for n, g in
                 _param_tensors(_np(grads_j)).items()},
                tol=2e-2 if clip_grad == "clip" else 1e-5)


# ---- the rest of slice 2: the stacked-residual helpers -------------------------


def test_residual_helpers_match_reference():
    from horovod_tpu.quant import error_feedback as jef
    from horovod_tpu_torch.quant import error_feedback as tef

    rng = np.random.default_rng(21)
    tree = {"w": _arr(rng, (3, 4), 1.0), "b": [_arr(rng, (5,), 1.0)]}
    sj = jef.ErrorFeedbackState(
        residual=jax.tree.map(jnp.asarray, tree), inner=())
    st = tef.ErrorFeedbackState(
        residual={"w": _t(tree["w"]), "b": [_t(tree["b"][0])]}, inner=())
    tj, tt_ = jef.tile_residual(sj, 4), tef.tile_residual(st, 4)
    for fj, ft in ((lambda s: s, lambda s: s),
                   (jef.unstack_residual, tef.unstack_residual),
                   (lambda s: jef.stack_residual(jef.unstack_residual(s)),
                    lambda s: tef.stack_residual(tef.unstack_residual(s)))):
        rj, rt = fj(tj).residual, ft(tt_).residual
        np.testing.assert_array_equal(rt["w"].numpy(), np.asarray(rj["w"]))
        np.testing.assert_array_equal(rt["b"][0].numpy(),
                                      np.asarray(rj["b"][0]))
    assert tt_.inner == () and isinstance(tt_.residual["b"], list)
