"""PyTorch port, the whole-sequence ("smallseq") attention
(horovod_tpu_torch/ops/pallas_kernels.py flash_attention_smallseq, kernels
#12 and #13) and its gate in models/transformer.py, held against the JAX
package's on the same numpy inputs.

The JAX side runs its Pallas kernels in interpret mode on the CPU, as
tests/test_pallas.py runs them; the port runs the kernels' plain PyTorch
versions, as it does for every CPU tensor, and must launch no kernel.
Sizes: B 2, L 128 (one case at L 256), H 4-8, D 16-32; the slice test
runs the transformer of tests/test_torch_port_transformer.py (2 layers,
d_model 64, 4 heads over 2 kv heads, seq 128, f32).  The kernels
themselves are held to these plain versions on the card
(tests/test_torch_port_flash_card.py and chip_smoke.py).

Tolerances:
* f32 outputs: 2e-6 absolute (values of magnitude ~1) — the same
  algorithm with the same rounding points, only the matmuls' summation
  order differs (about 5e-7 measured);
* f32 gradients: 1e-5 absolute (about 1e-6 measured);
* bf16: one bf16 ulp of the largest output (2^-7 of it) — both sides
  round the same f32 values to bf16 (P, dS, the outputs), and f32 sums
  in another order can move one across a rounding boundary;
* the transformer: loss rtol 1e-5, gradients 1e-4 relative L2 per tensor
  (the same math in the same order up to the matmuls' summation order).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as jt
from horovod_tpu.ops import pallas_kernels as jpk
from horovod_tpu_torch.common import config
from horovod_tpu_torch.convert import (_param_tensors,
                                       transformer_params_from_jax)
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.ops import pallas_kernels as tpk

_ATOL = 2e-6
_GRAD_ATOL = 1e-5
_KERNELS = (tpk._flash_fwd, tpk._flash_dq, tpk._flash_dkv, tpk._smallseq_fwd,
            tpk._smallseq_bwd)


@pytest.fixture(autouse=True)
def _no_launches():
    for fn in _KERNELS:
        fn.launches = 0
    yield
    for fn in _KERNELS:
        assert fn.launches == 0


def _qkv(seed, b=2, l=128, h=4, hkv=None, d=32):
    rng = np.random.default_rng(seed)
    hkv = hkv or h
    return (rng.standard_normal((b, l, h, d)).astype(np.float32),
            rng.standard_normal((b, l, hkv, d)).astype(np.float32),
            rng.standard_normal((b, l, hkv, d)).astype(np.float32))


def _j(*xs, dtype=jnp.float32):
    return [jnp.asarray(x, dtype) for x in xs]


def _t(*xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


def _close(got, want, atol=_ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0.0,
                               atol=atol)


# ---- forward ---------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,hkv,hb", [(4, 4, 2), (4, 2, 4), (8, 2, 2)])
def test_forward_matches_jax(causal, h, hkv, hb):
    """(8, 2) at heads_per_block 2 clamps up to the GQA group of 4."""
    q, k, v = _qkv(0, h=h, hkv=hkv)
    kw = dict(causal=causal, heads_per_block=hb)
    want = jpk.flash_attention_smallseq(*_j(q, k, v), **kw)
    got = tpk.flash_attention_smallseq(*_t(q, k, v), **kw)
    assert got.shape == (2, 128, h, 32) and got.dtype == torch.float32
    _close(got, want)
    _close(got, tpk.attention_reference(*_t(q, k, v), causal=causal),
           atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_forward_lse_matches_jax(causal):
    """The forward's (out, lse) against the reference's pallas_call, which
    keeps them in [B, H, L, D] / [B, H, L, 1]."""
    q, k, v = _qkv(1, h=4, hkv=2, l=256, d=16)
    scale = 16 ** -0.5
    jo, jl = jpk._smallseq_call(*(x.transpose(0, 2, 1, 3) for x in
                                  _j(q, k, v)), causal, scale, 4)
    out, lse = tpk._smallseq_fwd(*_t(q, k, v), causal=causal, scale=scale,
                                 hb=4)
    assert lse.shape == (2, 4, 256) and lse.dtype == torch.float32
    _close(out, np.asarray(jo).transpose(0, 2, 1, 3))
    _close(lse, np.asarray(jl)[..., 0], atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_forward_matches_jax(causal):
    q, k, v = _qkv(2)
    want = np.asarray(jpk.flash_attention_smallseq(
        *_j(q, k, v, dtype=jnp.bfloat16), causal=causal), np.float32)
    got = tpk.flash_attention_smallseq(*_t(q, k, v, dtype=torch.bfloat16),
                                       causal=causal)
    assert got.dtype == torch.bfloat16
    _close(got.float(), want, atol=np.abs(want).max() * 2.0 ** -7)


def test_heads_per_block_shapes_nothing_but_the_loop():
    """hb only chooses how the plain version walks the heads: every
    allowed value (a multiple of the GQA group dividing H) gives the same
    numbers."""
    q, k, v = _t(*_qkv(3, h=8, hkv=4))
    outs = [tpk._smallseq_fwd(q, k, v, causal=True, scale=0.2, hb=hb)
            for hb in (2, 4, 8)]
    for out, lse in outs[1:]:
        torch.testing.assert_close(out, outs[0][0], rtol=0, atol=1e-6)
        torch.testing.assert_close(lse, outs[0][1], rtol=0, atol=1e-6)


# ---- backward --------------------------------------------------------------


def _grads_jax(q, k, v, w, **kw):
    def loss(a, b, c):
        return ((jpk.flash_attention_smallseq(a, b, c, **kw) * w) ** 2).sum()

    return jax.grad(loss, argnums=(0, 1, 2))(*_j(q, k, v))


def _grads_port(q, k, v, w, dtype=torch.float32, **kw):
    leaves = [x.requires_grad_() for x in _t(q, k, v, dtype=dtype)]
    out = tpk.flash_attention_smallseq(*leaves, **kw)
    ((out.float() * torch.from_numpy(w)) ** 2).sum().backward()
    return [x.grad for x in leaves]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,hkv,hb", [(4, 4, 2), (4, 2, 4), (8, 2, 2)])
def test_grads_match_jax(causal, h, hkv, hb):
    """Gradients of sum((smallseq(q, k, v) * w)^2) against jax.grad of the
    reference's; GQA groups accumulate dk/dv over their q heads."""
    q, k, v = _qkv(4, h=h, hkv=hkv)
    w = np.cos(np.arange(32, dtype=np.float32))
    kw = dict(causal=causal, heads_per_block=hb)
    want = _grads_jax(q, k, v, w, **kw)
    got = _grads_port(q, k, v, w, **kw)
    for g, ref in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == ref.shape
        _close(g, ref, atol=_GRAD_ATOL)


@pytest.mark.parametrize("h,hkv,l", [(4, 2, 128), (8, 2, 128), (4, 2, 40)])
def test_bf16_grads_match_jax(h, hkv, l):
    """bf16 gradients against jax.grad of the reference's: GQA groups of 2
    and 4 (dk/dv summed over the group), and a ragged L 40."""
    q, k, v = _qkv(5, h=h, hkv=hkv, l=l)
    w = np.cos(np.arange(32, dtype=np.float32))

    def loss(a, b, c):
        out = jpk.flash_attention_smallseq(a, b, c, causal=True)
        return ((out.astype(jnp.float32) * w) ** 2).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *_j(q, k, v, dtype=jnp.bfloat16))
    got = _grads_port(q, k, v, w, dtype=torch.bfloat16, causal=True)
    for g, ref in zip(got, want):
        assert g.dtype == torch.bfloat16
        ref = np.asarray(ref, np.float32)
        _close(g.float(), ref, atol=np.abs(ref).max() * 2.0 ** -7)


def test_backward_plain_matches_reference_pallas_call():
    """_smallseq_bwd (through its plain version) against the reference's
    backward rule on the same residuals: dq, dk, dv in the input dtype,
    dk/dv summed over each GQA group."""
    q, k, v = _qkv(6, h=8, hkv=2, d=16)
    do = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    scale = 16 ** -0.5
    jq, jk, jv, jdo = _j(q, k, v, do)
    out_t, lse4 = jpk._smallseq_call(*(x.transpose(0, 2, 1, 3)
                                       for x in (jq, jk, jv)),
                                     True, scale, 4)
    want = jpk._smallseq_diff_bwd(True, scale, 4, (jq, jk, jv, out_t, lse4),
                                  jdo)
    out = torch.from_numpy(np.asarray(out_t).transpose(0, 2, 1, 3).copy())
    lse = torch.from_numpy(np.asarray(lse4)[..., 0].copy())
    got = tpk._smallseq_bwd(*_t(q, k, v, do), out, lse, causal=True,
                            scale=scale, hb=4)
    assert [g.shape for g in got] == [(2, 128, 8, 16), (2, 128, 2, 16),
                                      (2, 128, 2, 16)]
    for g, ref in zip(got, want):
        _close(g, ref, atol=_GRAD_ATOL)


# ---- surface ---------------------------------------------------------------


@pytest.mark.parametrize("h,group,hb,want", [
    (16, 1, 8, 8), (4, 1, 8, 4), (6, 1, 4, 3), (8, 4, 8, 8), (8, 4, 6, 4),
    (32, 16, 8, 16), (16, 8, 0, 8)])
def test_fit_heads_per_block_matches_jax(h, group, hb, want):
    """The reference's table: a request below the GQA group, or a
    nonsense knob value, clamps up to one whole group — never 0."""
    assert tpk._fit_heads_per_block(h, group, hb) == want
    assert jpk._fit_heads_per_block(h, group, hb) == want


@pytest.mark.parametrize("shapes,match", [
    (((2, 128, 4, 16), (2, 128, 3, 16)), "not divisible"),
    (((2, 128, 4, 16), (2, 64, 4, 16)), "lq == lk")])
def test_value_errors_match_jax(shapes, match):
    qs, ks = shapes
    q, k = torch.zeros(qs), torch.zeros(ks)
    with pytest.raises(ValueError, match=match):
        tpk.flash_attention_smallseq(q, k, k)
    with pytest.raises(ValueError, match=match):
        jpk.flash_attention_smallseq(jnp.zeros(qs), jnp.zeros(ks),
                                     jnp.zeros(ks))


def test_library_name_hashes_included_headers(tmp_path, monkeypatch):
    """A kernel library's name carries the hash of its source and of the
    csrc headers it includes, so an edited header never loads a stale
    library; both attention sources share flash_common.cuh and, through
    flash_bwd_sm90.cuh, the backward bodies of #10, #11 and #13."""
    from horovod_tpu_torch import _build

    assert "flash_smallseq" in _build.SOURCES
    for name in ("flash_attn", "flash_smallseq"):
        assert {"flash_common.cuh", "flash_sm90.cuh",
                "flash_bwd_sm90.cuh"} <= {p.name for p in
                                          _build._sources(name)}
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n#include <math.h>\n')
    (tmp_path / "h.cuh").write_text('#include "i.cuh"\nint x;\n')
    (tmp_path / "i.cuh").write_text("int y;\n")
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    names = [_build._lib_path("a").name]
    for header, text in (("h.cuh", '#include "i.cuh"\nint x2;\n'),
                         ("i.cuh", "int y2;\n")):
        (tmp_path / header).write_text(text)
        names.append(_build._lib_path("a").name)
    assert len(set(names)) == 3, names
    assert all(n.startswith("liba-") and n.endswith(".so") for n in names)


# ---- the gate ---------------------------------------------------------------


def _tpu(monkeypatch, on_tpu: bool):
    """Make the reference's platform check read a TPU (or not): the port
    reads ``device="cuda"`` where the reference reads the TPU platform."""
    fake = types.SimpleNamespace(devices=lambda: [types.SimpleNamespace(
        platform="tpu" if on_tpu else "cpu")])
    monkeypatch.setattr(jt, "jax", fake)


@pytest.mark.parametrize("threshold", [None, 16, 4096])
@pytest.mark.parametrize("seq,batch,heads", [
    (512, 128, 16), (1024, 2, 16), (2048, 128, 16), (130, 128, 16),
    (256, 16, 4)])
@pytest.mark.parametrize("mode", ["on", "auto", "off"])
def test_smallseq_gate_matches_reference(monkeypatch, mode, seq, batch,
                                         heads, threshold):
    monkeypatch.setenv("HVDT_FLASH_SMALLSEQ", mode)
    monkeypatch.setattr(tt, "_SMALLSEQ_AUTO_MIN_PROGRAMS", threshold)
    monkeypatch.setattr(jt, "_SMALLSEQ_AUTO_MIN_PROGRAMS", threshold)
    for hb in ("2", "4", "8", "16"):
        monkeypatch.setenv("HVDT_FLASH_SMALLSEQ_HB", hb)
        for device, on_tpu in (("cuda", True), ("cpu", False)):
            _tpu(monkeypatch, on_tpu)
            for dh in (64, 128):
                want = jt._smallseq_enabled(seq, dh, batch=batch,
                                            heads=heads)
                got = tt._smallseq_enabled(seq, dh, batch=batch,
                                           heads=heads,
                                           device=torch.device(device))
                assert got is want, (hb, device, dh)


def test_smallseq_gate_engages_auto_only_with_a_threshold(monkeypatch):
    monkeypatch.setenv("HVDT_FLASH_SMALLSEQ", "auto")
    cuda = torch.device("cuda")
    assert not tt._smallseq_enabled(512, 64, batch=128, heads=16,
                                    device=cuda)
    monkeypatch.setattr(tt, "_SMALLSEQ_AUTO_MIN_PROGRAMS", 16)
    assert tt._smallseq_enabled(512, 64, batch=128, heads=16, device=cuda)
    assert not tt._smallseq_enabled(512, 64, batch=128, heads=16,
                                    device=torch.device("cpu"))
    monkeypatch.setenv("HVDT_FLASH_SMALLSEQ_HB", "16")   # 12 MiB model
    assert not tt._smallseq_enabled(512, 64, batch=128, heads=16,
                                    device=cuda)


@pytest.mark.parametrize("seq,dh,hb", [
    (512, 64, 16), (512, 64, 8), (512, 64, 4), (1024, 64, 4),
    (1024, 128, 2), (128, 64, 16)])
def test_smallseq_vmem_ok_matches_reference(seq, dh, hb):
    assert tt._smallseq_vmem_ok(seq, dh, hb) is jt._smallseq_vmem_ok(
        seq, dh, hb)


@pytest.mark.parametrize("smallseq", ["on", "auto", "off"])
@pytest.mark.parametrize("flash", ["on", "auto", "off"])
def test_flash_fn_matches_reference(monkeypatch, flash, smallseq):
    """HVDT_FLASH_ATTENTION=off is the master off, =on forces the
    streaming kernel; otherwise smallseq, when its gate passes."""
    monkeypatch.setenv("HVDT_FLASH_ATTENTION", flash)
    monkeypatch.setenv("HVDT_FLASH_SMALLSEQ", smallseq)
    _tpu(monkeypatch, False)
    want = jt._flash_fn(128, 32, batch=8, heads=8)
    got = tt._flash_fn(128, 32, batch=8, heads=8, device=torch.device("cpu"))
    assert (got is None) is (want is None)
    if want is not None:
        assert got.func.__name__ == want.func.__name__
        assert got.keywords == want.keywords
    if flash == "off":
        assert got is None
    elif flash == "on":
        assert got.func is tpk.flash_attention
    else:
        assert (got is not None) is (smallseq == "on")


@pytest.mark.parametrize("hb", [None, "2", "16"])
def test_heads_per_block_follows_knob(monkeypatch, hb):
    monkeypatch.setenv("HVDT_FLASH_SMALLSEQ", "on")
    monkeypatch.delenv("HVDT_FLASH_ATTENTION", raising=False)
    if hb is None:
        monkeypatch.delenv("HVDT_FLASH_SMALLSEQ_HB", raising=False)
    else:
        monkeypatch.setenv("HVDT_FLASH_SMALLSEQ_HB", hb)
    fn = tt._flash_fn(512, 64, batch=128, heads=16, device=torch.device("cpu"))
    assert fn.func is tpk.flash_attention_smallseq
    assert fn.keywords == {"causal": True,
                           "heads_per_block": int(hb or 8)}
    assert config.KNOBS["HVDT_FLASH_SMALLSEQ_HB"].default == 8


# ---- the slice as a whole ----------------------------------------------------

_KW = dict(vocab=128, layers=2, d_model=64, heads=4, kv_heads=2, d_ff=128,
           max_seq=128)


def _numpy_params(seed=0):
    """The JAX package's params tree, traced abstractly and filled from
    numpy (norms 1, weights N(0, 0.1²))."""
    shapes = jax.eval_shape(
        lambda key: jt.transformer_init(key, jt.TransformerConfig(**_KW)),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if "ln" in jax.tree_util.keystr(path):
            return np.ones(leaf.shape, np.float32)
        return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("remat,chunk", [(False, 0), (True, 32)])
def test_transformer_smallseq_matches_jax(monkeypatch, remat, chunk):
    """With HVDT_FLASH_SMALLSEQ=on, the port's loss and gradients from
    weights carried across by convert match the JAX package's
    transformer_loss under the same knob (a fresh jax.jit), and the
    smallseq function ran on both sides."""
    monkeypatch.setenv("HVDT_FLASH_SMALLSEQ", "on")
    monkeypatch.delenv("HVDT_FLASH_ATTENTION", raising=False)
    params = _numpy_params()
    tokens = np.random.default_rng(1).integers(0, 128, (2, 128)).astype(
        np.int32)

    jcalls, tcalls = [], []
    jreal, treal = jpk.flash_attention_smallseq, tt.flash_attention_smallseq
    monkeypatch.setattr(jpk, "flash_attention_smallseq",
                        lambda *a, **k: jcalls.append(1) or jreal(*a, **k))
    monkeypatch.setattr(tt, "flash_attention_smallseq",
                        lambda *a, **k: tcalls.append(1) or treal(*a, **k))

    jcfg = jt.TransformerConfig(dtype=jnp.float32, remat=remat,
                                loss_chunk=chunk, **_KW)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p, t: jt.transformer_loss(p, t, jcfg)))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(tokens))
    want_grads = _param_tensors(jax.tree.map(np.asarray, want_grads))

    cfg = tt.TransformerConfig(dtype=torch.float32, remat=remat,
                               loss_chunk=chunk, **_KW)
    model = tt.transformer_init(0, cfg, device="cpu")
    model.load_state_dict(transformer_params_from_jax(params))
    loss = tt.transformer_loss(model, torch.from_numpy(tokens), cfg)
    loss.backward()

    assert jcalls
    assert len(tcalls) == cfg.layers * (1 + remat)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for name, p in model.named_parameters():
        w = want_grads[name].numpy().astype(np.float64)
        d = np.linalg.norm(p.grad.numpy().astype(np.float64) - w)
        assert d <= 1e-4 * np.linalg.norm(w) + 1e-12, (name, d)
