"""PyTorch port, the int8/int4 compressed gradient wire
(horovod_tpu_torch/quant/, ops/compression.py, the quantized branch of
ops/device.fused_allreduce and the new tensor collectives) held against
the JAX package on the same numpy inputs.

The JAX side runs both of its routes: the Pallas kernels in interpret
mode (``use_kernels=True`` or ``HVDT_QUANT_KERNELS=on``; sizes the TPU
tile gate refuses take its XLA fallback there) and XLA
(``use_kernels=False`` or ``HVDT_QUANT_KERNELS=off``).  The port runs
its plain PyTorch versions, as it does for every CPU tensor, and must
not launch a kernel.

Tolerances.  Quantize, dequantize and the two-stage allreduce at n <= 2:
bit-identical (tolerance 0) — the max is exact, every other step is one
IEEE f32 operation on both sides, and a sum of at most two terms has
one order.  Under jit, XLA's CPU backend contracts a multiply and a
following add into one FMA (one rounding fewer), which the JAX package
does not ask for and the port does not do; so the inputs of the jitted
collective comparisons have a per-block absmax of levels·2^k
(:func:`_pinned`), which makes every stage-1 dequantized product exact
and the contraction harmless, and the error-feedback comparison, whose
residual ``e - q·s`` is such a contraction, runs the JAX side op by op
(shard_map outside jit).  The tensor collectives: bit-identical (they move bytes; the
sums have two terms).  Parameters after fused_sgd steps: rtol 1e-6 /
atol 1e-7, the tolerance of tests/test_torch_port_optim.py for the same
optimizer.  The 200-step MLP: int8 loss within 5% of the f32 wire's, as
tests/test_quant.py holds the reference.
"""

import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

from horovod_tpu import optimizer as jopt
from horovod_tpu import quant as jquant
from horovod_tpu.common.types import ReduceOp as JReduceOp
from horovod_tpu.ops import compression as jcomp
from horovod_tpu.ops import device as jdev
from horovod_tpu.ops.optim_kernels import fused_sgd as jax_fused_sgd
from horovod_tpu.quant import collectives as jqc
from horovod_tpu.quant import kernels as jqk
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import device as tdev
from horovod_tpu_torch.ops import optim_kernels as tok
from horovod_tpu_torch.quant import collectives as tqc
from horovod_tpu_torch.quant import kernels as tqk

ROOT = pathlib.Path(__file__).resolve().parents[1]
_OPS = {"sum": (hvd.Sum, JReduceOp.SUM),
        "avg": (hvd.Average, JReduceOp.AVERAGE)}


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8).reshape(-1)


def _assert_same(got, want, what=""):
    """Bit-identical: same shape, same dtype name, same bytes."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype.name == want.dtype.name, (what, got.dtype, want.dtype)
    if not np.array_equal(_bits(got), _bits(want)):
        diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
        raise AssertionError(f"{what}: not bit-identical, max |diff| "
                             f"{np.nanmax(diff)} at {np.nanargmax(diff)}")


def _no_launches():
    return all(fn.launches == 0 for fn in (
        tqk._quantize_cuda, tqk._dequantize_cuda, tqk._quantize4_cuda,
        tqk._dequantize4_cuda))


def _vector(nblocks, block, seed):
    """Random values with, in the first blocks: ties at .5 on a unit
    grid (absmax 127, so scale 1), an all-zero block, values already on
    the grid of a power-of-two scale."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(nblocks * block) * 3).astype(np.float32)
    x2 = x.reshape(nblocks, block)
    if nblocks >= 1:
        x2[0] = np.round(rng.uniform(-126, 126, block)) + 0.5
        x2[0, 0] = 127.0
    if nblocks >= 2:
        x2[1] = 0.0
    if nblocks >= 3:
        x2[2] = rng.integers(-127, 128, block) * np.float32(2.0 ** -5)
        x2[2, 0] = 127 * 2.0 ** -5
    return x


def _pinned(size, block, levels, seed):
    """``size`` values of :func:`_vector` with the absmax of every block
    (the last one partial) moved up to levels·2^k, keeping its sign, so
    the block's scale is a power of two and q·scale is exact.  Pinned
    128-blocks stay pinned as 256-blocks."""
    x = _vector(-(-size // block), block, seed)[:size].copy()
    for start in range(0, size, block):
        row = x[start:start + block]
        m = np.abs(row).max()
        if m > 0:
            j = np.abs(row).argmax()
            k = np.ceil(np.log2(m / levels))
            row[j] = np.sign(row[j]) * levels * 2.0 ** k
    return x


_LEVELS = {"int8": 127, "int4": 7}


# ---- (a) quantize / dequantize against both JAX routes ----------------------

# (block, nblocks): the TPU gate accepts 64 and 32 blocks (a power-of-2
# divisor >= 32) and refuses 8 and 3, where the JAX package takes XLA.
_SIZES = [(256, 64), (512, 32), (256, 8), (512, 3)]


@pytest.mark.parametrize("wire", ["int8", "int4"])
@pytest.mark.parametrize("route", ["pallas", "xla"])
@pytest.mark.parametrize("block,nblocks", _SIZES)
def test_quantize_dequantize_bit_identical(block, nblocks, route, wire):
    x = _vector(nblocks, block, seed=block + nblocks)
    use = route == "pallas"
    if wire == "int8":
        jq, jd, tq, td = (jqk.quantize_flat, jqk.dequantize_flat,
                          tqk.quantize_flat, tqk.dequantize_flat)
    else:
        jq, jd, tq, td = (jqk.quantize_flat_int4, jqk.dequantize_flat_int4,
                          tqk.quantize_flat_int4, tqk.dequantize_flat_int4)
    qj, sj = jq(jnp.asarray(x), block, use_kernels=use)
    qt, st = tq(torch.from_numpy(x), block)
    _assert_same(qt, qj, "payload")
    _assert_same(st, sj, "scales")
    assert qt.numel() == (x.size if wire == "int8" else x.size // 2)
    _assert_same(td(qt, st, block), jd(qj, sj, block, use_kernels=use),
                 "dequantized")
    assert _no_launches()


@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_bf16_input_and_grid_values(wire):
    """bf16 input is quantized from its f32 value; values on the grid
    survive the round trip exactly (blocks 0 and 2 of _vector are on
    the int8 grid; for int4, codes of a power-of-two scale)."""
    block = 256
    x = _vector(4, block, seed=7)
    xb = x.astype(ml_dtypes.bfloat16)
    jq = jqk.quantize_flat if wire == "int8" else jqk.quantize_flat_int4
    tq = tqk.quantize_flat if wire == "int8" else tqk.quantize_flat_int4
    qj, sj = jq(jnp.asarray(xb), block, use_kernels=False)
    qt, st = tq(torch.from_numpy(xb.astype(np.float32)).to(torch.bfloat16),
                block)
    _assert_same(qt, qj, "payload")
    _assert_same(st, sj, "scales")
    levels = 127 if wire == "int8" else 7
    rng = np.random.default_rng(8)
    step = 2.0 ** rng.integers(-6, 6, (4, 1))
    grid = (rng.integers(-levels, levels + 1, (4, block)) * step
            ).astype(np.float32)
    grid[:, 0] = levels * step[:, 0]
    qdq = (tqk.quantize_dequantize if wire == "int8"
           else tqk.quantize_dequantize_int4)
    _assert_same(qdq(torch.from_numpy(grid), block), grid, "on grid")


def test_nan_block_dequantizes_to_nan():
    """A NaN makes its block's scale NaN, so the whole block comes back
    NaN in both packages; the other blocks are untouched."""
    x = _vector(3, 256, seed=9)
    x[300] = np.nan
    want = np.asarray(jqk.quantize_dequantize(jnp.asarray(x), 256,
                                              use_kernels=False))
    got = tqk.quantize_dequantize(torch.from_numpy(x), 256).numpy()
    assert np.isnan(got[256:512]).all() and np.isnan(want[256:512]).all()
    _assert_same(got[:256], want[:256])
    _assert_same(got[512:], want[512:])


# ---- (b) quantize_dequantize over odd shapes (padding) ----------------------


@pytest.mark.parametrize("wire", ["int8", "int4"])
@pytest.mark.parametrize("shape", [(1000,), (37, 17), (4, 128, 3), (5,)])
def test_round_trip_odd_shapes(shape, wire):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 2).astype(np.float32)
    jf = (jqk.quantize_dequantize if wire == "int8"
          else jqk.quantize_dequantize_int4)
    tf = (tqk.quantize_dequantize if wire == "int8"
          else tqk.quantize_dequantize_int4)
    want = jf(jnp.asarray(x), 128, use_kernels=False)
    got = tf(torch.from_numpy(x), 128)
    _assert_same(got, want)
    gb = tf(torch.from_numpy(x).to(torch.bfloat16), 128)
    assert gb.dtype == torch.bfloat16 and gb.shape == x.shape


# ---- (c) accounting, the TPU gate, errors, routing --------------------------


@pytest.mark.parametrize("size,block", [
    (256, 256), (257, 256), (1000, 256), (64 * 256, 256), (8 * 256, 256),
    (64 * 200, 200), (64 * 128, 128), (100, 256), (0, 256), (32 * 512, 512),
    (7, 2)])
def test_wire_bytes_and_gate_match_jax(size, block):
    assert tqk.wire_bytes(size, block) == jqk.wire_bytes(size, block)
    assert tqk.wire_bytes_int4(size, block) == jqk.wire_bytes_int4(size,
                                                                   block)
    assert (tqk.quant_kernel_eligible(size, block)
            == jqk.quant_kernel_eligible(size, block))
    assert (tqk.quant_kernel_eligible_int4(size, block)
            == jqk.quant_kernel_eligible_int4(size, block))


def test_value_errors_and_routing(monkeypatch):
    with pytest.raises(ValueError, match="whole number"):
        tqk.quantize_flat(torch.ones(100), 128)
    with pytest.raises(ValueError, match="whole number"):
        tqk.quantize_flat_int4(torch.ones(100), 128)
    with pytest.raises(ValueError, match="even"):
        tqk.quantize_flat_int4(torch.ones(127), 127)
    with pytest.raises(ValueError, match="1-D"):
        tqk.quantize_flat(torch.ones(2, 128), 128)
    with pytest.raises(ValueError, match="1-D"):
        tqk.quantize_flat_int4(torch.ones(2, 128), 128)
    # The kernel asked for a CPU tensor raises; off and auto take the
    # plain version there.
    with pytest.raises(ValueError, match="CUDA"):
        tqk.quantize_flat(torch.ones(256), 256, use_kernels=True)
    monkeypatch.setenv("HVDT_QUANT_KERNELS", "on")
    with pytest.raises(ValueError, match="CUDA"):
        tqk.dequantize_flat_int4(torch.zeros(128, dtype=torch.int8),
                                 torch.zeros(1), 256)
    for mode in ("off", "auto"):
        monkeypatch.setenv("HVDT_QUANT_KERNELS", mode)
        tqk.quantize_flat(torch.ones(256), 256)
    with pytest.raises(ValueError, match="CUDA"):
        tqk._quantize_cuda(torch.ones(1, 256))
    monkeypatch.setenv("HVDT_QUANT_BLOCK", "512")
    assert tqk.quant_block_size() == 512 == jqk.quant_block_size()
    monkeypatch.setenv("HVDT_QUANT_BLOCK", "0")
    assert tqk.quant_block_size() == 256 == jqk.quant_block_size()
    assert _no_launches()


# ---- (d)/(f) the quantized allreduce in a world of one ----------------------


@pytest.fixture
def world1():
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n], dtype=object), ("dp",))


# int8 at block 128 and int4 at block 256: the padded vector is 32
# blocks, so the JAX Pallas route takes its kernels at n = 1.
_WIRES = {"int8": (128, 4000), "int4": (256, 8000)}
# (op, prescale, postscale): Sum plain, Average scaled.
_CASES = [("sum", 1.0, 1.0), ("avg", 0.5, 2.0)]


def _jax_quantized(xs, wire, op, pre, post, route, monkeypatch):
    """JAX quantized_allreduce_flat over a len(xs)-device mesh."""
    block = _WIRES[wire][0]
    monkeypatch.setenv("HVDT_QUANT_KERNELS",
                       "on" if route == "pallas" else "off")

    def body(xl):
        return jqc.quantized_allreduce_flat(
            xl[0], "dp", op, block_size=block, prescale_factor=pre,
            postscale_factor=post, wire=wire)

    # The reference's Pallas calls carry no vma on this JAX (its own
    # tests run this collective on XLA only), so the check is off there.
    kw = {"check_vma": False} if route == "pallas" else {}
    out = jax.jit(shard_map(body, mesh=_mesh(len(xs)), in_specs=(P("dp"),),
                            out_specs=P(), **kw))(jnp.asarray(np.stack(xs)))
    monkeypatch.delenv("HVDT_QUANT_KERNELS")
    return np.asarray(out)


@pytest.mark.parametrize("route", ["pallas", "xla"])
@pytest.mark.parametrize("op,pre,post", _CASES)
@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_quantized_allreduce_world_of_one(world1, wire, op, pre, post,
                                          route, monkeypatch):
    block, size = _WIRES[wire]
    x = _pinned(size - 3, block, _LEVELS[wire], 11)
    want = _jax_quantized([x], wire, _OPS[op][1], pre, post, route,
                          monkeypatch)
    got = tqc.quantized_allreduce_flat(
        torch.from_numpy(x), _OPS[op][0], block_size=block,
        prescale_factor=pre, postscale_factor=post, wire=wire)
    _assert_same(got, want)
    assert _no_launches()


def test_quantized_allreduce_per_tensor_and_errors(world1):
    tree = {"w": torch.from_numpy(_vector(3, 128, 12)[:300].reshape(30, 10)),
            "n": [torch.arange(4, dtype=torch.int32)]}
    out = tqc.quantized_allreduce(tree, hvd.Sum, block_size=128)
    _assert_same(out["w"], tqc.quantized_allreduce_flat(
        tree["w"].reshape(-1), hvd.Sum, block_size=128).view(30, 10))
    _assert_same(out["n"][0], tree["n"][0])
    with pytest.raises(ValueError, match="SUM/AVERAGE"):
        tqc.quantized_allreduce_flat(torch.ones(128), hvd.Max)
    with pytest.raises(ValueError, match="'int8' or 'int4'"):
        tqc.quantized_allreduce_flat(torch.ones(128), wire="int2")
    assert tqc.quant_wire_leg(tqc.INT4_WIRE) == "int4"
    assert tqc.quant_wire_leg(torch.float32) is None
    assert tqc.wire_sentinel("int8") == jqc.wire_sentinel("int8")
    assert (tqc.INT8_WIRE, tqc.INT4_WIRE) == (jqc.INT8_WIRE, jqc.INT4_WIRE)


def _fused_leaves(seed, wire):
    """b [300] and w [33, 9] f32 (one float bucket, pinned 128-blocks)
    and an int32 leaf (its own bucket)."""
    flat = _pinned(597, 128, _LEVELS[wire], seed)
    return {"b": flat[:300], "step": np.arange(5, dtype=np.int32),
            "w": flat[300:].reshape(33, 9)}


def _jax_fused(per_rank, wire_dtype, op):
    """JAX fused_allreduce of {b, step, w} over a len(per_rank) mesh, at
    the HVDT_QUANT_BLOCK of the environment."""
    n = len(per_rank)

    def body(b, w):
        out = jdev.fused_allreduce(
            {"b": b[0], "step": jnp.arange(5, dtype=jnp.int32), "w": w[0]},
            "dp", op, wire_dtype=wire_dtype)
        return out["b"], out["step"], out["w"]

    out = jax.jit(shard_map(body, mesh=_mesh(n), in_specs=(P("dp"), P("dp")),
                            out_specs=(P(), P(), P())))(
        jnp.asarray(np.stack([r["b"] for r in per_rank])),
        jnp.asarray(np.stack([r["w"] for r in per_rank])))
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("comp", ["int8", "int4"])
def test_fused_allreduce_quantized_wire(world1, comp, monkeypatch):
    """Float buckets ride the quantized allreduce, the int32 bucket the
    exact path; the same bucket plan as the JAX package's."""
    monkeypatch.setenv("HVDT_QUANT_BLOCK", "128")
    leaves = _fused_leaves(13, comp)
    want = _jax_fused([leaves], getattr(jcomp.Compression, comp).wire_dtype,
                      JReduceOp.AVERAGE)
    tleaves = [torch.from_numpy(leaves[k]) for k in ("b", "step", "w")]
    got = tdev.fused_allreduce(
        tleaves, wire_dtype=getattr(hvd.Compression, comp).wire_dtype)
    for g, w, k in zip(got, want, ("b", "step", "w")):
        _assert_same(g, w, k)
    assert not np.array_equal(got[2].numpy(), leaves["w"])   # quantized
    out = hvd.allreduce_gradients(
        tleaves, compression=getattr(hvd.Compression, comp))
    for g, w, k in zip(out, want, ("b", "step", "w")):
        _assert_same(g, w, k)


# ---- (g) error feedback -----------------------------------------------------

_EF_SHAPES = {"b": (300,), "w": (33, 9)}


def _ef_grads(step):
    rng = np.random.default_rng(200 + step)
    return {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
            for k, s in _EF_SHAPES.items()}


def _port_ef(enabled, wire="int8", comp=None):
    rng = np.random.default_rng(20)
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              .requires_grad_() for k, s in _EF_SHAPES.items()}
    comp = comp or getattr(hvd.Compression, wire)
    opt = hvd.quant.with_error_feedback(
        hvd.DistributedOptimizer(
            tok.fused_sgd([params["b"], params["w"]], 0.25, momentum=0.5),
            compression=comp),
        block_size=128, enabled=enabled, wire=wire)
    return params, opt


@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_error_feedback_matches_jax(world1, wire, monkeypatch):
    """Three steps of with_error_feedback(DistributedOptimizer(fused_sgd,
    compression=int8|int4)) in both packages from the same numpy
    gradients.  The residuals depend only on the gradients: they are
    bit-identical to the reference's error feedback run op by op (around
    optax.identity, no collective), and to ``e - qdq(e)``; the jitted
    reference step contracts ``e - q·s`` into an FMA, so its residuals
    and the parameters agree to the optimizer test's tolerance."""
    monkeypatch.setenv("HVDT_QUANT_BLOCK", "128")
    params, opt = _port_ef(True, wire)
    qdq = (tqk.quantize_dequantize if wire == "int8"
           else tqk.quantize_dequantize_int4)

    rng = np.random.default_rng(20)
    jparams = {k: jnp.asarray(rng.standard_normal(s).astype(np.float32))
               for k, s in _EF_SHAPES.items()}
    tx = jquant.with_error_feedback(
        jopt.DistributedOptimizer(
            jax_fused_sgd(0.25, momentum=0.5),
            compression=getattr(jcomp.Compression, wire)),
        block_size=128, wire=wire)
    state = jquant.tile_residual(tx.init(jparams), 1)
    ef_only = jquant.with_error_feedback(optax.identity(), block_size=128,
                                         wire=wire)
    ef_state = ef_only.init(jparams)

    def body(p, sr, si, g):
        s = jquant.unstack_residual(jquant.ErrorFeedbackState(sr, si))
        u, s2 = tx.update(g, s, p)
        s2 = jquant.stack_residual(s2)
        return optax.apply_updates(p, u), s2.residual, s2.inner

    jstep = jax.jit(shard_map(
        body, mesh=_mesh(1), in_specs=(P(), P("dp"), P(), P()),
        out_specs=(P(), P("dp"), P())))

    for step in range(3):
        grads = _ef_grads(step)
        jgrads = {k: jnp.asarray(v) for k, v in grads.items()}
        before = {k: opt.residual[p].clone() for k, p in params.items()}
        for k, p in params.items():
            p.grad = torch.from_numpy(grads[k].copy())
        opt.step()
        jparams, sr, si = jstep(jparams, state.residual, state.inner, jgrads)
        state = jquant.ErrorFeedbackState(sr, si)
        _, ef_state = ef_only.update(jgrads, ef_state)
        for k, p in params.items():
            _assert_same(opt.residual[p], ef_state.residual[k],
                         f"residual {k}")
            e = torch.from_numpy(grads[k]) + before[k]
            _assert_same(opt.residual[p], e - qdq(e, 128), f"e-qdq {k}")
            np.testing.assert_allclose(opt.residual[p].numpy(),
                                       np.asarray(state.residual[k])[0],
                                       rtol=1e-6, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert _no_launches()


def test_error_feedback_disabled_and_state_dict(world1):
    params, off = _port_ef(False)
    params_on, on = _port_ef(True)
    assert ([r.shape for r in off.state_dict()["residual"]]
            == [r.shape for r in on.state_dict()["residual"]])
    grads = _ef_grads(0)
    for k, p in params.items():
        p.grad = torch.from_numpy(grads[k].copy())
    off.compensate()
    for k, p in params.items():
        _assert_same(p.grad, grads[k])
        assert not off.residual[p].any()
    for k, p in params_on.items():
        p.grad = torch.from_numpy(grads[k].copy())
    on.step()
    saved = on.state_dict()
    assert any(r.any() for r in saved["residual"])
    params2, fresh = _port_ef(True)
    fresh.load_state_dict(saved)
    for a, b in zip(fresh.state_dict()["residual"], saved["residual"]):
        _assert_same(a, b)
    assert (fresh.optimizer.state_dict()["state"].keys()
            == on.optimizer.state_dict()["state"].keys())
    with pytest.raises(ValueError, match="'int8' or 'int4'"):
        hvd.quant.with_error_feedback(off.optimizer, wire="fp8")


# ---- (h) compressor selection -----------------------------------------------


def test_compression_by_name_and_env(monkeypatch):
    for name in ("none", "fp16", "bf16", "int8", "int4", " INT8 ", ""):
        t = hvd.Compression.by_name(name)
        j = jcomp.Compression.by_name(name)
        assert t.__name__ == j.__name__ and t.wire_dtype.__class__ in (
            type(None), torch.dtype, str)
    with pytest.raises(ValueError, match="valid"):
        hvd.Compression.by_name("zstd")
    monkeypatch.setenv("HVDT_COMPRESSION", "int4")
    assert hvd.Compression.from_env() is hvd.Compression.int4
    monkeypatch.setenv("HVDT_QUANT", "1")       # the shorthand wins
    assert hvd.Compression.from_env() is hvd.Compression.int8
    assert hvd.Compression.int8.wire_dtype == jcomp.Compression.int8.wire_dtype
    assert hvd.Compression.int4.wire_dtype == jcomp.Compression.int4.wire_dtype


@pytest.mark.parametrize("comp", ["int8", "int4"])
def test_compressor_snaps_to_grid_like_jax(comp):
    """Bit-identical to the reference's compress of a JAX array (its
    quantize_dequantize); equal in value to its numpy host path, which
    keeps the sign of a code rounded to -0."""
    x = (np.random.default_rng(14).standard_normal((7, 73)) * 2
         ).astype(np.float32)
    jc = getattr(jcomp.Compression, comp)
    got, ctx = getattr(hvd.Compression, comp).compress(torch.from_numpy(x))
    _assert_same(got, jc.compress(jnp.asarray(x))[0])
    np.testing.assert_array_equal(got.numpy(), jc.compress(x)[0])
    assert getattr(hvd.Compression, comp).decompress(got, ctx) is got
    ints = torch.arange(3)
    assert getattr(hvd.Compression, comp).compress(ints)[0] is ints


def test_init_rejects_unknown_compression(monkeypatch):
    monkeypatch.setenv("HVDT_COMPRESSION", "zstd")
    with pytest.raises(ValueError, match="valid"):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()


def test_distributed_optimizer_resolves_env(world1, monkeypatch):
    p = torch.zeros(4, requires_grad=True)
    monkeypatch.setenv("HVDT_COMPRESSION", "int8")
    opt = hvd.DistributedOptimizer(tok.fused_sgd([p], 0.1))
    assert opt._compression is hvd.Compression.int8
    monkeypatch.setenv("HVDT_COMPRESSION", "int4")
    assert hvd.DistributedOptimizer(
        tok.fused_sgd([p], 0.1))._compression is hvd.Compression.int4
    explicit = hvd.DistributedOptimizer(tok.fused_sgd([p], 0.1),
                                        compression=hvd.Compression.bf16)
    assert explicit._compression is hvd.Compression.bf16
    monkeypatch.setenv("HVDT_COMPRESSION", "int8")
    x = torch.from_numpy(_vector(2, 256, 15))
    _assert_same(hvd.allreduce_gradients([x])[0],
                 tdev.fused_allreduce([x], wire_dtype=tqc.INT8_WIRE)[0])
    assert not torch.equal(hvd.allreduce_gradients([x])[0], x)
    monkeypatch.setenv("HVDT_COMPRESSION", "bogus")
    with pytest.raises(ValueError, match="valid"):
        hvd.DistributedOptimizer(tok.fused_sgd([p], 0.1))


# ---- (d)/(e)/(f)/(i) a two-process gloo world --------------------------------

_WORKER = r"""
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import device as dev
from horovod_tpu_torch.quant import collectives as qc

data = np.load(sys.argv[1])
hvd.init(device="cpu")
r = hvd.rank()
T = lambda k: torch.from_numpy(data[k][r].copy())
res = {}
ops = {"sum": hvd.Sum, "avg": hvd.Average}
for wire, block in (("int8", 128), ("int4", 256)):
    x = T("x_" + wire)
    for op, pre, post in (("sum", 1.0, 1.0), ("avg", 0.5, 2.0)):
        res[f"ar.{wire}.{op}"] = qc.quantized_allreduce_flat(
            x, ops[op], block_size=block, prescale_factor=pre,
            postscale_factor=post, wire=wire).numpy()
    inflight = qc.quantized_reduce_scatter_start(x, block_size=block,
                                                 wire=wire)
    res["rs." + wire] = qc.quantized_reduce_scatter_finish(inflight).numpy()
    leaves = [T("fb_" + wire), torch.arange(5, dtype=torch.int32),
              T("fw_" + wire)]
    comp = getattr(hvd.Compression, wire)
    for k, v in zip(("b", "step", "w"),
                    dev.fused_allreduce(leaves, wire_dtype=comp.wire_dtype)):
        res[f"fused.{wire}.{k}"] = v.numpy()

c = T("c")                                   # [4, 6]
res["ag0"] = dev.allgather(c).numpy()
res["ag1"] = dev.allgather(c, 1).numpy()
res["ag_stack1"] = dev.allgather(c, 1, tiled=False).numpy()
res["rs_sum0"] = dev.reduce_scatter(c).numpy()
res["rs_avg1"] = dev.reduce_scatter(c, 1, op=hvd.Average).numpy()
res["rs_max0"] = dev.reduce_scatter(c, 0, op=hvd.Max).numpy()
res["a2a_00"] = dev.alltoall(c).numpy()
res["a2a_01"] = dev.alltoall(c, 0, 1).numpy()
res["a2a_10"] = dev.alltoall(c, 1, 0).numpy()
res["eager"] = qc.eager_quantized_allreduce(T("e"), block_size=128).numpy()

# The 200-step MLP: int8 wire + error feedback against the f32 wire.
xd, yd = T("mlp_x"), T("mlp_y")
for name, comp, ef in (("f32", hvd.Compression.none, False),
                       ("int8", hvd.Compression.int8, True)):
    p = {k: torch.from_numpy(data["mlp_" + k].copy()).requires_grad_()
         for k in ("w1", "b1", "w2", "b2")}
    opt = hvd.quant.with_error_feedback(
        hvd.DistributedOptimizer(torch.optim.SGD(list(p.values()), lr=0.05),
                                 compression=comp),
        block_size=128, enabled=ef)
    for _ in range(200):
        opt.zero_grad()
        h = torch.tanh(xd @ p["w1"] + p["b1"])
        loss = ((h @ p["w2"] + p["b2"] - yd) ** 2).mean()
        loss.backward()
        opt.step()
    with torch.no_grad():
        xa, ya = torch.from_numpy(data["mlp_x"].reshape(-1, 16)), \
            torch.from_numpy(data["mlp_y"].reshape(-1, 1))
        h = torch.tanh(xa @ p["w1"] + p["b1"])
        res["mlp." + name] = np.float64(
            ((h @ p["w2"] + p["b2"] - ya) ** 2).mean())
np.savez(sys.argv[2], **res)
hvd.shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_proc(tmp_path_factory):
    """Inputs (rank-stacked numpy) and each rank's results of _WORKER."""
    tmp = tmp_path_factory.mktemp("quant2")
    rng = np.random.default_rng(30)
    data = {
        "x_int8": np.stack([_pinned(3990, 128, 127, 31 + r)
                            for r in range(2)]),
        "x_int4": np.stack([_pinned(7990, 256, 7, 33 + r)
                            for r in range(2)]),
        "c": rng.integers(-50, 50, (2, 4, 6)).astype(np.float32),
        "e": (rng.standard_normal((2, 300)) * 3).astype(np.float32),
    }
    xd = rng.standard_normal((64, 16)).astype(np.float32)
    wt = rng.standard_normal((16, 1)).astype(np.float32)
    yd = (xd @ wt + 0.1 * rng.standard_normal((64, 1))).astype(np.float32)
    data.update(mlp_x=xd.reshape(2, 32, 16), mlp_y=yd.reshape(2, 32, 1),
                mlp_w1=(rng.standard_normal((16, 32)) * 0.3).astype(
                    np.float32),
                mlp_b1=np.zeros(32, np.float32),
                mlp_w2=(rng.standard_normal((32, 1)) * 0.3).astype(
                    np.float32),
                mlp_b2=np.zeros(1, np.float32))
    for wire in ("int8", "int4"):
        for k in ("b", "w"):
            data[f"f{k}_{wire}"] = np.stack(
                [_fused_leaves(35 + r, wire)[k] for r in range(2)])
    data = {k: np.ascontiguousarray(v) for k, v in data.items()}
    np.savez(tmp / "in.npz", **data)
    env = dict(os.environ, HVDT_SIZE="2",
               HVDT_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for k in ("HVDT_QUANT_KERNELS", "HVDT_COMPRESSION", "HVDT_QUANT",
              "HVDT_QUANT_BLOCK", "HVDT_FUSION_THRESHOLD"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(tmp / "in.npz"),
         str(tmp / f"out{r}.npz")], env=dict(env, HVDT_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out.decode()[-3000:]
    return data, [dict(np.load(tmp / f"out{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("route", ["pallas", "xla"])
@pytest.mark.parametrize("op,pre,post", _CASES)
@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_quantized_allreduce_two_processes(two_proc, wire, op, pre, post,
                                           route, monkeypatch):
    data, res = two_proc
    x = data["x_" + wire]
    want = _jax_quantized([x[0], x[1]], wire, _OPS[op][1], pre, post, route,
                          monkeypatch)
    for r in range(2):
        _assert_same(res[r][f"ar.{wire}.{op}"], want, f"rank {r}")


@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_quantized_reduce_scatter_two_processes(two_proc, wire):
    data, res = two_proc
    block = _WIRES[wire][0]
    x = data["x_" + wire]

    def body(xl):
        return jqc.quantized_reduce_scatter_finish(
            jqc.quantized_reduce_scatter_start(xl[0], "dp", block_size=block,
                                               wire=wire))

    want = np.asarray(jax.jit(shard_map(
        body, mesh=_mesh(2), in_specs=(P("dp"),),
        out_specs=P("dp")))(jnp.asarray(x)))
    shard = want.size // 2
    for r in range(2):
        _assert_same(res[r]["rs." + wire], want[r * shard:(r + 1) * shard],
                     f"rank {r}")


@pytest.mark.parametrize("comp", ["int8", "int4"])
def test_fused_allreduce_two_processes(two_proc, comp, monkeypatch):
    data, res = two_proc
    per_rank = [{"b": data["fb_" + comp][r], "w": data["fw_" + comp][r]}
                for r in range(2)]
    monkeypatch.delenv("HVDT_QUANT_BLOCK", raising=False)   # 256
    want = _jax_fused(per_rank, getattr(jcomp.Compression, comp).wire_dtype,
                      JReduceOp.AVERAGE)
    for r in range(2):
        for k, w in zip(("b", "step", "w"), want):
            _assert_same(res[r][f"fused.{comp}.{k}"], w, f"rank {r} {k}")


def _jax_collective(fn, c):
    return np.asarray(jax.jit(shard_map(
        lambda t: fn(t[0]), mesh=_mesh(2), in_specs=(P("dp"),),
        out_specs=P("dp")))(jnp.asarray(c)))


@pytest.mark.parametrize("key,fn,per_rank", [
    ("ag0", lambda t: jdev.allgather(t, "dp")[None], False),
    ("ag1", lambda t: jdev.allgather(t, "dp", 1)[None], False),
    ("ag_stack1", lambda t: jdev.allgather(t, "dp", 1, tiled=False)[None],
     False),
    ("rs_sum0", lambda t: jdev.reduce_scatter(t, "dp")[None], True),
    ("rs_avg1", lambda t: jdev.reduce_scatter(
        t, "dp", 1, JReduceOp.AVERAGE)[None], True),
    ("rs_max0", lambda t: jdev.reduce_scatter(
        t, "dp", 0, JReduceOp.MAX)[None], True),
    ("a2a_00", lambda t: jdev.alltoall(t, "dp")[None], True),
    ("a2a_01", lambda t: jdev.alltoall(t, "dp", 0, 1)[None], True),
    ("a2a_10", lambda t: jdev.alltoall(t, "dp", 1, 0)[None], True),
])
def test_tensor_collectives_two_processes(two_proc, key, fn, per_rank):
    """allgather / reduce_scatter / alltoall against the JAX package's
    on a 2-device mesh (each rank's result stacked on a leading axis)."""
    data, res = two_proc
    want = _jax_collective(fn, data["c"])
    for r in range(2):
        _assert_same(res[r][key], want[r] if per_rank else want[0],
                     f"{key} rank {r}")
    if not per_rank:
        _assert_same(want[1], want[0])


def test_eager_quantized_allreduce_two_processes(two_proc):
    """The all-gather form: each rank's int8 wire bytes, dequantized and
    summed in rank order, then divided by n, as the reference's eager
    path does on its numpy copy."""
    data, res = two_proc
    e = data["e"]
    acc = np.zeros(384, np.float32)
    for r in range(2):
        acc += np.asarray(jqk.quantize_dequantize(
            jnp.asarray(np.concatenate([e[r], np.zeros(84, np.float32)])),
            128, use_kernels=False))
    acc /= 2
    for r in range(2):
        _assert_same(res[r]["eager"], acc[:300], f"rank {r}")


def test_mlp_200_steps_int8_within_5pct_of_f32(two_proc):
    _, res = two_proc
    for r in range(2):
        f32, int8 = float(res[r]["mlp.f32"]), float(res[r]["mlp.int8"])
        assert np.isfinite(int8) and int8 <= f32 * 1.05 + 1e-8, (int8, f32)
    assert float(res[0]["mlp.int8"]) == float(res[1]["mlp.int8"])
