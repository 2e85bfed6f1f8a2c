"""PyTorch port, SyncBatchNorm (horovod_tpu_torch/sync_batch_norm.py,
``conv1x1_bn_train(axis=...)`` in ops/conv_fused.py, ``ResNetConfig.
bn_axis`` in models/resnet.py) held against the JAX package's
sync_batch_norm.py, ops/conv_fused.py and models/resnet.py on the same
numpy inputs.

* A 2-process and a 4-process gloo world run the port; the reference
  runs under ``jax.shard_map`` over 2 and 4 CPU devices with a ``dp``
  axis (its fused conv's Pallas kernel in interpret mode, the port's
  wrappers their plain versions).  Each world is started once per module
  and the cases are parametrised over what it returns.
* Gradient conventions: the reference differentiates the ``pmean`` of
  the per-rank losses, and ``shard_map`` sums a replicated parameter's
  cotangent over the axis; the port keeps each rank's local parameter
  gradients, and the test averages them over the ranks as
  ``DistributedOptimizer`` does (``allreduce_gradients``).  So the
  port's averaged parameter gradient is held against the reference's
  gradient of the ``pmean``'d loss, and each rank's input gradient
  divided by the world size against the reference's input gradient.
* Cases: the ``SyncBatchNorm`` module against flax's (output, running
  statistics, gradients of scale, bias and input); ``sync_batch_stats``
  (the between-rank term included); the fused conv's ``axis=`` form
  (y, mean, var, the gradients of x, w, gamma and beta); in the
  2-process world also ResNet-26 with ``bn_axis="dp"`` (the reference's
  ``test_sync_bn_across_dp``: synced running statistics equal the
  global batch's; loss, rank-averaged gradients and the new statistics
  against the reference, unfused with unfused and fused with fused) and
  a bottleneck whose fused synced path is held to the unfused synced
  one (the reference's ``test_sync_bn_fused_matches_unfused``).
* In-process, a world of one: ``axis="dp"`` equals ``axis=None`` and
  ``bn_axis="dp"`` equals ``bn_axis=None`` bit for bit.

Tolerances (f32): module, statistics and conv outputs rtol 1e-4 / atol
1e-5 (the reductions are summed in another order on each side),
gradients rtol 2e-3 / atol 1e-5 (the batch-stat BN backward amplifies
those ulps; tests/test_models.py holds the fused path to the same);
ResNet-26: loss rtol 1e-5, statistics rtol 1e-4 / atol 1e-4, gradients
as relative L2 errors, 3e-2 per tensor and 1.5e-2 over all of them
(tests/test_torch_port_resnet.py explains the f32 conditioning of the
early layers).  Fused against unfused (port only): loss rtol 1e-5,
statistics rtol 1e-5 / atol 1e-6, gradients rtol 2e-3 / atol 1e-5, as
the reference's test.
"""

import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from horovod_tpu.models import resnet as jrn
from horovod_tpu.ops import conv_fused as jcf
from horovod_tpu.sync_batch_norm import SyncBatchNorm as JaxSyncBatchNorm
from horovod_tpu.sync_batch_norm import sync_batch_stats as jax_stats
from horovod_tpu_torch import sync_batch_norm as tsbn
from horovod_tpu_torch.convert import _param_tensors, resnet_params_from_jax
from horovod_tpu_torch.models import resnet as trn
from horovod_tpu_torch.ops import conv_fused as tcf

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=2e-3, atol=1e-5)
_C = 16                       # SyncBatchNorm features
_RN_BATCH, _RN_SIZE = 8, 32   # ResNet-26 global batch, image size


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inputs(n):
    rng = np.random.default_rng(n)
    f = np.float32
    inp = {
        "sbn.x": rng.standard_normal((4 * n, 3, 3, _C)).astype(f) * 2 + 1,
        "sbn.w": rng.standard_normal((4 * n, 3, 3, _C)).astype(f),
        "sbn.scale": (1 + 0.1 * rng.standard_normal(_C)).astype(f),
        "sbn.bias": (0.1 * rng.standard_normal(_C)).astype(f),
        "sbn.mean": (0.1 * rng.standard_normal(_C)).astype(f),
        "sbn.var": (1 + 0.1 * rng.random(_C)).astype(f),
        # Rank r's rows are shifted by 4r: the between-rank term counts.
        "stats.x": (rng.standard_normal((8 * n, 12))
                    + 4 * np.repeat(np.arange(n), 8)[:, None]).astype(f),
        "stats.w": rng.standard_normal((8 * n, 12)).astype(f),
        "conv.x": rng.standard_normal((2 * n, 8, 8, 128)).astype(f),
        "conv.w": (rng.standard_normal((128, 256)) / np.sqrt(128)
                   ).astype(f),
        "conv.gamma": (1 + 0.1 * rng.standard_normal(256)).astype(f),
        "conv.beta": (0.1 * rng.standard_normal(256)).astype(f),
        "conv.r": rng.standard_normal((2 * n, 8, 8, 256)).astype(f),
    }
    return inp


# ---- the port's side: one gloo world per size ------------------------------

_WORKER = r"""
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import sync_batch_norm as sbn
from horovod_tpu_torch.convert import resnet_params_from_jax
from horovod_tpu_torch.models import resnet as trn
from horovod_tpu_torch.ops import conv_fused as cf

data = dict(np.load(sys.argv[1], allow_pickle=True))
hvd.init(device="cpu")
n, r = hvd.size(), hvd.rank()
res = {}


def shard(key):
    a = data[key]
    k = a.shape[0] // n
    return torch.from_numpy(np.ascontiguousarray(a[r * k:(r + 1) * k]))


def mean_over_ranks(ts):
    return hvd.allreduce_gradients([t.detach().clone() for t in ts])


def put(prefix, **ts):
    for k, v in ts.items():
        res[prefix + k] = v.detach().numpy()


# SyncBatchNorm module: ((y * w) ** 2).sum() on each rank.
bn = sbn.SyncBatchNorm(data["sbn.scale"].shape[0], device="cpu")
with torch.no_grad():
    for k in ("scale", "bias", "mean", "var"):
        getattr(bn, k).copy_(torch.from_numpy(data["sbn." + k]))
x = shard("sbn.x").requires_grad_()
y = bn(x)
((y * shard("sbn.w")) ** 2).sum().backward()
dscale, dbias = mean_over_ranks([bn.scale.grad, bn.bias.grad])
put("sbn.", y=y, dx=x.grad / n, dscale=dscale, dbias=dbias, mean=bn.mean,
    var=bn.var)

# sync_batch_stats over a [rows, 12] shard.
x = shard("stats.x").requires_grad_()
mean, var = sbn.sync_batch_stats(x)
((mean * 2 + var) * shard("stats.w").sum(0)).sum().backward()
put("stats.", mean=mean, var=var, dx=x.grad / n)

# The fused conv's axis= form (the kernel's plain version on the CPU).
x = shard("conv.x").requires_grad_()
w, gamma, beta = (torch.from_numpy(data["conv." + k]).requires_grad_()
                  for k in ("w", "gamma", "beta"))
y, mean, var = cf.conv1x1_bn_train(x, w, gamma, beta, axis="dp")
((y * shard("conv.r")).sum() + (mean * 0.3).sum()
 + (var * 0.2).sum()).backward()
dw, dgamma, dbeta = mean_over_ranks([w.grad, gamma.grad, beta.grad])
put("conv.", y=y, mean=mean, var=var, dx=x.grad / n, dw=dw, dgamma=dgamma,
    dbeta=dbeta)
assert cf.matmul_batch_stats.launches == 0

if "rn.x" in data:
    import os
    # ResNet-26 with bn_axis="dp", unfused then fused: loss, the
    # rank-averaged gradients (DistributedOptimizer.synchronize) and the
    # new running statistics.
    for fused in ("0", "1"):
        os.environ["HVDT_FUSED_CONV1X1"] = fused
        cfg = trn.ResNetConfig(num_classes=10, dtype=torch.float32,
                               depth=26, bn_axis="dp")
        model = trn.resnet50_init(0, cfg, device="cpu")
        model.load_state_dict(resnet_params_from_jax(
            data["rn.params"].item(), data["rn.stats"].item()))
        opt = hvd.DistributedOptimizer(
            hvd.fused_sgd(model.parameters(), 0.01, momentum=0.9))
        loss, stats = trn.resnet_loss(model, shard("rn.x"), shard("rn.y"))
        loss.backward()
        opt.synchronize()
        p = f"rn{fused}."
        res[p + "loss"] = hvd.allreduce_gradients([loss.detach()])[0].numpy()
        for k, t in model.named_parameters():
            res[p + "g." + k] = t.grad.numpy()
        for k, t in model.named_buffers():
            res[p + "s." + k] = t.numpy()

    # One bottleneck, fused synced against unfused synced.
    cfg = trn.ResNetConfig(num_classes=10, dtype=torch.float32,
                           bn_axis="dp")
    for fused in ("0", "1"):
        os.environ["HVDT_FUSED_CONV1X1"] = fused
        block = trn._Bottleneck(128, 128, True, torch.Generator().manual_seed(0),
                                cfg)
        x = shard("bneck.x")
        y = block(x.permute(0, 3, 1, 2), cfg, 1)
        loss = (y.float() ** 2).mean()
        loss.backward()
        grads = mean_over_ranks([t.grad for _, t in block.named_parameters()])
        p = f"bneck{fused}."
        res[p + "loss"] = hvd.allreduce_gradients([loss.detach()])[0].numpy()
        for (k, _), g in zip(block.named_parameters(), grads):
            res[p + "g." + k] = g.numpy()
        for k, t in block.named_buffers():
            res[p + "s." + k] = t.numpy()
    assert cf.matmul_batch_stats.launches == 0

np.savez(sys.argv[2], **res)
hvd.shutdown()
"""


def _run_world(n, tmp, inputs):
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, HVDT_SIZE=str(n),
               HVDT_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("HVDT_FUSED_CONV1X1", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(tmp / "in.npz"),
         str(tmp / f"out{r}.npz")],
        env=dict(env, HVDT_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(n)]
    return procs


def _collect(procs, tmp):
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out.decode()[-3000:]
    return [dict(np.load(tmp / f"out{r}.npz")) for r in range(len(procs))]


# ---- the reference's side ---------------------------------------------------


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n], dtype=object), ("dp",))


def _jax_sbn(inp, n):
    mod = JaxSyncBatchNorm(use_running_average=False, momentum=0.99,
                           epsilon=1e-5)
    params = {"scale": jnp.asarray(inp["sbn.scale"]),
              "bias": jnp.asarray(inp["sbn.bias"])}
    stats = {"mean": jnp.asarray(inp["sbn.mean"]),
             "var": jnp.asarray(inp["sbn.var"])}

    def local(params, x, w):
        y, upd = mod.apply({"params": params, "batch_stats": stats}, x,
                           mutable=["batch_stats"])
        return (lax.pmean(((y * w) ** 2).sum(), "dp"),
                (y, upd["batch_stats"]))

    def total(params, x, w):
        return jax.shard_map(local, mesh=_mesh(n),
                             in_specs=(P(), P("dp"), P("dp")),
                             out_specs=(P(), (P("dp"), P())))(params, x, w)

    (_, (y, new)), (g, dx) = jax.jit(jax.value_and_grad(
        total, argnums=(0, 1), has_aux=True))(
            params, jnp.asarray(inp["sbn.x"]), jnp.asarray(inp["sbn.w"]))
    return {"y": y, "dx": dx, "dscale": g["scale"], "dbias": g["bias"],
            "mean": new["mean"], "var": new["var"]}


def _jax_stats(inp, n):
    def local(x, w):
        mean, var = jax_stats(x, "dp")
        loss = ((mean * 2 + var) * w.sum(0)).sum()
        return lax.psum(loss, "dp") / n, (mean, var)

    def total(x, w):
        # Each rank's w.sum(0) differs: the loss is their mean.
        return jax.shard_map(local, mesh=_mesh(n),
                             in_specs=(P("dp"), P("dp")),
                             out_specs=(P(), (P(), P())))(x, w)

    (_, (mean, var)), dx = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jnp.asarray(inp["stats.x"]), jnp.asarray(inp["stats.w"]))
    return {"mean": mean, "var": var, "dx": dx}


def _jax_conv(inp, n):
    def local(x, w, gamma, beta, r):
        y, mean, var = jcf.conv1x1_bn_train(x, w, gamma, beta, axis="dp")
        loss = (y * r).sum() + (mean * 0.3).sum() + (var * 0.2).sum()
        return lax.pmean(loss, "dp"), (y, mean, var)

    def total(x, w, gamma, beta, r):
        return jax.shard_map(local, mesh=_mesh(n),
                             in_specs=(P("dp"), P(), P(), P(), P("dp")),
                             out_specs=(P(), (P("dp"), P(), P())),
                             check_vma=False)(x, w, gamma, beta, r)

    args = [jnp.asarray(inp["conv." + k])
            for k in ("x", "w", "gamma", "beta", "r")]
    (_, (y, mean, var)), grads = jax.jit(jax.value_and_grad(
        total, argnums=(0, 1, 2, 3), has_aux=True))(*args)
    out = {"y": y, "mean": mean, "var": var}
    out.update(zip(("dx", "dw", "dgamma", "dbeta"), grads))
    return out


def _numpy_init(cfg, seed=0):
    """The JAX package's ResNet (params, batch_stats), filled from numpy
    as its init fills them (tests/test_torch_port_resnet.py)."""
    shapes = jax.eval_shape(lambda k: jrn.resnet50_init(k, cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = jax.tree_util.keystr(path), leaf.shape
        if len(shape) == 4:
            scale = np.sqrt(2.0 / np.prod(shape[:3]))
        elif name.endswith("['fc_w']"):
            scale = shape[0] ** -0.5
        else:
            one = name.endswith(("['scale']", "['var']"))
            return np.full(shape, float(one), np.float32)
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return tuple(jax.tree.map(np.asarray,
                              jax.tree_util.tree_map_with_path(fill, tree))
                 for tree in shapes)


def _jax_resnet(params, stats, x, y, fused: bool):
    cfg = jrn.ResNetConfig(num_classes=10, dtype=jnp.float32, depth=26,
                           bn_axis="dp")

    def local(p, s, xx, yy):
        loss, new = jrn.resnet_loss(p, s, xx, yy, cfg)
        return lax.pmean(loss, "dp"), new

    def total(p, s, xx, yy):
        return jax.shard_map(local, mesh=_mesh(2),
                             in_specs=(P(), P(), P("dp"), P("dp")),
                             out_specs=(P(), P()),
                             check_vma=not fused)(p, s, xx, yy)

    with pytest.MonkeyPatch.context() as mp:
        if fused:
            mp.setenv("HVDT_FUSED_CONV1X1", "1")
        else:
            mp.delenv("HVDT_FUSED_CONV1X1", raising=False)
        (loss, new), g = jax.jit(jax.value_and_grad(total, has_aux=True))(
            params, stats, jnp.asarray(x), jnp.asarray(y))
    return float(loss), jax.tree.map(np.asarray, g), jax.tree.map(
        np.asarray, new)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' per-rank results and the reference's."""
    started = {}
    inputs = {}
    for n in (2, 4):
        inp = _inputs(n)
        if n == 2:
            cfg = jrn.ResNetConfig(num_classes=10, dtype=jnp.float32,
                                   depth=26)
            params, stats = _numpy_init(cfg)
            rng = np.random.default_rng(7)
            inp["rn.x"] = rng.standard_normal(
                (_RN_BATCH, _RN_SIZE, _RN_SIZE, 3)).astype(np.float32)
            inp["rn.y"] = rng.integers(0, 10, _RN_BATCH).astype(np.int64)
            inp["rn.params"] = np.array(params, dtype=object)
            inp["rn.stats"] = np.array(stats, dtype=object)
            inp["bneck.x"] = rng.standard_normal((4, 8, 8, 128)).astype(
                np.float32)
        inputs[n] = inp
        tmp = tmp_path_factory.mktemp(f"world{n}")
        started[n] = (_run_world(n, tmp, inp), tmp)
    want = {}
    for n, inp in inputs.items():
        want[n] = {"sbn": _jax_sbn(inp, n), "stats": _jax_stats(inp, n),
                   "conv": _jax_conv(inp, n)}
    inp = inputs[2]
    params, stats = inp["rn.params"].item(), inp["rn.stats"].item()
    g_global = _jax_global_stats(params, stats, inp["rn.x"])
    for fused in (False, True):
        want[2][f"rn{int(fused)}"] = _jax_resnet(params, stats, inp["rn.x"],
                                                 inp["rn.y"], fused)
    got = {n: _collect(*started[n]) for n in started}
    return got, want, g_global


def _jax_global_stats(params, stats, x):
    """The unsynced reference over the whole batch: the statistics the
    synced run must reproduce."""
    cfg = jrn.ResNetConfig(num_classes=10, dtype=jnp.float32, depth=26)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("HVDT_FUSED_CONV1X1", raising=False)
        _, new = jax.jit(jrn.resnet_apply, static_argnums=(3, 4))(
            params, stats, jnp.asarray(x), cfg, True)
    return jax.tree.map(np.asarray, new)


def _cat(res, key):
    return np.concatenate([r[key] for r in res], axis=0)


@pytest.mark.parametrize("n", [2, 4])
def test_sync_batch_norm_module_matches_flax(worlds, n):
    got, want, _ = worlds
    res, w = got[n], want[n]["sbn"]
    np.testing.assert_allclose(_cat(res, "sbn.y"), w["y"], **OUT)
    np.testing.assert_allclose(_cat(res, "sbn.dx"), w["dx"], **GRAD)
    for r in res:
        for k in ("mean", "var"):
            np.testing.assert_allclose(r["sbn." + k], w[k], **OUT,
                                       err_msg=k)
        for k in ("dscale", "dbias"):
            np.testing.assert_allclose(r["sbn." + k], w[k], **GRAD,
                                       err_msg=k)


@pytest.mark.parametrize("n", [2, 4])
def test_sync_batch_stats_matches_reference(worlds, n):
    got, want, _ = worlds
    res, w = got[n], want[n]["stats"]
    for r in res:
        np.testing.assert_allclose(r["stats.mean"], w["mean"], **OUT)
        np.testing.assert_allclose(r["stats.var"], w["var"], **OUT)
    np.testing.assert_allclose(_cat(res, "stats.dx"), w["dx"], **GRAD)
    # The between-rank term: the rank means differ by 4, so the global
    # variance exceeds the mean of the per-rank variances.
    x = _inputs(n)["stats.x"]
    per_rank = np.mean([np.var(s, 0) for s in np.split(x, n)], 0)
    np.testing.assert_allclose(res[0]["stats.var"], np.var(x, 0), **OUT)
    assert (res[0]["stats.var"] > per_rank + 1.0).all()


@pytest.mark.parametrize("n", [2, 4])
def test_fused_conv_axis_matches_reference(worlds, n):
    got, want, _ = worlds
    res, w = got[n], want[n]["conv"]
    np.testing.assert_allclose(_cat(res, "conv.y"), w["y"], **OUT)
    np.testing.assert_allclose(_cat(res, "conv.dx"), w["dx"], **GRAD)
    for r in res:
        for k in ("mean", "var"):
            np.testing.assert_allclose(r["conv." + k], w[k], **OUT,
                                       err_msg=k)
        for k in ("dw", "dgamma", "dbeta"):
            np.testing.assert_allclose(r["conv." + k], w[k], **GRAD,
                                       err_msg=k)


def _assert_rel(got: dict, want: dict):
    """Relative L2 errors: 3e-2 per tensor, 1.5e-2 over all of them."""
    assert set(got) == set(want)
    diff = total = 0.0
    for name, w in want.items():
        w = np.asarray(w, np.float64)
        d = np.linalg.norm(np.asarray(got[name], np.float64) - w)
        assert d <= 3e-2 * np.linalg.norm(w) + 1e-12, (name, d)
        diff += d * d
        total += float(np.sum(w * w))
    assert np.sqrt(diff) <= 1.5e-2 * np.sqrt(total), np.sqrt(diff / total)


def _flat_stats(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        out[".".join(p.key for p in path)] = np.asarray(leaf)
    return out


def test_resnet_synced_stats_equal_global_batch(worlds):
    """The reference's test_sync_bn_across_dp: depth 26, f32, dp 2; the
    synced running statistics are those of the global batch."""
    got, _, g_global = worlds
    for r in got[2]:
        for k, v in _flat_stats(g_global).items():
            np.testing.assert_allclose(r["rn0.s." + k], v, rtol=1e-4,
                                       atol=1e-5, err_msg=k)


@pytest.mark.parametrize("fused", [False, True])
def test_resnet_sync_bn_matches_reference(worlds, fused):
    got, want, _ = worlds
    loss, grads, stats = want[2][f"rn{int(fused)}"]
    p = f"rn{int(fused)}."
    want_g = {k: t.numpy() for k, t in _param_tensors(grads).items()}
    for r in got[2]:
        np.testing.assert_allclose(float(r[p + "loss"]), loss, rtol=1e-5)
        _assert_rel({k: r[p + "g." + k] for k in want_g}, want_g)
        for k, v in _flat_stats(stats).items():
            np.testing.assert_allclose(r[p + "s." + k], v, rtol=1e-4,
                                       atol=1e-4, err_msg=k)
    # Every rank holds the same averaged gradients and statistics.
    for k in got[2][0]:
        if k.startswith(p):
            np.testing.assert_array_equal(got[2][0][k], got[2][1][k])


def test_bottleneck_fused_sync_matches_unfused_sync(worlds):
    got, _, _ = worlds
    for r in got[2]:
        np.testing.assert_allclose(float(r["bneck1.loss"]),
                                   float(r["bneck0.loss"]), rtol=1e-5)
        for k in r:
            if k.startswith("bneck0.s."):
                np.testing.assert_allclose(r["bneck1" + k[6:]], r[k],
                                           rtol=1e-5, atol=1e-6, err_msg=k)
            elif k.startswith("bneck0.g."):
                np.testing.assert_allclose(r["bneck1" + k[6:]], r[k],
                                           **GRAD, err_msg=k)


# ---- a world of one: synced equals unsynced, bit for bit --------------------


@pytest.fixture
def world1():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.detach().view(torch.int32),
                       b.detach().view(torch.int32))


def test_world_of_one_resnet_bn_axis_is_bit_identical(world1, monkeypatch):
    """``bn_axis="dp"`` in a world of one gives ``bn_axis=None``'s bytes:
    loss, gradients and running statistics, unfused and fused."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 32, 32, 3)).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, 10, 4))
    for fused in ("0", "1"):
        monkeypatch.setenv("HVDT_FUSED_CONV1X1", fused)
        out = []
        for axis in (None, "dp"):
            cfg = trn.ResNetConfig(num_classes=10, dtype=torch.float32,
                                   depth=26, bn_axis=axis)
            model = trn.resnet50_init(0, cfg, device="cpu")
            loss, _ = trn.resnet_loss(model, x, y)
            loss.backward()
            out.append([loss] + [p.grad for p in model.parameters()]
                       + list(model.buffers()))
        assert all(_bits_equal(a, b) for a, b in zip(*out)), fused


def test_sync_batch_stats_without_a_process_group():
    """No process group: a world of one, no collective."""
    x = torch.randn(6, 5)
    mean, var = tsbn.sync_batch_stats(x)
    assert torch.equal(mean, x.mean(0))
    assert torch.equal(var, (x * x).mean(0) - x.mean(0) ** 2)
    assert tsbn.resolve_group(None) == (None, 1)


def test_resnet_bn_group_from_mesh(world1):
    """``bn_group`` takes a mesh's ``bn_axis`` dimension."""
    from horovod_tpu_torch.parallel import make_mesh

    mesh = make_mesh(dp=1)
    group, size = tsbn.resolve_group(mesh, "dp")
    assert size == 1 and group is not None
    cfg = trn.ResNetConfig(num_classes=10, dtype=torch.float32, depth=26,
                           bn_axis="dp")
    model = trn.resnet50_init(0, cfg, device="cpu", bn_group=mesh)
    x = torch.randn(2, 32, 32, 3)
    logits, stats = trn.resnet_apply(model, x, True)
    assert torch.isfinite(logits).all() and model.bn_group is mesh


def test_convert_resnet_state_carries_to_synced_model():
    """SyncBN adds no parameters: the converter's state loads into a
    model with ``bn_axis``."""
    cfg = jrn.ResNetConfig(num_classes=10, dtype=jnp.float32, depth=26)
    params, stats = _numpy_init(cfg)
    model = trn.resnet50_init(0, trn.ResNetConfig(
        num_classes=10, dtype=torch.float32, depth=26, bn_axis="dp"),
        device="cpu")
    missing = model.load_state_dict(resnet_params_from_jax(params, stats))
    assert not missing.missing_keys and not missing.unexpected_keys
