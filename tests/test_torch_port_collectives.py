"""PyTorch port: process model, collectives, fused-bucket planning,
DistributedOptimizer over a 2-process gloo world, and import isolation.

* The bucket planner must give the JAX package's plan for the same
  (shape, dtype) list, invalid thresholds included.
* In a 2-process gloo world, broadcast_parameters makes rank 1 equal to
  rank 0, and DistributedOptimizer(fused_sgd) takes the step whose
  gradient is the mean of the JAX gradients on each rank's half-batch
  (BN is per rank, so that is not the global-batch step).  Tolerance,
  as relative L2 errors on the averaged gradients and on the updates:
  3e-2 per tensor and 1.5e-2 over all of them, as in
  tests/test_torch_port_resnet.py and for the same reason (the early
  layers' gradients are ill-conditioned in f32).
* broadcast_optimizer_state, in a 1- and a 2-process gloo world, gives
  every rank rank 0's moments and step count and leaves a learning-rate
  schedule local; the next step is the JAX fused_adam's (f32 tolerance
  of tests/test_torch_port_optim.py: rtol 1e-6, atol 1e-7).
* ``import horovod_tpu_torch`` loads nothing of JAX or horovod_tpu.
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

from horovod_tpu.models import resnet as jrn
from horovod_tpu.ops import device as jdev
from horovod_tpu.ops.optim_kernels import fused_adam as jax_fused_adam
from horovod_tpu.ops.optim_kernels import fused_sgd as jax_fused_sgd
import horovod_tpu_torch as hvd
from horovod_tpu_torch.convert import _param_tensors, resnet_params_from_jax
from horovod_tpu_torch.ops import device as tdev
from horovod_tpu_torch.ops import optim_kernels as tok
from test_torch_port_resnet import _assert_rel, _numpy_init

ROOT = pathlib.Path(__file__).resolve().parents[1]

# ---- (d) bucket planner ---------------------------------------------------

_NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
       "float16": np.float16, "int32": np.int32}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "int32": torch.int32}


def _leaf_lists(seed):
    rng = np.random.default_rng(seed)
    names = list(_NP)
    specs = [(tuple(int(d) for d in rng.integers(1, 40, rng.integers(1, 4))),
              names[rng.integers(len(names))]) for _ in range(30)]
    return ([np.zeros(s, _NP[d]) for s, d in specs],
            [torch.empty(s, dtype=_TORCH[d]) for s, d in specs])


@pytest.mark.parametrize("threshold", [64, 256, 1000, 4096, 1 << 20, None,
                                       0, -5, "garbage"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bucket_plan_matches_jax(seed, threshold, monkeypatch):
    monkeypatch.setenv("HVDT_FUSION_THRESHOLD", "512")
    jleaves, tleaves = _leaf_lists(seed)
    assert (tdev.fused_allreduce_buckets(tleaves, threshold)
            == jdev.fused_allreduce_buckets(jleaves, threshold))


def test_bucket_plan_ignores_dtype_interleaving():
    a = [torch.empty(10), torch.empty(3, dtype=torch.bfloat16),
         torch.empty(5)]
    b = [a[1], a[0], a[2]]
    plan_a = tdev.fused_allreduce_buckets(a, 1 << 20)
    plan_b = tdev.fused_allreduce_buckets(b, 1 << 20)
    assert plan_a == [[1], [0, 2]] and plan_b == [[0], [1, 2]]


def test_invalid_env_threshold_clamps_to_default(monkeypatch):
    monkeypatch.setenv("HVDT_FUSION_THRESHOLD", "-1")
    assert tdev._validated_threshold(None) == 64 * 1024 * 1024
    monkeypatch.setenv("HVDT_FUSION_THRESHOLD", "4096")
    assert tdev._validated_threshold(None) == 4096


# ---- one-process world ----------------------------------------------------


@pytest.fixture
def world1():
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def test_one_process_world(world1):
    assert (hvd.rank(), hvd.size(), hvd.local_rank(), hvd.local_size(),
            hvd.cross_rank(), hvd.cross_size()) == (0, 1, 0, 1, 0, 1)
    assert hvd.topology().device == torch.device("cpu")
    t = torch.arange(6, dtype=torch.float32)
    torch.testing.assert_close(
        tdev.allreduce(t, prescale_factor=2.0, postscale_factor=0.5), t)
    torch.testing.assert_close(tdev.allreduce(t, op=hvd.Sum), t)
    torch.testing.assert_close(tdev.broadcast(t, 0), t)
    grads = [torch.randn(5), torch.randn(3, 2, dtype=torch.bfloat16),
             torch.randn(7)]
    out = hvd.allreduce_gradients(grads, threshold_bytes=32,
                                  compression=hvd.Compression.bf16)
    for g, o in zip(grads, out):
        assert o.shape == g.shape and o.dtype == g.dtype
        torch.testing.assert_close(o, g.to(torch.bfloat16).to(g.dtype))
    assert hvd.broadcast_object({"a": 1}) == {"a": 1}


def test_unported_options_raise(world1):
    opt = tok.fused_sgd([torch.zeros(2, requires_grad=True)], 0.1)
    # ZeRO is ported (tests/test_torch_port_zero.py): it builds, and an
    # unknown stage raises with the valid list.
    assert type(hvd.DistributedOptimizer(
        opt, zero="states")).__name__ == "_ZeroStatesOptimizer"
    with pytest.raises(ValueError, match="valid: off, grads, states"):
        hvd.DistributedOptimizer(opt, zero="stats")
    # Adasum is ported (tests/test_torch_port_adasum.py): it builds.
    assert hvd.DistributedOptimizer(opt, op=hvd.Adasum)._op == hvd.Adasum
    # The int8/int4 wires are ported: they build.
    for comp in (hvd.Compression.int8, hvd.Compression.int4):
        assert hvd.DistributedOptimizer(
            opt, compression=comp)._compression is comp


def test_backward_passes_per_step_accumulates(world1):
    """k=2: the first step() issues no collective and leaves the
    parameter alone; the second applies the mean of both passes."""
    p = torch.zeros(3, requires_grad=True)
    opt = hvd.DistributedOptimizer(tok.fused_sgd([p], 1.0),
                                   backward_passes_per_step=2)
    for g in (torch.tensor([1.0, 2.0, 3.0]), torch.tensor([3.0, 2.0, 1.0])):
        opt.zero_grad()
        p.grad = g.clone()
        opt.step()
        if g[0] == 1.0:
            assert float(p.detach().abs().sum()) == 0.0
    torch.testing.assert_close(p.detach(), torch.full((3,), -2.0))


def test_init_without_card_or_cpu_request_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hvd.init()
    assert not hvd.is_initialized()


# ---- (e) two-process gloo world -------------------------------------------

_WORKER = r"""
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import resnet as trn

data = np.load(sys.argv[1])
out = sys.argv[2]
hvd.init(device="cpu")
r = hvd.rank()
cfg = trn.ResNetConfig(num_classes=10, dtype=torch.float32, depth=26)
model = trn.resnet50_init(1 + r, cfg, device="cpu")
if r == 0:
    model.load_state_dict({k[3:]: torch.from_numpy(data[k])
                           for k in data.files if k.startswith("sd.")})
hvd.broadcast_parameters(model.state_dict(), root_rank=0)
res = {"bcast." + k: v.numpy().copy() for k, v in model.state_dict().items()}

opt = hvd.DistributedOptimizer(
    hvd.fused_sgd(model.parameters(), float(data["lr"]), momentum=0.9),
    threshold_bytes=1 << 22)
hvd.broadcast_optimizer_state(opt, root_rank=0)
half = slice(2 * r, 2 * r + 2)
loss, _ = trn.resnet_loss(model, torch.from_numpy(data["x"][half]),
                          torch.from_numpy(data["y"][half]))
loss.backward()
opt.step()
for k, p in model.named_parameters():
    res["grad." + k] = p.grad.numpy().copy()
    res["param." + k] = p.detach().numpy().copy()

t = torch.full((3,), float(r + 1))
res["avg"] = hvd.device.allreduce(t).numpy()
res["sum"] = hvd.device.allreduce(t, op=hvd.Sum).numpy()
res["max"] = hvd.device.allreduce(t, op=hvd.Max).numpy()
res["bcast1"] = hvd.device.broadcast(t, root_rank=1).numpy()
res["obj"] = np.array(hvd.broadcast_object(r + 10, root_rank=1))
ps = hvd.add_process_set([0, 1])
res["ps_sum"] = hvd.device.allreduce(t, op=hvd.Sum, process_set=ps).numpy()
np.savez(out, **res)
hvd.shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_world(tmp_path, monkeypatch):
    monkeypatch.delenv("HVDT_FUSED_CONV1X1", raising=False)
    lr = 0.01
    cfg = jrn.ResNetConfig(num_classes=10, dtype=jnp.float32, depth=26)
    params, stats = _numpy_init(cfg)
    np_params = jax.tree.map(np.asarray, params)
    sd = resnet_params_from_jax(np_params, jax.tree.map(np.asarray, stats))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    y = rng.integers(0, 10, 4).astype(np.int32)
    np.savez(tmp_path / "in.npz", x=x, y=y, lr=np.float32(lr),
             **{"sd." + k: v.numpy() for k, v in sd.items()})

    env = dict(os.environ, HVDT_SIZE="2",
               HVDT_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(tmp_path / "in.npz"),
         str(tmp_path / f"out{r}.npz")], env=dict(env, HVDT_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]

    # Meanwhile, the JAX side: per-rank grads on each half-batch, their
    # mean, one fused_sgd step.
    grad_fn = jax.jit(jax.value_and_grad(jrn.resnet_loss, has_aux=True),
                      static_argnums=(4,))
    halves = [grad_fn(params, stats, jnp.asarray(x[2 * r:2 * r + 2]),
                      jnp.asarray(y[2 * r:2 * r + 2]), cfg)[1]
              for r in range(2)]
    mean_grads = jax.tree.map(lambda a, b: (a + b) / 2, *halves)
    tx = jax_fused_sgd(lr, momentum=0.9)
    updates, _ = tx.update(mean_grads, tx.init(params), params)
    new_params = optax.apply_updates(params, updates)

    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out.decode()[-3000:]
    res = [np.load(tmp_path / f"out{r}.npz") for r in range(2)]

    for k, v in sd.items():
        np.testing.assert_array_equal(res[1]["bcast." + k], v.numpy(),
                                      err_msg=k)
    want_g = _param_tensors(jax.tree.map(np.asarray, mean_grads))
    want_p = _param_tensors(jax.tree.map(np.asarray, new_params))
    init = _param_tensors(np_params)
    for r in range(2):
        _assert_rel({k: res[r]["grad." + k] for k in want_g},
                    {k: g.numpy() for k, g in want_g.items()})
        _assert_rel({k: res[r]["param." + k] - init[k].numpy()
                     for k in want_p},
                    {k: (p - init[k]).numpy() for k, p in want_p.items()})
    for k in want_p:
        np.testing.assert_array_equal(res[0]["param." + k],
                                      res[1]["param." + k], err_msg=k)
    for r in range(2):
        np.testing.assert_allclose(res[r]["avg"], [1.5] * 3)
        np.testing.assert_allclose(res[r]["sum"], [3.0] * 3)
        np.testing.assert_allclose(res[r]["max"], [2.0] * 3)
        np.testing.assert_allclose(res[r]["bcast1"], [2.0] * 3)
        assert int(res[r]["obj"]) == 11
        np.testing.assert_allclose(res[r]["ps_sum"], [3.0] * 3)


# ---- broadcast_optimizer_state with a schedule ---------------------------

_BCAST_SHAPE = (8, 128)


def _schedule(count):
    return 1e-2 * 0.5 ** count


def _bcast_np():
    """The param's init and four grads: steps 0-1 are rank 0's history,
    step 2 rank 1's own, step 3 the step both take after the call."""
    rng = np.random.default_rng(21)
    p0 = rng.standard_normal(_BCAST_SHAPE).astype(np.float32)
    return p0, [(rng.standard_normal(_BCAST_SHAPE) * 0.1).astype(np.float32)
                for _ in range(4)]


def _jax_adam_steps(lr, p0, grads):
    """(param, state) after the JAX fused_adam's steps over ``grads``."""
    tx = jax_fused_adam(lr)
    params = {"x": jnp.asarray(p0)}
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update({"x": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, updates)
    return np.asarray(params["x"]), state


def _close_f32(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("schedule", [True, False],
                         ids=["schedule", "float"])
def test_broadcast_optimizer_state_one_process(world1, schedule):
    """Returns with a schedule (a lambda, which cannot be pickled) as
    with a float learning rate, keeps the local schedule and count, and
    the next step is the JAX step."""
    lr = (lambda c: _schedule(c)) if schedule else 1e-2
    p0, grads = _bcast_np()
    p = torch.from_numpy(p0.copy())
    opt = tok.fused_adam([p], lr)
    for g in grads[:2]:
        p.grad = torch.from_numpy(g)
        opt.step()
    assert hvd.broadcast_optimizer_state(opt, root_rank=0) is opt
    assert opt.param_groups[0]["learning_rate"] is lr
    assert opt.param_groups[0]["count"] == 2
    p.grad = torch.from_numpy(grads[3])
    opt.step()
    want_p, want_s = _jax_adam_steps(lr, p0, [grads[0], grads[1], grads[3]])
    _close_f32(p.numpy(), want_p)
    _close_f32(opt.state[p]["mu"].numpy(), want_s.mu["x"])
    _close_f32(opt.state[p]["nu"].numpy(), want_s.nu["x"])


_BCAST_WORKER = r"""
import sys
import numpy as np
import torch
import horovod_tpu_torch as hvd

data = np.load(sys.argv[1])
hvd.init(device="cpu")
r = hvd.rank()
grads = [torch.from_numpy(data["g%d" % i]) for i in range(4)]
p = torch.from_numpy(data["p0"].copy())
opt = hvd.fused_adam([p], lambda c: 1e-2 * 0.5 ** c)
flat = hvd.fused_adam([torch.zeros(3)], 1e-3 * (r + 1))
# Rank 0 takes two steps, rank 1 one step of its own.
for g in (grads[:2] if r == 0 else grads[2:3]):
    p.grad = g
    opt.step()
hvd.broadcast_parameters([p], root_rank=0)
hvd.broadcast_optimizer_state(opt, root_rank=0)
hvd.broadcast_optimizer_state(flat, root_rank=0)
res = {"mu": opt.state[p]["mu"].numpy().copy(),
       "nu": opt.state[p]["nu"].numpy().copy(),
       "count": np.array(opt.param_groups[0]["count"]),
       "lr_callable": np.array(callable(opt.param_groups[0]["learning_rate"])),
       "flat_lr": np.array(flat.param_groups[0]["learning_rate"])}
p.grad = grads[3]
opt.step()
res["p"] = p.numpy().copy()
np.savez(sys.argv[2], **res)
hvd.shutdown()
"""


def test_broadcast_optimizer_state_two_processes(tmp_path):
    """Rank 1 starts from other moments and another count; after the
    call it holds rank 0's, keeps its own schedule, and its next step is
    the JAX fused_adam's third step from rank 0's history.  A float
    learning rate is rank 0's on every rank, as before."""
    p0, grads = _bcast_np()
    np.savez(tmp_path / "in.npz", p0=p0,
             **{f"g{i}": g for i, g in enumerate(grads)})
    env = dict(os.environ, HVDT_SIZE="2",
               HVDT_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BCAST_WORKER, str(tmp_path / "in.npz"),
         str(tmp_path / f"out{r}.npz")], env=dict(env, HVDT_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    _, root_state = _jax_adam_steps(_schedule, p0, grads[:2])
    want_p, _ = _jax_adam_steps(_schedule, p0,
                                [grads[0], grads[1], grads[3]])
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out.decode()[-3000:]
    res = [np.load(tmp_path / f"out{r}.npz") for r in range(2)]
    for key in ("mu", "nu", "p"):
        np.testing.assert_array_equal(res[1][key], res[0][key], err_msg=key)
    for r in range(2):
        assert int(res[r]["count"]) == 2
        assert bool(res[r]["lr_callable"])
        assert float(res[r]["flat_lr"]) == 1e-3
        _close_f32(res[r]["mu"], root_state.mu["x"])
        _close_f32(res[r]["nu"], root_state.nu["x"])
        _close_f32(res[r]["p"], want_p)


# ---- (f) import isolation -------------------------------------------------


# Modules of the later slices the walk below must reach.
_SLICE_MODULES = ("horovod_tpu_torch.bench", "horovod_tpu_torch.step_pipeline",
                  "horovod_tpu_torch.common.graphs",
                  "horovod_tpu_torch.telemetry.metrics",
                  "horovod_tpu_torch.telemetry.step_stats",
                  "horovod_tpu_torch.data.loader",
                  "horovod_tpu_torch.parallel.mesh",
                  "horovod_tpu_torch.parallel.ring_attention",
                  "horovod_tpu_torch.ops.eager",
                  "horovod_tpu_torch.ops.control_plane",
                  "horovod_tpu_torch.ops.host_collectives",
                  "horovod_tpu_torch.ops.messages",
                  "horovod_tpu_torch.ops.handles",
                  "horovod_tpu_torch.ops.sparse",
                  "horovod_tpu_torch.stall",
                  "horovod_tpu_torch.resilience.escalation",
                  "horovod_tpu_torch.common.util",
                  "horovod_tpu_torch.quant.fp8",
                  "horovod_tpu_torch.ops.adasum",
                  "horovod_tpu_torch.ops.overlap",
                  "horovod_tpu_torch.transport.policy",
                  "horovod_tpu_torch.transport.hierarchy",
                  "horovod_tpu_torch.interop.torch",
                  "horovod_tpu_torch.interop.torch_optimizer",
                  "horovod_tpu_torch.interop.torch_sync_batch_norm",
                  "horovod_tpu_torch.timeline",
                  "horovod_tpu_torch.parallel.moe",
                  "horovod_tpu_torch.parallel.pipeline")


def test_import_loads_no_jax():
    """Importing every module of the port loads nothing of JAX, and
    starts no thread (the eager controller starts at the first eager
    call)."""
    code = (
        "import sys, threading, importlib, pkgutil, horovod_tpu_torch as h\n"
        "for m in pkgutil.walk_packages(h.__path__, 'horovod_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"missing = [m for m in {_SLICE_MODULES!r} if m not in sys.modules]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'optax', 'horovod_tpu', 'triton'))\n"
        "threads = [t.name for t in threading.enumerate()]\n"
        "print(bad, missing, threads)\n"
        "sys.exit(1 if bad or missing or len(threads) > 1 else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_jax_imports_in_port_sources():
    sources = list((ROOT / "horovod_tpu_torch").rglob("*.py"))
    sources.append(ROOT / "chip_smoke.py")
    for path in sources:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0]
                assert top not in ("jax", "jaxlib", "optax",
                                   "horovod_tpu", "triton"), (path, line)
