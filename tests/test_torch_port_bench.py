"""PyTorch port, the ResNet-50 bench leg (horovod_tpu_torch/bench.py) on
the CPU.

* ``flops_per_step`` (FlopCounterMode over the port's training step on
  the meta device) within 10% of the JAX package's compiled
  ``cost_analysis()`` flops for the reference bench's step (depth 50,
  64x64, batch 2, bf16 compute, optax SGD-momentum).  On this container
  the port counts 7.7% fewer: it counts the convolutions and matmuls
  only, where XLA also counts BatchNorm, the elementwise work and the
  optimizer update.
* ``python -m horovod_tpu_torch.bench --device cpu ...`` prints one JSON
  line with the reference's keys, ``platform`` "cpu" and ``mfu`` null;
  the fused-optimizer leg launches no kernel on the CPU.
* The --overlap, --transport, --fp8, --zero and --ckpt-stall legs give
  the reference's JSON keys; the reference's other legs exit non-zero
  naming their ROADMAP item.
* The parent without a card exits non-zero with ``value`` 0.0 and never
  prints a CPU or cached number as the headline; the last-good cache
  rules of tests/test_bench_gate.py, on the port's own file.
"""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from horovod_tpu.models import resnet as jrn
from horovod_tpu_torch import bench
from horovod_tpu_torch.models import ResNetConfig
from horovod_tpu_torch.ops import conv_fused as tcf
from horovod_tpu_torch.ops import optim_kernels as tok

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SMALL = ["--batch-size", "2", "--image-size", "64", "--num-iters", "1",
          "--num-batches-per-iter", "1", "--num-warmup", "1"]
_KEYS = {"metric", "value", "unit", "vs_baseline", "platform",
         "device_kind", "mfu", "hbm_util", "hbm_util_method", "batch_size",
         "compile_s", "flops_per_step"}


def _env(**extra):
    env = dict(os.environ,
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.update(extra)
    return env


def test_flops_per_step_within_10_percent_of_jax_cost_analysis():
    cfg = jrn.ResNetConfig(num_classes=1000, dtype=jnp.bfloat16)
    params, stats = jax.eval_shape(lambda k: jrn.resnet50_init(k, cfg),
                                   jax.random.PRNGKey(0))
    opt = optax.sgd(0.01, momentum=0.9)

    def one_step(params, stats, opt_state, images, labels):
        (loss, new_stats), grads = jax.value_and_grad(
            jrn.resnet_loss, has_aux=True)(params, stats, images, labels,
                                           cfg)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, opt_state, \
            loss

    compiled = jax.jit(one_step).lower(
        params, stats, jax.eval_shape(opt.init, params),
        jax.ShapeDtypeStruct((2, 64, 64, 3), jnp.bfloat16),
        jax.ShapeDtypeStruct((2,), jnp.int32)).compile()
    want = float(compiled.cost_analysis()["flops"])
    got = bench.train_step_flops(ResNetConfig(), 2, 64)
    assert abs(got - want) <= 0.10 * want, (got, want, got / want)


def test_flops_scale_with_batch_and_ignore_the_fused_knob(monkeypatch):
    one = bench.train_step_flops(ResNetConfig(depth=26), 1, 64)
    monkeypatch.setenv("HVDT_FUSED_CONV1X1", "1")
    assert bench.train_step_flops(ResNetConfig(depth=26), 3, 64) == 3 * one
    assert os.environ["HVDT_FUSED_CONV1X1"] == "1"


def test_cpu_leg_prints_one_json_line():
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.bench", "--device", "cpu",
         *_SMALL], env=_env(), capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout
    d = json.loads(lines[0])
    assert _KEYS <= set(d)
    assert d["metric"] == "resnet50_images_per_sec_per_gpu"
    assert d["unit"] == "images/sec/gpu"
    assert d["platform"] == "cpu" and d["device_kind"] == "cpu"
    assert d["mfu"] is None and d["hbm_util"] is None
    assert d["hbm_util_method"] is None and d["batch_size"] == 2
    assert d["value"] > 0 and d["flops_per_step"] > 0
    assert d["vs_baseline"] == round(d["value"] / (1656.82 / 16), 3)
    assert "img/sec per iter" in out.stderr


def test_fused_optimizer_leg_launches_no_kernel_on_cpu(monkeypatch):
    monkeypatch.setenv("HVDT_TELEMETRY", "1")
    for counter in (tok._sgd_multi, tcf.matmul_batch_stats,
                    tcf._mm_forward):
        monkeypatch.setattr(counter, "launches", 0)
    leg = bench.measure(bench._parse_args(
        ["--device", "cpu", "--fused-optimizer", "--steps-per-call", "2",
         *_SMALL]))
    assert leg.doc["fused_optimizer"] is True
    assert leg.doc["steps_per_call"] == 2
    assert leg.doc["telemetry"]["steps"] == 2
    assert 0 < leg.doc["telemetry"]["goodput_fraction"] <= 1
    assert len(leg.rates) == 1 and torch.isfinite(leg.step())
    assert tok._sgd_multi.launches == 0
    assert tcf.matmul_batch_stats.launches == tcf._mm_forward.launches == 0


_LEG_IDS = [f"flag{i}-parallel axes" for i in range(3)] + [
    "flag3-serving", "flag4-serving"] + [
    f"flag{i}-control, analysis and the edges" for i in (5, 6, 7)]


# --remat, --moe and --pipeline are ported (parallel axes, part 1), and
# --serve (serving, part 1): item None, the leg prints its JSON.  The ids
# are the ones these cases had while every leg raised.
@pytest.mark.parametrize("flag,item", [
    (["--remat", "full"], None), (["--moe"], None), (["--pipeline"], None),
    (["--serve"], None), (["--serve-llm"], "serving"),
    (["--controller"], "control, analysis and the edges"),
    (["--fleet", "diurnal"], "control, analysis and the edges"),
    (["--report"], "control, analysis and the edges")], ids=_LEG_IDS)
def test_unported_legs_raise(flag, item, tmp_path, monkeypatch):
    if item is not None:
        with pytest.raises(NotImplementedError,
                           match=f"{flag[0]} is not ported yet .ROADMAP "
                                 f"Queue 1: {item}"):
            bench.main(flag)
        return
    seed = tmp_path / "seed.json"
    extra = (_SMALL if flag[0] == "--remat"
             else ["--serve-duration", "1", "--serve-threads", "2"]
             if flag[0] == "--serve"
             else ["--num-iters", "1", "--num-warmup", "1", "--json-out",
                   str(seed)])
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.bench", *flag, "--device",
         "cpu", *extra], env=_env(), capture_output=True, text=True,
        timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    if flag[0] == "--remat":
        assert doc["remat"] == "full" and doc["value"] > 0
        return
    if flag[0] == "--serve":
        # The reference's _run_serve_child keys, on the CPU's MLP.
        assert doc["metric"] == "serve_throughput_rps"
        assert doc["requests_ok"] > 0 and doc["requests_failed"] == 0
        assert doc["value"] == doc["throughput_rps"] > 0
        assert doc["latency_p99_ms"] >= doc["latency_p50_ms"] > 0
        assert doc["steady_state_compiles"] == 0
        assert doc["buckets"] == [1, 8, 32] and doc["clients"] == 2
        assert doc["platform"] == doc["device_kind"] == "cpu"
        return
    keys = ({"capacity_factor_at_peak", "dropped_fraction",
             "a2a_wire_bytes"} if flag[0] == "--moe" else
            {"microbatches_at_peak", "bubble_fraction_priced",
             "bubble_fraction_observed"})
    assert keys | {"rows", "metric", "value", "platform"} <= set(doc)
    assert doc["platform"] == "cpu" and len(doc["rows"]) == 4
    assert json.loads(seed.read_text()) == doc
    # The autotuner's seed readers take the file.
    from horovod_tpu_torch import autotune

    for k in ("HVDT_MOE_CAPACITY_FACTOR", "HVDT_PIPELINE_MICROBATCHES"):
        monkeypatch.delenv(k, raising=False)
    if flag[0] == "--moe":
        monkeypatch.setenv("HVDT_AUTOTUNE_MOE_SEED", str(seed))
        assert autotune._env_capacity_factor() == \
            doc["capacity_factor_at_peak"]
    else:
        monkeypatch.setenv("HVDT_AUTOTUNE_PIPELINE_SEED", str(seed))
        assert autotune._env_microbatches() == doc["microbatches_at_peak"]


def test_unported_leg_exits_nonzero():
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.bench", "--serve-llm"],
        env=_env(), capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert "ROADMAP Queue 1: serving" in out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("flag", [
    ["--zero", "grads"], ["--zero", "states"], ["--zero", "params"],
    ["--ckpt-stall"]])
def test_zero_and_ckpt_stall_legs(flag, monkeypatch):
    """The --zero legs (a world of one: one shard) and --ckpt-stall on
    the CPU: the reference's JSON keys.  states/params step fused_sgd on
    the rank's rows: the momentum rows, 256-element aligned, are the
    state's bytes."""
    for k in ("HVDT_ZERO", "HVDT_OVERLAP", "HVDT_TELEMETRY",
              "HVDT_FUSION_THRESHOLD", "HVDT_ASYNC_CKPT"):
        # setenv first, so that the leg's own settings are undone too.
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import zero as tz

    tz.reset()
    try:
        leg = bench.measure(bench._parse_args(["--device", "cpu", *flag,
                                               *_SMALL]))
        assert torch.isfinite(leg.step())
    finally:
        if hvd.is_initialized():
            hvd.shutdown()
        tz.reset()
    d = leg.doc
    assert d["value"] > 0
    if flag[0] == "--ckpt-stall":
        stall = d["checkpoint_stall_ms"]
        assert stall["sync"] > 0 and stall["async"] > 0
        assert "zero_stage" not in d
        return
    from horovod_tpu_torch.models import resnet50_init

    params = list(resnet50_init(0, ResNetConfig(),
                                device="meta").parameters())
    size = sum(p.numel() for p in params)
    assert d["zero_stage"] == flag[1] and d["zero_num_shards"] == 1
    assert d["param_bytes"] >= 4 * size
    assert d.get("fused_optimizer", False) is (flag[1] != "grads")
    if flag[1] == "grads":
        assert d["optimizer_state_bytes"] == 4 * size     # SGD's momentum
    else:
        plan = tz._make_plan(params, 8 * 1024 * 1024, 1)
        assert d["optimizer_state_bytes"] == 4 * sum(plan.padded_sizes)


@pytest.mark.parametrize("stage", ["grads", "states", "params"])
def test_zero_sharded_update_implies_fused_optimizer(stage):
    """--zero states/params shard fused_sgd's update, so they imply
    --fused-optimizer (the JSON's fused_optimizer says so); grads keeps
    the leg's optimizer."""
    args = bench._parse_args(["--zero", stage])
    assert args.fused_optimizer is (stage != "grads")


@pytest.mark.parametrize("flag", [["--overlap"], ["--transport", "auto"],
                                  ["--fp8"]])
def test_exchange_and_fp8_legs(flag, monkeypatch):
    """The --overlap, --transport and --fp8 legs on the CPU: the
    reference's JSON keys.  The exchange legs step through
    DistributedOptimizer in a world of one (gloo), with 8 MiB buckets:
    ResNet-50's f32 gradients (102 MB) plan 15 of them."""
    for k in ("HVDT_OVERLAP", "HVDT_TRANSPORT", "HVDT_FP8", "HVDT_TELEMETRY",
              "HVDT_FUSION_THRESHOLD"):
        monkeypatch.delenv(k, raising=False)
    from horovod_tpu_torch.ops import overlap as tov
    from horovod_tpu_torch.transport import policy as tpol

    tov.reset()
    tpol.reset()
    tov.reset_accounting()
    import horovod_tpu_torch as hvd

    try:
        leg = bench.measure(bench._parse_args(["--device", "cpu", *flag,
                                               *_SMALL]))
        assert torch.isfinite(leg.step())
    finally:
        hvd.shutdown()
        tov.reset()
        tpol.reset()
    d = leg.doc
    assert d["value"] > 0
    if flag[0] == "--overlap":
        assert d["overlap"] is True and 0 < d["overlap_fraction"] < 1
        sched = d["overlap_schedule"]
        from horovod_tpu_torch.models import resnet50_init

        params = list(resnet50_init(0, ResNetConfig(),
                                    device="meta").parameters())
        assert sched["buckets"] == len(tov.overlap_schedule(
            params, 8 * 1024 * 1024)) == 15
        assert sched["wire"] == "exact"
    elif flag[0] == "--transport":
        assert d["transport"] == "auto"
        assert d["transport_policy"].startswith("TransportPolicy(dcn:tree")
        assert d["transport_resolved"]["kind"] == "flat"
        assert d["transport_resolved"]["axes"] == ("dp",)
    else:
        fp8 = d["fp8"]
        assert fp8["mode"] == "matmul" and fp8["available"]
        assert fp8["engaged"] and fp8["shape_mkn"] == [64, 128, 256]
        assert fp8["fp8_matmul_us"] > 0 and fp8["bf16_matmul_us"] > 0


def test_parent_without_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("this case needs a machine without a card")
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.bench", *_SMALL],
        env=_env(HVDT_BENCH_ATTEMPT_TIMEOUTS="120,120",
                 HVDT_BENCH_ATTEMPT_SLEEP="0"),
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    d = json.loads(lines[0])
    assert d["value"] == 0.0 and d["platform"] is None
    assert "no CUDA device" in d["error"]
    assert "attempt0" in d["error"] and "attempt1" in d["error"]


# ---- the parent's cache rules (tests/test_bench_gate.py, adapted) ---------

GPU_LINE = {
    "metric": "resnet50_images_per_sec_per_gpu", "value": 1234.5,
    "unit": "images/sec/gpu", "vs_baseline": 11.922, "platform": "gpu",
    "device_kind": "NVIDIA H100 80GB HBM3", "mfu": 0.0305,
    "batch_size": 128}


@pytest.fixture
def parent(monkeypatch, tmp_path):
    monkeypatch.setattr(time, "sleep", lambda _s: None)
    monkeypatch.setenv("HVDT_BENCH_ATTEMPT_TIMEOUTS", "1,1")
    monkeypatch.delenv("HVDT_BENCH_NO_CACHE", raising=False)
    monkeypatch.setattr(bench, "LAST_GOOD_PATH", str(tmp_path / "lg.json"))
    return bench


def _run(parent, capsys, spawn, argv=()):
    parent._spawn = spawn
    rc = parent.main(list(argv))
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, "the bench prints exactly one JSON line"
    return rc, json.loads(out[0])


def test_failure_keeps_the_cached_run_as_a_stale_sub_record(parent, capsys,
                                                            monkeypatch):
    cached = dict(GPU_LINE, measured_at=time.strftime(
        "%Y-%m-%dT%H:%M:%SZ", time.gmtime(time.time() - 7200)))
    with open(parent.LAST_GOOD_PATH, "w") as f:
        json.dump(cached, f)
    rc, d = _run(parent, capsys, lambda *a: (False, None, "card down"))
    assert rc != 0
    assert d["value"] == 0.0 and d["vs_baseline"] == 0.0
    assert d["platform"] is None
    assert d["last_good"]["value"] == 1234.5
    assert d["last_good"]["stale"] is True
    assert d["last_good"]["age_hours"] == pytest.approx(2.0, abs=0.2)
    assert "attempt0: card down" in d["error"]
    assert "attempt1: card down" in d["error"]


def test_failure_without_cache(parent, capsys):
    rc, d = _run(parent, capsys, lambda *a: (False, None, "nope"))
    assert rc != 0 and d["value"] == 0.0 and "last_good" not in d


def test_healthy_card_run_is_cached(parent, capsys):
    rc, d = _run(parent, capsys,
                 lambda *a: (True, json.dumps(GPU_LINE), ""))
    assert rc == 0 and d["value"] == 1234.5 and "stale" not in d
    with open(parent.LAST_GOOD_PATH) as f:
        assert json.load(f)["measured_at"]


@pytest.mark.parametrize("variant", [
    {"fused_optimizer": True}, {"steps_per_call": 4}, {"eager": True},
    {"telemetry": {"steps": 3}}, {"platform": "cpu"}])
def test_variants_and_cpu_runs_are_not_cached(parent, capsys, variant):
    line = json.dumps(dict(GPU_LINE, **variant))
    rc, d = _run(parent, capsys, lambda *a: (True, line, ""))
    assert rc == 0 and d == json.loads(line)
    assert not os.path.exists(parent.LAST_GOOD_PATH)


def test_no_cache_env_protects_the_cache(parent, capsys, monkeypatch):
    monkeypatch.setenv("HVDT_BENCH_NO_CACHE", "1")
    rc, d = _run(parent, capsys,
                 lambda *a: (True, json.dumps(GPU_LINE), ""))
    assert rc == 0 and d["value"] == 1234.5
    assert not os.path.exists(parent.LAST_GOOD_PATH)


def test_cpu_device_is_one_attempt_and_never_cached(parent, capsys):
    seen = []

    def spawn(child_args, timeout_s):
        seen.append(child_args)
        return True, json.dumps(dict(GPU_LINE, platform="cpu")), ""

    rc, d = _run(parent, capsys, spawn, ["--device", "cpu"])
    assert rc == 0 and d["platform"] == "cpu"
    assert len(seen) == 1 and seen[0][-2:] == ["--device", "cpu"]
    assert not os.path.exists(parent.LAST_GOOD_PATH)
