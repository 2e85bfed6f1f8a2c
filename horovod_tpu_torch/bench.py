"""Synthetic ResNet-50 training benchmark of the port: the reference's
headline leg (``bench.py``, ``_run_child``) on the card.

    python -m horovod_tpu_torch.bench                      # on the card
    python -m horovod_tpu_torch.bench --fused-optimizer    # kernel #2
    HVDT_FUSED_CONV1X1=1 python -m horovod_tpu_torch.bench # kernel #4
    python -m horovod_tpu_torch.bench --device cpu --batch-size 2 \\
        --image-size 64 --num-iters 1 --num-batches-per-iter 1 --num-warmup 1

ResNet-50 (1000 classes, bf16 compute, f32 parameters) on a synthetic
batch of bf16 NHWC images and labels drawn from seeded generators,
trained with SGD(0.01, momentum 0.9): ``torch.optim.SGD`` by default,
the port's ``fused_sgd`` with ``--fused-optimizer``.  The step is built
with ``step_pipeline.donated_step`` (one CUDA graph a call) unless
``--eager`` asks for the eager step it is measured against.  As in the
reference the headline step has no gradient exchange.

Timing follows the reference: every timed region ends with a host fetch
of the loss; the rate of an iteration is ``batch * batches_per_iter *
steps_per_call / seconds``; the per-iteration rates and their spread go
to stderr.  ``compile_s`` is the eager first step plus the capture and
first replay.  MFU is ``steps/s * flops_per_step / peak``, with the peak
from ``telemetry.peak_flops_for`` (None where the device is unknown, as
on the CPU) and ``flops_per_step`` from :func:`train_step_flops`.

The parent runs the measurement in a child process with a hard timeout
per attempt (``HVDT_BENCH_ATTEMPT_TIMEOUTS``, seconds, comma-separated;
``HVDT_BENCH_ATTEMPT_SLEEP`` between attempts) and prints one JSON line.
It never falls back to the CPU: ``--device cpu`` runs the child there
only when asked, in one attempt (``HVDT_BENCH_CPU_TIMEOUT`` seconds).
If no attempt succeeds it prints ``value`` 0.0 with the error, the last
good card run (if any) as a ``last_good`` record marked stale, and exits
non-zero.  A card run of the default leg is
kept in ``.bench_torch_last_good.json`` beside the package; variants
(``--fused-optimizer``, ``--steps-per-call``, ``--eager``, telemetry,
``HVDT_BENCH_NO_CACHE``) never write it.

The exchange-scheduling legs follow the reference's env contract
(``bench.py:751-783``; explicit env wins over each default):

    python -m horovod_tpu_torch.bench --overlap          # HVDT_OVERLAP=on
    python -m horovod_tpu_torch.bench --transport auto   # HVDT_TRANSPORT
    python -m horovod_tpu_torch.bench --fp8              # HVDT_FP8=matmul

``--overlap`` and ``--transport`` give the step a gradient exchange:
``DistributedOptimizer`` in the world of one process (NCCL on the card)
with 8 MiB buckets (``HVDT_FUSION_THRESHOLD``), so ResNet-50's gradients
plan several buckets; their JSON keys are the reference's
(``overlap_fraction``, ``overlap_schedule``; ``transport``,
``transport_policy``, plus ``transport_resolved``, the policy applied to
the step's reduce group).  ``--fp8`` flips the compute gate; the ResNet
conv stack has no projection, so the step is unchanged, as in the
reference, and the ``fp8`` key carries the gate and probe state and a
microbench of ``quant.fp8.fp8_matmul`` (``torch._scaled_mm``) against
the bf16 ``torch.matmul`` at a bert-large projection shape.

The ZeRO and checkpoint legs (the reference's ``bench.py:772-783``,
``:1189-1222``, ``:1324-1348``):

    python -m horovod_tpu_torch.bench --zero states      # HVDT_ZERO
    python -m horovod_tpu_torch.bench --ckpt-stall

``--zero grads|states|params`` exchanges through
``DistributedOptimizer(zero=...)`` (``states``/``params`` imply
``--fused-optimizer``, and the JSON says so: ``fused_sgd``'s update #2
runs on the rank's shard rows, so their images/s compare with that
leg's; under
``params`` the step gathers the parameters before the forward) at 8
MiB buckets; the JSON gains ``zero_stage``, ``zero_num_shards``,
``optimizer_state_bytes`` and ``param_bytes`` (a rank's).  In the world
of one process that this leg runs in there is one shard: the state is
not smaller; the sharding shows across cards (``chip_smoke.py
--dp-cards 4``, dp_cards_zero).  ``--ckpt-stall`` times one commit of
the trained model's state through ``checkpoint.CheckpointManager``,
``save`` against ``save_async`` (the caller's side: the host snapshot),
as ``checkpoint_stall_ms`` with ``sync`` and ``async``; unlike the
reference's probe, a failure raises.

The parallel-axes legs (the reference's ``bench.py:351-560``,
``:799-806``):

    python -m horovod_tpu_torch.bench --moe
    python -m horovod_tpu_torch.bench --pipeline
    python -m horovod_tpu_torch.bench --remat dots      # HVDT_REMAT

``--moe`` and ``--pipeline`` run in the process, over the initialised
world as ``ep`` or ``pp`` (a world of one when no launcher variables are
set; gloo processes with ``--device cpu``, NCCL on the cards) where the
reference runs them on its 8-device CPU simulation, and never touch the
last-good cache.  ``--moe`` times ``parallel.moe_dispatch_combine``
(both all-to-alls, one expert a rank, a skewed router, top-1) at each of
the autotuner's capacity factors and prints the reference's keys:
``rows``, ``capacity_factor_at_peak`` (the best goodput, tokens/s times
the kept fraction), ``dropped_fraction`` and ``a2a_wire_bytes``.
``--pipeline`` times ``parallel.pipeline_1f1b`` (one ``tanh(x @ w)``
stage a rank, forward) at each of the autotuner's microbatch counts m,
and at 2m for the per-tick slope, and prints ``rows``,
``microbatches_at_peak``, ``bubble_fraction_priced`` (the clock's
``(p-1)/(m+p-1)``; the reference's cost model waits for ROADMAP Queue 1
item 8) and ``bubble_fraction_observed`` (the share of the step not
spent on ticks).  ``HVDT_AUTOTUNE_MOE_SEED`` /
``HVDT_AUTOTUNE_PIPELINE_SEED`` read these files (``--json-out``).
Each rank's time is the slowest rank's.  ``--remat full|dots`` runs the
ResNet-50 leg with its loss under ``torch.utils.checkpoint``
(``models.transformer.remat_checkpoint``): ``dots`` saves the products
without batch dimensions (the FC; convolutions are not dots) and
recomputes the rest; the BatchNorm running statistics keep the values
of the step's forward, as the reference's checkpointed function returns
them once.  The JSON gains ``remat``.

The serving leg (the reference's ``_run_serve_child``,
``bench.py:563-649``):

    python -m horovod_tpu_torch.bench --serve [--serve-duration S] \
        [--serve-threads N]

runs an in-process ``serve.ModelServer`` over the MLP 784-256-128-10
(buckets 1/8/32, one CUDA graph a bucket on the card) and fires
``--serve-threads`` HTTP clients with 1-4 row batches at it for
``--serve-duration`` seconds; it prints one JSON line under the
reference's keys (``serve_throughput_rps`` as ``metric``,
``latency_p50_ms``, ``latency_p99_ms``, ``requests_ok``,
``requests_failed``, ``steady_state_compiles``, ...), in a child with
the same attempt and timeout rules, and never touches the last-good
cache.

The reference's other legs are not ported yet: each flag raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import argparse
import calendar
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Callable, List

BASELINE_IMG_S_PER_DEVICE = 1656.82 / 16.0
METRIC = "resnet50_images_per_sec_per_gpu"
UNIT = "images/sec/gpu"
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAST_GOOD_PATH = os.path.join(_ROOT, ".bench_torch_last_good.json")

# The reference's other legs (argparse dest -> ROADMAP Queue 1 item).
_UNPORTED = {
    "serve_llm": "serving",
    "controller": "control, analysis and the edges",
    "fleet": "control, analysis and the edges",
    "report": "control, analysis and the edges",
}
# Keys of a JSON line that mark a variant, never the headline.
_VARIANTS = ("fused_optimizer", "steps_per_call", "eager", "telemetry",
             "overlap", "transport", "fp8", "zero_stage",
             "checkpoint_stall_ms", "remat", "fault_plan")
# The fp8 microbench: a bert-large projection (d_model 1024, d_ff 4096)
# over 8192 tokens on the card; a small one on the CPU.
FP8_SHAPE = {"cuda": (8192, 1024, 4096), "cpu": (64, 128, 256)}
# The --moe leg's tokens a rank and width: a bert-large MoE layer's
# (batch 32 x seq 512, d_model 1024) on the card, the reference's CPU-sim
# shape on the CPU.
MOE_SHAPE = {"cuda": (16384, 1024), "cpu": (256, 64)}
# The --pipeline leg's rows a step and width.
PIPELINE_SHAPE = {"cuda": (8192, 1024), "cpu": (128, 64)}


def _save_last_good(line: str) -> None:
    """Keep a card run of the default leg as the last good one."""
    try:
        d = json.loads(line)
        if d.get("platform") != "gpu" or d.get("metric") != METRIC \
                or any(d.get(k) for k in _VARIANTS):
            return
        if os.environ.get("HVDT_BENCH_NO_CACHE", "") not in ("", "0"):
            return
        d["measured_at"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        with open(LAST_GOOD_PATH, "w") as f:
            json.dump(d, f, indent=1)
    except OSError as e:  # a cache write must never sink the bench
        print(f"last-good cache write failed: {e!r}", file=sys.stderr)


def _load_last_good():
    try:
        with open(LAST_GOOD_PATH) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m horovod_tpu_torch.bench")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--num-iters", type=int, default=5)
    ap.add_argument("--num-batches-per-iter", type=int, default=50)
    ap.add_argument("--num-warmup", type=int, default=2)
    ap.add_argument("--steps-per-call", type=int, default=1,
                    help="N steps captured in one CUDA graph (the "
                         "reference runs N in one program)")
    ap.add_argument("--fused-optimizer", action="store_true",
                    help="SGD-momentum through the port's fused_sgd "
                         "(kernel #2) instead of torch.optim.SGD")
    ap.add_argument("--eager", action="store_true",
                    help="run the step eagerly, without the CUDA graph "
                         "(the yardstick for donated_step)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; the card otherwise")
    ap.add_argument("--overlap", action="store_true",
                    help="the step exchanges its gradients through "
                         "DistributedOptimizer with HVDT_OVERLAP=on (hooks "
                         "issue each 8 MiB bucket during the backward)")
    ap.add_argument("--transport", default="",
                    help="the step exchanges its gradients under this "
                         "HVDT_TRANSPORT policy (e.g. auto)")
    ap.add_argument("--fp8", action="store_true",
                    help="HVDT_FP8=matmul, and the fp8 gate, probe and "
                         "matmul microbench in the JSON")
    ap.add_argument("--zero", default="",
                    choices=("", "grads", "states", "params"),
                    help="the step exchanges its gradients through "
                         "DistributedOptimizer(zero=...) (HVDT_ZERO): "
                         "'grads' reduce-scatters and all-gathers each "
                         "bucket, 'states' shards the momentum (fused_sgd "
                         "on the rank's rows, delta all-gather; implies "
                         "--fused-optimizer), 'params' "
                         "keeps the parameters sharded between steps; JSON "
                         "gains zero_stage / optimizer_state_bytes.  One "
                         "card is one shard: the sharded memory shows "
                         "only across cards (chip_smoke.py --dp-cards 4)")
    ap.add_argument("--ckpt-stall", action="store_true",
                    help="time the commit-point checkpoint stall of the "
                         "trained state, sync against async "
                         "(HVDT_ASYNC_CKPT), as checkpoint_stall_ms")
    ap.add_argument("--moe", action="store_true",
                    help="expert-capacity sweep of moe_dispatch_combine "
                         "over the world as ep (JSON: rows, "
                         "capacity_factor_at_peak, dropped_fraction, "
                         "a2a_wire_bytes)")
    ap.add_argument("--pipeline", action="store_true",
                    help="1F1B microbatch sweep of pipeline_1f1b over the "
                         "world as pp (JSON: rows, microbatches_at_peak, "
                         "bubble_fraction_priced / _observed)")
    ap.add_argument("--json-out", default="",
                    help="--moe / --pipeline: also write the JSON here "
                         "(an HVDT_AUTOTUNE_*_SEED file)")
    ap.add_argument("--remat", default="", choices=("", "none", "full",
                                                   "dots"),
                    help="the ResNet-50 loss under torch.utils.checkpoint "
                         "(HVDT_REMAT): full saves the inputs, dots also "
                         "the products without batch dims; JSON gains "
                         "remat")
    ap.add_argument("--serve", action="store_true",
                    help="serving micro-benchmark instead of training: an "
                         "in-process ModelServer (MLP, shape-bucketed "
                         "engine + dynamic batcher) hammered over HTTP by "
                         "--serve-threads clients; JSON: latency_p50_ms / "
                         "latency_p99_ms / throughput_rps")
    ap.add_argument("--serve-duration", type=float, default=5.0,
                    help="seconds of sustained client fire for --serve")
    ap.add_argument("--serve-threads", type=int, default=8,
                    help="concurrent HTTP client threads for --serve")
    for flag in ("serve-llm", "report", "controller"):
        ap.add_argument(f"--{flag}", action="store_true",
                        help="not ported yet (raises)")
    ap.add_argument("--fleet", default="", help="not ported yet (raises)")
    ap.add_argument("--_child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.zero in ("states", "params"):
        # The sharded update is fused_sgd's: the JSON then says
        # fused_optimizer, the leg these images/s compare with.
        args.fused_optimizer = True
    return args


def _refuse_unported(args) -> None:
    for dest, item in _UNPORTED.items():
        if getattr(args, dest):
            raise NotImplementedError(
                f"--{dest.replace('_', '-')} is not ported yet (ROADMAP "
                f"Queue 1: {item})")


def train_step_flops(cfg, batch: int, image: int) -> float:
    """FLOPs of one training step of the ResNet ``cfg`` at ``batch``
    images of ``image``² pixels: forward and backward of ``resnet_loss``
    counted by ``torch.utils.flop_counter.FlopCounterMode`` on the meta
    device (no compute, independent of the values).  It counts the
    convolutions and matmuls, 2 FLOPs a multiply-add; BatchNorm,
    elementwise work and the optimizer are not counted.  The plain path
    is counted: the fused 1x1 convs do the same products."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from .models import resnet50_init, resnet_loss

    model = resnet50_init(0, cfg, device="meta")
    images = torch.empty((batch, image, image, 3), device="meta")
    labels = torch.zeros((batch,), dtype=torch.long, device="meta")
    knob = os.environ.pop("HVDT_FUSED_CONV1X1", None)
    try:
        with FlopCounterMode(display=False) as counter:
            loss, _ = resnet_loss(model, images, labels)
            loss.backward()
    finally:
        if knob is not None:
            os.environ["HVDT_FUSED_CONV1X1"] = knob
    return float(counter.get_total_flops())


@dataclasses.dataclass
class Leg:
    """One measured leg: its JSON line, the per-iteration rates, and a
    callable that runs one more call of its step (returns the loss)."""
    doc: dict
    rates: List[float]
    step: Callable[[], object]


def measure(args) -> Leg:
    """Build the leg ``args`` describes, time it and return it."""
    import torch

    from . import telemetry
    from .common.basics import resolve_device
    from .models import ResNetConfig, resnet50_init, resnet_loss
    from .ops.optim_kernels import fused_sgd
    from .step_pipeline import donated_step

    if args.overlap:
        os.environ.setdefault("HVDT_OVERLAP", "on")
        os.environ.setdefault("HVDT_TELEMETRY", "1")
        os.environ.setdefault("HVDT_FUSION_THRESHOLD", str(8 * 1024 * 1024))
    if args.transport:
        os.environ["HVDT_TRANSPORT"] = args.transport
        os.environ.setdefault("HVDT_TELEMETRY", "1")
        os.environ.setdefault("HVDT_FUSION_THRESHOLD", str(8 * 1024 * 1024))
    if args.fp8:
        os.environ["HVDT_FP8"] = "matmul"
        os.environ.setdefault("HVDT_TELEMETRY", "1")
    if args.zero:
        os.environ["HVDT_ZERO"] = args.zero
        os.environ.setdefault("HVDT_TELEMETRY", "1")
        os.environ.setdefault("HVDT_FUSION_THRESHOLD", str(8 * 1024 * 1024))
    if args.remat:
        os.environ.setdefault("HVDT_REMAT", args.remat)

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if on_card else device.type
    platform = "gpu" if on_card else device.type
    print(f"benchmarking on {platform}:{kind}", file=sys.stderr)

    def generator(seed):
        return torch.Generator(device=device).manual_seed(seed)

    cfg = ResNetConfig(num_classes=1000, dtype=torch.bfloat16)
    model = resnet50_init(0, cfg, device=device)
    size = (args.batch_size, args.image_size, args.image_size, 3)
    images = torch.randn(size, generator=generator(1), device=device,
                         dtype=torch.bfloat16)
    labels = torch.randint(0, cfg.num_classes, (args.batch_size,),
                           generator=generator(2), device=device)
    if args.fused_optimizer:
        opt = fused_sgd(model.parameters(), 0.01, momentum=0.9)
    else:
        opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    if args.overlap or args.transport or args.zero:
        # The exchange legs: a world of one process, so the step has the
        # gradient exchange the headline leg leaves out.
        import horovod_tpu_torch as hvd

        hvd.init(device=device)
        opt = hvd.DistributedOptimizer(opt)
        print(f"exchange leg: HVDT_OVERLAP="
              f"{os.environ.get('HVDT_OVERLAP')!r} HVDT_ZERO="
              f"{os.environ.get('HVDT_ZERO')!r} HVDT_TRANSPORT="
              f"{os.environ.get('HVDT_TRANSPORT')!r} threshold "
              f"{os.environ.get('HVDT_FUSION_THRESHOLD')}", file=sys.stderr)

    from .models.transformer import checkpoint_policy, remat_checkpoint

    remat = checkpoint_policy(args.remat) if args.remat else None
    policy = "full" if remat == "full" else "dots"

    def step_fn(model, opt, images, labels):
        for _ in range(args.steps_per_call):
            opt.zero_grad(set_to_none=True)
            if args.zero == "params":
                opt.gather_params()
            if remat is None:
                loss, _ = resnet_loss(model, images, labels)
                loss.backward()
            else:
                loss, _ = remat_checkpoint(resnet_loss, model, images,
                                           labels, policy=policy)
                # The recompute updates the running statistics a second
                # time: keep the forward's.
                stats = [b.clone() for b in model.buffers()]
                loss.backward()
                with torch.no_grad():
                    for b, v in zip(model.buffers(), stats):
                        b.copy_(v)
            opt.step()
        return loss.detach()

    step = step_fn if args.eager else donated_step(step_fn,
                                                   donate_argnums=(0, 1))
    flops_per_step = train_step_flops(cfg, args.batch_size, args.image_size)

    def call():
        return step(model, opt, images, labels)

    # The eager first step, then (graphed on the card) the capture and
    # its first replay.
    t0 = time.perf_counter()
    for _ in range(2 if on_card and not args.eager else 1):
        loss = call()
    loss.item()
    compile_s = time.perf_counter() - t0
    print(f"compile: {compile_s:.1f}s", file=sys.stderr)

    timer = ledger = None
    if telemetry.enabled():
        ledger = telemetry.GoodputLedger(already_elapsed=compile_s)
        ledger.charge("recompile", compile_s)
        timer = telemetry.StepTimer(examples_per_step=args.batch_size,
                                    flops_per_step=flops_per_step,
                                    device_kind=kind)

    # Every timed region ends with a host fetch of the loss, which
    # depends on the last step.
    t0 = time.perf_counter()
    for _ in range(args.num_warmup):
        loss = call()
    loss.item()
    print(f"warmup: {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    # Chaos-audit mode (the reference's bench.py:1037-1062): with
    # HVDT_FAULT_PLAN set, the step loop carries the 'step' injection
    # point and a preemption guard, and the JSON reports how many
    # injected faults the loop absorbed.  Without a plan this is a no-op
    # (inj is None).
    from .resilience import faults
    from .resilience.preempt import PreemptionGuard

    inj = faults.get_injector()
    recovered_faults = 0
    guard = PreemptionGuard().install() if inj is not None else None

    rates = []
    steps_per_iter = args.num_batches_per_iter * args.steps_per_call
    step_idx = 0
    for _ in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
            if inj is not None:
                step_idx += 1
                try:
                    inj.fire("step", step=step_idx)
                except faults.InjectedFault as e:
                    print(f"bench: recovered injected fault: {e}",
                          file=sys.stderr)
                    recovered_faults += 1
                guard.check(step=step_idx)
            loss = call()
        final_loss = loss.item()
        dt = time.perf_counter() - t0
        rates.append(args.batch_size * steps_per_iter / dt)
        if timer is not None:
            for _ in range(steps_per_iter):
                timer.observe(dt / steps_per_iter)

    value = statistics.fmean(rates)
    peak, _ = telemetry.peak_flops_for(kind)
    mfu = (value / args.batch_size) * flops_per_step / peak if peak else None
    assert mfu is None or mfu <= 1.0, (
        f"measured MFU {mfu:.2f} > 1 is physically impossible — timing did "
        "not wait for the device")
    print(f"img/sec per iter: {rates} (+-{statistics.pstdev(rates):.3f}); "
          f"final loss {final_loss:.3f}; flops/step {flops_per_step:.4e}",
          file=sys.stderr)
    doc = {
        "metric": METRIC,
        "value": round(value, 2),
        "unit": UNIT,
        "vs_baseline": round(value / BASELINE_IMG_S_PER_DEVICE, 3),
        "platform": platform,
        "device_kind": kind,
        "mfu": round(mfu, 4) if mfu is not None else None,
        # The reference's XPlane-profiled bandwidth share is not ported.
        "hbm_util": None,
        "hbm_util_method": None,
        "batch_size": args.batch_size,
        "compile_s": round(compile_s, 2),
        "flops_per_step": flops_per_step,
        **({"fused_optimizer": True} if args.fused_optimizer else {}),
        **({"steps_per_call": args.steps_per_call}
           if args.steps_per_call != 1 else {}),
        **({"eager": True} if args.eager else {}),
        **(_overlap_doc() if args.overlap else {}),
        **(_transport_doc(args.transport) if args.transport else {}),
        **(_fp8_doc(device) if args.fp8 else {}),
        **(_zero_doc(args, opt, model) if args.zero else {}),
        **(_ckpt_stall_doc(model) if args.ckpt_stall else {}),
        **({"remat": args.remat} if args.remat else {}),
        **({"telemetry": _telemetry_doc(timer, ledger)}
           if timer is not None else {}),
        **({"fault_plan": os.environ.get("HVDT_FAULT_PLAN", ""),
            "recovered_faults": recovered_faults,
            "injected_faults": inj.fired_total(),
            "emergency_checkpoints": PreemptionGuard.emergency_checkpoints}
           if inj is not None else {}),
    }
    if guard is not None:
        guard.uninstall()
    return Leg(doc, rates, call)


def _zero_doc(args, opt, model) -> dict:
    """The --zero leg's JSON fields (the reference's keys): the stage
    and a rank's memory after sharding.  The state is this rank's rows
    under states/params; under grads the wrapped optimizer's whole
    state."""
    from .telemetry import tree_bytes

    params = list(model.parameters())
    param_bytes = tree_bytes(params)
    if args.zero == "grads":
        from .common.process_sets import global_process_set

        n = global_process_set().size()
        opt_bytes = tree_bytes([v for st in opt.optimizer.state.values()
                                for v in st.values()])
    else:
        n = opt.transform.plan_for(params).num_shards
        opt_bytes = tree_bytes(opt.zero_state)
        if args.zero == "params":
            param_bytes = tree_bytes(opt.pshards)
    return {"zero_stage": args.zero, "zero_num_shards": int(n),
            "optimizer_state_bytes": int(opt_bytes),
            "param_bytes": int(param_bytes)}


def _ckpt_stall_doc(model) -> dict:
    """The --ckpt-stall leg: the step loop's stall for one commit of the
    trained state, ``CheckpointManager.save`` against ``save_async``
    (the caller's side: the device-to-host snapshot); the async write is
    drained before the directory is removed.  A failure raises."""
    import shutil
    import tempfile

    from .checkpoint import CheckpointManager

    out = {}
    tree = model.state_dict()
    root = tempfile.mkdtemp(prefix="hvdt-ckpt-stall-")
    prev = os.environ.pop("HVDT_ASYNC_CKPT", None)
    try:
        mgr = CheckpointManager(os.path.join(root, "sync"))
        t0 = time.perf_counter()
        mgr.save(1, tree, force=True)
        out["sync"] = round((time.perf_counter() - t0) * 1e3, 2)
        os.environ["HVDT_ASYNC_CKPT"] = "1"
        amgr = CheckpointManager(os.path.join(root, "async"))
        t0 = time.perf_counter()
        amgr.save_async(1, tree, force=True)
        out["async"] = round((time.perf_counter() - t0) * 1e3, 2)
        if not amgr.wait_for_async(120):
            raise RuntimeError("the async checkpoint write did not finish "
                               "within 120 s")
        amgr.close()
        if amgr.last_good_step() != 1:
            raise RuntimeError("the async checkpoint write failed")
    finally:
        if prev is None:
            os.environ.pop("HVDT_ASYNC_CKPT", None)
        else:
            os.environ["HVDT_ASYNC_CKPT"] = prev
        shutil.rmtree(root, ignore_errors=True)
    return {"checkpoint_stall_ms": out}


def _overlap_doc() -> dict:
    """The --overlap leg's JSON fields (the reference's keys): the
    byte-weighted overlap fraction and the last bucket plan."""
    from .ops import overlap

    fraction = overlap.overlap_fraction()
    return {"overlap": True,
            "overlap_fraction": (round(fraction, 4)
                                 if fraction is not None else None),
            "overlap_schedule": overlap.last_schedule()}


def _telemetry_doc(timer, ledger) -> dict:
    """The telemetry doc (``HVDT_TELEMETRY``): the StepTimer snapshot,
    the goodput fraction, and the reference's forensics handles — the
    exporter's port, where the span dump landed (``HVDT_TRACE_DIR``)
    and how many events the flight recorder holds."""
    from .telemetry import exporter, flight_recorder, trace

    doc = {**timer.snapshot(), "goodput_fraction": round(ledger.fraction(),
                                                         4)}
    exp = exporter.get_exporter()
    if exp is not None:
        doc["metrics_port"] = exp.port
    if trace.get_tracer() is not None:
        doc["trace_file"] = trace.flush(publish=False)
    fr = flight_recorder.get_flight_recorder()
    if fr is not None:
        doc["flight_recorder_events"] = len(fr.events())
    return doc


def _transport_doc(spec: str) -> dict:
    """The --transport leg's JSON fields: the policy, what it resolves
    to for the step's reduce group, and (telemetry on) the per-axis
    ``hvdt_wire_bytes_total`` counters, keyed as the reference keys
    them."""
    import dataclasses as dc

    from .ops import device as dev
    from .telemetry.instrument import get_recorder
    from .transport import get_policy

    pol = get_policy()
    res, _ = dev.resolve_transport()
    doc = {"transport": spec,
           "transport_policy": pol.describe() if pol else None,
           "transport_resolved": dc.asdict(res) if res else None}
    rec = get_recorder()
    if rec is not None:
        wb = rec.registry.get("hvdt_wire_bytes_total")
        if wb is not None:
            doc["wire_bytes_by_axis"] = {
                ",".join(f"{k}={v}" for k, v in key): val
                for key, val in sorted(wb._values.items())}
    return doc


def _fp8_doc(device) -> dict:
    """The --fp8 leg's JSON fields: the gate and probe state and a
    matmul microbench, ``fp8_matmul`` (x bf16, w f32, as the LM's
    projections call it) against the bf16 ``torch.matmul``."""
    import torch

    from .quant import fp8

    doc = {"fp8": {"mode": fp8.fp8_mode(), "available": fp8.fp8_available(),
                   "engaged": fp8.matmul_enabled()}}
    m, k, n = FP8_SHAPE["cuda" if device.type == "cuda" else "cpu"]
    gen = torch.Generator(device=device).manual_seed(3)
    x = torch.randn((m, k), generator=gen, device=device,
                    dtype=torch.bfloat16)
    w = torch.randn((k, n), generator=gen, device=device) * 0.02
    w16 = w.to(torch.bfloat16)
    doc["fp8"]["shape_mkn"] = [m, k, n]
    for key, fn in (("fp8_matmul_us", lambda: fp8.fp8_matmul(x, w)),
                    ("bf16_matmul_us", lambda: x @ w16)):
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(10):
            out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        doc["fp8"][key] = round((time.perf_counter() - t0) / 10 * 1e6, 1)
        assert torch.isfinite(out).all()
    return doc


def _sweep_world(args):
    """(device, hvd) for the --moe / --pipeline sweeps: the initialised
    world, on the card unless ``--device`` names another device."""
    import horovod_tpu_torch as hvd

    from .common.basics import resolve_device

    device = resolve_device(args.device)
    if not hvd.is_initialized():
        hvd.init(device=device)
    return device, hvd


def _slowest_rank(seconds: float) -> float:
    """The largest of every rank's ``seconds``."""
    import torch
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return seconds
    t = torch.tensor([seconds], dtype=torch.float64)
    if dist.get_backend() == "nccl":
        t = t.cuda()
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def _timed(fn, iters: int, warmup: int) -> float:
    """The least seconds of one call of ``fn`` (which ends with a host
    fetch) over ``iters`` timed calls after ``warmup``, the slowest
    rank's."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return _slowest_rank(min(times))


def _sweep_doc(device, doc: dict, args) -> dict:
    import torch

    on_card = device.type == "cuda"
    doc.update(platform="gpu" if on_card else device.type,
               device_kind=(torch.cuda.get_device_name(device) if on_card
                            else device.type))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(doc, f, indent=1)
    return doc


def run_moe_bench(args) -> dict:
    """--moe: the capacity-factor sweep (module docstring); the
    reference's ``_run_moe_bench`` with the world as ``ep``."""
    import torch

    from .autotune import ParameterManager
    from .parallel.moe import (_wire, a2a_wire_bytes, moe_capacity,
                               moe_dispatch_combine)

    device, hvd = _sweep_world(args)
    n, r = hvd.size(), hvd.rank()
    tok, dim = MOE_SHAPE["cuda" if device.type == "cuda" else "cpu"]
    n_experts = n                       # one expert a rank
    x = torch.randn((tok, dim), device=device, generator=torch.Generator(
        device=device).manual_seed(1 + r))
    # A skewed router: realistic imbalance, so low capacity factors drop
    # tokens and the sweep prices the trade.
    rw = torch.randn((dim, n_experts), device=device,
                     generator=torch.Generator(device=device).manual_seed(0)
                     ) * 2.0
    iters, warmup = max(3, args.num_iters), max(1, args.num_warmup)
    rows = []
    for cf in ParameterManager.MOE_CAPACITY_CANDIDATES:
        dropped = [0.0]

        def run_and_wait():
            y, aux = moe_dispatch_combine(
                x, x @ rw, lambda blk: blk * 2.0, experts_per_rank=1,
                capacity_factor=cf, top_k=1)
            float(y[..., :1].sum())
            dropped[0] = float(aux.dropped_fraction)

        secs = _timed(run_and_wait, iters, warmup)
        cap = moe_capacity(tok, n_experts, top_k=1, capacity_factor=cf)
        tps = n * tok / secs
        rows.append({
            "capacity_factor": cf,
            "capacity": cap,
            "seconds": secs,
            "tokens_per_s": round(tps, 1),
            "dropped_fraction": round(dropped[0], 6),
            "goodput_tokens_per_s": round(tps * (1.0 - dropped[0]), 1),
            # bytes one rank puts on the wire a step: the [ep, 1, cap,
            # dim] dispatch block out and the combine back
            "a2a_wire_bytes": 2 * a2a_wire_bytes((n, 1, cap, dim),
                                                 x.dtype, _wire("ep")),
        })
        print(f"capacity_factor {cf:>4}  cap {cap:>5}  {secs*1e3:>8.2f}ms  "
              f"dropped {dropped[0]:>7.4f}  goodput "
              f"{rows[-1]['goodput_tokens_per_s']:>10.1f} tok/s",
              file=sys.stderr)
    peak = max(rows, key=lambda row: row["goodput_tokens_per_s"])
    return _sweep_doc(device, {
        "metric": "moe_capacity_sweep",
        "value": peak["goodput_tokens_per_s"],
        "unit": "goodput_tokens_per_s",
        "n_devices": n,
        "experts": n_experts,
        "tokens_per_rank": tok,
        "d_model": dim,
        "capacity_factor_at_peak": peak["capacity_factor"],
        "dropped_fraction": peak["dropped_fraction"],
        "a2a_wire_bytes": peak["a2a_wire_bytes"],
        "rows": rows,
    }, args)


def run_pipeline_bench(args) -> dict:
    """--pipeline: the microbatch-count sweep (module docstring); the
    reference's ``_run_pipeline_bench`` with the world as ``pp``."""
    import torch

    from .autotune import ParameterManager
    from .parallel.pipeline import bubble_fraction, pipeline_1f1b

    device, hvd = _sweep_world(args)
    p, r = hvd.size(), hvd.rank()
    total, dim = PIPELINE_SHAPE["cuda" if device.type == "cuda" else "cpu"]
    w = torch.randn((dim, dim), device=device, generator=torch.Generator(
        device=device).manual_seed(1 + r)) * dim ** -0.5
    iters, warmup = max(3, args.num_iters), max(1, args.num_warmup)

    def time_step(m, mb):
        mbs = torch.randn((m, mb, dim), device=device,
                          generator=torch.Generator(device=device)
                          .manual_seed(2))

        def run_and_wait():
            with torch.no_grad():
                out = pipeline_1f1b(lambda wl, xb: torch.tanh(xb @ wl), w,
                                    mbs)
            float(out[..., :1].sum())

        return _timed(run_and_wait, iters, warmup)

    rows = []
    for lg in ParameterManager.PIPELINE_LOG2_MICROBATCH_CANDIDATES:
        m = int(round(2 ** lg))
        mb = max(1, total // m)
        t_m = time_step(m, mb)
        t_2m = time_step(2 * m, mb)
        tick = max(0.0, (t_2m - t_m) / m)
        observed = min(1.0, max(0.0, (t_m - m * tick) / t_m))
        priced = bubble_fraction(p, m)
        rows.append({
            "microbatches": m,
            "microbatch_rows": mb,
            "seconds": t_m,
            "tokens_per_s": round(m * mb / t_m, 1),
            "tick_seconds": tick,
            "bubble_fraction_priced": round(priced, 4),
            "bubble_fraction_observed": round(observed, 4),
        })
        print(f"microbatches {m:>3}  {t_m*1e3:>8.2f}ms  "
              f"{rows[-1]['tokens_per_s']:>10.1f} rows/s  bubble priced "
              f"{priced:.3f} observed {observed:.3f}", file=sys.stderr)
    peak = max(rows, key=lambda row: row["tokens_per_s"])
    return _sweep_doc(device, {
        "metric": "pipeline_microbatch_sweep",
        "value": peak["tokens_per_s"],
        "unit": "tokens_per_s",
        "n_devices": p,
        "stages": p,
        "d_model": dim,
        "microbatches_at_peak": peak["microbatches"],
        "bubble_fraction_priced": peak["bubble_fraction_priced"],
        "bubble_fraction_observed": peak["bubble_fraction_observed"],
        "rows": rows,
    }, args)


SERVE_SIZES = (784, 256, 128, 10)
SERVE_BUCKETS = (1, 8, 32)


def run_serve_bench(args) -> dict:
    """The serving leg: an in-process ModelServer over the MLP, N
    concurrent HTTP clients firing 1-4 row batches for
    ``--serve-duration`` seconds; the serving SLO metrics as a dict."""
    import http.client
    import threading

    import numpy as np
    import torch

    from .common.basics import resolve_device
    from .models.mlp import mlp_apply, mlp_init
    from .serve import InferenceEngine, ModelServer

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if on_card else device.type
    platform = "gpu" if on_card else device.type
    print(f"serve bench on {platform}:{kind}", file=sys.stderr)
    params = mlp_init(0, SERVE_SIZES, device=device)
    engine = InferenceEngine(mlp_apply, params, buckets=SERVE_BUCKETS)
    server = ModelServer(engine, host="127.0.0.1", port=0,
                         max_delay_ms=2.0, max_queue_depth=4096)
    port = server.start()
    engine.warmup((SERVE_SIZES[0],))
    warm_compiles = engine.compile_count()

    stop = threading.Event()
    counts = [0] * args.serve_threads
    errors = [0] * args.serve_threads

    def client(i):
        rng = np.random.default_rng(i)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        while not stop.is_set():
            rows = 1 + (i + counts[i]) % 4
            x = rng.normal(size=(rows, SERVE_SIZES[0])).astype(np.float32)
            try:
                conn.request("POST", "/predict",
                             json.dumps({"inputs": x.tolist()}),
                             {"Content-Type": "application/json"})
                r = conn.getresponse()
                r.read()
                if r.status == 200:
                    counts[i] += 1
                else:
                    errors[i] += 1
            except Exception:
                errors[i] += 1
                conn.close()
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=30)
        conn.close()

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(args.serve_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(args.serve_duration)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    dt = time.perf_counter() - t0
    pct = server.metrics.summary(
        "serve_request_latency_ms_predict").percentiles()
    ok = sum(counts)
    server.stop()
    return {
        "metric": "serve_throughput_rps",
        "value": round(ok / dt, 2),
        "unit": "req/s",
        "throughput_rps": round(ok / dt, 2),
        "latency_p50_ms": (round(pct[0.5], 3)
                           if pct[0.5] is not None else None),
        "latency_p99_ms": (round(pct[0.99], 3)
                           if pct[0.99] is not None else None),
        "requests_ok": ok,
        "requests_failed": sum(errors),
        "clients": args.serve_threads,
        "duration_s": round(dt, 2),
        "buckets": list(SERVE_BUCKETS),
        "steady_state_compiles": engine.compile_count() - warm_compiles,
        "platform": platform,
        "device_kind": kind,
    }


def _spawn(child_args: List[str], timeout_s: int):
    """Run the measurement in a child; (ok, json_line or None, note)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.bench", "--_child",
           *child_args]
    try:
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=timeout_s, cwd=_ROOT)
    except subprocess.TimeoutExpired:
        return False, None, f"child timed out after {timeout_s}s"
    sys.stderr.write(proc.stderr[-4000:])
    for line in reversed(proc.stdout.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                json.loads(line)
            except ValueError:
                continue
            return proc.returncode == 0, line, ""
    tail = (proc.stderr or proc.stdout or "")[-600:]
    return False, None, f"child rc={proc.returncode}: {tail}"


def main(argv=None) -> int:
    args = _parse_args(argv)
    _refuse_unported(args)
    if args.moe or args.pipeline:
        import horovod_tpu_torch as hvd

        doc = (run_moe_bench if args.moe else run_pipeline_bench)(args)
        if hvd.rank() == 0:
            print(json.dumps(doc))
        return 0
    if args._child:
        doc = run_serve_bench(args) if args.serve else measure(args).doc
        print(json.dumps(doc))
        return 0

    child_args = ["--batch-size", str(args.batch_size),
                  "--image-size", str(args.image_size),
                  "--num-iters", str(args.num_iters),
                  "--num-batches-per-iter", str(args.num_batches_per_iter),
                  "--num-warmup", str(args.num_warmup),
                  "--steps-per-call", str(args.steps_per_call)] \
        + (["--fused-optimizer"] if args.fused_optimizer else []) \
        + (["--eager"] if args.eager else []) \
        + (["--overlap"] if args.overlap else []) \
        + (["--transport", args.transport] if args.transport else []) \
        + (["--fp8"] if args.fp8 else []) \
        + (["--zero", args.zero] if args.zero else []) \
        + (["--ckpt-stall"] if args.ckpt_stall else []) \
        + (["--remat", args.remat] if args.remat else []) \
        + (["--serve", "--serve-duration", str(args.serve_duration),
            "--serve-threads", str(args.serve_threads)]
           if args.serve else []) \
        + (["--device", args.device] if args.device else [])
    if args.device == "cpu":      # asked for: one attempt there
        timeouts = [int(os.environ.get("HVDT_BENCH_CPU_TIMEOUT", "600"))]
    else:
        timeouts = [int(t) for t in os.environ.get(
            "HVDT_BENCH_ATTEMPT_TIMEOUTS", "420,300,300").split(",")]
    sleep_s = int(os.environ.get("HVDT_BENCH_ATTEMPT_SLEEP", "150"))
    notes = []
    for i, timeout_s in enumerate(timeouts):
        ok, line, note = _spawn(child_args, timeout_s)
        if ok and line:
            _save_last_good(line)
            print(line)
            return 0
        notes.append(f"attempt{i}: {note}")
        print(f"bench attempt {i} failed: {note}", file=sys.stderr)
        if i + 1 < len(timeouts):
            time.sleep(sleep_s)

    # No fallback: the headline is 0.0 with the error; a cached card run
    # rides along only as a stale sub-record.
    out = {"metric": METRIC, "value": 0.0, "unit": UNIT, "vs_baseline": 0.0,
           "platform": None, "device_kind": None, "mfu": None,
           "hbm_util": None, "hbm_util_method": None,
           "error": "; ".join(notes)[-1500:]}
    last_good = _load_last_good()
    if last_good:
        try:
            age_s = time.time() - calendar.timegm(time.strptime(
                last_good["measured_at"], "%Y-%m-%dT%H:%M:%SZ"))
            age = round(age_s / 3600.0, 1)
        except (KeyError, TypeError, ValueError, OverflowError):
            age = None
        out["last_good"] = {**last_good, "stale": True, "age_hours": age}
    print(json.dumps(out))
    return 1


if __name__ == "__main__":
    sys.exit(main())
