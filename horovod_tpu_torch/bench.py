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
    "zero": "exchange scheduling (ZeRO, checkpoint)",
    "ckpt_stall": "exchange scheduling (ZeRO, checkpoint)",
    "remat": "parallel axes",
    "moe": "parallel axes", "pipeline": "parallel axes",
    "serve": "serving", "serve_llm": "serving",
    "controller": "control, analysis and the edges",
    "fleet": "control, analysis and the edges",
    "report": "control, analysis and the edges",
}
# Keys of a JSON line that mark a variant, never the headline.
_VARIANTS = ("fused_optimizer", "steps_per_call", "eager", "telemetry",
             "overlap", "transport", "fp8")
# The fp8 microbench: a bert-large projection (d_model 1024, d_ff 4096)
# over 8192 tokens on the card; a small one on the CPU.
FP8_SHAPE = {"cuda": (8192, 1024, 4096), "cpu": (64, 128, 256)}


def _save_last_good(line: str) -> None:
    """Keep a card run of the default leg as the last good one."""
    try:
        d = json.loads(line)
        if d.get("platform") != "gpu" or any(d.get(k) for k in _VARIANTS):
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
    for flag in ("ckpt-stall", "serve", "serve-llm",
                 "report", "controller", "moe", "pipeline"):
        ap.add_argument(f"--{flag}", action="store_true",
                        help="not ported yet (raises)")
    for flag in ("zero", "remat", "fleet"):
        ap.add_argument(f"--{flag}", default="",
                        help="not ported yet (raises)")
    ap.add_argument("--_child", action="store_true", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


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
    if args.overlap or args.transport:
        # The exchange legs: a world of one process, so the step has the
        # gradient exchange the headline leg leaves out.
        import horovod_tpu_torch as hvd

        hvd.init(device=device)
        opt = hvd.DistributedOptimizer(opt)
        print(f"exchange leg: HVDT_OVERLAP="
              f"{os.environ.get('HVDT_OVERLAP')!r} HVDT_TRANSPORT="
              f"{os.environ.get('HVDT_TRANSPORT')!r} threshold "
              f"{os.environ.get('HVDT_FUSION_THRESHOLD')}", file=sys.stderr)

    def step_fn(model, opt, images, labels):
        for _ in range(args.steps_per_call):
            opt.zero_grad(set_to_none=True)
            loss, _ = resnet_loss(model, images, labels)
            loss.backward()
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

    rates = []
    steps_per_iter = args.num_batches_per_iter * args.steps_per_call
    for _ in range(args.num_iters):
        t0 = time.perf_counter()
        for _ in range(args.num_batches_per_iter):
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
        **({"telemetry": {**timer.snapshot(),
                          "goodput_fraction": round(ledger.fraction(), 4)}}
           if timer is not None else {}),
    }
    return Leg(doc, rates, call)


def _overlap_doc() -> dict:
    """The --overlap leg's JSON fields (the reference's keys): the
    byte-weighted overlap fraction and the last bucket plan."""
    from .ops import overlap

    fraction = overlap.overlap_fraction()
    return {"overlap": True,
            "overlap_fraction": (round(fraction, 4)
                                 if fraction is not None else None),
            "overlap_schedule": overlap.last_schedule()}


def _transport_doc(spec: str) -> dict:
    """The --transport leg's JSON fields: the policy and what it resolves
    to for the step's reduce group.  The reference's per-axis wire-byte
    counters come with the telemetry recorder (ROADMAP Queue 1 item 6)."""
    import dataclasses as dc

    from .ops import device as dev
    from .transport import get_policy

    pol = get_policy()
    res, _ = dev.resolve_transport()
    return {"transport": spec,
            "transport_policy": pol.describe() if pol else None,
            "transport_resolved": dc.asdict(res) if res else None}


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
    if args._child:
        print(json.dumps(measure(args).doc))
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
