#!/usr/bin/env python3
"""Smoke run of the PyTorch port (horovod_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (CUDA_HOME or /usr/local/cuda).
Phases, one JSON line each:

1. device  — the card's name and power limit (nvidia-smi);
2. build   — nvcc builds every CUDA kernel source of the package;
3. kernel  — each hand-written kernel against its plain PyTorch version
   on the card, at the shapes ResNet-50 at batch 64 gives it, with its
   time, the plain version's, the least time the card could take
   (bound) and one PyTorch library call's (timed only, never used by
   the port): the conv kernels (#3, #4) at the 9 shapes of the 26 fused
   convs, timed on the device alone beside torch.matmul timed the same
   way, with the host's enqueue, s1/s2 bit-identical across calls
   (kernel_total lines: sums over the 26 convs, with registers and
   spills); the optimizer kernels (#1, #2) as the train step calls
   them, one FusedAdam / FusedSGD step over the 161 leaves, held
   bit-identical to use_kernels=False, with the step's device and host
   times;
4. train   — full-width ResNet-50 (1000 classes, 224x224, bf16 compute,
   f32 params, batch 64) in an NCCL world of one, broadcast_parameters,
   HVDT_FUSED_CONV1X1=1, DistributedOptimizer(fused_sgd(0.01, momentum
   0.9)), 3 steps: the fused conv-stats kernel must launch 26 times a
   step and the SGD kernel every step;
5. eval    — one eval forward through the fused conv+affine kernel (26
   launches), held against the unfused forward on the same card;
6. adam    — 2 steps with DistributedOptimizer(fused_adam(1e-3));
7. quant_kernel — the four int8/int4 quantize/dequantize kernels against
   their plain versions on the card at each fused-bucket size of the
   ResNet-50 gradients (64 MiB threshold, padded to whole 256-element
   blocks): payload, scales and dequantized values bit-identical; each
   timed on the device alone, by the host's enqueue and back to back
   (quant_kernel_total lines: sums over the buckets);
8. int8    — 3 train steps under quant.with_error_feedback(
   DistributedOptimizer(fused_sgd(...), compression=Compression.int8)):
   the int8 quantize/dequantize kernels launch exactly as often as the
   leaf count and the bucket plan say, and one exchange of the same
   gradients gives the same bytes with HVDT_QUANT_KERNELS=off; then the
   step time against the uncompressed wire in turns, and host times of
   error feedback and of one exchange over each wire;
9. int4    — 2 steps with compression left unset and HVDT_COMPRESSION=
   int4 (Compression.from_env), with_error_feedback(..., wire="int4");
10. flash_kernel — the three flash-attention kernels (#9 forward, #10
   dQ, #11 dK/dV) against their plain versions at the LM path's shape
   (B 16, H 16, L 4096, D 64, bf16, causal), with
   scaled_dot_product_attention's forward and backward as the library
   yardstick, each line with its fraction of the bound and the kernel's
   registers and spills from the build log (#11's line adds pair_ms,
   #10 + #11, and pair_over_library, the pair over SDPA's backward);
   then one GQA case (Hkv 4), one offset case of flash_block_update, and
   a ragged one (L 1000, Hkv 4, offsets and a carry, the rows that see no
   key passed through bit for bit; then flash_grad_block at the same
   offsets against the plain versions of #10 and #11);
11. lm_train — the bert-large transformer LM preset at full width and
   depth (24 x 1024, 16 heads, d_ff 4096, vocab 30528, bf16 compute, f32
   params, remat full, loss_chunk 8192) at seq 4096, batch 16, through
   init, broadcast_parameters and DistributedOptimizer(fused_adam(3e-4,
   weight_decay=1e-4)), HVDT_FLASH_ATTENTION unset (the auto gate must
   engage) and HVDT_FLASH_BWD=kernel, 3 steps: per step #9 launches 48
   times (forward and remat recompute), #10 and #11 24 times each;
12. lm_bwd_default — 2 steps with HVDT_FLASH_BWD unset (the plain
   blockwise backward); the first step's gradients are held against the
   kernel backward's from the same state;
13. smallseq_kernel — the two whole-sequence kernels (#12 forward, #13
   backward, two launches a call) against their plain versions at the
   seq-512 LM path's shape (B 128, H 16, L 512, D 64, bf16, causal), each
   timed on the device alone and back to back beside
   scaled_dot_product_attention's forward and backward timed the same
   ways (fraction of the bound, registers and spills of each CUDA kernel;
   #13's line adds its design's byte floor and, from torch.profiler, its
   launches a call and each one's device time); then GQA (Hkv 4), D 128,
   non-causal, fp16 and ragged (L 200) cases;
14. lm_smallseq — the same bert-large preset at seq 512, batch 128, full
   width and depth, HVDT_FLASH_SMALLSEQ=on (HVDT_FLASH_ATTENTION and
   HVDT_FLASH_SMALLSEQ_HB unset), fused_adam(3e-4, weight_decay=1e-4), 3
   steps: per step #12 launches 48 times (forward and remat recompute),
   #13 24 times and #9-#11 never (and in every train phase the optimizer
   kernel exactly once a step);
15. lm_smallseq_default — 2 steps with HVDT_FLASH_SMALLSEQ unset (the
   materialized-score attention: 2.1 GB of f32 scores stays under the 4
   GiB flash gate); the first step's gradients are held against the
   smallseq path's from the same state, and no attention kernel runs;
16. bench — the port's bench leg (horovod_tpu_torch.bench, ResNet-50 at
   224x224, batch 128, bf16 compute, f32 params, 3 iterations of 20
   steps each) in turns: G (--fused-optimizer, HVDT_FUSED_CONV1X1=1,
   the step captured as one CUDA graph by donated_step), E (the same
   step eagerly), E, G, D (the default leg: torch.optim.SGD, unfused
   convs, graphed), each with img/s, MFU, the per-iteration rates and
   their spread, compile_s and peak memory; torch.profiler over 5 steady
   steps of G and of E (the device's busy and idle share, the top
   kernels; a graphed step must launch #4 26 times and #2 once, counted
   by kernel name); #4 against its plain version at the 9 shapes of the
   leg's 26 fused convs (batch 128), as in phase 2; then 3 graphed
   against 3 eager steps of two copies
   from one state under DistributedOptimizer in the NCCL world of one,
   with fused_sgd and then fused_adam and deterministic cuDNN: losses,
   parameters, BN statistics and optimizer state bit-identical;
17. optim_lm — #1 as the LM steps call it, one FusedAdam(3e-4,
   weight_decay=1e-4) step over clones of the bert-large leaves (11
   leaves, 434.0M parameters), held bit-identical to the plain version,
   beside torch.optim.AdamW(fused=True);
18. summary — total wall time, then the kernels line (13 kernels).

Any failure raises and the script exits non-zero without the last line,
which is exactly {"ok": true, "device": {...}} on success.  Without a
card, or run from a directory without the package, it exits non-zero.
"""

import gc
import json
import math
import os
import subprocess
import sys
import time

import torch

# Published peaks of one H100 SXM (dense): bf16 tensor cores and HBM.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
BATCH, IMAGE = 64, 224


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 10, reps: int = 5, warmup: int = 3) -> float:
    """Time of one call of ``fn`` by CUDA events: the median over
    ``reps`` runs of the mean over ``iters`` back-to-back calls (one
    stray slow call moves a mean, not the median)."""
    return cuda_ms_stats(fn, iters, reps, warmup)["median"]


def _stats(times):
    times = sorted(times)
    return {"median": times[len(times) // 2], "min": times[0],
            "max": times[-1]}


def cuda_ms_stats(fn, iters: int = 10, reps: int = 5,
                  warmup: int = 3) -> dict:
    """:func:`cuda_ms` with the min and max of the reps beside the
    median."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return _stats(times)


def host_ms(fn, reps: int = 5) -> float:
    """Median host-clock time of ``fn`` in ms, each call ended by a
    synchronize (for work that is many small launches)."""
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times[1:])[reps // 2]


def device_ms_stats(fn, iters: int = 10, reps: int = 5,
                    sleep_cycles: int = 20_000_000) -> dict:
    """Device time of one call of ``fn``: ``iters`` calls queued behind a
    device sleep of ``sleep_cycles`` clocks (~10 ms), long enough for the
    host to enqueue them all, so the events time the device alone and
    not the host's enqueue.  Median, min and max over ``reps``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return _stats(times)


def enqueue_ms_stats(fn, reps: int = 21) -> dict:
    """Host-clock time of one call of ``fn`` from an idle queue to its
    return, without waiting for the device: what the host spends to
    enqueue it."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return _stats(times)


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def fused_conv_shapes(batch: int, image: int):
    """(M, K, N) → count of the fused 1x1 convs in one ResNet-50 forward
    (the layers models/resnet._fused_1x1_eligible selects)."""
    from horovod_tpu_torch.models.resnet import _STAGES

    shapes = {}
    hw = image // 4                      # after the stem and the max pool
    cin = 64
    for si, (blocks, mid) in enumerate(_STAGES[50]):
        for bi in range(blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            out_hw = hw // stride
            for m, k, n in ((batch * hw * hw, cin, mid),          # conv1
                            (batch * out_hw * out_hw, mid, mid * 4)):  # conv3
                if k % 128 == 0 and n % 128 == 0:
                    shapes[(m, k, n)] = shapes.get((m, k, n), 0) + 1
            hw, cin = out_hw, mid * 4
    return shapes


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    return smi


def ptxas_of(log: str, entry: str) -> dict:
    """Registers and spill bytes of the kernel whose mangled entry name
    contains ``entry``, from a build log (``nvcc -Xptxas -v``)."""
    found, out = False, {}
    for line in log.splitlines():
        if "Compiling entry function" in line:
            found = entry in line
        elif found and "spill stores" in line:
            words = line.split()
            out["spill_store_bytes"] = int(words[words.index("spill") - 2])
            out["spill_load_bytes"] = int(words[-4])
        elif found and "registers" in line:
            words = line.split()
            out["registers"] = int(words[words.index("registers,") - 1]
                                   if "registers," in words else
                                   words[words.index("registers") - 1])
            found = False
    return out


def kernel_ptxas(name: str) -> list:
    """:func:`ptxas_of` each CUDA kernel of TPU kernel ``name`` (bf16, D 64
    for the attention kernels, the LM paths') in its library's last build
    log, one dict a CUDA kernel with its entry under ``kernel``."""
    from horovod_tpu_torch import _build

    lib, entries = KERNEL_ENTRY[name]
    log = _build.build_log(lib) or ""
    return [dict(kernel=entry, **ptxas_of(log, entry)) for entry in entries]


# TPU kernel -> (library, the mangled-name parts of its CUDA kernels).
KERNEL_ENTRY = {
    "_mm_kernel": ("conv_fused", ["mm_bn_relu_kernelI13__nv_bfloat16"]),
    "_mm_stats_kernel": ("conv_fused", ["mm_stats_kernelI13__nv_bfloat16"]),
    "_kernel": ("flash_attn", ["flash_fwd_kernelI13__nv_bfloat16Li64E"]),
    "_dq_kernel": ("flash_attn", ["flash_dq_kernelI13__nv_bfloat16Li64E"]),
    "_dkv_kernel": ("flash_attn", ["flash_dkv_kernelI13__nv_bfloat16Li64E"]),
    "_smallseq_fwd_kernel": ("flash_smallseq",
                             ["smallseq_fwd_kernelI13__nv_bfloat16Li64E"]),
    "_smallseq_bwd_kernel": ("flash_smallseq",
                             ["smallseq_dq_kernelI13__nv_bfloat16Li64E",
                              "smallseq_dkv_kernelI13__nv_bfloat16Li64E"]),
}


def phase_build():
    from horovod_tpu_torch import _build

    t0 = time.time()
    paths = _build.build_all()
    ptxas = []   # each kernel's registers and spills, under its entry name
    for name in paths:
        entry = None
        for line in (_build.build_log(name) or "").splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                ptxas.append(f"{entry}: {line.strip()}")
    emit({"phase": "build", "seconds": round(time.time() - t0, 3),
          "libraries": [str(p.name) for p in paths.values()],
          "ptxas": ptxas})


def conv_times(kernel, plain, library) -> dict:
    """One conv kernel's times at one shape: the device alone (CUDA events
    behind a device sleep; median, min, max) beside ``library`` timed the
    same way, the host's enqueue of one call, the back-to-back figure
    (CUDA events over calls queued as the host makes them, which the host
    bounds when its enqueue is the longer) and the plain version's."""
    dev = device_ms_stats(kernel, iters=20)
    lib = device_ms_stats(library, iters=20)
    host = enqueue_ms_stats(kernel)
    return {"kernel_ms": dev["median"], "kernel_ms_min": dev["min"],
            "kernel_ms_max": dev["max"], "library_ms": lib["median"],
            "library_ms_min": lib["min"], "library_ms_max": lib["max"],
            "enqueue_ms": host["median"], "back_to_back_ms": cuda_ms(kernel),
            "plain_ms": cuda_ms(plain)}


def conv_operands(gen, m, k, n):
    """Random bf16 operands of one fused 1x1 conv: a [M, K] and w [K, N],
    as the model hands the kernels w = (OIHW weight viewed [N, K]).t()."""
    dev = torch.device("cuda")
    a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((n, k), generator=gen, device=dev)
         / math.sqrt(k)).to(torch.bfloat16).t()
    return a, w


def check_mm_stats(cf, a, w):
    """#4 against its plain version on one (a, w): z within one bf16 ulp
    of the largest output (both round an f32 sum that differs only in
    summation order), the partial sums of z and z^2 within 1e-4 of the
    largest (128 f32 values, differently associated), and z, s1, s2
    bit-identical across two calls.  Returns z's error and tolerance."""
    shape = (*a.shape, w.shape[1])
    z, s1, s2 = cf.matmul_batch_stats(a, w)
    z_ref, s1_ref, s2_ref = cf._mm_stats_plain(a, w)
    again = cf.matmul_batch_stats(a, w)
    torch.cuda.synchronize()
    assert all(_bit_err(x, y) == 0.0
               for x, y in zip((z, s1, s2), again)), shape
    err = (z.float() - z_ref.float()).abs().max().item()
    tol = z_ref.float().abs().max().item() * 2.0 ** -7
    assert err <= tol, ("_mm_stats_kernel", shape, err, tol)
    for got, want in ((s1, s1_ref), (s2, s2_ref)):
        serr = (got - want).abs().max().item()
        stol = 1e-4 * want.abs().max().item()
        assert serr <= stol, ("_mm_stats_kernel sums", shape, serr, stol)
    return err, tol


def phase_conv_kernels(gen, smi):
    """#3 and #4 against their plain versions at the 9 shapes of the 26
    fused convs of a bs-64 ResNet-50 forward, each timed by
    :func:`conv_times` beside ``torch.matmul`` of the bare product; s1/s2
    (and z) must be bit-identical across calls.  Totals are summed over
    the 26 convs."""
    from horovod_tpu_torch.ops import conv_fused as cf

    summed = ("kernel_ms", "library_ms", "enqueue_ms", "back_to_back_ms",
              "plain_ms", "bound_ms")
    totals = {name: dict({key: 0.0 for key in summed}, max_abs_err=0.0,
                         bound_by={}, ptxas=kernel_ptxas(name))
              for name in ("_mm_kernel", "_mm_stats_kernel")}
    dev = torch.device("cuda")
    shapes = fused_conv_shapes(BATCH, IMAGE)
    for (m, k, n), count in sorted(shapes.items()):
        a, w = conv_operands(gen, m, k, n)
        scale = 1.0 + 0.1 * torch.randn(n, generator=gen, device=dev)
        bias = 0.1 * torch.randn(n, generator=gen, device=dev)
        flops = 2.0 * m * n * k
        io = 2.0 * (m * k + k * n + m * n)
        shape = {"shape": [m, k, n], "per_forward": count}

        # #3: relu((a @ w) * scale + bias)
        y = cf._mm_forward(a, w, scale, bias, True)
        y_ref = cf._mm_forward_plain(a, w, scale, bias, True)
        torch.cuda.synchronize()
        err = (y.float() - y_ref.float()).abs().max().item()
        # One bf16 ulp at the largest output: both round an f32 sum that
        # differs only in summation order.
        tol = y_ref.float().abs().max().item() * 2.0 ** -7
        assert err <= tol, ("_mm_kernel", (m, k, n), err, tol)
        b_ms, b_by = bound(io + 8.0 * n, flops, PEAK_BF16_FLOPS)
        row = dict(conv_times(lambda: cf._mm_forward(a, w, scale, bias, True),
                              lambda: cf._mm_forward_plain(a, w, scale, bias,
                                                           True),
                              lambda: torch.matmul(a, w)), bound_ms=b_ms)
        emit({"phase": "kernel", "name": "_mm_kernel", **shape,
              "max_abs_err": err, "tolerance": tol, "bound_by": b_by,
              "fraction_of_bound": b_ms / row["kernel_ms"], **row})
        tot = totals["_mm_kernel"]
        for key in summed:
            tot[key] += count * row[key]
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        tot["bound_by"][b_by] = tot["bound_by"].get(b_by, 0) + count
        del y, y_ref

        # #4: z = a @ w, per-BLOCK_M-row partial sums of z and z^2
        err, tol = check_mm_stats(cf, a, w)
        nb = -(-m // cf.BLOCK_M)
        b_ms, b_by = bound(io + 8.0 * nb * n, flops, PEAK_BF16_FLOPS)
        row = dict(conv_times(lambda: cf.matmul_batch_stats(a, w),
                              lambda: cf._mm_stats_plain(a, w),
                              lambda: torch.matmul(a, w)), bound_ms=b_ms)
        emit({"phase": "kernel", "name": "_mm_stats_kernel", **shape,
              "max_abs_err": err, "tolerance": tol, "bound_by": b_by,
              "fraction_of_bound": b_ms / row["kernel_ms"], **row})
        tot = totals["_mm_stats_kernel"]
        for key in summed:
            tot[key] += count * row[key]
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        tot["bound_by"][b_by] = tot["bound_by"].get(b_by, 0) + count
        del a, w
        torch.cuda.empty_cache()
    for name, tot in totals.items():
        emit({"phase": "kernel_total", "name": name,
              "convs": sum(shapes.values()),
              "fraction_of_bound": tot["bound_ms"] / tot["kernel_ms"],
              "over_library": tot["kernel_ms"] / tot["library_ms"],
              "card": smi, **tot})
    return totals


def optim_row(name, base, gen, make_opt, make_lib, bytes_per, flops_per,
              plain_iters=10):
    """#1 or #2 as a train step calls it: ``make_opt(leaves,
    use_kernels).step()`` over clones of ``base`` with random grads set,
    through the kernel and through the plain version from the same state
    (two steps, every parameter and moment held bit-identical), then
    timed: the kernel step by CUDA events back to back, by CUDA events
    behind a device sleep (the device alone) and by the host clock of
    its enqueue (median, min, max), the plain step, and ``make_lib`` (a
    torch.optim optimizer of the same function) on the same leaves."""
    from horovod_tpu_torch.ops import optim_kernels as ok

    grads = [torch.empty_like(b).normal_(generator=gen).mul_(0.01)
             for b in base]
    sides = []
    for use_kernels in (True, False):
        leaves = [b.detach().clone() for b in base]
        for q, g in zip(leaves, grads):
            q.grad = g
        opt = make_opt(leaves, use_kernels)
        before = ok._sgd_multi.launches + ok._adam_multi.launches
        for _ in range(2):
            opt.step()
        launches = ok._sgd_multi.launches + ok._adam_multi.launches - before
        assert launches == (2 if use_kernels else 0), (name, launches)
        sides.append((leaves, opt))
    torch.cuda.synchronize()
    (kl, kopt), (pl, popt) = sides
    err = 0.0
    for a, b in zip(kl, pl):
        err = max(err, _bit_err(a, b), *(
            _bit_err(kopt.state[a][k], popt.state[b][k])
            for k in kopt.state[a]))
    assert err == 0.0, (name, err)
    lib = [b.detach().clone() for b in base]
    for t, g in zip(lib, grads):
        t.grad = g
    try:
        library_ms = cuda_ms(make_lib(lib).step)
    except (RuntimeError, TypeError) as e:   # no fused form in this torch
        print(f"library optimizer unavailable: {e}", file=sys.stderr)
        library_ms = None
    n_params = sum(b.numel() for b in base)
    kern = cuda_ms_stats(kopt.step)
    dev = device_ms_stats(kopt.step)
    host = enqueue_ms_stats(kopt.step)
    b_ms, b_by = bound(float(bytes_per) * n_params,
                       float(flops_per) * n_params, PEAK_F32_FLOPS)
    row = {"kernel_ms": kern["median"], "kernel_ms_min": kern["min"],
           "kernel_ms_max": kern["max"], "device_ms": dev["median"],
           "device_ms_min": dev["min"], "device_ms_max": dev["max"],
           "host_ms": host["median"],
           "host_ms_min": host["min"], "host_ms_max": host["max"],
           "plain_ms": cuda_ms(popt.step, iters=plain_iters),
           "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
           "max_abs_err": err}
    del sides, kl, pl, kopt, popt, lib, grads
    torch.cuda.empty_cache()
    return row, n_params


def phase_optim_kernels(params, gen):
    """#2 and #1 over all ResNet-50 leaves: one FusedSGD(0.01, momentum
    0.9) / FusedAdam(1e-3) step, as the train and adam phases call it."""
    from horovod_tpu_torch.ops import optim_kernels as ok

    results = {}
    for name, make_opt, make_lib, bytes_per, flops_per in (
            ("_sgd_kernel",
             lambda ls, uk: ok.fused_sgd(ls, 0.01, momentum=0.9,
                                         use_kernels=uk),
             lambda ls: torch.optim.SGD(ls, lr=0.01, momentum=0.9,
                                        fused=True), 20, 4),
            ("_adam_kernel",
             lambda ls, uk: ok.fused_adam(ls, 1e-3, use_kernels=uk),
             lambda ls: torch.optim.Adam(ls, lr=1e-3, fused=True), 28, 12)):
        row, n_params = optim_row(name, params, gen, make_opt, make_lib,
                                  bytes_per, flops_per)
        emit({"phase": "kernel", "name": name, "leaves": len(params),
              "params": n_params, "tolerance": 0.0, **row})
        results[name] = row
    return results


def phase_optim_lm(gen, smi, shapes):
    """#1 over clones of the bert-large leaves (``shapes``): one
    FusedAdam(3e-4, weight_decay=1e-4) step as the LM phases call it,
    beside torch.optim.AdamW(fused=True), the same decoupled decay."""
    from horovod_tpu_torch.ops import optim_kernels as ok

    base = [torch.randn(s, generator=gen, device=gen.device)
            for s in shapes]
    row, n_params = optim_row(
        "_adam_kernel", base, gen,
        lambda ls, uk: ok.fused_adam(ls, 3e-4, weight_decay=1e-4,
                                     use_kernels=uk),
        lambda ls: torch.optim.AdamW(ls, lr=3e-4, weight_decay=1e-4,
                                     fused=True), 28, 12, plain_iters=3)
    emit({"phase": "optim_lm", "name": "_adam_kernel", "leaves": len(base),
          "params": n_params, "tolerance": 0.0, "card": smi, **row})
    del base
    torch.cuda.empty_cache()
    return row


QUANT_BLOCK = 256


def _bits(t):
    """A tensor's bytes as integers of its element size, for bit-identity
    checks."""
    return t.contiguous().view({1: torch.uint8, 2: torch.int16,
                                4: torch.int32}[t.element_size()])


def _bit_err(got, want) -> float:
    """0 when ``got`` and ``want`` hold the same bytes, else the largest
    absolute difference of their values."""
    assert got.shape == want.shape and got.dtype == want.dtype
    if torch.equal(_bits(got), _bits(want)):
        return 0.0
    return (got.double() - want.double()).abs().max().item() or math.inf


def phase_quant_kernels(params, gen):
    """#5-#8 against their plain versions at each fused-bucket size of
    the ResNet-50 gradients.  Tolerance 0: the max is exact and every
    other step is one IEEE f32 operation on both sides.  Each is timed on
    the device alone (``kernel_ms``: CUDA events behind a device sleep),
    by the host's enqueue of one call and back to back (which the host
    bounds at these sizes); the totals sum the bucket sizes."""
    from horovod_tpu_torch.ops import device as tdev
    from horovod_tpu_torch.quant import kernels as qk

    sizes = [sum(params[i].numel() for i in b)
             for b in tdev.fused_allreduce_buckets(params, None)]
    summed = ("kernel_ms", "enqueue_ms", "back_to_back_ms", "plain_ms",
              "bound_ms")
    totals = {name: dict({key: 0.0 for key in summed}, max_abs_err=0.0)
              for name in ("_quant_kernel", "_dequant_kernel",
                           "_quant4_kernel", "_dequant4_kernel")}
    for size in sizes:
        padded = -(-size // QUANT_BLOCK) * QUANT_BLOCK
        nb = padded // QUANT_BLOCK
        x = torch.randn(padded, generator=gen, device="cuda").mul_(1e-2)
        x[:QUANT_BLOCK] = 0.0                   # an all-zero block
        x2 = x.view(nb, QUANT_BLOCK)
        q, s = qk._quantize_cuda(x2)
        q4, s4 = qk._quantize4_cuda(x2)
        # (name, kernel call, plain call, outputs, bytes, ops)
        cases = (
            ("_quant_kernel", lambda: qk._quantize_cuda(x2),
             lambda: qk._quantize_plain(x2), 5.0 * padded + 4.0 * nb,
             5.0 * padded),
            ("_dequant_kernel", lambda: qk._dequantize_cuda(q, s),
             lambda: qk._dequantize_plain(q, s), 5.0 * padded + 4.0 * nb,
             1.0 * padded),
            ("_quant4_kernel", lambda: qk._quantize4_cuda(x2),
             lambda: qk._quantize4_plain(x2), 4.5 * padded + 4.0 * nb,
             5.0 * padded),
            ("_dequant4_kernel", lambda: qk._dequantize4_cuda(q4, s4),
             lambda: qk._dequantize4_plain(q4, s4),
             4.5 * padded + 4.0 * nb, 1.0 * padded))
        for name, kern, plain, nbytes, ops in cases:
            got, want = kern(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            err = max(_bit_err(g, w) for g, w in zip(got, want))
            assert err == 0.0, (name, size, err)
            b_ms, b_by = bound(nbytes, ops, PEAK_F32_FLOPS)
            dev = device_ms_stats(kern, iters=20)
            row = {"kernel_ms": dev["median"],
                   "enqueue_ms": enqueue_ms_stats(kern)["median"],
                   "back_to_back_ms": cuda_ms(kern),
                   "plain_ms": cuda_ms(plain), "bound_ms": b_ms}
            emit({"phase": "quant_kernel", "name": name, "elements": padded,
                  "block": QUANT_BLOCK, "max_abs_err": err, "tolerance": 0.0,
                  "bound_by": b_by, "library_ms": None,
                  "kernel_ms_min": dev["min"], "kernel_ms_max": dev["max"],
                  "fraction_of_bound": b_ms / dev["median"], **row})
            tot = totals[name]
            for key in summed:
                tot[key] += row[key]
            tot["bound_by"] = b_by
        del x, q, s, q4, s4
    for name, tot in totals.items():
        emit({"phase": "quant_kernel_total", "name": name,
              "buckets": len(sizes),
              "fraction_of_bound": tot["bound_ms"] / tot["kernel_ms"], **tot})
    return totals, sizes


# The LM path's attention shape: bert-large at seq 4096, batch 16.
LM_BATCH, LM_SEQ, LM_HEADS, LM_HEAD_DIM = 16, 4096, 16, 64


def _visible_pairs(lq: int, lk: int, q_offset: int, k_offset: int) -> int:
    """(q, k) pairs a causal pass needs: q_offset + i >= k_offset + j."""
    return sum(max(0, min(lk, q_offset + i - k_offset + 1))
               for i in range(lq))


def _flash_bounds(b, lq, lk, h, hkv, d, pairs):
    """(bound_ms, bound_by) of #9 (finished form), #10 and #11: each
    input read once, each output written once (o in bf16; dq and the
    per-q-head dk/dv in f32; lse and delta one f32 per row); 2 FLOP per
    multiply-add over the visible pairs, two products in the forward,
    three in dQ, four in dK/dV."""
    q_bytes, kv_bytes = 2.0 * b * lq * h * d, 2.0 * b * lk * hkv * d
    row = 4.0 * b * h * lq
    per_product = 2.0 * b * h * d * pairs
    return {
        "_kernel": bound(2 * q_bytes + 2 * kv_bytes + row,
                         2 * per_product, PEAK_BF16_FLOPS),
        "_dq_kernel": bound(4 * q_bytes + 2 * kv_bytes + 2 * row,
                            3 * per_product, PEAK_BF16_FLOPS),
        "_dkv_kernel": bound(2 * q_bytes + 2 * kv_bytes + 2 * row
                             + 2 * 4.0 * b * lk * h * d,
                             4 * per_product, PEAK_BF16_FLOPS),
    }


# One bf16 (fp16) ulp relative, 2^-7 (2^-10): the kernels and their plain
# versions round the same f32 quantities to 16 bits (P, dS, the outputs)
# and differ only in the order of their f32 sums, so a rounding lands one
# ulp apart now and then.  The logsumexp has no 16-bit rounding: 1e-5.
BF16_ULP, FP16_ULP, LSE_REL = 2.0 ** -7, 2.0 ** -10, 1e-5


def closeness(got, want, rel: float) -> dict:
    """How far ``got`` is from ``want``, each row against its own size.

    A row is one [D] vector (one batch, position and head) of an output
    shaped [B, L, H, D], else one value (lse, the carry's m and l).  The
    tolerance of a row is ``rel * (|want row| + rms row norm)``: its own
    L2 norm, plus the root-mean-square row norm as a floor for rows that
    are near zero (row 0 of dQ is a sum that cancels to rounding noise).
    Rows and not single elements, because an element of dQ or dK can
    cancel to near zero while its terms are large.  ``err_over_tol`` is
    the worst row's error over its tolerance: at most 1 to pass."""
    g, w = got.float(), want.float()
    diff = g - w
    if w.dim() == 4:
        err, size = diff.norm(dim=-1), w.norm(dim=-1)
    else:
        err, size = diff.abs(), w.abs()
    floor = size.square().mean().sqrt()
    worst = (err / (rel * (size + floor)).clamp_min(1e-30)).max().item()
    return {"max_abs_err": diff.abs().max().item(),
            "rel_l2": (diff.norm() / w.norm().clamp_min(1e-30)).item(),
            "rms_want": w.square().mean().sqrt().item(),
            "rel_tol": rel, "err_over_tol": worst}


def _flash_case(pk, b, lq, lk, h, hkv, gen, *, q_offset=0, k_offset=0,
                carry=False):
    """Random bf16 operands of one flash call, [B, L, H, D]."""
    d = LM_HEAD_DIM

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=gen.device).to(
            torch.bfloat16)

    case = dict(q=rnd(b, lq, h, d), k=rnd(b, lk, hkv, d),
                v=rnd(b, lk, hkv, d), do=rnd(b, lq, h, d),
                q_offset=q_offset, k_offset=k_offset, scale=d ** -0.5,
                block_q=pk._fit_block(lq, 512), block_k=pk._fit_block(lk, 512),
                block_kf=pk._fit_block(lk, 1024))
    if carry:
        case["carry"] = (
            torch.randn((b, lq, h, d), generator=gen, device=gen.device),
            torch.randn((b, h, lq), generator=gen, device=gen.device),
            1.0 + torch.rand((b, h, lq), generator=gen, device=gen.device))
    return case


def _flash_calls(pk, c):
    """{name: (kernel call, plain call)} of #9-#11 on case ``c``; the
    backward pair reads the kernel forward's (out, lse)."""
    fwd = dict(causal=True, scale=c["scale"], block_q=c["block_q"],
               block_k=c["block_kf"], finish=True)
    bwd = dict(causal=True, scale=c["scale"], block_q=c["block_q"],
               block_k=c["block_k"])
    args = (c["q"], c["k"], c["v"])
    offs = (c["q_offset"], c["k_offset"])
    out, lse = pk._flash_fwd(*args, None, *offs, **fwd)
    delta = (c["do"].float() * out.float()).sum(-1).transpose(1, 2)
    grad = (*args, c["do"], lse, delta, *offs)
    return {
        "_kernel": (lambda: pk._flash_fwd(*args, None, *offs, **fwd),
                    lambda: pk._flash_fwd_plain(*args, None, *offs, **fwd)),
        "_dq_kernel": (lambda: pk._flash_dq(*grad, **bwd),
                       lambda: pk._flash_dq_plain(*grad, **bwd)),
        "_dkv_kernel": (lambda: pk._flash_dkv(*grad, **bwd),
                        lambda: pk._flash_dkv_plain(*grad, **bwd)),
    }


def _compare(name, got, want, ulp=BF16_ULP):
    """:func:`closeness` of each of a kernel's outputs (a forward's
    logsumexp at ``LSE_REL``, the rest at ``ulp``); raises if any is out
    of tolerance."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    lse_at = 1 if name in ("_kernel", "_smallseq_fwd_kernel") else None
    outs = [closeness(g, w, LSE_REL if i == lse_at else ulp)
            for i, (g, w) in enumerate(zip(got, want))]
    assert all(o["err_over_tol"] <= 1.0 for o in outs), (name, outs)
    return outs


def _ragged_grads(pk, r):
    """:func:`closeness` of flash_grad_block's (dq, dk, dv) on case ``r``
    against the plain versions of #10 and #11 (one block of the whole
    length) and the same GQA group sum; the kernel forward gives (out,
    lse)."""
    q, k, v, do = r["q"], r["k"], r["v"], r["do"]
    offs = dict(q_offset=r["q_offset"], k_offset=r["k_offset"])
    b, lq, h, d = q.shape
    lk, hkv = k.shape[1], k.shape[2]
    out, lse = pk._flash_fwd(q, k, v, None, *offs.values(), causal=True,
                             scale=r["scale"], block_q=lq, block_k=lk,
                             finish=True)
    got = pk.flash_grad_block(q, k, v, do, out, lse, causal=True,
                              scale=r["scale"], **offs)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    args = (q, k, v, do, lse, delta, *offs.values())
    kw = dict(causal=True, scale=r["scale"], block_q=lq, block_k=lk)
    dq = pk._flash_dq_plain(*args, **kw)
    dk, dv = (x.reshape(b, lk, hkv, h // hkv, d).sum(3)
              for x in pk._flash_dkv_plain(*args, **kw))
    return [closeness(g, w, BF16_ULP) for g, w in zip(got, (dq, dk, dv))]


def phase_flash_kernels(gen, smi):
    """#9-#11 against their plain versions at the LM path's shape, timed
    beside their bounds and scaled_dot_product_attention (forward, and its
    autograd backward, which computes dQ, dK and dV together); then a GQA
    case and an offset case of flash_block_update."""
    from horovod_tpu_torch.ops import pallas_kernels as pk

    b, l, h, d = LM_BATCH, LM_SEQ, LM_HEADS, LM_HEAD_DIM
    c = _flash_case(pk, b, l, l, h, h, gen)
    calls = _flash_calls(pk, c)
    bounds = _flash_bounds(b, l, l, h, h, d, _visible_pairs(l, l, 0, 0))
    qt, kt, vt, dot = (x.transpose(1, 2) for x in
                       (c["q"], c["k"], c["v"], c["do"]))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True), iters=5)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    og = sdpa(qg, kg, vg, is_causal=True)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(og, (qg, kg, vg), dot,
                                                  retain_graph=True), iters=5)
    library = {"_kernel": lib_fwd, "_dq_kernel": lib_bwd,
               "_dkv_kernel": lib_bwd}
    rows = {}
    for name, (kern, plain) in calls.items():
        outs = _compare(name, kern(), plain())
        b_ms, b_by = bounds[name]
        rows[name] = {"kernel_ms": cuda_ms(kern, iters=5),
                      "plain_ms": cuda_ms(plain, iters=1, reps=3, warmup=1),
                      "library_ms": library[name], "bound_ms": b_ms,
                      "bound_by": b_by,
                      "max_abs_err": max(o["max_abs_err"] for o in outs)}
        extra = {}
        if name == "_dkv_kernel":  # #10 + #11 against SDPA's whole backward
            pair = rows["_dq_kernel"]["kernel_ms"] + rows[name]["kernel_ms"]
            extra = {"pair_ms": pair, "pair_over_library": pair / lib_bwd}
        ptxas = kernel_ptxas(name)
        assert all("registers" in x for x in ptxas), (name, ptxas)
        emit({"phase": "flash_kernel", "name": name,
              "shape": [b, l, h, h, d], "dtype": "bf16", "causal": True,
              "outputs": outs, "card": smi, **rows[name], **extra,
              "fraction_of_bound": b_ms / rows[name]["kernel_ms"],
              "ptxas": ptxas})
    del c, calls, qt, kt, vt, dot, qg, kg, vg, og

    # GQA (Hkv 4), and flash_block_update's offset form with a carry.
    g = _flash_case(pk, 4, l, l, h, 4, gen)
    gqa = {name: _compare(name, kern(), plain())
           for name, (kern, plain) in _flash_calls(pk, g).items()}
    o = _flash_case(pk, 4, 2048, 2048, h, h, gen, q_offset=2048,
                    k_offset=1024, carry=True)
    upd = dict(q_offset=o["q_offset"], k_offset=o["k_offset"], causal=True,
               scale=o["scale"])
    got = pk.flash_block_update(o["q"], o["k"], o["v"], *o["carry"], **upd)
    want = pk._flash_fwd_plain(o["q"], o["k"], o["v"], o["carry"],
                               o["q_offset"], o["k_offset"], causal=True,
                               scale=o["scale"], block_q=512, block_k=1024,
                               finish=False)
    # The carry's acc sums P V unnormalized, P rounded to bf16 as in the
    # forward: one bf16 ulp per row, as there; m and l are f32.
    upd = [closeness(gt, w, BF16_ULP) for gt, w in zip(got, want)]
    # Ragged: L 1000 (off the kernel's 128-row q and K/V tiles), Hkv 4,
    # k_offset 16 past q_offset so q rows 0-15 see no key and pass their
    # carry through bit for bit.
    r = _flash_case(pk, 4, 1000, 1000, h, 4, gen, q_offset=8, k_offset=24,
                    carry=True)
    rag = dict(q_offset=r["q_offset"], k_offset=r["k_offset"], causal=True,
               scale=r["scale"])
    got_r = pk.flash_block_update(r["q"], r["k"], r["v"], *r["carry"], **rag)
    want_r = pk._flash_fwd_plain(r["q"], r["k"], r["v"], r["carry"],
                                 r["q_offset"], r["k_offset"], causal=True,
                                 scale=r["scale"], block_q=1000,
                                 block_k=1000, finish=False)
    ragged = [closeness(gt, w, BF16_ULP) for gt, w in zip(got_r, want_r)]
    unseen = all(torch.equal(gt[:, :16] if gt.dim() == 4 else gt[:, :, :16],
                             c[:, :16] if c.dim() == 4 else c[:, :, :16])
                 for gt, c in zip(got_r, r["carry"]))
    # The backward of the same ragged case through flash_grad_block (#10,
    # #11 and the GQA group sum): rows 0-15 see no key (lse about -1e30).
    grads = _ragged_grads(pk, r)
    emit({"phase": "flash_kernel", "gqa": {"shape": [4, l, h, 4, d],
                                           "outputs": gqa},
          "block_update": {"shape": [4, 2048, h, h, d], "q_offset": 2048,
                           "k_offset": 1024, "outputs": upd},
          "ragged": {"shape": [4, 1000, h, 4, d], "q_offset": 8,
                     "k_offset": 24, "outputs": ragged,
                     "unseen_rows_pass_through": unseen,
                     "grad_block": grads}})
    assert all(o["err_over_tol"] <= 1.0 for o in upd), upd
    assert all(o["err_over_tol"] <= 1.0 for o in ragged), ragged
    assert all(o["err_over_tol"] <= 1.0 for o in grads), grads
    assert unseen, "rows that see no key changed their carry"
    del g, o, got, want, r, got_r, want_r
    return rows


# The whole-sequence path: bert-large at seq 512, batch 128 (the
# tools/tpu_ab.py lm_smallseq_hb8_bs128 leg).
SS_BATCH, SS_SEQ = 128, 512


def _smallseq_case(gen, b, l, h, hkv, d, dtype):
    """Random operands of one smallseq call, [B, L, H, D]."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=gen.device).to(dtype)

    return dict(q=rnd(b, l, h, d), k=rnd(b, l, hkv, d), v=rnd(b, l, hkv, d),
                do=rnd(b, l, h, d))


def _smallseq_calls(pk, c, causal):
    """{name: (kernel call, plain call)} of #12 and #13 on case ``c``; the
    backward pair reads the kernel forward's (out, lse)."""
    _, _, h, d = c["q"].shape
    kw = dict(causal=causal, scale=d ** -0.5,
              hb=pk._fit_heads_per_block(h, h // c["k"].shape[2], 8))
    args = (c["q"], c["k"], c["v"])
    out, lse = pk._smallseq_fwd(*args, **kw)
    grad = (*args, c["do"], out, lse)
    return {
        "_smallseq_fwd_kernel": (lambda: pk._smallseq_fwd(*args, **kw),
                                 lambda: pk._smallseq_fwd_plain(*args, **kw)),
        "_smallseq_bwd_kernel": (lambda: pk._smallseq_bwd(*grad, **kw),
                                 lambda: pk._smallseq_bwd_plain(*grad, **kw)),
    }


def _smallseq_bounds(b, l, h, hkv, d, causal):
    """(bound_ms, bound_by) of #12 and #13: each input read once, each
    output written once, all 16-bit but the f32 lse (one value a row);
    #12 reads q, k, v and writes o and lse, #13 reads q, k, v, dO, O and
    lse and writes dq, dk, dv.  2 FLOP per multiply-add over the (q, k)
    pairs the mask keeps: two products in the forward, five in the
    backward (q kᵀ, dO vᵀ, dV, dQ, dK)."""
    q_bytes, kv_bytes = 2.0 * b * l * h * d, 2.0 * b * l * hkv * d
    row = 4.0 * b * h * l
    pairs = l * (l + 1) // 2 if causal else l * l
    per_product = 2.0 * b * h * d * pairs
    return {
        "_smallseq_fwd_kernel": bound(2 * q_bytes + 2 * kv_bytes + row,
                                      2 * per_product, PEAK_BF16_FLOPS),
        "_smallseq_bwd_kernel": bound(4 * q_bytes + 4 * kv_bytes + row,
                                      5 * per_product, PEAK_BF16_FLOPS),
    }


def _smallseq_bwd_floor(b, l, h, hkv, d):
    """Bytes #13's two launches must move as designed, each input read once
    a launch: dQ reads q, dO, O, k and v and writes dq and delta; dK/dV
    reads k, v, q, dO, lse and delta and writes dk and dv."""
    q_bytes, kv_bytes = 2.0 * b * l * h * d, 2.0 * b * l * hkv * d
    row = 4.0 * b * h * l
    return (4 * q_bytes + 2 * kv_bytes + row) + (
        2 * q_bytes + 4 * kv_bytes + 2 * row)


def profiled_launches(fn, match, calls=5):
    """The CUDA kernels whose name contains ``match`` that one call of
    ``fn`` launches (torch.profiler over ``calls`` calls): their count a
    call and each one's mean device time in ms, or None where the
    profiler records no device activity."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if match in e.key]
    if not events:
        return None
    names = [re.search(r"(\w+)<", e.key) for e in events]
    return {"launches": sum(e.count for e in events) / calls,
            "device_ms": {(n.group(1) if n else e.key): e.device_time_total
                          / e.count / 1e3 for n, e in zip(names, events)}}


def phase_smallseq_kernels(gen, smi):
    """#12 and #13 against their plain versions at the seq-512 LM path's
    shape, each timed on the device alone (CUDA events behind a device
    sleep) and back to back, beside its bound and
    scaled_dot_product_attention timed both ways (forward for #12, its
    autograd backward for #13); #13's line adds its design's byte floor
    and its launches a call with each one's device time; then smaller
    GQA, D 128, non-causal, fp16 and ragged cases."""
    from horovod_tpu_torch.ops import pallas_kernels as pk

    b, l, h, d = SS_BATCH, SS_SEQ, LM_HEADS, LM_HEAD_DIM
    c = _smallseq_case(gen, b, l, h, h, d, torch.bfloat16)
    calls = _smallseq_calls(pk, c, True)
    bounds = _smallseq_bounds(b, l, h, h, d, True)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in
                       (c["q"], c["k"], c["v"], c["do"]))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    og = sdpa(qg, kg, vg, is_causal=True)
    library = {"_smallseq_fwd_kernel": lambda: sdpa(qt, kt, vt,
                                                    is_causal=True),
               "_smallseq_bwd_kernel": lambda: torch.autograd.grad(
                   og, (qg, kg, vg), dot, retain_graph=True)}
    rows = {}
    for name, (kern, plain) in calls.items():
        outs = _compare(name, kern(), plain())
        b_ms, b_by = bounds[name]
        dev = device_ms_stats(kern, iters=20)
        lib = device_ms_stats(library[name], iters=20)
        rows[name] = {"kernel_ms": dev["median"], "kernel_ms_min": dev["min"],
                      "kernel_ms_max": dev["max"],
                      "back_to_back_ms": cuda_ms(kern),
                      "plain_ms": cuda_ms(plain, iters=1, reps=3, warmup=1),
                      "library_ms": lib["median"],
                      "library_ms_min": lib["min"],
                      "library_ms_max": lib["max"],
                      "library_back_to_back_ms": cuda_ms(library[name]),
                      "bound_ms": b_ms, "bound_by": b_by,
                      "max_abs_err": max(o["max_abs_err"] for o in outs)}
        extra = {}
        if name == "_smallseq_bwd_kernel":
            floor = _smallseq_bwd_floor(b, l, h, h, d)
            extra = {"over_library": dev["median"] / lib["median"],
                     "design_floor_gb": floor / 1e9,
                     "design_floor_ms": floor / PEAK_BYTES * 1e3,
                     "per_call": profiled_launches(kern, "smallseq_")}
        emit({"phase": "smallseq_kernel", "name": name,
              "shape": [b, l, h, h, d], "dtype": "bf16", "causal": True,
              "outputs": outs, "card": smi, **rows[name], **extra,
              "fraction_of_bound": b_ms / rows[name]["kernel_ms"],
              "ptxas": kernel_ptxas(name)})
    del c, calls, qt, kt, vt, dot, qg, kg, vg, og

    # (B, L, H, Hkv, D, dtype, causal) of the smaller cases.
    cases = {"gqa": (16, 512, 16, 4, 64, torch.bfloat16, True),
             "d128": (16, 512, 8, 8, 128, torch.bfloat16, True),
             "noncausal": (16, 512, 16, 16, 64, torch.bfloat16, False),
             "fp16": (16, 512, 16, 16, 64, torch.float16, True),
             "ragged": (16, 200, 16, 4, 64, torch.bfloat16, True)}
    done = {}
    for label, (b2, l2, h2, hkv2, d2, dtype, causal) in cases.items():
        c2 = _smallseq_case(gen, b2, l2, h2, hkv2, d2, dtype)
        ulp = FP16_ULP if dtype == torch.float16 else BF16_ULP
        done[label] = {"shape": [b2, l2, h2, hkv2, d2], "causal": causal,
                       "dtype": str(dtype).split(".")[-1], "outputs": {
                           name: _compare(name, kern(), plain(), ulp)
                           for name, (kern, plain)
                           in _smallseq_calls(pk, c2, causal).items()}}
        del c2
    emit({"phase": "smallseq_kernel", "cases": done})
    return rows


def lm_config(seq: int = LM_SEQ):
    """The repo's bert-large preset (examples/jax_transformer_lm.py) at
    ``seq``: at 4096 the tools/tpu_ab.py lm_seq4096_fbwd_kernel
    configuration, at 512 (the preset's own length) lm_smallseq_hb8_bs128
    at batch 128."""
    from horovod_tpu_torch.models import TransformerConfig

    return TransformerConfig(vocab=30528, layers=24, d_model=1024,
                             heads=LM_HEADS, kv_heads=LM_HEADS, d_ff=4096,
                             max_seq=seq, dtype=torch.bfloat16,
                             remat=True, loss_chunk=8192)


def run_lm_steps(model, opt, tokens, cfg, steps, before_step=None,
                 after_step=None):
    """``steps`` optimizer steps, each timed on the host clock between
    synchronizes; ``before_step`` runs once, after the first backward and
    before its optimizer step, ``after_step`` after every step."""
    from horovod_tpu_torch.models import transformer_loss

    times, losses = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = transformer_loss(model, tokens, cfg)
        loss.backward()
        if before_step is not None:
            before_step()
            before_step = None
        opt.step()
        losses.append(loss.item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if after_step is not None:
            after_step()
    return times, losses


def lm_grads(model, tokens, cfg):
    """The loss's gradients from the model's current state (no step)."""
    from horovod_tpu_torch.models import transformer_loss

    model.zero_grad(set_to_none=True)
    transformer_loss(model, tokens, cfg).backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return grads


def lm_train_phase(hvd, gen, smi, phase, seq, batch, per_step):
    """Train the bert-large preset at (``seq``, ``batch``) from seed 0
    (init, broadcast_parameters, DistributedOptimizer(fused_adam(3e-4,
    weight_decay=1e-4))) for 3 steps under the knobs already set, emit the
    ``phase`` line and hold every step's launches to ``per_step`` (kernel
    name -> count).  Returns (model, opt, tokens, cfg, launches of the
    run)."""
    from horovod_tpu_torch.models import (transformer_flops_per_token,
                                          transformer_init)

    cfg = lm_config(seq)
    model = transformer_init(0, cfg, device=gen.device)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        hvd.fused_adam(model.parameters(), 3e-4, weight_decay=1e-4))
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                           device=gen.device)
    tokens_per_step = batch * seq
    flops_per_token = transformer_flops_per_token(cfg)
    steps = 3
    steps_launches = []

    def count_step():
        total = counters()
        done = {n: sum(s[n] for s in steps_launches) for n in total}
        steps_launches.append({n: total[n] - done[n] for n in total})

    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    times, losses = run_lm_steps(model, opt, tokens, cfg, steps,
                                 after_step=count_step)
    launches = counters()
    steady = sorted(times[1:])[len(times[1:]) // 2]
    emit({"phase": phase, "model": "bert-large", "layers": cfg.layers,
          "d_model": cfg.d_model, "heads": cfg.heads, "d_ff": cfg.d_ff,
          "vocab": cfg.vocab, "batch": batch, "seq": seq,
          "params": sum(p.numel() for p in model.parameters()),
          "steps": steps, "losses": losses, "step_s": times,
          "steady_step_s": steady, "tokens_per_s": tokens_per_step / steady,
          "model_tflops": 3 * flops_per_token * tokens_per_step / steady
          / 1e12,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches, "card": smi})
    assert all(math.isfinite(x) for x in losses), losses
    for step in steps_launches:
        assert all(step[n] == want for n, want in per_step.items()), step
        assert step["_adam_kernel"] == 1, step
    return model, opt, tokens, cfg, launches


def lm_default_phase(model, opt, tokens, cfg, smi, phase, knob, errs_key):
    """The default path with ``knob`` unset: its first step's gradients
    held against the gradients of the path just trained, from the same
    state, then 2 steps for their time.  Returns the 2 steps' launches.

    The attention kernels round P and dS to bf16 before their products
    (as the TPU kernels do); the default paths keep the scores and their
    gradients in f32.  Each rounding moves a term by up to 2^-9 relative,
    and a gradient is a sum of such terms with heavy cancellation, carried
    back through 24 layers: about 1e-2 relative L2 per tensor on a
    24-layer CPU rehearsal (d 256, seq 256).  5e-2 per tensor."""
    grads = lm_grads(model, tokens, cfg)
    del os.environ[knob]
    errs = {}

    def compare():
        for n, p in model.named_parameters():
            want = p.grad.float()
            errs[n] = ((grads[n].float() - want).norm() / want.norm()).item()

    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    times, losses = run_lm_steps(model, opt, tokens, cfg, 2,
                                 before_step=compare)
    launches = counters()
    grad_tol = 5e-2
    emit({"phase": phase, "steps": 2, "losses": losses, "step_s": times,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches, errs_key: errs, "tolerance": grad_tol,
          "card": smi})
    assert all(math.isfinite(x) for x in losses), losses
    assert max(errs.values()) <= grad_tol, errs
    return launches


def phase_lm(hvd, gen, smi):
    """lm_train (the streaming kernels, HVDT_FLASH_ATTENTION unset so the
    auto gate engages) and lm_bwd_default (the blockwise backward);
    returns the lm_train launches."""
    os.environ.pop("HVDT_FLASH_ATTENTION", None)
    os.environ["HVDT_FLASH_BWD"] = "kernel"
    model, opt, tokens, cfg, launches = lm_train_phase(
        hvd, gen, smi, "lm_train", LM_SEQ, LM_BATCH,
        {"_kernel": 48, "_dq_kernel": 24, "_dkv_kernel": 24})
    d_launches = lm_default_phase(model, opt, tokens, cfg, smi,
                                  "lm_bwd_default", "HVDT_FLASH_BWD",
                                  "grad_rel_l2_vs_kernel_bwd")
    assert d_launches["_kernel"] == 48 * 2, d_launches
    assert d_launches["_dq_kernel"] == d_launches["_dkv_kernel"] == 0
    del model, opt, tokens
    torch.cuda.empty_cache()
    return launches


def phase_lm_smallseq(hvd, gen, smi):
    """lm_smallseq (HVDT_FLASH_SMALLSEQ=on, the other attention knobs
    unset) and lm_smallseq_default (the materialized scores); returns the
    lm_smallseq launches and the shapes of the model's leaves."""
    for knob in ("HVDT_FLASH_ATTENTION", "HVDT_FLASH_SMALLSEQ_HB",
                 "HVDT_FLASH_BWD"):
        os.environ.pop(knob, None)
    os.environ["HVDT_FLASH_SMALLSEQ"] = "on"
    model, opt, tokens, cfg, launches = lm_train_phase(
        hvd, gen, smi, "lm_smallseq", SS_SEQ, SS_BATCH,
        {"_smallseq_fwd_kernel": 48, "_smallseq_bwd_kernel": 24,
         "_kernel": 0, "_dq_kernel": 0, "_dkv_kernel": 0})
    d_launches = lm_default_phase(model, opt, tokens, cfg, smi,
                                  "lm_smallseq_default",
                                  "HVDT_FLASH_SMALLSEQ",
                                  "grad_rel_l2_vs_smallseq")
    for name in ("_kernel", "_dq_kernel", "_dkv_kernel",
                 "_smallseq_fwd_kernel", "_smallseq_bwd_kernel"):
        assert d_launches[name] == 0, d_launches
    shapes = [tuple(p.shape) for p in model.parameters()]
    del model, opt, tokens
    torch.cuda.empty_cache()
    return launches, shapes


BENCH_BATCH = 128
BENCH_ARGS = ["--num-iters", "3", "--num-batches-per-iter", "20"]
# The legs of the bench phase: (name, bench flags, HVDT_FUSED_CONV1X1).
BENCH_LEGS = {"G": (["--fused-optimizer"], "1"),
              "E": (["--fused-optimizer", "--eager"], "1"),
              "D": ([], "0")}


def step_profile(step, steps: int = 5) -> dict:
    """torch.profiler over ``steps`` steady calls of ``step``, summarized
    by :func:`trace_summary`."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return trace_summary(events, steps, wall)


# Kernel classes of a step's device time: the first whose name parts
# match a kernel's name (lowercased) takes it.
KERNEL_CLASSES = (
    ("port kernels", ("mm_stats_kernel", "mm_bn_relu_kernel",
                      "optim_multi")),
    ("convolutions and matmuls", ("conv", "cudnn", "xmma", "gemm",
                                  "cutlass", "wgrad", "dgrad")),
    ("reductions", ("reduce_kernel",)),
    ("copies and casts", ("copy",)),
    ("elementwise", ("elementwise",)),
)


def trace_summary(events, steps: int, wall_s: float):
    """From a chrome trace of ``steps`` steps: the device's busy and idle
    share of the window from its first activity to its last (kernels,
    copies and fills on any stream, overlaps counted once), the device
    time and host time a step, kernel launches a step, device ms a step
    by :data:`KERNEL_CLASSES`, the top kernels by device time; and a
    function giving the launches a step of the kernels whose name holds a
    string."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   and "dur" in e)
    assert spans, "the profiler recorded no device activity"
    busy, (lo, hi) = 0.0, spans[0]
    for s0, s1 in spans[1:]:
        if s0 > hi:
            busy, lo = busy + hi - lo, s0
        hi = max(hi, s1)
    busy += hi - lo
    window = hi - spans[0][0]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            n, t = kernels.get(e["name"], (0, 0.0))
            kernels[e["name"]] = (n + 1, t + e["dur"])
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:12]
    by_class = {}
    for k, (_, t) in kernels.items():
        cls = next((c for c, parts in KERNEL_CLASSES
                    if any(p in k.lower() for p in parts)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + t / 1e3 / steps
    summary = {
        "steps": steps, "window_ms": window / 1e3, "busy_ms": busy / 1e3,
        "busy_share": busy / window, "idle_share": 1.0 - busy / window,
        "device_ms_per_step": busy / 1e3 / steps,
        "host_ms_per_step": wall_s * 1e3 / steps,
        "kernel_launches_per_step": sum(n for n, _ in kernels.values())
        / steps,
        "kernel_ms_per_step_by_class": by_class,
        "top_kernels": [{"name": k[:120], "per_step": n / steps,
                         "ms_per_step": t / 1e3 / steps}
                        for k, (n, t) in top]}
    return summary, lambda sub: sum(
        n for k, (n, _) in kernels.items() if sub in k) / steps


def bench_leg(bench, name: str, smi: str):
    """One leg of the port's bench at full width, through
    horovod_tpu_torch.bench.measure (the child's code): its JSON line,
    per-iteration rates and their spread, peak memory and the kernel
    counters of its run."""
    flags, fused_conv = BENCH_LEGS[name]
    os.environ["HVDT_FUSED_CONV1X1"] = fused_conv
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    leg = bench.measure(bench._parse_args([*BENCH_ARGS, *flags]))
    launches = counters()
    rates = leg.rates
    mean = sum(rates) / len(rates)
    row = {"leg": name, "flags": flags, "HVDT_FUSED_CONV1X1": fused_conv,
           "images_per_s": leg.doc["value"], "rates": rates,
           "spread": (sum((r - mean) ** 2 for r in rates)
                      / len(rates)) ** 0.5,
           "min_rate": min(rates), "max_rate": max(rates),
           "mfu": leg.doc["mfu"], "flops_per_step": leg.doc["flops_per_step"],
           "compile_s": leg.doc["compile_s"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": {k: v for k, v in launches.items() if v},
           "json": leg.doc, "card": smi}
    return leg, row


def graphed_equals_eager(hvd, make_opt, images, labels, steps: int = 3):
    """Two ResNet-50 copies from one state (broadcast_parameters in the
    NCCL world of one), each under DistributedOptimizer(make_opt(...)):
    ``steps`` steps through donated_step on one, eager steps on the
    other.  The largest difference over losses, parameters, BatchNorm
    running statistics and optimizer state (0.0 when every byte is the
    same), and the number of tensors compared."""
    from horovod_tpu_torch.models import ResNetConfig, resnet50_init, \
        resnet_loss
    from horovod_tpu_torch.step_pipeline import donated_step

    def one_step(model, opt, images, labels):
        opt.zero_grad(set_to_none=True)
        loss, _ = resnet_loss(model, images, labels)
        loss.backward()
        opt.step()
        return loss.detach()

    out = []
    for graphed in (True, False):
        model = resnet50_init(0, ResNetConfig())
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = hvd.DistributedOptimizer(make_opt(model.parameters()))
        step = donated_step(one_step) if graphed else one_step
        losses = [step(model, opt, images, labels).clone()
                  for _ in range(steps)]
        torch.cuda.synchronize()
        inner = opt.optimizer
        tensors = [torch.stack(losses), *model.state_dict().values(),
                   *(v for st in inner.state.values() for v in st.values())]
        out.append((tensors, inner.state_dict()["param_groups"],
                    opt._passes))
        del model, opt, step, inner
    (got, got_groups, got_passes), (want, want_groups, want_passes) = out
    assert got_groups == want_groups and got_passes == want_passes == steps
    err = max(_bit_err(a, b) for a, b in zip(got, want))
    return err, len(got)


def phase_bench(hvd, smi):
    """The port's bench leg at full width (ResNet-50, 224x224, batch 128,
    bf16 compute, f32 params) in turns G, E, E, G, D; torch.profiler over
    5 steady steps of G and of E; #4 against its plain version at the
    leg's 26 fused-conv shapes; then graphed against eager steps under
    DistributedOptimizer with fused_sgd and fused_adam.  Returns #4's
    largest error there."""
    from horovod_tpu_torch import bench
    from horovod_tpu_torch.models import ResNetConfig

    t0 = time.perf_counter()
    rows, profiles, main_launches = [], {}, None
    for name in ("G", "E", "E", "G", "D"):
        leg, row = bench_leg(bench, name, smi)
        if name == "G" and main_launches is None:
            main_launches = row["launches"]
            assert main_launches.get("_sgd_kernel", 0) >= 1, main_launches
            assert main_launches.get("_mm_stats_kernel", 0) >= 1, \
                main_launches
        if name not in profiles:
            prof, launches_of = step_profile(leg.step)
            if name == "G":
                per_step = {"_mm_stats_kernel": launches_of(
                                "mm_stats_kernel"),
                            "_sgd_kernel": launches_of("optim_multi<false>")}
                assert per_step == {"_mm_stats_kernel": 26,
                                    "_sgd_kernel": 1}, per_step
                prof["launches_per_graphed_step"] = per_step
            profiles[name] = prof
            emit({"phase": "bench_profile", "leg": name, **prof,
                  "card": smi})
        emit({"phase": "bench_leg", **row})
        rows.append(row)
        del leg
        gc.collect()
        torch.cuda.empty_cache()

    # #4 against its plain version at the shapes the leg gives it.
    from horovod_tpu_torch.ops import conv_fused as cf

    gen = torch.Generator(device="cuda").manual_seed(4)
    mm_stats = []
    for (m, k, n), count in sorted(fused_conv_shapes(BENCH_BATCH,
                                                     IMAGE).items()):
        a, w = conv_operands(gen, m, k, n)
        err, tol = check_mm_stats(cf, a, w)
        mm_stats.append({"shape": [m, k, n], "per_forward": count,
                         "max_abs_err": err, "tolerance": tol})
        del a, w
        torch.cuda.empty_cache()

    # Graphed equals eager on the main path, with deterministic cuDNN.
    os.environ["HVDT_FUSED_CONV1X1"] = "1"
    torch.backends.cudnn.deterministic = True
    try:
        gen = torch.Generator(device="cuda").manual_seed(3)
        images = torch.randn((BENCH_BATCH, IMAGE, IMAGE, 3), generator=gen,
                             device="cuda", dtype=torch.bfloat16)
        labels = torch.randint(0, ResNetConfig().num_classes, (BENCH_BATCH,),
                               generator=gen, device="cuda")
        checks = {}
        for name, make in (
                ("fused_sgd", lambda ps: hvd.fused_sgd(ps, 0.01,
                                                        momentum=0.9)),
                ("fused_adam", lambda ps: hvd.fused_adam(ps, 1e-3))):
            err, n = graphed_equals_eager(hvd, make, images, labels)
            assert err == 0.0, (name, err)
            checks[name] = {"steps": 3, "tensors": n, "max_abs_err": err}
        del images, labels
    finally:
        torch.backends.cudnn.deterministic = False
    gc.collect()
    torch.cuda.empty_cache()
    by = {}
    for row in rows:
        by.setdefault(row["leg"], []).append(row["images_per_s"])
    emit({"phase": "bench", "model": "resnet50", "batch": BENCH_BATCH,
          "image": IMAGE, "order": [r["leg"] for r in rows],
          "images_per_s": by, "graphed_over_eager": [
              g / e for g, e in zip(by["G"], by["E"])],
          "launches": main_launches, "mm_stats_vs_plain": mm_stats,
          "graphed_equals_eager": checks, "tolerance": 0.0,
          "wall_s": time.perf_counter() - t0, "card": smi})
    return max(r["max_abs_err"] for r in mm_stats)


def reset_counters():
    from horovod_tpu_torch.ops import conv_fused as cf
    from horovod_tpu_torch.ops import optim_kernels as ok
    from horovod_tpu_torch.ops import pallas_kernels as pk
    from horovod_tpu_torch.quant import kernels as qk

    pk._flash_fwd.launches = 0
    pk._flash_dq.launches = 0
    pk._flash_dkv.launches = 0
    pk._smallseq_fwd.launches = 0
    pk._smallseq_bwd.launches = 0
    cf._mm_forward.launches = 0
    cf.matmul_batch_stats.launches = 0
    ok._sgd_multi.launches = 0
    ok._adam_multi.launches = 0
    qk._quantize_cuda.launches = 0
    qk._dequantize_cuda.launches = 0
    qk._quantize4_cuda.launches = 0
    qk._dequantize4_cuda.launches = 0


def counters():
    from horovod_tpu_torch.ops import conv_fused as cf
    from horovod_tpu_torch.ops import optim_kernels as ok
    from horovod_tpu_torch.ops import pallas_kernels as pk
    from horovod_tpu_torch.quant import kernels as qk

    return {"_kernel": pk._flash_fwd.launches,
            "_dq_kernel": pk._flash_dq.launches,
            "_dkv_kernel": pk._flash_dkv.launches,
            "_smallseq_fwd_kernel": pk._smallseq_fwd.launches,
            "_smallseq_bwd_kernel": pk._smallseq_bwd.launches,
            "_mm_kernel": cf._mm_forward.launches,
            "_mm_stats_kernel": cf.matmul_batch_stats.launches,
            "_sgd_kernel": ok._sgd_multi.launches,
            "_adam_kernel": ok._adam_multi.launches,
            "_quant_kernel": qk._quantize_cuda.launches,
            "_dequant_kernel": qk._dequantize_cuda.launches,
            "_quant4_kernel": qk._quantize4_cuda.launches,
            "_dequant4_kernel": qk._dequantize4_cuda.launches}


def expected_quant_launches(hvd, model, steps, wire):
    """(quantize, dequantize) launches of ``steps`` steps of the
    error-feedback + quantized-wire path: per step, error feedback
    quantizes and dequantizes every gradient once; each float bucket is
    quantized twice (before the reduce-scatter, after the accumulate)
    and dequantized once after the gather, and once more before the
    accumulate on the int4 wire (the int8 accumulate is plain PyTorch,
    as it is XLA in the reference)."""
    grads = [p for p in model.parameters() if p.requires_grad]
    buckets = hvd.device.fused_allreduce_buckets(grads, None)
    deq = 2 if wire == "int4" else 1
    return (steps * (len(grads) + 2 * len(buckets)),
            steps * (len(grads) + deq * len(buckets)))


def quant_exchange_matches_plain(hvd, model, wire):
    """One fused_allreduce of the model's gradients over ``wire``, with
    the kernels and then with HVDT_QUANT_KERNELS=off: the same bytes."""
    grads = [p.grad.detach().clone() for p in model.parameters()]
    kern = hvd.device.fused_allreduce(grads, wire_dtype=wire)
    os.environ["HVDT_QUANT_KERNELS"] = "off"
    try:
        plain = hvd.device.fused_allreduce(grads, wire_dtype=wire)
    finally:
        del os.environ["HVDT_QUANT_KERNELS"]
    torch.cuda.synchronize()
    return max(_bit_err(a, b) for a, b in zip(kern, plain))


def run_steps(model, opt, images, labels, steps):
    from horovod_tpu_torch.models import resnet_loss

    times, losses = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad()
        loss, _ = resnet_loss(model, images, labels)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, losses


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import ResNetConfig, resnet50_init

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    phase_build()

    gen = torch.Generator(device="cuda").manual_seed(0)
    conv = phase_conv_kernels(gen, smi)

    os.environ["HVDT_FUSED_CONV1X1"] = "1"
    hvd.init()
    assert hvd.size() == 1 and hvd.topology().device.type == "cuda"
    cfg = ResNetConfig()          # depth 50, 1000 classes, bf16 compute
    model = resnet50_init(0, cfg)
    params = list(model.parameters())
    optim = phase_optim_kernels(params, gen)

    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        hvd.fused_sgd(model.parameters(), 0.01, momentum=0.9))
    images = torch.randn((BATCH, IMAGE, IMAGE, 3), generator=gen,
                         device="cuda")
    labels = torch.randint(0, cfg.num_classes, (BATCH,), generator=gen,
                           device="cuda")
    torch.cuda.reset_peak_memory_stats()
    steps = 3
    reset_counters()
    times, losses = run_steps(model, opt, images, labels, steps)
    train_launches = counters()
    assert all(math.isfinite(x) for x in losses), losses
    assert train_launches["_mm_stats_kernel"] == 26 * steps, train_launches
    assert train_launches["_sgd_kernel"] == steps, train_launches
    steady = sorted(times[1:])[len(times[1:]) // 2]
    emit({"phase": "train", "model": "resnet50", "batch": BATCH,
          "image": IMAGE, "steps": steps, "losses": losses,
          "step_s": times, "steady_step_s": steady,
          "images_per_s": BATCH / steady,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": train_launches, "card": smi})

    x = images[:16]
    reset_counters()
    model.eval()
    with torch.no_grad():
        logits = model(x)
    torch.cuda.synchronize()
    eval_launches = counters()
    assert eval_launches["_mm_kernel"] == 26, eval_launches
    os.environ["HVDT_FUSED_CONV1X1"] = "0"
    with torch.no_grad():
        ref = model(x)
    os.environ["HVDT_FUSED_CONV1X1"] = "1"
    assert logits.shape == (16, cfg.num_classes)
    assert torch.isfinite(logits).all()
    # bf16 activations rounded at other places on the unfused path (the
    # 1x1 conv output, then x*a + b in bf16): a few bf16 ulps per layer,
    # so a relative L2 error of a few 1e-3 over the logits.
    eval_err = ((logits - ref).norm() / ref.norm()).item()
    eval_tol = 2e-2
    assert eval_err <= eval_tol, (eval_err, eval_tol)
    emit({"phase": "eval", "batch": 16, "launches": eval_launches,
          "rel_l2_err_vs_unfused": eval_err, "tolerance": eval_tol})

    model.train()
    adam = hvd.DistributedOptimizer(hvd.fused_adam(model.parameters(), 1e-3))
    reset_counters()
    a_times, a_losses = run_steps(model, adam, images, labels, 2)
    adam_launches = counters()
    assert all(math.isfinite(x) for x in a_losses), a_losses
    assert adam_launches["_adam_kernel"] == 2, adam_launches
    assert adam_launches["_mm_stats_kernel"] == 52, adam_launches
    emit({"phase": "adam", "steps": 2, "losses": a_losses, "step_s": a_times,
          "launches": adam_launches})

    quant, bucket_sizes = phase_quant_kernels(params, gen)

    int8_opt = hvd.quant.with_error_feedback(hvd.DistributedOptimizer(
        hvd.fused_sgd(model.parameters(), 0.01, momentum=0.9),
        compression=hvd.Compression.int8))
    steps = 3
    reset_counters()
    q_times, q_losses = run_steps(model, int8_opt, images, labels, steps)
    int8_launches = counters()
    want_q, want_dq = expected_quant_launches(hvd, model, steps,
                                             "int8")
    assert all(math.isfinite(x) for x in q_losses), q_losses
    assert int8_launches["_quant_kernel"] == want_q, (int8_launches, want_q)
    assert int8_launches["_dequant_kernel"] == want_dq, (int8_launches,
                                                         want_dq)
    assert int8_launches["_sgd_kernel"] == steps, int8_launches
    assert int8_launches["_mm_stats_kernel"] == 26 * steps, int8_launches
    int8_err = quant_exchange_matches_plain(hvd, model, hvd.quant.INT8_WIRE)
    assert int8_err == 0.0, int8_err
    # Step time against the uncompressed wire in turns (int8, plain,
    # plain, int8) on the same card and model.
    plain_opt = hvd.DistributedOptimizer(
        hvd.fused_sgd(model.parameters(), 0.01, momentum=0.9))
    p_times = (run_steps(model, plain_opt, images, labels, steps)[0]
               + run_steps(model, plain_opt, images, labels, steps)[0])
    q_times += run_steps(model, int8_opt, images, labels, steps)[0]
    del plain_opt
    # Where the step's extra time goes: error feedback over the 161
    # gradients, and the bucket exchange over each wire.
    grads = [p.grad for p in model.parameters()]
    split_ms = {"error_feedback": host_ms(int8_opt.compensate)}
    for wire in (None, hvd.quant.INT8_WIRE, hvd.quant.INT4_WIRE):
        split_ms[f"exchange_{wire or 'f32'}"] = host_ms(
            lambda: hvd.device.fused_allreduce(grads, wire_dtype=wire))
    q_steady = sorted(q_times[1:])[len(q_times[1:]) // 2]
    p_steady = sorted(p_times[1:])[len(p_times[1:]) // 2]
    emit({"phase": "int8", "steps": steps, "losses": q_losses,
          "step_s": q_times, "steady_step_s": q_steady,
          "images_per_s": BATCH / q_steady,
          "uncompressed_step_s": p_times,
          "uncompressed_steady_step_s": p_steady,
          "uncompressed_images_per_s": BATCH / p_steady,
          "buckets": bucket_sizes, "launches": int8_launches,
          "expected_quant_dequant": [want_q, want_dq],
          "exchange_vs_plain_max_abs_err": int8_err, "host_ms": split_ms,
          "card": smi})
    del int8_opt

    os.environ["HVDT_COMPRESSION"] = "int4"
    try:
        assert hvd.Compression.from_env() is hvd.Compression.int4
        int4_opt = hvd.quant.with_error_feedback(hvd.DistributedOptimizer(
            hvd.fused_sgd(model.parameters(), 0.01, momentum=0.9)),
            wire="int4")
        reset_counters()
        f_times, f_losses = run_steps(model, int4_opt, images, labels, 2)
        int4_launches = counters()
    finally:
        del os.environ["HVDT_COMPRESSION"]
    want_q4, want_dq4 = expected_quant_launches(hvd, model, 2, "int4")
    assert all(math.isfinite(x) for x in f_losses), f_losses
    assert int4_launches["_quant4_kernel"] == want_q4, int4_launches
    assert int4_launches["_dequant4_kernel"] == want_dq4, int4_launches
    assert int4_launches["_quant_kernel"] == 0, int4_launches
    assert int4_launches["_sgd_kernel"] == 2, int4_launches
    int4_err = quant_exchange_matches_plain(hvd, model, hvd.quant.INT4_WIRE)
    assert int4_err == 0.0, int4_err
    emit({"phase": "int4", "steps": 2, "losses": f_losses, "step_s": f_times,
          "launches": int4_launches,
          "expected_quant_dequant": [want_q4, want_dq4],
          "exchange_vs_plain_max_abs_err": int4_err})
    del int4_opt, adam, opt, model, params, images, labels, grads
    torch.cuda.empty_cache()

    flash = phase_flash_kernels(gen, smi)
    lm_launches = phase_lm(hvd, gen, smi)
    flash.update(phase_smallseq_kernels(gen, smi))
    ss_launches, lm_shapes = phase_lm_smallseq(hvd, gen, smi)
    bench_mm_err = phase_bench(hvd, smi)
    conv["_mm_stats_kernel"]["max_abs_err"] = max(
        conv["_mm_stats_kernel"]["max_abs_err"], bench_mm_err)
    hvd.shutdown()
    phase_optim_lm(gen, smi, lm_shapes)

    sources = {"_mm_kernel": ("cuda", "horovod_tpu_torch/csrc/conv_fused.cu",
                              "horovod_tpu/ops/conv_fused.py:99",
                              eval_launches),
               "_mm_stats_kernel": ("cuda",
                                    "horovod_tpu_torch/csrc/conv_fused.cu",
                                    "horovod_tpu/ops/conv_fused.py:267",
                                    train_launches),
               "_sgd_kernel": ("cuda", "horovod_tpu_torch/csrc/optim.cu",
                               "horovod_tpu/ops/optim_kernels.py:289",
                               train_launches),
               "_adam_kernel": ("cuda", "horovod_tpu_torch/csrc/optim.cu",
                                "horovod_tpu/ops/optim_kernels.py:120",
                                adam_launches)}
    quant_cu = "horovod_tpu_torch/csrc/quant.cu"
    sources.update({
        "_quant_kernel": ("cuda", quant_cu, "horovod_tpu/quant/kernels.py:141",
                          int8_launches),
        "_dequant_kernel": ("cuda", quant_cu,
                            "horovod_tpu/quant/kernels.py:150",
                            int8_launches),
        "_quant4_kernel": ("cuda", quant_cu,
                           "horovod_tpu/quant/kernels.py:321",
                           int4_launches),
        "_dequant4_kernel": ("cuda", quant_cu,
                             "horovod_tpu/quant/kernels.py:328",
                             int4_launches)})
    flash_cu = "horovod_tpu_torch/csrc/flash_attn.cu"
    sources.update({
        name: ("cuda", flash_cu, f"horovod_tpu/ops/pallas_kernels.py:{line}",
               lm_launches)
        for name, line in (("_kernel", 89), ("_dq_kernel", 412),
                           ("_dkv_kernel", 461))})
    smallseq_cu = "horovod_tpu_torch/csrc/flash_smallseq.cu"
    sources.update({
        name: ("cuda", smallseq_cu,
               f"horovod_tpu/ops/pallas_kernels.py:{line}", ss_launches)
        for name, line in (("_smallseq_fwd_kernel", 614),
                           ("_smallseq_bwd_kernel", 662))})
    kernels = []
    for name, (route, source, replaces, launches) in sources.items():
        if name in conv:
            row = dict(conv[name])
            by = row.pop("bound_by")
            row["bound_by"] = max(by, key=by.get)
        elif name in quant:
            row = dict(quant[name], library_ms=None)
        elif name in flash:
            row = flash[name]
        else:
            row = dict(optim[name])
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": row["max_abs_err"],
                        "ms": row["kernel_ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    assert len(kernels) == 13, [k["name"] for k in kernels]
    emit({"phase": "total", "wall_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
