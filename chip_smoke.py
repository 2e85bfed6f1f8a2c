#!/usr/bin/env python3
"""Smoke run of the PyTorch port (horovod_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and triton.
Phases, one JSON line each:

1. device  — the card's name and power limit (nvidia-smi);
2. build   — nvcc builds every CUDA kernel source of the package;
3. kernel  — each hand-written kernel against its plain PyTorch version
   on the card, at the shapes ResNet-50 at batch 64 gives it, with its
   time, the plain version's, the least time the card could take
   (bound) and one PyTorch library call's (timed only, never used by
   the port);
4. train   — full-width ResNet-50 (1000 classes, 224x224, bf16 compute,
   f32 params, batch 64) in an NCCL world of one, broadcast_parameters,
   HVDT_FUSED_CONV1X1=1, DistributedOptimizer(fused_sgd(0.01, momentum
   0.9)), 3 steps: the fused conv-stats kernel must launch 26 times a
   step and the SGD kernel every step;
5. eval    — one eval forward through the fused conv+affine kernel (26
   launches), held against the unfused forward on the same card;
6. adam    — 2 steps with DistributedOptimizer(fused_adam(1e-3));
7. summary — the kernels line.

Any failure raises and the script exits non-zero without the last line,
which is exactly {"ok": true, "device": {...}} on success.  Without a
card, or run from a directory without the package, it exits non-zero.
"""

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
    return sorted(times)[reps // 2]


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
    import triton

    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "triton": triton.__version__})
    return smi


def phase_build():
    from horovod_tpu_torch import _build

    t0 = time.time()
    paths = _build.build_all()
    ptxas = [line.strip() for name in paths
             for line in (_build.build_log(name) or "").splitlines()
             if "registers" in line or "spill" in line]
    emit({"phase": "build", "seconds": round(time.time() - t0, 3),
          "libraries": [str(p.name) for p in paths.values()],
          "ptxas": ptxas})


def phase_conv_kernels(gen):
    from horovod_tpu_torch.ops import conv_fused as cf

    totals = {name: dict(kernel_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                         library_ms=0.0, max_abs_err=0.0, bound_by={})
              for name in ("_mm_kernel", "_mm_stats_kernel")}
    dev = torch.device("cuda")
    for (m, k, n), count in sorted(fused_conv_shapes(BATCH, IMAGE).items()):
        a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        # The model hands the kernels w = (OIHW weight viewed [N, K]).t().
        w = (torch.randn((n, k), generator=gen, device=dev)
             / math.sqrt(k)).to(torch.bfloat16).t()
        scale = 1.0 + 0.1 * torch.randn(n, generator=gen, device=dev)
        bias = 0.1 * torch.randn(n, generator=gen, device=dev)
        flops = 2.0 * m * n * k
        io = 2.0 * (m * k + k * n + m * n)

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
        row = {"kernel_ms": cuda_ms(
                   lambda: cf._mm_forward(a, w, scale, bias, True)),
               "plain_ms": cuda_ms(
                   lambda: cf._mm_forward_plain(a, w, scale, bias, True)),
               "library_ms": cuda_ms(lambda: torch.matmul(a, w)),
               "bound_ms": b_ms}
        emit({"phase": "kernel", "name": "_mm_kernel", "shape": [m, k, n],
              "per_forward": count, "max_abs_err": err, "tolerance": tol,
              "bound_by": b_by, **row})
        tot = totals["_mm_kernel"]
        for key, val in row.items():
            tot[key] += count * val
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        tot["bound_by"][b_by] = tot["bound_by"].get(b_by, 0) + count

        # #4: z = a @ w, per-128-row partial sums of z and z^2
        z, s1, s2 = cf.matmul_batch_stats(a, w)
        z_ref, s1_ref, s2_ref = cf._mm_stats_plain(a, w)
        torch.cuda.synchronize()
        err = (z.float() - z_ref.float()).abs().max().item()
        tol = z_ref.float().abs().max().item() * 2.0 ** -7
        assert err <= tol, ("_mm_stats_kernel", (m, k, n), err, tol)
        # Partial sums of 128 f32 values, differently associated.
        for got, want in ((s1, s1_ref), (s2, s2_ref)):
            serr = (got - want).abs().max().item()
            stol = 1e-4 * want.abs().max().item()
            assert serr <= stol, ("_mm_stats_kernel sums", serr, stol)
        nb = -(-m // cf.BLOCK_M)
        b_ms, b_by = bound(io + 8.0 * nb * n, flops, PEAK_BF16_FLOPS)
        row = {"kernel_ms": cuda_ms(lambda: cf.matmul_batch_stats(a, w)),
               "plain_ms": cuda_ms(lambda: cf._mm_stats_plain(a, w)),
               "library_ms": cuda_ms(lambda: torch.matmul(a, w)),
               "bound_ms": b_ms}
        emit({"phase": "kernel", "name": "_mm_stats_kernel",
              "shape": [m, k, n], "per_forward": count, "max_abs_err": err,
              "tolerance": tol, "bound_by": b_by, **row})
        tot = totals["_mm_stats_kernel"]
        for key, val in row.items():
            tot[key] += count * val
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        tot["bound_by"][b_by] = tot["bound_by"].get(b_by, 0) + count
    return totals


def _leaf_copies(params, gen, n_state):
    """Clones of ``params`` with random grads and state tensors."""
    def rand(p):   # in p's memory layout, as autograd gives grads
        return torch.empty_like(p).normal_(generator=gen).mul_(0.01)

    return [(p.detach().clone(), rand(p), [rand(p).abs_()
                                           for _ in range(n_state)])
            for p in params]


def _clone(leaves):
    return [(q.clone(), g, [s.clone() for s in st]) for q, g, st in leaves]


def phase_optim_kernels(params, gen):
    """#1 and #2 over all ResNet-50 leaves: one optimizer step through
    the kernel against the plain version, from the same state."""
    from horovod_tpu_torch.ops import optim_kernels as ok

    n_params = sum(p.numel() for p in params)
    results = {}
    for name, n_state, bytes_per in (("_sgd_kernel", 1, 20),
                                     ("_adam_kernel", 2, 28)):
        base = _leaf_copies(params, gen, n_state)

        def step(leaves, use_kernels, name=name):
            if name == "_sgd_kernel":
                for q, g, (m,) in leaves:
                    ok._sgd_leaf(g, m, 0.01, momentum=0.9, nesterov=False,
                                 use_kernels=use_kernels, p=q)
            else:
                sc = ok._adam_scalars(3, 1e-3, 0.9, 0.999)
                for q, g, (m, v) in leaves:
                    ok._adam_leaf(q, g, m, v, sc, b1=0.9, b2=0.999, eps=1e-8,
                                  eps_root=0.0, wd=0.0,
                                  use_kernels=use_kernels, apply=True)

        kern, plain = _clone(base), _clone(base)
        step(kern, True)
        step(plain, False)
        torch.cuda.synchronize()
        err = max(max((a - b).abs().max().item()
                      for a, b in zip([q, *st], [q2, *st2]))
                  for (q, _, st), (q2, _, st2) in zip(kern, plain))
        # A few f32 ulps of the largest parameter: same formulas, same
        # order, IEEE sqrt and division, no contraction on either side.
        tol = 1e-6 * max(p.abs().max().item() for p in params)
        assert err <= tol, (name, err, tol)

        lib = [q.clone().requires_grad_() for q, _, _ in base]
        for t, (_, g, _) in zip(lib, base):
            t.grad = g
        try:
            lib_opt = (torch.optim.SGD(lib, lr=0.01, momentum=0.9, fused=True)
                       if name == "_sgd_kernel" else
                       torch.optim.Adam(lib, lr=1e-3, fused=True))
            library_ms = cuda_ms(lib_opt.step)
        except (RuntimeError, TypeError) as e:   # no fused form in this torch
            print(f"library optimizer unavailable: {e}", file=sys.stderr)
            library_ms = None
        b_ms, b_by = bound(float(bytes_per) * n_params,
                           (4.0 if n_state == 1 else 12.0) * n_params,
                           PEAK_F32_FLOPS)
        row = {"kernel_ms": cuda_ms(lambda: step(kern, True)),
               "plain_ms": cuda_ms(lambda: step(plain, False)),
               "library_ms": library_ms, "bound_ms": b_ms,
               "bound_by": b_by, "max_abs_err": err}
        emit({"phase": "kernel", "name": name, "leaves": len(params),
              "params": n_params, "tolerance": tol, **row})
        results[name] = row
        del kern, plain, base, lib
    return results


def reset_counters():
    from horovod_tpu_torch.ops import conv_fused as cf
    from horovod_tpu_torch.ops import optim_kernels as ok

    cf._mm_forward.launches = 0
    cf.matmul_batch_stats.launches = 0
    ok._sgd_leaf_fused.launches = 0
    ok._adam_leaf_fused.launches = 0


def counters():
    from horovod_tpu_torch.ops import conv_fused as cf
    from horovod_tpu_torch.ops import optim_kernels as ok

    return {"_mm_kernel": cf._mm_forward.launches,
            "_mm_stats_kernel": cf.matmul_batch_stats.launches,
            "_sgd_kernel": ok._sgd_leaf_fused.launches,
            "_adam_kernel": ok._adam_leaf_fused.launches}


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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    phase_build()

    gen = torch.Generator(device="cuda").manual_seed(0)
    conv = phase_conv_kernels(gen)

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
    assert train_launches["_sgd_kernel"] >= steps, train_launches
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
    assert adam_launches["_adam_kernel"] >= 2, adam_launches
    assert adam_launches["_mm_stats_kernel"] == 52, adam_launches
    emit({"phase": "adam", "steps": 2, "losses": a_losses, "step_s": a_times,
          "launches": adam_launches})
    hvd.shutdown()

    sources = {"_mm_kernel": ("cuda", "horovod_tpu_torch/csrc/conv_fused.cu",
                              "horovod_tpu/ops/conv_fused.py:99",
                              eval_launches),
               "_mm_stats_kernel": ("cuda",
                                    "horovod_tpu_torch/csrc/conv_fused.cu",
                                    "horovod_tpu/ops/conv_fused.py:267",
                                    train_launches),
               "_sgd_kernel": ("triton",
                               "horovod_tpu_torch/ops/optim_kernels.py",
                               "horovod_tpu/ops/optim_kernels.py:289",
                               train_launches),
               "_adam_kernel": ("triton",
                                "horovod_tpu_torch/ops/optim_kernels.py",
                                "horovod_tpu/ops/optim_kernels.py:120",
                                adam_launches)}
    kernels = []
    for name, (route, source, replaces, launches) in sources.items():
        if name in conv:
            row = dict(conv[name])
            by = row.pop("bound_by")
            row["bound_by"] = max(by, key=by.get)
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
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
