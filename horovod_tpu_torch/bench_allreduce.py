"""Allreduce bus-bandwidth microbenchmark of the port's collectives.

The PyTorch counterpart of the repository's root ``bench_allreduce.py``:
it sweeps message sizes (``--min-bytes`` to ``--max-bytes``, x4 a step)
through the port's own data plane and reports, per size:

* ``jit_algbw_gbps`` — algorithm bandwidth, message bytes / op time;
* ``jit_busbw_gbps`` — bus bandwidth, ``algbw * 2(n-1)/n`` (the
  ring-allreduce accounting NCCL's numbers use).

The row and summary keys are the reference's (its device path is named
``jit``; here it is ``ops.device.fused_allreduce`` on NCCL or gloo), so
the files feed what reads the reference's: ``HVDT_AUTOTUNE_TRANSPORT_SEED``
reads ``hierarchical_speedup_vs_flat_at_peak`` of a ``--hierarchical``
sweep, ``HVDT_AUTOTUNE_ZERO_SEED`` ``rs_ag_speedup_vs_allreduce_at_peak``
of a ``--reduce-scatter`` sweep.

Modes:

* the flat sweep, ``--wire {f32,bf16,fp16,int8,int4}``: a chained
  ``fused_allreduce`` (AVERAGE) of one tensor on that wire (casts for
  bf16/fp16, the two-stage quantized allreduce for int8/int4: kernels
  #5-#8 on the card); a non-f32 wire also times f32 and reports
  ``speedup_vs_f32``; ``--eager`` adds the negotiated eager path
  (``hvd.allreduce``) per size;
* ``--reduce-scatter``: the ZeRO route (``ops.zero.rs_exchange``:
  reduce-scatter, then all-gather) and the reduce-scatter alone against
  the flat allreduce;
* ``--a2a``: the MoE all-to-all transport of ``parallel/moe.py``, exact
  against its int8 wire;
* ``--hierarchical`` (or ``--transport SPEC``): the ``HVDT_TRANSPORT``
  hierarchy on an (``--outer`` x n/outer) ``("dcn", "ici")`` mesh: the
  flat all-reduce, the hierarchical one and each tier alone.

It runs in the world it finds (under the port's ``hvdtrun``, or a world
of one), or with ``--np N`` in a world of its own: N processes of this
module, gloo on the CPU (``--device cpu``), NCCL one card a process.
Rank 0 prints one line a size on stderr, the summary JSON as the last
line on stdout, and writes it to ``--json-out``.  Each time is the
slowest rank's best of ``--iters`` timed calls of ``--inner`` chained
operations, the device synchronised before and after.

    python -m horovod_tpu_torch.bench_allreduce --np 4 --wire int8
    python -m horovod_tpu_torch.bench_allreduce --np 4 --reduce-scatter \\
        --json-out zero_seed.json
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from typing import Callable, List, Optional

import torch

SCHEMA_VERSION = 1
_ITEM = {"float32": 4, "bfloat16": 2, "float16": 2}


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024:
            return f"{n:.0f}{unit}"
        n /= 1024
    return f"{n:.0f}TiB"


def _sizes(args) -> List[int]:
    out, s = [], args.min_bytes
    while s <= args.max_bytes:
        out.append(s)
        s *= 4
    return out


def wire_payload_bytes(count: int, dtype: str, wire: str) -> int:
    """Bytes one allreduce message of ``count`` elements occupies on the
    selected wire."""
    from .quant import kernels as qk

    if wire in ("bf16", "fp16"):
        return count * 2
    if wire == "int8":
        return qk.wire_bytes(count)
    if wire == "int4":
        return qk.wire_bytes_int4(count)
    return count * _ITEM[dtype]


def _wire_dtype(wire: str):
    from .ops.compression import Compression

    return {"f32": None, "bf16": Compression.bf16.wire_dtype,
            "fp16": Compression.fp16.wire_dtype,
            "int8": Compression.int8.wire_dtype,
            "int4": Compression.int4.wire_dtype}[wire]


class _Timer:
    """Times chained operations the same way on every rank."""

    def __init__(self, device: torch.device, inner: int, iters: int,
                 warmup: int):
        self.device, self.inner = device, inner
        self.iters, self.warmup = iters, warmup

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, one: Callable[[torch.Tensor], torch.Tensor],
                 x: torch.Tensor) -> float:
        """Seconds a call of ``one`` (``acc -> acc``): the slowest rank's
        best of ``iters`` timed calls of ``inner`` chained ones."""
        import torch.distributed as dist

        acc = x.clone()
        best = float("inf")
        for i in range(self.warmup + self.iters):
            dist.barrier()
            self._sync()
            t0 = time.perf_counter()
            for _ in range(self.inner):
                acc = one(acc)
            self._sync()
            if i >= self.warmup:
                best = min(best, (time.perf_counter() - t0) / self.inner)
        t = torch.tensor([best], dtype=torch.float64)
        if dist.get_backend() == "nccl":
            t = t.to(self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())


def _setup(args):
    import horovod_tpu_torch as hvd

    hvd.init(device=args.device)
    dev = hvd.topology().device
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return hvd, dev, name, _Timer(dev, args.inner, args.iters,
                                  args.warmup)


def _ones(count: int, dtype: str, dev: torch.device) -> torch.Tensor:
    return torch.ones(count, dtype=getattr(torch, dtype), device=dev)


def _log(hvd, msg: str) -> None:
    if hvd.rank() == 0:
        print(msg, file=sys.stderr, flush=True)


def _finish(hvd, args, summary: dict) -> dict:
    if hvd.rank() == 0:
        if args.json_out:
            with open(args.json_out, "w") as f:
                json.dump(summary, f, indent=1)
        print(json.dumps(summary), flush=True)
    return summary


# ---- the flat sweep -----------------------------------------------------


def _fused_one(wire: str):
    """``acc -> fused_allreduce([acc], AVERAGE)[0]`` on ``wire``."""
    from .common.types import ReduceOp
    from .ops import device as tdev

    wd = _wire_dtype(wire)

    def one(acc):
        return tdev.fused_allreduce([acc], ReduceOp.AVERAGE,
                                    wire_dtype=wd)[0]
    return one


def _eager_seconds(hvd, x: torch.Tensor, iters: int, warmup: int) -> float:
    """Per-op seconds of the negotiated eager allreduce (every rank's
    own best; the names differ by size and call)."""
    key = x.numel()
    for i in range(warmup):
        hvd.allreduce(x, name=f"bw_warm_{key}_{i}")
    best = float("inf")
    for i in range(iters):
        t0 = time.perf_counter()
        out = hvd.allreduce(x, name=f"bw_{key}_{i}")
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        best = min(best, time.perf_counter() - t0)
    return best


def run_flat(args) -> dict:
    hvd, dev, kind, timer = _setup(args)
    n = hvd.size()
    _log(hvd, f"# allreduce sweep on {n}x {dev.type}:{kind} "
              f"(busbw = algbw * 2(n-1)/n)")
    factor = 2.0 * (n - 1) / n if n > 1 else 1.0
    rows = []
    for size in _sizes(args):
        count = max(1, size // _ITEM[args.dtype])
        x = _ones(count, args.dtype, dev)
        t = timer(_fused_one(args.wire), x)
        on_wire = wire_payload_bytes(count, args.dtype, args.wire)
        row = {"bytes": size, "size_bytes": size,
               "jit_algbw_gbps": size / t / 1e9,
               "jit_busbw_gbps": size / t * factor / 1e9,
               "jit_us": t * 1e6, "seconds": t,
               "axis": "dp", "axis_size": int(n), "algorithm": "flat",
               "wire": args.wire, "bytes_on_wire": on_wire,
               "wire_gbps": on_wire / t / 1e9}
        msg = (f"{_fmt_bytes(size):>8}  jit {row['jit_us']:>10.1f}us "
               f"algbw {row['jit_algbw_gbps']:>8.2f} GB/s "
               f"busbw {row['jit_busbw_gbps']:>8.2f} GB/s")
        if args.wire != "f32":
            t32 = timer(_fused_one("f32"), x)
            row["f32_us"] = t32 * 1e6
            row["speedup_vs_f32"] = t32 / t
            msg += (f"   wire={args.wire} {_fmt_bytes(on_wire):>8} "
                    f"speedup {row['speedup_vs_f32']:>5.2f}x")
        if args.eager:
            te = _eager_seconds(hvd, x, max(3, args.iters // 2), 1)
            row["eager_algbw_gbps"] = size / te / 1e9
            row["eager_us"] = te * 1e6
            msg += (f"   eager {row['eager_us']:>10.1f}us "
                    f"algbw {row['eager_algbw_gbps']:>8.2f} GB/s")
        rows.append(row)
        _log(hvd, msg)
    peak = max(rows, key=lambda r: r["jit_busbw_gbps"])
    summary = {"metric": "allreduce_peak_busbw_gbps",
               "schema_version": SCHEMA_VERSION,
               "value": round(peak["jit_busbw_gbps"], 3), "unit": "GB/s",
               "n_devices": n, "platform": dev.type, "device_kind": kind,
               "at_bytes": peak["bytes"], "wire": args.wire, "rows": rows}
    if args.wire != "f32":
        summary["speedup_vs_f32_at_peak"] = round(peak["speedup_vs_f32"], 3)
    return _finish(hvd, args, summary)


# ---- --reduce-scatter: the ZeRO route ------------------------------------


def run_reduce_scatter(args) -> dict:
    from .common.types import ReduceOp
    from .ops import device as tdev
    from .ops import zero

    hvd, dev, kind, timer = _setup(args)
    n = hvd.size()
    _log(hvd, f"# reduce-scatter sweep on {n}x {dev.type}:{kind} "
              f"(rs_ag = reduce-scatter + all-gather, the HVDT_ZERO wire)")

    def allreduce(acc):
        return tdev.fused_allreduce([acc], ReduceOp.AVERAGE)[0]

    def rs_ag(acc):
        return zero.rs_exchange([acc], ReduceOp.AVERAGE)[0]

    def rs(acc):
        # The hop alone, tiled back so the chain carries on (the tile
        # is local).
        return tdev.reduce_scatter_flat(acc).repeat(n).mul_(1.0 / n)

    rows = []
    for size in _sizes(args):
        count = max(n, size // _ITEM[args.dtype])
        count -= count % n
        x = _ones(count, args.dtype, dev)
        t = {leg: timer(fn, x) for leg, fn in
             (("allreduce", allreduce), ("rs_ag", rs_ag), ("rs", rs))}
        speedup = t["allreduce"] / t["rs_ag"] if t["rs_ag"] > 0 else None
        rows.append({
            "bytes": size, "size_bytes": size, "axis": "dp",
            "axis_size": int(n), "algorithm": "rs_ag", "wire": "f32",
            "seconds": t["rs_ag"], "allreduce_us": t["allreduce"] * 1e6,
            "rs_ag_us": t["rs_ag"] * 1e6, "rs_us": t["rs"] * 1e6,
            "rs_ag_algbw_gbps": size / t["rs_ag"] / 1e9,
            "rs_ag_speedup_vs_allreduce": speedup,
            "deferred_ag_fraction": (1.0 - t["rs"] / t["rs_ag"]
                                     if t["rs_ag"] > 0 else None)})
        _log(hvd, f"{_fmt_bytes(size):>8}  allreduce "
                  f"{t['allreduce']*1e6:>9.1f}us  rs+ag "
                  f"{t['rs_ag']*1e6:>9.1f}us  rs {t['rs']*1e6:>9.1f}us  "
                  f"speedup {speedup:>5.2f}x")
    peak = max(rows, key=lambda r: r["rs_ag_algbw_gbps"])
    return _finish(hvd, args, {
        "metric": "reduce_scatter_sweep", "schema_version": SCHEMA_VERSION,
        "value": round(peak["rs_ag_speedup_vs_allreduce"], 3),
        "unit": "speedup_vs_allreduce", "n_devices": int(n),
        "platform": dev.type, "device_kind": kind,
        "at_bytes": peak["bytes"],
        "rs_ag_speedup_vs_allreduce_at_peak": round(
            peak["rs_ag_speedup_vs_allreduce"], 3),
        "rows": rows})


# ---- --a2a: the MoE all-to-all transport ---------------------------------


def run_a2a(args) -> dict:
    from .parallel import moe
    from .parallel.ring_attention import _Ring

    hvd, dev, kind, timer = _setup(args)
    n = hvd.size()
    ring = _Ring(None, "ep")
    _log(hvd, f"# all_to_all sweep on {n}x {dev.type}:{kind} (the MoE "
              f"expert-dispatch wire; int8 = block-scaled payload + f32 "
              f"scales)")
    rows = []
    for size in _sizes(args):
        count = max(n, size // _ITEM[args.dtype])
        count -= count % n
        x = _ones(count, args.dtype, dev).view(n, count // n)
        t = {}
        for wire in ("f32", "int8"):
            leg = None if wire == "f32" else wire
            t[wire] = timer(lambda acc: moe._a2a_on_wire(acc, ring, leg), x)
        speedup = t["f32"] / t["int8"] if t["int8"] > 0 else None
        for wire in ("f32", "int8"):
            rows.append({
                "bytes": size, "size_bytes": size, "axis": "dp",
                "axis_size": int(n), "algorithm": "ring", "wire": wire,
                "op": "all_to_all", "seconds": t[wire],
                "a2a_us": t[wire] * 1e6,
                "a2a_algbw_gbps": size / t[wire] / 1e9,
                "a2a_wire_bytes": wire_payload_bytes(count, args.dtype,
                                                     wire),
                "int8_speedup_vs_f32": speedup})
        _log(hvd, f"{_fmt_bytes(size):>8}  f32 {t['f32']*1e6:>9.1f}us  "
                  f"int8 {t['int8']*1e6:>9.1f}us  speedup {speedup:>5.2f}x")
    peak = max((r for r in rows if r["wire"] == "f32"),
               key=lambda r: r["a2a_algbw_gbps"])
    return _finish(hvd, args, {
        "metric": "a2a_sweep", "schema_version": SCHEMA_VERSION,
        "value": round(peak["int8_speedup_vs_f32"], 3),
        "unit": "int8_speedup_vs_f32", "n_devices": int(n),
        "platform": dev.type, "device_kind": kind,
        "at_bytes": peak["bytes"],
        "int8_a2a_speedup_vs_f32_at_peak": round(
            peak["int8_speedup_vs_f32"], 3),
        "rows": rows})


# ---- --hierarchical: the HVDT_TRANSPORT hierarchy ------------------------


def run_hierarchical(args) -> dict:
    os.environ.setdefault("HVDT_TRANSPORT", args.transport or "auto")
    import torch.distributed as dist

    from .common.types import ReduceOp
    from .ops import device as tdev
    from .parallel import MeshSpec, make_mesh
    from .quant import kernels as qk
    from .transport import policy as tpolicy

    tpolicy.reset()
    hvd, dev, kind, timer = _setup(args)
    n = hvd.size()
    outer = args.outer
    if outer < 2 or n % outer:
        outer = 2 if (n >= 4 and n % 2 == 0) else 0
    if not outer:
        raise SystemExit(f"--hierarchical needs an even world >= 4 to "
                         f"split into (outer, inner); have {n}")
    n_dcn, n_ici = outer, n // outer
    mesh = make_mesh(MeshSpec(axes=(("dcn", n_dcn), ("ici", n_ici))))
    res = tpolicy.get_policy().resolve(("dcn", "ici"))
    if res.kind != "hierarchical":
        raise SystemExit(f"HVDT_TRANSPORT={os.environ['HVDT_TRANSPORT']!r} "
                         "does not resolve ('dcn', 'ici') hierarchically")
    item = _ITEM[args.dtype]
    g_dcn = mesh.get_group("dcn")
    _log(hvd, f"# hierarchical allreduce sweep on {n_dcn}x{n_ici} "
              f"{dev.type}:{kind} policy={tpolicy.get_policy().describe()}")

    def flat(acc):
        dist.all_reduce(acc)
        return acc.mul_(1.0 / n)

    def hier(acc):
        return tdev.fused_allreduce([acc], ReduceOp.AVERAGE,
                                    axis=("dcn", "ici"), mesh=mesh)[0]

    def ici(acc):
        shard = tdev.reduce_scatter_flat(acc, "ici", mesh)
        return tdev.allgather_flat_shards(shard, "ici", mesh).mul_(
            1.0 / n_ici)

    def dcn(acc):
        dist.all_reduce(acc, group=g_dcn)
        return acc.mul_(1.0 / n_dcn)

    def wire_item(wire):
        return {"bf16": 2, "fp16": 2}.get(wire, item)

    rows = []
    for size in _sizes(args):
        count = max(n_ici, size // item)
        count -= count % n_ici
        shard = count // n_ici
        x = _ones(count, args.dtype, dev)
        t = {"flat": timer(flat, x), "hier": timer(hier, x),
             "ici": timer(ici, x), "dcn": timer(dcn, x[:shard])}
        ici_wire = 2 * count * wire_item(res.fast.wire) \
            * (n_ici - 1) // n_ici
        if res.slow.wire == "int8":
            dcn_wire = int(qk.wire_bytes(shard))
        elif res.slow.wire == "int4":
            dcn_wire = int(qk.wire_bytes_int4(shard))
        else:
            dcn_wire = 2 * shard * wire_item(res.slow.wire) \
                * (n_dcn - 1) // max(1, n_dcn)
        speedup = t["flat"] / t["hier"] if t["hier"] > 0 else None
        flat_wire = 2 * count * item * (n - 1) // n
        rows.extend([
            {"bytes": size, "size_bytes": size, "axis": "ici",
             "axis_size": int(n_ici), "algorithm": res.fast.algorithm,
             "wire": res.fast.wire, "us": t["ici"] * 1e6,
             "seconds": t["ici"], "bytes_on_wire": ici_wire,
             "wire_gbps": ici_wire / t["ici"] / 1e9},
            {"bytes": size, "size_bytes": size, "axis": "dcn",
             "axis_size": int(n_dcn), "algorithm": res.slow.algorithm,
             "wire": res.slow.wire, "us": t["dcn"] * 1e6,
             "seconds": t["dcn"], "bytes_on_wire": dcn_wire,
             "wire_gbps": dcn_wire / t["dcn"] / 1e9},
            {"bytes": size, "size_bytes": size, "axis": "ici+dcn",
             "axis_size": int(n), "algorithm": "flat",
             "wire": args.dtype if args.dtype != "float32" else "f32",
             "us": t["flat"] * 1e6, "seconds": t["flat"],
             "bytes_on_wire": flat_wire,
             "wire_gbps": flat_wire / t["flat"] / 1e9},
            {"bytes": size, "size_bytes": size, "axis": "ici+dcn",
             "axis_size": int(n), "algorithm": "hierarchical",
             "wire": f"{res.fast.wire}/{res.slow.wire}",
             "us": t["hier"] * 1e6, "seconds": t["hier"],
             "flat_us": t["flat"] * 1e6,
             "bytes_on_wire": ici_wire + dcn_wire,
             "jit_algbw_gbps": size / t["hier"] / 1e9,
             "hierarchical_speedup_vs_flat": speedup}])
        _log(hvd, f"{_fmt_bytes(size):>8}  flat {t['flat']*1e6:>9.1f}us  "
                  f"hier {t['hier']*1e6:>9.1f}us  speedup {speedup:>5.2f}x  "
                  f"(ici {t['ici']*1e6:.1f}us dcn {t['dcn']*1e6:.1f}us)")
    hier_rows = [r for r in rows if r["algorithm"] == "hierarchical"]
    peak = max(hier_rows, key=lambda r: r["jit_algbw_gbps"])
    return _finish(hvd, args, {
        "metric": "allreduce_hierarchical_sweep",
        "schema_version": SCHEMA_VERSION,
        "value": round(peak["hierarchical_speedup_vs_flat"], 3),
        "unit": "speedup_vs_flat", "n_devices": int(n),
        "mesh": {"dcn": int(n_dcn), "ici": int(n_ici)},
        "platform": dev.type, "device_kind": kind,
        "transport": os.environ.get("HVDT_TRANSPORT", ""),
        "at_bytes": peak["bytes"],
        "hierarchical_speedup_vs_flat_at_peak": round(
            peak["hierarchical_speedup_vs_flat"], 3),
        "rows": rows})


# ---- launching ------------------------------------------------------------


def _spawn(argv: List[str], n: int, timeout_s: float) -> int:
    """Run this module with ``argv`` (``--np`` dropped) as an ``n``-process
    world on this host; 0 when every rank exits 0."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, HVDT_SIZE=str(n), HVDT_LOCAL_SIZE=str(n),
               HVDT_COORDINATOR_ADDR=f"127.0.0.1:{port}",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.bench_allreduce", *argv],
        env=dict(env, HVDT_RANK=str(r), HVDT_LOCAL_RANK=str(r)))
        for r in range(n)]
    deadline = time.time() + timeout_s
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() for p in procs) or time.time() > deadline:
                return 1
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return 1 if any(p.returncode for p in procs) else 0


def _without_np(argv: List[str]) -> List[str]:
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == "--np":
            skip = True
        elif not a.startswith("--np="):
            out.append(a)
    return out


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(prog="python -m "
                                 "horovod_tpu_torch.bench_allreduce")
    ap.add_argument("--min-bytes", type=int, default=1 << 12)
    ap.add_argument("--max-bytes", type=int, default=1 << 26)
    ap.add_argument("--dtype", default="float32", choices=tuple(_ITEM))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--inner", type=int, default=10,
                    help="chained operations per timed call")
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--eager", action="store_true",
                    help="also time the negotiated eager path")
    ap.add_argument("--wire", choices=("f32", "bf16", "fp16", "int8",
                                       "int4"), default="f32",
                    help="wire of the flat sweep (a non-f32 wire also "
                         "times f32 for speedup_vs_f32)")
    ap.add_argument("--json-out", default="",
                    help="also write the summary JSON to this file")
    ap.add_argument("--reduce-scatter", action="store_true",
                    help="the ZeRO route against the flat allreduce (the "
                         "HVDT_AUTOTUNE_ZERO_SEED input)")
    ap.add_argument("--a2a", action="store_true",
                    help="the MoE all-to-all, exact against int8")
    ap.add_argument("--hierarchical", action="store_true",
                    help="the HVDT_TRANSPORT hierarchy on an (outer x "
                         "inner) mesh (the HVDT_AUTOTUNE_TRANSPORT_SEED "
                         "input)")
    ap.add_argument("--transport", default="",
                    help="HVDT_TRANSPORT spec of the hierarchical sweep "
                         "(default 'auto')")
    ap.add_argument("--outer", type=int, default=2,
                    help="the slow (dcn) axis size of --hierarchical")
    ap.add_argument("--np", type=int, default=0,
                    help="run in a world of N processes of its own")
    ap.add_argument("--device", default=None,
                    help="'cpu' for a gloo world on the host (default: "
                         "the card of the local rank)")
    ap.add_argument("--timeout", type=float, default=1800.0,
                    help="seconds the --np world may take")
    return ap.parse_args(argv)


def run(args) -> dict:
    """The mode ``args`` selects, in the current world (rank 0 returns
    the summary; every rank returns it)."""
    if args.reduce_scatter:
        return run_reduce_scatter(args)
    if args.a2a:
        return run_a2a(args)
    if args.hierarchical or args.transport:
        return run_hierarchical(args)
    return run_flat(args)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    if args.np > 1:
        return _spawn(_without_np(argv), args.np, args.timeout)
    import horovod_tpu_torch as hvd

    try:
        run(args)
    finally:
        hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
