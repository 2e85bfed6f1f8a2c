"""Env-var knob reader — the knobs this package reads.

A copy of the reader in the JAX package's ``common/config.py`` holding
only the knobs the PyTorch port consumes.  Names, meanings and
defaults are the same as there, so one environment configures either
package.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict

__all__ = ["Knob", "KNOBS", "get", "get_bool", "get_int", "get_float",
           "get_str"]


def _parse_bool(v: str) -> bool:
    return v.strip().lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    default: Any
    parser: Callable[[str], Any]
    doc: str

    def read(self) -> Any:
        raw = os.environ.get(self.name)
        if raw is None:
            return self.default
        try:
            return self.parser(raw)
        except (ValueError, TypeError):
            return self.default


KNOBS: Dict[str, Knob] = {
    k.name: k
    for k in [
        Knob("HVDT_FUSION_THRESHOLD", 64 * 1024 * 1024, int,
             "Tensor-fusion bucket size in bytes for fused gradient "
             "allreduce (64 MiB)."),
        Knob("HVDT_FUSED_CONV1X1", False, _parse_bool,
             "Route eligible ResNet 1x1 conv+BN(+ReLU) blocks through the "
             "fused conv kernels (ops/conv_fused.py): train mode emits the "
             "conv output and batch-stat partials in one pass, eval mode "
             "fuses the folded affine into the matmul epilogue.  Default "
             "off, as in the JAX package.  Eligibility: 1x1, stride 1, "
             "Cin % 128 == 0 and Cout % 128 == 0."),
        Knob("HVDT_COMPRESSION", "", str,
             "Gradient wire compressor by name: none|bf16|fp16|int8|int4 "
             "(empty = none).  Consumed by init() and by "
             "DistributedOptimizer / allreduce_gradients when "
             "compression= is unset; unknown names raise with the valid "
             "list."),
        Knob("HVDT_QUANT", False, _parse_bool,
             "Shorthand for HVDT_COMPRESSION=int8 (wins over it): route "
             "gradient collectives over the block-scaled int8 wire "
             "(quant/collectives two-stage quantized allreduce).  Pair "
             "with quant.with_error_feedback."),
        Knob("HVDT_QUANT_BLOCK", 256, int,
             "Block size (elements) for int8/int4 wire quantization: one "
             "f32 absmax scale per block (256 = 1.6% scale overhead).  "
             "The CUDA kernels take any block (any even block for int4)."),
        Knob("HVDT_QUANT_KERNELS", "auto", str,
             "Quantize/dequantize route: auto (the CUDA kernel for a CUDA "
             "tensor, the plain PyTorch version for a CPU tensor), on (the "
             "kernel; a CPU tensor raises), off (the plain version "
             "everywhere, an explicit opt-out)."),
        Knob("HVDT_FLASH_ATTENTION", "auto", str,
             "Flash-attention kernel for the transformer's attention: auto "
             "(CUDA tensors only, when the f32 score tensor batch x heads "
             "x L x L would reach 4 GiB), on (whenever the sequence "
             "tiles; the plain version for CPU tensors), off."),
        Knob("HVDT_FLASH_BWD", "xla", str,
             "flash_attention backward: xla (the reference's blockwise "
             "recompute, plain PyTorch) or kernel (flash_grad_block: the "
             "dQ and dK/dV kernels).  Read each time a backward runs."),
        Knob("HVDT_FLASH_SMALLSEQ", "auto", str,
             "Whole-sequence attention kernels (flash_attention_smallseq, "
             "the forward and backward kernels of csrc/flash_smallseq.cu) "
             "for the transformer at seq <= 1024: auto (disengaged until a "
             "measured threshold is set, as in the reference), on (whenever "
             "seq % 128 == 0 and seq <= 1024; the plain versions for CPU "
             "tensors), off.  HVDT_FLASH_ATTENTION=off overrides to off; "
             "HVDT_FLASH_ATTENTION=on forces the streaming kernel."),
        Knob("HVDT_FLASH_SMALLSEQ_HB", 8, int,
             "heads_per_block for the smallseq attention kernels (clamped "
             "to divide the head count and to whole GQA groups).  On the "
             "card it shapes only the plain version's loop over heads; "
             "auto's program count reads it."),
        Knob("HVDT_RING_PALLAS", False, _parse_bool,
             "Run ring attention's per-step block update and backward "
             "through the flash kernels (#9 flash_block_update forward, "
             "#10/#11 flash_grad_block backward) where legal; read when "
             "ring_attention is called with use_pallas=None.  On a CUDA "
             "tensor the kernels are that default anyway wherever they "
             "take the operands, and the knob makes them required."),
        Knob("HVDT_REMAT", "", str,
             "Activation rematerialization for the transformer block: "
             "'none'/'' (default) saves all activations; 'full' saves "
             "only block inputs (torch.utils.checkpoint per layer); "
             "'dots' is not ported yet and raises."),
        Knob("HVDT_FP8", "off", str,
             "fp8 (e4m3) compute path: off (default) or matmul (the "
             "transformer projections through quant/fp8.py: "
             "torch._scaled_mm on the card).  Unknown values raise with "
             "the valid list."),
        Knob("HVDT_OVERLAP", "", str,
             "Overlapped gradient exchange (ops/overlap.py): 'on' makes "
             "DistributedOptimizer issue each bucket's collective from "
             "gradient hooks, in reverse-topological order, on a "
             "communication stream while the backward runs; unset/'off' "
             "(default) keeps the exchange in step()."),
        Knob("HVDT_XLA_LATENCY_HIDING", "auto", str,
             "The reference's XLA latency-hiding flags: auto, on, off "
             "(validated; the port sets nothing, its overlap comes from "
             "HVDT_OVERLAP's hooks)."),
        Knob("HVDT_TRANSPORT", "", str,
             "Per-mesh-axis transport policy (horovod_tpu_torch/"
             "transport): comma entries axis:algorithm:wire[:threshold] "
             "with axis in {ici,dcn,dp,pp,fsdp,ep,sp,tp}, algorithm in "
             "{ring,tree,2d_ring}, wire in {f32,bf16,fp16,int8,int4} "
             "(int8/int4 on dcn only), threshold digits[K|M|G]; or "
             "'auto'.  Unset (default) keeps the flat exchange; unknown "
             "vocabulary raises at init()."),
        Knob("HVDT_ZERO", "", str,
             "ZeRO-style state-sharding stage (ops/zero.py): 'grads' swaps "
             "the fused allreduce for an explicit reduce-scatter + "
             "allgather split (same wire bytes; any torch.optim "
             "optimizer); 'states' reduce-scatters gradients and runs the "
             "fused update (#1/#2) on each rank's 1/n shard of the "
             "moments, allgathering only the parameter deltas (optimizer "
             "memory shrinks ~n x; requires fused_adam/fused_sgd); "
             "'params' additionally keeps the parameters sharded between "
             "steps (gather_params() before the forward).  Unset/'off' "
             "(default) keeps the replicated path as the identical "
             "objects; unknown stages fail init() with the valid list."),
        Knob("HVDT_ASYNC_CKPT", False, _parse_bool,
             "Asynchronous checkpointing: CheckpointManager.save_async "
             "takes a device->host snapshot at the commit point and hands "
             "it to a background writer thread (queue depth 1, a newer "
             "snapshot supersedes a queued older one); LAST_GOOD advances "
             "only after the manifest write + fsync.  Unset (default): "
             "save_async IS the synchronous save."),
        Knob("HVDT_CKPT_SNAPSHOT_BUDGET_S", 1.0, float,
             "Stall budget for the commit-point device->host checkpoint "
             "snapshot (the only part of an async save the step loop "
             "pays).  Snapshots are timed into hvdt_ckpt_snapshot_seconds; "
             "one over the budget logs a warning and increments "
             "hvdt_ckpt_snapshot_over_budget_total."),
        Knob("HVDT_AUTOTUNE", False, _parse_bool,
             "Enable Bayesian autotuning of the fusion threshold and the "
             "knob dimensions below (autotune.AutotunedStep)."),
        Knob("HVDT_AUTOTUNE_LOG", "", str,
             "CSV log file for autotune samples."),
        Knob("HVDT_AUTOTUNE_WARMUP_SAMPLES", 3, int,
             "Autotune warmup discard count."),
        Knob("HVDT_AUTOTUNE_STEPS_PER_SAMPLE", 10, int,
             "Steps per autotune sample."),
        Knob("HVDT_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", 20, int,
             "Max BO samples."),
        Knob("HVDT_AUTOTUNE_GAUSSIAN_PROCESS_NOISE", 0.8, float,
             "GP noise alpha."),
        Knob("HVDT_AUTOTUNE_FUSED_OPTIMIZER", False, _parse_bool,
             "Add a fused-vs-unfused optimizer dimension (0/1) to the "
             "autotune search space; the step builder is rebuilt with "
             "fused=... at each knob change.  Starting point comes from "
             "HVDT_FUSED_OPTIMIZER."),
        Knob("HVDT_FUSED_OPTIMIZER", False, _parse_bool,
             "The fused optimizer kernels (fused_adam/fused_sgd, #1/#2) "
             "as the default of bench legs that read it; the autotuner's "
             "fused dimension starts here."),
        Knob("HVDT_AUTOTUNE_QUANT", False, _parse_bool,
             "Add a quantized-wire leg dimension (f32/int8/int4) to the "
             "autotune search space; the step builder is rebuilt with "
             "quant=.../quant_leg=... at each knob change.  Starting "
             "point comes from HVDT_QUANT / HVDT_COMPRESSION."),
        Knob("HVDT_AUTOTUNE_OVERLAP", False, _parse_bool,
             "Add an overlap-schedule on/off dimension to the autotune "
             "search space; the step builder is rebuilt with overlap=... "
             "at each knob change (both legs keep one optimizer state).  "
             "Starting point comes from HVDT_OVERLAP."),
        Knob("HVDT_AUTOTUNE_TRANSPORT", False, _parse_bool,
             "Add a flat-vs-hierarchical transport dimension (0/1) to the "
             "autotune search space; the step builder is rebuilt with "
             "transport=... at each knob change.  Starting point: "
             "HVDT_TRANSPORT set, or the measured "
             "HVDT_AUTOTUNE_TRANSPORT_SEED verdict."),
        Knob("HVDT_AUTOTUNE_TRANSPORT_SEED", "", str,
             "Path to a bench_allreduce --json-out file; when its measured "
             "hierarchical_speedup_vs_flat_at_peak exceeds 1.0 the "
             "transport dimension starts on the hierarchical leg."),
        Knob("HVDT_AUTOTUNE_ZERO", False, _parse_bool,
             "Add a replicated-vs-ZeRO-sharded dimension (0/1) to the "
             "autotune search space; the step builder is rebuilt with "
             "zero=... at each knob change, hot-swappable because both "
             "legs keep ONE sharded state tree (the replicated leg "
             "exchanges via allreduce and slices its shard).  Starting "
             "point: HVDT_ZERO set, or the measured "
             "HVDT_AUTOTUNE_ZERO_SEED verdict."),
        Knob("HVDT_AUTOTUNE_ZERO_SEED", "", str,
             "Path to a bench_allreduce --reduce-scatter --json-out file; "
             "when its measured rs_ag_speedup_vs_allreduce_at_peak exceeds "
             "1.0 the zero dimension starts on the sharded leg."),
        Knob("HVDT_MOE_CAPACITY_FACTOR", 1.25, float,
             "Default expert capacity factor (the MoE autotune "
             "dimension's starting point; parallel/moe is not ported "
             "yet)."),
        Knob("HVDT_PIPELINE_MICROBATCHES", 8, int,
             "Default 1F1B microbatch count (the pipeline autotune "
             "dimension's starting point; parallel/pipeline is not "
             "ported yet)."),
        Knob("HVDT_AUTOTUNE_MOE", False, _parse_bool,
             "Add an expert capacity-factor dimension to the autotune "
             "search space; builders accepting capacity_factor= are "
             "rebuilt with it at each knob change."),
        Knob("HVDT_AUTOTUNE_MOE_SEED", "", str,
             "Path to a bench --moe --json-out file; its measured "
             "capacity_factor_at_peak becomes the MoE dimension's "
             "starting point."),
        Knob("HVDT_AUTOTUNE_PIPELINE", False, _parse_bool,
             "Add a 1F1B microbatch-count dimension to the autotune "
             "search space; builders accepting microbatches= are "
             "rebuilt with it at each knob change."),
        Knob("HVDT_AUTOTUNE_PIPELINE_SEED", "", str,
             "Path to a bench --pipeline --json-out file; its measured "
             "microbatches_at_peak becomes the pipeline dimension's "
             "starting point."),
        Knob("HVDT_AUTOTUNE_MODEL_SEED", "", str,
             "Let autotune consult the static cost model for its "
             "starting legs.  The cost model (analysis/costmodel) is not "
             "ported yet: any value but off raises NotImplementedError "
             "when a starting leg is chosen."),
        Knob("HVDT_TELEMETRY", False, _parse_bool,
             "Step statistics in the bench's JSON line (the StepTimer "
             "snapshot and the goodput fraction).  The exporter, traces "
             "and the flight recorder are not ported yet."),
        Knob("HVDT_COMPILATION_CACHE", "", str,
             "Directory for what the port compiles at run time "
             "(step_pipeline.enable_compilation_cache: the torch inductor "
             "and Triton caches, for callers who torch.compile their own "
             "step).  Empty/off = disabled."),
        Knob("HVDT_COMPILATION_CACHE_MIN_COMPILE_SECS", 1.0, float,
             "The reference's filter of cheap XLA compilations.  Accepted "
             "and without effect in the port: torch's caches keep every "
             "entry."),
        Knob("HVDT_CYCLE_TIME", 0.0, float,
             "Background-loop cycle time in ms for the eager path. 0 = run "
             "as fast as possible (with an idle back-off of up to 2 ms)."),
        Knob("HVDT_BATCH_COLLECTIVES", True, _parse_bool,
             "Pack multiple same-dtype tensors into one fused collective."),
        Knob("HVDT_CACHE_CAPACITY", 1024, int,
             "Response-cache capacity (negotiated-collective descriptors)."),
        Knob("HVDT_TIMELINE", "", str,
             "Write per-tensor Chrome-tracing timeline JSON to this path.  "
             "Not ported yet: the eager controller raises when it is set."),
        Knob("HVDT_STALL_CHECK_DISABLE", False, _parse_bool,
             "Disable stall inspector."),
        Knob("HVDT_STALL_CHECK_TIME_SECONDS", 60, int,
             "Warn when a tensor is ready on some-but-not-all ranks this "
             "long."),
        Knob("HVDT_STALL_SHUTDOWN_TIME_SECONDS", 0, int,
             "Log an error, once, when a tensor has stalled this long "
             "(0 = never).  Logs only: HVDT_STALL_ABORT_TIME_SECONDS is "
             "what fails a stalled op."),
        Knob("HVDT_STALL_ABORT_TIME_SECONDS", 0, int,
             "Stall-escalation abort rung (resilience/escalation.py): past "
             "this age the coordinator aborts the stalled negotiation with "
             "an error response, so waiters raise HorovodInternalError "
             "instead of hanging forever.  0 = disabled."),
        Knob("HVDT_STALL_RESET_TIME_SECONDS", 0, int,
             "Stall-escalation reset rung: past this age a worker "
             "additionally asks the elastic driver for a re-rendezvous.  "
             "0 = disabled.  No effect yet: the elastic launcher is not "
             "ported (ROADMAP Queue 1, item 6), so the rung only logs."),
        Knob("HVDT_CONTROL_PLANE_TIMEOUT_S", 300.0, float,
             "Eager control-plane gather/broadcast timeout — the failure-"
             "detection latency bound: a dead peer surfaces as this timeout "
             "firing, converted to HorovodInternalError."),
        Knob("HVDT_DISABLE_PROFILER_RANGES", False, _parse_bool,
             "Disable the torch.profiler record_function ranges around "
             "eager ops."),
        Knob("HVDT_RANK", -1, int, "Global process rank (set by launcher)."),
        Knob("HVDT_SIZE", -1, int, "Global process count (set by launcher)."),
        Knob("HVDT_LOCAL_RANK", -1, int,
             "Rank within the host (set by launcher)."),
        Knob("HVDT_LOCAL_SIZE", -1, int,
             "Processes on this host (set by launcher)."),
        Knob("HVDT_CROSS_RANK", -1, int, "Host index (set by launcher)."),
        Knob("HVDT_CROSS_SIZE", -1, int, "Number of hosts (set by launcher)."),
        Knob("HVDT_COORDINATOR_ADDR", "", str,
             "host:port of the rendezvous (torch.distributed TCP store)."),
    ]
}


def get(name: str) -> Any:
    return KNOBS[name].read()


def get_bool(name: str) -> bool:
    return bool(get(name))


def get_int(name: str) -> int:
    return int(get(name))


def get_float(name: str) -> float:
    return float(get(name))


def get_str(name: str) -> str:
    return str(get(name))
