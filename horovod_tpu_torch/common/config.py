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
