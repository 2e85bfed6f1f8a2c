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

__all__ = ["Knob", "KNOBS", "get", "get_bool", "get_int", "get_str"]


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
        Knob("HVDT_REMAT", "", str,
             "Activation rematerialization for the transformer block: "
             "'none'/'' (default) saves all activations; 'full' saves "
             "only block inputs (torch.utils.checkpoint per layer); "
             "'dots' is not ported yet and raises."),
        Knob("HVDT_FP8", "off", str,
             "fp8 (e4m3) compute path: off (default) or matmul (the "
             "transformer projections through fp8; not ported yet, so it "
             "raises).  Unknown values raise with the valid list."),
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


def get_str(name: str) -> str:
    return str(get(name))
