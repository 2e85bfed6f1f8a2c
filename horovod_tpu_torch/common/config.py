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
