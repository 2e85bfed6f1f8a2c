"""Gradient compression for the wire: none, fp16 and bf16 casts.

The PyTorch counterpart of ``Compression.none/.fp16/.bf16`` in the JAX
package's ``ops/compression.py``.  ``wire_dtype`` is the type a fused
allreduce bucket is cast to for the collective and cast back from;
``compress``/``decompress`` are the explicit round trip for user code.
The int8/int4 block-scaled wires are later work (ROADMAP Queue 1,
item 6).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

__all__ = ["Compressor", "NoneCompressor", "FP16Compressor",
           "BF16Compressor", "Compression"]


class Compressor:
    """Interface: ``compress`` returns ``(tensor, ctx)``, ``decompress``
    undoes it with that ctx."""

    wire_dtype: Optional[torch.dtype] = None

    @staticmethod
    def compress(tensor: torch.Tensor) -> Tuple[torch.Tensor, Any]:
        raise NotImplementedError

    @staticmethod
    def decompress(tensor: torch.Tensor, ctx: Any) -> torch.Tensor:
        raise NotImplementedError


class NoneCompressor(Compressor):
    wire_dtype = None

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    @classmethod
    def compress(cls, tensor):
        if tensor.is_floating_point():
            return tensor.to(cls.wire_dtype), tensor.dtype
        return tensor, None

    @classmethod
    def decompress(cls, tensor, ctx):
        return tensor.to(ctx) if ctx is not None else tensor


class FP16Compressor(_CastCompressor):
    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    wire_dtype = torch.bfloat16


class Compression:
    """Option holder."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
