"""Gradient compression for the wire: fp16/bf16 casts and the int8/int4
block-scaled wires.

The PyTorch counterpart of the JAX package's ``ops/compression.py``.
``wire_dtype`` is what a fused allreduce bucket rides: a torch dtype the
bucket is cast to and back from, or for ``Compression.int8`` / ``.int4``
the sentinel string (``quant.collectives.INT8_WIRE`` / ``INT4_WIRE``)
that routes each float bucket through the two-stage quantized allreduce.
``compress``/``decompress`` are the explicit round trip for user code;
the int8/int4 ``compress`` snaps a float tensor to the wire's grid
(quantize, dequantize) in its own dtype.

``Compression.by_name`` / ``Compression.from_env`` select a compressor by
name (``HVDT_COMPRESSION=none|bf16|fp16|int8|int4``, or ``HVDT_QUANT=1``
as the int8 shorthand, which wins); ``init()``, ``DistributedOptimizer``
and ``allreduce_gradients`` read the environment when ``compression=``
is left unset.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import torch

__all__ = ["Compressor", "NoneCompressor", "FP16Compressor",
           "BF16Compressor", "Int8Compressor", "Int4Compressor",
           "Compression"]


class Compressor:
    """Interface: ``compress`` returns ``(tensor, ctx)``, ``decompress``
    undoes it with that ctx."""

    wire_dtype: Optional[Union[torch.dtype, str]] = None

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


class Int8Compressor(Compressor):
    """Block-scaled symmetric int8 wire (``quant/``).  ``wire_dtype`` is
    the ``INT8_WIRE`` sentinel: ``fused_allreduce`` sends each float
    bucket through the two-stage quantized allreduce.  ``compress``
    returns a float tensor snapped to the int8 grid in its own dtype,
    the value the wire delivers; ``decompress`` is the identity."""

    wire_dtype = "int8_blockwise"   # == quant.collectives.INT8_WIRE

    @staticmethod
    def _qdq(tensor: torch.Tensor) -> torch.Tensor:
        from ..quant import kernels

        return kernels.quantize_dequantize(tensor)

    @classmethod
    def compress(cls, tensor):
        if tensor.is_floating_point():
            return cls._qdq(tensor), None
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class Int4Compressor(Int8Compressor):
    """Packed int4 wire (two codes a byte, absmax/7 block scales): the
    :class:`Int8Compressor` contract on the coarser grid; pair it with
    ``quant.with_error_feedback(..., wire="int4")``."""

    wire_dtype = "int4_blockwise"   # == quant.collectives.INT4_WIRE

    @staticmethod
    def _qdq(tensor: torch.Tensor) -> torch.Tensor:
        from ..quant import kernels

        return kernels.quantize_dequantize_int4(tensor)


class Compression:
    """Option holder."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
    int4 = Int4Compressor

    _BY_NAME = {"none": NoneCompressor, "fp16": FP16Compressor,
                "bf16": BF16Compressor, "int8": Int8Compressor,
                "int4": Int4Compressor}

    @classmethod
    def by_name(cls, name: str) -> type:
        """The compressor called ``name``; an unknown name raises with
        the valid list."""
        key = (name or "none").strip().lower()
        try:
            return cls._BY_NAME[key]
        except KeyError:
            raise ValueError(
                f"unknown compression {name!r}; valid: "
                f"{sorted(cls._BY_NAME)}") from None

    @classmethod
    def from_env(cls) -> type:
        """The compressor the environment selects: ``HVDT_QUANT=1`` is
        int8, else ``HVDT_COMPRESSION`` by name (empty = none)."""
        from ..common import config

        if config.get_bool("HVDT_QUANT"):
            return Int8Compressor
        return cls.by_name(config.get_str("HVDT_COMPRESSION") or "none")
