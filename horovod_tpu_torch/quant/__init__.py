"""Quantized gradient collectives — the block-scaled int8 / packed-int4
wire.

The PyTorch counterpart of the JAX package's ``quant/``:

* :mod:`.kernels` — quantize/dequantize, CUDA kernels for Hopper
  (``csrc/quant.cu``) beside their plain PyTorch versions;
  ``HVDT_QUANT_BLOCK`` / ``HVDT_QUANT_KERNELS``;
* :mod:`.collectives` — the two-stage quantized allreduce over
  ``torch.distributed`` (wired into ``fused_allreduce`` as the
  ``Compression.int8`` / ``.int4`` wire) and the all-gather eager form;
* :mod:`.error_feedback` — ``with_error_feedback(optimizer)`` and the
  reference's stacked-residual helpers;
* :mod:`.fp8` — the per-tensor-scaled e4m3 matmul (``HVDT_FP8``).

Selection: ``DistributedOptimizer(compression=hvd.Compression.int8)``
(or ``.int4``), or env-wide ``HVDT_COMPRESSION=int8|int4`` /
``HVDT_QUANT=1`` when ``compression=`` is left unset.
"""

from __future__ import annotations

from .kernels import (  # noqa: F401
    quant_block_size,
    quant_kernel_eligible,
    quant_kernel_eligible_int4,
    quantize_flat,
    dequantize_flat,
    quantize_dequantize,
    quantize_flat_int4,
    dequantize_flat_int4,
    quantize_dequantize_int4,
    wire_bytes,
    wire_bytes_int4,
)
from .collectives import (  # noqa: F401
    INT8_WIRE,
    INT4_WIRE,
    quant_wire_leg,
    wire_sentinel,
    quantized_allreduce,
    quantized_allreduce_flat,
    eager_quantized_allreduce,
)
from .error_feedback import (  # noqa: F401
    ErrorFeedbackState,
    stack_residual,
    tile_residual,
    unstack_residual,
    with_error_feedback,
)
from . import fp8  # noqa: F401

__all__ = [
    "quant_block_size",
    "quant_kernel_eligible",
    "quant_kernel_eligible_int4",
    "quantize_flat",
    "dequantize_flat",
    "quantize_dequantize",
    "quantize_flat_int4",
    "dequantize_flat_int4",
    "quantize_dequantize_int4",
    "wire_bytes",
    "wire_bytes_int4",
    "INT8_WIRE",
    "INT4_WIRE",
    "quant_wire_leg",
    "wire_sentinel",
    "quantized_allreduce",
    "quantized_allreduce_flat",
    "eager_quantized_allreduce",
    "with_error_feedback",
    "ErrorFeedbackState",
    "tile_residual",
    "stack_residual",
    "unstack_residual",
    "fp8",
]
