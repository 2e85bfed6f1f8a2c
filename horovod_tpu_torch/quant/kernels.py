"""Block-scaled symmetric int8/int4 quantize/dequantize.

The PyTorch counterpart of the JAX package's ``quant/kernels.py``: the
wire format of the quantized gradient collectives.  int8: a flat float
vector is cut into blocks of ``HVDT_QUANT_BLOCK`` elements; each block
carries one f32 scale ``absmax * f32(1/127)`` and its elements as int8
``round_half_even(x * (1/scale))`` clipped to [-127, 127] (1 + 4/block
bytes an element).  int4: scale ``absmax * f32(1/7)``, codes clipped to
[-7, 7] and packed two to a byte, half-split: byte ``j`` of a block holds
element ``j`` in its low nibble and element ``j + block/2`` in its high
one (0.5 + 4/block bytes an element).

Four kernels, written in CUDA C++ for Hopper in ``csrc/quant.cu`` (its
header says what bounds them and how the design answers it), each beside
its plain PyTorch version with the same arithmetic:

* ``_quantize_cuda``    (replaces ``_quant_kernel``)    — #5;
* ``_dequantize_cuda``  (replaces ``_dequant_kernel``)  — #6;
* ``_quantize4_cuda``   (replaces ``_quant4_kernel``)   — #7;
* ``_dequantize4_cuda`` (replaces ``_dequant4_kernel``) — #8.

``HVDT_QUANT_KERNELS`` (or ``use_kernels=``) picks the route: ``auto``
(default) launches the kernel for a CUDA tensor and takes the plain
version for a CPU tensor; ``on`` (``use_kernels=True``) launches the
kernel and raises for a CPU tensor; ``off`` (``use_kernels=False``) takes
the plain version everywhere.  The kernels take any whole-block size and
any block (any even block for int4): the TPU's (32, 128) int8 tile floor,
which :func:`quant_kernel_eligible` keeps describing because the JAX
package's tests pin its meaning, does not route anything here.
``launches`` on each ``_*_cuda`` wrapper counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..common import config

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
]

# The TPU lowering's tile floors, kept for quant_kernel_eligible*.
_LANES = 128
_INT8_SUBLANE = 32


def quant_block_size() -> int:
    """The block-scaling granularity (``HVDT_QUANT_BLOCK``, default 256
    elements)."""
    block = config.get_int("HVDT_QUANT_BLOCK")
    return block if block > 0 else 256


def quant_kernel_eligible(size: int, block: int) -> bool:
    """The JAX package's Pallas gate: whole blocks, a lane-aligned block
    and a power-of-2 block-row divisor of at least 32.  Kept with the
    reference's meaning; the Hopper kernels do not consult it."""
    if block <= 0 or block % _LANES or size <= 0 or size % block:
        return False
    nblocks = size // block
    return (nblocks & -nblocks) >= _INT8_SUBLANE


def quant_kernel_eligible_int4(size: int, block: int) -> bool:
    """The JAX package's int4 Pallas gate: :func:`quant_kernel_eligible`
    plus a lane-aligned packed half-block (``block % 256 == 0``)."""
    return (quant_kernel_eligible(size, block)
            and (block // 2) % _LANES == 0)


def _use_kernel(t: torch.Tensor, use_kernels: Optional[bool]) -> bool:
    """True to launch the CUDA kernel for ``t``, False for the plain
    version; raises when the kernel is asked for a CPU tensor."""
    if use_kernels is None:
        mode = config.get_str("HVDT_QUANT_KERNELS").strip().lower()
        use_kernels = {"on": True, "off": False}.get(mode)
    if use_kernels is False:
        return False
    if t.device.type == "cuda":
        return True
    if use_kernels:
        raise ValueError(
            "the quantization kernels run on CUDA tensors, got one on "
            f"{t.device} (HVDT_QUANT_KERNELS=on or use_kernels=True)")
    return False


# ---- plain versions --------------------------------------------------------

# f32(1/127) and f32(1/7): the reference multiplies by these constants.
_INV127 = 1.0 / 127.0
_INV7 = 1.0 / 7.0


def _scale_and_codes(x2: torch.Tensor, inv_levels: float, levels: float):
    """Per-row scale ([nblocks, 1] f32) and f32 integer codes."""
    absmax = x2.abs().amax(dim=1, keepdim=True)
    scale = absmax * torch.tensor(inv_levels, dtype=torch.float32)
    pos = scale > 0
    # All-zero block: scale 0, codes 0 (never 0/0).
    inv = torch.where(pos, 1.0 / torch.where(pos, scale, 1.0), 0.0)
    return scale, torch.clamp(torch.round(x2 * inv), -levels, levels)


def _quantize_plain(x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale, codes = _scale_and_codes(x2, _INV127, 127.0)
    return codes.to(torch.int8), scale[:, 0]


def _dequantize_plain(q2: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return q2.to(torch.float32) * scales[:, None]


def _quantize4_plain(x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale, codes = _scale_and_codes(x2, _INV7, 7.0)
    c = codes.to(torch.int32)
    half = c.shape[1] // 2
    packed = (c[:, :half] & 0xF) | ((c[:, half:] & 0xF) << 4)
    return packed.to(torch.uint8).view(torch.int8), scale[:, 0]


def _dequantize4_plain(p2: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    b = p2.view(torch.uint8).to(torch.int32)
    nib = torch.cat([b & 0xF, b >> 4], dim=1)
    codes = torch.where(nib >= 8, nib - 16, nib)
    return codes.to(torch.float32) * scales[:, None]


# ---- CUDA kernels ----------------------------------------------------------


def _lib() -> ctypes.CDLL:
    from .._build import load_library

    lib = load_library("quant")
    if not getattr(lib, "_hvdt_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for name in ("hvdt_quant_int8", "hvdt_dequant_int8",
                     "hvdt_quant_int4", "hvdt_dequant_int4"):
            fn = getattr(lib, name)
            fn.argtypes = [p, p, p, ll, i, p]
            fn.restype = i
        lib._hvdt_typed = True
    return lib


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
                scales: Optional[torch.Tensor] = None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} takes {dtype}, got {t.dtype}")
    if t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name} takes a contiguous [nblocks, width] "
                         f"tensor, got shape {tuple(t.shape)}")
    if scales is not None:
        if scales.device != t.device or scales.dtype != torch.float32:
            raise TypeError(f"{name}: scales must be f32 on {t.device}, got "
                            f"{scales.dtype} on {scales.device}")
        if scales.shape != (t.shape[0],) or not scales.is_contiguous():
            raise ValueError(f"{name}: scales must be contiguous "
                             f"[{t.shape[0]}], got {tuple(scales.shape)}")


def _launch(name: str, *args) -> None:
    """Call the C entry ``name`` on the current stream of the first
    tensor's device; raises on a CUDA error."""
    dev = args[0].device
    ptrs = [a.data_ptr() for a in args[:3]]
    with torch.cuda.device(dev):
        rc = getattr(_lib(), name)(*ptrs, *args[3:],
                                   torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _quantize_cuda(x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """#5: f32 [nblocks, block] -> int8 [nblocks, block], f32 [nblocks]."""
    _check_cuda("_quantize_cuda", x2, torch.float32)
    nblocks, block = x2.shape
    q = torch.empty((nblocks, block), dtype=torch.int8, device=x2.device)
    scales = torch.empty(nblocks, dtype=torch.float32, device=x2.device)
    _launch("hvdt_quant_int8", x2, q, scales, nblocks, block)
    _quantize_cuda.launches += 1
    return q, scales


def _dequantize_cuda(q2: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """#6: int8 [nblocks, block] x f32 [nblocks] -> f32 [nblocks, block]."""
    _check_cuda("_dequantize_cuda", q2, torch.int8, scales)
    out = torch.empty(q2.shape, dtype=torch.float32, device=q2.device)
    _launch("hvdt_dequant_int8", q2, scales, out, *q2.shape)
    _dequantize_cuda.launches += 1
    return out


def _quantize4_cuda(x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """#7: f32 [nblocks, block] -> int8 [nblocks, block/2] (two codes a
    byte, half-split), f32 [nblocks]."""
    _check_cuda("_quantize4_cuda", x2, torch.float32)
    nblocks, block = x2.shape
    if block % 2:
        raise ValueError(f"int4 wire needs an even block size, got {block}")
    p = torch.empty((nblocks, block // 2), dtype=torch.int8, device=x2.device)
    scales = torch.empty(nblocks, dtype=torch.float32, device=x2.device)
    _launch("hvdt_quant_int4", x2, p, scales, nblocks, block)
    _quantize4_cuda.launches += 1
    return p, scales


def _dequantize4_cuda(p2: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """#8: int8 [nblocks, block/2] x f32 [nblocks] -> f32 [nblocks, block]."""
    _check_cuda("_dequantize4_cuda", p2, torch.int8, scales)
    nblocks, half = p2.shape
    out = torch.empty((nblocks, 2 * half), dtype=torch.float32,
                      device=p2.device)
    _launch("hvdt_dequant_int4", p2, scales, out, nblocks, 2 * half)
    _dequantize4_cuda.launches += 1
    return out


for _fn in (_quantize_cuda, _dequantize_cuda, _quantize4_cuda,
            _dequantize4_cuda):
    _fn.launches = 0


# ---- public API ------------------------------------------------------------


def _rows(flat: torch.Tensor, block: int, name: str, pad_hint: str
          ) -> torch.Tensor:
    """``flat`` as f32 [nblocks, block], contiguous."""
    if flat.dim() != 1:
        raise ValueError(f"{name} takes a 1-D vector, got shape "
                         f"{tuple(flat.shape)}")
    if flat.numel() % block:
        raise ValueError(
            f"size {flat.numel()} is not a whole number of {block}-element "
            f"blocks — pad first ({pad_hint} does)")
    return flat.to(torch.float32).contiguous().view(-1, block)


def quantize_flat(flat: torch.Tensor, block_size: Optional[int] = None,
                  use_kernels: Optional[bool] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize a flat float vector whose size divides into whole
    blocks.  Returns ``(q, scales)``: int8 ``[size]`` and f32
    ``[size // block]``.  Callers own padding."""
    block = block_size or quant_block_size()
    x2 = _rows(flat, block, "quantize_flat", "quantize_dequantize")
    if x2.shape[0] and _use_kernel(x2, use_kernels):
        q2, scales = _quantize_cuda(x2)
    else:
        q2, scales = _quantize_plain(x2)
    return q2.reshape(-1), scales


def dequantize_flat(q: torch.Tensor, scales: torch.Tensor,
                    block_size: Optional[int] = None,
                    use_kernels: Optional[bool] = None) -> torch.Tensor:
    """Inverse of :func:`quantize_flat`; returns f32 ``[size]``."""
    block = block_size or quant_block_size()
    q2 = q.reshape(-1, block)
    if q2.shape[0] and _use_kernel(q2, use_kernels):
        out = _dequantize_cuda(q2.contiguous(), scales.contiguous())
    else:
        out = _dequantize_plain(q2, scales)
    return out.reshape(-1)


def _round_trip(x: torch.Tensor, block: int, quantize, dequantize,
                use_kernels: Optional[bool]) -> torch.Tensor:
    """pad -> quantize -> dequantize -> unpad, in x's shape and dtype."""
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    q, scales = quantize(flat, block, use_kernels)
    out = dequantize(q, scales, block, use_kernels)
    if pad:
        out = out[:-pad]
    return out.reshape(x.shape).to(x.dtype)


def quantize_dequantize(x: torch.Tensor, block_size: Optional[int] = None,
                        use_kernels: Optional[bool] = None) -> torch.Tensor:
    """Round-trip a float tensor of any shape through the int8 wire
    format (pad, quantize, dequantize, unpad), in its shape and dtype:
    the value the wire carries, which error feedback subtracts."""
    return _round_trip(x, block_size or quant_block_size(), quantize_flat,
                       dequantize_flat, use_kernels)


def wire_bytes(size: int, block_size: Optional[int] = None) -> int:
    """Bytes of the int8 wire format for ``size`` elements: 1 B an
    element plus one f32 scale a (padded) block."""
    block = block_size or quant_block_size()
    nblocks = -(-size // block)
    return nblocks * block + nblocks * 4


def quantize_flat_int4(flat: torch.Tensor, block_size: Optional[int] = None,
                       use_kernels: Optional[bool] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int4 sibling of :func:`quantize_flat`.  Returns ``(packed,
    scales)``: int8 ``[size // 2]`` (two codes a byte, half-split) and
    f32 ``[size // block]``."""
    block = block_size or quant_block_size()
    if block % 2:
        raise ValueError(f"int4 wire needs an even block size, got {block}")
    x2 = _rows(flat, block, "quantize_flat_int4", "quantize_dequantize_int4")
    if x2.shape[0] and _use_kernel(x2, use_kernels):
        p2, scales = _quantize4_cuda(x2)
    else:
        p2, scales = _quantize4_plain(x2)
    return p2.reshape(-1), scales


def dequantize_flat_int4(packed: torch.Tensor, scales: torch.Tensor,
                         block_size: Optional[int] = None,
                         use_kernels: Optional[bool] = None) -> torch.Tensor:
    """Inverse of :func:`quantize_flat_int4`; ``packed`` holds
    ``size // 2`` bytes, returns f32 ``[size]``."""
    block = block_size or quant_block_size()
    p2 = packed.reshape(-1, block // 2)
    if p2.shape[0] and _use_kernel(p2, use_kernels):
        out = _dequantize4_cuda(p2.contiguous(), scales.contiguous())
    else:
        out = _dequantize4_plain(p2, scales)
    return out.reshape(-1)


def quantize_dequantize_int4(x: torch.Tensor,
                             block_size: Optional[int] = None,
                             use_kernels: Optional[bool] = None
                             ) -> torch.Tensor:
    """int4 sibling of :func:`quantize_dequantize`."""
    return _round_trip(x, block_size or quant_block_size(),
                       quantize_flat_int4, dequantize_flat_int4, use_kernels)


def wire_bytes_int4(size: int, block_size: Optional[int] = None) -> int:
    """Bytes of the int4 wire format: 0.5 B an element plus one f32
    scale a (padded) block."""
    block = block_size or quant_block_size()
    nblocks = -(-size // block)
    return nblocks * (block // 2) + nblocks * 4
