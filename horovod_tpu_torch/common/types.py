"""Core framework-neutral types: ``Status``, ``ReduceOp`` and the wire
``DataType``.

Copies of the JAX package's ``common/types.py`` definitions, with the
same values, so code, serialized statuses and the eager path's wire
requests read the same in both packages.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["StatusType", "Status", "ReduceOp", "DataType",
           "DUPLICATE_NAME_ERROR", "data_type_of", "torch_dtype_of"]


class StatusType(enum.IntEnum):
    """Status taxonomy (Horovod's common.h)."""

    OK = 0
    UNKNOWN_ERROR = 1
    PRECONDITION_ERROR = 2
    ABORTED = 3
    INVALID_ARGUMENT = 4
    IN_PROGRESS = 5


@dataclasses.dataclass(frozen=True)
class Status:
    """Operation status."""

    type: StatusType = StatusType.OK
    reason: str = ""

    @staticmethod
    def ok() -> "Status":
        return _OK

    @staticmethod
    def unknown(msg: str) -> "Status":
        return Status(StatusType.UNKNOWN_ERROR, msg)

    @staticmethod
    def precondition(msg: str) -> "Status":
        return Status(StatusType.PRECONDITION_ERROR, msg)

    @staticmethod
    def aborted(msg: str) -> "Status":
        return Status(StatusType.ABORTED, msg)

    @staticmethod
    def invalid_argument(msg: str) -> "Status":
        return Status(StatusType.INVALID_ARGUMENT, msg)

    @staticmethod
    def in_progress() -> "Status":
        return Status(StatusType.IN_PROGRESS, "")

    def ok_p(self) -> bool:
        return self.type == StatusType.OK

    def in_progress_p(self) -> bool:
        return self.type == StatusType.IN_PROGRESS


_OK = Status()

# Error message used when two in-flight tensors share a name.
DUPLICATE_NAME_ERROR = (
    "Requested to collective-op a tensor with the same name as another tensor "
    "that is currently being processed.  If you want to request another tensor, "
    "use a different tensor name."
)


class DataType(enum.IntEnum):
    """Wire dtype enum; the values appear in the serialized requests."""

    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    INT32 = 4
    INT64 = 5
    FLOAT16 = 6
    FLOAT32 = 7
    FLOAT64 = 8
    BOOL = 9
    BFLOAT16 = 10


_TORCH: Dict[DataType, torch.dtype] = {
    DataType.UINT8: torch.uint8,
    DataType.INT8: torch.int8,
    DataType.UINT16: torch.uint16,
    DataType.INT16: torch.int16,
    DataType.INT32: torch.int32,
    DataType.INT64: torch.int64,
    DataType.FLOAT16: torch.float16,
    DataType.FLOAT32: torch.float32,
    DataType.FLOAT64: torch.float64,
    DataType.BOOL: torch.bool,
    DataType.BFLOAT16: torch.bfloat16,
}
_FROM_TORCH = {v: k for k, v in _TORCH.items()}
# numpy dtype names ("bfloat16" is ml_dtypes' name, which numpy arrays
# carry without this package importing ml_dtypes).
_FROM_NAME = {str(v).rsplit(".", 1)[-1]: k for k, v in _TORCH.items()}


def data_type_of(array: Any) -> DataType:
    """The wire DataType of a torch tensor, a numpy array, or a dtype of
    either."""
    dtype = getattr(array, "dtype", array)
    if isinstance(dtype, torch.dtype):
        dt = _FROM_TORCH.get(dtype)
    else:
        dt = _FROM_NAME.get(np.dtype(dtype).name)
    if dt is None:
        raise ValueError(f"Unsupported dtype for collective ops: {dtype}")
    return dt


def torch_dtype_of(dt: int) -> torch.dtype:
    """The torch dtype of a wire DataType (the inverse of
    :func:`data_type_of` on tensors)."""
    return _TORCH[DataType(dt)]


class ReduceOp(enum.IntEnum):
    """Reduction selector; Average is Sum followed by a division by the
    world size (the prescale/postscale split of Horovod's bindings)."""

    AVERAGE = 0
    SUM = 1
    ADASUM = 2
    MIN = 3
    MAX = 4
    PRODUCT = 5
