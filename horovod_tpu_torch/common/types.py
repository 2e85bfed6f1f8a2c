"""Core framework-neutral types: ``Status`` and ``ReduceOp``.

Copies of the JAX package's ``common/types.py`` definitions, with the
same values, so code and serialized statuses read the same in both
packages.
"""

from __future__ import annotations

import dataclasses
import enum

__all__ = ["StatusType", "Status", "ReduceOp"]


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


class ReduceOp(enum.IntEnum):
    """Reduction selector; Average is Sum followed by a division by the
    world size (the prescale/postscale split of Horovod's bindings)."""

    AVERAGE = 0
    SUM = 1
    ADASUM = 2
    MIN = 3
    MAX = 4
    PRODUCT = 5
