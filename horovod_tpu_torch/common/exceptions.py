"""Framework exceptions (the same classes as the JAX package's)."""

from __future__ import annotations

__all__ = [
    "HorovodTpuError",
    "HorovodInternalError",
    "HostsUpdatedInterrupt",
    "NotInitializedError",
    "TensorMismatchError",
]


class HorovodTpuError(Exception):
    """Base class for all framework errors."""


class HorovodInternalError(HorovodTpuError):
    """A collective operation failed mid-flight."""


class HostsUpdatedInterrupt(HorovodTpuError):
    """Host membership changed; training should re-rendezvous without
    rolling back state."""

    def __init__(self, skip_sync: bool = False):
        super().__init__()
        self.skip_sync = skip_sync


class NotInitializedError(HorovodTpuError):
    def __init__(self, what: str = "Framework"):
        super().__init__(
            f"{what} has not been initialized; call "
            "horovod_tpu_torch.init() first."
        )


class TensorMismatchError(HorovodTpuError):
    """Shape/dtype/op mismatch across ranks."""
