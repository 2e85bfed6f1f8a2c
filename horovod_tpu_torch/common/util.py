"""Capability predicates, with the JAX package's names
(``hvd.nccl_built()``, ``hvd.mpi_enabled()``, …), so scripts that gate
on them port unchanged.  Each reports what this installation has: NCCL
and gloo as ``torch.distributed`` offers them, CUDA as torch was built;
no MPI, XLA, TPU or native TCP plane exists in the port.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = [
    "mpi_built", "mpi_enabled", "mpi_threads_supported",
    "gloo_built", "gloo_enabled", "nccl_built", "ddl_built", "ccl_built",
    "cuda_built", "rocm_built",
    "xla_built", "tpu_available", "native_built", "tcp_enabled",
]


def mpi_built(verbose: bool = False) -> bool:
    return False


def mpi_enabled() -> bool:
    return False


def mpi_threads_supported() -> bool:
    return False


def gloo_built(verbose: bool = False) -> bool:
    return dist.is_gloo_available()


def gloo_enabled() -> bool:
    """Whether the process group runs over gloo (a CPU world)."""
    return dist.is_initialized() and dist.get_backend() == "gloo"


def nccl_built(verbose: bool = False) -> bool:
    return dist.is_nccl_available()


def ddl_built(verbose: bool = False) -> bool:
    return False


def ccl_built(verbose: bool = False) -> bool:
    return False


def cuda_built(verbose: bool = False) -> bool:
    return torch.version.cuda is not None


def rocm_built(verbose: bool = False) -> bool:
    return getattr(torch.version, "hip", None) is not None


def xla_built(verbose: bool = False) -> bool:
    return False


def tpu_available(verbose: bool = False) -> bool:
    return False


def native_built(verbose: bool = False) -> bool:
    """False: the port has no native TCP/Adasum core; its CUDA kernels
    are built on first use (``_build.py``)."""
    return False


def tcp_enabled() -> bool:
    return False
