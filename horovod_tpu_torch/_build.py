"""Build the package's CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its
own by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``horovod_tpu_torch/_build/`` (git-ignored), then loaded with
``ctypes``.  The library's file name carries a hash of its source and of
the ``csrc/*.cuh`` headers it includes, so an edited source or header
rebuilds and a stale library is never loaded.  A build
failure raises with the compiler's output: nothing falls back.

``build_all()`` starts one ``nvcc`` per source, all at once, and waits
for them; a caller that wants the build out of the way before timing
anything calls it first.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

__all__ = ["SOURCES", "build_all", "build_log", "load_library", "BUILD_DIR",
           "SRC_DIR"]

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("conv_fused", "quant", "flash_attn", "flash_smallseq", "optim")
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]

_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home
                 else []) + [shutil.which("nvcc") or "",
                             "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every ``csrc`` header it includes with
    ``#include "..."``, directly or through another header."""
    files, todo = [], [SRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        todo += [SRC_DIR / inc.decode()
                 for inc in _INCLUDE.findall(path.read_bytes())]
    return files


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(_ARCH).encode())
    for path in _sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _command(name: str, out: Path) -> List[str]:
    return [_nvcc(), *_ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
            "-fPIC", "-Xptxas", "-v", "-lineinfo", "-o", str(out),
            str(SRC_DIR / f"{name}.cu")]


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together.  Returns name → library path.  The compiler's
    output (``-Xptxas -v``: registers, shared memory, spills) is kept in
    ``_build/<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    paths = {}
    for name in names:
        path = _lib_path(name)
        paths[name] = path
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        log = open(path.with_suffix(".log"), "w")
        try:
            proc = subprocess.Popen(_command(name, tmp), stdout=log,
                                    stderr=subprocess.STDOUT)
        except BaseException:
            log.close()
            raise
        procs.append((name, path, tmp, proc, log))
    failed = []
    for name, path, tmp, proc, log in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append((name, path.with_suffix(".log").read_text()))
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(
            f"--- {name} ---\n{text}" for name, text in failed))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def build_log(name: str) -> Optional[str]:
    """The compiler's output of the last build of ``name``, if any."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else None
