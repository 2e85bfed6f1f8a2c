"""Leveled, rank-tagged logging (the JAX package's ``common/logging_util.py``
for the port; ref: common/logging.{h,cc} LOG(level, rank)).

``HVDT_LOG_LEVEL`` (trace|debug|info|warning|error|fatal, default
warning) sets the level of the ``horovod_tpu_torch`` logger tree on the
first :func:`get_logger` call; ``HVDT_LOG_HIDE_TIME`` drops the
timestamp from each line.  Lines carry the process's ``HVDT_RANK``.

One difference from the reference: the package logger keeps
propagating to the root logger, and the stderr handler is installed
only when the root logger has none (an application's own logging
configuration, or a test's log capture, keeps seeing these records
without printing each line twice).
"""

from __future__ import annotations

import logging
import os
import sys

__all__ = ["get_logger"]

_LEVELS = {
    "trace": 5,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

logging.addLevelName(5, "TRACE")

_ROOT = "horovod_tpu_torch"

_configured = False


def get_logger(name: str = _ROOT) -> logging.Logger:
    """``logging.getLogger(name)``, with the package's handler, format and
    level installed on the first call."""
    global _configured
    logger = logging.getLogger(name)
    if not _configured:
        from . import config

        level = _LEVELS.get(config.get_str("HVDT_LOG_LEVEL").lower(),
                            logging.WARNING)
        root = logging.getLogger(_ROOT)
        root.setLevel(level)
        _configured = True
        if logging.getLogger().handlers:
            return logger
        handler = logging.StreamHandler(sys.stderr)
        rank = os.environ.get("HVDT_RANK", "-")
        if config.get_bool("HVDT_LOG_HIDE_TIME"):
            fmt = f"[%(levelname)s | rank {rank}] %(message)s"
        else:
            fmt = f"%(asctime)s [%(levelname)s | rank {rank}] %(message)s"
        handler.setFormatter(logging.Formatter(fmt))
        root.addHandler(handler)
    return logger
