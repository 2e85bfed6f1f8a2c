"""Data loading: device prefetch (``loader.prefetch_to_device``).  The
loaders, the sampler and its cursor wait for ROADMAP Queue 1: runtime
plane."""

from .loader import prefetch_to_device  # noqa: F401
