"""Online inference serving: turn a checkpointed model into an endpoint.

The port's counterpart of the JAX package's ``serve/`` (its LLM decode
engine, ``serve/llm``, is not in this package yet).  Layering, bottom up:

* :mod:`~horovod_tpu_torch.serve.metrics` — Prometheus-text counters /
  gauges / latency summaries (the telemetry module's classes);
* :mod:`~horovod_tpu_torch.serve.engine`  — :class:`InferenceEngine`: one
  CUDA graph per shape bucket, pad-to-bucket, in-place hot weight swap,
  optional mesh sharding;
* :mod:`~horovod_tpu_torch.serve.batcher` — :class:`DynamicBatcher`:
  bounded admission queue + linger-based micro-batching ahead of the
  engine;
* :mod:`~horovod_tpu_torch.serve.reload`  — :class:`CheckpointWatcher`:
  polls a ``CheckpointManager`` directory and hot-swaps newer steps;
* :mod:`~horovod_tpu_torch.serve.server`  — :class:`ModelServer`: stdlib
  HTTP front end (``/predict``, ``/healthz``, ``/metrics``) with 503
  backpressure and SIGTERM graceful drain;
* :mod:`~horovod_tpu_torch.serve.replica` — :class:`ReplicaRegistrar`: KV
  heartbeats (load + p99) that wire one replica into the elastic serving
  control plane, plus the ``--replica-worker`` entry;
* :mod:`~horovod_tpu_torch.serve.router`  — :class:`Router`: the front
  tier — discovers live replicas from the rendezvous KV, load-balances
  ``/predict`` with retries/hedging, ejects SLO-breaching replicas;
* :mod:`~horovod_tpu_torch.serve.autoscale` — :class:`ServeDriver` +
  :class:`AutoscalePolicy`: the driver-side replica autoscaler on the
  pod-aware elastic machinery.

Entry points: ``python -m horovod_tpu_torch.serve`` and ``hvdtrun serve``
(:func:`main`; ``--replicas``/``--autoscale`` switch to the elastic
control plane); in-process embedding through :class:`ModelServer`
(``python -m horovod_tpu_torch.bench --serve`` does this).
"""

from .batcher import (BackpressureError, DispatcherDied,  # noqa: F401
                      DynamicBatcher, RequestDeadlineExceeded)
from .engine import InferenceEngine, parse_buckets  # noqa: F401
from .metrics import MetricsRegistry  # noqa: F401
from .reload import CheckpointWatcher  # noqa: F401
from .server import ModelServer  # noqa: F401

__all__ = [
    "InferenceEngine", "DynamicBatcher", "BackpressureError",
    "DispatcherDied", "RequestDeadlineExceeded",
    "CheckpointWatcher", "ModelServer", "MetricsRegistry",
    "parse_buckets", "main",
]


def main(argv=None) -> int:
    """CLI entry (``python -m horovod_tpu_torch.serve`` / ``hvdtrun
    serve``)."""
    from .__main__ import main as _main

    return _main(argv)
