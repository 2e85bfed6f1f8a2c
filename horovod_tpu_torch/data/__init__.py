"""Data subsystem: loaders, async prefetch, device prefetch, samplers
(the JAX package's ``data/`` for the port; Horovod's
data/data_loader_base.py and torch/elastic/sampler.py)."""

from .loader import (AsyncDataLoader, AsyncDataLoaderMixin, BaseDataLoader,
                     prefetch_to_device)
from .sampler import DistributedSampler, ElasticSampler, shard_batch_indices

__all__ = ["BaseDataLoader", "AsyncDataLoaderMixin", "AsyncDataLoader",
           "prefetch_to_device", "DistributedSampler", "ElasticSampler",
           "shard_batch_indices"]
