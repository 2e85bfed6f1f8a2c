"""Elastic state for torch training (ref: horovod/torch/elastic/state.py).

The port's counterpart of the JAX package's ``interop/torch_elastic.py``,
the same handler design: ``TorchState(model=..., optimizer=..., **misc)``
assigns each kwarg as an attribute and routes save/restore/sync through
a type-matched handler (``nn.Module`` -> state_dict deepcopy +
broadcast_parameters, ``Optimizer`` -> state_dict deepcopy +
broadcast_optimizer_state, ``ElasticSampler`` -> state_dict +
broadcast_object), falling back to plain ObjectState pickling for
everything else.  The handler registry is user-extensible
(``set_handler_registry``), matching the reference surface.  The port's
own ``DistributedOptimizer`` wrapper is an optimizer here too.

The snapshots stay on the tensors' devices (a ``state_dict`` deepcopy,
as in the reference), so an in-process restore is a device copy.  With
``path=`` every commit is also written to disk atomically and a freshly
spawned worker resumes from it, as ``elastic.TensorState`` does: the
launcher's process-restart re-rendezvous needs it.  With
``HVDT_PEER_STORE`` set every commit also goes to the peer-replicated RAM
tier as host copies (``resilience/peer_store.py``), and a respawned
worker restores from the newer of the two tiers, each tensor back on its
device.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Tuple

import torch

from ..data.sampler import ElasticSampler
from ..elastic import ObjectState, _Persistent, run  # noqa: F401
from ..functions import broadcast_object
from ..optimizer import _DistributedOptimizer
from . import torch as _binding

__all__ = ["TorchState", "StateHandler", "ModelStateHandler",
           "OptimizerStateHandler", "SamplerStateHandler",
           "get_handler_registry", "set_handler_registry", "run"]


class StateHandler:
    """Per-type save/restore/sync strategy
    (ref: torch/elastic/state.py:71 StateHandler)."""

    def __init__(self, value):
        self.value = value

    def save(self):
        raise NotImplementedError()

    def restore(self):
        raise NotImplementedError()

    def sync(self):
        raise NotImplementedError()

    def set_value(self, value):
        self.value = value
        self.save()


class ModelStateHandler(StateHandler):
    def __init__(self, model):
        super().__init__(model)
        self._saved = copy.deepcopy(self.value.state_dict())

    def save(self):
        self._saved = copy.deepcopy(self.value.state_dict())

    def restore(self):
        self.value.load_state_dict(self._saved)

    def sync(self):
        _binding.broadcast_parameters(self.value.state_dict(), root_rank=0)


class OptimizerStateHandler(StateHandler):
    def __init__(self, optimizer):
        super().__init__(optimizer)
        self._saved = copy.deepcopy(self.value.state_dict())

    def save(self):
        self._saved = copy.deepcopy(self.value.state_dict())

    def restore(self):
        self.value.load_state_dict(self._saved)

    def sync(self):
        _binding.broadcast_optimizer_state(self.value, root_rank=0)


class SamplerStateHandler(StateHandler):
    def __init__(self, sampler):
        super().__init__(sampler)
        self._saved = copy.deepcopy(self.value.state_dict())

    def save(self):
        self._saved = copy.deepcopy(self.value.state_dict())

    def restore(self):
        self.value.load_state_dict(self._saved)

    def sync(self):
        # Broadcast then load so every rank repartitions identically
        # (ref: SamplerStateHandler.sync).
        self.value.load_state_dict(
            broadcast_object(self.value.state_dict(), root_rank=0))


_handler_registry: List[Tuple[type, type]] = [
    (torch.nn.Module, ModelStateHandler),
    (torch.optim.Optimizer, OptimizerStateHandler),
    (_DistributedOptimizer, OptimizerStateHandler),
    (ElasticSampler, SamplerStateHandler),
]


def get_handler_registry():
    return _handler_registry


def set_handler_registry(registry):
    global _handler_registry
    _handler_registry = registry


def _get_handlers(kwargs: Dict[str, Any]):
    handlers, remainder = {}, {}
    for k, v in kwargs.items():
        for handler_type, handler_cls in _handler_registry:
            if isinstance(v, handler_type):
                handlers[k] = handler_cls(v)
                break
        else:
            remainder[k] = v
    return handlers, remainder


class TorchState(_Persistent, ObjectState):
    """State of a torch training process: models, optimizers, samplers
    and arbitrary picklable attributes, with commit/restore/sync routed
    through per-type handlers (ref: torch/elastic/state.py:27
    TorchState — same kwargs contract and attribute exposure).
    ``path``: a disk location for commits (``elastic.TensorState``'s
    ``path=``); without it the state behaves as the reference's.  Give
    each rank a path of its own when ranks hold state of their own (a
    model's BatchNorm statistics over its local batches)."""

    def __init__(self, model=None, optimizer=None, path=None, **kwargs):
        kwargs.update({k: v for k, v in
                       (("model", model), ("optimizer", optimizer))
                       if v is not None})
        handlers, remainder = _get_handlers(kwargs)
        # bypass __setattr__'s handler routing during construction
        object.__setattr__(self, "_handlers", handlers)
        object.__setattr__(self, "_state_path", path)
        for name, handler in handlers.items():
            object.__setattr__(self, name, handler.value)
        super().__init__(**remainder)
        self._resume()

    def _payload_keys(self) -> List[str]:
        return [k for k in super()._payload_keys()
                if k not in self._handlers and k != "restored_from"]

    def _persisted(self):
        return {"objects": self._saved,
                "handlers": {k: h._saved for k, h in self._handlers.items()}}

    def _load_persisted(self, saved) -> None:
        self._saved = saved["objects"]
        for k, h in self._handlers.items():
            h._saved = saved["handlers"][k]

    def save(self) -> None:
        for handler in self._handlers.values():
            handler.save()
        super().save()

    def restore(self) -> None:
        for handler in self._handlers.values():
            handler.restore()
        super().restore()

    def sync(self) -> None:
        for handler in self._handlers.values():
            handler.sync()
        super().sync()

    def __setattr__(self, name, value):
        if hasattr(self, "_handlers") and name in self._handlers:
            self._handlers[name].set_value(value)
        object.__setattr__(self, name, value)
