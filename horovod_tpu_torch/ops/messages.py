"""Wire messages for the eager negotiation protocol.

A copy of the JAX package's ``ops/messages.py``: the same Request and
Response fields and the same compact JSON, so both packages encode the
same requests and responses to the same strings.  The control plane
(``ops/control_plane.py``) moves these strings through the process
group's c10d store a few times per negotiation cycle.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import List, Optional, Sequence, Tuple

from ..common.types import DataType, ReduceOp

__all__ = ["RequestType", "Request", "Response", "encode_request_list",
           "decode_request_list", "encode_response_list",
           "decode_response_list"]


class RequestType(enum.IntEnum):
    """(ref: message.h:52-60 Request::RequestType)"""

    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2
    JOIN = 3
    ADASUM = 4
    ALLTOALL = 5
    BARRIER = 6
    REDUCESCATTER = 7  # TPU-native extension (first-class on TPU)


@dataclasses.dataclass
class Request:
    """One rank's announcement that a named tensor is ready
    (ref: message.h:50-150)."""

    request_rank: int
    request_type: RequestType
    tensor_name: str
    tensor_type: int               # DataType value
    tensor_shape: Tuple[int, ...]
    reduce_op: int = int(ReduceOp.AVERAGE)
    prescale_factor: float = 1.0
    postscale_factor: float = 1.0
    root_rank: int = -1            # broadcast only
    splits: Tuple[int, ...] = ()   # alltoall only
    process_set_id: int = 0
    group_id: int = -1             # grouped-allreduce membership

    def descriptor(self) -> Tuple:
        """The fields that must agree across ranks (ref: ConstructResponse
        shape/dtype cross-validation, controller.cc:495).  Allgather and
        alltoall legitimately differ in dim 0 across ranks (ragged/uneven),
        so only trailing dims participate for those ops."""
        if self.request_type in (RequestType.ALLGATHER, RequestType.ALLTOALL):
            shape_part = self.tensor_shape[1:]
        else:
            shape_part = self.tensor_shape
        return (self.request_type, self.tensor_type, shape_part,
                self.reduce_op, self.root_rank, self.process_set_id)

    def to_obj(self) -> list:
        return [self.request_rank, int(self.request_type), self.tensor_name,
                self.tensor_type, list(self.tensor_shape), self.reduce_op,
                self.prescale_factor, self.postscale_factor, self.root_rank,
                list(self.splits), self.process_set_id, self.group_id]

    @staticmethod
    def from_obj(o: list) -> "Request":
        return Request(o[0], RequestType(o[1]), o[2], o[3], tuple(o[4]), o[5],
                       o[6], o[7], o[8], tuple(o[9]), o[10], o[11])


@dataclasses.dataclass
class Response:
    """Coordinator's instruction to execute a (possibly fused) collective
    (ref: message.h:153-262 — fused tensor_names + tensor_sizes + error)."""

    response_type: RequestType
    tensor_names: List[str]
    error_message: str = ""
    # per-tensor shapes so joined/late ranks can materialize zero inputs
    # (ref: Response::tensor_sizes)
    tensor_shapes: List[Tuple[int, ...]] = dataclasses.field(default_factory=list)
    tensor_type: int = 0
    reduce_op: int = int(ReduceOp.AVERAGE)
    prescale_factor: float = 1.0
    postscale_factor: float = 1.0
    root_rank: int = -1
    recv_splits: List[Tuple[int, ...]] = dataclasses.field(default_factory=list)
    process_set_id: int = 0
    last_joined_rank: int = -1

    def to_obj(self) -> list:
        return [int(self.response_type), self.tensor_names, self.error_message,
                [list(s) for s in self.tensor_shapes], self.tensor_type,
                self.reduce_op, self.prescale_factor, self.postscale_factor,
                self.root_rank, [list(s) for s in self.recv_splits],
                self.process_set_id, self.last_joined_rank]

    @staticmethod
    def from_obj(o: list) -> "Response":
        return Response(RequestType(o[0]), list(o[1]), o[2],
                        [tuple(s) for s in o[3]], o[4], o[5], o[6], o[7],
                        o[8], [tuple(s) for s in o[9]], o[10], o[11])


def encode_request_list(reqs: Sequence[Request]) -> str:
    return json.dumps({"r": [r.to_obj() for r in reqs]})


def decode_request_list(data: str) -> List[Request]:
    obj = json.loads(data)
    return [Request.from_obj(o) for o in obj["r"]]


def encode_response_list(resps: Sequence[Response]) -> str:
    return json.dumps([r.to_obj() for r in resps])


def decode_response_list(data: str) -> List[Response]:
    return [Response.from_obj(o) for o in json.loads(data)]
