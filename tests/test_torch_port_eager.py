"""PyTorch port, the eager core against the JAX package on the CPU.

(a) Wire format: the same requests and responses encode to the same
    JSON strings in both packages, and each decodes the other's.
(b) Coordinator: both packages' controllers (built bare, with no thread)
    are fed the same gathered payloads over a few cycles, with a 3-rank
    process-set table stubbed in both; ``_construct_response_list``
    (which ends in ``_fuse_responses``) must give the same response
    lists, string for string: types, names, order, fusion groups,
    shapes, ``recv_splits``, ``last_joined_rank`` and error messages.
(c) World of one: every public eager function of both packages, on the
    same seeded numpy inputs (and the port's also on torch tensors),
    gives equal outputs, exactly; the torch results keep the input's
    type, device and dtype.

Multi-process gloo worlds are in test_torch_port_eager_worlds.py.
"""

import collections
import itertools
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
from horovod_tpu.common import basics as jbasics
from horovod_tpu.ops import eager as jeager
from horovod_tpu.ops import messages as jmsg
from horovod_tpu.stall import StallInspector as JStall
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics as tbasics
from horovod_tpu_torch.ops import eager as teager
from horovod_tpu_torch.ops import messages as tmsg
from horovod_tpu_torch.stall import StallInspector as TStall

# ---- (a) wire format --------------------------------------------------------


def _requests(msg, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        rt = msg.RequestType(int(rng.integers(0, 8)))
        shape = tuple(int(d) for d in rng.integers(0, 9, rng.integers(0, 4)))
        out.append(msg.Request(
            int(rng.integers(0, 4)), rt, f"t.{seed}.{i}", int(rng.integers(0, 11)),
            shape, int(rng.integers(0, 6)), float(rng.choice([1.0, 0.5, 3])),
            float(rng.choice([1.0, 0.25])), int(rng.integers(-1, 3)),
            tuple(int(s) for s in rng.integers(0, 5, rng.integers(0, 4))),
            int(rng.integers(0, 3)), int(rng.integers(-1, 4))))
    return out


def _responses(msg, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(8):
        n = int(rng.integers(1, 4))
        out.append(msg.Response(
            msg.RequestType(int(rng.integers(0, 8))),
            [f"r.{seed}.{i}.{j}" for j in range(n)],
            "" if rng.random() < 0.7 else f"Mismatched data type for tensor r.{i}.",
            [tuple(int(d) for d in rng.integers(0, 7, 2)) for _ in range(n)],
            int(rng.integers(0, 11)), int(rng.integers(0, 6)),
            float(rng.choice([1.0, 2.0])), float(rng.choice([1.0, 0.5])),
            int(rng.integers(-1, 3)),
            [tuple(int(s) for s in rng.integers(0, 4, 3)) for _ in range(n)],
            int(rng.integers(0, 3)), int(rng.integers(-1, 3))))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_wire_json_equals_reference(seed):
    jreq, treq = _requests(jmsg, seed), _requests(tmsg, seed)
    assert tmsg.encode_request_list(treq) == jmsg.encode_request_list(jreq)
    jresp, tresp = _responses(jmsg, seed), _responses(tmsg, seed)
    assert tmsg.encode_response_list(tresp) == jmsg.encode_response_list(jresp)
    # each decodes the other's string to the same message
    s = jmsg.encode_request_list(jreq)
    assert tmsg.encode_request_list(tmsg.decode_request_list(s)) == s
    s = jmsg.encode_response_list(jresp)
    assert tmsg.encode_response_list(tmsg.decode_response_list(s)) == s
    assert [int(r) for r in tmsg.RequestType] == [int(r) for r in jmsg.RequestType]


def test_descriptor_matches_reference():
    for jr, tr in zip(_requests(jmsg, 7), _requests(tmsg, 7)):
        assert tr.descriptor() == jr.descriptor()


# ---- (b) coordinator --------------------------------------------------------


class _PS:
    def __init__(self, ranks):
        self.ranks = list(ranks)

    def size(self):
        return len(self.ranks)


class _Table:
    sets = {0: _PS([0, 1, 2]), 1: _PS([0, 2])}

    def get(self, ps_id):
        return self.sets[ps_id]


class _State:
    process_set_table = _Table()


class _CP:
    def rank(self):
        return 0

    def size(self):
        return 3


def _bare(eager_mod, stall_cls):
    ctl = object.__new__(eager_mod.EagerController)
    ctl.cp = _CP()
    ctl._cache = eager_mod.ResponseCache(1024)
    ctl._message_table = eager_mod._MessageTable()
    ctl._joined = {}
    ctl._group_members = {}
    ctl._stall = stall_cls(3)
    ctl._escalator = None
    return ctl


@pytest.fixture
def coordinators(monkeypatch):
    monkeypatch.setattr(jbasics, "_global_state", lambda: _State())
    monkeypatch.setattr(tbasics, "_global_state", lambda: _State())
    return (_bare(jeager, JStall), jmsg), (_bare(teager, TStall), tmsg)


def _req(msg, rank, rt, name, dtype, shape, op=0, splits=(), ps=0, group=-1,
         root=-1, pre=1.0):
    return msg.Request(rank, msg.RequestType[rt], name, dtype, tuple(shape),
                       op, pre, 1.0, root, tuple(splits), ps, group)


# Each case: cycles of per-rank request specs ("bits" lists the cache bits a
# rank announces; the caches are filled first from "cache").
F32, F64, I32 = 7, 8, 4
_CASES = {
    "mismatched_dtype": [[
        [("ALLREDUCE", "a", F32, (4,))], [("ALLREDUCE", "a", F64, (4,))],
        [("ALLREDUCE", "a", F32, (4,))]]],
    "mismatched_shape": [[
        [("ALLREDUCE", "b", F32, (4,))], [("ALLREDUCE", "b", F32, (4,))],
        [("ALLREDUCE", "b", F32, (5,))]]],
    "mismatched_op": [[
        [("ALLREDUCE", "c", F32, (4,), 1)], [("ALLREDUCE", "c", F32, (4,), 3)],
        [("ALLREDUCE", "c", F32, (4,), 1)]]],
    "mismatched_type": [[
        [("ALLREDUCE", "d", F32, (4,))], [("ALLGATHER", "d", F32, (4,))],
        [("ALLREDUCE", "d", F32, (4,))]]],
    "ragged_allgather_joined": [
        [[("ALLGATHER", "g", I32, (3, 2))], [("JOIN",)],
         [("ALLGATHER", "g", I32, (1, 2))]],
        [[("JOIN",)], [], [("JOIN",)]]],
    "alltoall_joined": [
        [[("ALLTOALL", "x", F32, (5, 3), 0, (2, 0, 3))], [("JOIN",)], []],
        [[], [], [("ALLTOALL", "x", F32, (4, 3), 0, (1, 1, 2))]],
        [[("JOIN",)], [], [("JOIN",)]]],
    "group_gate": [
        [[("ALLREDUCE", "grp.0", F32, (2,), 0, (), 0, 5),
          ("ALLREDUCE", "solo", F32, (3,))],
         [("ALLREDUCE", "grp.0", F32, (2,), 0, (), 0, 5),
          ("ALLREDUCE", "solo", F32, (3,))],
         [("ALLREDUCE", "grp.0", F32, (2,), 0, (), 0, 5),
          ("ALLREDUCE", "grp.1", F32, (6,), 0, (), 0, 5),
          ("ALLREDUCE", "solo", F32, (3,))]],
        [[("ALLREDUCE", "grp.1", F32, (6,), 0, (), 0, 5)],
         [("ALLREDUCE", "grp.1", F32, (6,), 0, (), 0, 5)], []]],
    "fusion_threshold": [[
        [("ALLREDUCE", f"f{i}", F32, (s,)) for i, s in
         enumerate((10, 20, 30, 5, 40, 1))]
        + [("ALLREDUCE", "f64", F64, (3,)), ("ALLREDUCE", "scalar", F32, ()),
           ("BROADCAST", "bc", F32, (2,), 0, (), 0, -1, 1),
           ("ALLREDUCE", "pre", F32, (2,), 0, (), 0, -1, -1, 2.0)]] * 3],
    "process_set": [[
        [("ALLREDUCE", "s", F32, (2,), 1, (), 1), ("REDUCESCATTER", "rs", F32, (7, 2), 1)],
        [("REDUCESCATTER", "rs", F32, (7, 2), 1)],
        [("ALLREDUCE", "s", F32, (2,), 1, (), 1), ("REDUCESCATTER", "rs", F32, (7, 2), 1)]]],
    "cache_bits": "cache",
}

_CACHED = [("ALLREDUCE", "w0", F32, (8,)), ("ALLREDUCE", "w1", F32, (2, 2)),
           ("ALLGATHER", "w2", I32, (3,))]


def _payload(msg, ctl, rank, specs, bits=()):
    reqs = []
    for spec in specs:
        if spec[0] == "JOIN":
            reqs.append(msg.Request(rank, msg.RequestType.JOIN, "join.0", 0, (),
                                    process_set_id=0))
        else:
            reqs.append(_req(msg, rank, *spec))
    for r in reqs:
        if r.group_id >= 0:
            ctl._group_members.setdefault(r.group_id, set()).add(r.tensor_name)
    return f"{','.join(map(str, bits))}|{msg.encode_request_list(reqs)}"


@pytest.mark.parametrize("case", sorted(_CASES))
def test_coordinator_matches_reference(case, coordinators, monkeypatch):
    monkeypatch.setenv("HVDT_FUSION_THRESHOLD", "200")
    outs = []
    for ctl, msg in coordinators:
        got = []
        if _CASES[case] == "cache":
            for spec in _CACHED:
                ctl._cache.insert(_req(msg, 0, *spec))
            cycles = [[("bits", (0, 1, 2))] * 3,
                      [("bits", (1,)), ("bits", (1,)),
                       ("spec", [("ALLREDUCE", "w1", F32, (2, 2))])],
                      [("bits", (0,)), ("spec", [("ALLREDUCE", "w0", F32, (9,))]),
                       ("bits", (0,))]]
            for cycle in cycles:
                gathered = [_payload(msg, ctl, r, [] if kind == "bits" else v,
                                     v if kind == "bits" else ())
                            for r, (kind, v) in enumerate(cycle)]
                got.append(msg.encode_response_list(
                    ctl._construct_response_list(gathered)))
        else:
            for cycle in _CASES[case]:
                gathered = [_payload(msg, ctl, r, specs)
                            for r, specs in enumerate(cycle)]
                got.append(msg.encode_response_list(
                    ctl._construct_response_list(gathered)))
        outs.append(got)
    assert outs[1] == outs[0]
    assert any(o != "[]" for o in outs[0])


def test_coordinator_fusion_groups_by_threshold(coordinators, monkeypatch):
    """The threshold case fuses into more than one group, and a scalar
    (0 bytes, as in the JAX package) joins a group without filling it."""
    monkeypatch.setenv("HVDT_FUSION_THRESHOLD", "200")
    ctl, msg = coordinators[1]
    gathered = [_payload(msg, ctl, r, _CASES["fusion_threshold"][0][0])
                for r in range(3)]
    resp = ctl._construct_response_list(gathered)
    groups = [r.tensor_names for r in resp]
    assert groups[0] == ["f0", "f1"] and ["scalar"] != groups[-1]
    assert sum(len(g) > 1 for g in groups) >= 2


# ---- (c) world of one -------------------------------------------------------


@pytest.fixture(scope="module")
def worlds():
    jhvd.init()
    hvd.init(device="cpu")
    yield
    hvd.shutdown()
    jhvd.shutdown()


def _fresh_names(monkeypatch):
    monkeypatch.setattr(jeager, "_name_counters",
                        collections.defaultdict(itertools.count))
    monkeypatch.setattr(teager, "_name_counters",
                        collections.defaultdict(itertools.count))


_DTYPES = {"float32": np.float32, "float64": np.float64, "float16": np.float16,
           "bfloat16": ml_dtypes.bfloat16, "int32": np.int32,
           "int64": np.int64, "uint8": np.uint8, "int8": np.int8}


def _input(dtype, shape=(3, 4), seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind in "iu":
        lo = 0 if np.dtype(dtype).kind == "u" else -50
        return rng.integers(lo, 50, shape).astype(dtype)
    return rng.standard_normal(shape).astype(np.float32).astype(dtype)


def _torch_of(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np_of(t, like):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(like.dtype)
    return t.numpy()


def _same(port, ref):
    ref = np.asarray(ref)
    assert isinstance(port, np.ndarray)
    assert port.dtype == ref.dtype and port.shape == ref.shape
    assert port.tobytes() == ref.tobytes()


def _both(fn_name, x, **kw):
    """The reference's and the port's answer for numpy ``x``, and the
    port's for the torch form of ``x`` (as numpy)."""
    ref = getattr(jhvd, fn_name)(x, **kw)
    port_np = getattr(hvd, fn_name)(x, **kw)
    t = _torch_of(x)
    port_t = getattr(hvd, fn_name)(t, **kw)
    return ref, port_np, port_t, t


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("op", ["AVERAGE", "SUM", "MIN", "MAX", "PRODUCT"])
def test_allreduce_world_of_one(worlds, dtype, op):
    x = _input(_DTYPES[dtype])
    ref, port_np, port_t, t = _both("allreduce", x, op=getattr(hvd.ReduceOp, op),
                                    name=f"ar.{dtype}.{op}")
    _same(port_np, ref)
    assert port_t.dtype == t.dtype and port_t.device == t.device
    _same(_np_of(port_t, x), ref)


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("pre,post", [(2.0, 1.0), (1.0, 0.5), (0.5, 3.0),
                                      (2.5, 0.25)])
def test_allreduce_scales_world_of_one(worlds, dtype, pre, post):
    x = _input(_DTYPES[dtype], seed=1)
    ref, port_np, port_t, _ = _both(
        "allreduce", x, op=hvd.Sum, prescale_factor=pre,
        postscale_factor=post, name=f"sc.{dtype}.{pre}.{post}")
    _same(port_np, ref)
    _same(_np_of(port_t, x), ref)


@pytest.mark.parametrize("dtype", ["float32", "int64", "bfloat16"])
def test_gather_broadcast_alltoall_reducescatter_world_of_one(worlds, dtype):
    x = _input(_DTYPES[dtype], (6, 2), seed=2)
    for fn, kw in (("allgather", {}), ("broadcast", {"root_rank": 0}),
                   ("reducescatter", {}),
                   ("reducescatter", {"op": hvd.Max})):
        ref, port_np, port_t, t = _both(fn, x, name=f"{fn}.{dtype}.{len(kw)}",
                                        **kw)
        _same(port_np, ref)
        _same(_np_of(port_t, x), ref)
        assert port_t.dtype == t.dtype
    ref, ref_splits = jhvd.alltoall(x, name=f"a2a.{dtype}")
    out, splits = hvd.alltoall(x, name=f"a2a.{dtype}")
    _same(out, ref)
    assert splits == ref_splits == [6]
    out_t, splits_t = hvd.alltoall(_torch_of(x), splits=[6],
                                   name=f"a2a.t.{dtype}")
    _same(_np_of(out_t, x), ref)
    assert splits_t == [6]
    for mod in (jhvd, hvd):
        with pytest.raises(ValueError, match="splits sum"):
            mod.alltoall(x, splits=[2, 2], name="a2a.bad")


def test_broadcast_scalar_world_of_one(worlds):
    for v in (np.float32(3.5), np.int64(2**40), 7):
        ref = jhvd.broadcast(v, 0, name="bc.scalar")
        out = hvd.broadcast(v, 0, name="bc.scalar")
        _same(out, ref)
    t = hvd.broadcast(torch.tensor(5, dtype=torch.int64), 0, name="bc.t")
    assert t.shape == () and int(t) == 5


def test_grouped_allreduce_world_of_one(worlds):
    xs = [_input(np.float32, (i + 1, 3), seed=i) for i in range(4)]
    ref = jeager.grouped_allreduce(xs, name="grp", op=hvd.Sum,
                                   prescale_factor=0.5)
    port = teager.grouped_allreduce(xs, name="grp", op=hvd.Sum,
                                    prescale_factor=0.5)
    port_t = teager.grouped_allreduce([torch.from_numpy(x) for x in xs],
                                      name="grp.t", op=hvd.Sum,
                                      prescale_factor=0.5)
    for r, p, t in zip(ref, port, port_t):
        _same(p, r)
        _same(t.numpy(), r)


def test_many_tensors_fused_world_of_one(worlds):
    """Twenty allreduces in flight at once are fused and each comes back
    whole (the reference's test_many_tensors_fused, on both packages)."""
    for mod, em in ((jhvd, jeager), (hvd, teager)):
        hs = [em.allreduce_async(np.full((16,), float(i), np.float32),
                                 name=f"fuse.{i}", op=hvd.Sum)
              for i in range(20)]
        for i, h in enumerate(hs):
            np.testing.assert_array_equal(em.synchronize(h),
                                          np.full((16,), float(i)))


def test_auto_names_world_of_one(worlds, monkeypatch):
    _fresh_names(monkeypatch)
    names = []
    for mod, em in ((jhvd, jeager), (hvd, teager)):
        mod.allreduce(np.ones(2, np.float32))
        mod.allreduce(np.ones(3, np.float32))
        mod.allgather(np.ones(2, np.float32))
        mod.broadcast(np.ones(2, np.float32), 0)
        mod.barrier()
        keys = list(em._controller()._cache._entries)
        names.append([k for k in keys if ".noname." in k][-4:])
    assert names[0] == names[1] == ["allreduce.noname.0", "allreduce.noname.1",
                                    "allgather.noname.0", "broadcast.noname.0"]


def test_duplicate_name_world_of_one(worlds):
    msgs = []
    for em in (jeager, teager):
        ctl = em._controller()
        orig = ctl._run_cycle
        ctl._run_cycle = lambda: False      # pause negotiation
        try:
            h = em.allreduce_async(np.ones(3), name="dup")
            with pytest.raises(ValueError) as e:
                em.allreduce_async(np.ones(3), name="dup")
            msgs.append(str(e.value))
        finally:
            ctl._run_cycle = orig
        em.synchronize(h)
    assert msgs[0] == msgs[1] and "same name" in msgs[1]


def test_async_poll_synchronize_world_of_one(worlds):
    for em in (jeager, teager):
        ctl = em._controller()
        orig = ctl._run_cycle
        ctl._run_cycle = lambda: False
        try:
            h = em.allreduce_async(np.arange(5, dtype=np.float32), name="poll")
            time.sleep(0.02)
            assert not em.poll(h)
        finally:
            ctl._run_cycle = orig
        deadline = time.time() + 10
        while not em.poll(h):
            assert time.time() < deadline
            time.sleep(0.001)
        np.testing.assert_array_equal(em.synchronize(h), np.arange(5.0))
        with pytest.raises(ValueError, match="Unknown handle"):
            em.poll(h)


def test_join_barrier_objects_world_of_one(worlds):
    assert hvd.join() == jhvd.join() == 0
    assert hvd.barrier() is None and jhvd.barrier() is None
    obj = {"a": [1, 2], "b": "x"}
    assert hvd.allgather_object(obj) == jhvd.allgather_object(obj)
    idx = np.array([3, 1, 3], np.int64)
    vals = _input(np.float32, (3, 4), seed=5)
    ref = jhvd.sparse_allreduce(idx, vals, (5, 4), name="sp")
    port = hvd.sparse_allreduce(idx, vals, (5, 4), name="sp")
    _same(port.indices, ref.indices)
    _same(port.values, ref.values)
    _same(port.to_dense(), ref.to_dense())
    port_t = hvd.sparse_allreduce(torch.from_numpy(idx),
                                  torch.from_numpy(vals), (5, 4), name="spt")
    _same(port_t.to_dense().numpy(), ref.to_dense())


def test_adasum_and_timeline_raise(worlds, monkeypatch):
    # Adasum is ported (tests/test_torch_port_adasum.py): in a world of
    # one it returns the input; a reducescatter asking for it raises.
    np.testing.assert_array_equal(
        hvd.allreduce(np.arange(3.0), op=hvd.Adasum), np.arange(3.0))
    np.testing.assert_array_equal(
        hvd.grouped_allreduce([np.ones(2)], op=hvd.Adasum)[0], np.ones(2))
    with pytest.raises(ValueError, match="Adasum is an allreduce"):
        hvd.reducescatter(np.ones(2), op=hvd.Adasum)
    # HVDT_TIMELINE is ported (tests/test_torch_port_timeline.py): a
    # controller started with it set opens the timeline instead of
    # raising, and a path it cannot open raises as the reference's does.
    monkeypatch.setenv("HVDT_TIMELINE", "/nonexistent/timeline.json")
    with pytest.raises(FileNotFoundError):
        teager.EagerController()


def test_cuda_tensor_in_cpu_world_raises(worlds, monkeypatch):
    """The eager plane never carries a CUDA tensor through gloo: such a
    call raises at the call site (a fake CUDA tensor stands in for one
    here)."""
    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    t = torch.ones(2).as_subclass(FakeCuda)
    with pytest.raises(ValueError, match="gloo"):
        hvd.allreduce(t, name="cuda.in.gloo")


def test_call_inside_capture_raises(worlds, monkeypatch):
    from horovod_tpu_torch.common import graphs

    monkeypatch.setattr(graphs, "capturing", lambda: True)
    with pytest.raises(RuntimeError, match="cannot run inside a CUDA graph"):
        hvd.allreduce(torch.ones(2), name="in.capture")


def test_process_set_helpers_world_of_one(worlds):
    for mod in (jhvd, hvd):
        ps = mod.add_process_set([0])
        assert ps.ranks == [0] and ps.id == 0
        assert mod.process_set_by_id(0).ranks == [0]
    msgs = []
    for mod in (jhvd, hvd):
        with pytest.raises(Exception) as e:
            mod.remove_process_set(0)
        msgs.append((type(e.value).__name__, str(e.value)))
        with pytest.raises(Exception) as e:
            mod.process_set_by_id(9)
        msgs.append((type(e.value).__name__, str(e.value)))
    assert msgs[:2] == msgs[2:]


def test_devices_and_build_flags(worlds):
    """One device a process in the port (the reference counts every local
    TPU chip, here eight simulated CPU devices): both agree on the
    homogeneity and on num_devices == len(global_devices)."""
    assert hvd.is_homogeneous() == jhvd.is_homogeneous() is True
    for mod in (jhvd, hvd):
        assert mod.num_devices() == len(mod.global_devices())
        assert set(map(str, mod.local_devices())) <= set(
            map(str, mod.global_devices()))
    assert hvd.local_devices() == [torch.device("cpu")]
    flags = ["mpi_built", "mpi_enabled", "mpi_threads_supported", "gloo_built",
             "gloo_enabled", "nccl_built", "ddl_built", "ccl_built",
             "cuda_built", "rocm_built", "xla_built", "tpu_available",
             "native_built", "tcp_enabled"]
    for f in flags:
        assert callable(getattr(jhvd, f)) and isinstance(getattr(hvd, f)(), bool)
    assert hvd.gloo_built() == torch.distributed.is_gloo_available()
    assert hvd.nccl_built() == torch.distributed.is_nccl_available()
    assert hvd.cuda_built() == (torch.version.cuda is not None)
    assert hvd.gloo_enabled() is True
    assert not (hvd.xla_built() or hvd.tpu_available() or hvd.mpi_built())


def test_stall_shutdown_threshold_logs_once(monkeypatch, caplog):
    """HVDT_STALL_SHUTDOWN_TIME_SECONDS logs an error once a stall
    episode (it stops nothing; the abort rung fails a stalled op), and
    resolving the tensor re-arms it."""
    monkeypatch.setenv("HVDT_STALL_CHECK_TIME_SECONDS", "1")
    monkeypatch.setenv("HVDT_STALL_SHUTDOWN_TIME_SECONDS", "2")
    stall = TStall(2)
    errors = []
    for episode in range(2):
        stall.record("t", 0)
        ts, ranks = stall._pending["t"]
        stall._pending["t"] = (ts - 10.0, ranks)
        with caplog.at_level("WARNING", logger="horovod_tpu_torch.stall"):
            for _ in range(3):
                stall._last_check = 0.0
                assert stall.check() == (["t"] if _ == 0 else [])
        errors.append([r.getMessage() for r in caplog.records
                       if r.levelname == "ERROR"])
        caplog.clear()
        stall.resolve("t")
    assert errors == [["Stalled tensor t exceeded shutdown threshold "
                       "(2s)"]] * 2
