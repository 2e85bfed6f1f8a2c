"""PyTorch port: Horovod's torch API (``horovod_tpu_torch.interop.torch``).

The JAX package's own tests of its torch binding
(``tests/test_torch_optimizer.py``: ``TestSingleProcess``, ``TestGuards``,
``TestReferenceOptionsParity``, the group with a non-optimized
parameter; ``tests/test_interop_sparse.py``: ``TestTorchInterop`` and
``TestTorchInteropParity``) run here against both packages, in a world of
one, on the same torch inputs (``pkg`` is ``reference`` or ``port``).
Where both train, the losses and parameters agree to rtol 1e-6 (a world
of one reduces nothing; the reference goes through numpy, the port stays
in torch).  The int8 hook path is held to the reference's numpy
``_np_quantize_dequantize`` grid exactly.  A two-process gloo world
(started once) holds the port's optimizer to the global-batch SGD replica
(rtol 1e-5, the reference test's) and its grouped bf16-compressed run to
equal weights on both ranks.

One case differs on purpose: the reference raises on a non-CPU tensor;
the port carries CUDA tensors over NCCL, and only a CUDA tensor in a CPU
(gloo) world raises.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu.interop.torch as jit
from horovod_tpu.ops.compression import Int8Compressor as JInt8
import horovod_tpu_torch as hvd
import horovod_tpu_torch.interop.torch as tit

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def worlds():
    jhvd.init()
    hvd.init(device="cpu")
    yield
    hvd.shutdown()
    jhvd.shutdown()


@pytest.fixture(params=["reference", "port"])
def pkg(request, worlds):
    top = jhvd if request.param == "reference" else hvd
    return types.SimpleNamespace(name=request.param, t=jit if top is jhvd
                                 else tit, top=top)


def _make_model(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Linear(4, 1)


def _train(pkg, steps=40, **kwargs):
    model = _make_model()
    opt = pkg.t.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(), **kwargs)
    torch.manual_seed(1)
    x = torch.randn(32, 4)
    y = x @ torch.tensor([[1.0], [-2.0], [0.5], [3.0]])
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = torch.nn.functional.mse_loss(model(x), y)
        loss.backward()
        opt.step()
        losses.append(float(loss))
    return losses, model


# ---- TestSingleProcess ------------------------------------------------------


def test_wraps_and_trains(pkg):
    losses, _ = _train(pkg, steps=60)
    assert losses[-1] < losses[0] * 0.05


def test_is_a_dynamic_subclass(pkg):
    model = _make_model()
    opt = pkg.t.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    assert isinstance(opt, torch.optim.SGD)
    assert type(opt).__name__ == "DistributedSGD"
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=1, gamma=0.5)
    sched.step()
    assert opt.param_groups[0]["lr"] == 0.05


def test_trains_as_the_reference(worlds):
    got = {}
    for name, t in (("reference", jit), ("port", tit)):
        losses, model = _train(types.SimpleNamespace(t=t), steps=20)
        got[name] = (losses, model.weight.detach().clone())
    np.testing.assert_allclose(got["port"][0], got["reference"][0],
                               rtol=1e-6)
    np.testing.assert_allclose(got["port"][1], got["reference"][1],
                               rtol=1e-6)


def test_backward_passes_per_step_accumulates(pkg):
    model = _make_model()
    opt = pkg.t.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(),
        backward_passes_per_step=2)
    w0 = model.weight.detach().clone()
    x = torch.randn(8, 4)
    (model(x) ** 2).mean().backward()
    with pytest.raises(RuntimeError, match="mid-accumulation"):
        opt.step()
    assert torch.equal(model.weight.detach(), w0)
    (model(x) ** 2).mean().backward()
    opt.step()
    ref = _make_model()
    wr = ref.weight.clone().detach().requires_grad_(True)
    br = ref.bias.clone().detach().requires_grad_(True)
    ((x @ wr.T + br) ** 2).mean().backward()
    torch.testing.assert_close(model.weight.detach(), w0 - 0.1 * wr.grad)


def test_zero_grad_guard(pkg):
    model = _make_model()
    opt = pkg.t.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    (model(torch.randn(4, 4)) ** 2).mean().backward()
    with pytest.raises(RuntimeError, match="outstanding"):
        opt.zero_grad()
    opt.synchronize()
    opt.zero_grad()


def test_named_parameters_must_cover(pkg):
    model = _make_model()
    with pytest.raises(ValueError, match="cover"):
        pkg.t.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=[("w", model.weight)])


# ---- TestGuards -------------------------------------------------------------


def _opt(pkg, model, **kw):
    return pkg.t.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(), **kw)


def test_synchronize_then_clip_then_step(pkg):
    model = _make_model()
    opt = _opt(pkg, model)
    w0 = model.weight.detach().clone()
    ((model(torch.randn(16, 4))) ** 2).mean().backward()
    opt.synchronize()
    g_after_sync = model.weight.grad.detach().clone()
    torch.nn.utils.clip_grad_norm_(model.parameters(), 1e-4)
    opt.step()
    assert (w0 - model.weight.detach()).abs().max() <= 0.1 * 1.2e-4
    assert g_after_sync.abs().max() > 1e-3


def test_over_backward_raises(pkg):
    model = _make_model()
    opt = _opt(pkg, model, backward_passes_per_step=2)
    x = torch.randn(4, 4)
    ((model(x)) ** 2).mean().backward()
    ((model(x)) ** 2).mean().backward()
    with pytest.raises(RuntimeError, match="more than"):
        ((model(x)) ** 2).mean().backward()
    opt.synchronize()


def test_closure_rejected(pkg):
    model = _make_model()
    opt = _opt(pkg, model)
    ((model(torch.randn(4, 4))) ** 2).mean().backward()
    with pytest.raises(ValueError, match="closure"):
        opt.step(lambda: None)
    opt.synchronize()


def test_duplicate_names_rejected(pkg):
    model = _make_model()
    with pytest.raises(ValueError, match="duplicate"):
        pkg.t.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=[("w", model.weight), ("w", model.bias)])


def test_bf16_model_trains(pkg):
    model = _make_model().to(torch.bfloat16)
    opt = _opt(pkg, model)
    x = torch.randn(16, 4, dtype=torch.bfloat16)
    losses = []
    for _ in range(10):
        opt.zero_grad()
        loss = ((model(x)) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert model.weight.dtype == torch.bfloat16
    assert losses[-1] < losses[0]


# ---- TestReferenceOptionsParity ---------------------------------------------


@pytest.mark.parametrize("wire", ["bf16", "fp16"])
def test_cast_compression_trains(pkg, wire):
    losses, _ = _train(pkg, compression=getattr(pkg.top.Compression, wire))
    assert losses[-1] < losses[0] * 0.1


def test_predivide_matches_plain_average(pkg):
    l_plain, _ = _train(pkg, steps=10)
    l_pre, _ = _train(pkg, steps=10, gradient_predivide_factor=4.0)
    np.testing.assert_allclose(l_plain, l_pre, rtol=1e-5)


def test_predivide_requires_average(pkg):
    model = _make_model()
    with pytest.raises(ValueError, match="requires op=Average"):
        pkg.t.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters(),
            op=pkg.top.Sum, gradient_predivide_factor=2.0)


def test_num_groups_trains_same(pkg):
    l_plain, _ = _train(pkg, steps=10)
    l_grp, _ = _train(pkg, steps=10, num_groups=2)
    np.testing.assert_allclose(l_plain, l_grp, rtol=1e-6)


def test_explicit_groups(pkg):
    model = _make_model()
    params = list(model.parameters())
    opt = pkg.t.DistributedOptimizer(
        torch.optim.SGD(params, lr=0.1),
        named_parameters=model.named_parameters(), groups=[params])
    x = torch.randn(16, 4)
    y = torch.zeros(16, 1)
    loss0 = None
    for _ in range(5):
        opt.zero_grad()
        loss = torch.nn.functional.mse_loss(model(x), y)
        loss.backward()
        opt.step()
        loss0 = loss0 or float(loss)
    assert float(loss) < loss0


def test_groups_and_num_groups_mutually_exclusive(pkg):
    model = _make_model()
    with pytest.raises(ValueError, match="not both"):
        pkg.t.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters(),
            num_groups=2, groups=[list(model.parameters())])


def test_sparse_grad_guard_and_densify(pkg):
    emb = torch.nn.Embedding(8, 3, sparse=True)
    opt = pkg.t.DistributedOptimizer(
        torch.optim.SGD(emb.parameters(), lr=0.1),
        named_parameters=emb.named_parameters())
    with pytest.raises(NotImplementedError, match="sparse_as_dense"):
        emb(torch.tensor([1, 2])).sum().backward()

    emb2 = torch.nn.Embedding(8, 3, sparse=True)
    opt2 = pkg.t.DistributedOptimizer(
        torch.optim.SGD(emb2.parameters(), lr=0.5),
        named_parameters=emb2.named_parameters(), sparse_as_dense=True)
    before = emb2.weight.detach().clone()
    emb2(torch.tensor([1, 2])).sum().backward()
    opt2.step()
    del opt
    moved = (before != emb2.weight.detach()).any(dim=1)
    assert moved.tolist() == [False, True, True] + [False] * 5


def test_skip_synchronize_context(pkg):
    model = _make_model()
    opt = _opt(pkg, model)
    x = torch.randn(8, 4)
    model(x).pow(2).mean().backward()
    opt.synchronize()
    torch.nn.utils.clip_grad_norm_(model.parameters(), 1.0)
    with opt.skip_synchronize():
        opt.step()
    model(x).pow(2).mean().backward()
    with pytest.raises(RuntimeError, match="without a prior"):
        with opt.skip_synchronize():
            pass
    opt.step()


def test_group_with_non_optimized_param_still_issues(pkg):
    torch.manual_seed(0)
    body = torch.nn.Linear(4, 4)
    head = torch.nn.Linear(4, 1)
    opt = pkg.t.DistributedOptimizer(
        torch.optim.SGD(head.parameters(), lr=0.1),
        named_parameters=head.named_parameters(),
        groups=[list(body.parameters()) + list(head.parameters())])
    head(body(torch.randn(8, 4))).pow(2).mean().backward()
    opt.step()
    assert all(p.grad is not None for p in head.parameters())


def test_int8_hook_path_is_the_reference_grid(pkg):
    """Compression.int8 snaps each gradient to the int8 block grid in
    the hook; after synchronize every .grad equals the reference's numpy
    grid of the local gradient (a world of one reduces nothing)."""
    torch.manual_seed(3)
    model = torch.nn.Sequential(torch.nn.Linear(300, 7),
                                torch.nn.Linear(7, 2))
    opt = pkg.t.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(),
        compression=pkg.top.Compression.int8)
    x = torch.randn(5, 300)
    model(x).pow(2).sum().backward()
    local = [p.grad.detach().clone() for p in model.parameters()]
    opt.synchronize()
    for p, g in zip(model.parameters(), local):
        want = JInt8._np_quantize_dequantize(g.numpy())
        np.testing.assert_array_equal(p.grad.numpy(), want)
        assert not np.array_equal(want, g.numpy())
    opt.step()


def test_missing_gradient_is_enqueued_as_zeros(pkg):
    """A parameter with no gradient on this rank is enqueued as zeros by
    synchronize() and gets the reduced (zero) gradient."""
    a = torch.ones(3, requires_grad=True)
    b = torch.ones(2, requires_grad=True)
    opt = pkg.t.DistributedOptimizer(torch.optim.SGD([a, b], lr=1.0),
                                     named_parameters=[("a", a), ("b", b)])
    (2 * a.sum()).backward()
    assert b.grad is None
    opt.step()
    assert torch.equal(b.grad, torch.zeros(2))
    assert torch.equal(a, torch.full((3,), -1.0))


# ---- TestTorchInterop / TestTorchInteropParity -------------------------------


def test_allreduce_roundtrip(pkg):
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    out = pkg.t.allreduce(t, name="t0")
    assert isinstance(out, torch.Tensor)
    assert torch.allclose(out, t)


def test_broadcast_parameters_inplace(pkg):
    model = torch.nn.Linear(4, 2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    pkg.t.broadcast_parameters(model.state_dict(), root_rank=0)
    for k, v in model.state_dict().items():
        assert torch.allclose(v, before[k])


def test_broadcast_optimizer_state(pkg):
    model = torch.nn.Linear(3, 1)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    model(torch.ones(2, 3)).sum().backward()
    opt.step()
    before = [opt.state[p]["momentum_buffer"].clone()
              for p in model.parameters()]
    pkg.t.broadcast_optimizer_state(opt, root_rank=0)
    for p, b in zip(model.parameters(), before):
        assert torch.equal(opt.state[p]["momentum_buffer"], b)


def test_alltoall(pkg):
    t = torch.arange(4, dtype=torch.float32)
    out, splits = pkg.t.alltoall(t, name="a2a0")
    assert torch.allclose(out, t)
    assert list(splits) == [4]


def test_non_cpu_tensor(pkg):
    """The one deliberate difference: the reference takes CPU tensors
    only; the port takes CUDA tensors too (over NCCL), and raises only
    for a CUDA tensor in a CPU (gloo) world."""
    if pkg.name == "reference":
        from unittest import mock

        fake = mock.Mock(spec=torch.Tensor)
        fake.device.type = "meta"
        with pytest.raises(ValueError, match="CPU tensors only"):
            jit._to_np(fake)
        return

    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    with pytest.raises(ValueError, match="gloo"):
        tit.allreduce_(torch.ones(2).as_subclass(FakeCuda), name="p_cuda")


def test_async_synchronize_returns_torch(pkg):
    t = torch.arange(4, dtype=torch.float32)
    h = pkg.t.allreduce_async(t, name="p_async")
    assert pkg.t.poll(h) in (True, False)
    out = pkg.t.synchronize(h)
    assert isinstance(out, torch.Tensor)
    assert torch.allclose(out, t)


def test_allreduce_inplace(pkg):
    t = torch.arange(4, dtype=torch.float32)
    expected = t.clone()
    out = pkg.t.allreduce_(t, name="p_inplace")
    assert out is t
    assert torch.allclose(t, expected)


def test_broadcast_inplace_async(pkg):
    t = torch.ones(3)
    out = pkg.t.synchronize(pkg.t.broadcast_async_(t, root_rank=0,
                                                   name="p_bcast"))
    assert out is t
    assert torch.allclose(t, torch.ones(3))


def test_grouped_allreduce_variants(pkg):
    ts = [torch.ones(2), torch.full((3,), 2.0)]
    outs = pkg.t.grouped_allreduce(ts, name="p_grp")
    assert all(isinstance(o, torch.Tensor) for o in outs)
    assert torch.allclose(outs[1], ts[1])
    ts2 = [torch.ones(2), torch.full((3,), 5.0)]
    outs2 = pkg.t.grouped_allreduce_(ts2, name="p_grp_ip")
    assert outs2[0] is ts2[0] and outs2[1] is ts2[1]
    assert torch.allclose(ts2[1], torch.full((3,), 5.0))


def test_alltoall_async(pkg):
    t = torch.arange(4, dtype=torch.float32)
    out, splits = pkg.t.synchronize(pkg.t.alltoall_async(t, name="p_a2a"))
    assert isinstance(out, torch.Tensor)
    assert torch.allclose(out, t)
    assert list(splits) == [4]


def test_sparse_allreduce_async(pkg):
    t = torch.sparse_coo_tensor([[0, 2]], [1.0, 2.0], (4,))
    out = pkg.t.sparse_allreduce_async(t, name="p_sparse", op=None)()
    assert out.is_sparse
    assert torch.allclose(out.to_dense(), torch.tensor([1.0, 0.0, 2.0, 0.0]))


def test_join_barrier(pkg):
    pkg.t.barrier()
    assert pkg.t.join() >= 0


def test_object_helpers_and_compression(pkg):
    assert pkg.t.broadcast_object({"a": 1}, root_rank=0) == {"a": 1}
    assert pkg.t.allgather_object([2, 3]) == [[2, 3]]
    assert pkg.t.Compression.fp16 is not None


def test_top_level_allgather_object(pkg):
    assert pkg.top.allgather_object(7) == [7]


def test_bfloat16_tensor_roundtrip(pkg):
    t = torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)
    out = pkg.t.allreduce(t, name="p_bf16")
    assert out.dtype == torch.bfloat16
    assert torch.allclose(out, t)


def test_requires_grad_param_broadcast_inplace(pkg):
    p = torch.nn.Parameter(torch.ones(3))
    out = pkg.t.broadcast_(p, root_rank=0, name="p_rg")
    assert out is p and p.requires_grad


def test_every_name_of_the_reference(worlds):
    for name in jit.__all__:
        assert getattr(tit, name) is not None, name
    assert tit.SyncBatchNorm.__module__.startswith("horovod_tpu_torch.")
    assert tit.rank() == 0 and tit.size() == 1
    assert tit.Average is hvd.Average
    from horovod_tpu_torch.interop import torch_elastic

    assert tit.elastic is torch_elastic
    assert tit.TorchState is torch_elastic.TorchState
    import horovod_tpu_torch.interop as interop

    for name in ("tf", "mxnet"):
        with pytest.raises(NotImplementedError, match="item 8"):
            getattr(interop, name)
    assert interop.torch is tit


def test_inplace_target_is_held_weakly(worlds):
    """The in-place target lives in the handle's entry as a weak
    reference and is dropped with the entry."""
    import gc

    from horovod_tpu_torch.ops import eager

    t = torch.ones(2)
    h = tit.allreduce_async_(t, name="p_weak")
    ref = eager._controller().handles.take_meta(h)
    assert ref() is t and eager._controller().handles.take_meta(h) is None
    eager._controller().handles.set_meta(h, ref)
    del t
    gc.collect()
    out = tit.synchronize(h)       # target gone: the result comes back
    assert torch.equal(out, torch.ones(2))
    assert eager._controller().handles.take_meta(h) is None


# ---- two processes ----------------------------------------------------------

_WORKER = r"""
import json, sys
import torch
import horovod_tpu_torch.interop.torch as hvd

hvd.init(device="cpu")
r = hvd.rank()
torch.manual_seed(0)
model = torch.nn.Linear(3, 1, bias=False)
opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.5),
                               named_parameters=model.named_parameters())
xs = torch.full((4, 3), float(r + 1))
for _ in range(3):
    opt.zero_grad()
    (model(xs) ** 2).mean().backward()
    opt.step()
out = {"w": model.weight.detach().tolist()}

torch.manual_seed(0)
model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 1))
opt = hvd.DistributedOptimizer(
    torch.optim.SGD(model.parameters(), lr=0.2),
    named_parameters=model.named_parameters(), num_groups=2,
    compression=hvd.Compression.bf16)
for _ in range(3):
    opt.zero_grad()
    (model(xs) ** 2).mean().backward()
    opt.step()
out["grouped"] = [p.detach().tolist() for p in model.parameters()]
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
hvd.shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("interop2")
    env = dict(os.environ, HVDT_SIZE="2",
               HVDT_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
               HVDT_CONTROL_PLANE_TIMEOUT_S="60",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(out / f"r{r}.json")],
        env=dict(env, HVDT_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=90)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [json.loads((out / f"r{r}.json").read_text()) for r in range(2)]


def test_two_process_equivalence(two_ranks):
    """Both ranks end equal, and equal to SGD on the mean of the two
    ranks' gradients (the reference test's replica)."""
    np.testing.assert_allclose(two_ranks[0]["w"], two_ranks[1]["w"],
                               rtol=1e-6)
    torch.manual_seed(0)
    w = torch.nn.Linear(3, 1, bias=False).weight.detach().clone()
    for _ in range(3):
        grads = []
        for r in range(2):
            xs = torch.full((4, 3), float(r + 1))
            wr = w.clone().requires_grad_(True)
            ((xs @ wr.T) ** 2).mean().backward()
            grads.append(wr.grad)
        w = w - 0.5 * (grads[0] + grads[1]) / 2
    np.testing.assert_allclose(two_ranks[0]["w"], w.numpy(), rtol=1e-5)


def test_two_process_grouped_compressed(two_ranks):
    for a, b in zip(two_ranks[0]["grouped"], two_ranks[1]["grouped"]):
        np.testing.assert_allclose(a, b, rtol=1e-5)
