"""PyTorch port, ``step_pipeline.donated_step`` on the card: a train step
captured as one CUDA graph against the same step run eagerly.

Every test is marked ``cuda`` and skips without a card.  This file
imports neither JAX nor the JAX package, so it runs where only PyTorch
is installed:

    python -m pytest --noconftest -m cuda \\
        tests/test_torch_port_step_pipeline_card.py

ResNet-26 (10 classes, 64x64, batch 8, bf16 compute, f32 parameters)
with the fused 1x1 convs on (HVDT_FUSED_CONV1X1=1, kernel #4), built
twice from one seed.  One copy takes N steps through ``donated_step``
(an eager step, the capture and its replay, then replays), the other N
eager steps.  Tolerance: none.  The graph replays the kernels the eager
step launches, in the same order, on the same inputs, and cuDNN is held
to deterministic algorithms; so losses, parameters, BatchNorm running
statistics and optimizer state must hold the same bytes.  A learning
rate changed between replays and FusedAdam's bias corrections (read
from device memory that a replay hook refreshes) must therefore match
the eager steps too.
"""

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import step_pipeline as sp
from horovod_tpu_torch.models import ResNetConfig, resnet50_init, resnet_loss
from horovod_tpu_torch.ops import conv_fused as cf
from horovod_tpu_torch.ops import optim_kernels as ok

pytestmark = pytest.mark.cuda

_STEPS = 5


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setenv("HVDT_FUSED_CONV1X1", "1")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    return torch.device("cuda")


@pytest.fixture
def world(card):
    hvd.init()
    yield
    hvd.shutdown()


def _step(model, opt, images, labels):
    opt.zero_grad(set_to_none=True)
    loss, _ = resnet_loss(model, images, labels)
    loss.backward()
    opt.step()
    return loss.detach()


def _batch(device):
    g = torch.Generator(device=device).manual_seed(1)
    images = torch.randn((8, 64, 64, 3), generator=g, device=device)
    labels = torch.randint(0, 10, (8,), generator=g, device=device)
    return images, labels


_OPTS = {
    "sgd": lambda ps: ok.fused_sgd(ps, 0.05, momentum=0.9),
    "adam": lambda ps: ok.fused_adam(ps, 1e-3, weight_decay=1e-4),
    "distributed_sgd": lambda ps: hvd.DistributedOptimizer(
        ok.fused_sgd(ps, 0.05, momentum=0.9)),
    "torch_sgd": lambda ps: torch.optim.SGD(ps, lr=0.05, momentum=0.9),
}


def _lr_key(opt):
    return "lr" if "lr" in opt.param_groups[0] else "learning_rate"


def _run(opt_name, graphed, device, lr_at=None):
    """N steps of one copy; the learning rate is set to a third of its
    value before step ``lr_at`` (0-based) when given."""
    model = resnet50_init(0, ResNetConfig(num_classes=10, depth=26),
                          device=device)
    opt = _OPTS[opt_name](model.parameters())
    images, labels = _batch(device)
    step = sp.donated_step(_step) if graphed else _step
    losses = []
    for k in range(_STEPS):
        if k == lr_at:
            for group in opt.param_groups:
                group[_lr_key(opt)] = group[_lr_key(opt)] / 3
        losses.append(step(model, opt, images, labels).clone())
    torch.cuda.synchronize()
    if graphed:
        assert step.graphed
    return model, opt, torch.stack(losses)


def _state_tensors(opt):
    inner = getattr(opt, "optimizer", opt)
    return {(i, k): v for i, (p, st) in enumerate(inner.state.items())
            for k, v in st.items() if isinstance(v, torch.Tensor)}


_INT_OF_SIZE = {8: torch.int64, 4: torch.int32, 2: torch.int16,
                1: torch.uint8}


def _assert_same(a, b, name=""):
    """The same bytes (so NaNs and signed zeros count too)."""
    assert a.dtype == b.dtype and a.shape == b.shape, name
    it = _INT_OF_SIZE[a.element_size()]
    assert torch.equal(a.contiguous().view(it), b.contiguous().view(it)), name


@pytest.mark.parametrize("opt_name,lr_at", [
    ("sgd", None), ("sgd", 3), ("adam", None), ("adam", 3),
    ("torch_sgd", None)])
def test_graphed_steps_equal_eager_steps(card, opt_name, lr_at):
    gm, gopt, glosses = _run(opt_name, True, card, lr_at)
    em, eopt, elosses = _run(opt_name, False, card, lr_at)
    _assert_same(glosses, elosses)
    for (name, a), (_, b) in zip(gm.state_dict().items(),
                                 em.state_dict().items()):
        _assert_same(a, b, name)
    gs, es = _state_tensors(gopt), _state_tensors(eopt)
    assert gs.keys() == es.keys() and gs
    for key in gs:
        _assert_same(gs[key], es[key], str(key))
    assert gopt.state_dict()["param_groups"] == \
        eopt.state_dict()["param_groups"]
    if opt_name == "adam":
        assert gopt.state_dict()["param_groups"][0]["count"] == _STEPS


def test_several_steps_in_one_graph_equal_eager_steps(card):
    """Two steps a call (the bench's --steps-per-call): each captured
    optimizer step has its own scalar row and hook, so a schedule and
    the count advance step by step."""
    def two_steps(model, opt, images, labels):
        return torch.stack([_step(model, opt, images, labels)
                            for _ in range(2)])

    sched = lambda count: 1e-3 * 0.8 ** count        # noqa: E731
    runs = []
    for graphed in (True, False):
        model = resnet50_init(0, ResNetConfig(num_classes=10, depth=26),
                              device=card)
        opt = ok.fused_adam(model.parameters(), sched)
        images, labels = _batch(card)
        step = sp.donated_step(two_steps) if graphed else two_steps
        losses = torch.cat([step(model, opt, images, labels).clone()
                            for _ in range(4)])
        torch.cuda.synchronize()
        runs.append((losses, model.state_dict(), opt))
    (gl, gsd, gopt), (el, esd, eopt) = runs
    _assert_same(gl, el)
    for name in gsd:
        _assert_same(gsd[name], esd[name], name)
    assert gopt.param_groups[0]["count"] == eopt.param_groups[0]["count"] \
        == 8


def test_overlap_step_runs_cpu_batches_through_the_graph(card):
    """overlap_step.run: CPU batches prefetched to the card (pinned, a
    side stream, the consumer waiting on its event) feed the graphed
    step, which copies each into the graph's inputs; the same as eager
    steps on the same batches."""
    g = torch.Generator().manual_seed(5)
    batches = [(torch.randn((8, 64, 64, 3), generator=g),
                torch.randint(0, 10, (8,), generator=g)) for _ in range(4)]

    def step(model, opt, images, labels):
        _step(model, opt, images, labels)
        return model, opt

    out = []
    for graphed in (True, False):
        model = resnet50_init(0, ResNetConfig(num_classes=10, depth=26),
                              device=card)
        opt = ok.fused_sgd(model.parameters(), 0.05, momentum=0.9)
        if graphed:
            st = sp.overlap_step(step, prefetch_size=2)
            assert st.run((model, opt), batches) == (model, opt)
            assert st.graphed
        else:
            for x, y in batches:
                step(model, opt, x.to(card), y.to(card))
        torch.cuda.synchronize()
        out.append(model.state_dict())
    for name in out[0]:
        _assert_same(out[0][name], out[1][name], name)


def test_lr_change_between_replays_takes_effect(card):
    _, _, changed = _run("sgd", True, card, lr_at=3)
    _, _, kept = _run("sgd", True, card, lr_at=None)
    assert torch.equal(changed[:4], kept[:4])
    assert not torch.equal(changed[4:], kept[4:])


def test_torch_optim_lr_change_after_capture_raises(card):
    """torch.optim.SGD hands its learning rate to its kernels as a Python
    float, which the capture bakes in: a graphed call after a change
    raises instead of training on at the captured rate, and a fresh
    donated_step takes the new rate."""
    model = resnet50_init(0, ResNetConfig(num_classes=10, depth=26),
                          device=card)
    opt = _OPTS["torch_sgd"](model.parameters())
    images, labels = _batch(card)
    step = sp.donated_step(_step)
    for _ in range(3):                      # eager, capture, replay
        step(model, opt, images, labels)
    opt.param_groups[0]["lr"] /= 3
    with pytest.raises(ValueError, match="hyperparameter"):
        step(model, opt, images, labels)
    step = sp.donated_step(_step)
    for _ in range(3):
        assert torch.isfinite(step(model, opt, images, labels))
    assert step.graphed


def test_distributed_optimizer_in_an_nccl_world_of_one(world):
    device = torch.device("cuda")
    _, gopt, glosses = _run("distributed_sgd", True, device)
    _, eopt, elosses = _run("distributed_sgd", False, device)
    _assert_same(glosses, elosses)
    for key, a in _state_tensors(gopt).items():
        _assert_same(a, _state_tensors(eopt)[key])
    assert gopt._passes == eopt._passes == _STEPS


def test_backward_passes_per_step_refuses_a_capture(world):
    """k = 2 no longer refuses a capture: donated_step keeps one graph a
    pass of the cycle (the first eager call of each pass, then a capture
    of each), and the graphed passes equal the eager ones bit for bit
    (tests/test_torch_port_sync_bn_card.py holds more cases)."""
    device = torch.device("cuda")
    out = []
    for graphed in (True, False):
        model = resnet50_init(0, ResNetConfig(num_classes=10, depth=26),
                              device=device)
        opt = hvd.DistributedOptimizer(
            ok.fused_sgd(model.parameters(), 0.05, momentum=0.9),
            backward_passes_per_step=2)
        step = sp.donated_step(_step) if graphed else _step
        images, labels = _batch(device)
        losses = torch.stack([step(model, opt, images, labels).clone()
                              for _ in range(6)])
        torch.cuda.synchronize()
        if graphed:
            assert len(step._graphs) == 2
        out.append((losses, model.state_dict(), opt._passes))
    (gl, gsd, gp), (el, esd, ep) = out
    _assert_same(gl, el)
    for name in gsd:
        _assert_same(gsd[name], esd[name], name)
    assert gp == ep == 6


def test_swapped_donated_tensor_raises(card):
    model = resnet50_init(0, ResNetConfig(num_classes=10, depth=26),
                          device=card)
    opt = ok.fused_sgd(model.parameters(), 0.05, momentum=0.9)
    images, labels = _batch(card)
    step = sp.donated_step(_step)
    for _ in range(3):
        step(model, opt, images, labels)
    step(model, opt, images + 1, labels)        # a new batch is copied in
    with pytest.raises(ValueError, match="argument 2 must be"):
        step(model, opt, images[:4], labels)
    other = resnet50_init(0, ResNetConfig(num_classes=10, depth=26),
                          device=card)
    with pytest.raises(ValueError, match="donated argument 0"):
        step(other, opt, images, labels)
    with torch.no_grad():
        model.fc_b.data = model.fc_b.data.clone()
    with pytest.raises(ValueError, match="donated argument 0"):
        step(model, opt, images, labels)


def test_graphed_step_launches_by_profiler(card):
    """Per replay, one launch of #2 and one of #4 per fused conv (what an
    eager step's counters show); the counters themselves count Python
    calls, which a replay does not make."""
    from torch.profiler import ProfilerActivity, profile

    model = resnet50_init(0, ResNetConfig(num_classes=10, depth=26),
                          device=card)
    opt = ok.fused_sgd(model.parameters(), 0.05, momentum=0.9)
    images, labels = _batch(card)
    cf.matmul_batch_stats.launches = ok._sgd_multi.launches = 0
    step = sp.donated_step(_step)
    step(model, opt, images, labels)
    per_step = cf.matmul_batch_stats.launches
    assert per_step > 0 and ok._sgd_multi.launches == 1
    step(model, opt, images, labels)                  # capture + replay
    assert cf.matmul_batch_stats.launches == 2 * per_step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step(model, opt, images, labels)
        torch.cuda.synchronize()
    assert cf.matmul_batch_stats.launches == 2 * per_step
    assert ok._sgd_multi.launches == 2
    names = {e.key: e.count for e in prof.key_averages()}
    assert names, "the profiler recorded no device activity"
    stats = sum(n for k, n in names.items() if "mm_stats_kernel" in k)
    sgd = sum(n for k, n in names.items() if "optim_multi<false>" in k)
    assert (stats, sgd) == (3 * per_step, 3), names


def test_every_kernel_launcher_replays_in_a_global_capture(card):
    """Each hand-written kernel captured alone in a graph with
    capture_error_mode="global", which refuses any host call a capture
    cannot hold: the launchers' cudaGetDevice, cudaFuncSetAttribute and
    tensor-map encodes are legal there, and a replay writes the bytes an
    eager call writes (#1/#2 are covered by the steps above)."""
    from horovod_tpu_torch.ops import pallas_kernels as pk
    from horovod_tpu_torch.quant import kernels as qk

    g = torch.Generator(device=card).manual_seed(7)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=card).to(dtype)

    a, w = rand(512, 256), rand(256, 384)
    scale, bias = rand(384, dtype=torch.float32), rand(384,
                                                       dtype=torch.float32)
    flat = rand(8 * 256, dtype=torch.float32)
    q8, s8 = qk.quantize_flat(flat, 256)
    q4, s4 = qk.quantize_flat_int4(flat, 256)
    b, l, h, d = 2, 128, 4, 64
    q, k, v, do = (rand(b, l, h, d) for _ in range(4))
    ss = dict(causal=True, scale=d ** -0.5, hb=4)
    fl = dict(causal=True, scale=d ** -0.5, block_q=128, block_k=128)
    out, lse = pk._smallseq_fwd(q, k, v, **ss)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    calls = {
        "#3": lambda: cf.matmul_bn_relu(a, w, scale, bias),
        "#4": lambda: cf.matmul_batch_stats(a, w),
        "#5": lambda: qk.quantize_flat(flat, 256),
        "#6": lambda: qk.dequantize_flat(q8, s8, 256),
        "#7": lambda: qk.quantize_flat_int4(flat, 256),
        "#8": lambda: qk.dequantize_flat_int4(q4, s4, 256),
        "#9": lambda: pk._flash_fwd(q, k, v, None, 0, 0, finish=True, **fl),
        "#10": lambda: pk._flash_dq(q, k, v, do, lse, delta, 0, 0, **fl),
        "#11": lambda: pk._flash_dkv(q, k, v, do, lse, delta, 0, 0, **fl),
        "#12": lambda: pk._smallseq_fwd(q, k, v, **ss),
        "#13": lambda: pk._smallseq_bwd(q, k, v, do, out, lse, **ss)}
    for name, call in calls.items():
        want = call()
        want = want if isinstance(want, tuple) else (want,)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="global"):
            got = call()
        got = got if isinstance(got, tuple) else (got,)
        graph.replay()
        torch.cuda.synchronize()
        assert len(got) == len(want), name
        for x, y in zip(got, want):
            _assert_same(x, y, name)


@pytest.mark.parametrize("fault", ["refused_in_python", "host_sync"])
def test_failed_capture_never_carries_on_eagerly(card, fault):
    """A step whose capture fails raises at the capture and on every
    later call: it never falls back to running eagerly.  The capture
    fails on a refusal raised in Python, or on a host read of a device
    value (``.item()``), which a capture cannot hold.  The host-sync
    case is last in this file: it leaves the card usable, but it is the
    one that makes the CUDA runtime refuse a call."""
    model = resnet50_init(0, ResNetConfig(num_classes=10, depth=26),
                          device=card)
    opt = ok.fused_sgd(model.parameters(), 0.05, momentum=0.9)
    images, labels = _batch(card)

    def step_fn(model, opt, images, labels):
        loss = _step(model, opt, images, labels)
        if fault == "host_sync":
            loss.item()
        elif torch.cuda.is_current_stream_capturing():
            raise ValueError("refused under a capture")
        return loss

    step = sp.donated_step(step_fn)
    assert torch.isfinite(step(model, opt, images, labels))   # eager
    with pytest.raises((RuntimeError, ValueError)):
        step(model, opt, images, labels)                      # the capture
    assert not step.graphed
    with pytest.raises(RuntimeError, match="never carries on eagerly"):
        step(model, opt, images, labels)
    torch.cuda.synchronize()
