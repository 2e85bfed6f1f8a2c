"""PyTorch port, the step pipeline (horovod_tpu_torch/step_pipeline.py)
and device prefetch (data/loader.py), on the CPU.

* ``donated_step`` against the JAX package's ``donated_step`` of the same
  step: ResNet-26 (64x64, batch 4, 10 classes), two ``fused_sgd`` steps
  with the fused 1x1 convs on, both sides restarted from the same state
  before each step (as in test_torch_port_resnet.py, whose helpers and
  tolerances this file uses: loss rtol 1e-5, BN statistics rtol/atol
  1e-4, parameter updates and momenta 3e-2 per tensor and 1.5e-2 over
  all of them, relative L2).  On CPU tensors the step runs eagerly on
  every call, and no kernel launches.
* What a capture defers to its replay hooks, with the capture simulated
  on the CPU (``capturing`` patched true, the kernel launches recorded
  instead of made): FusedSGD/FusedAdam leave their count and scalars
  alone at capture, and each hook writes the scalars an eager step would
  use into the rows the launches read and advances the count;
  DistributedOptimizer's pass count advances per hook, and
  ``backward_passes_per_step > 1`` and the int8 wire raise.
* ``overlap_step.run``, ``prefetch_to_device`` and
  ``enable_compilation_cache`` keep the reference's contract.
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models import resnet as jrn
from horovod_tpu.ops.optim_kernels import fused_sgd as jax_fused_sgd
from horovod_tpu.step_pipeline import donated_step as jax_donated_step
import horovod_tpu_torch as hvd
from horovod_tpu_torch import step_pipeline as sp
from horovod_tpu_torch.common import graphs
from horovod_tpu_torch.convert import (_param_tensors,
                                       optimizer_state_from_jax,
                                       resnet_params_from_jax)
from horovod_tpu_torch.data import loader as tloader
from horovod_tpu_torch.models import resnet as trn
from horovod_tpu_torch.ops import conv_fused as tcf
from horovod_tpu_torch.ops import optim_kernels as tok
from test_torch_port_resnet import (_assert_rel, _assert_stats, _batch,
                                    _jax_cfg, _np, _numpy_init, _port_model)

_LR, _MOMENTUM, _STEPS = 0.01, 0.9, 2


def _port_step(model, opt, images, labels):
    opt.zero_grad(set_to_none=True)
    loss, _ = trn.resnet_loss(model, images, labels)
    loss.backward()
    opt.step()
    return loss.detach()


@pytest.fixture(scope="module")
def jax_steps():
    """Two steps of the JAX donated_step, with the state each starts
    from."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HVDT_FUSED_CONV1X1", "1")
        cfg = _jax_cfg()
        params, stats = _numpy_init(cfg)
        tx = jax_fused_sgd(_LR, momentum=_MOMENTUM, use_kernels=False)
        opt_state = tx.init(params)

        def one_step(params, stats, opt_state, images, labels):
            (loss, new_stats), grads = jax.value_and_grad(
                jrn.resnet_loss, has_aux=True)(params, stats, images,
                                               labels, cfg)
            updates, opt_state = tx.update(grads, opt_state, params)
            return (optax.apply_updates(params, updates), new_stats,
                    opt_state, loss)

        step = jax_donated_step(one_step, donate_argnums=(0, 1, 2))
        out = []
        for k in range(_STEPS):
            x, y = _batch(k)
            before = (_np(params), _np(stats), _np(opt_state.trace))
            params, stats, opt_state, loss = step(
                params, stats, opt_state, jnp.asarray(x), jnp.asarray(y))
            out.append({"before": before, "loss": float(loss),
                        "params": _np(params), "stats": _np(stats),
                        "trace": _np(opt_state.trace)})
    return out


def test_donated_step_matches_jax_donated_step(jax_steps, monkeypatch):
    monkeypatch.setenv("HVDT_FUSED_CONV1X1", "1")
    for counter in (tcf.matmul_batch_stats, tok._sgd_multi):
        monkeypatch.setattr(counter, "launches", 0)
    model = _port_model(*jax_steps[0]["before"][:2])
    opt = tok.fused_sgd(model.parameters(), _LR, momentum=_MOMENTUM)
    step = sp.donated_step(_port_step)
    named = dict(model.named_parameters())
    for k, want in enumerate(jax_steps):
        params, stats, trace = want["before"]
        model.load_state_dict(resnet_params_from_jax(params, stats))
        optimizer_state_from_jax(optax.TraceState(trace=trace), model, opt)
        before = _param_tensors(params)
        x, y = _batch(k)
        loss = step(model, opt, torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(loss.item(), want["loss"], rtol=1e-5)
        _assert_rel({n: (p.detach() - before[n]).numpy()
                     for n, p in named.items()},
                    {n: (p - before[n]).numpy() for n, p in
                     _param_tensors(want["params"]).items()})
        _assert_rel({n: opt.state[p]["trace"].numpy()
                     for n, p in named.items()},
                    {n: t.numpy() for n, t in
                     _param_tensors(want["trace"]).items()})
        _assert_stats(model, want["stats"])
    assert not step.graphed
    assert tcf.matmul_batch_stats.launches == tok._sgd_multi.launches == 0


def test_donated_step_on_cpu_runs_every_call():
    calls = []
    step = sp.donated_step(lambda a, b, x: calls.append(x) or x + 1)
    out = [step(torch.zeros(1), torch.zeros(1), torch.tensor(float(i)))
           for i in range(4)]
    assert [float(o) for o in out] == [1.0, 2.0, 3.0, 4.0]
    assert len(calls) == 4 and not step.graphed


def test_on_replay_refuses_a_foreign_capture():
    assert not sp.capturing()
    with pytest.raises(RuntimeError, match="donated_step"):
        sp.on_replay(lambda: None)


def test_collect_replay_hooks_opens_one_capture_at_a_time():
    with graphs.collect_replay_hooks() as hooks:
        graphs.on_replay(print)
        with pytest.raises(RuntimeError, match="already open"):
            with graphs.collect_replay_hooks():
                pass
    assert hooks == [print]
    with pytest.raises(RuntimeError, match="donated_step"):
        graphs.on_replay(print)


def test_frozen_hyperparameters_are_what_a_replay_keeps():
    """A graphed call raises when these differ from their value at
    capture: every group entry of a torch.optim optimizer (found through
    a ``.optimizer`` wrapper), but only which updates run for the fused
    optimizers, whose scalars a replay hook refreshes."""
    a, b = _two_groups()

    class Wrapper:
        optimizer = torch.optim.SGD([a], lr=0.1, momentum=0.9)

    frozen = sp._frozen_hyperparameters
    before = frozen(Wrapper())
    Wrapper.optimizer.param_groups[0]["lr"] = 0.05
    assert frozen(Wrapper()) != before
    assert frozen([torch.zeros(1), Wrapper.optimizer]) == frozen(Wrapper())

    sgd = tok.fused_sgd([b], 0.1, momentum=0.9)
    before = frozen(sgd)
    sgd.param_groups[0]["lr"] = 0.02
    sgd.param_groups[0]["momentum"] = 0.5
    assert frozen(sgd) == before
    sgd.param_groups[0]["nesterov"] = True
    assert frozen(sgd) != before

    adam = tok.fused_adam([b], lambda count: 1e-3, weight_decay=0.01)
    before = frozen(adam)
    adam.param_groups[0].update(count=7, learning_rate=2e-3,
                                weight_decay=0.02, b1=0.8)
    assert frozen(adam) == before
    adam.param_groups[0]["weight_decay"] = 0.0
    assert frozen(adam) != before


# ---- a capture simulated on the CPU ---------------------------------------


@pytest.fixture
def fake_capture(monkeypatch):
    """``capturing()`` reads true and a capture's hook list is open;
    CPU leaves take the kernel route, and each launch is recorded as
    (entry, scalars passed by value, device scalar address) instead of
    made.  Yields (hooks, launches)."""
    hooks, launches = [], []

    def launch(entry, table, scalars, flags, device, dev_scalars=None):
        launches.append((entry, [float(s) for s in scalars], dev_scalars))

    monkeypatch.setattr(graphs, "capturing", lambda: True)
    monkeypatch.setattr(graphs, "_hooks", hooks)
    monkeypatch.setattr(tok, "_on_cpu", lambda t: False)
    monkeypatch.setattr(tok, "_check_cuda_leaf", tok._check_leaf)
    monkeypatch.setattr(tok, "_launch", launch)
    yield hooks, launches
    tok._sgd_multi.launches = tok._adam_multi.launches = 0


def _two_groups():
    ps = [torch.zeros(4, requires_grad=True), torch.zeros(3, 2,
                                                          requires_grad=True)]
    for p in ps:
        p.grad = torch.ones_like(p)
    return ps


def _row_of(launch, rows_of):
    """The f32 row a launch's device-scalar address points at."""
    _, _, addr = launch
    for rows in rows_of:
        for gi in range(rows.shape[0]):
            if rows[gi].data_ptr() == addr:
                return rows[gi]
    raise AssertionError("launch reads no known row")


def _rows(opt_refresh_hooks):
    """The rows tensors captured by the optimizers' hooks."""
    out = []
    for h in opt_refresh_hooks:
        for cell in h.__closure__ or ():
            if isinstance(cell.cell_contents, torch.Tensor):
                out.append(cell.cell_contents)
    return out


def test_fused_adam_capture_defers_count_and_scalars(fake_capture):
    hooks, launches = fake_capture
    a, b = _two_groups()
    sched = lambda count: 1e-2 * 0.5 ** count        # noqa: E731
    opt = tok.fused_adam([{"params": [a]}, {"params": [b],
                                           "learning_rate": 3e-3}],
                         sched, weight_decay=0.01)
    opt.param_groups[0]["count"] = 2          # two eager steps before
    opt.param_groups[1]["count"] = 2
    opt.step()                                # the captured step
    assert [g["count"] for g in opt.param_groups] == [2, 2]
    assert len(hooks) == 1 and len(launches) == 2
    assert all(addr is not None for _, _, addr in launches)
    rows = _rows(hooks)
    for replay in range(3):
        want = [tok._adam_row(g) for g in opt.param_groups]
        hooks[0]()
        assert [g["count"] for g in opt.param_groups] == [3 + replay] * 2
        for gi, launch in enumerate(launches):
            got = _row_of(launch, rows)[:len(want[gi])]
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(want[gi], np.float32))
    # The scalars of the third replay: lr at count 4, bias corrections
    # at count 5, as the fifth eager step would take them.
    np.testing.assert_array_equal(
        _row_of(launches[0], rows)[:3].numpy(),
        np.asarray(tok._adam_scalars(4, sched, 0.9, 0.999), np.float32))


def test_fused_sgd_capture_reads_lr_per_replay(fake_capture):
    hooks, launches = fake_capture
    a, b = _two_groups()
    opt = tok.fused_sgd([{"params": [a]}, {"params": [b], "lr": 0.5}], 0.1,
                        momentum=0.9)
    opt.step()
    (hook,), rows = hooks, _rows(hooks)
    hook()
    assert _row_of(launches[0], rows)[:2].tolist() == pytest.approx(
        [0.1, 0.9])
    opt.param_groups[0]["lr"] = 0.025
    hook()
    assert _row_of(launches[0], rows)[:2].tolist() == pytest.approx(
        [0.025, 0.9])
    assert _row_of(launches[1], rows)[:2].tolist() == pytest.approx(
        [0.5, 0.9])


def test_plain_leaves_refuse_a_capture(fake_capture):
    a, _ = _two_groups()
    with pytest.raises(ValueError, match="every leaf must take the fused"):
        tok.fused_sgd([a], 0.1).step()        # no momentum: plain update
    with pytest.raises(ValueError, match="every leaf must take the fused"):
        tok.fused_adam([a], 1e-3, use_kernels=False).step()


@pytest.fixture
def world1():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def test_distributed_optimizer_under_capture(fake_capture, world1):
    hooks, _ = fake_capture
    a, b = _two_groups()
    opt = hvd.DistributedOptimizer(tok.fused_sgd([a, b], 0.1, momentum=0.9))
    opt.step()
    assert opt._passes == 0 and len(hooks) == 2
    for _ in range(3):
        for h in hooks:
            h()
    assert opt._passes == 3
    acc = hvd.DistributedOptimizer(tok.fused_sgd([a, b], 0.1, momentum=0.9),
                                   backward_passes_per_step=2)
    with pytest.raises(ValueError, match="backward_passes_per_step"):
        acc.step()
    int8 = hvd.DistributedOptimizer(
        tok.fused_sgd([a, b], 0.1, momentum=0.9),
        compression=hvd.Compression.int8)
    with pytest.raises(NotImplementedError, match="the rest of slice 2"):
        int8.step()
    with pytest.raises(NotImplementedError, match="the rest of slice 2"):
        hvd.quant.with_error_feedback(
            tok.fused_sgd([a, b], 0.1, momentum=0.9)).step()


# ---- overlap_step, prefetch_to_device, the compilation cache --------------


class _Buf:
    def __init__(self, payload):
        self.payload = payload


def test_prefetch_size_zero_raises():
    with pytest.raises(ValueError, match="size >= 1"):
        tloader.prefetch_to_device([1, 2], size=0, device="cpu")
    with pytest.raises(ValueError, match="size >= 1"):
        tloader.prefetch_to_device([1], size=-2, device="cpu")


def test_prefetch_close_drops_queued_batches():
    made = []

    def put(b):
        made.append(_Buf(b))
        return made[-1]

    it = tloader.prefetch_to_device(range(10), size=3, device="cpu",
                                    put=put)
    assert next(it).payload == 0
    queued = [weakref.ref(b) for b in made[1:]]
    del made[:]
    it.close()
    gc.collect()
    assert len(queued) == 2 and all(r() is None for r in queued)
    with pytest.raises(StopIteration):
        next(it)


def test_prefetch_moves_nested_batches_in_order():
    batches = [(torch.full((2,), float(i)), {"y": torch.tensor(i)})
               for i in range(5)]
    out = list(tloader.prefetch_to_device(batches, size=2, device="cpu"))
    assert [float(x[0]) for x, _ in out] == [0, 1, 2, 3, 4]
    assert [int(d["y"]) for _, d in out] == [0, 1, 2, 3, 4]
    assert isinstance(out[0], tuple) and out[0][0].device.type == "cpu"


def test_overlap_step_run_threads_state_and_splats_batches():
    calls = []

    def put(b):
        calls.append(("put", int(b[0][0])))
        return b

    def step(acc, count, x, y):
        calls.append(("step", int(x[0])))
        return acc + x.sum() * y, count + 1

    st = sp.overlap_step(step, prefetch_size=2, device="cpu", put=put)
    acc, count = st.run((torch.zeros(()), 0),
                        [(torch.full((3,), float(i)), 2.0)
                         for i in range(4)])
    assert float(acc) == sum(6.0 * i for i in range(4)) and count == 4
    assert calls.index(("put", 2)) < calls.index(("step", 1))
    assert st.graphed is False              # attributes forward
    with pytest.raises(ValueError, match="prefetch_size >= 1"):
        sp.overlap_step(step, prefetch_size=0)


def test_overlap_step_closes_prefetch_on_error():
    made = []

    def put(b):
        made.append(_Buf(b))
        return made[-1]

    def step(acc, batch):
        if batch.payload >= 1:
            raise RuntimeError("boom")
        return (acc,)

    st = sp.overlap_step(step, donate_argnums=(), prefetch_size=3,
                         device="cpu", put=put)
    with pytest.raises(RuntimeError, match="boom"):
        st.run((0,), list(range(6)))
    refs = [weakref.ref(b) for b in made]
    del made[:]
    gc.collect()
    assert all(r() is None for r in refs), \
        "queued batches must be dropped on an error exit"


def test_enable_compilation_cache(monkeypatch, tmp_path):
    monkeypatch.setattr(sp, "_engaged", None)
    monkeypatch.delenv("HVDT_COMPILATION_CACHE", raising=False)
    for var in ("TORCHINDUCTOR_CACHE_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.delenv(var, raising=False)
    assert sp.enable_compilation_cache() is None          # knob unset
    assert sp.enable_compilation_cache("off") is None
    import os

    assert "TORCHINDUCTOR_CACHE_DIR" not in os.environ
    path = str(tmp_path / "cache")
    monkeypatch.setenv("HVDT_COMPILATION_CACHE", path)
    assert sp.enable_compilation_cache() == path
    assert sp.enable_compilation_cache() == path          # idempotent
    assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == os.path.join(
        path, "inductor")
    assert os.environ["TRITON_CACHE_DIR"] == os.path.join(path, "triton")
    assert os.path.isdir(path)
    assert sp.enable_compilation_cache("none") == path    # off: no-op
    blocked = tmp_path / "file"
    blocked.write_text("")
    assert sp.enable_compilation_cache(str(blocked / "sub")) == path
