"""PyTorch port on the card: ZeRO (ops/zero.py) and checkpoints
(checkpoint.py) in an NCCL world of one.

Every test is marked ``cuda`` and skips without a card.  This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_port_zero_card.py

* #1 (``hvdt_adam_multi``) and #2 (``hvdt_sgd_multi``) on ZeRO shard
  rows (one multi-tensor launch over every bucket's rows, ``APPLY`` on
  the parameter rows under ``params``) give the bytes of their plain
  versions (``use_kernels=False``), moments and deltas alike.
* A graphed ``DistributedOptimizer(zero="states"|"params")`` step
  (``donated_step``) equals the eager one, and the replicated optimizer,
  bit for bit: ResNet-26 (10 classes, 64x64, batch 8) with
  deterministic cuDNN.
* ``CheckpointManager.save_async`` of CUDA tensors that the next replay
  updates in place restores the snapshot, not the update.
* A restore (``restore_checkpoint(in_place=True)`` and
  ``load_zero_state``) into a captured step replays from the restored
  state, equal to an uninterrupted run.
Tolerance: none.
"""

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import checkpoint as ckpt
from horovod_tpu_torch import step_pipeline as sp
from horovod_tpu_torch.models import ResNetConfig, resnet50_init, resnet_loss
from horovod_tpu_torch.ops import optim_kernels as ok
from horovod_tpu_torch.ops import zero as tz

pytestmark = pytest.mark.cuda

_STEPS = 4


@pytest.fixture
def world(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    monkeypatch.setenv("HVDT_FUSION_THRESHOLD", str(1024 * 1024))
    for k in ("HVDT_OVERLAP", "HVDT_ZERO", "HVDT_ASYNC_CKPT"):
        monkeypatch.delenv(k, raising=False)
    tz.reset()
    hvd.init()
    yield torch.device("cuda")
    hvd.shutdown()


def _same(a, b):
    """Same bytes in logical order (``reshape(-1)``: a 1x1 conv weight's
    ``contiguous()`` keeps its channels_last strides)."""
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))


def _leaves(dtype=torch.float32):
    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(300, 130), (130,), (64, 3, 3, 32), (7,), (5000,)]
    return [torch.randn(s, generator=g, device="cuda").to(dtype)
            for s in shapes]


@pytest.mark.parametrize("kind", ["sgd", "adam"])
@pytest.mark.parametrize("stage", ["states", "params"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_on_shard_rows_match_plain(world, kind, stage, dtype):
    ps = _leaves(dtype)
    out = {}
    for use in (True, False):
        kw = dict(stage=stage, num_shards=4, threshold_bytes=200_000,
                  use_kernels=use)
        tx = (tz.zero_sgd(0.05, momentum=0.9, nesterov=True, **kw)
              if kind == "sgd"
              else tz.zero_adam(1e-2, weight_decay=0.1, **kw))
        params = [p.clone() for p in ps]
        st = tx.init(params)
        pshards = tx.shard_params(params) if stage == "params" else None
        ok._sgd_multi.launches = ok._adam_multi.launches = 0
        deltas = []
        for s in range(3):
            g = torch.Generator(device="cuda").manual_seed(10 + s)
            grads = [torch.randn(p.shape, generator=g, device="cuda").to(dtype)
                     for p in params]
            if stage == "params":
                upd, st = tx.update(grads, st, pshards, apply=(s == 2))
                if upd is not None:
                    deltas += list(upd)
                    pshards = tuple(a + b for a, b in zip(pshards, upd))
            else:
                upd, st = tx.update(grads, st, params)
                deltas += upd
                params = [a + b for a, b in zip(params, upd)]
        launches = ok._sgd_multi.launches + ok._adam_multi.launches
        # One launch a step over every bucket's rows (one dtype here).
        assert launches == (3 if use else 0), launches
        stacks = [t for _, ss in tz._state_stacks(st) for t in ss]
        out[use] = (stacks, deltas, list(pshards or ()))
    for a, b in zip(*(sum(out[u], []) for u in (True, False))):
        _same(a, b)


def _model():
    return resnet50_init(0, ResNetConfig(depth=26, num_classes=10))


def _batch(seed=3):
    g = torch.Generator(device="cuda").manual_seed(seed)
    images = torch.randn((8, 64, 64, 3), generator=g, device="cuda",
                         dtype=torch.bfloat16)
    labels = torch.randint(0, 10, (8,), generator=g, device="cuda")
    return images, labels


def _step(model, opt, images, labels):
    gather = getattr(opt, "gather_params", None)
    if gather is not None:
        gather()
    opt.zero_grad(set_to_none=True)
    loss, _ = resnet_loss(model, images, labels)
    loss.backward()
    opt.step()
    return loss.detach()


def _opt(model, kind, stage):
    inner = (hvd.fused_sgd(model.parameters(), 0.01, momentum=0.9)
             if kind == "sgd"
             else hvd.fused_adam(model.parameters(), 1e-3, weight_decay=1e-4))
    return hvd.DistributedOptimizer(inner, zero=stage or "off")


def _state(model, opt):
    out = [v.detach().clone() for v in model.state_dict().values()]
    if hasattr(opt, "transform"):
        opt.gather_params()
        out = [v.detach().clone() for v in model.state_dict().values()]
        full = opt.transform.full_state(opt.gathered_zero_state(),
                                        opt._zparams)
        for name in ("mu", "nu", "trace"):
            out += [v.clone() for v in full.get(name, [])]
    else:
        params = [p for g in opt.optimizer.param_groups for p in g["params"]]
        for name in ("mu", "nu", "trace"):
            out += [opt.optimizer.state[p][name].clone() for p in params
                    if name in opt.optimizer.state[p]]
    return out


def _run(kind, stage, graphed, steps=_STEPS):
    model = _model()
    opt = _opt(model, kind, stage)
    step = sp.donated_step(_step) if graphed else _step
    batch = _batch()
    losses = [step(model, opt, *batch).clone() for _ in range(steps)]
    torch.cuda.synchronize()
    return [torch.stack(losses)] + _state(model, opt)


@pytest.mark.parametrize("kind", ["sgd", "adam"])
@pytest.mark.parametrize("stage", ["states", "params"])
def test_graphed_zero_step_equals_eager_and_replicated(world, kind, stage):
    graphed = _run(kind, stage, True)
    eager = _run(kind, stage, False)
    repl = _run(kind, None, True)
    for a, b, c in zip(graphed, eager, repl):
        _same(a, b)
        _same(a, c)


def test_async_snapshot_holds_while_replay_updates(world, tmp_path,
                                                   monkeypatch):
    monkeypatch.setenv("HVDT_ASYNC_CKPT", "1")
    model = _model()
    opt = _opt(model, "adam", "states")
    step = sp.donated_step(_step)
    batch = _batch()
    for _ in range(2):
        step(model, opt, *batch)
    tree = model.state_dict()
    want = {k: v.detach().cpu().clone() for k, v in tree.items()}
    mgr = ckpt.CheckpointManager(str(tmp_path))
    assert mgr.save_async(5, tree, force=True)
    step(model, opt, *batch)             # a replay rewrites every parameter
    torch.cuda.synchronize()
    assert mgr.wait_for_async(60)
    mgr.close()
    got, s = mgr.restore_latest()
    assert s == 5
    for k in want:
        _same(got[k], want[k])
    assert any(not torch.equal(tree[k].cpu(), want[k]) for k in want)


@pytest.mark.parametrize("stage", ["states", "params"])
def test_restore_into_captured_step_replays(world, tmp_path, stage):
    model = _model()
    opt = _opt(model, "adam", stage)
    step = sp.donated_step(_step)
    batch = _batch()
    for _ in range(3):
        step(model, opt, *batch)
    if stage == "params":
        opt.gather_params()
    tree = model.state_dict()
    mgr = ckpt.CheckpointManager(str(tmp_path / "model"))
    mgr.save(3, tree, force=True)
    ckpt.save_zero_state(str(tmp_path / "zero"), opt.gathered_zero_state(),
                         opt.zero_metadata(), step=3)
    want = [torch.stack([step(model, opt, *batch).clone()
                         for _ in range(3)])] + _state(model, opt)
    restored, s = mgr.restore_latest(tree, in_place=True)
    assert s == 3 and restored is tree
    state, meta, zs = ckpt.restore_zero_state(str(tmp_path / "zero"))
    assert zs == 3 and meta == opt.zero_metadata()
    opt.load_zero_state(state)
    opt.load_params()
    got = [torch.stack([step(model, opt, *batch).clone()
                        for _ in range(3)])] + _state(model, opt)
    for a, b in zip(got, want):
        _same(a, b)
