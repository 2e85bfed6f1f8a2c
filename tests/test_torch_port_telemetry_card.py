"""PyTorch port, the telemetry recorders on the card: a graphed step's
collectives counted per replay, and the device-memory gauges.

Every test is marked ``cuda`` and skips without a card.  This file
imports neither JAX nor the JAX package, so it runs where only PyTorch
is installed:

    python -m pytest --noconftest -m cuda \\
        tests/test_torch_port_telemetry_card.py

A small MLP under ``DistributedOptimizer(fused_sgd)`` (kernel #2) in
the NCCL world of one, through ``donated_step``: call 1 runs eagerly,
call 2 captures and replays, later calls replay.  With
``HVDT_TELEMETRY=1`` the collective counters after N calls must be N
times what one eager call books (exact: they are sums of integers), the
flight recorder must hold one event per bucket per call, and a replay
must launch the same kernels and copies with the recorders on as with
them off (``torch.profiler``: the hooks run on the host only).
"""

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import step_pipeline as sp
from horovod_tpu_torch.ops import optim_kernels as ok
from horovod_tpu_torch.telemetry import exporter as texp
from horovod_tpu_torch.telemetry import flight_recorder as tfr
from horovod_tpu_torch.telemetry import instrument as tinst
from horovod_tpu_torch.telemetry import metrics as tmet

pytestmark = pytest.mark.cuda

_CALLS = 6


@pytest.fixture
def world(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for k in ("HVDT_TELEMETRY", "HVDT_FLIGHT_RECORDER"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HVDT_METRICS_PORT", "0")
    tmet.reset_default_registry()
    tinst.reset()
    tfr.reset()
    hvd.init()
    yield monkeypatch
    hvd.shutdown()
    tinst.reset()
    tfr.reset()


def _model():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(256, 512), torch.nn.ReLU(),
                               torch.nn.Linear(512, 10)).cuda()


def _step(model, opt, x, y):
    opt.zero_grad(set_to_none=True)
    torch.nn.functional.cross_entropy(model(x), y).backward()
    opt.step()


def _counts():
    reg = tmet.default_registry()
    out = {}
    for name in ("hvdt_collectives_total", "hvdt_collective_bytes_total"):
        m = reg.get(name)
        out[name] = {tuple(sorted(lb.items())): v for lb, v in m.items()} \
            if m is not None else {}
    return out


def _kernels(fn):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted(e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)


def _build(threshold):
    model = _model()
    opt = hvd.DistributedOptimizer(
        ok.fused_sgd(model.parameters(), 0.01, momentum=0.9),
        threshold_bytes=threshold)
    x = torch.randn(64, 256, device="cuda")
    y = torch.randint(0, 10, (64,), device="cuda")
    return model, opt, x, y


def test_replays_count_the_captured_buckets(world):
    world.setenv("HVDT_TELEMETRY", "1")
    world.setenv("HVDT_FLIGHT_RECORDER", "1")
    model, opt, x, y = _build(256 * 1024)
    _step(model, opt, x, y)                 # one eager call: the unit
    torch.cuda.synchronize()
    one = _counts()
    per_call = len(tfr.get_flight_recorder().events())
    assert one["hvdt_collectives_total"] and per_call >= 2
    tmet.reset_default_registry()
    tinst.reset()
    tfr.reset()
    step = sp.donated_step(_step)
    for _ in range(_CALLS):
        step(model, opt, x, y)
    torch.cuda.synchronize()
    assert step.graphed
    got = _counts()
    for name, series in one.items():
        assert got[name] == {k: _CALLS * v for k, v in series.items()}, name
    assert len(tfr.get_flight_recorder().events()) == _CALLS * per_call


def test_replay_kernels_equal_with_recorders_off(world):
    launched = {}
    # The process's first graph replays its input copies through other
    # copy kernels than every later graph's: a first round is discarded.
    for on in ("warm-up", False, True):
        if on is True:
            world.setenv("HVDT_TELEMETRY", "1")
            world.setenv("HVDT_FLIGHT_RECORDER", "1")
        model, opt, x, y = _build(256 * 1024)
        step = sp.donated_step(_step)
        for _ in range(3):
            step(model, opt, x, y)
        launched[on] = _kernels(lambda: step(model, opt, x, y))
    assert launched[True] == launched[False]
    assert any("optim_multi" in k for k in launched[True])


def test_hbm_gauge_reads_the_allocator(world):
    keep = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    reg = tmet.MetricsRegistry()
    texp.bind_process_gauges(reg)
    torch.cuda.synchronize()
    assert reg.get("hvdt_hbm_bytes_in_use").value() == float(
        torch.cuda.memory_allocated())
    assert reg.get("hvdt_hbm_peak_bytes").value() >= keep.numel()
    del keep
