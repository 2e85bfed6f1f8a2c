"""PyTorch port, the step statistics (horovod_tpu_torch/telemetry/
step_stats.py and metrics.py) held against the JAX package's on the same
observations: the StepTimer snapshot, the goodput fraction, the rendered
metrics text, the peak table and tree_bytes.

Exact equality throughout: both sides do the same float64 arithmetic on
the same inputs.
"""

import numpy as np
import pytest
import torch

from horovod_tpu.telemetry import metrics as jmet
from horovod_tpu.telemetry import step_stats as jss
from horovod_tpu_torch.telemetry import metrics as tmet
from horovod_tpu_torch.telemetry import step_stats as tss

_STEPS = [0.105, 0.097, 0.2, 0.101, 0.099, 0.5, 0.1, 0.098]


@pytest.mark.parametrize("kind,flops", [
    ("TPU v5 lite", 3.1e12), ("NVIDIA H100 80GB HBM3", 3.15e12),
    ("cpu", 3.1e12), ("TPU v4", None)])
def test_step_timer_snapshot_matches_jax(kind, flops):
    want = jss.StepTimer(examples_per_step=128, flops_per_step=flops,
                         device_kind=kind, registry=jmet.MetricsRegistry())
    got = tss.StepTimer(examples_per_step=128, flops_per_step=flops,
                        device_kind=kind, registry=tmet.MetricsRegistry())
    if kind.startswith("NVIDIA"):
        # The H100 row is the port's own; give the reference its peak.
        want = jss.StepTimer(examples_per_step=128, flops_per_step=flops,
                             peak_flops=989e12,
                             registry=jmet.MetricsRegistry())
    for s in _STEPS:
        want.observe(s)
        got.observe(s)
    assert got.snapshot() == want.snapshot()
    assert got.mfu() == want.mfu()
    assert got.count == want.count == len(_STEPS)
    assert got.mean_step_seconds() == want.mean_step_seconds()
    assert (got.mfu() is None) == (kind == "cpu" or flops is None)


def test_step_scope_times_a_block():
    timer = tss.StepTimer(examples_per_step=4,
                          registry=tmet.MetricsRegistry())
    with timer.step():
        pass
    with pytest.raises(RuntimeError):
        with timer.step():
            raise RuntimeError("a failed step is not observed")
    assert timer.count == 1
    assert timer.snapshot()["mfu"] is None


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_goodput_fraction_matches_jax():
    clocks = (_Clock(), _Clock())
    want = jss.GoodputLedger(registry=jmet.MetricsRegistry(),
                             clock=clocks[0], already_elapsed=5.0)
    got = tss.GoodputLedger(registry=tmet.MetricsRegistry(),
                            clock=clocks[1], already_elapsed=5.0)
    for ledger in (want, got):
        ledger.charge("recompile", 5.0)
        ledger.charge("restore", 1.5)
    for c in clocks:
        c.t += 45.0
    assert got.fraction() == want.fraction() == pytest.approx(0.87)
    assert got.lost_seconds() == want.lost_seconds()
    assert got.lost_seconds("restore") == want.lost_seconds("restore")
    assert got.elapsed_seconds() == want.elapsed_seconds() == 50.0
    for name in ("hvdt_goodput_fraction", "hvdt_goodput_lost_seconds_total"):
        assert got.registry.get(name).render() == \
            want.registry.get(name).render()


def test_metrics_render_matches_jax():
    regs = (jmet.MetricsRegistry(), tmet.MetricsRegistry())
    for reg in regs:
        c = reg.counter("hvdt_c_total", "a counter")
        c.inc(2, op="allreduce")
        c.inc(3.5, op="allgather")
        g = reg.gauge("hvdt_g", "a gauge")
        g.set(7.25)
        reg.gauge("hvdt_probe", "a live probe").set_function(lambda: 0.5)
        s = reg.summary("hvdt_s_seconds", "a summary", window=5)
        for v in (0.3, 0.1, 0.9, 0.2, 0.5, 0.4, 0.05):
            s.observe(v)
        reg.summary("hvdt_empty", "no data")
    assert regs[1].render() == regs[0].render()
    s0, s1 = (r.get("hvdt_s_seconds") for r in regs)
    assert s1.percentiles() == s0.percentiles()
    assert s1.quantile(0.5) == s0.quantile(0.5)
    assert s1.mean() == s0.mean()
    with pytest.raises(TypeError, match="already registered"):
        regs[1].gauge("hvdt_c_total")
    assert tmet.reset_default_registry() is tmet.default_registry()


def test_peak_table():
    for sub, flops, bw in jss.PEAK_BY_DEVICE_KIND:
        assert (sub, flops, bw) in tss.PEAK_BY_DEVICE_KIND
        assert tss.peak_flops_for(sub) == jss.peak_flops_for(sub)
        assert tss.peak_flops_for(f"TPU {sub.upper()}") == \
            jss.peak_flops_for(f"TPU {sub.upper()}")
    assert tss.peak_flops_for("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    for unknown in ("NVIDIA H100 PCIe", "NVIDIA H100 NVL", "NVIDIA A100-SXM4"
                    "-80GB", "cpu", "", None):
        assert tss.peak_flops_for(unknown) == (None, None)


def test_tree_bytes_matches_jax():
    tree = {"a": np.zeros((3, 4), np.float32),
            "b": [np.zeros((5,), np.float16), np.zeros((), np.int64)],
            "c": "not an array"}
    assert tss.tree_bytes(tree) == jss.tree_bytes(tree) == 48 + 10 + 8
    assert tss.tree_bytes({"t": torch.zeros(3, 4, dtype=torch.bfloat16),
                           "n": np.zeros(2, np.float32)}) == 24 + 8
    model = torch.nn.Linear(4, 3)
    assert tss.tree_bytes(model) == (12 + 3) * 4
