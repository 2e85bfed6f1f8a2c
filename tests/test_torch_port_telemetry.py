"""The port's telemetry modules against the JAX package's.

The same inputs go through both packages' functions: the metric catalog,
the Prometheus text a sequence of counter / gauge / summary operations
renders, ``snapshot_dict``, the per-bucket records of
``fused_allreduce`` (the reference's one trace on the CPU mesh against
one eager call of the port's), the history layer's serialized series,
the straggler monitor, ``warmup_schedule``, and the zero-overhead
identity contract of every ``get_*()`` with its knob unset.  Text and
JSON compare exactly; float summaries to 1e-12.
"""

from __future__ import annotations

import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu import callbacks as jcb
from horovod_tpu.ops import device as jdev
from horovod_tpu.telemetry import exporter as jexp
from horovod_tpu.telemetry import flight_recorder as jfr
from horovod_tpu.telemetry import history as jhist
from horovod_tpu.telemetry import instrument as jinst
from horovod_tpu.telemetry import metrics as jmet
from horovod_tpu.telemetry import straggler as jstrag
from horovod_tpu.telemetry import trace as jtrace

import horovod_tpu_torch as hvd
from horovod_tpu_torch import callbacks as tcb
from horovod_tpu_torch.common import graphs
from horovod_tpu_torch.telemetry import anomaly as tanom
from horovod_tpu_torch.telemetry import exporter as texp
from horovod_tpu_torch.telemetry import flight_recorder as tfr
from horovod_tpu_torch.telemetry import history as thist
from horovod_tpu_torch.telemetry import instrument as tinst
from horovod_tpu_torch.telemetry import metrics as tmet
from horovod_tpu_torch.telemetry import straggler as tstrag
from horovod_tpu_torch.telemetry import trace as ttrace
from horovod_tpu_torch.resilience import peer_store as tpeer

_KNOBS = ("HVDT_TELEMETRY", "HVDT_TRACE_DIR", "HVDT_FLIGHT_RECORDER",
          "HVDT_HISTORY", "HVDT_EVENT_LOG", "HVDT_PEER_STORE")


def _reset_all():
    for mod in (jmet, tmet):
        mod.reset_default_registry()
    for mod in (jinst, tinst, jfr, tfr, jtrace, ttrace, jhist, thist,
                tanom, tpeer):
        mod.reset()


@pytest.fixture
def clean(monkeypatch):
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    _reset_all()
    yield monkeypatch
    _reset_all()


# -- the catalog --------------------------------------------------------------

def test_catalog_matches_reference():
    want = {k: (v.kind, v.labels) for k, v in jmet.CATALOG.items()}
    got = {k: (v.kind, v.labels) for k, v in tmet.CATALOG.items()}
    assert got == want
    for name in ("hvdt_phase_EXEC_ALLREDUCE_seconds", "hvdt_collectives_total",
                 "nope_total"):
        assert tmet.declared_metric(name) == jmet.declared_metric(name)


# -- registry rendering and the snapshot -------------------------------------

def _drive(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("hvdt_collectives_total", "count")
    c.inc(3, op="allreduce", dtype="float32", wire="float32", path="jit",
          axis="dp")
    c.inc(1.5, op="allgather", dtype="bfloat16", wire="bfloat16",
          path="eager")
    reg.counter("hvdt_steps_total", "steps").inc(7)
    g = reg.gauge("hvdt_mfu", "mfu")
    g.set(0.4375)
    reg.gauge("hvdt_hbm_bytes_in_use", "hbm").set_function(lambda: 1024.0)
    s = reg.summary("hvdt_step_time_seconds", "step")
    for v in np.random.default_rng(3).uniform(0.01, 0.2, 200):
        s.observe(float(v))
    reg.gauge("hvdt_goodput_fraction", "gp").set(0.98765)
    return reg


def test_render_and_snapshot_match_reference(clean):
    jreg, treg = _drive(jmet), _drive(tmet)
    assert treg.render() == jreg.render()
    js, ts = jexp.snapshot_dict(jreg), texp.snapshot_dict(treg)
    assert ts.keys() == js.keys()
    js.pop("wall_ts"), ts.pop("wall_ts")
    assert ts == js


# -- per-bucket records of fused_allreduce -----------------------------------

LEAVES = [((1000,), np.float32), ((7, 3), np.float32), ((300,), np.float16),
          ((5,), np.int32), ((2048,), np.float32)]


def _leaves():
    rng = np.random.default_rng(0)
    return [(rng.standard_normal(s) * 4).astype(d) for s, d in LEAVES]


def _series(reg):
    out = {}
    for name in ("hvdt_collective_bytes_total", "hvdt_collectives_total",
                 "hvdt_wire_bytes_total"):
        m = reg.get(name)
        out[name] = sorted((tuple(sorted(lb.items())), v)
                           for lb, v in m.items()) if m else []
    fill = reg.get("hvdt_fusion_fill_ratio")
    out["fill"] = sorted(fill._ring) if fill is not None else []
    return out


@pytest.mark.parametrize("wire", [None, "bf16"], ids=["exact", "bf16"])
def test_fused_allreduce_records_match_reference(clean, wire):
    clean.setenv("HVDT_TELEMETRY", "1")
    clean.setenv("HVDT_FLIGHT_RECORDER", "1")
    leaves = _leaves()
    if wire:
        # The reference casts an integer bucket to the wire dtype too;
        # the port sends it exact (ops/device.py), so its label differs.
        leaves = [x for x in leaves if x.dtype.kind == "f"]
    threshold = 8192
    mesh = Mesh(np.asarray(jax.devices()[:2], dtype=object), ("dp",))
    jwire = jnp.bfloat16 if wire else None

    def body(*xs):
        return jdev.fused_allreduce(list(xs), "dp", threshold_bytes=threshold,
                                    wire_dtype=jwire)

    fn = jax.jit(jax.shard_map(body, mesh=mesh,
                               in_specs=tuple(P() for _ in leaves),
                               out_specs=[P() for _ in leaves],
                               check_vma=False))
    jax.block_until_ready(fn(*[jnp.asarray(x) for x in leaves]))
    hvd.init(device="cpu")
    try:
        hvd.device.fused_allreduce([torch.from_numpy(x) for x in leaves],
                                   threshold_bytes=threshold,
                                   wire_dtype=(torch.bfloat16 if wire
                                               else None))
    finally:
        hvd.shutdown()
    want, got = _series(jmet.default_registry()), _series(
        tmet.default_registry())
    assert got.keys() == want.keys()
    for k in want:
        if k == "fill":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
        else:
            assert got[k] == want[k], k
    keys = ("op", "name", "dtype", "shape", "nbytes", "wire", "path",
            "count", "axis", "status")
    jev = [{k: e[k] for k in keys} for e in jfr.get_flight_recorder().events()]
    tev = [{k: e[k] for k in keys} for e in tfr.get_flight_recorder().events()]
    assert tev == jev


def test_replay_books_the_captured_buckets(clean):
    """Inside a donated_step capture the device path books nothing, and
    each replay hook books what one eager call books."""
    clean.setenv("HVDT_TELEMETRY", "1")
    clean.setenv("HVDT_FLIGHT_RECORDER", "1")
    leaves = [torch.from_numpy(x) for x in _leaves()]
    hvd.init(device="cpu")
    try:
        hvd.device.fused_allreduce(leaves, threshold_bytes=8192)
        eager = _series(tmet.default_registry())
        n_events = len(tfr.get_flight_recorder().events())
        tmet.reset_default_registry()
        tinst.reset()
        clean.setattr(graphs, "capturing", lambda: True)
        with graphs.collect_replay_hooks() as hooks:
            hvd.device.fused_allreduce(leaves, threshold_bytes=8192)
        clean.setattr(graphs, "capturing", lambda: False)
        assert _series(tmet.default_registry())["hvdt_collectives_total"] \
            == []
        assert len(tfr.get_flight_recorder().events()) == n_events
        for _ in range(3):
            for h in hooks:
                h()
    finally:
        hvd.shutdown()
    got = _series(tmet.default_registry())
    for k in ("hvdt_collective_bytes_total", "hvdt_collectives_total"):
        assert got[k] == [(lb, 3 * v) for lb, v in eager[k]], k
    assert len(tfr.get_flight_recorder().events()) == 4 * n_events
    # Outside donated_step (a foreign capture) nothing can count.
    clean.setattr(graphs, "capturing", lambda: True)
    before = _series(tmet.default_registry())
    tinst.get_recorder().record_collective("allreduce", "float32",
                                           "float32", 64, path="jit")
    assert _series(tmet.default_registry()) == before


# -- the history layer and the straggler monitor -----------------------------

def _feed_history(hmod, mmod):
    reg = mmod.MetricsRegistry()
    clock = iter(float(t) for t in range(1000, 2000))
    h = hmod.MetricHistory(window=16, sample_s=0.0, registry=reg,
                           clock=lambda: next(clock))
    gp = reg.gauge("hvdt_goodput_fraction", "")
    wb = reg.counter("hvdt_wire_bytes_total", "")
    for step in range(1, 25):
        gp.set(1.0 - step / 100)
        wb.inc(1000 * step, axis="dp", wire="float32")
        h.observe_step(step, 0.05 + 0.001 * step)
    return h


def test_history_matches_reference():
    got = _feed_history(thist, tmet).to_dict(max_points=10)
    want = _feed_history(jhist, jmet).to_dict(max_points=10)
    assert json.dumps(got) == json.dumps(want)
    back = thist.MetricHistory.from_dict(got).to_dict()
    assert back == jhist.MetricHistory.from_dict(want).to_dict()


@pytest.mark.parametrize("means", [[0.1, 0.1, 0.35, 0.1],
                                   [0.1, 0.11, 0.1, 0.12],
                                   [0.1, 0.1, 0.3, 0.31]],
                         ids=["one_slow", "none", "slow_pod"])
def test_straggler_matches_reference(means):
    out = []
    for smod, mmod in ((jstrag, jmet), (tstrag, tmet)):
        reg = mmod.MetricsRegistry()
        seen = []
        mon = smod.StragglerMonitor(window=2, threshold=2.0, registry=reg,
                                    allgather_fn=lambda m: list(means),
                                    pod_size=2,
                                    on_straggler=lambda r, s: seen.append(
                                        (r, round(s, 9))))
        mon.observe(0.1)
        mon.observe(0.1)
        out.append((reg.render(), seen))
    assert out[1] == out[0]


# -- callbacks ----------------------------------------------------------------

def test_warmup_schedule_matches_reference():
    steps = [0, 1, 5, 9, 10, 11, 50]
    for after in (None, lambda s: 0.4 * 0.5 ** (s / 10)):
        want = jcb.warmup_schedule(0.1, 10, scale=4.0, after=after)
        got = tcb.warmup_schedule(0.1, 10, scale=4.0, after=after)
        for s in steps:
            w = np.asarray(want(s))
            g = got(s)
            assert g.dtype == torch.float32
            assert float(g) == float(w), (s, float(g), float(w))


# -- zero overhead -------------------------------------------------------------

def test_zero_overhead_identity(clean):
    def fn(x):
        return x

    assert tinst.get_recorder() is None
    assert ttrace.get_tracer() is None
    assert tfr.get_flight_recorder() is None
    assert thist.get_history() is None
    assert tanom.get_event_log() is None
    assert tpeer.get_peer_store() is None
    assert tinst.wrap_step(fn) is fn
    threads = set(threading.enumerate())
    assert texp.maybe_start_exporter() is None
    assert texp.get_exporter() is None
    assert set(threading.enumerate()) == threads
    # On, the same call sites build their objects.
    clean.setenv("HVDT_TELEMETRY", "1")
    assert tinst.get_recorder() is not None
    assert tinst.wrap_step(fn) is not fn


def test_exporter_endpoints(clean, tmp_path):
    clean.setenv("HVDT_TELEMETRY", "1")
    clean.setenv("HVDT_HISTORY", "1")
    clean.setenv("HVDT_FLIGHT_RECORDER", "1")
    clean.setenv("HVDT_METRICS_PORT", "0")
    exp = texp.maybe_start_exporter()
    try:
        tfr.get_flight_recorder().record("allreduce", "x", "float32")
        thist.get_history().record("step_time", 1, 0.5)
        base = f"http://127.0.0.1:{exp.port}"
        text = urllib.request.urlopen(base + "/metrics").read().decode()
        names = {ln.split("{")[0].split(" ")[0] for ln in text.splitlines()
                 if ln and not ln.startswith("#")}
        assert "hvdt_hbm_bytes_in_use" in names
        assert all(tmet.declared_metric(n) for n in names)
        hz = json.loads(urllib.request.urlopen(base + "/healthz").read())
        assert hz == {"status": "ok", "rank": 0, "steps": 0}
        fr = json.loads(urllib.request.urlopen(base + "/flightrecorder")
                        .read())
        assert fr["events"][0]["name"] == "x"
        ts = json.loads(urllib.request.urlopen(base + "/timeseries").read())
        assert ts["series"]["step_time"] == [[ts["series"]["step_time"][0][0],
                                             1, 0.5]]
    finally:
        texp.stop_exporter()
