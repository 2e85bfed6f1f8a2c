"""PyTorch port: the autotuner (horovod_tpu_torch/autotune.py) against
the JAX package's autotune.py.

* ``GaussianProcess`` predictions and ``BayesianOptimizer.suggest`` equal
  the reference's on the same samples (the same numpy code: exact).
* ``ParameterManager`` walks the reference's knob sequence on the same
  timing sequence, with every optional dimension and env seed.
* ``AutotunedStep``: a passthrough with ``HVDT_AUTOTUNE`` unset
  (``builder(None)`` once); with it set, rebuilds through the builder's
  keywords and discards the region after each rebuild.  In a 2-process
  gloo world rank 0's choice reaches rank 1 over the c10d store, while
  the ranks time differently.
* The ZeRO dimension hot-swaps ``DistributedOptimizer(zero="states")``
  between the reduce-scatter and the allreduce-and-slice wire over one
  state (same storages), and the run equals one without the swaps.
* ``HVDT_AUTOTUNE_MODEL_SEED`` raises (the cost model is not ported).
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

from horovod_tpu import autotune as ja
from horovod_tpu_torch import autotune as ta

ROOT = pathlib.Path(__file__).resolve().parents[1]

_KNOBS = ("HVDT_AUTOTUNE", "HVDT_AUTOTUNE_LOG", "HVDT_AUTOTUNE_WARMUP_SAMPLES",
          "HVDT_AUTOTUNE_STEPS_PER_SAMPLE",
          "HVDT_AUTOTUNE_BAYES_OPT_MAX_SAMPLES",
          "HVDT_AUTOTUNE_GAUSSIAN_PROCESS_NOISE",
          "HVDT_AUTOTUNE_FUSED_OPTIMIZER", "HVDT_FUSED_OPTIMIZER",
          "HVDT_AUTOTUNE_QUANT", "HVDT_QUANT", "HVDT_COMPRESSION",
          "HVDT_AUTOTUNE_OVERLAP", "HVDT_OVERLAP", "HVDT_AUTOTUNE_TRANSPORT",
          "HVDT_AUTOTUNE_TRANSPORT_SEED", "HVDT_TRANSPORT",
          "HVDT_AUTOTUNE_ZERO", "HVDT_AUTOTUNE_ZERO_SEED", "HVDT_ZERO",
          "HVDT_AUTOTUNE_MOE", "HVDT_AUTOTUNE_MOE_SEED",
          "HVDT_MOE_CAPACITY_FACTOR", "HVDT_AUTOTUNE_PIPELINE",
          "HVDT_AUTOTUNE_PIPELINE_SEED", "HVDT_PIPELINE_MICROBATCHES",
          "HVDT_AUTOTUNE_MODEL_SEED", "HVDT_FUSION_THRESHOLD")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    from horovod_tpu.ops import overlap as jov, zero as jz
    from horovod_tpu.transport import policy as jpol
    from horovod_tpu_torch.ops import overlap as tov, zero as tz
    from horovod_tpu_torch.transport import policy as tpol

    for m in (jov, jz, jpol, tov, tz, tpol):
        m.reset()
    yield
    for m in (jov, jz, jpol, tov, tz, tpol):
        m.reset()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gp_predictions_match_reference(seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 5, (7, 3))
    y = rng.standard_normal(7)
    q = rng.uniform(0, 5, (11, 3))
    tg, jg = ta.GaussianProcess(noise=0.3), ja.GaussianProcess(noise=0.3)
    for g in (tg, jg):
        g.fit(x, y)
    for a, b in zip(tg.predict(q), jg.predict(q)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ta.GaussianProcess().predict(q),
                    ja.GaussianProcess().predict(q)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 3])
def test_bayesian_suggest_matches_reference(seed):
    import itertools

    rng = np.random.default_rng(seed)
    grid = np.array(list(itertools.product(range(20, 29), (1, 2, 4),
                                           (0.0, 1.0))), float)
    tb, jb = ta.BayesianOptimizer(grid, 0.8), ja.BayesianOptimizer(grid, 0.8)
    np.testing.assert_array_equal(tb.suggest(), jb.suggest())
    for _ in range(12):
        p = jb.suggest()
        np.testing.assert_array_equal(tb.suggest(), p)
        y = float(rng.uniform(1e8, 1e9))
        tb.observe(p, y)
        jb.observe(p, y)
    assert tb.best[1] == jb.best[1]
    np.testing.assert_array_equal(tb.best[0], jb.best[0])


_DIMS = {"fused": "HVDT_AUTOTUNE_FUSED_OPTIMIZER",
         "quant": "HVDT_AUTOTUNE_QUANT", "overlap": "HVDT_AUTOTUNE_OVERLAP",
         "transport": "HVDT_AUTOTUNE_TRANSPORT", "zero": "HVDT_AUTOTUNE_ZERO",
         "moe": "HVDT_AUTOTUNE_MOE", "pipeline": "HVDT_AUTOTUNE_PIPELINE"}


def _walk(mod, seq):
    pm = mod.ParameterManager(warmup_samples=1, steps_per_sample=2,
                              max_samples=6)
    out = [tuple(pm._current)]
    views = []
    for dt in seq:
        if pm.record(1e8, dt):
            out.append(tuple(pm._current))
            views.append((pm.bucket_bytes, pm.overlap_buckets,
                          pm.fused_optimizer, pm.quant_wire, pm.quant_leg,
                          pm.overlap_schedule, pm.transport_policy,
                          pm.zero_sharding, pm.capacity_factor,
                          pm.num_microbatches, pm.tuning_complete))
    return out, views


@pytest.mark.parametrize("dims", [(), ("zero",), ("overlap", "zero"),
                                  ("fused", "quant", "overlap", "transport",
                                   "zero", "moe", "pipeline")])
@pytest.mark.parametrize("env", [{}, {"HVDT_ZERO": "states",
                                      "HVDT_OVERLAP": "on",
                                      "HVDT_COMPRESSION": "int4",
                                      "HVDT_FUSION_THRESHOLD": str(1 << 24),
                                      "HVDT_MOE_CAPACITY_FACTOR": "1.5",
                                      "HVDT_PIPELINE_MICROBATCHES": "16"}])
def test_parameter_manager_sequence_matches_reference(dims, env, monkeypatch,
                                                      tmp_path):
    for d in dims:
        monkeypatch.setenv(_DIMS[d], "1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rng = np.random.default_rng(len(dims))
    seq = list(rng.uniform(0.01, 0.2, 40))
    t_log, j_log = tmp_path / "t.csv", tmp_path / "j.csv"
    monkeypatch.setenv("HVDT_AUTOTUNE_LOG", str(t_log))
    tw = _walk(ta, seq)
    monkeypatch.setenv("HVDT_AUTOTUNE_LOG", str(j_log))
    jw = _walk(ja, seq)
    assert tw == jw
    strip = lambda p: [r.split(",", 1)[1] for r in p.read_text().splitlines()]
    assert strip(t_log) == strip(j_log)


@pytest.mark.parametrize("seed_doc,knob,want", [
    ({"rs_ag_speedup_vs_allreduce_at_peak": 1.3}, "ZERO", True),
    ({"rs_ag_speedup_vs_allreduce_at_peak": 0.9}, "ZERO", False),
    ({"hierarchical_speedup_vs_flat_at_peak": 2.0}, "TRANSPORT", True),
    ({"capacity_factor_at_peak": 2.0}, "MOE", 2.0),
    ({"microbatches_at_peak": 32}, "PIPELINE", 32)])
def test_env_seeds_match_reference(seed_doc, knob, want, monkeypatch,
                                   tmp_path):
    path = tmp_path / "seed.json"
    path.write_text(json.dumps(seed_doc))
    monkeypatch.setenv(f"HVDT_AUTOTUNE_{knob}_SEED", str(path))
    fn = {"ZERO": "_env_zero", "TRANSPORT": "_env_transport",
          "MOE": "_env_capacity_factor",
          "PIPELINE": "_env_microbatches"}[knob]
    assert getattr(ta, fn)() == getattr(ja, fn)() == want


def test_model_seed_raises(monkeypatch):
    monkeypatch.setenv("HVDT_AUTOTUNE_MODEL_SEED", "1")
    with pytest.raises(NotImplementedError, match="item 8"):
        ta._env_overlap()
    with pytest.raises(NotImplementedError, match="cost model"):
        ta._model_seed("quant")
    monkeypatch.setenv("HVDT_AUTOTUNE_MODEL_SEED", "off")
    assert ta._model_seed("quant") is None


def test_passthrough_when_off():
    calls = []

    def builder(threshold_bytes, **kw):
        calls.append((threshold_bytes, kw))
        return lambda x: x + 1

    step = ta.autotuned_step(builder)
    assert [step(i) for i in range(30)] == list(range(1, 31))
    assert calls == [(None, {})] and step.autotuner is None
    assert step.summary() == "autotune disabled (HVDT_AUTOTUNE not set)"


def test_rebuilds_through_builder_keywords(monkeypatch):
    import torch

    for k, v in (("HVDT_AUTOTUNE", "1"), ("HVDT_AUTOTUNE_ZERO", "1"),
                 ("HVDT_AUTOTUNE_OVERLAP", "1"),
                 ("HVDT_AUTOTUNE_WARMUP_SAMPLES", "1"),
                 ("HVDT_AUTOTUNE_STEPS_PER_SAMPLE", "2"),
                 ("HVDT_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", "3")):
        monkeypatch.setenv(k, v)
    built = []

    def builder(threshold_bytes, overlap=None, zero=None):
        built.append((threshold_bytes, overlap, zero))
        return lambda t: t * 2

    step = ta.autotuned_step(builder, tree_example=[torch.zeros(256)])
    for _ in range(20):
        step(torch.ones(3))
    assert built[0] == (None, False, False)
    assert len(built) == 4                # three samples, a rebuild each
    assert all(isinstance(b[0], int) for b in built[1:])
    assert step.autotuner.done
    assert "zero=" in step.summary() and "schedule=" in step.summary()


# ---------------------------------------------------------------------------
# Processes: the 2-rank sync, the ZeRO hot swap over one state
# ---------------------------------------------------------------------------

_WORKER = r"""
import os, sys, time, json
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import autotune as ta

mode = sys.argv[2]
hvd.init(device="cpu")
r = hvd.rank()
res = {}
if mode == "sync":
    built = []
    def builder(threshold_bytes, zero=False, overlap=False):
        built.append([threshold_bytes, bool(zero), bool(overlap)])
        return lambda x: x
    step = ta.autotuned_step(builder, tree_example=[torch.zeros(1000)])
    rng = np.random.default_rng(100 + r)        # each rank times its own
    real = time.perf_counter
    clock = [0.0]
    def fake():
        clock[0] += float(rng.uniform(0.001, 0.05))
        return clock[0]
    ta.time.perf_counter = fake
    for _ in range(30):
        step(torch.ones(2))
    ta.time.perf_counter = real
    res["built"] = built
    res["final"] = [float(v) for v in step.autotuner.pm._current]
else:
    # The ZeRO dimension over one state: DistributedOptimizer(zero=
    # "states") with the wire flipped by the tuner's builder.
    def run(tuned):
        g = torch.Generator().manual_seed(5)
        ps = [torch.randint(-4, 5, s, generator=g).float().requires_grad_()
              for s in ((16, 24), (24,), (24, 8), (8,))]
        opt = hvd.DistributedOptimizer(hvd.fused_adam(ps, 1e-2),
                                       zero="states", threshold_bytes=256)
        ptrs = [t.data_ptr() for t in opt.zero_state.mu + opt.zero_state.nu]
        legs = []
        def builder(threshold_bytes, zero=True):
            opt.set_rs_wire(zero)
            legs.append(bool(zero))
            def step(x):
                opt.zero_grad()
                w = torch.arange(8.0) * (r + 1) / 4
                ((torch.tanh(x @ ps[0] + ps[1]) @ ps[2] + ps[3]) * w).sum(
                    ).backward()
                opt.step()
                return torch.zeros(())
            return step
        if tuned:
            step = ta.autotuned_step(builder, tree_example=ps)
        else:
            step = builder(None)
        for s in range(16):
            x = torch.randint(-2, 3, (4, 16),
                              generator=torch.Generator().manual_seed(s)).float()
            step(x)
        same = ptrs == [t.data_ptr() for t in
                        opt.zero_state.mu + opt.zero_state.nu]
        return ps, opt, legs, same
    a_ps, a_opt, legs, same = run(True)
    b_ps, b_opt, _, _ = run(False)
    res["legs"] = legs
    res["same_storage"] = same
    res["equal"] = all(torch.equal(x, y) for x, y in zip(a_ps, b_ps)) and all(
        torch.equal(x, y) for x, y in zip(a_opt.zero_state.mu + a_opt.zero_state.nu,
                                          b_opt.zero_state.mu + b_opt.zero_state.nu))
    res["rows"] = [list(t.shape) for t in a_opt.zero_state.mu]
with open(sys.argv[1], "w") as f:
    json.dump(res, f)
hvd.shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _world(tmp_path, mode, env_extra):
    env = dict(os.environ, HVDT_SIZE="2",
               HVDT_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""), **env_extra)
    for k in _KNOBS:
        if k not in env_extra:
            env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(tmp_path / f"{mode}{r}.json"),
         mode], env=dict(env, HVDT_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=180)
        assert p.returncode == 0, out.decode()[-3000:]
    return [json.load(open(tmp_path / f"{mode}{r}.json")) for r in range(2)]


_TUNE = {"HVDT_AUTOTUNE": "1", "HVDT_AUTOTUNE_ZERO": "1",
         "HVDT_AUTOTUNE_OVERLAP": "1", "HVDT_AUTOTUNE_WARMUP_SAMPLES": "1",
         "HVDT_AUTOTUNE_STEPS_PER_SAMPLE": "2",
         "HVDT_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "4"}


def test_two_process_sync_adopts_rank0_choice(tmp_path):
    res = _world(tmp_path, "sync", _TUNE)
    assert res[0]["built"] == res[1]["built"]
    assert len(res[0]["built"]) == 5
    assert res[0]["final"] == res[1]["final"]


def test_zero_dimension_hot_swaps_one_state(tmp_path):
    res = _world(tmp_path, "zero", _TUNE)
    for r in range(2):
        assert res[r]["same_storage"] and res[r]["equal"]
        assert len(set(res[r]["legs"])) == 2      # both legs ran
        assert all(rows[0] == 1 for rows in res[r]["rows"])
    assert res[0]["legs"] == res[1]["legs"]
