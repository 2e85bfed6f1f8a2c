"""PyTorch port, ``python -m horovod_tpu_torch.bench_allreduce``: every
mode in a gloo world of 2 at two small sizes (one world runs them one
after another through the module's ``run``, and one ``--np 2 --device
cpu`` launch of the module runs the reduce-scatter sweep in a world of
its own).

Each run's summary (written to ``--json-out``; the launch's is also its
last stdout line) carries the reference's keys (the root
``bench_allreduce.py``: the summary's metric and its ``*_at_peak``
verdict, each row's bandwidth and wire columns) with one row a size (four
a size under ``--hierarchical``, two under ``--a2a``), finite times, and
the wire accounting of ``wire_payload_bytes`` computed as the
reference's.  The port's ``autotune`` reads a ``--hierarchical`` file as
its transport seed and a ``--reduce-scatter`` file as its ZeRO seed.
Times on the CPU are not device metrics: only keys and arithmetic are
checked.
"""

import json
import math
import os
import pathlib
import socket
import subprocess
import sys

import pytest

import bench_allreduce as jbench
from horovod_tpu_torch import autotune
from horovod_tpu_torch import bench_allreduce as tbench

ROOT = pathlib.Path(__file__).resolve().parents[1]
SIZES = (4096, 16384)

# mode: (argv, summary metric, verdict key, row keys, rows a size)
_MODES = {
    "f32_eager": (["--eager"], "allreduce_peak_busbw_gbps", None,
                  ("jit_algbw_gbps", "jit_busbw_gbps", "bytes_on_wire",
                   "wire_gbps", "eager_us", "eager_algbw_gbps"), 1),
    "bf16": (["--wire", "bf16"], "allreduce_peak_busbw_gbps",
             "speedup_vs_f32_at_peak",
             ("jit_algbw_gbps", "jit_busbw_gbps", "bytes_on_wire",
              "speedup_vs_f32", "f32_us"), 1),
    "fp16": (["--wire", "fp16"], "allreduce_peak_busbw_gbps",
             "speedup_vs_f32_at_peak", ("speedup_vs_f32",), 1),
    "int8": (["--wire", "int8"], "allreduce_peak_busbw_gbps",
             "speedup_vs_f32_at_peak", ("speedup_vs_f32", "bytes_on_wire"),
             1),
    "int4": (["--wire", "int4"], "allreduce_peak_busbw_gbps",
             "speedup_vs_f32_at_peak", ("speedup_vs_f32", "bytes_on_wire"),
             1),
    "reduce_scatter": (["--reduce-scatter"], "reduce_scatter_sweep",
                       "rs_ag_speedup_vs_allreduce_at_peak",
                       ("rs_ag_us", "rs_us", "allreduce_us",
                        "rs_ag_algbw_gbps", "rs_ag_speedup_vs_allreduce",
                        "deferred_ag_fraction"), 1),
    "a2a": (["--a2a"], "a2a_sweep", "int8_a2a_speedup_vs_f32_at_peak",
            ("a2a_us", "a2a_algbw_gbps", "a2a_wire_bytes",
             "int8_speedup_vs_f32"), 2),
    "hierarchical": (["--hierarchical"], "allreduce_hierarchical_sweep",
                     "hierarchical_speedup_vs_flat_at_peak",
                     ("us", "bytes_on_wire"), 4),
}


_WORKER = r"""
import json, os, sys
import horovod_tpu_torch as hvd
from horovod_tpu_torch import bench_allreduce as tbench

# Every mode in one world (the hierarchical sweep last: it sets
# HVDT_TRANSPORT and the current mesh).
for mode, argv in json.loads(sys.argv[1]).items():
    out = os.path.join(sys.argv[2], mode + ".json")
    tbench.run(tbench.parse_args([*argv, "--json-out", out]))
hvd.shutdown()
"""


def _common(mode):
    return ["--device", "cpu", "--min-bytes", str(SIZES[0]), "--max-bytes",
            str(SIZES[-1]), "--iters", "2", "--inner", "2", "--warmup", "1",
            *_MODES[mode][0]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mode's summary: one gloo world of 2 runs them one after
    another, beside one ``python -m ... --np 2`` launch (the CLI and its
    own world) of the reduce-scatter sweep."""
    tmp = tmp_path_factory.mktemp("bench_allreduce")
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for k in ("HVDT_TRANSPORT", "HVDT_SIZE", "HVDT_RANK",
              "HVDT_COORDINATOR_ADDR", "HVDT_ZERO", "HVDT_OVERLAP"):
        env.pop(k, None)
    cli = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.bench_allreduce", "--np",
         "2", *_common("reduce_scatter"), "--json-out",
         str(tmp / "cli.json")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, cwd=str(tmp))
    modes = {m: _common(m) for m in _MODES}
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    wenv = dict(env, HVDT_SIZE="2",
                HVDT_COORDINATOR_ADDR=f"127.0.0.1:{port}")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, json.dumps(modes), str(tmp)],
        env=dict(wenv, HVDT_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    for p in procs:
        log, _ = p.communicate(timeout=240)
        assert p.returncode == 0, log.decode()[-3000:]
    stdout, stderr = cli.communicate(timeout=240)
    assert cli.returncode == 0, stderr.decode()[-3000:]
    last = json.loads(stdout.decode().strip().splitlines()[-1])
    with open(tmp / "cli.json") as f:
        assert json.load(f) == last
    out = {"cli": (last, tmp / "cli.json")}
    for mode in _MODES:
        with open(tmp / f"{mode}.json") as f:
            out[mode] = (json.load(f), tmp / f"{mode}.json")
    return out


@pytest.mark.parametrize("mode", [*_MODES, "cli"])
def test_mode_writes_the_reference_keys(runs, mode):
    summary, _ = runs[mode]
    _, metric, verdict, row_keys, per_size = _MODES[
        "reduce_scatter" if mode == "cli" else mode]
    assert summary["metric"] == metric
    assert summary["schema_version"] == jbench.SCHEMA_VERSION
    assert summary["n_devices"] == 2 and summary["platform"] == "cpu"
    if verdict is not None:
        assert math.isfinite(summary[verdict]) and summary[verdict] > 0
    rows = summary["rows"]
    assert len(rows) == per_size * len(SIZES)
    assert sorted({r["bytes"] for r in rows}) == list(SIZES)
    for r in rows:
        for k in ("bytes", "size_bytes", "axis", "axis_size", "algorithm",
                  "wire", "seconds"):
            assert k in r, (k, r)
        assert math.isfinite(r["seconds"]) and r["seconds"] > 0
    for k in row_keys:
        assert any(k in r for r in rows), k


@pytest.mark.parametrize("wire", ["f32", "bf16", "fp16", "int8", "int4"])
def test_wire_payload_bytes_match_reference(wire):
    for count in (1, 255, 1024, 4096, 100_000):
        assert (tbench.wire_payload_bytes(count, "float32", wire)
                == jbench.wire_payload_bytes(count, "float32", wire))


def test_autotune_reads_the_sweeps_as_seeds(runs, monkeypatch):
    for k in ("HVDT_TRANSPORT", "HVDT_ZERO", "HVDT_AUTOTUNE_MODEL_SEED"):
        monkeypatch.delenv(k, raising=False)
    hier, hier_path = runs["hierarchical"]
    rs, rs_path = runs["reduce_scatter"]
    monkeypatch.setenv("HVDT_AUTOTUNE_TRANSPORT_SEED", str(hier_path))
    assert autotune._env_transport() == (
        hier["hierarchical_speedup_vs_flat_at_peak"] > 1.0)
    monkeypatch.setenv("HVDT_AUTOTUNE_ZERO_SEED", str(rs_path))
    assert autotune._env_zero() == (
        rs["rs_ag_speedup_vs_allreduce_at_peak"] > 1.0)
    # A verdict above 1 starts the dimension on the measured leg.
    for doc, key, fn, knob in (
            (hier, "hierarchical_speedup_vs_flat_at_peak",
             autotune._env_transport, "HVDT_AUTOTUNE_TRANSPORT_SEED"),
            (rs, "rs_ag_speedup_vs_allreduce_at_peak", autotune._env_zero,
             "HVDT_AUTOTUNE_ZERO_SEED")):
        path = pathlib.Path(str(hier_path)).with_name(f"won_{key}.json")
        path.write_text(json.dumps({**doc, key: 1.5}))
        monkeypatch.setenv(knob, str(path))
        assert fn() is True


def test_np_drops_its_own_flag():
    assert tbench._without_np(["--np", "4", "--a2a", "--np=2", "--wire",
                               "int8"]) == ["--a2a", "--wire", "int8"]
