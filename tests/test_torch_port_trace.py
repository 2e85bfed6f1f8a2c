"""The port's span tracer and flight recorder against the JAX package's.

``step_trace_id``, ``merge_dumps`` and ``analyze_desync`` give equal
outputs on the same inputs (exact: JSON); the tracer's dump and the
driver-side merge over the port's rendezvous KV keep the reference's
format; and a two-process gloo world whose rank 1 skips a named
allreduce ends in a stall abort whose desync report, on both ranks,
names the same first divergent collective (seq and name) as the
reference's ``analyze_desync`` over the same events.
"""

from __future__ import annotations

import json
import os
import pathlib
import socket
import subprocess
import sys

import pytest

from horovod_tpu.telemetry import flight_recorder as jfr
from horovod_tpu.telemetry import trace as jtrace

from horovod_tpu_torch.runner import http_kv
from horovod_tpu_torch.telemetry import flight_recorder as tfr
from horovod_tpu_torch.telemetry import instrument as tinst
from horovod_tpu_torch.telemetry import trace as ttrace

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def clean(monkeypatch):
    for k in ("HVDT_TELEMETRY", "HVDT_TRACE_DIR", "HVDT_FLIGHT_RECORDER"):
        monkeypatch.delenv(k, raising=False)
    for mod in (ttrace, tfr, tinst):
        mod.reset()
    yield monkeypatch
    for mod in (ttrace, tfr, tinst):
        mod.reset()


def _dumps():
    return {
        r: {"traceEvents": [
            {"ph": "X", "name": f"EXEC_ALLREDUCE:g{k}", "cat": "collective",
             "ts": 1.7e15 + 1000.0 * k + 17.0 * r, "dur": 250.5 + r,
             "pid": r, "tid": k % 2,
             "args": {"step": k, "trace_id": jtrace.step_trace_id(k)}}
            for k in range(4)]
            + [{"ph": "i", "name": "mark", "cat": "mark", "s": "p",
                "ts": 1.7e15 + 3.5 + r, "pid": r, "tid": 0, "args": {}}],
            "displayTimeUnit": "ms", "metadata": {"rank": r}}
        for r in (2, 0, 1)}


def test_step_trace_id_and_merge_match_reference():
    for step in (0, 1, 42, 10 ** 7):
        assert ttrace.step_trace_id(step) == jtrace.step_trace_id(step)
    dumps = _dumps()
    got = ttrace.merge_dumps(json.loads(json.dumps(dumps)))
    assert json.dumps(got) == json.dumps(jtrace.merge_dumps(dumps))


def _events(seqs, *, skip=(), rename=None, inflight=()):
    out = []
    for s in seqs:
        if s in skip:
            continue
        name = (rename or {}).get(s, f"grad.{s}")
        out.append({"seq": s, "op": "allreduce", "name": name,
                    "dtype": "float32", "shape": [s, 4], "nbytes": 16 * s,
                    "status": "inflight" if s in inflight else "done"})
    return out


@pytest.mark.parametrize("case", ["agree", "missing", "mismatch", "evicted",
                                  "silent_rank"])
def test_analyze_desync_matches_reference(case):
    by_rank = {
        "agree": {0: _events(range(1, 6)), 1: _events(range(1, 6))},
        "missing": {0: _events(range(1, 8), inflight=(7,)),
                    1: _events(range(1, 7)), 2: _events(range(1, 8))},
        "mismatch": {0: _events(range(1, 6)),
                     1: _events(range(1, 6), rename={3: "other"})},
        "evicted": {0: _events(range(5, 12)), 1: _events(range(3, 10))},
        "silent_rank": {0: _events(range(1, 4)), 1: []},
    }[case]
    expected = [0, 1, 2, 3] if case == "silent_rank" else None
    got = tfr.analyze_desync(by_rank, expected)
    want = jfr.analyze_desync(by_rank, expected)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


def test_tracer_flush_and_driver_merge(clean, tmp_path):
    clean.setenv("HVDT_TRACE_DIR", str(tmp_path))
    tracer = ttrace.get_tracer()
    step = tinst.wrap_step(lambda: None)
    for _ in range(3):
        step()
    tracer.complete("EXEC_ALLREDUCE:x", 0.002, args={"fused": 1})
    path = ttrace.flush(publish=False)
    doc = json.loads(pathlib.Path(path).read_text())
    spans = [e for e in doc["traceEvents"] if e["name"] == "train.step"]
    assert [e["args"]["trace_id"] for e in spans] == [
        "step-00000000", "step-00000001", "step-00000002"]
    assert doc["traceEvents"][-1]["args"]["trace_id"] == "step-00000003"
    server = http_kv.RendezvousServer(addr="127.0.0.1")
    server.start()
    try:
        client = http_kv.KVClient("127.0.0.1", server.port, server.secret)
        for r in (1, 0):
            tracer.publish(client, rank=r)
        merged = ttrace.write_merged(server, str(tmp_path / "out"))
    finally:
        server.stop()
    got = json.loads(pathlib.Path(merged).read_text())
    want = jtrace.merge_dumps({r: tracer.dump() for r in (0, 1)})
    assert got["metadata"] == want["metadata"] == {"ranks": [0, 1],
                                                   "merged": True}
    assert len(got["traceEvents"]) == len(want["traceEvents"])


_DESYNC_WORKER = r"""
import json, sys, time
import numpy as np
import torch.distributed as dist
import horovod_tpu_torch as hvd
from horovod_tpu_torch.runner.http_kv import KVClient
from horovod_tpu_torch.telemetry import flight_recorder as fr

hvd.init(device="cpu")
r = hvd.rank()
dist.barrier()
for name in ("warmup", "a", "b"):
    hvd.allreduce(np.ones(2, np.float32), name=name)
info = {}
t0 = time.perf_counter()
if r == 0:
    try:
        hvd.allreduce(np.ones(2, np.float32), name="skipped")
        info["skipped"] = "completed"
    except hvd.HorovodInternalError as e:
        info["skipped"] = str(e)
else:
    time.sleep(3.5)          # rank 1 never issues "skipped"
time.sleep(0.6)              # both ranks' rings reach the KV
rec = fr.get_flight_recorder()
kv = KVClient.from_env()
rec.publish(kv)
time.sleep(0.6)
info["by_rank"] = fr._gather_events(kv, 2, r, rec.events())
info["report"] = fr.emit_desync_report(stalled="skipped", kv_client=kv,
                                       size=2, out_dir=sys.argv[1] + ".d")
info["report_s"] = time.perf_counter() - t0
with open(sys.argv[1] + ".json", "w") as f:
    json.dump(info, f)
hvd.shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_stall_abort_desync_report_names_the_skipped_collective(tmp_path):
    server = http_kv.RendezvousServer(addr="127.0.0.1")
    server.start()
    env = dict(os.environ, HVDT_SIZE="2",
               HVDT_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
               HVDT_CONTROL_PLANE_TIMEOUT_S="60",
               HVDT_STALL_CHECK_TIME_SECONDS="1",
               HVDT_STALL_ABORT_TIME_SECONDS="2",
               HVDT_FLIGHT_RECORDER="1", HVDT_TELEMETRY="1",
               HVDT_TELEMETRY_PUBLISH_S="0.2", HVDT_METRICS_PORT="0",
               HVDT_TRACE_DIR=str(tmp_path / "trace"),
               HVDT_RENDEZVOUS_ADDR="127.0.0.1",
               HVDT_RENDEZVOUS_PORT=str(server.port),
               HVDT_SECRET=server.secret.hex(),
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("HVDT_FUSED_CONV1X1", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DESYNC_WORKER, str(tmp_path / f"r{r}")],
        env=dict(env, HVDT_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    try:
        logs = [p.communicate(timeout=90)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        server.stop()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    info = [json.loads((tmp_path / f"r{r}.json").read_text())
            for r in range(2)]
    assert info[0]["skipped"].startswith("collective skipped aborted")
    # The coordinator's abort rung wrote its own report first.
    auto = json.loads((tmp_path / "trace" /
                       "desync_report_rank0.json").read_text())
    heads = []
    for doc in info + [{"report": auto, "by_rank": None}]:
        rep = doc["report"]
        heads.append((rep["first_divergent_seq"],
                      rep["divergent_event"]["name"], rep["missing_ranks"]))
        if doc["by_rank"] is not None:
            by_rank = {int(k): v for k, v in doc["by_rank"].items()}
            want = jfr.analyze_desync(by_rank, [0, 1])
            for key in ("first_divergent_seq", "missing_ranks",
                        "mismatches", "divergent_event",
                        "per_rank_last_seq", "inflight_by_rank"):
                assert rep[key] == want[key], key
    assert heads[0] == heads[1] == heads[2]
    assert heads[0][1:] == ("skipped", [1])
    assert max(d["report_s"] for d in info) < 10.0
