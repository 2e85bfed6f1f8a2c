"""PyTorch port, the serving plane's data path against the JAX package's:
``serve/engine.py`` (``InferenceEngine``, ``parse_buckets``),
``serve/batcher.py``, ``serve/reload.py``, ``serve/server.py`` and the
serve CLI's assembly (``serve/__main__.py``), plus ``serve_snapshot_dict``
and ``fleet.scheduler.read_target``.

The same numpy inputs go through the reference's engine and the port's,
with the parameters carried across by ``convert.py``
(``mlp_params_from_jax``, ``transformer_params_from_jax``): the MLP
(6-16-3, f32, within 1e-5) and a 2-layer transformer (d 64, seq 128, f32
compute) under ``HVDT_FLASH_SMALLSEQ=on``, where the reference runs #12
in interpret mode and the port #12's plain version (within 1e-4).  On
the CPU the port's engine captures nothing: ``serve_compiles_total``
counts the first use of a key, as the reference counts its compiles.
The batcher, watcher and server cases are the reference's
``tests/test_serve.py`` on the port's classes.
"""

import http.client
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.models import mlp as jmlp
from horovod_tpu.models import transformer as jt
from horovod_tpu.serve import InferenceEngine as JEngine
from horovod_tpu.serve import parse_buckets as jparse
from horovod_tpu.telemetry import exporter as jexporter
from horovod_tpu.fleet import scheduler as jscheduler
from horovod_tpu_torch.checkpoint import CheckpointManager
from horovod_tpu_torch.convert import (mlp_params_from_jax,
                                       transformer_params_from_jax)
from horovod_tpu_torch.fleet import scheduler as tscheduler
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.models.mlp import mlp_apply, mlp_init
from horovod_tpu_torch.ops import pallas_kernels as tpk
from horovod_tpu_torch.serve import (BackpressureError, CheckpointWatcher,
                                     DynamicBatcher, InferenceEngine,
                                     MetricsRegistry, ModelServer,
                                     parse_buckets)
from horovod_tpu_torch.telemetry import exporter as texporter

SIZES = (6, 16, 3)          # tiny MLP: 6 features -> 3 classes
_TKW = dict(vocab=64, layers=2, d_model=64, heads=4, kv_heads=4, d_ff=128,
            max_seq=128)


@pytest.fixture(scope="module")
def jparams():
    return jmlp.mlp_init(jax.random.PRNGKey(0), SIZES)


@pytest.fixture(scope="module")
def params(jparams):
    """The port's MLP holding the reference's weights."""
    model = mlp_init(0, SIZES, device="cpu")
    model.load_state_dict(mlp_params_from_jax(
        {k: np.asarray(v) for k, v in jparams.items()}))
    return model


def _want(jparams, x):
    return np.asarray(jmlp.mlp_apply(jparams, jnp.asarray(x)))


def _doubled(model):
    return {k: v * 2.0 for k, v in model.state_dict().items()}


def _post(port, doc, timeout=30):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/predict", json.dumps(doc),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _get(port, route, timeout=30):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", route)
        r = conn.getresponse()
        return r.status, r.read().decode()
    finally:
        conn.close()


# ---- parse_buckets -------------------------------------------------------

@pytest.mark.parametrize("spec", [None, "32,4, 4,16", "7", "0,4", "",
                                  "1,8,32"])
def test_parse_buckets_matches_reference(spec):
    try:
        want = jparse(spec)
    except ValueError:
        with pytest.raises(ValueError):
            parse_buckets(spec)
        return
    assert parse_buckets(spec) == want


# ---- the engine against the reference's ----------------------------------

@pytest.mark.parametrize("buckets,sizes", [((4, 8), (1, 3, 4, 5, 8)),
                                           ((4,), (11,)),
                                           ((1, 8, 32), (1, 2, 9, 33, 70))])
def test_mlp_engine_matches_reference(jparams, params, buckets, sizes):
    """Padding to a bucket and chunking past the top one: each batch's
    rows equal the reference engine's, and the compile and pad-row
    counters agree batch by batch."""
    eng, ref = InferenceEngine(mlp_apply, params, buckets=buckets), \
        JEngine(jmlp.mlp_apply, jparams, buckets=buckets)
    for n in sizes:
        x = np.random.default_rng(n).normal(
            size=(n, SIZES[0])).astype(np.float32)
        got, want = eng.infer(x), ref.infer(x)
        assert got.shape == want.shape == (n, SIZES[-1])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert eng.compile_count() == ref.compile_count()
        for name in ("serve_pad_rows_total", "serve_engine_batches_total"):
            assert eng.metrics.counter(name).value() == \
                ref.metrics.counter(name).value()
    assert eng.buckets == ref.buckets


def test_compile_counter_flat_on_warm_buckets(params):
    eng = InferenceEngine(mlp_apply, params, buckets=(4, 8))
    eng.warmup((SIZES[0],))
    warm = eng.compile_count()
    assert warm == 2                      # one key a bucket
    for n in (1, 2, 3, 4, 6, 8):
        eng.infer(np.zeros((n, SIZES[0]), np.float32))
    assert eng.compile_count() == warm    # zero steady-state compiles
    assert all(eng.captured(b, (SIZES[0],)) for b in (4, 8))


def test_new_feature_shape_is_a_new_key():
    eng = InferenceEngine(lambda p, x: x * 2.0, {"w": torch.zeros(1)},
                          buckets=(4,))
    eng.infer(np.zeros((2, 3), np.float32))
    assert eng.compile_count() == 1
    eng.infer(np.zeros((2, 5), np.float32))
    assert eng.compile_count() == 2
    eng.infer(np.zeros((2, 5), np.int32))
    assert eng.compile_count() == 3


def test_empty_batch_rejected(params):
    eng = InferenceEngine(mlp_apply, params, buckets=(4,))
    for bad in (np.zeros((0, SIZES[0]), np.float32), np.float32(1.0)):
        with pytest.raises(ValueError):
            eng.infer(bad)


def test_swap_params_moves_outputs_without_a_compile(jparams, params):
    """The reference's swap case on the same weights: the outputs follow
    the swap (the doubled weights' reference outputs) while the compile
    counter stays flat; the served tensors are written in place."""
    model = mlp_init(0, SIZES, device="cpu")
    model.load_state_dict(params.state_dict())
    eng = InferenceEngine(mlp_apply, model, buckets=(4,))
    x = np.random.default_rng(1).normal(size=(2, SIZES[0])).astype(
        np.float32)
    y1 = eng.infer(x)
    compiles = eng.compile_count()
    ptrs = [p.data_ptr() for p in model.parameters()]
    assert eng.params_version == 0
    assert eng.swap_params(_doubled(model)) == 1
    y2 = eng.infer(x)
    np.testing.assert_allclose(
        y2, _want(jax.tree.map(lambda a: a * 2.0, jparams), x),
        rtol=1e-5, atol=1e-5)
    assert not np.allclose(y1, y2)
    assert eng.compile_count() == compiles
    assert [p.data_ptr() for p in model.parameters()] == ptrs


@pytest.mark.parametrize("bad", ["shape", "dtype", "name"])
def test_swap_params_checks_before_copying(params, bad):
    model = mlp_init(0, SIZES, device="cpu")
    eng = InferenceEngine(mlp_apply, model, buckets=(4,))
    new = {k: v.clone() + 1 for k, v in model.state_dict().items()}
    if bad == "shape":
        new["w0"] = torch.zeros(SIZES[0] + 1, SIZES[1])
    elif bad == "dtype":
        new["b1"] = new["b1"].double()
    else:
        new["w9"] = new.pop("w0")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="swap_params"):
        eng.swap_params(new)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])
    assert eng.params_version == 0



def test_transformer_engine_matches_reference(monkeypatch):
    """Token batches through both engines under HVDT_FLASH_SMALLSEQ=on
    (the reference's #12 in interpret mode, the port's plain #12): the
    padded bucket's real rows agree, and the port's #12 ran in every
    layer without a kernel launch."""
    monkeypatch.setenv("HVDT_FLASH_SMALLSEQ", "on")
    monkeypatch.delenv("HVDT_FLASH_ATTENTION", raising=False)
    shapes = jax.eval_shape(
        lambda key: jt.transformer_init(key, jt.TransformerConfig(**_TKW)),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (np.ones(leaf.shape, np.float32)
                            if "ln" in jax.tree_util.keystr(path) else
                            (rng.standard_normal(leaf.shape) * 0.1
                             ).astype(np.float32)), shapes)
    jcfg = jt.TransformerConfig(dtype=jnp.float32, **_TKW)
    ref = JEngine(lambda p, x: jt.transformer_apply(p, x, jcfg),
                  jax.tree.map(jnp.asarray, params), buckets=(4,))
    cfg = tt.TransformerConfig(dtype=torch.float32, **_TKW)
    model = tt.transformer_init(0, cfg, device="cpu")
    model.load_state_dict(transformer_params_from_jax(params))
    calls = []
    real = tt.flash_attention_smallseq
    monkeypatch.setattr(tt, "flash_attention_smallseq",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(tpk._smallseq_fwd, "launches", 0)
    eng = InferenceEngine(lambda p, x: tt.transformer_apply(p, x, cfg),
                          model, buckets=(4,))
    x = np.random.default_rng(1).integers(0, 64, (3, 128)).astype(np.int32)
    got, want = eng.infer(x), ref.infer(x)
    assert got.shape == want.shape == (3, 128, 64)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert len(calls) == cfg.layers
    assert tpk._smallseq_fwd.launches == 0
    assert eng.compile_count() == ref.compile_count() == 1


def test_transformer_bf16_rows_independent_of_padding():
    """The CLI's --model transformer path (bf16 compute): a padded
    bucket's real rows equal the rows' own forward."""
    cfg = tt.TransformerConfig(vocab=64, layers=1, d_model=16, heads=2,
                               kv_heads=2, d_ff=32, max_seq=16)
    model = tt.transformer_init(0, cfg, device="cpu")
    eng = InferenceEngine(lambda p, x: tt.transformer_apply(p, x, cfg),
                          model, buckets=(2, 4))
    x = np.random.default_rng(0).integers(0, 64, (3, 8)).astype(np.int32)
    out = eng.infer(x)
    assert out.shape == (3, 8, 64)
    with torch.inference_mode():
        want = tt.transformer_apply(model, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out, want.numpy(), rtol=2e-2, atol=2e-2)
    assert eng.compile_count() == 1


# ---- the batcher ---------------------------------------------------------

def test_concurrent_producers_no_loss_no_duplication(jparams, params):
    """16 producer threads through the batcher into the engine: every
    request's response is the reference's output for exactly its input,
    and the warm buckets take no new key."""
    eng = InferenceEngine(mlp_apply, params, buckets=(4, 16))
    eng.warmup((SIZES[0],))
    warm = eng.compile_count()
    batcher = DynamicBatcher(eng.infer, max_batch_size=16,
                             max_delay_ms=10.0, max_queue_depth=10_000)
    n_threads, per_thread = 16, 8
    results, errors = {}, []

    def producer(tid):
        rng = np.random.default_rng(tid)
        for i in range(per_thread):
            rows = 1 + (tid + i) % 4
            x = rng.normal(size=(rows, SIZES[0])).astype(np.float32)
            try:
                results[(tid, i)] = (x, batcher.submit(x).result(timeout=60))
            except Exception as e:   # pragma: no cover - fail loudly
                errors.append((tid, i, e))

    threads = [threading.Thread(target=producer, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    batcher.close()
    assert not errors
    assert len(results) == n_threads * per_thread
    xs = np.concatenate([x for x, _ in results.values()])
    ys = np.concatenate([y for _, y in results.values()])
    np.testing.assert_allclose(ys, _want(jparams, xs), rtol=1e-5, atol=1e-5)
    assert eng.compile_count() == warm
    assert batcher.metrics.counter("serve_requests_total").value() \
        == n_threads * per_thread


def test_backpressure_rejects_past_queue_bound():
    release = threading.Event()

    def gated_infer(x):
        release.wait(timeout=30)
        return x

    batcher = DynamicBatcher(gated_infer, max_batch_size=2,
                             max_delay_ms=1.0, max_queue_depth=4)
    futures = []
    try:
        futures.append(batcher.submit(np.zeros((2, 3))))
        deadline = time.time() + 10
        while batcher.queue_depth() < 4 and time.time() < deadline:
            try:
                futures.append(batcher.submit(np.zeros((2, 3))))
            except BackpressureError:
                time.sleep(0.01)
        assert batcher.queue_depth() >= 3
        with pytest.raises(BackpressureError):
            batcher.submit(np.zeros((2, 3)))
        assert batcher.metrics.counter("serve_rejected_total").value() >= 1
    finally:
        release.set()
        batcher.close()
    for f in futures:
        assert f.result(timeout=30).shape == (2, 3)   # none lost


def test_mixed_feature_shapes_grouped_not_mixed():
    calls = []

    def record_infer(x):
        calls.append(x.shape)
        return x * 2.0

    batcher = DynamicBatcher(record_infer, max_batch_size=8,
                             max_delay_ms=50.0, max_queue_depth=64)
    try:
        f1 = batcher.submit(np.ones((2, 3), np.float32))
        f2 = batcher.submit(np.ones((1, 5), np.float32))
        f3 = batcher.submit(np.ones((1, 3), np.float32))
        np.testing.assert_allclose(f1.result(30), 2 * np.ones((2, 3)))
        np.testing.assert_allclose(f2.result(30), 2 * np.ones((1, 5)))
        np.testing.assert_allclose(f3.result(30), 2 * np.ones((1, 3)))
    finally:
        batcher.close()
    assert (1, 5) in calls


def test_engine_error_propagates_to_futures():
    def boom(x):
        raise RuntimeError("kernel on fire")

    batcher = DynamicBatcher(boom, max_batch_size=4, max_delay_ms=1.0,
                             max_queue_depth=16)
    try:
        with pytest.raises(RuntimeError, match="kernel on fire"):
            batcher.submit(np.zeros((1, 2))).result(timeout=30)
    finally:
        batcher.close()


def test_submit_after_close_rejected():
    batcher = DynamicBatcher(lambda x: x, max_batch_size=2,
                             max_delay_ms=1.0, max_queue_depth=4)
    batcher.close()
    with pytest.raises(RuntimeError):
        batcher.submit(np.zeros((1, 2)))


def test_deadline_expiry_between_gather_and_dispatch():
    from horovod_tpu_torch.serve.batcher import (RequestDeadlineExceeded,
                                                 _Request)

    calls = []
    batcher = DynamicBatcher(lambda x: calls.append(x) or x,
                             max_batch_size=4, max_delay_ms=1.0,
                             max_queue_depth=16, deadline_s=30.0)
    try:
        expired = _Request(np.zeros((1, 2)), deadline_s=0.001)
        live = _Request(np.ones((1, 2)), deadline_s=30.0)
        time.sleep(0.01)
        batcher._dispatch_groups([expired, live])
        with pytest.raises(RequestDeadlineExceeded):
            expired.future.result(timeout=5)
        np.testing.assert_allclose(live.future.result(timeout=5),
                                   np.ones((1, 2)))
        assert len(calls) == 1
        assert batcher.metrics.counter(
            "serve_deadline_expired_total").value() >= 1
    finally:
        batcher.close()


# ---- the checkpoint watcher ----------------------------------------------

def test_watcher_empty_dir_is_quiet(tmp_path, params):
    eng = InferenceEngine(mlp_apply, params, buckets=(4,))
    w = CheckpointWatcher(str(tmp_path / "empty"), eng)
    assert w.check_once() is None
    assert w.current_step is None


def test_corrupt_checkpoint_counted_not_fatal(tmp_path, jparams):
    """A half-written newer step is counted and skipped; the engine keeps
    serving the step it has; a good newer step recovers, with the
    doubled weights' reference outputs."""
    model = mlp_init(0, SIZES, device="cpu")
    model.load_state_dict(mlp_params_from_jax(
        {k: np.asarray(v) for k, v in jparams.items()}))
    ckdir = tmp_path / "ck"
    mgr = CheckpointManager(str(ckdir))
    mgr.save(1, model.state_dict(), force=True)
    eng = InferenceEngine(mlp_apply, mlp_init(1, SIZES, device="cpu"),
                          buckets=(4,))
    w = CheckpointWatcher(str(ckdir), eng)
    assert w.check_once() == 1
    x = np.ones((2, SIZES[0]), np.float32)
    np.testing.assert_allclose(eng.infer(x), _want(jparams, x), rtol=1e-5,
                               atol=1e-5)
    os.makedirs(mgr.step_path(3))
    assert w.check_once() is None
    assert w.current_step == 1
    assert w.metrics.counter("serve_reload_failures_total").value() == 1
    mgr.save(4, _doubled(model), force=True)
    assert w.check_once() == 4
    np.testing.assert_allclose(
        eng.infer(x), _want(jax.tree.map(lambda a: a * 2.0, jparams), x),
        rtol=1e-5, atol=1e-5)
    assert eng.params_version == 2 and eng.compile_count() == 1


def test_polling_thread_start_stop(tmp_path, params):
    ckdir = tmp_path / "ck"
    CheckpointManager(str(ckdir)).save(2, params.state_dict(), force=True)
    eng = InferenceEngine(mlp_apply, mlp_init(1, SIZES, device="cpu"),
                          buckets=(4,))
    w = CheckpointWatcher(str(ckdir), eng, poll_interval_s=0.05)
    w.start(load_initial=False)
    deadline = time.time() + 10
    while w.current_step is None and time.time() < deadline:
        time.sleep(0.02)
    w.stop()
    assert w.current_step == 2
    assert eng.params_version == 1


# ---- the HTTP server -----------------------------------------------------

def test_full_serving_path(tmp_path, jparams, params):
    """The acceptance path: a server over a port checkpoint, 64
    concurrent /predict requests over two buckets answered with the
    reference's outputs, a flat compile counter, the metrics and healthz
    documents, and a hot reload under load with no failed request."""
    ckdir = str(tmp_path / "ckpts")
    mgr = CheckpointManager(ckdir)
    mgr.save(10, params.state_dict(), force=True)
    template = mlp_init(0, SIZES, device="cpu")
    with torch.no_grad():
        for p in template.parameters():
            p.zero_()
    engine = InferenceEngine(mlp_apply, template, buckets=(4, 16))
    server = ModelServer(engine, port=0, checkpoint_dir=ckdir,
                         max_batch_size=16, max_delay_ms=5.0,
                         max_queue_depth=4096)
    port = server.start()
    try:
        assert server.watcher.current_step == 10
        engine.warmup((SIZES[0],))
        warm = engine.compile_count()
        assert warm == 2
        results, failures = {}, []

        def client(i):
            x = np.random.default_rng(i).normal(
                size=((i % 5) + 1, SIZES[0])).astype(np.float32)
            try:
                results[i] = (x, *_post(port, {"inputs": x.tolist()}))
            except Exception as e:    # pragma: no cover - fail loudly
                failures.append((i, e))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(64)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not failures and len(results) == 64
        for x, status, body in results.values():
            assert status == 200, body
            assert body["model_version"] == 1
            np.testing.assert_allclose(np.asarray(body["outputs"]),
                                       _want(jparams, x), rtol=1e-4,
                                       atol=1e-4)
        assert engine.compile_count() == warm

        status, text = _get(port, "/metrics")
        assert status == 200
        for needle in ('serve_request_latency_ms_predict{quantile="0.5"}',
                       'serve_request_latency_ms_predict{quantile="0.99"}',
                       "serve_queue_depth", "serve_compiles_total 2",
                       "serve_batch_fill"):
            assert needle in text
        status, body = _get(port, "/healthz")
        assert status == 200
        assert json.loads(body) == {"status": "ok", "model_version": 1,
                                    "checkpoint_step": 10,
                                    "buckets": [4, 16], "engine": "static"}

        p2 = jax.tree.map(lambda a: a * 2.0, jparams)
        stop_fire, fire_failures = threading.Event(), []

        def fire():
            rng = np.random.default_rng(999)
            while not stop_fire.is_set():
                x = rng.normal(size=(2, SIZES[0])).astype(np.float32)
                try:
                    status, body = _post(port, {"inputs": x.tolist()})
                    got = np.asarray(body.get("outputs"))
                    if status != 200 or not any(
                            np.allclose(got, _want(p, x), rtol=1e-4,
                                        atol=1e-4) for p in (jparams, p2)):
                        fire_failures.append((status, body))
                except Exception as e:   # pragma: no cover
                    fire_failures.append(("exc", repr(e)))

        firing = [threading.Thread(target=fire) for _ in range(4)]
        for t in firing:
            t.start()
        try:
            mgr.save(11, _doubled(params), force=True)
            assert server.watcher.check_once() == 11
        finally:
            time.sleep(0.2)
            stop_fire.set()
            for t in firing:
                t.join(timeout=60)
        assert not fire_failures
        assert engine.compile_count() == warm
        x = np.ones((1, SIZES[0]), np.float32)
        status, body = _post(port, {"inputs": x.tolist()})
        np.testing.assert_allclose(np.asarray(body["outputs"]),
                                   _want(p2, x), rtol=1e-4, atol=1e-4)
        assert json.loads(_get(port, "/healthz")[1])["checkpoint_step"] == 11
    finally:
        server.stop()


def test_http_backpressure_503(params):
    engine = InferenceEngine(mlp_apply, params, buckets=(4,))
    server = ModelServer(engine, port=0, max_batch_size=1,
                         max_delay_ms=1.0, max_queue_depth=2)
    release, entered = threading.Event(), threading.Event()
    real_infer = engine.infer

    def gated(x):
        entered.set()
        release.wait(timeout=60)
        return real_infer(x)

    server.batcher._infer = gated
    port = server.start()
    pending = []
    try:
        def bg():
            t = threading.Thread(target=_post, args=(
                port, {"inputs": np.zeros((1, SIZES[0])).tolist()}))
            t.start()
            pending.append(t)

        bg()
        assert entered.wait(timeout=30)
        bg()
        bg()
        deadline = time.time() + 30
        while server.batcher.queue_depth() < 2 and time.time() < deadline:
            time.sleep(0.01)
        assert server.batcher.queue_depth() == 2
        status, body = _post(port, {"inputs":
                                    np.zeros((1, SIZES[0])).tolist()})
        assert status == 503 and "queue" in body["error"]
        assert server.metrics.counter("serve_rejected_total").value() >= 1
    finally:
        release.set()
        for t in pending:
            t.join(timeout=60)
        server.stop()


def test_bad_requests_400_and_404(params):
    engine = InferenceEngine(mlp_apply, params, buckets=(4,))
    server = ModelServer(engine, port=0)
    port = server.start()
    try:
        status, body = _post(port, {"not_inputs": [1, 2]})
        assert status == 400 and body["error"].startswith("bad request")
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("POST", "/predict", "{not json",
                     {"Content-Type": "application/json"})
        assert conn.getresponse().status == 400
        conn.close()
        status, _ = _post(port, {"inputs": []})
        assert status == 400
        assert _get(port, "/nope")[0] == 404
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("POST", "/elsewhere", "{}")
        assert conn.getresponse().status == 404
        conn.close()
    finally:
        server.stop()


# ---- the CLI assembly ----------------------------------------------------

def test_build_server_mlp_roundtrip(tmp_path):
    """The __main__ assembly path with --device cpu: parse the flags,
    build the server over a port checkpoint of the reference's weights,
    serve one request with the reference's outputs."""
    from horovod_tpu_torch.serve.__main__ import build_server, parse_args

    sizes = (4, 8, 2)
    p = jmlp.mlp_init(jax.random.PRNGKey(3), sizes)
    ckdir = str(tmp_path / "ck")
    CheckpointManager(ckdir).save(5, mlp_params_from_jax(
        {k: np.asarray(v) for k, v in p.items()}), force=True)
    args = parse_args([
        "--checkpoint", ckdir, "--model", "mlp", "--mlp-sizes", "4,8,2",
        "--port", "0", "--buckets", "2,4", "--max-delay-ms", "2",
        "--reload-interval", "60", "--device", "cpu"])
    server, feat_shape = build_server(args)
    assert feat_shape == (4,)
    assert server.watcher.poll_interval_s == 60
    port = server.start()
    try:
        assert server.watcher.current_step == 5
        x = np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32)
        status, body = _post(port, {"inputs": x.tolist()})
        assert status == 200
        np.testing.assert_allclose(np.asarray(body["outputs"]),
                                   _want(p, x), rtol=1e-4, atol=1e-4)
    finally:
        server.stop()


def test_build_server_transformer_and_engines(tmp_path):
    from horovod_tpu_torch.serve.__main__ import build_server, parse_args

    base = ["--checkpoint", str(tmp_path), "--model", "transformer",
            "--vocab", "64", "--layers", "1", "--d-model", "16", "--heads",
            "2", "--d-ff", "32", "--seq", "8", "--port", "0", "--buckets",
            "2", "--device", "cpu"]
    server, feat = build_server(parse_args(base))
    assert feat == (8,) and server.input_dtype == np.int32
    server.engine.warmup(feat, dtype=np.int32)
    assert server.engine.compile_count() == 1
    server.stop()
    with pytest.raises(NotImplementedError, match="item 7 part 2"):
        build_server(parse_args(base + ["--engine", "continuous"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_server(parse_args(base[:-2]))


def test_serve_module_entry_point(tmp_path):
    """``python -m horovod_tpu_torch.serve`` starts, serves /healthz and
    a prediction over a CPU MLP, and stops on SIGINT."""
    import signal
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.serve", "--checkpoint",
         str(tmp_path), "--mlp-sizes", "6,16,3", "--port", str(port),
         "--buckets", "1,4", "--device", "cpu"], env=env,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 60
        while True:
            try:
                status, body = _get(port, "/healthz", timeout=5)
                break
            except OSError:
                assert proc.poll() is None and time.time() < deadline
                time.sleep(0.2)
        assert status == 200 and json.loads(body)["buckets"] == [1, 4]
        status, body = _post(port, {"inputs": [[0.5] * 6]})
        assert status == 200 and len(body["outputs"][0]) == 3
    finally:
        proc.send_signal(signal.SIGINT)
        _, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err[-2000:]
    assert "serving freshly-initialized weights" in err


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---- across packages: the snapshot and the replica-target key ------------

def test_serve_snapshot_dict_matches_reference(params):
    """The heartbeat roll-up of a served registry: the same keys and
    values from both packages' functions (the port's registry classes
    are the reference's names)."""
    engine = InferenceEngine(mlp_apply, params, buckets=(4,))
    server = ModelServer(engine, port=0)
    port = server.start()
    try:
        for _ in range(3):
            assert _post(port, {"inputs": [[0.1] * 6]})[0] == 200
        got = texporter.serve_snapshot_dict(server.metrics)
        want = jexporter.serve_snapshot_dict(server.metrics)
    finally:
        server.stop()
    assert got == want
    assert got["requests_total"] == 3 and got["draining"] is False
    assert {"queue_depth", "p50_ms", "p99_ms", "batches_total",
            "rejected_total", "deadline_expired_total"} <= set(got)
    reg = MetricsRegistry()
    reg.gauge("hvdt_engine_tokens_per_sec", "").set(12.5)
    reg.gauge("hvdt_engine_kv_blocks_in_use", "").set(3)
    assert texporter.serve_snapshot_dict(reg) == \
        jexporter.serve_snapshot_dict(reg)
    assert texporter.serve_snapshot_dict(MetricsRegistry()) == {}


@pytest.mark.parametrize("raw", [None, b"3", b" 4\n", b"-1", b"nope",
                                 b"\xff\xfe", b'{"target": 5, "seq": 2, '
                                 b'"writer": "fleet"}', b'{"target": "6"}',
                                 b'{"seq": 1}', b'{"target": [1]}', b"[1]",
                                 b'{"target": 2.9, "seq": null}'])
def test_read_target_matches_reference(raw):
    assert tscheduler.read_target(raw) == jscheduler.read_target(raw)
    assert tscheduler.TARGET_KV_KEY == "/serve/target_replicas"
