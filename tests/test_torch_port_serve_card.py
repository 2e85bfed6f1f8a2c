"""PyTorch port, ``serve.InferenceEngine`` on the card: one CUDA graph a
bucket against the eager forward.

Every test is marked ``cuda`` and skips without a card.  This file
imports neither JAX nor the JAX package, so it runs where only PyTorch
is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_serve_card.py

Tolerance: none where the graph and the eager forward run the same
padded batch — a replay launches the eager forward's kernels in the same
order on the same inputs, so the logits hold the same bytes.  The MLP
(784-256-128-10, f32) and a 2-layer transformer (d 256, 4 heads of 64,
seq 256, bf16 compute) with ``HVDT_FLASH_SMALLSEQ=on``, whose attention
is kernel #12 in every layer.  A key's first use runs eagerly, its
second captures; the compile counter counts captures.
"""

import threading

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.models.mlp import mlp_apply, mlp_init
from horovod_tpu_torch.ops import pallas_kernels as pk
from horovod_tpu_torch.serve import InferenceEngine

pytestmark = pytest.mark.cuda

_CFG = dict(vocab=512, layers=2, d_model=256, heads=4, kv_heads=4, d_ff=512,
            max_seq=256)


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setenv("HVDT_FLASH_SMALLSEQ", "on")
    monkeypatch.delenv("HVDT_FLASH_ATTENTION", raising=False)
    return torch.device("cuda")


def _transformer(card):
    cfg = tt.TransformerConfig(**_CFG)
    return cfg, tt.transformer_init(0, cfg, device=card)


def _eager(fn, params, x, card):
    with torch.inference_mode():
        return fn(params, torch.from_numpy(x).to(card)).float().cpu().numpy()


@pytest.mark.parametrize("model", ["mlp", "transformer"])
def test_captured_bucket_equals_eager_forward(card, model):
    """Per bucket: the eager first use, the capture and two replays give
    the eager forward's bytes on the same padded batch; one capture a
    bucket; #12 runs in every layer (its counter moves on the eager use
    and the capture, never on a replay)."""
    if model == "mlp":
        params, fn = mlp_init(0, device=card), mlp_apply
        feat, dtype = (784,), np.float32

        def batch(seed, n):
            return np.random.default_rng(seed).normal(
                size=(n, 784)).astype(np.float32)
    else:
        cfg, params = _transformer(card)

        def fn(p, x):
            return tt.transformer_apply(p, x, cfg)

        feat, dtype = (cfg.max_seq,), np.int32

        def batch(seed, n):
            return np.random.default_rng(seed).integers(
                0, cfg.vocab, (n, cfg.max_seq)).astype(np.int32)

    eng = InferenceEngine(fn, params, buckets=(1, 4, 8))
    pk._smallseq_fwd.launches = 0
    for b in eng.buckets:
        for call in range(4):
            n = b if call % 2 == 0 else max(1, b - 1)
            x = batch(10 * b + call, n)
            xp = np.concatenate([x, np.zeros((b - n,) + feat, dtype)])
            got = eng.infer(x)
            want = _eager(fn, params, xp, card)[:n]
            assert np.array_equal(got, want), (b, call)
        assert eng.captured(b, feat, dtype)
    assert eng.compile_count() == 3
    layers = 0 if model == "mlp" else _CFG["layers"]
    # Eager forwards of the check: 4 a bucket; engine: eager + capture.
    assert pk._smallseq_fwd.launches == layers * (4 + 2) * 3


def test_swap_under_a_graph(card):
    """swap_params copies into the captured storage: the replays follow
    the new weights (the new weights' eager forward, in bytes) with no
    new capture, the parameters keep their storage, and a mismatched
    swap raises before a byte is copied."""
    cfg, params = _transformer(card)

    def fn(p, x):
        return tt.transformer_apply(p, x, cfg)

    eng = InferenceEngine(fn, params, buckets=(4,))
    eng.warmup((cfg.max_seq,), dtype=np.int32)
    assert eng.compile_count() == 1
    x = np.random.default_rng(0).integers(0, cfg.vocab, (3, cfg.max_seq)
                                          ).astype(np.int32)
    old = eng.infer(x)
    ptrs = [p.data_ptr() for p in params.parameters()]
    new = {k: (v * 1.5).cpu() for k, v in params.state_dict().items()}
    bad = dict(new, embed=new["embed"][:-1])
    with pytest.raises(ValueError, match="swap_params"):
        eng.swap_params(bad)
    assert np.array_equal(eng.infer(x), old)
    assert eng.swap_params(new) == 1
    got = eng.infer(x)
    assert not np.array_equal(got, old)
    xp = np.concatenate([x, np.zeros((1, cfg.max_seq), np.int32)])
    assert np.array_equal(got, _eager(fn, params, xp, card)[:3])
    assert [p.data_ptr() for p in params.parameters()] == ptrs
    assert eng.compile_count() == 1


def test_swap_while_replays_run(card):
    """A thread replays while another swaps five times: every answer is
    one weight version's eager forward whole (in bytes), none fails,
    nothing recaptures."""
    params = mlp_init(0, device=card)
    orig = {k: v.clone() for k, v in params.state_dict().items()}
    versions = [{k: v * (1.0 + 0.1 * i) for k, v in orig.items()}
                for i in range(6)]
    eng = InferenceEngine(mlp_apply, params, buckets=(8,))
    eng.warmup((784,))
    x = np.random.default_rng(1).normal(size=(8, 784)).astype(np.float32)
    probe = mlp_init(0, device=card)
    wants = []
    for w in versions:
        probe.load_state_dict(w)
        wants.append(_eager(mlp_apply, probe, x, card))
    assert np.array_equal(eng.infer(x), wants[0])
    answers, errors, stop = [], [], threading.Event()

    def fire():
        while not stop.is_set():
            try:
                answers.append(eng.infer(x))
            except Exception as e:      # collected, asserted empty
                errors.append(e)

    t = threading.Thread(target=fire)
    t.start()
    for w in versions[1:]:
        eng.swap_params(w)
    stop.set()
    t.join(timeout=60)
    assert not errors and answers
    for a in answers:
        assert any(np.array_equal(a, w) for w in wants)
    assert np.array_equal(eng.infer(x), wants[-1])
    assert eng.compile_count() == 1 and eng.params_version == 5
