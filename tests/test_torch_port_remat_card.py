"""PyTorch port, ``remat_policy="dots"`` on the card: a small LM (2
layers, d_model 128, 2 heads of 64, d_ff 256, vocab 512, bf16, batch 4)
through the attention kernels, dots against full.

* seq 256 with ``HVDT_FLASH_SMALLSEQ=on`` (#12 forward, #13 backward)
  and seq 256 with ``HVDT_FLASH_ATTENTION=on`` (#9 forward, #10 / #11
  backward): the loss and every gradient under dots equal full's in
  every byte (the saved products are the ones the recompute would
  compute, on the same card); the forward kernel launches twice a layer
  (forward and recompute) under both, the backward kernels once.
* Under dots the backward runs no block product again: it dispatches as
  many ``aten.mm`` as without remat, and full dispatches more.

Every test is marked ``cuda`` and skips without a card.  This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_port_remat_card.py
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.ops import pallas_kernels as pk

pytestmark = pytest.mark.cuda

_KW = dict(vocab=512, layers=2, d_model=128, heads=2, kv_heads=2, d_ff=256,
           max_seq=256, dtype=torch.bfloat16)
_KNOBS = {"smallseq": {"HVDT_FLASH_SMALLSEQ": "on"},
          "flash": {"HVDT_FLASH_ATTENTION": "on", "HVDT_FLASH_BWD": "kernel"}}
_FWD = {"smallseq": (pk._smallseq_fwd,), "flash": (pk._flash_fwd,)}
_BWD = {"smallseq": (pk._smallseq_bwd,), "flash": (pk._flash_dq,
                                                   pk._flash_dkv)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


class _CountMm(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm += 1
        return func(*args, **(kwargs or {}))


def _run(cfg, tokens, count=False):
    model = tt.transformer_init(0, cfg)
    for fn in _FWD["smallseq"] + _FWD["flash"] + _BWD["smallseq"] \
            + _BWD["flash"]:
        fn.launches = 0
    loss = tt.transformer_loss(model, tokens, cfg)
    counter = _CountMm()
    if count:
        with counter:
            loss.backward()
    else:
        loss.backward()
    torch.cuda.synchronize()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return loss.detach(), grads, counter.mm


@pytest.mark.parametrize("path", ["smallseq", "flash"])
def test_dots_equals_full_through_the_kernels(card, monkeypatch, path):
    for knob, value in _KNOBS[path].items():
        monkeypatch.setenv(knob, value)
    tokens = torch.randint(0, 512, (4, 256), generator=card, device="cuda")
    runs = {}
    for policy in ("full", "dots"):
        cfg = tt.TransformerConfig(**_KW, remat=True, remat_policy=policy)
        loss, grads, _ = _run(cfg, tokens)
        launches = ([f.launches for f in _FWD[path]],
                    [f.launches for f in _BWD[path]])
        assert launches == ([2 * 2], [2] * len(_BWD[path])), launches
        runs[policy] = (loss, grads)
    assert torch.equal(runs["dots"][0], runs["full"][0])
    for name, g in runs["dots"][1].items():
        assert torch.equal(g, runs["full"][1][name]), name


def test_dots_recomputes_no_product(card, monkeypatch):
    monkeypatch.setenv("HVDT_FLASH_SMALLSEQ", "on")
    tokens = torch.randint(0, 512, (4, 256), generator=card, device="cuda")
    mm = {}
    for policy in ("none", "full", "dots"):
        cfg = tt.remat_from_env(tt.TransformerConfig(**_KW), policy)
        mm[policy] = _run(cfg, tokens, count=True)[2]
    assert mm["dots"] == mm["none"] < mm["full"], mm
