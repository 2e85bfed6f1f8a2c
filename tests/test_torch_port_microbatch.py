"""PyTorch port, gradient accumulation: ``optimizer.microbatch_gradients``
and ``DistributedOptimizer(backward_passes_per_step=k)`` held against the
JAX package's ``optimizer.microbatch_gradients`` on the same numpy
inputs, in a world of one (gloo).

* The reference's ``test_microbatch_gradients``: k = 4 micro-batches of a
  64-row batch give the full batch's mean gradient (the reference under
  ``shard_map`` over 8 devices, the port over the whole batch in a world
  of one).  Tolerance rtol 1e-5, as there.
* The reference's bf16 drift test (tests/test_zero.py): 8 micro-batches
  of bf16 gradients accumulate in f32 and are cast once, so the port's
  result holds the reference's bytes, where a bf16 running sum drifts.
* The accumulation of k passes by ``DistributedOptimizer`` equals
  ``microbatch_gradients`` bit for bit (the first pass copied, the
  others added, one division and one cast), and ``donated_step``'s
  phase key follows the pass count through wrappers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu_torch as hvd
from horovod_tpu import optimizer as jopt
from horovod_tpu_torch import step_pipeline as sp
from horovod_tpu_torch.ops import optim_kernels as tok


@pytest.fixture
def world1():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def test_microbatch_gradients_match_reference(world1, mesh8):
    w0 = np.asarray([1.0, -1.0], np.float32)
    x = np.random.RandomState(3).randn(64, 2).astype(np.float32)

    def jloss(w, xs):
        return jnp.mean((xs @ w) ** 2)

    def per_shard(w, xs):
        return jopt.microbatch_gradients(lambda w, xs: jax.grad(jloss)(w, xs),
                                         w, xs, num_microbatches=4)

    want = jax.shard_map(per_shard, mesh=mesh8, in_specs=(P(), P("dp")),
                         out_specs=P())(jnp.asarray(w0), jnp.asarray(x))
    full = jax.grad(jloss)(jnp.asarray(w0), jnp.asarray(x))

    w = torch.from_numpy(w0).requires_grad_()

    def grad_fn(params, xs):
        loss = ((xs @ params[0]) ** 2).mean()
        return torch.autograd.grad(loss, params)

    got = hvd.microbatch_gradients(grad_fn, [w], torch.from_numpy(x), 4)
    assert len(got) == 1 and got[0].dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(full), rtol=1e-5)


def test_bf16_grads_accumulate_in_f32(world1):
    """8 micro-batches of bf16 gradients: the port's mean holds the
    reference's bytes; a bf16 running sum of the same values differs."""
    k = 8
    rng = np.random.RandomState(0)
    micro = (1.0 + rng.rand(k, 64) * 0.01).astype(np.float32)

    def jgrad(p, mb):
        return {"w": mb["x"][0]}

    want = jopt.microbatch_gradients(
        jgrad, {"w": jnp.zeros((64,), jnp.bfloat16)},
        {"x": jnp.asarray(micro, jnp.bfloat16)}, num_microbatches=k)["w"]

    w = torch.zeros(64, dtype=torch.bfloat16)
    batch = {"x": torch.from_numpy(micro).to(torch.bfloat16)}
    got = hvd.microbatch_gradients(lambda p, mb: [mb["x"][0]], [w], batch, k)
    assert got[0].dtype == torch.bfloat16
    assert torch.equal(got[0].view(torch.int16), torch.from_numpy(
        np.array(want).view(np.int16)))

    naive = torch.zeros(64, dtype=torch.bfloat16)
    for i in range(k):
        naive = naive + batch["x"][i]
    assert not torch.equal(naive / k, got[0]), \
        "the inputs do not show bf16 accumulation drift"


def test_f32_and_integer_leaves(world1):
    """f32 leaves average exactly; an integer leaf keeps its dtype (the
    reference's acc dtype rule), with the mean truncated on the cast."""
    k = 4
    x = torch.arange(k * 8, dtype=torch.float32).reshape(k, 8)
    n = torch.arange(k * 3, dtype=torch.int32).reshape(k, 3)
    got = hvd.microbatch_gradients(
        lambda p, mb: [mb[0][0], mb[1][0]],
        [torch.zeros(8), torch.zeros(3, dtype=torch.int32)], (x, n), k)
    np.testing.assert_allclose(got[0].numpy(), x.numpy().mean(0), rtol=1e-6)
    assert got[1].dtype == torch.int32
    assert got[1].tolist() == (n.double().mean(0)).long().tolist()
    with pytest.raises(ValueError, match="does not split"):
        hvd.microbatch_gradients(lambda p, mb: [mb[0]], [torch.zeros(1)],
                                 torch.zeros(6, 1), 4)


def test_optimizer_accumulation_equals_microbatch(world1):
    """k passes of DistributedOptimizer(backward_passes_per_step=k) hand
    the wrapped optimizer the bytes microbatch_gradients returns; only
    the k-th pass steps, and the phase key follows the passes."""
    k = 4
    rng = np.random.default_rng(1)
    w0 = rng.standard_normal((6, 3)).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((8 * k, 6)).astype(np.float32))

    def grads(params, xs):
        with torch.enable_grad():
            loss = torch.tanh(xs @ params[0]).pow(2).mean()
            return torch.autograd.grad(loss, params)

    w = torch.from_numpy(w0.copy()).requires_grad_()
    want = hvd.microbatch_gradients(grads, [w], x, k)[0]

    seen = []

    class Probe(torch.optim.SGD):
        def step(self, closure=None):
            seen.append(self.param_groups[0]["params"][0].grad.clone())

    opt = hvd.DistributedOptimizer(Probe([w], lr=0.1),
                                   backward_passes_per_step=k)
    wrapped = hvd.quant.with_error_feedback(opt, enabled=False)
    phases = []
    for i in range(k):
        phases.append(sp._phase([w, wrapped]))
        w.grad = grads([w], x[i * 8:(i + 1) * 8])[0]
        opt.step()
        assert len(seen) == (i == k - 1)
    assert phases == [(0,), (1,), (2,), (3,)]
    assert sp._phase([w, wrapped]) == (0,)
    assert torch.equal(seen[0].view(torch.int32), want.view(torch.int32))
    assert sp._phase(tok.fused_sgd([w], 0.1, momentum=0.9)) == ()


@pytest.mark.parametrize("has_grad", [
    (False, True, False, True),      # on the second pass of each cycle only
    (True, False, True, False),      # on the first pass of each cycle only
    (True, True, False, True),       # missing on the later cycle's first pass
    (True, True, False, False),      # gone in the later cycle
], ids=["pass1_only", "pass0_only", "late_start", "gone"])
def test_accumulation_of_a_gradient_that_comes_and_goes(world1, has_grad):
    """k = 2 over two cycles; one parameter always has a gradient, the
    other only on the passes ``has_grad`` marks.  At each boundary the
    wrapped optimizer sees, for each parameter, the sum of the
    gradients it had in that cycle over k (f32 sum, one division), and
    zeros for a parameter that had none in the cycle: every parameter
    that requires a gradient is exchanged, as in the reference's
    interop optimizer."""
    k = 2
    rng = np.random.default_rng(7)
    a = torch.zeros(5, requires_grad=True)
    b = torch.zeros(3, requires_grad=True)
    ga = [torch.from_numpy(rng.standard_normal(5).astype(np.float32))
          for _ in has_grad]
    gb = [torch.from_numpy(rng.standard_normal(3).astype(np.float32))
          for _ in has_grad]
    seen = []

    class Probe(torch.optim.SGD):
        def step(self, closure=None):
            seen.append([None if p.grad is None else p.grad.clone()
                         for p in self.param_groups[0]["params"]])

    opt = hvd.DistributedOptimizer(Probe([a, b], lr=0.1),
                                   backward_passes_per_step=k)
    for i, present in enumerate(has_grad):
        opt.zero_grad()
        a.grad = ga[i].clone()
        b.grad = gb[i].clone() if present else None
        opt.step()
    assert len(seen) == 2

    def mean(gs, mask):
        got = [g for g, m in zip(gs, mask) if m]
        if not got:
            return None
        total = got[0].clone()
        for g in got[1:]:
            total.add_(g)
        return total / k

    for cycle in range(2):
        sl = slice(cycle * k, (cycle + 1) * k)
        want_a = mean(ga[sl], [True] * k)
        want_b = mean(gb[sl], has_grad[sl])
        got_a, got_b = seen[cycle]
        assert torch.equal(got_a, want_a)
        if want_b is None:
            assert torch.equal(got_b, torch.zeros(3))
        else:
            assert torch.equal(got_b, want_b)
