"""PyTorch port, expert parallelism (horovod_tpu_torch/parallel/moe.py)
held against the JAX package's parallel/moe.py on the same numpy inputs.

One 2-process gloo world runs the port's ``moe_dispatch_combine`` over
the world (``ep = 2``) for every case below; the reference runs under
``jax.shard_map`` over two CPU devices.  Each member's loss is
``sum(out * cot) + 0.5 * load_balance_loss``; each member's backward
gives the gradient of the members' summed loss (the all-to-all's and the
group mean's transposes carry the other member's part), which the
reference gets as ``jax.grad`` of the ``psum`` of the local losses.

* The reference's ``test_routing_correctness`` / ``test_capacity_drop``
  inputs (``tests/test_parallel.py``).
* Random tokens and logits at top_k 1 and 2, capacity factors 0.25 /
  1.25 / 4.0 and ``experts_per_rank`` 1 and 2: outputs, both aux values
  and the gradients to tokens, logits and expert weights, f32 within
  rtol 1e-5 (atol 1e-5 on gradients that cancel to near zero).
* The bf16, fp16 and int8 wires (``HVDT_TRANSPORT=ep:ring:<wire>``),
  int8 through the plain quantize/dequantize against the reference's XLA
  path: forward within rtol 1e-5 (bf16/fp16) and within one int8 step of
  each block (int8); gradients for the casts as for f32.
* The int8 wire's gradient: the reference's cast to int8 passes no
  cotangent, so ``jax.grad`` reaches the tokens and the expert weights
  only through each block's scale (its absolute maximum: at most one
  element a 256-element block) and lands far from the exact wire's
  gradient; the port sends the cotangent over the same int8 wire and
  lands within the quantization error of the exact one.
* In-process: ``moe_capacity``, a group of one against the 2-rank
  answer's structure, and the argument checks.
"""

import json
import os
import zlib
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from horovod_tpu.parallel import moe as jmoe
from horovod_tpu.transport import policy as jpolicy
from horovod_tpu_torch.parallel import moe as tmoe

ROOT = pathlib.Path(__file__).resolve().parents[1]
_EP, _T, _D = 2, 16, 8
_TOL = dict(rtol=1e-5, atol=1e-5)

# name -> (experts_per_rank, capacity_factor, top_k, wire, expert body)
_CASES = {
    "routing": (2, 4.0, 1, "", "scale"),
    "capacity_drop": (1, 0.25, 1, "", "identity"),
}
for _k in (1, 2):
    for _cf in (0.25, 1.25, 4.0):
        for _epr in (1, 2):
            _CASES[f"k{_k}_cf{_cf}_epr{_epr}"] = (_epr, _cf, _k, "", "tanh")
for _wire in ("bf16", "fp16", "int8"):
    _CASES[f"wire_{_wire}"] = (1, 1.25, 2, _wire, "tanh")
_CASES["int8_grad_exact"] = (1, 4.0, 1, "", "tanh")
_CASES["int8_grad_int8"] = (1, 4.0, 1, "int8", "tanh")


def _inputs(name):
    epr, _, _, _, body = _CASES[name]
    e = _EP * epr
    # The two int8_grad cases share their inputs.
    seed = "int8_grad" if name.startswith("int8_grad") else name
    rng = np.random.default_rng(zlib.crc32(seed.encode()))
    if name == "routing":
        tokens = np.ones((_EP * _T, _D), np.float32)
        logits = np.eye(e, dtype=np.float32)[np.arange(_EP * _T) % e] * 50
        w = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    elif name == "capacity_drop":
        tokens = np.ones((_EP * _T, _D), np.float32)
        logits = np.tile(np.array([[50.0, 0.0]], np.float32), (_EP * _T, 1))
        w = np.zeros(e, np.float32)
    else:
        tokens = rng.standard_normal((_EP * _T, _D)).astype(np.float32)
        logits = rng.standard_normal((_EP * _T, e)).astype(np.float32)
        w = (rng.standard_normal((e, _D, _D)) / np.sqrt(_D)).astype(
            np.float32)
    cot = rng.standard_normal((_EP * _T, _D)).astype(np.float32)
    return dict(tokens=tokens, logits=logits, w=w, cot=cot)


def _body_jax(body, w):
    if body == "scale":
        return lambda x: x * w[:, None, None]
    if body == "identity":
        return lambda x: x + 0 * w.sum()
    return lambda x: jnp.tanh(jnp.einsum("end,edf->enf", x, w))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_WORKER = r"""
import json, os, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel import moe_dispatch_combine

def body_fn(body, w):
    if body == "scale":
        return lambda x: x * w[:, None, None]
    if body == "identity":
        return lambda x: x + 0 * w.sum()
    return lambda x: torch.tanh(torch.einsum("end,edf->enf", x, w))

hvd.init(device="cpu")
r = hvd.rank()
data = np.load(sys.argv[1])
cases, t = json.loads(sys.argv[3]), int(sys.argv[4])
res = {}
for name, (epr, cf, k, wire, body) in cases.items():
    if wire:
        os.environ["HVDT_TRANSPORT"] = "ep:ring:" + wire
    else:
        os.environ.pop("HVDT_TRANSPORT", None)
    rows = slice(r * t, (r + 1) * t)
    tok = torch.tensor(data[name + ".tokens"][rows], requires_grad=True)
    lg = torch.tensor(data[name + ".logits"][rows], requires_grad=True)
    w = torch.tensor(data[name + ".w"][r * epr:(r + 1) * epr],
                     requires_grad=True)
    out, aux = moe_dispatch_combine(
        tok, lg, body_fn(body, w), experts_per_rank=epr,
        capacity_factor=cf, top_k=k)
    loss = (out * torch.from_numpy(data[name + ".cot"][rows])).sum() \
        + 0.5 * aux.load_balance_loss
    loss.backward()
    res[name + ".out"] = out.detach().numpy()
    res[name + ".lb"] = aux.load_balance_loss.detach().numpy()
    res[name + ".dropped"] = aux.dropped_fraction.detach().numpy()
    for key, leaf in (("dtokens", tok), ("dlogits", lg), ("dw", w)):
        res[name + "." + key] = leaf.grad.numpy()
np.savez(sys.argv[2], **res)
hvd.shutdown()
"""


def _jax_case(name, inp):
    """The reference under shard_map: out, lb, dropped and the gradients
    of the psum of the members' losses."""
    epr, cf, k, wire, body = _CASES[name]
    mesh = Mesh(np.asarray(jax.devices()[:_EP]), ("ep",))
    if wire:
        os.environ["HVDT_TRANSPORT"] = "ep:ring:" + wire
    jpolicy.reset()
    try:
        def total(tokens, logits, w, cot):
            def local(t, lg, wl, c):
                out, aux = jmoe.moe_dispatch_combine(
                    t, lg, _body_jax(body, wl), axis="ep",
                    experts_per_rank=epr, capacity_factor=cf, top_k=k)
                loss = (out * c).sum() + 0.5 * aux.load_balance_loss
                return (lax.psum(loss, "ep"), out, aux.load_balance_loss,
                        aux.dropped_fraction)

            loss, out, lb, dropped = jax.shard_map(
                local, mesh=mesh, in_specs=(P("ep"),) * 4,
                out_specs=(P(), P("ep"), P(), P()), check_vma=False)(
                    tokens, logits, w, cot)
            return loss, (out, lb, dropped)

        args = [jnp.asarray(inp[key]) for key in ("tokens", "logits", "w",
                                                  "cot")]
        (_, (out, lb, dropped)), grads = jax.jit(jax.value_and_grad(
            total, argnums=(0, 1, 2), has_aux=True))(*args)
    finally:
        os.environ.pop("HVDT_TRANSPORT", None)
        jpolicy.reset()
    return {"out": np.asarray(out), "lb": float(lb),
            "dropped": float(dropped),
            **{key: np.asarray(g) for key, g in zip(
                ("dtokens", "dlogits", "dw"), grads)}}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The port's results (rows of both members concatenated) and the
    reference's, per case."""
    tmp = tmp_path_factory.mktemp("moe")
    inputs = {n: _inputs(n) for n in _CASES}
    np.savez(tmp / "in.npz", **{f"{n}.{k}": v for n, d in inputs.items()
                                for k, v in d.items()})
    env = dict(os.environ, HVDT_SIZE=str(_EP),
               HVDT_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("HVDT_TRANSPORT", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(tmp / "in.npz"),
         str(tmp / f"out{r}.npz"), json.dumps(_CASES), str(_T)],
        env=dict(env, HVDT_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(_EP)]
    want = {n: _jax_case(n, inputs[n]) for n in _CASES}
    res = []
    for r, p in enumerate(procs):
        log, _ = p.communicate(timeout=240)
        assert p.returncode == 0, log.decode()[-3000:]
        res.append(dict(np.load(tmp / f"out{r}.npz")))
    got = {}
    for n in _CASES:
        got[n] = {key: np.concatenate([r[f"{n}.{key}"] for r in res])
                  for key in ("out", "dtokens", "dlogits", "dw")}
        for key in ("lb", "dropped"):
            vals = [float(r[f"{n}.{key}"]) for r in res]
            assert vals[0] == vals[1], (n, key, vals)
            got[n][key] = vals[0]
    return got, want, inputs


_EXACT = [n for n in _CASES if not _CASES[n][3]]


@pytest.mark.parametrize("name", _EXACT)
def test_matches_reference(world, name):
    got, want, _ = world
    g, w = got[name], want[name]
    np.testing.assert_allclose(g["out"], w["out"], **_TOL)
    np.testing.assert_allclose(g["lb"], w["lb"], rtol=1e-5)
    assert g["dropped"] == pytest.approx(w["dropped"], abs=1e-7)
    for key in ("dtokens", "dlogits", "dw"):
        np.testing.assert_allclose(g[key], w[key], err_msg=key, **_TOL)


def test_routing_correctness(world):
    """The reference's test: token i goes to expert i % 4, which scales
    it by its constant, times the softmax gate; nothing dropped."""
    got, _, inp = world
    out = got["routing"]["out"]
    logits = inp["routing"]["logits"]
    p = np.exp(logits - logits.max(-1, keepdims=True))
    gates = (p / p.sum(-1, keepdims=True)).max(-1)
    for i in range(_EP * _T):
        np.testing.assert_allclose(out[i], np.full(_D, (i % 4 + 1)
                                                   * gates[i]), rtol=1e-4)
    assert got["routing"]["dropped"] == 0.0


def test_capacity_drop(world):
    """The reference's test: every token to expert 0 at capacity factor
    0.25 (4 slots of 16 choices a member): most dropped, zeros out."""
    got, _, _ = world
    assert got["capacity_drop"]["dropped"] > 0.5
    assert np.count_nonzero(got["capacity_drop"]["out"].sum(-1)) == 4


@pytest.mark.parametrize("wire", ["bf16", "fp16", "int8"])
def test_wires_match_reference(world, wire):
    got, want, inp = world
    name = f"wire_{wire}"
    g, w = got[name], want[name]
    if wire == "int8":
        # One int8 step of the largest block (gates <= 1, |tanh| <= 1):
        # the two sides may round a code differently at a half.
        step = 1.0 / 127
        np.testing.assert_allclose(g["out"], w["out"], atol=2 * step)
    else:
        np.testing.assert_allclose(g["out"], w["out"], **_TOL)
        for key in ("dtokens", "dlogits", "dw"):
            np.testing.assert_allclose(g[key], w[key], err_msg=key,
                                       rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g["lb"], w["lb"], rtol=1e-5)
    assert g["dropped"] == pytest.approx(w["dropped"], abs=1e-7)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_reference_vjp_passes_only_through_block_scales(world):
    """The int8 wire's gradient: the reference's reaches the tokens and
    the expert weights only through the block scales, the port's is the
    quantized cotangent, near the exact wire's gradient."""
    got, want, _ = world
    exact, ref, port = (want["int8_grad_exact"], want["int8_grad_int8"],
                        got["int8_grad_int8"])
    for key in ("dtokens", "dw"):
        # At most one element of a 256-element block reaches the input.
        frac = np.count_nonzero(ref[key]) / ref[key].size
        assert frac <= 0.25, (key, frac)
        assert _rel(ref[key], exact[key]) > 0.5, key
        assert _rel(port[key], exact[key]) < 2e-2, key
        # Only cotangents that round to code 0 vanish.
        assert np.count_nonzero(port[key]) >= 0.9 * port[key].size, key
    # The exact wire is the same function on both sides.
    np.testing.assert_allclose(got["int8_grad_exact"]["dtokens"],
                               exact["dtokens"], **_TOL)


def test_moe_capacity_matches_reference():
    for args in [(8, 2, 1, 1.0), (1, 64, 1, 1.0), (16, 4, 2, 1.25),
                 (16384, 8, 2, 1.25), (7, 3, 1, 0.25)]:
        t, e, k, cf = args
        assert tmoe.moe_capacity(t, e, top_k=k, capacity_factor=cf) == \
            jmoe.moe_capacity(t, e, top_k=k, capacity_factor=cf)


def test_group_of_one_and_checks(monkeypatch):
    """No process group: the experts are all local and nothing moves;
    HVDT_MOE_TOPK and HVDT_MOE_CAPACITY_FACTOR are read at the call."""
    rng = np.random.default_rng(3)
    tok = torch.tensor(rng.standard_normal((12, 4)), dtype=torch.float32)
    lg = torch.tensor(rng.standard_normal((12, 3)), dtype=torch.float32)
    monkeypatch.setenv("HVDT_MOE_TOPK", "2")
    monkeypatch.setenv("HVDT_MOE_CAPACITY_FACTOR", "8")
    out, aux = tmoe.moe_dispatch_combine(tok, lg, lambda x: 2 * x,
                                         experts_per_rank=3)
    torch.testing.assert_close(out, 2 * tok)
    assert float(aux.dropped_fraction) == 0.0
    with pytest.raises(ValueError, match="router logits last dim"):
        tmoe.moe_dispatch_combine(tok, lg, lambda x: x, experts_per_rank=2)
    with pytest.raises(ValueError, match="exceeds"):
        tmoe.moe_dispatch_combine(tok, lg, lambda x: x, experts_per_rank=3,
                                  top_k=4)
    assert tmoe.a2a_wire_bytes((2, 1, 5, 8), torch.float32, None) == 320
    assert tmoe.a2a_wire_bytes((2, 1, 5, 8), torch.float32, "bf16") == 160
    assert tmoe.a2a_wire_bytes((2, 1, 5, 8), torch.float32, "int8") == \
        2 * 256 + 2 * 4
