"""PyTorch port, the transformer LM on its parallel axes
(horovod_tpu_torch/models/transformer.py with MoE, ``ep`` and ``pp``;
``remat_policy="dots"``; ``DistributedOptimizer(axis=, pipeline=,
expert=)``) held against the JAX package's models/transformer.py on the
same numpy weights and tokens.

Size: 4 layers, d_model 64, 4 heads, d_ff 128, vocab 256, seq 32, batch
4, f32.  The weights are the JAX package's parameter tree filled from
numpy and carried over by ``convert.transformer_params_from_jax`` (with
each member's ``pp`` / ``ep`` slice).  Layouts:

* ``num_experts=4, ep=1`` — the dense fallback, in-process;
* ``ep=2`` (4 experts, 2 a member) — a 2-process gloo world over
  ``make_mesh(dp=1, ep=2)``, each member with its own 2 sequences; the
  reference under ``jax.shard_map`` over ``ep`` (tokens and experts
  sharded) with the loss averaged by ``lax.pmean``;
* ``pp=2`` (2 layers a stage, m = 2 microbatches) — a 2-process world
  over ``make_mesh(dp=1, pp=2)``, the same tokens on both stages; the
  reference under ``shard_map`` over ``pp`` (stacked layers sharded);
* ``remat_policy="dots"`` against the reference's ``dots``, in-process.

In the worlds each member's gradients after ``DistributedOptimizer(axis=
"dp", expert="ep" | pipeline="pp").synchronize()`` are held to the
reference's gradient (the member's slice of a sharded leaf, the whole of
a replicated one); the plain world-averaging optimizer mixes the two
members' experts and the two stages' layers, which two tests show.

Tolerances (f32), as tests/test_torch_port_transformer.py: loss rtol
1e-5; gradients 1e-4 relative L2 per tensor.
"""

import os
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

import horovod_tpu_torch as hvd
from horovod_tpu.models import transformer as jt
from horovod_tpu_torch.convert import transformer_params_from_jax
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.parallel import mesh as tmesh

ROOT = pathlib.Path(__file__).resolve().parents[1]
_KW = dict(vocab=256, layers=4, d_model=64, heads=4, kv_heads=4, d_ff=128,
           max_seq=32)
_B, _L = 4, 32
_GRAD_TOL = 1e-4


def _jcfg(**kw):
    return jt.TransformerConfig(dtype=jnp.float32, **{**_KW, **kw})


def _tcfg(**kw):
    return tt.TransformerConfig(dtype=torch.float32, **{**_KW, **kw})


def _numpy_params(cfg, seed=0):
    shapes = jax.eval_shape(lambda key: jt.transformer_init(key, cfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if "ln" in jax.tree_util.keystr(path):
            return np.ones(leaf.shape, np.float32)
        return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)

    return jax.tree.map(np.asarray,
                        jax.tree_util.tree_map_with_path(fill, shapes))


def _tokens():
    return np.random.default_rng(1).integers(0, 256, (_B, _L)).astype(
        np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_loss_grads(cfg, params, tokens, island=None):
    """Loss and gradients of the reference; ``island`` ("ep" or "pp")
    runs it under shard_map over two devices with that axis manual and
    the loss averaged over it."""
    p = jax.tree.map(jnp.asarray, params)
    t = jnp.asarray(tokens)
    if island is None:
        fn = lambda p, t: jt.transformer_loss(p, t, cfg)   # noqa: E731
    else:
        mesh = Mesh(np.asarray(jax.devices()[:2]), (island,))
        axes = jt.transformer_logical_axes(cfg)
        logical = {"experts": "ep"} if island == "ep" else {"stages": "pp"}

        def spec(lg):
            s = [logical.get(name) for name in lg]
            while s and s[-1] is None:
                s.pop()
            return P(*s)

        specs = jax.tree.map(spec, axes, is_leaf=lambda x: isinstance(
            x, tuple))

        def local(p, t):
            return lax.pmean(jt.transformer_loss(p, t, cfg), island)

        fn = jax.shard_map(local, mesh=mesh, in_specs=(
            specs, P(island) if island == "ep" else P()), out_specs=P())
    loss, grads = jax.jit(jax.value_and_grad(fn))(p, t)
    return float(loss), _flat(jax.tree.map(np.asarray, grads))


def _port_model(cfg, params, **ranks):
    pp_rank, ep_rank = ranks.get("pp_rank", 0), ranks.get("ep_rank", 0)
    model = tt.transformer_init(0, cfg, device="cpu", pp_rank=pp_rank,
                                ep_rank=ep_rank)
    model.load_state_dict(transformer_params_from_jax(
        params, pp=(pp_rank, cfg.pp) if cfg.pp > 1 else None,
        ep=(ep_rank, cfg.ep) if cfg.ep > 1 else None))
    return model


def _grads(model):
    return {n: p.grad.detach().numpy().copy()
            for n, p in model.named_parameters()}


def _check_grads(got, want, slicer=lambda name, leaf: leaf):
    for name, g in got.items():
        w = slicer(name, want[name])
        assert g.shape == w.shape, name
        if np.abs(w).max() < 1e-8:
            # The router under ep > 1 at top_k = 1: the gate is v / v,
            # so the reference's gradient is rounding noise around 0.
            assert np.abs(g).max() < 1e-8, name
            continue
        assert _rel(g, w) < _GRAD_TOL, (name, _rel(g, w))


# ---- in-process layouts -----------------------------------------------------


def test_moe_dense_fallback_matches_reference():
    jcfg, tcfg = _jcfg(num_experts=4), _tcfg(num_experts=4)
    params, tokens = _numpy_params(jcfg), _tokens()
    want_loss, want = _jax_loss_grads(jcfg, params, tokens)
    model = _port_model(tcfg, params)
    loss = tt.transformer_loss(model, torch.from_numpy(tokens), tcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    _check_grads(_grads(model), want)


def test_group_of_one_routes_like_the_reference_ep_island():
    """ep = 1 with an ep_group of one takes the routed path with every
    expert local; with no drops (capacity factor 4 = E) it is the
    reference's ep = 2 island on the same global batch: loss and every
    gradient."""
    import torch.distributed as dist

    jcfg = _jcfg(num_experts=4, ep=2, capacity_factor=4.0)
    params, tokens = _numpy_params(jcfg), _tokens()
    want_loss, want = _jax_loss_grads(jcfg, params, tokens, island="ep")
    cfg = _tcfg(num_experts=4, capacity_factor=4.0)
    hvd.init(device="cpu")
    try:
        model = _port_model(cfg, params)
        loss = tt.transformer_loss(model, torch.from_numpy(tokens), cfg,
                                   ep_group=dist.group.WORLD)
        loss.backward()
    finally:
        hvd.shutdown()
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    _check_grads(_grads(model), want)


@pytest.mark.parametrize("experts", [0, 4])
def test_dots_matches_reference_dots(experts):
    """remat_policy="dots" against the reference's dots policy, and in
    every byte against the port's own remat="full" and no remat."""
    jcfg = _jcfg(num_experts=experts, remat=True, remat_policy="dots")
    params, tokens = _numpy_params(jcfg), _tokens()
    want_loss, want = _jax_loss_grads(jcfg, params, tokens)
    runs = {}
    for policy in ("dots", "full", None):
        cfg = _tcfg(num_experts=experts, remat=policy is not None,
                    remat_policy=policy or "full")
        model = _port_model(cfg, params)
        loss = tt.transformer_loss(model, torch.from_numpy(tokens), cfg)
        loss.backward()
        runs[policy] = (loss.item(), _grads(model))
    np.testing.assert_allclose(runs["dots"][0], want_loss, rtol=1e-5)
    _check_grads(runs["dots"][1], want)
    for policy in ("full", None):
        assert runs[policy][0] == runs["dots"][0]
        for name, g in runs["dots"][1].items():
            np.testing.assert_array_equal(g, runs[policy][1][name])


def test_dots_saves_the_products_and_recomputes_the_rest():
    """Under dots the backward recomputes no aten.mm (the block's
    projections are saved), under full every one of them."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func] = self.ops.get(func, 0) + 1
            return func(*args, **(kwargs or {}))

    params, tokens = _numpy_params(_jcfg()), torch.from_numpy(_tokens())
    mm = {}
    for policy in ("none", "full", "dots"):
        cfg = tt.remat_from_env(_tcfg(), policy)
        model = _port_model(cfg, params)
        loss = tt.transformer_loss(model, tokens, cfg)
        with Count() as count:
            loss.backward()
        mm[policy] = count.ops.get(torch.ops.aten.mm.default, 0)
    # Under full the recompute runs the block's products up to the last
    # one the backward reads (q, k, v, o, up, gate: the checkpoint stops
    # early before down), 4 layers; the backward's own products are the
    # same in every run.
    assert mm["full"] - mm["none"] >= 6 * 4
    assert mm["dots"] == mm["none"]
    assert tt.checkpoint_policy("dots") is tt._dots_policy
    assert tt.remat_from_env(_tcfg(), "dots").remat_policy == "dots"


# ---- the 2-process worlds ---------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_WORKER = r"""
import json, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.convert import transformer_params_from_jax
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.parallel import make_mesh

axis, kw, b = sys.argv[3], json.loads(sys.argv[4]), int(sys.argv[5])
data = np.load(sys.argv[1])
params = {"block": {}}
for name in data.files:
    if name.startswith("block."):
        params["block"][name[6:]] = data[name]
    elif name != "tokens":
        params[name] = data[name]
hvd.init(device="cpu")
r = hvd.rank()
mesh = make_mesh(dp=1, **{axis: 2})
cfg = tt.TransformerConfig(dtype=torch.float32, **kw)
ranks = {axis + "_rank": r}
model = tt.transformer_init(0, cfg, device="cpu", **ranks)
model.load_state_dict(transformer_params_from_jax(params, **{axis: (r, 2)}))
tokens = torch.from_numpy(data["tokens"])
if axis == "ep":
    tokens = tokens[r * b:(r + 1) * b]
groups = {axis + "_group": mesh}
res = {}
for mode in ("axis", "world"):
    model.zero_grad()
    loss = tt.transformer_loss(model, tokens, cfg, **groups)
    loss.backward()
    sgd = torch.optim.SGD(model.parameters(), lr=0.1)
    if mode == "axis":
        opt = hvd.DistributedOptimizer(
            sgd, axis="dp", **({"expert": "ep"} if axis == "ep"
                               else {"pipeline": "pp"}))
    else:
        opt = hvd.DistributedOptimizer(sgd)
    opt.synchronize()
    res[mode + ".loss"] = np.array(loss.item())
    for n, p in model.named_parameters():
        res[mode + "." + n] = p.grad.numpy()
np.savez(sys.argv[2], **res)
hvd.shutdown()
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Per layout ("ep", "pp"): the reference's loss and gradients and
    each member's results."""
    import json

    tmp = tmp_path_factory.mktemp("tparallel")
    layouts = {"ep": dict(num_experts=4, ep=2), "pp": dict(pp=2)}
    procs, want = {}, {}
    for axis, extra in layouts.items():
        jcfg = _jcfg(**extra)
        params, tokens = _numpy_params(jcfg), _tokens()
        np.savez(tmp / f"in_{axis}.npz", tokens=tokens, **_flat(params))
        env = dict(os.environ, HVDT_SIZE="2",
                   HVDT_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
                   PYTHONPATH=str(ROOT) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        for k in ("HVDT_TRANSPORT", "HVDT_OVERLAP", "HVDT_ZERO"):
            env.pop(k, None)
        procs[axis] = [subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(tmp / f"in_{axis}.npz"),
             str(tmp / f"out_{axis}{r}.npz"), axis,
             json.dumps({**_KW, **extra}), str(_B // 2)],
            env=dict(env, HVDT_RANK=str(r)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for r in range(2)]
        want[axis] = _jax_loss_grads(jcfg, params, tokens, island=axis)
    got = {}
    for axis, ps in procs.items():
        got[axis] = []
        for r, p in enumerate(ps):
            log, _ = p.communicate(timeout=240)
            assert p.returncode == 0, log.decode()[-3000:]
            got[axis].append(dict(np.load(tmp / f"out_{axis}{r}.npz")))
    return got, want


def _member_slice(axis, rank):
    cfg = _tcfg(num_experts=4, ep=2) if axis == "ep" else _tcfg(pp=2)

    def slicer(name, leaf):
        if not name.startswith("block."):
            return leaf
        return tt.local_slice(name[6:], leaf, cfg, **{axis + "_rank": rank})
    return slicer


@pytest.mark.parametrize("axis", ["ep", "pp"])
def test_parallel_layout_matches_reference(worlds, axis):
    got, want = worlds
    want_loss, want_grads = want[axis]
    losses = [float(r["axis.loss"]) for r in got[axis]]
    # ep: the members' mean is the reference's pmean; pp: every stage
    # computes the same loss.
    np.testing.assert_allclose(np.mean(losses), want_loss, rtol=1e-5)
    if axis == "pp":
        assert losses[0] == losses[1]
    for rank, res in enumerate(got[axis]):
        grads = {k[5:]: v for k, v in res.items()
                 if k.startswith("axis.") and k != "axis.loss"}
        assert set(grads) == set(want_grads)
        _check_grads(grads, want_grads, _member_slice(axis, rank))


def test_world_average_mixes_the_experts(worlds):
    """Averaging the expert leaves over ep, as the plain optimizer over
    the world does, gives every member the same, wrong, gradient."""
    got, want = worlds
    _, want_grads = want["ep"]
    for rank, res in enumerate(got["ep"]):
        slicer = _member_slice("ep", rank)
        for name in ("block.w_up", "block.w_down"):
            right = slicer(name, want_grads[name])
            assert _rel(res["axis." + name], right) < _GRAD_TOL
            assert _rel(res["world." + name], right) > 0.1, name
    np.testing.assert_array_equal(got["ep"][0]["world.block.w_up"],
                                  got["ep"][1]["world.block.w_up"])


def test_world_average_mixes_the_stages(worlds):
    """Averaging the stage leaves over pp, as the plain optimizer over
    the world does, gives both stages the same, wrong, gradient."""
    got, want = worlds
    _, want_grads = want["pp"]
    for rank, res in enumerate(got["pp"]):
        slicer = _member_slice("pp", rank)
        for name in ("block.wq", "block.w_up", "block.ln1"):
            right = slicer(name, want_grads[name])
            assert _rel(res["axis." + name], right) < _GRAD_TOL
            assert _rel(res["world." + name], right) > 0.1, name
    np.testing.assert_array_equal(got["pp"][0]["world.block.wq"],
                                  got["pp"][1]["world.block.wq"])


# ---- configs and the optimizer contract -------------------------------------


def test_logical_axes_match_reference():
    for experts in (0, 4):
        assert tt.transformer_logical_axes(_tcfg(num_experts=experts)) == \
            jt.transformer_logical_axes(_jcfg(num_experts=experts))


def test_slices_of_one_model():
    """A member's module holds its slice of the model the same seed
    draws whole, and its sharded leaves say over which axes."""
    whole = tt.transformer_init(3, _tcfg(num_experts=4), device="cpu")
    cfg = _tcfg(num_experts=4, ep=2, pp=2)
    part = tt.transformer_init(3, cfg, device="cpu", pp_rank=1, ep_rank=1)
    for name, p in part.block.items():
        torch.testing.assert_close(
            p, tt.local_slice(name, whole.block[name], cfg, 1, 1))
        axes = ("pp", "ep") if name in ("w_up", "w_down") else ("pp",)
        assert tmesh.sharded_axes(p) == axes
    assert tmesh.sharded_axes(part.embed) == ()
    assert part.block["w_up"].shape == (2, 2, 64, 128)


def test_optimizer_contract(monkeypatch):
    for kw in (dict(axis=("dp", "pp"), pipeline="pp"),
               dict(axis=("dp", "ep"), expert="ep")):
        with pytest.raises(ValueError, match="parameter-SHARDED"):
            hvd.DistributedOptimizer(
                torch.optim.SGD([torch.zeros(2, requires_grad=True)], 0.1),
                **kw)
    hvd.init(device="cpu")
    try:
        tmesh.make_mesh(dp=1, pp=1, ep=1)
        model = tt.transformer_init(0, _tcfg(num_experts=4, ep=1),
                                    device="cpu")
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), 0.1), axis="dp",
            pipeline="pp", expert="ep")
        assert opt._axis == "dp" and opt._process_set.size() == 1
        marked = torch.zeros(3, requires_grad=True)
        tmesh.mark_sharded(marked, "ep")
        with pytest.raises(ValueError, match="name the axis"):
            hvd.DistributedOptimizer(torch.optim.SGD([marked], 0.1),
                                     axis="dp")
        with pytest.raises(ValueError, match="not among"):
            hvd.DistributedOptimizer(torch.optim.SGD([marked], 0.1),
                                     axis="tp", expert="ep")
    finally:
        hvd.shutdown()


# sp together with pp or ep builds since parallel axes, part 2 (match
# None): the member's module holds its part, and its loss asks for the
# ring's group; tests/test_torch_port_tensor_parallel.py runs both layouts
# in a world of 4 against the reference.  The ids are the ones these
# cases had while they raised.
@pytest.mark.parametrize("kw,match", [
    (dict(sp=2, pp=2), None),
    (dict(sp=2, ep=2, num_experts=2), None),
    (dict(pp=3), "not divisible by pp"),
    (dict(num_experts=3, ep=2), "not divisible by ep")],
    ids=["kw0-parallel axes, part 2", "kw1-parallel axes, part 2",
         "kw2-not divisible by pp", "kw3-not divisible by ep"])
def test_config_checks(kw, match):
    if match is None:
        cfg = _tcfg(**kw)
        model = tt.transformer_init(0, cfg, device="cpu", pp_rank=1,
                                    ep_rank=1 if cfg.ep > 1 else 0)
        assert model.block["wq"].shape[0] == _KW["layers"] // cfg.pp
        if cfg.num_experts:
            assert model.block["w_up"].shape[1] == 1
        with pytest.raises(ValueError, match="needs sp_group"):
            tt.transformer_loss(model, torch.zeros((2, 8), dtype=torch.long),
                                cfg)
        return
    with pytest.raises((NotImplementedError, ValueError), match=match):
        tt.transformer_init(0, _tcfg(**kw), device="cpu")


def test_groups_are_checked():
    model = tt.transformer_init(0, _tcfg(pp=2), device="cpu")
    with pytest.raises(ValueError, match="needs pp_group"):
        tt.transformer_loss(model, torch.zeros((2, 8), dtype=torch.long),
                            _tcfg(pp=2))
