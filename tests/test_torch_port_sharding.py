"""PyTorch port, the logical-axis sharding rules
(horovod_tpu_torch/parallel/sharding.py) held against the JAX package's
parallel/sharding.py: the rule table in both forms, ``logical_to_mesh``
on the reference's cases (tests/test_parallel.py: absent and size-1 axes
dropped, the tp and fsdp layouts, the double-use ``ValueError``),
``batch_spec``, ``fsdp_shardings`` / ``named_sharding`` (the placements
against the reference's ``NamedSharding`` specs) and ``local_part``
against the shards ``jax.device_put`` lays out on the CPU's 8 devices.
In-process, no process group: a mesh is a mapping of axis sizes or a
stand-in with a ``DeviceMesh``'s ``mesh_dim_names`` and ``mesh``.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import horovod_tpu_torch.parallel as tpar
from horovod_tpu.models import transformer as jt
from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu.parallel import sharding as js
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.parallel import sharding as ts


def _spec(pspec):
    """A PartitionSpec as the port's tuple."""
    return tuple(pspec)


def _fake_mesh(**sizes):
    """What the port reads of a ``DeviceMesh``: dimension names, shape."""
    return types.SimpleNamespace(
        mesh_dim_names=tuple(sizes),
        mesh=torch.zeros(tuple(sizes.values()), dtype=torch.int64))


@pytest.mark.parametrize("fsdp", [False, True])
def test_rules_match_reference(fsdp):
    assert ts.transformer_rules(fsdp=fsdp) == js.transformer_rules(fsdp=fsdp)
    rules = ts.transformer_rules(fsdp=fsdp)
    assert rules["kv"] is None and rules["vocab"] is None


# The reference's TestShardingRules cases, and size-1 / absent axes.
_MAPPING_CASES = [
    (dict(dp=8), ("batch", "embed"), False),
    (dict(dp=4, tp=2), ("embed", "mlp"), False),
    (dict(dp=2, fsdp=4), ("batch",), True),
    (dict(dp=2, fsdp=4), ("vocab", "embed"), True),
    (dict(dp=2, tp=1, fsdp=4), ("embed", "heads"), True),
    (dict(dp=2, pp=2, tp=2), ("stages", "embed", "heads"), False),
    (dict(dp=1, ep=2, sp=4), ("stages", "experts", "embed", "mlp"), False),
    (dict(dp=2, sp=4), ("batch", "seq"), False),
]


@pytest.mark.parametrize("sizes,logical,fsdp", _MAPPING_CASES)
def test_logical_to_mesh_matches_reference(sizes, logical, fsdp):
    mesh = jmesh.make_mesh(**sizes)
    want = js.logical_to_mesh(logical, js.transformer_rules(fsdp=fsdp), mesh)
    rules = ts.transformer_rules(fsdp=fsdp)
    assert ts.logical_to_mesh(logical, rules, sizes) == _spec(want)
    assert ts.logical_to_mesh(logical, rules, _fake_mesh(**sizes)) == \
        _spec(want)


def test_logical_to_mesh_without_a_mesh_and_double_use():
    rules = ts.transformer_rules(fsdp=True)
    for logical in (("batch", "seq"), ("embed", "mlp"), (None, "heads")):
        assert ts.logical_to_mesh(logical, rules) == _spec(
            js.logical_to_mesh(logical, js.transformer_rules(fsdp=True)))
    assert ts.logical_to_mesh(("kv", None, None), rules) == ()
    with pytest.raises(ValueError, match="consumed twice"):
        ts.logical_to_mesh(("mlp", "heads"), ts.transformer_rules(),
                           dict(tp=8))
    with pytest.raises(ValueError, match="consumed twice"):
        js.logical_to_mesh(("mlp", "heads"), js.transformer_rules(),
                           jmesh.make_mesh(tp=8))
    # A size-1 axis is dropped, so the same table serves a mesh without tp.
    assert ts.logical_to_mesh(("mlp", "heads"), ts.transformer_rules(),
                              dict(dp=8, tp=1)) == ()


@pytest.mark.parametrize("sizes,seq,fsdp", [
    (dict(dp=8), False, False), (dict(dp=2, sp=4), True, False),
    (dict(dp=2, fsdp=4), False, True), (dict(dp=2, fsdp=2, sp=2), True,
                                        True)])
def test_batch_spec_matches_reference(sizes, seq, fsdp):
    mesh = jmesh.make_mesh(**sizes)
    want = js.batch_spec(mesh, seq_sharded=seq,
                         rules=js.transformer_rules(fsdp=fsdp))
    got = ts.batch_spec(sizes, seq_sharded=seq,
                        rules=ts.transformer_rules(fsdp=fsdp))
    assert got == _spec(want)
    assert ts.batch_spec() == _spec(js.batch_spec())


def _placements_of(pspec, names):
    """The placements a PartitionSpec gives on mesh dims ``names``."""
    out = ["R"] * len(names)
    for dim, entry in enumerate(pspec):
        for ax in ((entry,) if isinstance(entry, str) else entry or ()):
            out[names.index(ax)] = f"S({dim})"
    return out


@pytest.mark.parametrize("experts", [0, 4])
def test_fsdp_shardings_match_reference(experts):
    sizes = dict(dp=2, fsdp=2, tp=2)
    mesh = jmesh.make_mesh(**sizes)
    axes = jt.transformer_logical_axes(jt.TransformerConfig(
        num_experts=experts))
    want = js.fsdp_shardings(mesh, axes)
    got = ts.fsdp_shardings(_fake_mesh(**sizes), axes)
    names = tuple(sizes)
    flat_w = jax.tree.leaves(want)
    flat_g = jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, tuple))
    assert len(flat_w) == len(flat_g) == len(jax.tree.leaves(
        axes, is_leaf=lambda x: isinstance(x, tuple)))
    for w, g in zip(flat_w, flat_g):
        assert [str(p) for p in g] == _placements_of(w.spec, names)
    # The embed leaf: vocab replicated, embed over fsdp.
    assert [str(p) for p in got["embed"]] == ["R", "S(1)", "R"]


def test_named_sharding_default_rules():
    mesh = _fake_mesh(dp=4, tp=2)
    assert [str(p) for p in ts.named_sharding(mesh, ("embed", "mlp"))] == \
        ["R", "S(1)"]
    assert [str(p) for p in ts.named_sharding(mesh, ("batch", None))] == \
        ["S(0)", "R"]


@pytest.mark.parametrize("sizes,logical,fsdp", [
    (dict(fsdp=2, tp=4), ("embed", "heads"), True),
    (dict(dp=2, fsdp=2, tp=2), ("heads", "embed"), True),
    (dict(dp=2, fsdp=4), ("batch", "seq"), True),
    (dict(dp=2, fsdp=2, sp=2), ("batch", "seq"), True),
    (dict(pp=2, ep=2, tp=2), ("stages", "experts", "embed", "mlp"), False),
    (dict(dp=4, tp=2), ("vocab", "embed"), False)])
def test_local_part_matches_device_put(devices, sizes, logical, fsdp):
    """Each device's shard of ``jax.device_put`` under the reference's
    spec is the port's ``local_part`` at that device's mesh coordinates,
    for a numpy array and for a tensor."""
    mesh = jmesh.make_mesh(**sizes)
    rules_j, rules_t = (js.transformer_rules(fsdp=fsdp),
                        ts.transformer_rules(fsdp=fsdp))
    shape = tuple(8 * (i + 2) for i in range(len(logical)))
    whole = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    placed = jax.device_put(jnp.asarray(whole), NamedSharding(
        mesh, js.logical_to_mesh(logical, rules_j, mesh)))
    names = tuple(mesh.axis_names)
    devs = np.asarray(mesh.devices)
    seen = 0
    for shard in placed.addressable_shards:
        pos = np.argwhere(devs == shard.device)[0]
        coords = dict(zip(names, (int(i) for i in pos)))
        want = np.asarray(shard.data)
        got = ts.local_part(whole, logical, rules_t, sizes, coords)
        np.testing.assert_array_equal(got, want)
        got_t = ts.local_part(torch.from_numpy(whole), logical, rules_t,
                              sizes, coords)
        np.testing.assert_array_equal(got_t.numpy(), want)
        seen += 1
    assert seen == len(jax.devices()[:np.prod(list(sizes.values()))])


def test_local_part_checks_divisibility():
    with pytest.raises(ValueError, match="does not divide"):
        ts.local_part(np.zeros((6, 4)), ("embed", "mlp"),
                      ts.transformer_rules(fsdp=True), dict(fsdp=4),
                      dict(fsdp=0))


@pytest.mark.parametrize("kw", [dict(tp=2), dict(fsdp=2), dict(tp=2, fsdp=2),
                                dict(pp=2, num_experts=4, ep=2)])
def test_transformer_leaf_specs_follow_the_rules(kw):
    """The port's transformer shards each leaf as the reference's rules
    map its logical axes on a mesh of those sizes, and ``local_slice``
    is ``local_part`` with the member's coordinates."""
    cfg = tt.TransformerConfig(vocab=64, layers=2, d_model=32, heads=4,
                               kv_heads=2, d_ff=64, max_seq=16,
                               dtype=torch.float32, **kw)
    sizes = {a: kw.get(a, 1) for a in ("pp", "ep", "tp", "fsdp")}
    mesh = jmesh.make_mesh(**{a: n for a, n in sizes.items() if n > 1})
    rules = js.transformer_rules(fsdp=cfg.fsdp > 1)
    axes = jt.transformer_logical_axes(jt.TransformerConfig(
        num_experts=cfg.num_experts))
    flat = {"embed": axes["embed"], "ln_f": axes["ln_f"],
            **axes["block"]}
    for name, logical in flat.items():
        assert tt.leaf_spec(name, cfg) == _spec(
            js.logical_to_mesh(logical, rules, mesh)), name
    whole = tt.transformer_init(0, dataclasses.replace(
        cfg, pp=1, ep=1, tp=1, fsdp=1), device="cpu")
    ranks = dict(pp_rank=sizes["pp"] - 1, ep_rank=sizes["ep"] - 1,
                 tp_rank=sizes["tp"] - 1, fsdp_rank=sizes["fsdp"] - 1)
    part = tt.transformer_init(0, cfg, device="cpu", **ranks)
    for name, p in part.named_parameters():
        short = name.split(".")[-1]
        torch.testing.assert_close(p, tt.local_slice(
            short, dict(whole.named_parameters())[name], cfg, **ranks),
            rtol=0, atol=0)


def test_exports_and_pcast():
    for name in ("transformer_rules", "logical_to_mesh", "named_sharding",
                 "batch_spec", "fsdp_shardings", "pcast_to_union",
                 "local_part"):
        assert getattr(tpar, name) is getattr(ts, name)
    x = torch.ones(3)
    assert ts.pcast_to_union(x, torch.zeros(2), extra=("sp",)) is x
    assert "PyTorch tensors carry no such" in ts.pcast_to_union.__doc__
