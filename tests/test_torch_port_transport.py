"""PyTorch port: the transport-policy layer (horovod_tpu_torch/transport)
against the JAX package's horovod_tpu/transport.

* ``HVDT_TRANSPORT`` parses to the same per-axis policies as
  ``parse_transport`` over a list of valid specs, and fails with the
  same error class (``ValueError``) on each invalid one; ``resolve`` and
  ``bucket_threshold`` agree on one-, two- and three-axis groups; the
  mesh's transport-class helpers agree.
* With the knob unset nothing resolves (``resolve_axis`` is None and
  ``fused_allreduce`` takes its flat path); ``init()`` rejects bad
  vocabulary.
* In a 4-process gloo world on a 2x2 ``("dcn", "ici")`` mesh, on exactly
  representable inputs (integers, whose sums never round), the
  hierarchical allreduce (ring or tree fast tier, a bf16 fast wire, SUM
  and AVERAGE, pre/postscale, also through the overlap scheduler) equals
  flat ``fused_allreduce`` bit for bit; the int8 slow tier stays within
  the block-scale/2 bound of its two quantization stages (here taken
  from the largest magnitudes, a looser bound than the per-block one).
"""

import dataclasses
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from horovod_tpu.parallel import mesh as jmesh
from horovod_tpu.transport import policy as jpol
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import device as tdev
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.transport import policy as tpol

ROOT = pathlib.Path(__file__).resolve().parents[1]

_VALID = ["auto", "AUTO", "ici:ring:f32", "ici:ring:f32:64M",
          "ici:ring:f32:64M,dcn:tree:int8:8M", "dcn:tree:int4",
          "dp:ring:bf16:1024", "tp:2d_ring:fp16:3k,ici:tree:f32",
          " ici : ring : f32 , dcn:ring:bf16:1G ", "sp:tree:f32:0",
          "dcn:2d_ring:int8"]
_INVALID = ["", ",", "ici", "ici:ring", "ici:ring:f32:1M:extra",
            "gpu:ring:f32", "ici:mesh:f32", "ici:ring:f64",
            "ici:ring:int8", "ici:ring:int4", "ici:ring:f32:12X",
            "ici:ring:f32:-1", "ici:ring:f32,ici:tree:f32"]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("HVDT_TRANSPORT", raising=False)
    tpol.reset()
    jpol.reset()
    yield
    tpol.reset()
    jpol.reset()


def _as_dict(entries):
    return {k: dataclasses.asdict(v) for k, v in entries.items()}


@pytest.mark.parametrize("spec", _VALID)
def test_parse_matches_reference(spec):
    want = jpol.TransportPolicy.parse(spec)
    got = tpol.TransportPolicy.parse(spec)
    assert _as_dict(got.entries) == _as_dict(want.entries)
    assert got.describe() == want.describe()


@pytest.mark.parametrize("spec", _INVALID)
def test_invalid_specs_raise_like_reference(spec):
    with pytest.raises(ValueError) as want:
        jpol.TransportPolicy.parse(spec)
    with pytest.raises(ValueError) as got:
        tpol.TransportPolicy.parse(spec)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", _VALID)
@pytest.mark.parametrize("group", [("dp",), ("tp",), ("dcn", "ici"),
                                   ("dp", "tp"), ("dp", "pp", "tp"),
                                   ("dp", "sp", "tp")])
def test_resolve_matches_reference(spec, group):
    try:
        want = jpol.TransportPolicy.parse(spec).resolve(group)
    except ValueError as e:
        with pytest.raises(ValueError, match="exactly one slow"):
            tpol.TransportPolicy.parse(spec).resolve(group)
        assert "exactly one slow" in str(e)
        return
    got = tpol.TransportPolicy.parse(spec).resolve(group)
    assert (got is None) == (want is None)
    if want is not None:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("group", [("dp",), ("dcn", "ici"),
                                   ("dp", "pp", "fsdp", "tp")])
def test_mesh_transport_helpers_match_reference(group):
    for a in group:
        assert (tmesh.axis_transport_class(a, group)
                == jmesh.axis_transport_class(a, group))
    for w in (1, 2, 3):
        assert (tmesh.split_transport_axes(group, w)
                == jmesh.split_transport_axes(group, w))
    assert tmesh.TRANSPORT_CLASSES == jmesh.TRANSPORT_CLASSES
    with pytest.raises(ValueError):
        tmesh.axis_transport_class("zz", group)


def test_env_policy_and_bucket_threshold(monkeypatch):
    assert tpol.get_policy() is None and tpol.resolve_axis("dp") is None
    assert tpol.bucket_threshold(("dcn", "ici")) is None
    assert tpol.bucket_threshold("dp", 123) == 123
    for spec in ("auto", "ici:ring:f32:64M,dcn:tree:int8:8M"):
        monkeypatch.setenv("HVDT_TRANSPORT", spec)
        for group in ("dp", ("dcn", "ici")):
            assert (tpol.bucket_threshold(group)
                    == jpol.bucket_threshold(group))
    monkeypatch.setenv("HVDT_TRANSPORT", "off")
    assert tpol.get_policy() is None and not tpol.enabled()


def test_no_policy_keeps_the_flat_path(monkeypatch):
    """Unset: nothing resolves, whatever the axis or mesh."""
    assert tdev.resolve_transport(("dcn", "ici"), "not-a-mesh") == (
        None, "not-a-mesh")
    calls = []
    monkeypatch.setattr(tpol, "resolve_axis",
                        lambda *a: calls.append(a) or None)
    hvd.init(device="cpu")
    try:
        out = tdev.fused_allreduce([torch.ones(3)], axis=("dcn", "ici"))
        assert calls == [] and torch.equal(out[0], torch.ones(3))
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("spec,match", [("ici:ring:f64", "valid: f32"),
                                        ("gpu:ring:f32", "valid: ici"),
                                        ("ici:ring:int8", "dcn-only")])
def test_init_rejects_bad_vocabulary(monkeypatch, spec, match):
    monkeypatch.setenv("HVDT_TRANSPORT", spec)
    with pytest.raises(ValueError, match=match):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()
    monkeypatch.setenv("HVDT_TRANSPORT", "auto")
    hvd.init(device="cpu")
    try:
        assert hvd.is_initialized()
    finally:
        hvd.shutdown()


# ---- a four-process gloo world on a 2x2 ("dcn", "ici") mesh ---------------------

_WORKER = r"""
import os, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import device as dev
from horovod_tpu_torch.ops import overlap as ov
from horovod_tpu_torch.parallel import make_mesh
from horovod_tpu_torch.transport import hierarchy as th, policy as tp

data = np.load(sys.argv[1])
hvd.init(device="cpu")
r = hvd.rank()
mesh = make_mesh(dcn=2, ici=2)
assert mesh.mesh_dim_names == ("dcn", "ici")
assert hvd.common.basics.current_mesh() is mesh
T = lambda k: torch.from_numpy(data[k][r].copy())
leaves = [T(f"leaf{i}") for i in range(4)] + [torch.arange(6, dtype=torch.int32) * (r + 1)]
res = {}
kws = {"avg": {}, "sum": dict(op=hvd.Sum),
       "scaled": dict(prescale_factor=0.5, postscale_factor=4.0)}
for tag, kw in kws.items():
    xs = leaves if tag != "scaled" else leaves[:4]
    for i, v in enumerate(dev.fused_allreduce(xs, threshold_bytes=512,
                                              **kw)):
        res[f"flat.{tag}.{i}"] = v.numpy()
for spec in ("auto", "ici:ring:f32,dcn:tree:f32", "ici:tree:f32,dcn:ring:f32",
             "ici:ring:bf16,dcn:tree:bf16:512", "dcn:ring:int8:512"):
    os.environ["HVDT_TRANSPORT"] = spec
    res_ = tp.resolve_axis(("dcn", "ici"))
    assert res_.kind == "hierarchical", res_
    for tag, kw in kws.items():
        xs = leaves if tag != "scaled" else leaves[:4]
        for i, v in enumerate(dev.fused_allreduce(xs, threshold_bytes=512,
                                                  **kw)):
            res[f"{spec}.{tag}.{i}"] = v.numpy()
    os.environ["HVDT_OVERLAP"] = "on"
    for i, v in enumerate(ov.OverlapScheduler().exchange(
            leaves, threshold_bytes=512)):
        res[f"{spec}.ovl.{i}"] = v.numpy()
    del os.environ["HVDT_OVERLAP"]
    res[f"{spec}.bytes"] = np.int64(th.wire_bytes_estimate(res_, 1000, 4))
    res[f"{spec}.tiers"] = np.array(th.tier_sizes(res_))
del os.environ["HVDT_TRANSPORT"]
np.savez(sys.argv[2], **res)
hvd.shutdown()
"""

_SPECS = ("auto", "ici:ring:f32,dcn:tree:f32", "ici:tree:f32,dcn:ring:f32",
          "ici:ring:bf16,dcn:tree:bf16:512")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def four_proc(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("transport4")
    rng = np.random.default_rng(60)
    shapes = [(13, 7), (301,), (4, 4, 5), (3,)]
    # |values| < 32: every partial sum of four is exact in bf16 too.
    data = {f"leaf{i}": rng.integers(-31, 32, (4,) + s).astype(np.float32)
            for i, s in enumerate(shapes)}
    np.savez(tmp / "in.npz", **data)
    env = dict(os.environ, HVDT_SIZE="4",
               HVDT_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for k in ("HVDT_OVERLAP", "HVDT_TRANSPORT", "HVDT_FUSION_THRESHOLD",
              "HVDT_COMPRESSION", "HVDT_QUANT", "HVDT_QUANT_BLOCK"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(tmp / "in.npz"),
         str(tmp / f"out{r}.npz")], env=dict(env, HVDT_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(4)]
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out.decode()[-3000:]
    return data, [dict(np.load(tmp / f"out{r}.npz")) for r in range(4)]


@pytest.mark.parametrize("tag", ["avg", "sum", "scaled", "ovl"])
@pytest.mark.parametrize("spec", _SPECS)
def test_hierarchical_equals_flat(four_proc, spec, tag):
    data, res = four_proc
    n = 5 if tag in ("avg", "sum", "ovl") else 4
    for r in range(4):
        for i in range(n):
            want = res[r][f"flat.{'avg' if tag == 'ovl' else tag}.{i}"]
            got = res[r][f"{spec}.{tag}.{i}"]
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    if tag == "avg":
        for i in range(4):
            np.testing.assert_array_equal(res[0][f"flat.avg.{i}"],
                                          data[f"leaf{i}"].mean(0))


def test_int8_slow_tier_within_bound(four_proc):
    data, res = four_proc
    spec = "dcn:ring:int8:512"
    for i in range(4):
        x = data[f"leaf{i}"].astype(np.float64)
        exact = x.mean(0)
        # Stage 1 quantizes each slow rank's fast-tier sum (|.| <= the sum
        # of two ranks' magnitudes), stage 2 the slow sum; each at most
        # half a step of 1/127 of its block's absmax; AVERAGE divides by 4.
        fast_max = 2 * np.abs(x).max()
        bound = (2 * fast_max / 127 / 2 + 2 * fast_max / 127 / 2) / 4
        for r in range(4):
            got = res[r][f"{spec}.avg.{i}"]
            assert np.abs(got - exact).max() <= bound
            np.testing.assert_array_equal(got, res[0][f"{spec}.avg.{i}"])
    for r in range(4):                     # the int leaf stays exact
        np.testing.assert_array_equal(res[r][f"{spec}.avg.4"],
                                      res[r]["flat.avg.4"])


def test_tier_sizes_and_wire_bytes(four_proc):
    _, res = four_proc
    for spec in _SPECS + ("dcn:ring:int8:512",):
        assert res[0][f"{spec}.tiers"].tolist() == [2, 2]
    # ring fast tier at f32: RS + AG of 1000 f32 over 2 ranks (2 x 2000
    # bytes), the 500-element shard on the slow tier: tree = one AR,
    # 2 x 1000 bytes.
    assert int(res[0]["auto.bytes"]) == 4000 + 2000
