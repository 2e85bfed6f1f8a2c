"""PyTorch port, the pod mesh and the mesh knobs
(horovod_tpu_torch/parallel/mesh.py ``pod_mesh_spec`` / ``pod_axis_tiers``,
``HVDT_PP`` / ``HVDT_EP`` / ``HVDT_MESH_AXES``) held against the JAX
package.

The pod helpers are plain arithmetic on axis sizes: the port's spec,
its tiers and its errors must equal the reference's on a grid of
``(num_pods, pod_size, pp, ep)`` and under the env defaults.
``HVDT_MESH_AXES`` at ``init()``: a 4-rank gloo world started by the
port's ``hvdtrun --mesh-axes dp=2,tp=2`` adopts a ``DeviceMesh`` laid
out as the reference's default mesh over four devices, and its ``tp``
group reduces over the right ranks; a product that is not the world size
raises the reference's error.
"""

import itertools
import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

from horovod_tpu.common import basics as jbasics
from horovod_tpu.parallel import mesh as jmesh
import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_POD_ENV = ("HVDT_NUM_PODS", "HVDT_POD_SIZE", "HVDT_SIZE", "HVDT_PP",
            "HVDT_EP")


def _call(mod, *args, **kw):
    try:
        spec = mod.pod_mesh_spec(*args, **kw)
    except ValueError as e:
        return "error", str(e)
    return spec.axes, mod.pod_axis_tiers(spec)


@pytest.mark.parametrize(
    "num_pods,pod_size,pp,ep",
    list(itertools.product((1, 2, 4), (1, 2, 4), (1, 2, 4), (1, 2)))
    + [(0, 2, 1, 1), (2, 0, 1, 1), (2, 2, 0, 1), (2, 2, 1, 0),
       (3, 4, 2, 1), (4, 6, 2, 4)])
def test_pod_mesh_spec_matches_reference(num_pods, pod_size, pp, ep,
                                         monkeypatch):
    for k in _POD_ENV:
        monkeypatch.delenv(k, raising=False)
    got = _call(tmesh, num_pods, pod_size, pp=pp, ep=ep)
    assert got == _call(jmesh, num_pods, pod_size, pp=pp, ep=ep)
    if got[0] != "error":
        assert tmesh.MeshSpec(got[0]).total == num_pods * pod_size


@pytest.mark.parametrize("env", [
    {},
    {"HVDT_SIZE": "8"},
    {"HVDT_SIZE": "8", "HVDT_NUM_PODS": "2"},
    {"HVDT_NUM_PODS": "4", "HVDT_POD_SIZE": "2", "HVDT_PP": "2"},
    {"HVDT_NUM_PODS": "2", "HVDT_POD_SIZE": "4", "HVDT_EP": "2"},
    {"HVDT_NUM_PODS": "2", "HVDT_POD_SIZE": "4", "HVDT_PP": "2",
     "HVDT_EP": "4"},
    {"HVDT_NUM_PODS": "3", "HVDT_POD_SIZE": "4", "HVDT_PP": "2"},
])
def test_pod_mesh_spec_env_defaults(env, monkeypatch):
    for k in _POD_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert _call(tmesh) == _call(jmesh)


def test_pod_axis_tiers_off_contract():
    """A spec without an ``ici`` axis: everything but the innermost axis
    is ``dcn``, as in the reference."""
    for axes in ((("dp", 2), ("tp", 2)), (("pp", 4),),
                 (("dcn", 2), ("ep", 2))):
        assert (tmesh.pod_axis_tiers(tmesh.MeshSpec(axes))
                == jmesh.pod_axis_tiers(jmesh.MeshSpec(axes)))


def test_mesh_axes_product_error(monkeypatch):
    """The world of one with a 4-member ``HVDT_MESH_AXES``: init raises
    the reference's error and leaves nothing initialised."""
    monkeypatch.setenv("HVDT_MESH_AXES", "dp=2,tp=2")
    with pytest.raises(ValueError) as got:
        hvd.init(device="cpu")
    with pytest.raises(ValueError) as want:
        jbasics._build_default_mesh(jax.devices()[:1])
    assert str(got.value) == str(want.value)
    assert not hvd.is_initialized()
    monkeypatch.delenv("HVDT_MESH_AXES")
    hvd.init(device="cpu")
    try:
        assert hvd.common.basics.current_mesh() is None
    finally:
        hvd.shutdown()


_WORKER = textwrap.dedent('''
    import json
    import os
    import sys

    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common.basics import current_mesh

    assert "--device" in sys.argv
    hvd.init(device="cpu")
    mesh = current_mesh()
    x = torch.tensor([float(2 ** hvd.rank())])
    dist.all_reduce(x, group=mesh.get_group("tp"))
    out = {"names": list(mesh.mesh_dim_names),
           "layout": mesh.mesh.tolist(), "tp_sum": x.item(),
           "env": os.environ.get("HVDT_MESH_AXES")}
    with open(os.path.join(os.environ["OUT_DIR"],
                           f"{hvd.rank()}.json"), "w") as f:
        json.dump(out, f)
    hvd.shutdown()
''')


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_mesh_axes_through_hvdtrun(tmp_path, monkeypatch):
    (tmp_path / "w.py").write_text(_WORKER)
    env = dict(os.environ, OUT_DIR=str(tmp_path),
               PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for k in ("HVDT_MESH_AXES", "HVDT_SIZE", "HVDT_RANK",
              "HVDT_COORDINATOR_ADDR"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
           "--coordinator-port", str(_free_port()), "-np", "4",
           "--mesh-axes", "dp=2,tp=2", "--", sys.executable,
           str(tmp_path / "w.py"), "--device", "cpu"]
    p = subprocess.run(cmd, env=env, cwd=str(tmp_path),
                       capture_output=True, timeout=120)
    assert p.returncode == 0, (p.stdout + p.stderr).decode()[-3000:]
    monkeypatch.setenv("HVDT_MESH_AXES", "dp=2,tp=2")
    ref = jbasics._build_default_mesh(jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(ref.devices).tolist()
    for r in range(4):
        got = json.loads((tmp_path / f"{r}.json").read_text())
        assert got["env"] == "dp=2,tp=2"
        assert got["names"] == list(ref.axis_names) == ["dp", "tp"]
        assert got["layout"] == ids == [[0, 1], [2, 3]]
        assert got["tp_sum"] == sum(2 ** m for m in ids[r // 2])
