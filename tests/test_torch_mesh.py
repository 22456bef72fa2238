"""The port's meshes of logical devices and sharding rules against the
JAX package's.

* ``make_test_mesh`` lays out the reference's shapes, axis names and ids
  (the JAX side in one subprocess with 8 forced host devices, as
  ``tests/test_router.py`` does).
* ``split_mesh`` and ``recarve_mesh`` give the reference's groups, id for
  id and in its shapes, on meshes of 4 and 8 devices and the multi-pod
  mesh of 8, for every group count from 0 to n + 1 (the counts the
  reference refuses raise ``ValueError`` in both).
* A mesh refuses repeated ids, ids without a device and devices this
  process cannot reach; ``grid_ids`` places blocks as ``PartitionSpec``
  does; the rules resolve as the reference's.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.sharding import spec as ref_spec
from repro_torch.launch import mesh as pm
from repro_torch.sharding import spec

CPU = torch.device("cpu")

_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys
sys.path.insert(0, sys.argv[1])
import json
import numpy as np
from repro.launch.mesh import make_test_mesh, recarve_mesh, split_mesh


def ids_of(m):
    return np.vectorize(lambda d: d.id)(np.asarray(m.devices)).tolist()


out = {}
for key, n, mp in (("4", 4, False), ("8", 8, False), ("8pod", 8, True)):
    mesh = make_test_mesh(n, multi_pod=mp)
    entry = {"ids": ids_of(mesh), "names": list(mesh.axis_names)}
    for name, fn in (("split", split_mesh), ("recarve", recarve_mesh)):
        entry[name] = {}
        for g in range(0, n + 2):
            try:
                entry[name][str(g)] = [[ids_of(s), list(s.axis_names)]
                                       for s in fn(mesh, g)]
            except ValueError as e:
                entry[name][str(g)] = "ValueError: " + str(e)
    out[key] = entry
print(json.dumps(out))
"""

MESHES = {"4": (4, False), "8": (8, False), "8pod": (8, True)}
CASES = [(key, op, g) for key, (n, _) in MESHES.items()
         for op in ("split", "recarve") for g in range(0, n + 2)]


@pytest.fixture(scope="module")
def ref_meshes():
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, os.path.abspath(src)],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("key", sorted(MESHES))
def test_make_test_mesh_matches_reference(ref_meshes, key):
    n, multi_pod = MESHES[key]
    mesh = pm.make_test_mesh(n, multi_pod=multi_pod, device="cpu")
    np.testing.assert_array_equal(mesh.ids, np.asarray(ref_meshes[key]["ids"]))
    assert list(mesh.axis_names) == ref_meshes[key]["names"]
    assert mesh.size == n and mesh.devices_of() == [CPU] * n
    assert mesh.shape == dict(zip(mesh.axis_names, mesh.ids.shape))


@pytest.mark.parametrize("key,op,groups", CASES)
def test_groups_match_reference(ref_meshes, key, op, groups):
    """The port's carve of a mesh holding the reference's ids gives the
    reference's groups, shapes and axis names — or its refusal."""
    ref = ref_meshes[key]
    mesh = pm.Mesh(np.asarray(ref["ids"]), ref["names"],
                   {i: "cpu" for i in np.ravel(ref["ids"])})
    want = ref[op][str(groups)]
    fn = pm.split_mesh if op == "split" else pm.recarve_mesh
    if isinstance(want, str):
        with pytest.raises(ValueError) as err:
            fn(mesh, groups)
        assert "ValueError: " + str(err.value) == want
        return
    got = fn(mesh, groups)
    assert [[s.ids.tolist(), list(s.axis_names)] for s in got] == want
    # disjoint, and together they cover the parent, by id
    flat = np.concatenate([s.ids.ravel() for s in got])
    assert sorted(flat.tolist()) == sorted(mesh.ids.ravel().tolist())
    assert all(s.devices_of() == [CPU] * s.size for s in got)


def test_test_mesh_shapes_and_refusals():
    assert pm.make_test_mesh(1, device="cpu").shape == {"data": 1,
                                                        "model": 1}
    assert pm.make_test_mesh(2, device="cpu").shape == {"data": 2,
                                                        "model": 1}
    with pytest.raises(ValueError, match="not \\(2, n/2\\)"):
        pm.make_test_mesh(3, device="cpu")
    with pytest.raises(ValueError, match="multi-pod"):
        pm.make_test_mesh(4, multi_pod=True, device="cpu")
    prod = pm.make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16}
    assert prod.devices_of() == [torch.device("meta")] * 256


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["single", "multi"])
def test_production_mesh_is_the_reference_layout(multi_pod):
    """The reference's production meshes (``repro.launch.mesh``: 16 x 16
    ``("data", "model")``, 2 x 16 x 16 ``("pod", "data", "model")``) as
    logical ids row-major, on ``meta`` (shapes only); the rules resolve as on the reference's mesh of that name."""
    mesh = pm.make_production_mesh(multi_pod=multi_pod)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    assert mesh.ids.shape == shape
    assert mesh.axis_names == (("pod", "data", "model") if multi_pod
                               else ("data", "model"))
    np.testing.assert_array_equal(mesh.ids.ravel(), np.arange(mesh.size))
    assert spec.rules_for_mesh(mesh) == (spec.MULTI_POD_RULES if multi_pod
                                         else spec.SINGLE_POD_RULES)
    assert mesh.devices_of() == [torch.device("meta")] * mesh.size


def test_test_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pm.make_test_mesh(4)


def test_mesh_refuses_bad_ids_and_unreachable_devices(monkeypatch):
    with pytest.raises(ValueError, match="repeat"):
        pm.Mesh([[0, 0]], ("data", "model"), ["cpu"])
    with pytest.raises(ValueError, match="no device"):
        pm.Mesh([[0, 1]], ("data", "model"), ["cpu"])
    with pytest.raises(ValueError, match="axis names"):
        pm.Mesh([0, 1], ("data", "model"), ["cpu", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="sees 1 CUDA card"):
        pm.Mesh([[0, 1]], ("data", "model"), ["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="CPU, a CUDA card or meta"):
        pm.Mesh([[0]], ("data", "model"), ["mps"])
    # meta holds a mesh that only places shapes (make_production_mesh)
    assert pm.Mesh([[0]], ("data", "model"), ["meta"]).first_device == \
        torch.device("meta")
    mesh = pm.Mesh([[0, 1]], ("data", "model"), ["cuda", "cuda:0"])
    assert mesh.devices_of() == [torch.device("cuda", 0)] * 2


def test_grid_ids_place_blocks_as_partition_spec():
    mesh = pm.Mesh(np.arange(8).reshape(2, 2, 2), ("pod", "data", "model"),
                   ["cpu"] * 8)
    # P(("data", "model")): the block index row-major over the axes, the
    # first position along the pod axis
    np.testing.assert_array_equal(mesh.grid_ids(("data", "model")),
                                  [0, 1, 2, 3])
    np.testing.assert_array_equal(mesh.grid_ids(("model", "data")),
                                  [0, 2, 1, 3])
    # P("pod", "model"): rows over pods, columns over the model axis
    np.testing.assert_array_equal(mesh.grid_ids(("pod",), ("model",)),
                                  [[0, 1], [4, 5]])
    np.testing.assert_array_equal(mesh.grid_ids((), ("pod", "data",
                                                     "model")),
                                  [np.arange(8)])
    with pytest.raises(ValueError, match="two dimensions"):
        mesh.grid_ids(("data",), ("data", "model"))
    with pytest.raises(ValueError, match="no mesh axis"):
        mesh.grid_ids(("rows",))
    assert mesh.first_device == CPU


def test_rules_resolve_as_the_reference():
    for name in ("SINGLE_POD_RULES", "MULTI_POD_RULES"):
        ref, port = getattr(ref_spec, name), getattr(spec, name)
        for f in ("batch", "fsdp", "tensor", "expert", "corpus"):
            assert getattr(port, f) == getattr(ref, f), (name, f)
        assert port.spec("batch", None, "corpus") == tuple(
            ref.spec("batch", None, "corpus"))
    pod = pm.make_test_mesh(8, multi_pod=True, device="cpu")
    flat = pm.make_test_mesh(4, device="cpu")
    assert spec.rules_for_mesh(pod) == spec.MULTI_POD_RULES
    assert spec.rules_for_mesh(flat) == spec.SINGLE_POD_RULES
    assert spec.ShardCtx().mesh is None
    assert spec.axes_tuple(None) == () and spec.axes_tuple("data") == (
        "data",)
