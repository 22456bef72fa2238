"""The port's Arch API (``repro_torch.models.api``) against the JAX
package's (``repro.models.api``), on the CPU, for every (arch x shape)
cell of ``ARCH_IDS`` at the reduced configs, with no mesh.

* Structure: the step's name, every argument's shape and dtype (meta
  tensors against ``jax.ShapeDtypeStruct``, in JAX's flattening order)
  and ``REDUCED_DIMS``; at the full configs every argument is a meta
  tensor (nothing allocated), ``ogb_products`` included.
* ``realize``: the non-parameter arguments equal the reference's bit for
  bit (the same ``np.random.default_rng`` draws in the same order).
* The recsys and GNN steps (f32) on the reference's realized arguments,
  carried across, against ``jax.jit(cell.fn)``: a train step's loss and
  metrics within 1e-5 relative, its updated params within rtol 1e-5 per
  element (atol 1e-9: a zero-initialised bias moves by the lr alone),
  AdamW's moments within 1e-4 relative L2 a leaf (they are the gradients,
  summed in another order: ``tests/test_torch_train.py``'s gradient
  tolerance); ``serve_step`` outputs within rtol 1e-5 / atol 1e-6 (bf16
  scores: within 2^-8 relative, and the ids equal); ``retrieval``'s ids
  equal, its f32 values within rtol 1e-5.  The LM cells are in
  ``tests/test_torch_api_lm.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import shapes_for
from repro.configs.registry import ARCH_IDS, get_config
from repro.models import api as RA
from repro_torch import tree
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import api as A

CASES = [(a, s.shape_id) for a in ARCH_IDS
         for s in shapes_for(get_config(a, reduced=True))]
LM_ARCHS = [a for a in ARCH_IDS
            if type(get_config(a)).__name__ == "LMConfig"]
STEP_CASES = [c for c in CASES if c[0] not in LM_ARCHS]
F32_REL = 1e-5
MOMENT_REL = 1e-4
BF16_REL = 2.0 ** -8


def _np(x):
    """An array of either package as numpy (bf16 read as f32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = jnp.asarray(x)
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def to_port(t):
    """The reference's realized arguments as the port's tensors (bf16 kept
    as bf16), the same structure."""
    def one(x):
        x = jnp.asarray(x)
        if x.dtype == jnp.bfloat16:
            return torch.from_numpy(
                np.array(x.astype(jnp.float32))).to(torch.bfloat16)
        return torch.from_numpy(np.array(x))
    return jax.tree.map(one, t)


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _rel(got, want) -> float:
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


@pytest.mark.parametrize("arch,shape", CASES,
                         ids=[f"{a}-{s}" for a, s in CASES])
def test_cell_structure_and_realize_match_reference(arch, shape):
    rc = RA.build_cell(arch, shape, reduced=True)
    pc = A.build_cell(arch, shape, reduced=True)
    assert (pc.arch, pc.shape_id, pc.step) == (rc.arch, rc.shape_id,
                                               rc.step)
    assert pc.in_shardings is None and pc.donate_argnums == \
        rc.donate_argnums
    rl = jax.tree_util.tree_flatten_with_path(rc.args)[0]
    pl = tree.keyed_leaves(pc.args)
    assert [jax.tree_util.keystr(p) for p, _ in rl] == [k for k, _ in pl]
    for (path, r), (key, p) in zip(rl, pl):
        assert p.device.type == "meta", key
        assert tuple(p.shape) == tuple(r.shape), key
        assert _dtype_name(p) == str(r.dtype), key
    assert (pc.loss_fn is not None) == (pc.step == "train_step")
    want = RA.realize(rc, seed=3)
    got = A.realize(pc, seed=3, device="cpu")
    assert len(got) == len(want)
    rw = jax.tree_util.tree_flatten_with_path(want[1:])[0]
    pg = tree.keyed_leaves(got[1:])
    assert [jax.tree_util.keystr(p) for p, _ in rw] == [k for k, _ in pg]
    for (_, w), (key, g) in zip(rw, pg):
        assert g.dtype == getattr(torch, str(w.dtype)), key
        np.testing.assert_array_equal(_np(g), _np(w), err_msg=key)
    # the params: the port's own init, of the reference's shapes
    ps = (got[0]["params"] if pc.step == "train_step" else got[0])
    rs = (want[0]["params"] if rc.step == "train_step" else want[0])
    assert [tuple(x.shape) for x in tree.leaves(ps)] == \
        [tuple(x.shape) for x in jax.tree_util.tree_leaves(rs)]


def test_reduced_dims_match_reference():
    assert A.REDUCED_DIMS == RA.REDUCED_DIMS


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_cells_allocate_nothing(arch):
    """Every cell of the full published config builds with meta tensors
    alone, as the reference's builds ``ShapeDtypeStruct``s."""
    for s in shapes_for(get_config(arch)):
        rc = RA.build_cell(arch, s.shape_id)
        pc = A.build_cell(arch, s.shape_id)
        rl = jax.tree_util.tree_leaves(rc.args)
        pl = tree.leaves(pc.args)
        assert len(pl) == len(rl) and pl
        for p, r in zip(pl, rl):
            assert p.device.type == "meta"
            assert tuple(p.shape) == tuple(r.shape)
            assert _dtype_name(p) == str(r.dtype)


def test_serve_params_are_bf16_and_realize_f32():
    """An LM's serve_step takes bf16 params in its abstract args (the
    reference's REPRO_OPT_SERVE_PARAMS default), and ``realize`` gives it
    the init's f32 params, as the reference's does."""
    cell = A.build_cell("qwen3-0.6b", "decode_32k", reduced=True)
    assert {x.dtype for x in tree.leaves(cell.args[0])} == {torch.bfloat16}
    args = A.realize(cell, device="cpu")
    assert {x.dtype for x in tree.leaves(args[0])} == {torch.float32}


MESH_CELLS = [("qwen3-0.6b", "prefill_32k"), ("qwen3-0.6b", "train_4k"),
              ("bert4rec", "retrieval_cand"), ("dlrm-rm2", "retrieval_cand"),
              ("bert4rec", "serve_p99"), ("mind", "serve_p99"),
              ("wide-deep", "train_batch"),
              ("graphsage-reddit", "minibatch_lg"),
              ("graphsage-reddit", "molecule")]


@pytest.mark.parametrize("arch,shape", MESH_CELLS,
                         ids=[f"{a}-{s}" for a, s in MESH_CELLS])
def test_mesh_cell_runs_as_one_device(arch, shape):
    """A reduced cell built on a (2, 2) mesh of logical CPU devices has
    shardings and runs on the one-device cell's arguments to its outputs
    bit for bit: its sharding constraints change no value, and its
    retrieval and scoring take the two-level top-k over the item shards,
    which gives the one-device ids and values.  (The MoE LMs and the
    destination-partitioned SAGE are other functions on a mesh: held
    against the reference's sharded ones in
    ``tests/test_torch_mesh_models.py``.)"""
    mesh = make_test_mesh(4, device=torch.device("cpu"))
    on = A.build_cell(arch, shape, mesh=mesh, reduced=True)
    one = A.build_cell(arch, shape, reduced=True)
    assert one.in_shardings is None
    assert len(tree.leaves(on.in_shardings)) == len(tree.leaves(on.args))
    args = A.realize(one, seed=0, device="cpu")
    got, want = on.fn(*args), one.fn(*args)
    for g, w in zip(tree.leaves(got), tree.leaves(want), strict=True):
        assert torch.equal(g, w)


def check_train_step(got, want):
    """``(state, metrics)`` of the port's train step against the
    reference's, at this file's tolerances."""
    (gs, gm), (ws, wm) = got, want
    assert gm.keys() == wm.keys()
    for k in wm:
        np.testing.assert_allclose(_np(gm[k]), _np(wm[k]), rtol=F32_REL,
                                   atol=0, err_msg=k)
    wl = dict((jax.tree_util.keystr(p), x) for p, x in
              jax.tree_util.tree_flatten_with_path(ws)[0])
    gl = dict(tree.keyed_leaves(gs))
    assert gl.keys() == wl.keys()
    for key, w in wl.items():
        if key.startswith("['params']"):
            np.testing.assert_allclose(_np(gl[key]), _np(w), rtol=F32_REL,
                                       atol=1e-9, err_msg=key)
        elif key == "['opt']['step']":
            assert int(gl[key]) == int(w)
        else:
            assert _rel(gl[key], w) <= MOMENT_REL, key


@pytest.mark.parametrize("arch,shape", STEP_CASES,
                         ids=[f"{a}-{s}" for a, s in STEP_CASES])
def test_step_matches_reference(arch, shape):
    rc = RA.build_cell(arch, shape, reduced=True)
    pc = A.build_cell(arch, shape, reduced=True)
    args = RA.realize(rc)
    want = jax.jit(rc.fn)(*args)
    got = pc.fn(*to_port(args))
    if pc.step == "train_step":
        check_train_step(got, want)
        return
    if pc.step == "retrieval" or (pc.step == "serve_step"
                                  and isinstance(got, tuple)):
        vals, ids = got
        np.testing.assert_array_equal(_np(ids), _np(want[1]))
        if vals.dtype == torch.bfloat16:
            np.testing.assert_allclose(_np(vals), _np(want[0]),
                                       rtol=BF16_REL, atol=0)
        else:
            np.testing.assert_allclose(_np(vals), _np(want[0]),
                                       rtol=F32_REL, atol=0)
        return
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_REL,
                               atol=1e-6)


def test_train_step_state_is_freed_on_release():
    """A train step's new state is freed as soon as the caller drops it,
    with the garbage collector off: no reference cycle keeps a step's
    new params and moments alive (at DLRM-RM2's width one state is 21
    GB, and two alive at once pass the card's memory)."""
    import gc
    import weakref
    cell = A.build_cell("dlrm-rm2", "train_batch", reduced=True)
    state, batch = A.realize(cell, device="cpu")
    gc.collect()
    gc.disable()
    try:
        new, _ = cell.fn(state, batch)
        refs = [weakref.ref(x) for x in tree.leaves(new)]
        del new
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
