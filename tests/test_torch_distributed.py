"""The port's sharded scan (``core.distributed``) and two-level top-k
(``core.topk``) against the JAX package's, on meshes of logical CPU
devices: (2, 1), (1, 4) and (2, 2).

Each function is held against the JAX one-device function (in this
process) and against the JAX sharded function run with 4 forced host
devices in one subprocess (as ``tests/test_distributed.py`` does): ids
exactly, distances to rtol 1e-6 (M f32 terms summed in another order).
The inputs plant equal distances on both sides of every shard boundary
(identical code rows, equal scores), so the merge must give ties to the
lowest global id as ``lax.top_k`` does; ``top_n`` above a shard's rows
takes the reference's widths.  The executor's placement — ragged shards,
a shard no candidate falls in — has no JAX counterpart and is held
against the one-device functions: the fused scan's whole output, the
dense bucket's finite (dist, position) pairs.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as rd
from repro.core import topk as rtopk
from repro.models.layers import ShardCtx as RefCtx
from repro_torch.core import distributed as pd
from repro_torch.core import topk as ptopk
from repro_torch.launch.mesh import Mesh
from repro_torch.sharding.spec import ShardCtx, rules_for_mesh

N, M, K, DSUB, B, S = 64, 8, 256, 2, 3, 40
TIES = (15, 16, 31, 32, 47, 48)      # identical code rows at the boundaries
MESHES = {"2": (2, 1), "4": (1, 4), "2x2": (2, 2)}
TOPS = (4, 24)                       # 24 passes a (1, 4) shard's 16 rows


def _inputs():
    rng = np.random.default_rng(7)
    codes = rng.integers(1, K, (N, M)).astype(np.uint8)
    codes[list(TIES)] = 0
    lut = rng.uniform(0.1, 1.0, (M, K)).astype(np.float32)
    lut[:, 0] = 0.0                  # the tied rows score 0: the top six
    luts = rng.uniform(0.1, 1.0, (B, M, K)).astype(np.float32)
    luts[:, :, 0] = 0.0
    mask = rng.random((B, N)) < 0.6
    mask[:, list(TIES)] = True
    rows = np.full((B, S), -1, np.int32)
    for b, c in enumerate((S, 25, 9)):
        pick = rng.choice(np.setdiff1d(np.arange(N), TIES), c - 4,
                          replace=False)
        rows[b, :c] = np.sort(np.concatenate([pick, TIES[:4]]))
    queries = rng.standard_normal((B, M * DSUB)).astype(np.float32)
    codebooks = rng.standard_normal((M, K, DSUB)).astype(np.float32)
    scores = rng.standard_normal((4, 256)).astype(np.float32)
    for c in (63, 64, 127, 128, 191, 192):
        scores[:, c] = 9.0
        scores[1, c] = -9.0
    return dict(codes=codes, lut=lut, luts=luts, mask=mask, rows=rows,
                queries=queries, codebooks=codebooks, scores=scores)


_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.core import distributed as rd
from repro.core.topk import sharded_topk
from repro.models.layers import ShardCtx
from repro.sharding.spec import rules_for_mesh

x = dict(np.load(sys.argv[2]))
out = {}
for name, shape in (("2", (2, 1)), ("4", (1, 4)), ("2x2", (2, 2))):
    mesh = jax.make_mesh(shape, ("data", "model"))
    ctx = ShardCtx(mesh=mesh, rules=rules_for_mesh(mesh))
    corpus = ctx.rules.corpus

    def put(a, *spec):
        return jax.device_put(jnp.asarray(a), NamedSharding(mesh, P(*spec)))

    codes = put(x["codes"], corpus, None)
    mask = put(x["mask"], None, corpus)
    with mesh:
        for top in (4, 24):
            r = jax.jit(lambda c, l: rd.sharded_adc_topn(c, l, top, ctx))(
                codes, jnp.asarray(x["lut"]))
            out[f"topn/{name}/{top}"] = r
            for blocked in (True, False):
                r = jax.jit(lambda c, l: rd.sharded_adc_topn_batch(
                    c, l, top, ctx, blocked=blocked))(
                        codes, jnp.asarray(x["luts"]))
                out[f"batch/{name}/{top}/{blocked}"] = r
            r = jax.jit(lambda c, l, m: rd.sharded_adc_topn_window(
                c, l, m, top, ctx))(codes, jnp.asarray(x["luts"]), mask)
            out[f"window/{name}/{top}"] = r
        for top in (4, 40):
            for int8 in (False, True):
                r = jax.jit(lambda c, q, cb, rw: rd.sharded_adc_topn_rows(
                    c, q, cb, rw, top, ctx, lut_int8=int8))(
                        codes, jnp.asarray(x["queries"]),
                        jnp.asarray(x["codebooks"]), jnp.asarray(x["rows"]))
                out[f"rows/{name}/{top}/{int8}"] = r
        for largest in (True, False):
            s = put(x["scores"], "data", "model")
            r = jax.jit(lambda s: sharded_topk(
                s, 8, ctx, shard_axes="model", batch_axes="batch",
                largest=largest))(s)
            out[f"topk/{name}/model/{largest}"] = r
            s = put(x["scores"], None, corpus)
            r = jax.jit(lambda s: sharded_topk(
                s, 8, ctx, shard_axes=corpus, batch_axes=None,
                largest=largest))(s)
            out[f"topk/{name}/corpus/{largest}"] = r
flat = {}
for k, (v, i) in out.items():
    flat[k + "/vals"] = np.asarray(v)
    flat[k + "/ids"] = np.asarray(i)
np.savez(sys.argv[3], **flat)
print("ok")
"""


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def ref_sharded(inputs, tmp_path_factory):
    """The JAX sharded functions' outputs on 4 forced host devices."""
    tmp = tmp_path_factory.mktemp("dist")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, os.path.abspath(src),
         str(tmp / "in.npz"), str(tmp / "out.npz")],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


def _ctx(name):
    shape = MESHES[name]
    n = int(np.prod(shape))
    mesh = Mesh(np.arange(n).reshape(shape), ("data", "model"),
                ["cpu"] * n)
    return ShardCtx(mesh=mesh, rules=rules_for_mesh(mesh))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got, want_vals, want_ids, width=None):
    """ids exactly, distances to rtol 1e-6 (the first ``width``)."""
    gv, gi = (np.asarray(x) for x in got)
    wv, wi = np.asarray(want_vals), np.asarray(want_ids)
    if width is not None:
        gv, gi, wv, wi = gv[..., :width], gi[..., :width], \
            wv[..., :width], wi[..., :width]
    assert gv.shape == wv.shape, (gv.shape, wv.shape)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gv, wv, rtol=1e-6)


def _ref_one(key, inputs, top, **kw):
    """The JAX one-device function of ``key``."""
    x, ctx = inputs, RefCtx()
    codes = jnp.asarray(x["codes"])
    if key == "topn":
        return rd.sharded_adc_topn(codes, jnp.asarray(x["lut"]), top, ctx)
    if key == "batch":
        return rd.sharded_adc_topn_batch(codes, jnp.asarray(x["luts"]), top,
                                         ctx)
    if key == "window":
        return rd.sharded_adc_topn_window(codes, jnp.asarray(x["luts"]),
                                          jnp.asarray(x["mask"]), top, ctx)
    return rd.sharded_adc_topn_rows(
        codes, jnp.asarray(x["queries"]), jnp.asarray(x["codebooks"]),
        jnp.asarray(x["rows"]), top, ctx, **kw)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("top", TOPS)
def test_sharded_adc_topn(inputs, ref_sharded, mesh, top):
    got = pd.sharded_adc_topn(_t(inputs["codes"]), _t(inputs["lut"]), top,
                              _ctx(mesh))
    key = f"topn/{mesh}/{top}"
    _same(got, ref_sharded[key + "/vals"], ref_sharded[key + "/ids"])
    # the one-device answer's first min(top, rows a shard) pairs; the
    # tied rows (distance 0) lead in ascending id
    width = got[0].shape[0]
    rv, ri = _ref_one("topn", inputs, top)
    _same(got, rv, ri, width)
    np.testing.assert_array_equal(np.asarray(got[1])[:min(width, 6)],
                                  TIES[:min(width, 6)])


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("top", TOPS)
@pytest.mark.parametrize("blocked", [True, False], ids=["blocked", "map"])
def test_sharded_adc_topn_batch(inputs, ref_sharded, mesh, top, blocked):
    got = pd.sharded_adc_topn_batch(_t(inputs["codes"]), _t(inputs["luts"]),
                                    top, _ctx(mesh), blocked=blocked)
    key = f"batch/{mesh}/{top}/{blocked}"
    _same(got, ref_sharded[key + "/vals"], ref_sharded[key + "/ids"])
    rv, ri = _ref_one("batch", inputs, top)
    _same(got, rv, ri, got[0].shape[1])


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("top", TOPS)
def test_sharded_adc_topn_window(inputs, ref_sharded, mesh, top):
    got = pd.sharded_adc_topn_window(_t(inputs["codes"]), _t(inputs["luts"]),
                                     _t(inputs["mask"]), top, _ctx(mesh))
    key = f"window/{mesh}/{top}"
    _same(got, ref_sharded[key + "/vals"], ref_sharded[key + "/ids"])
    _same(got, *_ref_one("window", inputs, top))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("top", [4, S])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_sharded_adc_topn_rows(inputs, ref_sharded, mesh, top, int8):
    got = pd.sharded_adc_topn_rows(
        _t(inputs["codes"]), _t(inputs["queries"]), _t(inputs["codebooks"]),
        _t(inputs["rows"]), top, _ctx(mesh), lut_int8=int8)
    key = f"rows/{mesh}/{top}/{int8}"
    _same(got, ref_sharded[key + "/vals"], ref_sharded[key + "/ids"])
    _same(got, *_ref_one("rows", inputs, top, lut_int8=int8))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("axes", ["model", "corpus"])
@pytest.mark.parametrize("largest", [True, False], ids=["max", "min"])
def test_sharded_topk(inputs, ref_sharded, mesh, axes, largest):
    ctx = _ctx(mesh)
    scores = _t(inputs["scores"])
    if axes == "model":
        got = ptopk.sharded_topk(scores, 8, ctx, shard_axes="model",
                                 batch_axes="batch", largest=largest)
    else:
        got = ptopk.sharded_topk(scores, 8, ctx, shard_axes=ctx.rules.corpus,
                                 batch_axes=None, largest=largest)
    key = f"topk/{mesh}/{axes}/{largest}"
    _same(got, ref_sharded[key + "/vals"], ref_sharded[key + "/ids"])
    rv, ri = rtopk.sharded_topk(jnp.asarray(inputs["scores"]), 8, RefCtx(),
                                shard_axes="model", largest=largest)
    _same(got, rv, ri)
    # the planted ties straddle every boundary and go to the lowest ids
    row = 1 if not largest else 0
    np.testing.assert_array_equal(np.asarray(got[1])[row, :6],
                                  [63, 64, 127, 128, 191, 192])


@pytest.mark.parametrize("top", [1, 4, S])
def test_one_device_paths_match_reference(inputs, top):
    """``ctx.mesh is None``: the kernels' plain versions over the whole
    codes answer as the JAX one-device functions."""
    x = inputs
    _same(pd.sharded_adc_topn(_t(x["codes"]), _t(x["lut"]), top),
          *_ref_one("topn", x, top))
    _same(pd.sharded_adc_topn_batch(_t(x["codes"]), _t(x["luts"]), top),
          *_ref_one("batch", x, top))
    _same(pd.sharded_adc_topn_window(_t(x["codes"]), _t(x["luts"]),
                                     _t(x["mask"]), top),
          *_ref_one("window", x, top))
    _same(pd.sharded_adc_topn_rows(_t(x["codes"]), _t(x["queries"]),
                                   _t(x["codebooks"]), _t(x["rows"]), top),
          *_ref_one("rows", x, top))
    _same(ptopk.sharded_topk(_t(x["scores"]), top, ShardCtx(),
                             shard_axes="model"),
          *rtopk.sharded_topk(jnp.asarray(x["scores"]), top, RefCtx(),
                              shard_axes="model"))


def _ragged(inputs, mesh):
    """The executor's placement of N - 3 rows: shards of ceil(N'/S) rows,
    the last fewer."""
    return pd.shard_codes(_t(inputs["codes"][:N - 3]), _ctx(mesh),
                          even=False)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("top", [4, S])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_rows_on_ragged_and_empty_shards(inputs, mesh, top, int8):
    """Rows lists that leave whole shards empty, over a ragged placement:
    the one-device function's whole output."""
    x = inputs
    sh = _ragged(x, mesh)
    assert len({p.shape[0] for p in sh.parts}) > 1 or len(sh.parts) < 4
    rows = x["rows"].copy()
    rows[rows >= 30] = -1            # the (1, 4) mesh's last shards: empty
    rows = np.sort(np.where(rows < 0, N, rows), axis=1)
    rows[rows == N] = -1
    got = pd.sharded_adc_topn_rows(sh, _t(x["queries"]), _t(x["codebooks"]),
                                   _t(rows), top, _ctx(mesh), lut_int8=int8)
    want = rd.sharded_adc_topn_rows(
        jnp.asarray(x["codes"][:N - 3]), jnp.asarray(x["queries"]),
        jnp.asarray(x["codebooks"]), jnp.asarray(rows), top, RefCtx(),
        lut_int8=int8)
    _same(got, *want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("top", [4, 64])
def test_bucket_gathers_each_shards_run(inputs, mesh, top):
    """The executor's dense window: each shard scans its run of the
    bucket from its own codes; the finite pairs are those of the
    one-device scan of the gathered bucket, at its width."""
    x = inputs
    sh = _ragged(x, mesh)
    rng = np.random.default_rng(3)
    rows = np.sort(rng.choice(np.arange(40), 29, replace=False))
    rows = np.union1d(rows, [15, 16, 31, 32])        # ties at boundaries
    bucket = 64
    mask = np.zeros((B, bucket), bool)
    mask[:, :len(rows)] = rng.random((B, len(rows))) < 0.7
    mask[:, np.searchsorted(rows, [15, 16, 31, 32])] = True
    got = pd.sharded_adc_topn_bucket(sh, rows, _t(x["luts"]), mask,
                                     min(top, bucket), _ctx(mesh))
    padded = np.zeros(bucket, np.int64)
    padded[:len(rows)] = rows
    wv, wp = rd.sharded_adc_topn_window(
        jnp.asarray(x["codes"][padded]), jnp.asarray(x["luts"]),
        jnp.asarray(mask), min(top, bucket), RefCtx())
    gv, gp = (np.asarray(a) for a in got)
    wv, wp = np.asarray(wv), np.asarray(wp)
    assert gv.shape == wv.shape
    finite = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), finite)
    np.testing.assert_array_equal(gp[finite], wp[finite])
    np.testing.assert_allclose(gv[finite], wv[finite], rtol=1e-6)


def test_replicate_copies_once_per_device():
    ctx = _ctx("2x2")
    x = torch.arange(6.0)
    reps = pd.replicate_to_mesh(x, ctx)
    assert len(reps) == 4 and all(r is x for r in reps)
    assert pd.replicate_to_mesh(reps, ctx) is reps
    assert pd.replicate_to_mesh(x, ShardCtx()) is x


def test_uneven_and_foreign_inputs_raise(inputs):
    x = inputs
    with pytest.raises(ValueError, match="do not split over 4 shards"):
        pd.sharded_adc_topn(_t(x["codes"][:N - 2]), _t(x["lut"]), 4,
                            _ctx("4"))
    with pytest.raises(ValueError, match="whole blocks"):
        pd.sharded_adc_topn_batch(torch.zeros((2 * 65537, M), dtype=torch.uint8),
                                  _t(x["luts"]), 4, _ctx("2"))
    with pytest.raises(ValueError, match="equal code shards"):
        pd.sharded_adc_topn_window(_ragged(x, "4"), _t(x["luts"]),
                                   _t(x["mask"]), 4, _ctx("4"))
    with pytest.raises(ValueError, match="2 code shards for a mesh of 4"):
        pd.sharded_adc_topn_rows(_ragged(x, "2"), _t(x["queries"]),
                                 _t(x["codebooks"]), _t(x["rows"]), 4,
                                 _ctx("4"))
    with pytest.raises(ValueError, match="do not split into"):
        ptopk.sharded_topk(_t(x["scores"][:3]), 4, _ctx("2x2"),
                           shard_axes="model")
    with pytest.raises(ValueError, match="exceeds"):
        ptopk.sharded_topk(_t(x["scores"]), 257, _ctx("2"),
                           shard_axes="model")


def test_shard_row_lists_lead_with_valid_rows():
    rows = np.array([[0, 3, 5, 9, -1, -1], [4, 8, 10, -1, -1, -1]], np.int32)
    lists = pd.shard_row_lists(rows, (0, 4, 8, 12))
    assert [lst.shape for lst in lists] == [(2, 64)] * 3
    np.testing.assert_array_equal(lists[0][:, :3], [[0, 3, -1], [-1, -1, -1]])
    np.testing.assert_array_equal(lists[1][:, :3], [[1, -1, -1], [0, -1, -1]])
    np.testing.assert_array_equal(lists[2][:, :3], [[1, -1, -1], [0, 2, -1]])
    wide = np.arange(100, dtype=np.int32)[None]
    assert pd.shard_row_lists(wide, (0, 100))[0].shape == (1, 128)
