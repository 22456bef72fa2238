"""The port's GraphSAGE and graph data (``repro_torch.models.gnn``,
``repro_torch.data.{graphs,partition}``) against the JAX package's, on
the CPU, on the same numpy-seeded inputs and the reference's own params
carried across by ``transformer.params_from_numpy``.

Tolerances: graph data bit for bit (the same numpy draws); f32 functions
rtol 1e-5 / atol 1e-6 (the same operations summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_config
from repro.data import graphs as RGr
from repro.data import partition as RPa
from repro.models import gnn as RG
from repro_torch.configs.registry import get_config
from repro_torch.data import graphs as Gr
from repro_torch.data import partition as Pa
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import gnn as G
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.sharding.spec import SINGLE_POD_RULES, ShardCtx

RTOL, ATOL = 1e-5, 1e-6
ARCH = "graphsage-reddit"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want):
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


def _equal_trees(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _equal_trees(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal_trees(g, w)
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _params(d_feat=None, n_classes=None):
    rcfg, cfg = ref_config(ARCH, reduced=True), get_config(ARCH,
                                                           reduced=True)
    rp = RG.init_sage(jax.random.key(0), rcfg, d_feat, n_classes)
    return rp, T.params_from_numpy(jax.tree.map(np.asarray, rp), "cpu"), \
        rcfg, cfg


def _graph(seed=0, n=60, e=400, d=16, c=4):
    return Gr.random_graph(np.random.default_rng(seed), n, e, d, c)


# ------------------------------------------------------------ graph data
@pytest.mark.parametrize("n,e", [(60, 400), (1000, 20_000), (5, 0)])
def test_random_graph_and_csr_bit_equal(n, e):
    got = Gr.random_graph(np.random.default_rng(1), n, e, 7, 3)
    want = RGr.random_graph(np.random.default_rng(1), n, e, 7, 3)
    _equal_trees(got, want)
    _equal_trees(Gr.build_csr(got["edges"], n),
                 RGr.build_csr(want["edges"], n))


@pytest.mark.parametrize("fanout", [1, 5, 15])
def test_neighbor_sample_bit_equal(fanout):
    g = _graph(2, n=200, e=900)
    indptr, idx = Gr.build_csr(g["edges"], 200)
    nodes = np.random.default_rng(3).integers(0, 200, 64)
    got = Gr.neighbor_sample(np.random.default_rng(4), indptr, idx, nodes,
                             fanout)
    want = RGr.neighbor_sample(np.random.default_rng(4), indptr, idx, nodes,
                               fanout)
    _equal_trees(got, want)
    # isolated nodes (no in-edges) sample themselves on both sides
    lone = np.nonzero(np.diff(indptr) == 0)[0]
    if len(lone):
        got = Gr.neighbor_sample(np.random.default_rng(5), indptr, idx,
                                 lone, fanout)
        assert np.all(got == lone[:, None])


def test_sample_two_hop_bit_equal():
    g = _graph(6, n=300, e=2000)
    indptr, idx = Gr.build_csr(g["edges"], 300)
    batch = np.arange(0, 300, 7)
    got = Gr.sample_two_hop(np.random.default_rng(7), indptr, idx, batch,
                            (5, 3), g["features"])
    want = RGr.sample_two_hop(np.random.default_rng(7), indptr, idx, batch,
                              (5, 3), g["features"])
    _equal_trees(got, want)


def test_block_diagonal_batch_bit_equal():
    _equal_trees(Gr.block_diagonal_batch(np.random.default_rng(8), 12, 30,
                                         64, 16, 2),
                 RGr.block_diagonal_batch(np.random.default_rng(8), 12, 30,
                                          64, 16, 2))


@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_partition_bit_equal(n_shards):
    g = _graph(9, n=62, e=300)
    mask = np.ones(62, bool)
    feats, labels, mask = Pa.pad_nodes(g["features"], g["labels"], mask,
                                       n_shards)
    _equal_trees((feats, labels, mask),
                 RPa.pad_nodes(g["features"], g["labels"], np.ones(62, bool),
                               n_shards))
    _equal_trees(Pa.partition_edges_by_dst(g["edges"], len(feats), n_shards),
                 RPa.partition_edges_by_dst(g["edges"], len(feats),
                                            n_shards))


# ------------------------------------------------------- message passing
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("offset", [None, 20])
def test_mean_aggregate(weighted, offset):
    """Weights (zeros among them), destinations beyond the node count and,
    with an offset, below 0: dropped as ``segment_sum`` drops them."""
    rng = np.random.default_rng(10)
    h = rng.standard_normal((70, 8)).astype(np.float32)
    edges = np.stack([rng.integers(0, 70, 500),
                      rng.integers(0, 80, 500)], 1).astype(np.int32)
    w = (rng.integers(0, 3, 500).astype(np.float32) if weighted else None)
    got = G._mean_aggregate(torch.from_numpy(h), edges, 50, L.LOCAL_CTX,
                            None if w is None else torch.from_numpy(w),
                            offset)
    want = RG._mean_aggregate(jnp.asarray(h), jnp.asarray(edges), 50, None,
                              None if w is None else jnp.asarray(w), offset)
    _close(got, want)


@pytest.mark.parametrize("mode", ["sum", "max"])
def test_segment_reduce_fixed_order(mode):
    """``jax.ops.segment_*``'s values, ids out of range dropped, and the
    same bits from a second run."""
    rng = np.random.default_rng(11)
    v = torch.from_numpy(rng.standard_normal((300, 5)).astype(np.float32))
    seg = torch.from_numpy(rng.integers(-2, 25, 300))
    a = L.segment_reduce(v, seg, 20, mode)
    want = (jax.ops.segment_sum if mode == "sum" else jax.ops.segment_max)(
        jnp.asarray(v.numpy()), jnp.asarray(seg.numpy()), num_segments=20)
    _close(a, want)
    assert torch.equal(a, L.segment_reduce(v, seg, 20, mode))


@pytest.mark.parametrize("mode", ["sum", "max"])
def test_segment_reduce_with_order_of_the_ids(mode):
    """``segment_order`` computed once serves every reduction over the
    same ids: the same bits as sorting them again, and its lengths are
    each segment's count of in-range ids."""
    rng = np.random.default_rng(12)
    seg = torch.from_numpy(rng.integers(-2, 25, 300))
    order = L.segment_order(seg, 20)
    for cols in (5, 1):
        v = torch.from_numpy(rng.standard_normal((300, cols)).astype(
            np.float32))
        assert torch.equal(L.segment_reduce(v, None, 20, mode, order=order),
                           L.segment_reduce(v, seg, 20, mode))
    np.testing.assert_array_equal(order[1].numpy(), np.bincount(
        seg.numpy()[(seg.numpy() >= 0) & (seg.numpy() < 20)], minlength=20))


# ------------------------------------------------------------- forwards
def test_sage_forward_full_and_loss():
    rp, p, rcfg, cfg = _params()
    g = _graph(12)
    got = G.sage_forward_full(p, torch.from_numpy(g["features"]),
                              g["edges"], cfg)
    want = RG.sage_forward_full(rp, jnp.asarray(g["features"]),
                                jnp.asarray(g["edges"]), rcfg)
    assert got.shape == (60, cfg.n_classes)
    _close(got, want)
    mask = (np.arange(60) % 3 == 0).astype(np.float32)
    for m in (None, mask):
        lg = G.sage_loss(got, g["labels"], None if m is None else m)
        lw = RG.sage_loss(want, jnp.asarray(g["labels"]),
                          None if m is None else jnp.asarray(m))
        _close(lg[0], lw[0])
        _close(lg[1]["accuracy"], lw[1]["accuracy"])


def test_sage_forward_full_weighted():
    rp, p, rcfg, cfg = _params()
    g = _graph(13)
    w = np.random.default_rng(14).random(400).astype(np.float32)
    got = G.sage_forward_full(p, torch.from_numpy(g["features"]),
                              g["edges"], cfg, weights=torch.from_numpy(w))
    want = RG.sage_forward_full(rp, jnp.asarray(g["features"]),
                                jnp.asarray(g["edges"]), rcfg,
                                weights=jnp.asarray(w))
    _close(got, want)


def test_sage_forward_minibatch():
    rp, p, rcfg, cfg = _params()
    g = _graph(15, n=200, e=1500)
    indptr, idx = Gr.build_csr(g["edges"], 200)
    f0, f1, f2 = Gr.sample_two_hop(np.random.default_rng(16), indptr, idx,
                                   np.arange(32), cfg.sample_sizes,
                                   g["features"])
    got = G.sage_forward_minibatch(p, *map(torch.from_numpy, (f0, f1, f2)),
                                   cfg)
    want = RG.sage_forward_minibatch(rp, *map(jnp.asarray, (f0, f1, f2)),
                                     rcfg)
    assert got.shape == (32, cfg.n_classes)
    _close(got, want)


def test_sage_forward_batched():
    rp, p, rcfg, cfg = _params(n_classes=2)
    b = Gr.block_diagonal_batch(np.random.default_rng(17), 8, 30, 64,
                                cfg.d_feat, 2)
    got = G.sage_forward_batched(p, torch.from_numpy(b["features"]),
                                 b["edges"], b["graph_ids"], 8, cfg)
    want = RG.sage_forward_batched(rp, jnp.asarray(b["features"]),
                                   jnp.asarray(b["edges"]),
                                   jnp.asarray(b["graph_ids"]), 8, rcfg)
    assert got.shape == (8, 2)
    _close(got, want)
    _close(G.sage_loss(got, b["labels"])[0],
           RG.sage_loss(want, jnp.asarray(b["labels"]))[0])


def test_init_sage_shapes():
    rp, _, _, cfg = _params(d_feat=24, n_classes=5)
    p = G.init_sage(torch.Generator().manual_seed(0), cfg, 24, 5, "cpu")
    got = jax.tree.map(lambda t: tuple(t.shape), p)
    assert got == jax.tree.map(lambda a: tuple(a.shape), rp)


def _bf16_bound(p, feats, edges):
    """The elementwise limit of the dst-partitioned logits against the
    one-device ones: its layer 2 aggregates the hidden states rounded to
    bf16 (each off by at most 2^-8 of itself), so a logit moves by at
    most 2^-8 * mean_neighbours(|h1|) @ |w_neigh| of layer 2."""
    p1, p2 = p["layers"]
    h1 = G._sage_layer(feats, G._mean_aggregate(feats, edges, len(feats),
                                                None), p1, final=False)
    agg = G._mean_aggregate(h1.abs(), edges, len(feats), None)
    return 2.0 ** -8 * (agg @ p2["w_neigh"].abs())


@pytest.mark.parametrize("entry", ["full", "batched", "dstpart"])
def test_mesh_ctx_matches_one_device(entry):
    """On a (2, 2) mesh of logical CPU devices: the full-graph and the
    batched forwards are the one-device ones bit for bit (the reference
    has no sharding constraint in them), and the reference's within
    RTOL; the destination-partitioned forward (edges by
    ``partition_edges_by_dst`` over the 4 corpus shards) is the
    reference's one-device forward within the bf16 limit of its hidden
    states (``_bf16_bound``) plus f32 rounding (1e-5 of the largest
    logit)."""
    rp, p, rcfg, cfg = _params()
    ctx = ShardCtx(mesh=make_test_mesh(4, device=torch.device("cpu")),
                   rules=SINGLE_POD_RULES)
    g = _graph(18, n=64, e=300)
    feats = torch.from_numpy(g["features"])
    want = RG.sage_forward_full(rp, jnp.asarray(g["features"]),
                                jnp.asarray(g["edges"]), rcfg)
    if entry == "full":
        got = G.sage_forward_full(p, feats, g["edges"], cfg, ctx)
        assert torch.equal(got, G.sage_forward_full(p, feats, g["edges"],
                                                    cfg))
    elif entry == "batched":
        gid = (np.arange(64) // 16).astype(np.int32)
        got = G.sage_forward_batched(p, feats, g["edges"], gid, 4, cfg, ctx)
        assert torch.equal(got, G.sage_forward_batched(
            p, feats, g["edges"], gid, 4, cfg))
        want = RG.sage_forward_batched(rp, jnp.asarray(g["features"]),
                                       jnp.asarray(g["edges"]),
                                       jnp.asarray(gid), 4, rcfg)
    else:
        pe, pw = Pa.partition_edges_by_dst(g["edges"], 64, 4)
        got = G.sage_forward_full_dstpart(p, feats, pe, pw, cfg, ctx)
        bound = _bf16_bound(p, feats, torch.from_numpy(g["edges"]).long())
        err = (got - torch.from_numpy(np.array(want))).abs()
        assert (err <= bound + 1e-5 * got.abs().max()).all()
        assert float(err.max()) > 0           # it did round in bf16
        return
    _close(got, want)
