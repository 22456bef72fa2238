"""The port's host tiers against the JAX package's: same numpy inputs,
same answers.

Candidate collection, Algorithm 1 re-rank with its I/O accounting, the
SSD page layout, posting-list and graph construction under the same
``np.random.Generator``, PQ encoding under the same codebooks, and the
synthetic data generator are all equal, not merely close.  The plan-merge
rule follows DESIGN.md §3 (only ``None`` keeps the layer below), which the
JAX package's ``QueryPlan.override`` breaks for an explicit ``None``
keyword (ROADMAP queue 3(b)).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import clustering as rclust, navgraph as rnav, pq as rpq
from repro.core.filters import Eq as RefEq, In as RefIn
from repro.core.io_sim import (SSDSim as RefSSD,
                               StorageLayout as RefLayout,
                               pack_buckets_maxmin as ref_pack)
from repro.core.rerank import heuristic_rerank as ref_rerank
from repro.data.synthetic import clustered_vectors as ref_vectors
from repro_torch.core import clustering, navgraph, pq
from repro_torch.core.engine import FusionANNSIndex
from repro_torch.core.executor import PlanOverrides, QueryPlan
from repro_torch.core.filters import Eq, In
from repro_torch.core.io_sim import (SSDSim, StorageLayout,
                                     pack_buckets_maxmin)
from repro_torch.core.rerank import heuristic_rerank
from repro_torch.data.synthetic import clustered_vectors

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def pair(anns_bundle, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("snap"))
    anns_bundle.index.save_snapshot(path)
    return anns_bundle, FusionANNSIndex.load_snapshot(path, device="cpu")


@pytest.mark.parametrize("filters", [(None, None),
                                     (RefEq("c", 1), Eq("c", 1)),
                                     (RefIn("c", (0, 2)), In("c", (0, 2)))],
                         ids=["none", "eq", "in"])
def test_collect_candidates_equal(pair, filters):
    b, port = pair
    rview, pview = b.index.view(), port.view()
    attrs = {"c": np.arange(rview.n_sealed) % 3}
    from repro.core.filters import AttributeTable as RefTable
    from repro_torch.core.filters import AttributeTable
    rview = dataclasses.replace(rview, attrs=RefTable.from_columns(
        rview.n_sealed, attrs))
    pview = dataclasses.replace(pview, attrs=AttributeTable.from_columns(
        pview.n_sealed, attrs))
    rf, pf = filters
    for q in b.queries:
        for top_m in (1, 8, b.cfg.top_m):
            r_ids, r_pre = rview.collect_candidates(q, top_m, filt=rf)
            p_ids, p_pre = pview.collect_candidates(q, top_m, filt=pf)
            np.testing.assert_array_equal(p_ids, r_ids)
            np.testing.assert_array_equal(p_pre, r_pre)


@pytest.mark.parametrize("intra_merge,use_buffer",
                         [(True, True), (False, True), (True, False)])
def test_heuristic_rerank_equal(anns_bundle, intra_merge, use_buffer):
    b = anns_bundle
    rng = np.random.default_rng(5)
    posting = b.index.posting
    kw = dict(vec_bytes=4 * b.data.shape[1], page_bytes=b.cfg.page_bytes)
    rlay = RefLayout.build(posting.primary, posting.n_clusters, **kw)
    play = StorageLayout.build(posting.primary, posting.n_clusters, **kw)
    np.testing.assert_array_equal(play.page_of, rlay.page_of)
    assert play.n_pages == rlay.n_pages
    rssd = RefSSD(b.data, rlay, buffer_pages=8, intra_merge=intra_merge,
                  use_buffer=use_buffer)
    pssd = SSDSim(b.data, play, buffer_pages=8, intra_merge=intra_merge,
                  use_buffer=use_buffer)
    for q in b.queries[:8]:
        cand = rng.choice(len(b.data), int(rng.integers(1, 300)),
                          replace=False)
        for k, batch, early in ((10, 16, False), (3, 7, True)):
            r = ref_rerank(q, cand, rssd, k, batch_size=batch,
                           disable_early_stop=early)
            p = heuristic_rerank(q, cand, pssd, k, batch_size=batch,
                                 disable_early_stop=early)
            np.testing.assert_array_equal(p.ids, r.ids)
            np.testing.assert_array_equal(p.dists, r.dists)
            assert dataclasses.asdict(p.io) == dataclasses.asdict(r.io)
            assert (p.batches_run, p.candidates_scored, p.early_stopped) \
                == (r.batches_run, r.candidates_scored, r.early_stopped)


def test_page_packing_equal():
    rng = np.random.default_rng(9)
    for _ in range(60):
        per_page = int(rng.integers(1, 40))
        sizes = rng.integers(0, 5 * per_page,
                             int(rng.integers(0, 200))).tolist()
        assert pack_buckets_maxmin(sizes, per_page) == \
            ref_pack(sizes, per_page)


@pytest.mark.parametrize("n,dim,n_clusters", [(2500, 32, 50), (4000, 16, 90)])
def test_build_posting_lists_equal(n, dim, n_clusters):
    data = ref_vectors(np.random.default_rng(1), n, dim, n_clusters=24)
    r = rclust.build_posting_lists(np.random.default_rng(2), data,
                                   n_clusters)
    p = clustering.build_posting_lists(np.random.default_rng(2), data,
                                       n_clusters, device=CPU)
    np.testing.assert_array_equal(p.centroids, r.centroids)
    np.testing.assert_array_equal(p.primary, r.primary)
    assert len(p.members) == len(r.members)
    for pm, rm in zip(p.members, r.members):
        np.testing.assert_array_equal(pm, rm)
        assert pm.dtype == rm.dtype


def test_navgraph_build_and_search_equal(anns_bundle):
    cents = anns_bundle.index.posting.centroids
    r = rnav.build_navgraph(cents, degree=12)
    p = navgraph.build_navgraph(cents, degree=12, device=CPU)
    np.testing.assert_array_equal(p.neighbors, r.neighbors)
    np.testing.assert_array_equal(p.super_centroids, r.super_centroids)
    np.testing.assert_array_equal(p.super_assign, r.super_assign)
    assert p.entry == r.entry
    for q in anns_bundle.queries:
        for top_m in (1, 8, 30):
            np.testing.assert_array_equal(navgraph.search(p, q, top_m),
                                          rnav.search(r, q, top_m))
    with pytest.raises(ValueError, match="n_posting_fraction"):
        navgraph.build_navgraph(np.zeros((50_001, 2), np.float32),
                                device=CPU)


def test_pq_encode_equal_under_shared_codebooks(anns_bundle):
    import jax.numpy as jnp
    b = anns_bundle
    cb = np.asarray(b.index.codebook.codebooks)
    codes = pq.encode(pq.PQCodebook(torch.from_numpy(cb.copy())), b.data)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(b.index.codes))
    np.testing.assert_array_equal(
        pq.decode(pq.PQCodebook(torch.from_numpy(cb.copy())), codes).numpy(),
        np.asarray(rpq.decode(rpq.PQCodebook(jnp.asarray(cb)),
                              jnp.asarray(codes.numpy()))))


def test_pq_training_error_close_to_reference(anns_bundle):
    """Port-trained codebooks start from a torch.Generator draw, not
    jax.random, so they differ; their quantization error stays within 5%
    of the reference codebooks' on the same data."""
    b = anns_bundle
    cb = pq.train_codebooks(torch.Generator().manual_seed(0), b.data,
                            b.cfg.pq_m, device=CPU)
    rec = pq.decode(cb, pq.encode(cb, b.data)).numpy()
    ref_cb = pq.PQCodebook(torch.from_numpy(
        np.asarray(b.index.codebook.codebooks).copy()))
    ref_rec = pq.decode(ref_cb, pq.encode(ref_cb, b.data)).numpy()
    err = np.mean(np.sum((rec - b.data) ** 2, -1))
    ref_err = np.mean(np.sum((ref_rec - b.data) ** 2, -1))
    assert err <= 1.05 * ref_err


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int8])
def test_clustered_vectors_equal(dtype):
    r = ref_vectors(np.random.default_rng(4), 700, 12, dtype=dtype)
    p = clustered_vectors(np.random.default_rng(4), 700, 12, dtype=dtype)
    np.testing.assert_array_equal(p, r)
    chunked = clustered_vectors(np.random.default_rng(4), 700, 12,
                                dtype=dtype, chunk=256)
    assert chunked.shape == r.shape and chunked.dtype == r.dtype


BASE = QueryPlan(k=10, top_m=16, top_n=128)


def test_override_pins_explicit_none_keyword():
    """ROADMAP queue 3(b): k=0 from the overrides survives k=None."""
    assert BASE.override(PlanOverrides(k=0), k=None).k == 0
    assert BASE.override(PlanOverrides(k=None), k=None).k == 10


@pytest.mark.parametrize("ov_k", [None, 0, 3])
@pytest.mark.parametrize("kw_k", [None, 0, 5])
def test_override_last_non_none_wins(ov_k, kw_k):
    want = kw_k if kw_k is not None else ov_k if ov_k is not None else 10
    got = BASE.override(PlanOverrides(k=ov_k, top_n=0), k=kw_k)
    assert got.k == want
    assert got.top_n == 0 and got.top_m == 16
    assert PlanOverrides(k=ov_k).merge_into(BASE) == \
        BASE.override(PlanOverrides(k=ov_k))
