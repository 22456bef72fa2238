"""The port's query engine against the JAX package's, on one index.

The shared session index (``anns_bundle``) is saved with the JAX package's
``save_snapshot`` and loaded into the port with ``device="cpu"``: both
packages then hold the same codebooks, codes, posting lists, graph and SSD
tier.  Every query path must return the reference's ids AND distances
(both come from the numpy re-rank on raw vectors, so equality is exact)
and the same ``QueryStats`` counters.  An index the port builds itself
must reach the reference's recall.
"""

import numpy as np
import pytest

from repro.core.engine import FusionANNSIndex as RefIndex
from repro.core.executor import PlanOverrides as RefOverrides
from repro.core.filters import And as RefAnd, Eq as RefEq, Range as RefRange
from repro.core.engine import recall_at_k
from repro_torch.core.engine import FusionANNSIndex
from repro_torch.core.executor import PlanOverrides
from repro_torch.core.filters import And, Eq, Range

COUNTERS = ("candidates_scanned", "candidates_prefilter", "ios",
            "buffer_hits", "rerank_batches")


def assert_same(ref_results, port_results):
    assert len(ref_results) == len(port_results)
    for r, p in zip(ref_results, port_results):
        np.testing.assert_array_equal(p.ids, r.ids)
        np.testing.assert_array_equal(p.dists, r.dists)
        for c in COUNTERS:
            assert getattr(p.stats, c) == getattr(r.stats, c), c


@pytest.fixture(scope="module")
def pair(anns_bundle, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("snap"))
    anns_bundle.index.save_snapshot(path)
    return anns_bundle, FusionANNSIndex.load_snapshot(path, device="cpu")


def test_snapshot_tiers_load(pair):
    b, port = pair
    np.testing.assert_array_equal(port.codes.numpy(),
                                  np.asarray(b.index.codes))
    np.testing.assert_array_equal(port.codebook.codebooks.numpy(),
                                  np.asarray(b.index.codebook.codebooks))
    assert port.device.type == "cpu"
    assert port.n_total == b.index.n_total


def test_single_and_batch_paths(pair):
    b, port = pair
    assert_same([b.index.query(q) for q in b.queries],
                [port.query(q) for q in b.queries])
    assert_same(b.index.batch_query(b.queries), port.batch_query(b.queries))
    assert_same(b.index.query_batch_fused(b.queries),
                port.query_batch_fused(b.queries))


@pytest.mark.parametrize("plan", [
    dict(fused=True), dict(fused=True, lut_int8=True),
    dict(window=4, inflight_depth=1), dict(window=4, inflight_depth=2),
    dict(window=4, inflight_depth=3),
    dict(window=4, inflight_depth=3, fused=True, lut_int8=True),
], ids=["fused", "fused_int8", "w4_d1", "w4_d2", "w4_d3", "w4_d3_int8"])
def test_plan_paths(pair, plan):
    b, port = pair
    assert_same(b.index.submit(b.queries, **plan).results(),
                port.submit(b.queries, **plan).results())


@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
def test_mixed_k_overrides(pair, fused):
    b, port = pair
    ks = [1, 5, 10, 3, None, 7] * 4
    tops = [None, 64, None, 32, 128, None] * 4
    n = len(b.queries)
    ref_ov = [RefOverrides(k=k, top_n=t) for k, t in zip(ks, tops)][:n]
    port_ov = [PlanOverrides(k=k, top_n=t) for k, t in zip(ks, tops)][:n]
    ref = b.index.submit(b.queries, overrides=ref_ov, window=6,
                         fused=fused).results()
    got = port.submit(b.queries, overrides=port_ov, window=6,
                      fused=fused).results()
    assert_same(ref, got)
    assert [len(r.ids) for r in got] == [k or b.cfg.top_k for k in ks][:n]


@pytest.fixture(scope="module")
def filtered_pair(anns_bundle, tmp_path_factory):
    """A small attributed reference index plus a few delta rows (the
    unsealed tail the executor merges exactly), loaded into the port."""
    b = anns_bundle
    n = len(b.data)
    ref = RefIndex.build(b.data, b.cfg, attributes={
        "cat": np.arange(n) % 8, "ts": np.arange(n) % 100})
    ref.insert(b.new_vecs, attributes={"cat": np.zeros(len(b.new_vecs),
                                                        np.int64)})
    path = str(tmp_path_factory.mktemp("snap_attr"))
    ref.save_snapshot(path)
    return b, ref, FusionANNSIndex.load_snapshot(path, device="cpu")


@pytest.mark.parametrize("fused", [False, True], ids=["dense", "fused"])
def test_filtered_requests_and_delta(filtered_pair, fused):
    b, ref, port = filtered_pair
    for rf, pf in ((None, None), (RefEq("cat", 0), Eq("cat", 0)),
                   (RefAnd((RefEq("cat", 1), RefRange("ts", 0, 50))),
                    And((Eq("cat", 1), Range("ts", 0, 50))))):
        r = ref.submit(b.queries, filter=rf, fused=fused, window=5).results()
        p = port.submit(b.queries, filter=pf, fused=fused,
                        window=5).results()
        assert_same(r, p)
        if pf is not None:
            assert all(x.stats.candidates_scanned
                       < x.stats.candidates_prefilter for x in p)


def test_port_built_index_recall(anns_bundle):
    b = anns_bundle
    port = FusionANNSIndex.build(b.data, b.cfg, device="cpu")
    got = recall_at_k(np.stack([r.ids for r in port.query_batch_fused(
        b.queries)]), b.gt, 10)
    ref = recall_at_k(np.stack([r.ids for r in b.index.query_batch_fused(
        b.queries)]), b.gt, 10)
    assert got >= ref - 0.02
    fused = port.submit(b.queries, fused=True).results()
    np.testing.assert_array_equal(
        np.stack([r.ids for r in fused]),
        np.stack([r.ids for r in port.query_batch_fused(b.queries)]))


def test_fused_top_n_4096_over_lists_past_16384_rows(tmp_path):
    """A fused window whose longest candidate list passes 16,384 rows at
    top_n = 4,096 (S = 32,768, tk = 4,096): the card serves it on the
    fused kernel's spill route, which fused_plan's one launch refuses; on
    the CPU the plain version returns the reference's ids and distances
    for every query."""
    import dataclasses
    from repro.configs.anns_datasets import SIFT_SMALL
    from repro.data.synthetic import clustered_vectors
    from repro_torch.kernels.pq_adc import ops

    n, dim = 34_000, 16
    cfg = dataclasses.replace(SIFT_SMALL, n_vectors=n, dim=dim, pq_m=4,
                              n_posting_fraction=4 / n, top_m=2,
                              top_n=4096)
    rows = clustered_vectors(np.random.default_rng(5), n + 4, dim,
                             n_clusters=4)
    ref = RefIndex.build(rows[:n], cfg)
    ref.save_snapshot(str(tmp_path))
    port = FusionANNSIndex.load_snapshot(str(tmp_path), device="cpu")
    queries = rows[n:]
    longest = max(len(port.view().collect_candidates(q, cfg.top_m)[0])
                  for q in queries)
    assert longest > 16_384
    s = 1 << (longest - 1).bit_length()
    with pytest.raises(ValueError):
        ops.fused_plan(len(queries), s, 4096, cfg.pq_m, 256, 132)
    assert ops.fused_route(len(queries), s, 4096, cfg.pq_m, 256,
                           132).key == "adc_fused_topk[spill]"
    assert_same(ref.submit(queries, fused=True).results(),
                port.submit(queries, fused=True).results())
