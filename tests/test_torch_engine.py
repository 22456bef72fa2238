"""The port's query engine against the JAX package's, on one index.

The shared session index (``anns_bundle``) is saved with the JAX package's
``save_snapshot`` and loaded into the port with ``device="cpu"``: both
packages then hold the same codebooks, codes, posting lists, graph and SSD
tier.  Every query path must return the reference's ids AND distances
(both come from the numpy re-rank on raw vectors, so equality is exact)
and the same ``QueryStats`` counters.  An index the port builds itself
must reach the reference's recall.

With a mesh of logical CPU devices attached (``attach_mesh``,
``make_executor(mesh)``) the sharded executor — each shard scanning its
own rows, only (dist, id) pairs merged — must give the JAX single-device
executor's ids, distances and counters (the reference's own sharded
executor raises on this JAX, ROADMAP queue 3 fault (a)), also after
inserts, deletes and seals replayed on both packages; a seal re-places
the code shards, an insert does not.
"""

import copy

import numpy as np
import pytest

from repro.core.engine import FusionANNSIndex as RefIndex
from repro.core.executor import PlanOverrides as RefOverrides
from repro.core.filters import And as RefAnd, Eq as RefEq, Range as RefRange
from repro.core.engine import recall_at_k
from repro_torch.core.engine import FusionANNSIndex
from repro_torch.core.executor import PlanOverrides
from repro_torch.core.filters import And, Eq, Range
from repro_torch.launch.mesh import make_test_mesh, recarve_mesh

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


MESH_PATHS = {"dense": {}, "fused": dict(fused=True),
              "int8": dict(fused=True, lut_int8=True)}


def _mesh(name):
    """(2, 1), (2, 2), and the last of three groups carved from 8: a
    (1, 2) sub-mesh of ids 6 and 7."""
    if name == "carved":
        return recarve_mesh(make_test_mesh(8, device="cpu"), 3)[2]
    return make_test_mesh(int(name), device="cpu")


@pytest.mark.parametrize("mesh", ["2", "4", "carved"])
@pytest.mark.parametrize("path", sorted(MESH_PATHS))
@pytest.mark.parametrize("window", [1, 64])
def test_mesh_executor_serves_reference(pair, mesh, path, window):
    b, port = pair
    ex = port.make_executor(_mesh(mesh))
    assert ex._n_shards() == (4 if mesh == "4" else 2)
    got = ex.run(b.queries, port.plan(window=window, **MESH_PATHS[path]))
    want = b.index.submit(b.queries, window=window,
                          **MESH_PATHS[path]).results()
    assert_same(want, got)


def test_attach_mesh_swaps_the_placement(pair):
    b, port = pair
    port = copy.deepcopy(port)
    ex = port.executor.attach_mesh(make_test_mesh(4, device="cpu"))
    assert_same(b.index.batch_query(b.queries), port.batch_query(b.queries))
    placed = ex._placed
    assert placed.starts == (0, 625, 1250, 1875, 2500)
    assert all(p.data_ptr() == port.codes[s].data_ptr()
               for p, s in zip(placed.parts, placed.starts))   # views
    ex.attach_mesh(make_test_mesh(2, device="cpu"))
    assert ex._placed is None and ex._n_shards() == 2
    assert_same(b.index.query_batch_fused(b.queries),
                port.query_batch_fused(b.queries))
    assert ex._placed.starts == (0, 1250, 2500)


def test_mesh_executor_after_mutation(anns_bundle, fresh_index, tmp_path):
    """Inserts, deletes and two seals (the second purging deleted delta
    rows) replayed on both packages; after each step the sharded port
    answers as the reference's single-device executor.  An insert keeps
    the placement; a seal re-places it over the new codes."""
    b, ref = anns_bundle, fresh_index
    ref.save_snapshot(str(tmp_path))
    port = FusionANNSIndex.load_snapshot(str(tmp_path), device="cpu")
    ex = port.make_executor(make_test_mesh(4, device="cpu"))
    queries = np.concatenate([b.queries[:8], b.new_vecs[:8]])

    def check():
        for path, plan in MESH_PATHS.items():
            for window in (1, 64):
                assert_same(ref.submit(queries, window=window,
                                       **plan).results(),
                            ex.run(queries, port.plan(window=window,
                                                      **plan)))

    check()
    placed = ex._placed
    ids = ref.insert(b.new_vecs[:12])
    np.testing.assert_array_equal(port.insert(b.new_vecs[:12]), ids)
    for index in (ref, port):
        index.delete(np.asarray([ids[0], 3]))
    check()
    assert ex._placed is placed                  # an insert: no re-place
    ref.compact()
    port.compact()
    check()
    assert ex._placed is not placed and ex._placed_src is port.codes
    assert ex._placed.starts[-1] == port.codes.shape[0]
    more = ref.insert(b.new_vecs[12:20])
    port.insert(b.new_vecs[12:20])
    for index in (ref, port):
        index.delete(more[2:5])
        index.compact()                          # purges the deleted rows
    check()
    assert ex._placed.starts[-1] == port.codes.shape[0]


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
