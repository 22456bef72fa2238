"""The paper's baselines (``core.baselines``: SPANN-like, HI+GPU, HI+PQ
and HI+PQ+GPU, RUMMY-like, DiskANN-like) in the port against the JAX
package's, on the session index loaded from its snapshot on the CPU.

Each system must return the reference's ids, ``QueryDemand`` numbers
and ``IOStats`` for every query (all host numpy over the same tiers;
HI+PQ's lookup table comes from the port's ``pq.adc_lut``, equal to the
reference's ``jnp`` one on these inputs).
"""

import dataclasses

import numpy as np
import pytest

from repro.core import baselines as rb
from repro_torch.core import baselines as pb

from _torch_serving import pair, snapshot  # noqa: F401


def _same(ref, port):
    np.testing.assert_array_equal(port.ids, ref.ids)
    assert dataclasses.asdict(port.demand) == dataclasses.asdict(ref.demand)
    assert dataclasses.asdict(port.io) == dataclasses.asdict(ref.io)


@pytest.mark.parametrize("system", ["SpannLike", "HIGpu", "RummyLike"])
@pytest.mark.parametrize("top_m", [4, 16])
def test_list_systems_match_reference(pair, system, top_m):
    b, idx = pair
    ref = getattr(rb, system)(b.index, b.data)
    port = getattr(pb, system)(idx, b.data)
    for q in b.queries:
        _same(ref.query(q, 10, top_m), port.query(q, 10, top_m))


@pytest.mark.parametrize("gpu", [False, True], ids=["cpu_adc", "gpu_adc"])
@pytest.mark.parametrize("top_n", [32, 128])
def test_hi_pq_matches_reference(pair, gpu, top_n):
    b, idx = pair
    ref = rb.HIPq(b.index, b.data, gpu=gpu)
    port = pb.HIPq(idx, b.data, gpu=gpu)
    for q in b.queries:
        _same(ref.query(q, 10, 8, top_n), port.query(q, 10, 8, top_n))


def test_diskann_like_matches_reference(anns_bundle):
    b = anns_bundle
    data = b.data[:1200]
    ref = rb.DiskAnnLike(data, degree=16)
    port = pb.DiskAnnLike(data, degree=16, device="cpu")
    np.testing.assert_array_equal(port.graph.neighbors, ref.graph.neighbors)
    for q in b.queries:
        for ef in (32, 128):
            _same(ref.query(q, 10, ef=ef), port.query(q, 10, ef=ef))


def test_baselines_reach_the_index_recall(pair):
    """As ``tests/test_engine.py`` holds the reference's: each list system
    within reach of the index's recall@10."""
    from repro.core.engine import recall_at_k
    b, idx = pair
    fa = recall_at_k(np.stack([r.ids for r in idx.query_batch_fused(
        b.queries)]), b.gt, 10)
    for system in (pb.SpannLike(idx, b.data), pb.RummyLike(idx, b.data)):
        got = np.stack([system.query(q, 10, b.cfg.top_m).ids
                        for q in b.queries])
        assert recall_at_k(got, b.gt, 10) >= fa - 0.1
    hp = pb.HIPq(idx, b.data)
    got = np.stack([hp.query(q, 10, b.cfg.top_m, b.cfg.top_n).ids
                    for q in b.queries])
    assert recall_at_k(got, b.gt, 10) >= fa - 0.1
