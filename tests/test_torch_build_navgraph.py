"""The port's incremental navigation-graph build (above 50,000 vertices)
against the JAX package's ``build_navgraph``, on the CPU: the same
points give the same neighbours, entry and seed tree, bit for bit.  Both
are per-vertex Python loops; this file holds only this test, so it runs
on a worker of its own.
"""

import numpy as np
import torch

from repro.core import navgraph as rnav
from repro_torch.core import navgraph


def test_incremental_navgraph_equals_reference():
    pts = np.random.default_rng(0).normal(
        size=(navgraph.MAX_EXACT_VERTICES + 1, 8)).astype(np.float32)
    r = rnav.build_navgraph(pts, degree=4, ef_build=8)
    p = navgraph.build_navgraph(pts, degree=4, ef_build=8,
                                device=torch.device("cpu"))
    np.testing.assert_array_equal(p.neighbors, r.neighbors)
    assert p.entry == r.entry
    np.testing.assert_array_equal(p.super_centroids, r.super_centroids)
    np.testing.assert_array_equal(p.super_assign, r.super_assign)
    for q in pts[:: 5000]:
        np.testing.assert_array_equal(navgraph.search(p, q, 8),
                                      rnav.search(r, q, 8))
