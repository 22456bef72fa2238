"""What the port's serving-stack tests share (imported by
``tests/test_torch_{client,service,router,edge,perf_model}.py``).

* ``port_witness_guard`` — autouse in every module that imports it: with
  ``LINT_LOCKS`` set, the port's locks are witnesses of
  ``repro_torch.analysis.concurrency.witness.WITNESS`` (the conftest's
  guard drains only the JAX package's), so a test whose body inverted
  the port's lock hierarchy fails here.
* ``pair`` — the session index (``anns_bundle``, built by the JAX
  package) beside the port's load of its snapshot on the CPU, so both
  packages serve the same tiers.
* ``assert_same`` — ids, distances and ``QueryStats`` counters equal.
"""

import numpy as np
import pytest

# every QueryStats counter; the last three depend on which queries share a
# scan window (the union), the rest on the query alone
PER_QUERY = ("ios", "pages_requested", "buffer_hits", "ssd_bytes",
             "rerank_batches", "rerank_scored")
PER_WINDOW = ("h2d_bytes", "candidates_scanned", "candidates_prefilter")
FAR = 3600.0        # a deadline no run meets early


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


@pytest.fixture(autouse=True)
def port_witness_guard():
    from repro_torch.analysis.concurrency import witness
    if not witness.enabled():
        yield
        return
    witness.WITNESS.drain_violations()
    yield
    bad = witness.WITNESS.drain_violations()
    assert not bad, ("lock-order violations witnessed in the port:\n"
                     + "\n".join(map(str, bad)))


def load_port(path: str):
    from repro_torch.core.engine import FusionANNSIndex
    return FusionANNSIndex.load_snapshot(path, device="cpu")


@pytest.fixture(scope="module")
def snapshot(anns_bundle, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("snap"))
    anns_bundle.index.save_snapshot(path)
    return path


@pytest.fixture(scope="module")
def pair(anns_bundle, snapshot):
    return anns_bundle, load_port(snapshot)


def assert_same(ref, port, counters=PER_QUERY + PER_WINDOW):
    """Results (``QueryResult`` or ``SearchResponse``) equal one by one."""
    ref, port = list(ref), list(port)
    assert len(ref) == len(port)
    for i, (r, p) in enumerate(zip(ref, port)):
        np.testing.assert_array_equal(p.ids, r.ids, err_msg=f"query {i}")
        np.testing.assert_array_equal(p.dists, r.dists, err_msg=f"query {i}")
        for c in counters:
            assert getattr(p.stats, c) == getattr(r.stats, c), (i, c)


@pytest.fixture(scope="module")
def attr_pair(anns_bundle, tmp_path_factory):
    """An attributed reference index (columns ``cat`` = id % 8 and
    ``ts`` = id % 100 on the sealed rows, ``cat`` = 0 on a delta of the
    held-out rows) beside the port's load of its snapshot."""
    from repro.core.engine import FusionANNSIndex as RefIndex
    b = anns_bundle
    n = len(b.data)
    ref = RefIndex.build(b.data, b.cfg, attributes={
        "cat": np.arange(n) % 8, "ts": np.arange(n) % 100})
    ref.insert(b.new_vecs, attributes={"cat": np.zeros(len(b.new_vecs),
                                                        np.int64)})
    path = str(tmp_path_factory.mktemp("snap_attr"))
    ref.save_snapshot(path)
    return b, ref, load_port(path)


def filters():
    """The same predicates built by each package: (reference, port)."""
    from repro.core import filters as rf
    from repro_torch.core import filters as pf
    return [(None, None), (rf.Eq("cat", 0), pf.Eq("cat", 0)),
            (rf.And((rf.Eq("cat", 1), rf.Range("ts", 0, 50))),
             pf.And((pf.Eq("cat", 1), pf.Range("ts", 0, 50))))]
