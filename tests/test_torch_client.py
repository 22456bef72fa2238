"""The port's typed serving API against the JAX package's: the executor's
Backend request path, ``FusionANNSIndex.search``, the sync and asyncio
clients over the executor and over the batching service, and the request
coalescer.

Both packages serve the same tiers (the session index and the port's CPU
load of its snapshot).  Every path must return the reference's ids and
distances and the same ``QueryStats`` counters; where the threaded
harness decides which queries share a scan window, the counters that
depend on the window (``PER_WINDOW``) are left out and the per-query
ones still held.
"""

import asyncio
import copy

import numpy as np
import pytest

from repro.serve.anns_service import BatchingANNSService as RefService
from repro.serve.client import (ANNSClient as RefClient,
                                AsyncANNSClient as RefAsync,
                                RequestCoalescer as RefCoalescer,
                                SearchRequest as RefRequest,
                                coalesce_key as ref_coalesce_key)
from repro_torch.core.futures import QueryFuture
from repro_torch.serve.anns_service import BatchingANNSService
from repro_torch.serve.client import (ANNSClient, AsyncANNSClient, Backend,
                                      RequestCoalescer, SearchRequest,
                                      SearchResponse, as_request,
                                      coalesce_key)
from repro_torch.serve.router import ReplicaRouter
from repro_torch.serve.tenants import TenantManager

from _torch_serving import (FAR, PER_QUERY, PER_WINDOW,  # noqa: F401
                            assert_same, attr_pair, filters, pair,
                            port_witness_guard, snapshot)

REQUESTS = {"default": {}, "k5_top_n64": dict(k=5, top_n=64),
            "k1": dict(k=1), "far_deadline": dict(deadline_s=FAR)}


def test_backend_protocol_conformance(pair):
    """Executor, service, router and tenant manager all satisfy the
    runtime-checkable protocol: typed submit -> SearchResponse future,
    drain() -> the served responses."""
    b, idx = pair
    backends = {
        "executor": idx.make_executor(),
        "service": BatchingANNSService(idx, max_batch=4, max_wait_s=0.0),
        "router": ReplicaRouter(idx, n_replicas=2, threaded=False,
                                max_batch=4, max_wait_s=0.0),
        "tenants": TenantManager(idx.make_executor()),
    }
    for name, backend in backends.items():
        assert isinstance(backend, Backend), name
        fut = backend.submit(SearchRequest(query=b.queries[0], tag="t0"))
        assert isinstance(fut, QueryFuture), name
        drained = backend.drain()
        assert isinstance(drained, list) and len(drained) == 1, name
        assert isinstance(drained[0], SearchResponse), name
        assert drained[0].tag == "t0" and fut.result() is drained[0], name


@pytest.mark.parametrize("kw", list(REQUESTS.values()), ids=list(REQUESTS))
def test_index_search_matches_reference(pair, kw):
    """``FusionANNSIndex.search`` — the executor's request path — gives
    the reference's ids, distances and counters, one request a query.
    (The reference side runs on a fresh executor: the session index's
    shared one belongs to the JAX package's own tests.)"""
    b, idx = pair
    rex = b.index.make_executor()
    ref = [rex.submit(RefRequest(query=q, **kw)).result() for q in b.queries]
    got = [idx.search(SearchRequest(query=q, **kw)) for q in b.queries]
    assert_same(ref, got)
    assert all(g.batch_size == 1 and g.t_queue_s == 0.0 for g in got)


@pytest.mark.parametrize("fi", range(3), ids=["none", "eq", "and_range"])
def test_filtered_search_matches_reference(attr_pair, fi):
    b, ref, idx = attr_pair
    rf, pf = filters()[fi]
    want = [ref.search(RefRequest(query=q, filter=rf)) for q in b.queries]
    got = [idx.search(SearchRequest(query=q, filter=pf)) for q in b.queries]
    assert_same(want, got)


def test_executor_backend_rollup_and_cancel(pair):
    """The executor's request path is a real submission: pending on
    return, ``result()`` drives it, cancel skips the re-rank, and
    ``drain``/``live_load``/``latency_percentiles``/``stats_rollup``
    report what the reference's report for the same requests."""
    b, idx = pair
    rex, pex = b.index.make_executor(), idx.make_executor()
    fut = pex.submit(SearchRequest(query=b.queries[2], tag="x"))
    assert not fut.done() and pex.live_load() == 1
    rfut = rex.submit(RefRequest(query=b.queries[2], tag="x"))
    assert_same([rfut.result()], [fut.result()])
    victims = (pex.submit(SearchRequest(query=b.queries[3])),
               rex.submit(RefRequest(query=b.queries[3])))
    assert all(v.cancel() and v.cancelled() for v in victims)
    for q in b.queries[4:9]:
        pex.submit(SearchRequest(query=q))
        rex.submit(RefRequest(query=q))
    got, want = pex.drain(), rex.drain()
    assert [r.rid for r in got] == [r.rid for r in want]
    assert_same(want, got)
    assert pex.live_load() == rex.live_load() == 0
    assert pex.stats_rollup() == rex.stats_rollup()
    assert pex.stats_rollup()["served"] == 6
    assert pex.latency_percentiles()["n"] == 6
    assert pex.stop() is pex and pex.drain() == []


def test_executor_copies_with_fresh_locks(pair):
    """deepcopy/pickle drop the locks, tickets and planner and rebuild
    them; the copy serves on its own."""
    b, idx = pair
    ex = idx.make_executor()
    ex.planner                                          # noqa: B018
    ex.submit(SearchRequest(query=b.queries[0]))
    dup = copy.deepcopy(ex)
    assert dup._backend_lock is not ex._backend_lock
    assert dup._request_tickets == [] and not hasattr(dup, "_planner")
    np.testing.assert_array_equal(
        dup.submit(SearchRequest(query=b.queries[1])).result().ids,
        b.index.query(b.queries[1]).ids)
    ex.drain()


def test_as_request_and_coalesce_key_match_reference(pair):
    from repro.serve.client import as_request as ref_as_request
    b, _ = pair
    q = b.queries[0]
    for kw in ({}, dict(k=3, top_n=40, deadline_s=2.0, tag="a",
                        tenant="t", adaptive=True)):
        p, r = as_request(q, **kw), ref_as_request(q, **kw)
        for f in ("k", "top_n", "deadline_s", "tag", "tenant", "filter",
                  "adaptive"):
            assert getattr(p, f) == getattr(r, f), f
        assert p.query.dtype == np.float32
        np.testing.assert_array_equal(p.query, r.query)
        assert as_request(p) is p
        assert as_request(p, k=9).k == 9 and p.k == kw.get("k")
        for fused, int8, epoch in ((False, False, None), (True, True, 3)):
            pk = coalesce_key(p, fused=fused, lut_int8=int8, epoch=epoch)
            rk = ref_coalesce_key(r, fused=fused, lut_int8=int8, epoch=epoch)
            assert pk == rk


def _sync_backend(pkg_index, service_cls, kind):
    if kind == "executor":
        return pkg_index.make_executor()
    return service_cls(pkg_index, max_batch=8, max_wait_s=0.0,
                       threaded=(kind == "threaded"), **(
                           {"fused": True} if kind == "fused" else {}))


@pytest.mark.parametrize("kind", ["executor", "service", "threaded",
                                  "fused"])
def test_sync_client_matches_reference(pair, kind):
    """``ANNSClient.search_many`` over the executor and the batching
    service (sync, threaded and fused): the reference's answers."""
    b, idx = pair
    pb = _sync_backend(idx, BatchingANNSService, kind)
    rb = _sync_backend(b.index, RefService, kind)
    try:
        reqs = [dict(query=q, tag=i, deadline_s=FAR)
                for i, q in enumerate(b.queries)]
        got = ANNSClient(pb).search_many([SearchRequest(**r) for r in reqs],
                                         timeout=120)
        want = RefClient(rb).search_many([RefRequest(**r) for r in reqs],
                                         timeout=120)
    finally:
        pb.stop()
        rb.stop()
    # the threaded harness forms its own batches: window counters differ
    assert_same(want, got, counters=PER_QUERY if kind == "threaded"
                else PER_QUERY + PER_WINDOW)
    assert [g.tag for g in got] == list(range(len(b.queries)))
    assert pb.stats_rollup()["served"] == len(b.queries)


@pytest.mark.parametrize("kind", ["executor", "service", "threaded",
                                  "router"])
def test_async_client_matches_reference(pair, kind):
    """``AsyncANNSClient.search`` / ``search_many`` over the executor,
    the sync and the threaded service and a threaded two-replica router:
    every response carries the reference's ids and distances (streamed in
    completion order, matched by tag), and no future is left pending."""
    b, idx = pair
    if kind == "router":
        pb = ReplicaRouter(idx, n_replicas=2, threaded=True, max_batch=8,
                           max_wait_s=0.0005)
    else:
        pb = _sync_backend(idx, BatchingANNSService, kind)
    want = b.index.batch_query(b.queries)

    async def drive():
        async with AsyncANNSClient(pb, max_inflight=16) as ac:
            one = await asyncio.wait_for(
                ac.search(SearchRequest(query=b.queries[0], tag="one")), 60)
            reqs = [SearchRequest(query=q, tag=i, deadline_s=FAR)
                    for i, q in enumerate(b.queries)]
            got = {}

            async def collect():
                async for r in ac.search_many(reqs):
                    got[r.tag] = r
            await asyncio.wait_for(collect(), 120)
            return one, got

    try:
        one, got = asyncio.run(drive())
    finally:
        pb.stop()
    assert_same(want[:1], [one], counters=PER_QUERY)
    assert_same(want, [got[i] for i in range(len(b.queries))],
                counters=PER_QUERY)
    assert pb.live_load() == 0


def test_async_clients_with_coalescer_match_reference(pair):
    """A burst of duplicates through each package's coalescing async
    client costs one backend submit a distinct query, and both give the
    same answers and the same leader/attached counts."""
    b, idx = pair
    qs = [b.queries[i % 4] for i in range(16)]

    def run(index, svc_cls, client_cls, coal_cls, req_cls):
        svc = svc_cls(index, threaded=True, max_batch=8, max_wait_s=0.002)
        co = coal_cls()

        async def drive():
            async with client_cls(svc, coalescer=co) as ac:
                return await asyncio.wait_for(asyncio.gather(*[
                    ac.search(req_cls(query=q, tag=i))
                    for i, q in enumerate(qs)]), 120)
        try:
            out = asyncio.run(drive())
        finally:
            svc.stop()
        return out, dict(co.stats), svc.stats_rollup()["served"], co.live()

    got, pst, pserved, plive = run(idx, BatchingANNSService,
                                   AsyncANNSClient, RequestCoalescer,
                                   SearchRequest)
    want, rst, rserved, rlive = run(b.index, RefService, RefAsync,
                                    RefCoalescer, RefRequest)
    assert_same(want, got, counters=PER_QUERY)
    assert [g.tag for g in got] == list(range(len(qs)))
    assert pst["leaders"] + pst["attached"] == len(qs)
    assert pserved == pst["leaders"] and plive == 0
    assert rserved == rst["leaders"] and rlive == 0


def test_coalescer_claim_publish_abandon_match_reference(pair):
    """The coalescer's leader/waiter protocol driven by hand the same way
    on both packages: waiters mirror the leader's response with their own
    tags, an abandoned key fails its waiters, a resolved key retires."""
    b, _ = pair
    from repro.core.futures import QueryFuture as RefFuture
    from repro.serve.client import SearchResponse as RefResponse
    from repro.core.executor import QueryStats as RefStats
    from repro_torch.core.executor import QueryStats

    def drive(co_cls, req_cls, fut_cls, resp_cls, stats_cls):
        co = co_cls(epoch_source=lambda: 7)
        q = b.queries[0]
        lead, key = co.claim(req_cls(query=q, tag="a"))
        attached = [co.claim(req_cls(query=q, tag=t)) for t in "bc"]
        master = fut_cls(tag="m")
        co.publish(key, master)
        attached[1][1].cancel()                   # only that waiter
        stats = stats_cls(**dict.fromkeys(
            ("ios", "pages_requested", "buffer_hits", "ssd_bytes",
             "h2d_bytes", "candidates_scanned", "candidates_prefilter",
             "rerank_batches", "rerank_scored"), 1), early_stopped=False)
        master._set_result(resp_cls(ids=np.arange(3), dists=np.zeros(3),
                                    stats=stats, tag="a"))
        lead2, key2 = co.claim(req_cls(query=b.queries[1]))
        waiter = co.claim(req_cls(query=b.queries[1], tag="w"))[1]
        co.abandon(key2, RuntimeError("refused"))
        return (lead, [a[0] for a in attached],
                attached[0][1].result().tag, attached[1][1].cancelled(),
                lead2, type(waiter.exception()).__name__, dict(co.stats),
                co.live())

    assert drive(RequestCoalescer, SearchRequest, QueryFuture,
                 SearchResponse, QueryStats) == \
        drive(RefCoalescer, RefRequest, RefFuture, RefResponse, RefStats)
