"""The port's tenants and HTTP edge against the JAX package's.

* ``TokenBucket`` and ``TenantManager`` quotas on a fake clock: the same
  admissions, refusals, ``retry_after`` values, refunds and books.
* Base predicates: two tenants over one attributed index never see each
  other's rows, and get the reference's answers.
* ``AnnsEdge`` on ``127.0.0.1`` at an ephemeral port, over a threaded
  two-replica router, with two tenants, API keys and one quota: the same
  HTTP requests (searches, filters, adaptive and deadlined bodies, bad
  bodies, unknown routes and keys, a request past the quota, the stats
  and health routes) get the reference edge's status codes, error codes
  and ids.  Every wait carries a timeout and every edge is closed.
"""

import asyncio

import numpy as np

from repro.core import filters as rf
from repro.core.futures import BackpressureError as RefBackpressure
from repro.core.futures import QueryFuture as RefFuture
from repro.serve.client import SearchRequest as RefRequest
from repro.serve.edge import (AnnsEdge as RefEdge, EdgeConfig as RefEdgeCfg,
                              HttpConn as RefConn)
from repro.serve.router import ReplicaRouter as RefRouter
from repro.serve.tenants import (QuotaExceeded as RefQuota,
                                 TenantConfig as RefTenant,
                                 TenantManager as RefManager,
                                 TokenBucket as RefBucket)
from repro_torch.core import filters as pf
from repro_torch.core.futures import BackpressureError, QueryFuture
from repro_torch.serve.client import SearchRequest
from repro_torch.serve.edge import AnnsEdge, EdgeConfig, HttpConn
from repro_torch.serve.router import ReplicaRouter
from repro_torch.serve.tenants import (QuotaExceeded, TenantConfig,
                                       TenantManager, TokenBucket)

from _torch_serving import (FakeClock, assert_same, attr_pair,  # noqa: F401
                            pair, port_witness_guard, snapshot)

PORT = dict(bucket=TokenBucket, manager=TenantManager, tenant=TenantConfig,
            quota=QuotaExceeded, request=SearchRequest, future=QueryFuture,
            backpressure=BackpressureError, router=ReplicaRouter,
            edge=AnnsEdge, edge_cfg=EdgeConfig, conn=HttpConn, filters=pf)
REF = dict(bucket=RefBucket, manager=RefManager, tenant=RefTenant,
           quota=RefQuota, request=RefRequest, future=RefFuture,
           backpressure=RefBackpressure, router=RefRouter, edge=RefEdge,
           edge_cfg=RefEdgeCfg, conn=RefConn, filters=rf)


def _bucket_trace(pkg):
    clk = FakeClock()
    bucket = pkg["bucket"](rate=2.0, burst=3, clock=clk)
    out = []
    for t, op in ((0.0, "a"), (0.0, "a"), (0.0, "a"), (0.0, "a"),
                  (0.0, "r"), (0.1, "a"), (0.2, "a"), (0.7, "a"),
                  (0.9, "f"), (0.9, "a"), (5.0, "a"), (5.0, "r")):
        clk.t = t
        if op == "a":
            out.append(bucket.try_acquire())
        elif op == "f":
            bucket.refund()
        out.append(bucket.retry_after())
    free = pkg["bucket"](rate=0.0, clock=clk)
    return out, [free.try_acquire() for _ in range(5)], free.retry_after()


def test_token_bucket_matches_reference():
    assert _bucket_trace(PORT) == _bucket_trace(REF)


class _Stub:
    """Records submits; ``refuse`` makes the next submit raise
    backpressure, the futures are resolved by hand."""

    def __init__(self, pkg):
        self.pkg, self.requests, self.futs, self.refuse = pkg, [], [], False

    def submit(self, req):
        if self.refuse:
            self.refuse = False
            raise self.pkg["backpressure"]("full")
        self.requests.append(req)
        f = self.pkg["future"](tag=req.tag, blocking=True)
        self.futs.append(f)
        return f

    def drain(self):
        return []

    def stop(self):
        return self

    def live_load(self):
        return 0

    def latency_percentiles(self):
        return {"p50": 0.0, "p99": 0.0, "n": 0}

    def stats_rollup(self):
        return {"served": 0}


def _manager_trace(pkg):
    clk = FakeClock()
    f = pkg["filters"]
    stub = _Stub(pkg)
    mgr = pkg["manager"](stub, (
        pkg["tenant"]("alice", "ka", rate_qps=1.0, burst=2,
                      filter=f.Eq("cat", 1)),
        pkg["tenant"]("bob", "kb", filter=f.Eq("cat", 2))), clock=clk)
    out = []
    q = np.zeros(4, np.float32)
    for t, tenant, filt, refuse in (
            (0.0, "alice", None, False), (0.0, "alice", f.Eq("ts", 3), False),
            (0.0, "alice", None, False), (0.5, "alice", None, False),
            (1.0, "alice", None, True), (1.0, "alice", None, False),
            (1.0, "bob", f.Range("ts", 0, 9), False), (1.0, None, None, False),
            (1.0, "carol", None, False)):
        clk.t = t
        stub.refuse = refuse
        try:
            mgr.submit(pkg["request"](query=q, tenant=tenant, filter=filt))
            out.append(("ok", repr(stub.requests[-1].filter)))
        except pkg["quota"] as exc:
            out.append(("quota", exc.tenant, exc.retry_after))
        except Exception as exc:                  # noqa: BLE001
            out.append((type(exc).__name__,))
    for fut in stub.futs[:2]:
        fut._set_exception(RuntimeError("x"))
    roll = mgr.tenant_rollup()
    books = {n: {k: v for k, v in r.items() if k != "latency"}
             for n, r in roll.items()}
    return out, books, mgr.tenant_names(), repr(mgr.base_filter("alice"))


def test_tenant_manager_quotas_and_base_filters_match_reference():
    got, want = _manager_trace(PORT), _manager_trace(REF)
    assert got == want
    kinds = [o[0] for o in got[0]]
    assert "quota" in kinds and "BackpressureError" in kinds
    assert "ValueError" in kinds                  # unknown tenant refused


def test_tenants_over_real_index_match_reference(attr_pair):
    """Two tenants with disjoint base predicates over one attributed
    index: every answer is the reference's, and each tenant's ids carry
    its own category even when its request asks for the other's."""
    b, ref, idx = attr_pair
    outs = []
    for pkg, index in ((REF, ref), (PORT, idx)):
        f = pkg["filters"]
        mgr = pkg["manager"](index.make_executor(), (
            pkg["tenant"]("alice", "ka", filter=f.Eq("cat", 1)),
            pkg["tenant"]("bob", "kb", filter=f.Eq("cat", 2))))
        res = []
        for tenant, other in (("alice", 2), ("bob", 1)):
            for q in b.queries[:6]:
                for filt in (None, f.Eq("cat", other), f.Range("ts", 0, 40)):
                    res.append(mgr.submit(pkg["request"](
                        query=q, k=10, tenant=tenant,
                        filter=filt)).result(timeout=60))
        roll = mgr.stats_rollup()["tenants"]
        outs.append((res, {n: r["query_stats"] for n, r in roll.items()}))
    assert_same(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]
    n_each = len(outs[1][0]) // 2
    for i, r in enumerate(outs[1][0]):
        cat = 1 if i < n_each else 2
        assert all(int(c) % 8 == cat for c in r.ids), i


def _requests(b):
    """(method, path, body, api key) in order, over one keep-alive
    connection: the quota (alice: burst 3, no refill on the fake clock)
    runs out at alice's fourth search."""
    q = [v.tolist() for v in b.queries]
    return [
        ("POST", "/v1/search", {"query": q[0], "k": 5, "tag": "a0"}, "ka"),
        ("POST", "/v1/search", {"query": q[1], "filter": {"eq": ["ts", 7]}},
         "kb"),
        ("POST", "/v1/search", {"query": q[2], "top_n": 64}, "kb"),
        ("POST", "/v1/search", {"query": q[3], "adaptive": True,
                                "deadline_s": 60.0}, "ka"),
        ("POST", "/v1/search", {"query": q[4]}, "wrong"),
        ("POST", "/v1/search", {"query": q[4]}, None),
        ("POST", "/v1/search", {"query": q[5], "filter": {"bogus": 1}},
         "kb"),
        ("POST", "/v1/search", {"k": 3}, "kb"),
        ("POST", "/v1/search", {"query": []}, "kb"),
        ("GET", "/v1/search", None, "kb"),
        ("POST", "/v2/nothing", {}, "kb"),
        ("POST", "/v1/search", {"query": q[6], "deadline_s": 1e-9}, "kb"),
        ("POST", "/v1/search", {"query": q[7], "k": 10}, "ka"),
        ("POST", "/v1/search", {"query": q[8]}, "ka"),
        ("GET", "/v1/stats", None, None),
        ("GET", "/healthz", None, None),
        ("POST", "/v1/search", {"query": q[9], "k": 7, "tag": 9}, "kb"),
    ]


def _drive_edge(pkg, index, b):
    f = pkg["filters"]
    tenants = (pkg["tenant"]("alice", "ka", rate_qps=1.0, burst=3,
                             filter=f.Range("cat", 0, 3)),
               pkg["tenant"]("bob", "kb", filter=f.Range("cat", 2, 7)))
    router = pkg["router"](index, n_replicas=2, threaded=True, max_batch=4,
                           max_wait_s=0.0005)
    clk = FakeClock()

    async def drive():
        edge = pkg["edge"](router, pkg["edge_cfg"](tenants=tenants),
                           own_backend=True, clock=clk)
        await edge.start()
        try:
            assert edge.cfg.host == "127.0.0.1" and edge.port > 0
            conn = await pkg["conn"].open("127.0.0.1", edge.port)
            out = []
            for method, path, body, key in _requests(b):
                headers = {} if key is None else {"x-api-key": key}
                status, payload = await asyncio.wait_for(
                    conn.request(method, path, body, headers=headers), 60)
                if status == 200 and path == "/v1/search":
                    out.append((status, payload["ids"], payload["dists"],
                                payload["tenant"], payload["tag"]))
                elif status == 200:
                    out.append((status, sorted(payload)))
                else:
                    out.append((status, payload["error"]["code"]))
            await conn.aclose()
            return out, dict(edge.stats)
        finally:
            await asyncio.wait_for(edge.aclose(), 120)

    try:
        return asyncio.run(drive())
    finally:
        router.stop()


def test_edge_answers_as_reference_edge(attr_pair):
    b, ref, idx = attr_pair
    got, gstats = _drive_edge(PORT, idx, b)
    want, wstats = _drive_edge(REF, ref, b)
    assert [g[0] for g in got] == [w[0] for w in want]
    assert got == want
    assert gstats == wstats
    statuses = [g[0] for g in got]
    for code in (200, 400, 401, 404, 405, 429, 504):
        assert code in statuses, code
    assert gstats["rate_limited"] == 1 and gstats["auth_failures"] == 2


def test_edge_keepalive_burst_matches_batch_query(pair):
    """An open edge over a threaded router: 24 searches spread over three
    keep-alive connections, sent concurrently, come back with
    ``batch_query``'s ids and distances; the drain leaves nothing
    pending."""
    b, idx = pair
    router = ReplicaRouter(idx, n_replicas=2, threaded=True, max_batch=8,
                           max_wait_s=0.0005)
    qs = np.concatenate([b.queries, b.queries[:4]])

    async def drive():
        async with AnnsEdge(router, EdgeConfig(), own_backend=True) as edge:
            conns = [await HttpConn.open("127.0.0.1", edge.port)
                     for _ in range(3)]

            async def one(c, idxs):
                out = {}
                for i in idxs:
                    status, payload = await c.request(
                        "POST", "/v1/search", {"query": qs[i].tolist()})
                    assert status == 200
                    out[i] = payload
                return out

            parts = await asyncio.wait_for(asyncio.gather(*[
                one(c, range(j, len(qs), 3)) for j, c in enumerate(conns)]),
                120)
            for c in conns:
                await c.aclose()
            return {k: v for p in parts for k, v in p.items()}

    try:
        got = asyncio.run(drive())
    finally:
        router.stop()
    want = b.index.batch_query(qs)
    for i, w in enumerate(want):
        np.testing.assert_array_equal(got[i]["ids"], w.ids)
        np.testing.assert_array_equal(np.asarray(got[i]["dists"],
                                                 np.float32), w.dists)
    assert router.live_load() == 0
