"""The port's batching service against the JAX package's.

* One request stream that mixes ``k``, ``top_n``, filters, a cancelled
  request and an expired deadline goes through both packages'
  synchronous services: every request resolves alike (ids, distances,
  counters, or the same exception), and the service counters and the
  ``QueryStats`` rollup are equal.
* The threaded harness (pump + ticker threads) gives the synchronous
  harness's ids and distances on the dense, fused and int8 paths and
  with the scan split into in-flight windows; ``stop()`` leaves no
  future pending.
* Admission control (backpressure, cancel compaction) counts alike.
* Adaptive requests: with both executors' planners on one (slow) device
  model, the service's override picks the same accuracy level on both
  packages and the same answers come back.
"""

import numpy as np
import pytest

from repro.core import perf_model as ref_pm
from repro.core.futures import BackpressureError as RefBackpressure
from repro.serve.anns_service import BatchingANNSService as RefService
from repro.serve.client import SearchRequest as RefRequest
from repro_torch.core import perf_model as port_pm
from repro_torch.core.futures import BackpressureError
from repro_torch.serve.anns_service import BatchingANNSService
from repro_torch.serve.client import SearchRequest

from _torch_serving import (FAR, PER_QUERY, assert_same,  # noqa: F401
                            attr_pair, filters, pair, port_witness_guard,
                            snapshot)

SERVICE_COUNTERS = ("batches", "requests", "rejected", "expired",
                    "cancelled")


def _stream(queries):
    """(request kwargs, cancel?) per request: mixed k and top_n, three
    filters, one cancelled request and one already-expired deadline."""
    ks = [None, 1, 5, 10, 3, 7]
    tops = [None, 64, None, 32, 128, None, 16]
    out = []
    for i, q in enumerate(queries):
        kw = dict(query=q, k=ks[i % len(ks)], top_n=tops[i % len(tops)],
                  tag=i, deadline_s=FAR)
        if i == 5:
            kw["deadline_s"] = -1.0          # expired before its batch
        out.append((kw, i % 3, i == 8))
    return out


def _serve_stream(index, queries, svc_cls, req_cls, flt):
    svc = svc_cls(index, max_batch=6, max_wait_s=0.0)
    futs = []
    for kw, fi, cancel in _stream(queries):
        f = svc.submit(req_cls(filter=flt[fi], **kw))
        if cancel:
            assert f.cancel()
        futs.append(f)
    drained = svc.drain()
    out = []
    for f in futs:
        if f.cancelled():
            out.append("cancelled")
        elif f.exception(timeout=60) is not None:
            out.append(type(f.exception()).__name__)
        else:
            out.append(f.result())
    return svc, out, drained


def test_sync_service_mixed_stream_matches_reference(attr_pair):
    b, ref, idx = attr_pair
    qs = list(b.queries) + list(b.new_vecs[:4])
    fl = filters()
    rsvc, want, rdrained = _serve_stream(ref, qs, RefService, RefRequest,
                                         [f[0] for f in fl])
    psvc, got, pdrained = _serve_stream(idx, qs, BatchingANNSService,
                                        SearchRequest, [f[1] for f in fl])
    assert [w if isinstance(w, str) else "ok" for w in want] == \
        [g if isinstance(g, str) else "ok" for g in got]
    assert want[5] == "DeadlineExceeded" and want[8] == "cancelled"
    assert_same([w for w in want if not isinstance(w, str)],
                [g for g in got if not isinstance(g, str)])
    assert [r.tag for r in pdrained] == [r.tag for r in rdrained]
    assert {k: psvc.stats[k] for k in SERVICE_COUNTERS} == \
        {k: rsvc.stats[k] for k in SERVICE_COUNTERS}
    assert psvc.stats["expired"] == 1 and psvc.stats["cancelled"] == 1
    proll, rroll = psvc.stats_rollup(), rsvc.stats_rollup()
    assert proll["served"] == rroll["served"] == len(qs) - 2
    assert proll["query_stats"] == rroll["query_stats"]
    assert [g.batch_size for g in got if not isinstance(g, str)] == \
        [w.batch_size for w in want if not isinstance(w, str)]


PLANS = {"dense": {}, "fused": dict(fused=True),
         "fused_int8": dict(fused=True, lut_int8=True),
         "windows": dict(scan_window=3, inflight_depth=2)}


@pytest.mark.parametrize("plan", list(PLANS.values()), ids=list(PLANS))
def test_threaded_service_matches_sync(pair, plan):
    """Pump + ticker threads: the synchronous harness's ids and
    distances (and the reference's), whatever batches the threads form;
    ``stop()`` drains every future."""
    b, idx = pair
    qs = np.concatenate([b.queries, b.queries[::-1]])
    sync = BatchingANNSService(idx, max_batch=8, max_wait_s=0.0, **plan)
    want = [f.result() for f in [sync.submit(SearchRequest(
        query=q, k=[10, 4, 7][i % 3], deadline_s=FAR))
        for i, q in enumerate(qs)]]
    ref = RefService(b.index, max_batch=8, max_wait_s=0.0, **plan)
    ref_out = [f.result() for f in [ref.submit(RefRequest(
        query=q, k=[10, 4, 7][i % 3], deadline_s=FAR))
        for i, q in enumerate(qs)]]
    assert_same(ref_out, want)
    svc = BatchingANNSService(idx, max_batch=8, max_wait_s=0.001,
                              threaded=True, **plan)
    try:
        futs = [svc.submit(SearchRequest(query=q, k=[10, 4, 7][i % 3],
                                         deadline_s=FAR))
                for i, q in enumerate(qs)]
        got = [f.result(timeout=120) for f in futs]
    finally:
        svc.stop()
    assert all(f.done() for f in futs)
    assert_same(want, got, counters=PER_QUERY)
    assert svc.stats_rollup()["served"] == len(qs)
    assert svc.live_load() == 0 and not svc.threaded


def test_admission_control_matches_reference(pair):
    """A full queue rejects; cancelled requests compact out before the
    admission decision; counters equal on both packages."""
    b, idx = pair

    def drive(index, svc_cls, req_cls, bp_cls):
        svc = svc_cls(index, max_batch=4, max_wait_s=0.0, max_queue=3)
        futs = [svc.submit(req_cls(query=q)) for q in b.queries[:3]]
        with pytest.raises(bp_cls):
            svc.submit(req_cls(query=b.queries[3]))
        assert futs[0].cancel() and futs[1].cancel()
        assert svc.live_load() == 1
        futs.append(svc.submit(req_cls(query=b.queries[4])))   # compacts
        out = [r.ids for r in svc.drain()]
        return out, {k: svc.stats[k] for k in SERVICE_COUNTERS}

    got, pst = drive(idx, BatchingANNSService, SearchRequest,
                     BackpressureError)
    want, rst = drive(b.index, RefService, RefRequest, RefBackpressure)
    assert pst == rst and pst["rejected"] == 1 and pst["cancelled"] == 2
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _slow(pm, factor=1e5):
    """The paper testbed's model with every cost ``factor`` times larger:
    modelled latencies of seconds, so a deadline picks a reduced level
    without any request coming near it."""
    hw = pm.DeviceModel()
    return pm.DeviceModel(
        ssd_iops=hw.ssd_iops / factor, ssd_bw=hw.ssd_bw / factor,
        ssd_lat=hw.ssd_lat * factor, pcie_bw=hw.pcie_bw / factor,
        gpu_lookup_rate=hw.gpu_lookup_rate / factor,
        cpu_lookup_rate=hw.cpu_lookup_rate / factor,
        cpu_dist_rate=hw.cpu_dist_rate / factor,
        graph_hop_time=hw.graph_hop_time * factor)


def test_adaptive_requests_match_reference(pair):
    """The service's adaptive override (``top_m``/``top_n`` from the
    planner at the request's remaining deadline) and the executor's
    request path give the same answers on both packages."""
    b, idx = pair
    dim = int(idx.ssd.vectors.shape[1])
    outs = {}
    for name, index, svc_cls, req_cls, pm in (
            ("ref", b.index, RefService, RefRequest, ref_pm),
            ("port", idx, BatchingANNSService, SearchRequest, port_pm)):
        ex = index.make_executor()
        ex._planner = pm.AdaptivePlanner(index.cfg, _slow(pm), dim=dim)
        svc = svc_cls(index, executor=ex, max_batch=8, max_wait_s=0.0)
        warm = [f.result() for f in [svc.submit(req_cls(query=q))
                                     for q in b.queries[:8]]]
        d = ex._planner._demand
        lats = [pm.single_thread_latency(pm.scale_demand(d, lv),
                                         ex._planner.hw)
                for lv in pm.ACCURACY_LEVELS]
        # a deadline between the "balanced" and "fast" levels' latencies
        deadline = (lats[2] + lats[3]) / 2 / ex._planner.headroom
        sug = ex._planner.suggest(deadline)
        adaptive = [f.result() for f in [svc.submit(req_cls(
            query=q, deadline_s=deadline, adaptive=True))
            for q in b.queries[8:]]]
        direct = [ex.submit(req_cls(query=q, deadline_s=deadline,
                                    adaptive=True)).result()
                  for q in b.queries[8:12]]
        outs[name] = (warm, adaptive, direct, sug, lats)
    (rw, ra, rd, rsug, rlats), (pw, pa, pd, psug, plats) = \
        outs["ref"], outs["port"]
    assert plats == rlats and psug == rsug
    assert psug["level"] == "fast"
    assert deadline > 1.0            # seconds: no request comes near it
    assert_same(rw, pw)
    assert_same(ra, pa)
    assert_same(rd, pd)
    full = [r.stats.candidates_scanned for r in rw]
    assert np.mean([r.stats.candidates_scanned for r in pa]) < np.mean(full)
