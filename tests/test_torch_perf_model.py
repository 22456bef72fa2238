"""The port's analytic device model and deadline-adaptive planner against
the JAX package's, equal to the float.

Seeded demands and stats go through both packages' ``core.perf_model``;
every function must return the same floats (``==``, not approx), the
same accuracy level and the same ``AdaptivePlanner.suggest`` dicts.  The
executors' lazy ``planner`` must observe served requests alike.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import perf_model as ref
from repro.serve.client import SearchRequest as RefRequest
from repro_torch.core import perf_model as port
from repro_torch.serve.client import SearchRequest

from _torch_serving import FAR, pair, port_witness_guard, snapshot  # noqa: F401


def _demand_fields(rng):
    return dict(ssd_ios=float(rng.integers(1, 800)),
                ssd_requests=float(rng.choice([-1.0, rng.integers(1, 400)])),
                ssd_bytes=float(rng.integers(0, 3_000_000)),
                h2d_bytes=float(rng.integers(0, 5_000_000)),
                gpu_lookups=float(rng.integers(0, 10_000_000)),
                cpu_lookups=float(rng.choice([0.0, rng.integers(1, 10**6)])),
                cpu_dist_ops=float(rng.integers(0, 10**6)),
                graph_hops=float(rng.integers(0, 300)))


DEMANDS = [_demand_fields(np.random.default_rng(s)) for s in range(6)]
HWS = [{}, dict(ssd_iops=2e5, ssd_lat=1e-4), dict(pcie_bw=1e9,
                                                  gpu_lookup_rate=1e9)]


def _pair(fields, hw):
    return ((ref.QueryDemand(**fields), ref.DeviceModel(**hw)),
            (port.QueryDemand(**fields), port.DeviceModel(**hw)))


def _as_dict(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


@pytest.mark.parametrize("fn, args", [
    ("single_thread_latency", ()),
    ("qps_at_threads", (1,)), ("qps_at_threads", (64,)),
    ("latency_at_threads", (8,)),
    ("sweep_threads", ()),
    ("qps_at_replicas", (1,)), ("qps_at_replicas", (3, 16)),
    ("sweep_replicas", ()),
    ("max_useful_replicas", ()),
], ids=lambda v: v if isinstance(v, str) else str(v))
def test_device_model_functions_equal(fn, args):
    for fields in DEMANDS:
        for hw in HWS:
            (rd, rhw), (pd, phw) = _pair(fields, hw)
            assert getattr(port, fn)(pd, phw, *args) == \
                getattr(ref, fn)(rd, rhw, *args), (fields, hw)


@pytest.mark.parametrize("fields", DEMANDS[:3], ids=["d0", "d1", "d2"])
def test_accuracy_resolution_equal(fields):
    (rd, rhw), (pd, phw) = _pair(fields, {})
    assert [dataclasses.asdict(lv) for lv in port.ACCURACY_LEVELS] == \
        [dataclasses.asdict(lv) for lv in ref.ACCURACY_LEVELS]
    for r_lv, p_lv in zip(ref.ACCURACY_LEVELS, port.ACCURACY_LEVELS):
        for sel in (1.0, 0.37):
            assert _as_dict(port.scale_demand(pd, p_lv, sel)) == \
                _as_dict(ref.scale_demand(rd, r_lv, sel))
    lat = ref.single_thread_latency(rd, rhw)
    for dl in (10.0, lat, lat / 2, lat / 5, lat / 20, 1e-9):
        for sel, head in ((1.0, 1.0), (0.5, 0.9)):
            assert port.resolve_accuracy(dl, pd, phw, selectivity=sel,
                                         headroom=head).name == \
                ref.resolve_accuracy(dl, rd, rhw, selectivity=sel,
                                     headroom=head).name


def test_demand_from_stats_equal():
    rng = np.random.default_rng(3)
    for _ in range(5):
        totals = {f: int(rng.integers(0, 10**6)) for f in
                  ("ios", "ssd_bytes", "h2d_bytes", "candidates_scanned",
                   "rerank_scored")}
        n = float(rng.integers(0, 50))
        kw = dict(pq_m=int(rng.integers(4, 64)), dim=int(rng.integers(8, 960)),
                  top_m=int(rng.integers(1, 128)))
        assert _as_dict(port.demand_from_stats(totals, n, **kw)) == \
            _as_dict(ref.demand_from_stats(totals, n, **kw))


def _stats_seq(rng, n):
    from types import SimpleNamespace
    out = []
    for _ in range(n):
        pre = int(rng.integers(100, 50_000))
        out.append(SimpleNamespace(
            ios=int(rng.integers(1, 600)),
            ssd_bytes=int(rng.integers(4096, 3_000_000)),
            h2d_bytes=int(rng.integers(0, 4_000_000)),
            candidates_scanned=int(rng.integers(1, pre + 1)),
            candidates_prefilter=pre,
            rerank_scored=int(rng.integers(1, 4096))))
    return out


@pytest.mark.parametrize("alpha, headroom", [(0.25, 0.9), (0.6, 1.0)])
def test_adaptive_planner_suggest_equal(anns_bundle, alpha, headroom):
    """Both planners observe the same stats stream; after each observation
    ``suggest`` gives the same dict at deadlines spanning every level."""
    cfg = anns_bundle.cfg
    from repro_torch.configs.base import ANNSConfig
    pcfg = ANNSConfig(**dataclasses.asdict(cfg))
    rp = ref.AdaptivePlanner(cfg, dim=32, alpha=alpha, headroom=headroom)
    pp = port.AdaptivePlanner(pcfg, dim=32, alpha=alpha, headroom=headroom)
    assert pp.suggest(1e-3) is None and rp.suggest(1e-3) is None
    for st in _stats_seq(np.random.default_rng(7), 12):
        rp.observe(st)
        pp.observe(st)
        lat = ref.single_thread_latency(rp._demand, rp.hw)
        for dl in (None, 60.0, lat, lat / 2, lat / 3, lat / 6, lat / 50):
            assert pp.suggest(dl) == rp.suggest(dl), dl
        assert _as_dict(pp._demand) == _as_dict(rp._demand)
        assert pp._selectivity == rp._selectivity


def test_executor_planner_observes_served_requests(pair):
    """Served request-path responses feed both executors' lazy planners
    identically (the same EWMA demand, the same suggestions)."""
    b, idx = pair
    rex, pex = b.index.make_executor(), idx.make_executor()
    assert rex.planner.pq_m == pex.planner.pq_m
    for q in b.queries[:6]:
        r = rex.submit(RefRequest(query=q, deadline_s=FAR)).result()
        p = pex.submit(SearchRequest(query=q, deadline_s=FAR)).result()
        np.testing.assert_array_equal(p.ids, r.ids)
    assert _as_dict(pex.planner._demand) == _as_dict(rex.planner._demand)
    lat = ref.single_thread_latency(rex.planner._demand, rex.planner.hw)
    for dl in (lat, lat / 3, lat / 10):
        assert pex.planner.suggest(dl) == rex.planner.suggest(dl)
