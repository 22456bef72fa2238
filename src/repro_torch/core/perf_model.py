"""Analytic device model: turns the *measured* per-query I/O counts, byte
volumes and compute demands into QPS/latency curves vs thread count (the
port's copy of ``repro.core.perf_model``, equal to the float).

``DeviceModel``'s defaults model the PAPER'S testbed, not the card the
port runs on and not a TPU: Samsung 990Pro (~1.2M IOPS 4K rand,
~7 GB/s), PCIe 3.0 x16 (~12 GB/s effective), V100 HBM2 (900 GB/s),
64-core Xeon.  They are the reference's values, kept so that the
adaptive planner and the autoscaler's bound decide as the reference's
do; H100 rates belong here only once measured on one.

Throughput: each resource r has capacity C_r and per-query demand d_r;
QPS(T) = min(T / L_1, min_r C_r / d_r) where L_1 is the single-thread
latency; latency(T) = T / QPS(T) (Little's law) — matching the paper's
observation that SPANN saturates SSD *bandwidth* at 4 threads while
FusionANNS rides the IOPS/PCIe-light path to 64.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.analysis.concurrency.witness import make_lock


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    ssd_iops: float = 1.2e6            # 4K random read command rate
    ssd_bw: float = 7.0e9              # B/s
    ssd_lat: float = 60e-6             # s per command (QD1)
    pcie_bw: float = 12.0e9            # B/s host<->accelerator
    gpu_lookup_rate: float = 2.0e11    # ADC LUT lookups/s (HBM-bw bound)
    cpu_lookup_rate: float = 5.0e7     # per-thread ADC lookups/s — random
    #                                    DRAM access bound (the paper's §2.2
    #                                    argument for GPU placement)
    cpu_dist_rate: float = 2.0e9       # per-thread f32 mul-adds/s
    graph_hop_time: float = 1.5e-6     # s per navgraph hop (measured-ish)
    n_threads_max: int = 64


@dataclasses.dataclass
class QueryDemand:
    """Per-query resource demands (from measured engine stats).

    ssd_requests = discrete I/O commands (what IOPS/latency bind on);
    ssd_ios      = 4 KB pages touched (the Fig. 12c "I/O numbers" metric);
    for random-4K systems the two coincide."""

    ssd_ios: float = 0.0
    ssd_requests: float = -1.0         # -1 -> same as ssd_ios
    ssd_bytes: float = 0.0
    h2d_bytes: float = 0.0
    gpu_lookups: float = 0.0           # M lookups per scanned candidate
    cpu_lookups: float = 0.0           # CPU-side ADC (MI(CPU) variant)
    cpu_dist_ops: float = 0.0          # exact-distance mul-adds (rerank etc.)
    graph_hops: float = 0.0

    @property
    def requests(self) -> float:
        return self.ssd_ios if self.ssd_requests < 0 else self.ssd_requests


def demand_from_stats(totals: Dict[str, float], n: float, *, pq_m: int,
                      dim: int, top_m: int) -> QueryDemand:
    """Mean per-query demand from summed ``QueryStats`` counters covering
    ``n`` responses — the ONE stats-to-demand conversion, used by the
    router's replica-scaling sweep (``ReplicaRouter.measured_demand``)
    and the adaptive planner."""
    n = max(n, 1)
    return QueryDemand(
        ssd_ios=totals["ios"] / n,
        ssd_bytes=totals["ssd_bytes"] / n,
        h2d_bytes=totals["h2d_bytes"] / n,
        gpu_lookups=totals["candidates_scanned"] / n * pq_m,
        cpu_dist_ops=totals["rerank_scored"] / n * dim,
        graph_hops=2.0 * top_m)


def single_thread_latency(d: QueryDemand, hw: DeviceModel) -> float:
    io = d.requests * hw.ssd_lat + d.ssd_bytes / hw.ssd_bw
    pcie = d.h2d_bytes / hw.pcie_bw
    gpu = d.gpu_lookups / hw.gpu_lookup_rate
    cpu = (d.cpu_lookups / hw.cpu_lookup_rate
           + d.cpu_dist_ops / hw.cpu_dist_rate
           + d.graph_hops * hw.graph_hop_time)
    return io + pcie + gpu + cpu


def qps_at_threads(d: QueryDemand, hw: DeviceModel, threads: int) -> float:
    l1 = single_thread_latency(d, hw)
    caps = []
    if d.requests:
        caps.append(hw.ssd_iops / d.requests)
    if d.ssd_bytes:
        caps.append(hw.ssd_bw / d.ssd_bytes)
    if d.h2d_bytes:
        caps.append(hw.pcie_bw / d.h2d_bytes)
    if d.gpu_lookups:
        caps.append(hw.gpu_lookup_rate / d.gpu_lookups)
    cpu_time = (d.cpu_lookups / hw.cpu_lookup_rate
                + d.cpu_dist_ops / hw.cpu_dist_rate
                + d.graph_hops * hw.graph_hop_time)
    if cpu_time:
        caps.append(threads / cpu_time)
    caps.append(threads / max(l1, 1e-12))
    return min(caps)


def latency_at_threads(d: QueryDemand, hw: DeviceModel, threads: int) -> float:
    return threads / max(qps_at_threads(d, hw, threads), 1e-9)


def sweep_threads(d: QueryDemand, hw: DeviceModel,
                  threads=(1, 2, 4, 8, 16, 32, 64)) -> Dict[int, Dict]:
    return {t: {"qps": qps_at_threads(d, hw, t),
                "latency_ms": 1e3 * latency_at_threads(d, hw, t)}
            for t in threads}


def qps_at_replicas(d: QueryDemand, hw: DeviceModel, n_replicas: int,
                    threads_per_replica: int = 8) -> float:
    """Multi-replica operating point: ``n_replicas`` replicas, each on its
    own device group (the model's premise; serve/router.py), each running
    its own pump + ``threads_per_replica`` host serving threads.

    Accelerator-side capacities SCALE with replicas — every group brings
    its own HBM slice and host<->device links (gpu_lookup_rate, pcie_bw
    x n) — while the box's SSD is shared and host threads total
    ``n x t``.  QPS therefore rides ``n x t / L_1`` until a shared
    resource binds, which is the router's whole premise: replicas add
    serving-pipeline concurrency, not index capacity."""
    caps = [hw.ssd_iops / d.requests if d.requests else np.inf,
            hw.ssd_bw / d.ssd_bytes if d.ssd_bytes else np.inf,
            n_replicas * hw.pcie_bw / d.h2d_bytes if d.h2d_bytes
            else np.inf,
            n_replicas * hw.gpu_lookup_rate / d.gpu_lookups
            if d.gpu_lookups else np.inf]
    threads = n_replicas * threads_per_replica
    cpu_time = (d.cpu_lookups / hw.cpu_lookup_rate
                + d.cpu_dist_ops / hw.cpu_dist_rate
                + d.graph_hops * hw.graph_hop_time)
    if cpu_time:
        caps.append(threads / cpu_time)
    caps.append(threads / max(single_thread_latency(d, hw), 1e-12))
    return float(min(caps))


def sweep_replicas(d: QueryDemand, hw: DeviceModel,
                   replicas=(1, 2, 4),
                   threads_per_replica: int = 8) -> Dict[int, float]:
    return {n: qps_at_replicas(d, hw, n, threads_per_replica)
            for n in replicas}


def max_useful_replicas(d: QueryDemand, hw: DeviceModel, *,
                        threads_per_replica: int = 8,
                        min_gain: float = 1.02, cap: int = 64) -> int:
    """The autoscaler's sanity bound (serve/autoscaler.py): the largest
    replica count at which adding one more replica still improves modelled
    QPS by at least ``min_gain``x.  Past this point a SHARED resource
    (SSD IOPS/bandwidth in this model) binds, so growing the replica set
    burns devices without serving more traffic — the autoscaler never
    scales above it no matter what the load signals say."""
    n = 1
    prev = qps_at_replicas(d, hw, 1, threads_per_replica)
    while n < cap:
        nxt = qps_at_replicas(d, hw, n + 1, threads_per_replica)
        if prev <= 0 or nxt < prev * min_gain:
            break
        prev, n = nxt, n + 1
    return n


# ---------------------------------------------------------------------------
# Deadline-adaptive accuracy (DESIGN.md §11)
# ---------------------------------------------------------------------------
#
# The paper's Fig. 10 exposes accuracy as a runtime knob (heuristic
# re-rank depth / int8 LUTs); here the SAME knob becomes a per-request
# resolver: pick the most accurate level whose MODELED single-thread
# latency fits the request's ``deadline_s``.  ``top_m_frac`` scales the
# graph traversal + scan-side demands (posting lists visited -> union
# size -> H2D bytes + ADC lookups), ``top_n_frac`` the re-rank-side
# demands (SSD I/O + exact distances).

@dataclasses.dataclass(frozen=True)
class AccuracyLevel:
    name: str
    top_m_frac: float
    top_n_frac: float


# most-accurate-first: the resolver returns the FIRST level that fits,
# so an easy deadline always gets full accuracy
ACCURACY_LEVELS: Tuple[AccuracyLevel, ...] = (
    AccuracyLevel("full", 1.0, 1.0),
    AccuracyLevel("high", 0.75, 0.75),
    AccuracyLevel("balanced", 0.5, 0.5),
    AccuracyLevel("fast", 0.25, 0.25),
    AccuracyLevel("turbo", 0.125, 0.125),
)


def scale_demand(d: QueryDemand, level: AccuracyLevel,
                 selectivity: float = 1.0) -> QueryDemand:
    """Predicted demand at a reduced accuracy level.  ``selectivity``
    (scanned/prefilter candidate ratio, <= 1) lets a caller predict a
    FILTERED workload's demand from unfiltered measurements — both scan
    and re-rank work shrink with it, because filtering happens at
    candidate collection (not post-top-k)."""
    m = level.top_m_frac * selectivity
    n = level.top_n_frac * selectivity
    return QueryDemand(
        ssd_ios=d.ssd_ios * n,
        ssd_requests=(d.ssd_requests if d.ssd_requests < 0
                      else d.ssd_requests * n),
        ssd_bytes=d.ssd_bytes * n,
        h2d_bytes=d.h2d_bytes * m,
        gpu_lookups=d.gpu_lookups * m,
        cpu_lookups=d.cpu_lookups * m,
        cpu_dist_ops=d.cpu_dist_ops * n,
        graph_hops=d.graph_hops * level.top_m_frac)


def resolve_accuracy(deadline_s: float, demand: QueryDemand,
                     hw: DeviceModel, *, selectivity: float = 1.0,
                     levels: Tuple[AccuracyLevel, ...] = ACCURACY_LEVELS,
                     headroom: float = 1.0) -> AccuracyLevel:
    """The most accurate level whose modeled latency fits
    ``deadline_s * headroom``; the cheapest level when none does (a
    best-effort answer beats none — the deadline machinery downstream
    still expires truly hopeless requests)."""
    for level in levels:
        lat = single_thread_latency(
            scale_demand(demand, level, selectivity), hw)
        if lat <= deadline_s * headroom:
            return level
    return levels[-1]


class AdaptivePlanner:
    """Observes served ``QueryStats`` and suggests per-request plan
    overrides that the device model predicts meet a deadline.

    Holds an EWMA of per-query demand (at whatever accuracy recent
    traffic ran) plus the observed filter selectivity; ``suggest()``
    resolves an accuracy level against that baseline and converts its
    fractions into concrete ``top_m``/``top_n`` values.  Thread-safe:
    one ``executor``-ranked lock over the EWMA state — callers must not
    hold another executor-rank lock (same-rank nesting is a witnessed
    lock-order violation)."""

    def __init__(self, cfg, hw: Optional[DeviceModel] = None, *, dim: int,
                 pq_m: Optional[int] = None, alpha: float = 0.25,
                 headroom: float = 0.9):
        self.cfg = cfg
        self.hw = hw if hw is not None else DeviceModel()
        self.dim = int(dim)
        self.pq_m = int(cfg.pq_m if pq_m is None else pq_m)
        self.alpha = float(alpha)
        self.headroom = float(headroom)
        self._lock = make_lock("executor")
        self._demand: Optional[QueryDemand] = None  # guarded-by: _lock
        self._selectivity = 1.0                     # guarded-by: _lock
        self._n_observed = 0                        # guarded-by: _lock

    def observe(self, stats) -> None:
        """Fold one served query's ``QueryStats`` into the EWMA."""
        totals = {"ios": stats.ios, "ssd_bytes": stats.ssd_bytes,
                  "h2d_bytes": stats.h2d_bytes,
                  "candidates_scanned": stats.candidates_scanned,
                  "rerank_scored": stats.rerank_scored}
        d = demand_from_stats(totals, 1, pq_m=self.pq_m, dim=self.dim,
                              top_m=self.cfg.top_m)
        sel = (stats.candidates_scanned
               / max(stats.candidates_prefilter, 1))
        a = self.alpha
        with self._lock:  # acquires: executor
            if self._demand is None:
                self._demand = d
                self._selectivity = sel
            else:
                prev = self._demand
                self._demand = QueryDemand(**{
                    f.name: (1 - a) * getattr(prev, f.name)
                    + a * getattr(d, f.name)
                    for f in dataclasses.fields(QueryDemand)})
                self._selectivity = (1 - a) * self._selectivity + a * sel
            self._n_observed += 1

    def suggest(self, deadline_s: Optional[float]) -> Optional[Dict]:
        """Plan override for one request, or None when no adaptation is
        needed (no deadline, nothing observed yet, or full accuracy
        already fits).  The observed demand already reflects the live
        selectivity, so the resolver runs at selectivity=1."""
        if deadline_s is None:
            return None
        with self._lock:  # acquires: executor
            d = self._demand
            sel = self._selectivity
        if d is None:
            return None
        level = resolve_accuracy(deadline_s, d, self.hw,
                                 headroom=self.headroom)
        if level.top_m_frac >= 1.0 and level.top_n_frac >= 1.0:
            return None
        return {"level": level.name,
                "selectivity": sel,
                "top_m": max(1, int(round(self.cfg.top_m
                                          * level.top_m_frac))),
                "top_n": max(self.cfg.top_k,
                             int(round(self.cfg.top_n
                                       * level.top_n_frac)))}
