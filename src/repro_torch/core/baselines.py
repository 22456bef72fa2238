"""Baseline ANNS systems the paper compares against (§2.3, §6),
implemented over the same substrate so I/O counts and byte volumes are
apples-to-apples (the port's counterpart of ``repro.core.baselines``):

  * SPANN-like      — posting lists (raw vectors) on SSD, exact distances
  * HI+GPU          — SPANN + accelerator distances (lists cross PCIe)
  * HI+PQ           — PQ-compressed lists on SSD, CPU ADC + re-rank
  * HI+PQ+GPU       — compressed lists -> PCIe -> accelerator ADC + re-rank
  * RUMMY-like      — all in host memory, lists cross PCIe per query
  * DiskANN-like    — graph on SSD, one page per visited node

Each query returns (ids, QueryStats-compatible demand numbers).  They are
host numpy over the port's tiers; HI+PQ's lookup table is built by
``pq.adc_lut`` on the index's device.  ``data`` is indexed as the
index's posting members are: by physical row (equal to the id on an
index no seal has purged)."""

from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

import numpy as np
import torch

from repro_torch.core import navgraph as ng, pq
from repro_torch.core.engine import FusionANNSIndex, resolve_device
from repro_torch.core.io_sim import (IOStats, PostingListStore, SSDSim,
                                     StorageLayout)
from repro_torch.core.perf_model import QueryDemand


@dataclasses.dataclass
class BaselineResult:
    ids: np.ndarray
    demand: QueryDemand
    io: IOStats


def _exact_topk(query, vecs, ids, k):
    d = np.sum((vecs.astype(np.float32) - query.astype(np.float32)) ** 2, -1)
    order = np.argsort(d)[:k]
    return ids[order]


class SpannLike:
    """Hierarchical indexing only: navgraph -> read top-m raw posting lists
    from SSD -> exact distances on CPU."""

    def __init__(self, index: FusionANNSIndex, data: np.ndarray):
        self.index = index
        self.data = data
        cfg = index.cfg
        entry_bytes = data.dtype.itemsize * data.shape[1] + 4
        self.store = PostingListStore.build(
            [len(m) for m in index.posting.members], entry_bytes,
            cfg.page_bytes)

    def query(self, q: np.ndarray, k: int, top_m: int) -> BaselineResult:
        cids = ng.search(self.index.graph, q.astype(np.float32), top_m)
        stats = IOStats()
        self.store.read_lists(cids, stats)
        ids = np.concatenate([self.index.posting.members[c] for c in cids])
        ids = np.unique(ids)
        out = _exact_topk(q, self.data[ids], ids, k)
        demand = QueryDemand(
            ssd_ios=stats.pages_requested,        # pages touched (Fig. 12c)
            ssd_requests=stats.ios,               # large sequential reads
            ssd_bytes=stats.bytes_read,
            cpu_dist_ops=len(ids) * self.data.shape[1],
            graph_hops=top_m * 2)
        return BaselineResult(out, demand, stats)


class HIGpu(SpannLike):
    """SPANN + GPU distances: raw lists also cross PCIe (cudaMemcpy)."""

    def query(self, q, k, top_m):
        r = super().query(q, k, top_m)
        d = r.demand
        vec_bytes = self.data.dtype.itemsize * self.data.shape[1]
        n_cand = d.cpu_dist_ops / self.data.shape[1]
        r.demand = QueryDemand(
            ssd_ios=d.ssd_ios, ssd_requests=d.ssd_requests,
            ssd_bytes=d.ssd_bytes,
            h2d_bytes=n_cand * vec_bytes,
            gpu_lookups=n_cand * self.data.shape[1],  # dist on accelerator
            graph_hops=d.graph_hops)
        return r


class HIPq:
    """PQ-compressed posting lists on SSD; CPU ADC; re-rank over the
    *straw-man* raw layout (no bucketing, no dedup) — §2.3's combination."""

    def __init__(self, index: FusionANNSIndex, data: np.ndarray,
                 gpu: bool = False):
        self.index = index
        self.data = data
        self.gpu = gpu
        cfg = index.cfg
        self.codes_np = index.codes.cpu().numpy()
        self.store = PostingListStore.build(
            [len(m) for m in index.posting.members], cfg.pq_m + 4,
            cfg.page_bytes)
        # straw-man raw-vector layout: insertion order, no page sharing
        layout = StorageLayout.build(
            index.posting.primary, index.posting.n_clusters,
            vec_bytes=data.dtype.itemsize * data.shape[1],
            page_bytes=cfg.page_bytes, optimized=False)
        self.raw = SSDSim(data, layout, buffer_pages=0,
                          intra_merge=False, use_buffer=False)

    def query(self, q, k, top_m, top_n) -> BaselineResult:
        cfg = self.index.cfg
        cids = ng.search(self.index.graph, q.astype(np.float32), top_m)
        stats = IOStats()
        self.store.read_lists(cids, stats)           # compressed lists I/O
        ids = np.unique(np.concatenate(
            [self.index.posting.members[c] for c in cids]))
        lut = pq.adc_lut(self.index.codebook, torch.from_numpy(
            np.asarray(q)).to(self.index.device)).cpu().numpy()
        codes = self.codes_np[ids]
        dist = lut[np.arange(cfg.pq_m)[None, :], codes.astype(np.int32)] \
            .sum(-1)
        order = ids[np.argsort(dist)[:top_n]]
        # fixed-size re-rank (no heuristic early stop), straw-man layout
        rstats = self.raw.begin_query()
        vecs = self.raw.fetch(order, rstats)
        out = _exact_topk(q, vecs, order, k)
        io = stats.merge(rstats)
        demand = QueryDemand(
            ssd_ios=io.pages_requested,
            ssd_requests=stats.ios + rstats.ios,
            ssd_bytes=io.bytes_read,
            h2d_bytes=(len(ids) * cfg.pq_m if self.gpu else 0),
            gpu_lookups=(len(ids) * cfg.pq_m if self.gpu else 0),
            cpu_lookups=(0 if self.gpu else len(ids) * cfg.pq_m),
            cpu_dist_ops=len(order) * self.data.shape[1],
            graph_hops=top_m * 2)
        return BaselineResult(out, demand, io)


class RummyLike:
    """GPU-accelerated in-memory IVF: no SSD I/O, but the selected raw
    posting lists cross PCIe every query (the reordered-pipelining system's
    steady-state traffic)."""

    def __init__(self, index: FusionANNSIndex, data: np.ndarray):
        self.index = index
        self.data = data

    def query(self, q, k, top_m) -> BaselineResult:
        cids = ng.search(self.index.graph, q.astype(np.float32), top_m)
        ids = np.unique(np.concatenate(
            [self.index.posting.members[c] for c in cids]))
        out = _exact_topk(q, self.data[ids], ids, k)
        vec_bytes = self.data.dtype.itemsize * self.data.shape[1]
        demand = QueryDemand(
            h2d_bytes=len(ids) * vec_bytes,
            gpu_lookups=len(ids) * self.data.shape[1],
            graph_hops=top_m * 2)
        return BaselineResult(out, demand, IOStats())


class DiskAnnLike:
    """Graph-based on-SSD search: one 4 KB page per visited node (vector +
    adjacency in the node record), best-first beam search.  The exact kNN
    graph is built on ``device`` (None: the card)."""

    def __init__(self, data: np.ndarray, degree: int = 32,
                 seed: int = 0, sample_build: Optional[int] = None, *,
                 device=None):
        self.data = data.astype(np.float32)
        # exact kNN graph (chunked brute force) — the search I/O behaviour
        # is what the comparison needs, not Vamana's build heuristics
        self.graph = ng.knn_graph_exact(self.data, resolve_device(device),
                                        degree=degree)

    def query(self, q, k, ef: int = 128) -> BaselineResult:
        points, neighbors = self.graph.points, self.graph.neighbors
        visited = set()
        cand, best = [], []
        ios = 0
        for entry in self.graph.seed_beam(q):
            entry = int(entry)
            visited.add(entry)
            d0 = float(np.sum((points[entry] - q) ** 2))
            heapq.heappush(cand, (d0, entry))
            heapq.heappush(best, (-d0, entry))
            ios += 1
        while cand:
            dist, u = heapq.heappop(cand)
            if len(best) >= ef and dist > -best[0][0]:
                break
            for v in neighbors[u]:
                if v < 0 or v in visited:
                    continue
                visited.add(int(v))
                ios += 1                       # each node record = 1 page
                dv = float(np.sum((points[v] - q) ** 2))
                if len(best) < ef or dv < -best[0][0]:
                    heapq.heappush(cand, (dv, int(v)))
                    heapq.heappush(best, (-dv, int(v)))
                    if len(best) > ef:
                        heapq.heappop(best)
        out = sorted(((-nd, v) for nd, v in best))[:k]
        ids = np.array([v for _, v in out], np.int64)
        demand = QueryDemand(ssd_ios=ios, ssd_bytes=ios * 4096,
                             cpu_dist_ops=ios * self.data.shape[1],
                             graph_hops=ios)
        return BaselineResult(ids, demand, IOStats(ios=ios,
                                                   bytes_read=ios * 4096))
