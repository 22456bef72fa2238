"""In-memory navigation graph over posting-list centroids (paper §4.1).

Vertices are the posting-list centroids.  Up to 50,000 of them each links
to its exact top-``degree`` nearest, the distance blocks in torch on
``device``; above that, the SPTAG-flavoured incremental build of the JAX
package (vertices added one by one, linked to the top-R nearest that a
search of the partial graph finds, neighbours back-updated under a
max-degree cap), host numpy transcribed as it is, so its neighbours equal
the reference's.  Search is best-first beam search on the host (the CPU
stage ② of the online pipeline), exactly as in the paper and the JAX
package.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.clustering import _kmeans, _nearest, sq_dists

# the exact kNN build is O(C²): above this many vertices the build is
# incremental
MAX_EXACT_VERTICES = 50_000


@dataclasses.dataclass
class NavGraph:
    points: np.ndarray                 # (C, D) centroids
    neighbors: np.ndarray              # (C, R) int32, -1 padded
    entry: int                         # search entry point (medoid-ish)
    # SPTAG pairs the graph with space-partition TREES that provide seeds
    # for traversal; a kNN graph over tight clusters is otherwise a set of
    # disconnected cliques.  Stand-in with the same O(sqrt(C)) lookup and
    # geometric coverage: a 2-level k-means hierarchy over the vertices —
    # query -> nearest super-centroids -> their member vertices as seeds.
    super_centroids: Optional[np.ndarray] = None   # (S, D)
    super_assign: Optional[np.ndarray] = None      # (C,) vertex -> super

    def seed_beam(self, query: np.ndarray, n_super: int = 3,
                  per_super: int = 3) -> np.ndarray:
        if self.super_centroids is None:
            return np.array([self.entry], np.int64)
        ds = np.sum((self.super_centroids - query) ** 2, -1)
        out = [np.array([self.entry], np.int64)]
        for s in np.argsort(ds)[:n_super]:
            members = np.where(self.super_assign == s)[0]
            if not len(members):
                continue
            dm = np.sum((self.points[members] - query) ** 2, -1)
            out.append(members[np.argsort(dm)[:per_super]])
        return np.unique(np.concatenate(out))


def _seed_tree(points: np.ndarray, device: torch.device):
    """2-level k-means hierarchy (the SPTAG-tree stand-in)."""
    c = len(points)
    s = max(2, int(np.ceil(np.sqrt(c))))
    rng = np.random.default_rng(0)
    supers = _kmeans(rng, points.astype(np.float32), s, device, iters=6)
    return supers, _nearest(points, supers, device).astype(np.int32)


def knn_graph_exact(points: np.ndarray, device: torch.device,
                    degree: int = 32, chunk: int = 2048) -> NavGraph:
    """Exact kNN graph via chunked brute force."""
    c = len(points)
    r = min(degree, c - 1)
    neighbors = np.empty((c, r), np.int32)
    pts = torch.from_numpy(np.ascontiguousarray(points, np.float32)).to(
        device)
    for s in range(0, c, chunk):
        d2 = sq_dists(points[s:s + chunk], pts)
        rows = torch.arange(d2.shape[0], device=device)
        d2[rows, s + rows] = float("inf")
        neighbors[s:s + chunk] = torch.topk(
            d2, r, dim=1, largest=False, sorted=True)[1].cpu().numpy()
    entry = int(np.argmin(np.sum(
        (points - points.mean(0, keepdims=True)) ** 2, -1)))
    supers, assign = _seed_tree(points, device)
    return NavGraph(points=points.astype(np.float32), neighbors=neighbors,
                    entry=entry, super_centroids=supers, super_assign=assign)


def build_navgraph(points: np.ndarray, degree: int = 32,
                   ef_build: int = 64, *,
                   device: torch.device) -> NavGraph:
    """Navigation-graph construction.

    <= 50k vertices: exact kNN adjacency on ``device`` — highest quality,
    matmul-fast.  Beyond that, SPTAG-style incremental insertion where
    each vertex links to its top-``degree`` nearest found by seeded graph
    search over the partial graph (a per-vertex Python loop on the host;
    the O(C²) exact build is out of reach there)."""
    if len(points) <= MAX_EXACT_VERTICES:
        return knn_graph_exact(points.astype(np.float32), device,
                               degree=degree)
    c, d = points.shape
    r = min(degree, max(c - 1, 1))
    nbrs: List[List[Tuple[float, int]]] = [[] for _ in range(c)]

    def link(u: int, v: int, dist: float) -> None:
        lst = nbrs[u]
        heapq.heappush(lst, (-dist, v))
        if len(lst) > r:
            heapq.heappop(lst)             # drop farthest

    bootstrap = min(c, 2 * r)
    for i in range(1, c):
        if i <= bootstrap:
            cand = np.arange(i)
        else:
            cand = _search_ids(points, nbrs, points[i], ef_build, entry=0)
        dd = np.sum((points[cand] - points[i]) ** 2, -1)
        order = np.argsort(dd)[:r]
        for j in order:
            v, dist = int(cand[j]), float(dd[j])
            link(i, v, dist)
            link(v, i, dist)

    neighbors = np.full((c, r), -1, np.int32)
    for i, lst in enumerate(nbrs):
        ids = [v for _, v in sorted(lst, reverse=True)]
        neighbors[i, :len(ids)] = ids[:r]
    entry = int(np.argmin(np.sum(
        (points - points.mean(0, keepdims=True)) ** 2, -1)))
    supers, assign = _seed_tree(points, device)
    return NavGraph(points=points, neighbors=neighbors, entry=entry,
                    super_centroids=supers, super_assign=assign)


def _search_ids(points, nbrs_dyn, query, ef, entry=0) -> np.ndarray:
    """Best-first search over the under-construction adjacency (build
    helper)."""
    visited = {entry}
    d0 = float(np.sum((points[entry] - query) ** 2))
    cand = [(d0, entry)]
    best = [(-d0, entry)]
    while cand:
        dist, u = heapq.heappop(cand)
        if dist > -best[0][0] and len(best) >= ef:
            break
        for _, v in nbrs_dyn[u]:
            if v in visited:
                continue
            visited.add(v)
            dv = float(np.sum((points[v] - query) ** 2))
            if len(best) < ef or dv < -best[0][0]:
                heapq.heappush(cand, (dv, v))
                heapq.heappush(best, (-dv, v))
                if len(best) > ef:
                    heapq.heappop(best)
    return np.array([v for _, v in best], np.int64)


def search(graph: NavGraph, query: np.ndarray, top_m: int,
           ef: Optional[int] = None) -> np.ndarray:
    """CPU best-first beam search -> ids of the top-m nearest centroids
    (online stage ②).  ef defaults to 2*top_m."""
    ef = ef or max(2 * top_m, 32)
    points, neighbors = graph.points, graph.neighbors
    visited = np.zeros(len(points), bool)
    cand: List[Tuple[float, int]] = []
    best: List[Tuple[float, int]] = []
    for entry in graph.seed_beam(query):
        entry = int(entry)
        visited[entry] = True
        d0 = float(np.sum((points[entry] - query) ** 2))
        heapq.heappush(cand, (d0, entry))
        heapq.heappush(best, (-d0, entry))
    while cand:
        dist, u = heapq.heappop(cand)
        if len(best) >= ef and dist > -best[0][0]:
            break
        for v in neighbors[u]:
            if v < 0 or visited[v]:
                continue
            visited[v] = True
            dv = float(np.sum((points[v] - query) ** 2))
            if len(best) < ef or dv < -best[0][0]:
                heapq.heappush(cand, (dv, v))
                heapq.heappush(best, (-dv, v))
                if len(best) > ef:
                    heapq.heappop(best)
    out = sorted(((-nd, v) for nd, v in best))
    return np.array([v for _, v in out[:top_m]], np.int32)
