"""In-memory navigation graph over posting-list centroids (paper §4.1).

Vertices are the posting-list centroids; each links to its exact
top-``degree`` nearest.  Search is best-first beam search on the host (the
CPU stage ② of the online pipeline), exactly as in the paper and the JAX
package.  The graph build's distance blocks run in torch on ``device``.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.clustering import _kmeans, _nearest, sq_dists

# the exact kNN build is O(C²); it is the only build here, so centroid
# counts stop at the size it handles
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


def build_navgraph(points: np.ndarray, degree: int = 32, *,
                   device: torch.device) -> NavGraph:
    """Navigation-graph construction: exact kNN adjacency (highest
    quality, matmul-fast).  The JAX package's incremental SPTAG-style
    insertion for more than 50k vertices is a per-vertex Python loop and
    is not ported; larger centroid counts raise."""
    if len(points) > MAX_EXACT_VERTICES:
        raise ValueError(
            f"{len(points)} centroids: the exact navigation-graph build "
            f"takes at most {MAX_EXACT_VERTICES}; lower n_posting_fraction")
    return knn_graph_exact(points.astype(np.float32), device, degree=degree)


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
