"""Heuristic re-ranking — paper §4.2, Algorithm 1, on the host (numpy).

The CPU re-ranks using raw vectors fetched from the SSD tier
(``core.io_sim``): max-heap top-k, change rate Δ = |S_n − S_n∩S_{n−1}|/k,
early termination after β stable batches.  The JAX package's device form
(``heuristic_rerank_jax``) is not on the serving path and is not ported
in this slice.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.core.io_sim import IOStats, SSDSim


@dataclasses.dataclass
class RerankResult:
    ids: np.ndarray                 # (k,) final neighbour ids (ascending dist)
    dists: np.ndarray               # (k,)
    batches_run: int
    candidates_scored: int
    io: IOStats
    early_stopped: bool


def heuristic_rerank(query: np.ndarray, candidate_ids: np.ndarray,
                     ssd: SSDSim, k: int, *, batch_size: int = 32,
                     eps: float = 0.05, beta: int = 2,
                     disable_early_stop: bool = False) -> RerankResult:
    """Algorithm 1.  ``candidate_ids`` must be sorted by ascending PQ
    distance (the GPU's output order — step ⑦)."""
    q = query.astype(np.float32)
    stats = ssd.begin_query()
    heap: list = []                 # max-heap via negated dists
    stability = 0
    batches = 0
    scored = 0
    early = False
    n = len(candidate_ids)

    def heap_ids() -> set:
        return {vid for _, vid in heap}

    for start in range(0, n, batch_size):
        prev = heap_ids()
        batch = candidate_ids[start:start + batch_size]
        vecs = ssd.fetch(batch, stats)                     # I/O + dedup
        d = np.sum((vecs.astype(np.float32) - q[None]) ** 2, axis=1)
        for dist, vid in zip(d, batch):
            scored += 1
            if len(heap) < k:
                heapq.heappush(heap, (-dist, int(vid)))
            elif dist < -heap[0][0]:
                heapq.heapreplace(heap, (-dist, int(vid)))
        batches += 1
        cur = heap_ids()
        delta = len(cur - prev) / max(k, 1)                # Eq. 3
        if not disable_early_stop:
            if delta < eps:
                stability += 1
                if stability >= beta:
                    early = True
                    break
            else:
                stability = 0

    order = sorted(((-nd, vid) for nd, vid in heap))
    ids = np.array([vid for _, vid in order], np.int32)
    dd = np.array([d for d, _ in order], np.float32)
    return RerankResult(ids=ids, dists=dd, batches_run=batches,
                        candidates_scored=scored, io=stats,
                        early_stopped=early)
