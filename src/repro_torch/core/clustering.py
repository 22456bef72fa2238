"""Posting-list construction (paper §4.1): hierarchical balanced clustering
+ the ε-replication closure of Eq. (2) with the ≤8-replica cap.

The numpy-rng algorithm of the JAX package, step for step, so a CPU build
gives the same posting lists from the same ``np.random.Generator``.  Only
the distance blocks (``|x|² - 2x·cᵀ + |c|²``) and the polish step's
per-centroid sums run in torch on ``device``: that is where a 10M-vector,
50k-centroid build spends its operations.  On the card ``index_add_``
accumulates with atomics in no fixed order: f32 sums there changed the
centroids' last bits from one seeded build to the next (measured on an
H100), so on the card the polish sums its f32 rows in f64, whose
rounding lies 29 bits below f32's, and rounds the mean to f32 once: the
order no longer reaches the centroids, and two builds from one seed give
the same posting lists (``tests/test_torch_cuda.py::
test_cuda_posting_lists_are_reproducible``).  On the CPU the sums stay
f32 in row order, numpy's ``np.add.at``, bit for bit.

Every distance block here (and in ``core.pq``) is f32: its products run
under :data:`full_f32`, which keeps cuBLAS off TF32 whatever the caller
set, so a seal on the card assigns and encodes as the build did.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.analysis.concurrency.witness import make_lock

# rows per distance block: (16384, 50k centroids) f32 is 3.3 GB; results
# do not depend on it
_CHUNK = 16384


@dataclasses.dataclass
class PostingLists:
    centroids: np.ndarray            # (C, D) f32
    members: List[np.ndarray]        # per-cluster vector-ids (with replicas)
    primary: np.ndarray              # (N,) nearest-cluster id per vector

    @property
    def n_clusters(self) -> int:
        return len(self.members)

    def replication_factor(self) -> float:
        total = sum(len(m) for m in self.members)
        return total / max(len(self.primary), 1)


class _FullF32:
    """Context manager: cuBLAS f32 products in full f32 (TF32 off) inside
    it, the caller's setting restored when the last thread leaves.  The
    setting is process-wide, so threads inside count themselves."""

    def __init__(self):
        # a leaf: held for two attribute writes, nothing acquired under it
        self._lock = make_lock("future")
        self._depth = 0                  # guarded-by: _lock
        self._saved = False              # guarded-by: _lock

    def __enter__(self) -> None:
        with self._lock:  # acquires: future
            if self._depth == 0:
                self._saved = torch.backends.cuda.matmul.allow_tf32
                torch.backends.cuda.matmul.allow_tf32 = False
            self._depth += 1

    def __exit__(self, *exc) -> None:
        with self._lock:  # acquires: future
            self._depth -= 1
            if self._depth == 0:
                torch.backends.cuda.matmul.allow_tf32 = self._saved


full_f32 = _FullF32()


def row_sq_norms(x: torch.Tensor) -> torch.Tensor:
    """``np.sum(x ** 2, -1)`` of a float32 (n, d) tensor, summed in numpy's
    pairwise order (8 strided accumulators per 128-wide block), so the CPU
    build matches the JAX package's numpy arithmetic bit for bit."""
    return _pairwise_sum(x * x)


def _pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[1]
    if n < 8:
        res = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for i in range(n):
            res = res + x[:, i]
        return res
    if n <= 128:
        n8 = n - n % 8
        r = x[:, 0:8]
        for i in range(8, n8, 8):
            r = r + x[:, i:i + 8]
        res = (((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3]))
               + ((r[:, 4] + r[:, 5]) + (r[:, 6] + r[:, 7])))
        for i in range(n8, n):
            res = res + x[:, i]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return _pairwise_sum(x[:, :n2]) + _pairwise_sum(x[:, n2:])


def sq_dists(blk: np.ndarray, centers: torch.Tensor) -> torch.Tensor:
    """(n, C) squared L2 between host rows ``blk`` and ``centers`` (on the
    device that does the work), as the JAX package writes it:
    ``|x|² - 2x·cᵀ + |c|²``."""
    b = torch.from_numpy(np.ascontiguousarray(blk, np.float32)).to(
        centers.device)
    with full_f32:
        prod = (2.0 * b) @ centers.T
    return row_sq_norms(b)[:, None] - prod + row_sq_norms(centers)[None]


def _nearest(data: np.ndarray, centers: np.ndarray,
             device: torch.device, chunk: int = _CHUNK) -> np.ndarray:
    """Index of the nearest center per row (ties -> lowest index)."""
    c = torch.from_numpy(np.ascontiguousarray(centers, np.float32)).to(device)
    out = np.empty(len(data), np.int64)
    for s in range(0, len(data), chunk):
        out[s:s + chunk] = torch.argmin(
            sq_dists(data[s:s + chunk], c), -1).cpu().numpy()
    return out


def _kmeans(rng: np.random.Generator, data: np.ndarray, k: int,
            device: torch.device, iters: int = 10) -> np.ndarray:
    """Plain Lloyd k-means (numpy means, device distances) — the leaf step
    of the hierarchical balanced clustering."""
    n = len(data)
    centers = data[rng.choice(n, size=k, replace=n < k)].astype(np.float32)
    for _ in range(iters):
        assign = _nearest(data, centers, device)
        for c in range(k):
            pts = data[assign == c]
            if len(pts):
                centers[c] = pts.mean(0)
    return centers


def hierarchical_balanced_clustering(
        rng: np.random.Generator, data: np.ndarray, n_clusters: int,
        device: torch.device, branch: int = 8) -> np.ndarray:
    """Recursively k-means-split the largest partition until ``n_clusters``
    leaves exist (keeps leaves balanced — the paper's [34] lineage).
    Returns centroids (n_clusters, D)."""
    parts: List[np.ndarray] = [np.arange(len(data))]
    while len(parts) < n_clusters:
        parts.sort(key=len)
        big = parts.pop()                      # split the largest
        k = min(branch, max(2, n_clusters - len(parts)))
        if len(big) <= k:
            parts.append(big)
            break
        sub = data[big]
        centers = _kmeans(rng, sub, k, device, iters=6)
        assign = _nearest(sub, centers, device)
        new = [big[assign == c] for c in range(k)]
        parts.extend(p for p in new if len(p))
    cents = np.stack([data[p].mean(0) if len(p) else data[0]
                      for p in parts[:n_clusters]]).astype(np.float32)
    # polish with a few global Lloyd rounds
    return _kmeans_polish(data, cents, device, iters=4)


def _kmeans_polish(data: np.ndarray, centers: np.ndarray,
                   device: torch.device, iters: int = 4,
                   chunk: int = _CHUNK) -> np.ndarray:
    cent = torch.from_numpy(centers).to(device)
    # the card's index_add_ has no fixed order: sum in f64 there
    acc = torch.float32 if cent.device.type == "cpu" else torch.float64
    for _ in range(iters):
        sums = torch.zeros(cent.shape, dtype=acc, device=device)
        cnts = torch.zeros(len(cent), dtype=torch.float64, device=device)
        for s in range(0, len(data), chunk):
            blk = data[s:s + chunk]
            a = torch.argmin(sq_dists(blk, cent), -1)
            sums.index_add_(0, a, torch.from_numpy(
                np.ascontiguousarray(blk, np.float32)).to(device, acc))
            cnts.index_add_(0, a, torch.ones(len(a), dtype=torch.float64,
                                             device=device))
        nz = cnts > 0
        # sums over f64 counts, rounded back to f32: numpy's promotion
        cent[nz] = (sums[nz].double() / cnts[nz, None]).float()
    return cent.cpu().numpy()


def assign_with_replication(data: np.ndarray, centroids: np.ndarray,
                            device: torch.device, eps: float = 0.10,
                            max_replicas: int = 8,
                            chunk: int = _CHUNK) -> PostingLists:
    """Eq. (2): v ∈ C_i  ⇔  Dist(v, C_i) ≤ (1+ε)·Dist(v, C_1), capped at
    ``max_replicas`` clusters per vector.  Members of each cluster are in
    ascending vector id, as the JAX package's per-vector loop appends
    them."""
    n = len(data)
    c = len(centroids)
    r = min(max_replicas, c)
    cent = torch.from_numpy(np.ascontiguousarray(centroids, np.float32)).to(
        device)
    primary = np.empty(n, np.int32)
    clus, vids = [], []
    for s in range(0, n, chunk):
        d2 = sq_dists(data[s:s + chunk], cent)
        dd, idx = torch.topk(d2, r, dim=1, largest=False, sorted=True)
        dd, idx = dd.cpu().numpy(), idx.cpu().numpy()
        primary[s:s + len(idx)] = idx[:, 0]
        # Eq. 2 threshold on *distances* (squared dist => (1+eps)^2)
        ok = dd <= (1.0 + eps) ** 2 * dd[:, :1]
        rows, cols = np.nonzero(ok)            # row-major: vid ascending
        clus.append(idx[rows, cols])
        vids.append(s + rows)
    clus_a = np.concatenate(clus) if clus else np.zeros(0, np.int64)
    vids_a = np.concatenate(vids) if vids else np.zeros(0, np.int64)
    order = np.argsort(clus_a, kind="stable")
    bounds = np.cumsum(np.bincount(clus_a, minlength=c))[:-1]
    members = np.split(vids_a[order].astype(np.int32), bounds)
    return PostingLists(centroids=centroids.astype(np.float32),
                        members=members, primary=primary)


def build_posting_lists(rng: np.random.Generator, data: np.ndarray,
                        n_clusters: int, eps: float = 0.10,
                        max_replicas: int = 8, *,
                        device: torch.device) -> PostingLists:
    cents = hierarchical_balanced_clustering(rng, data, n_clusters, device)
    return assign_with_replication(data, cents, device, eps, max_replicas)
