"""SSD tier simulation with exact 4 KB-page semantics (paper §4.3).

Implements the optimised storage layout (per-centroid buckets,
first-fit-decreasing remainder bin-packing so partial pages are shared),
the vec->page mapping table, Direct-I/O page reads, and the two dedup
mechanisms:

  * intra-mini-batch: requests hitting the same page within ONE ``fetch()``
    are merged,
  * inter-mini-batch: a (per-query) DRAM page buffer absorbs repeats
    ACROSS ``fetch()`` calls.

The two mechanisms are strictly separated for the Fig. 12 per-mechanism
attribution: the page buffer only serves pages read by *previous*
mini-batches, so disabling ``intra_merge`` really does charge one I/O per
same-page request inside a batch (insertions into the buffer are deferred
to the end of the fetch).  Every mechanism can be disabled independently.
I/O counts and byte volumes are exact; latency is modelled by the analytic
device model of the reference package's ``core.baselines`` (DESIGN.md §7).

Thread-safety: the per-query DRAM buffer is thread-local, so the threaded
serving runtime can re-rank two queries concurrently — each
re-ranking thread sees its own per-query buffer scope and per-query I/O
accounting stays exact.
"""

from __future__ import annotations

import dataclasses
import heapq
import threading
from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class IOStats:
    ios: int = 0                 # page reads issued to the "SSD"
    pages_requested: int = 0     # before any dedup
    buffer_hits: int = 0         # inter-mini-batch dedup (DRAM page buffer)
    intra_merged: int = 0        # intra-mini-batch dedup (same-page merge)
    bytes_read: int = 0

    def merge(self, other: "IOStats") -> "IOStats":
        return IOStats(self.ios + other.ios,
                       self.pages_requested + other.pages_requested,
                       self.buffer_hits + other.buffer_hits,
                       self.intra_merged + other.intra_merged,
                       self.bytes_read + other.bytes_read)


class PageBuffer:
    """LRU DRAM page buffer (inter-mini-batch dedup)."""

    def __init__(self, capacity_pages: int):
        self.capacity = capacity_pages
        self._lru: "OrderedDict[int, bool]" = OrderedDict()

    def hit(self, page: int) -> bool:
        if page in self._lru:
            self._lru.move_to_end(page)
            return True
        return False

    def insert(self, page: int) -> None:
        self._lru[page] = True
        self._lru.move_to_end(page)
        while len(self._lru) > self.capacity:
            self._lru.popitem(last=False)

    def clear(self) -> None:
        self._lru.clear()


def pack_buckets_maxmin(bucket_sizes: Sequence[int], per_page: int
                        ) -> Tuple[List[List[int]], int]:
    """First-fit-decreasing packing of bucket *remainders* into shared
    pages (§4.3's shared-page layout).

    Full pages are dedicated; remainders are sorted descending and each is
    placed into the FIRST open page with room (first-fit-decreasing — not
    the max-min pairing the name suggests; the name is kept for API
    stability).  Returns (groups of bucket-ids sharing a page, total pages
    used).

    Same result as scanning the open pages in order for each remainder,
    but without the O(remainders x pages) scan that stalls a
    50k-centroid build: open pages are kept in one min-heap of page
    indices per load, so "the first page with room for ``size``" is the
    smallest head among the heaps of loads ``<= per_page - size``."""
    full_pages = sum(s // per_page for s in bucket_sizes)
    rema = [(s % per_page, i) for i, s in enumerate(bucket_sizes)
            if s % per_page]
    rema.sort(reverse=True)
    groups: List[List[int]] = []
    by_load: List[List[int]] = [[] for _ in range(per_page + 1)]
    for size, bid in rema:
        best_load, best_gi = -1, len(groups)
        for load in range(per_page - size + 1):
            heap = by_load[load]
            if heap and heap[0] < best_gi:
                best_load, best_gi = load, heap[0]
        if best_load < 0:
            groups.append([bid])
        else:
            heapq.heappop(by_load[best_load])
            groups[best_gi].append(bid)
        heapq.heappush(by_load[max(best_load, 0) + size], best_gi)
    return groups, full_pages + len(groups)


@dataclasses.dataclass
class StorageLayout:
    """vec_id -> page mapping under the optimised bucket layout."""

    page_of: np.ndarray            # (N,) int64 page id per vector
    n_pages: int
    per_page: int
    page_bytes: int

    @staticmethod
    def build(primary_cluster: np.ndarray, n_clusters: int,
              vec_bytes: int, page_bytes: int = 4096,
              optimized: bool = True) -> "StorageLayout":
        """``primary_cluster[v]`` = the single bucket that stores v (no
        duplicates across buckets — paper §4.3).  ``optimized=False`` lays
        vectors out in insertion order (the straw-man layout)."""
        n = len(primary_cluster)
        per_page = max(1, page_bytes // vec_bytes)
        page_of = np.empty(n, np.int64)
        if not optimized:
            page_of[:] = np.arange(n) // per_page
            return StorageLayout(page_of, int(page_of.max()) + 1 if n else 0,
                                 per_page, page_bytes)
        # group vectors by bucket; remainders share pages via max-min
        order = np.argsort(primary_cluster, kind="stable")
        sizes = np.bincount(primary_cluster, minlength=n_clusters)
        groups, n_pages = pack_buckets_maxmin(sizes.tolist(), per_page)
        # assign pages: first the full pages bucket-by-bucket, then groups
        page = 0
        starts = np.zeros(n_clusters + 1, np.int64)
        np.cumsum(sizes, out=starts[1:])
        slot_page = np.empty(n, np.int64)   # page of the i-th sorted vector
        rem_start: Dict[int, int] = {}
        for c in range(n_clusters):
            full = sizes[c] // per_page
            for f in range(full):
                s = starts[c] + f * per_page
                slot_page[s:s + per_page] = page
                page += 1
            rem_start[c] = starts[c] + full * per_page
        for grp in groups:
            for bid in grp:
                s = rem_start[bid]
                e = starts[bid] + sizes[bid]
                slot_page[s:e] = page
            page += 1
        page_of[order] = slot_page
        return StorageLayout(page_of, page, per_page, page_bytes)


class SSDSim:
    """Raw-vector store with page-granular reads + dedup mechanisms."""

    def __init__(self, vectors: np.ndarray, layout: StorageLayout,
                 buffer_pages: int = 1024, *,
                 intra_merge: bool = True, use_buffer: bool = True):
        self.vectors = vectors
        self.layout = layout
        self.intra_merge = intra_merge
        self.use_buffer = use_buffer
        self.buffer_pages = buffer_pages
        # one DRAM buffer per re-ranking thread: a query's re-rank runs
        # entirely on one thread, so per-query scoping survives the
        # threaded runtime's concurrent retirements
        self._tls = threading.local()

    @property
    def buffer(self) -> PageBuffer:
        buf = getattr(self._tls, "buffer", None)
        if buf is None:
            buf = PageBuffer(self.buffer_pages)
            self._tls.buffer = buf
        return buf

    # thread-local state is not deepcopy/pickle-able; a copy starts with
    # fresh (empty) per-thread buffers, which is also semantically right
    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_tls", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._tls = threading.local()

    def begin_query(self) -> IOStats:
        """Per-query buffer scope (the paper's DRAM buffer is per-query
        working memory)."""
        self.buffer.clear()
        return IOStats()

    def fetch(self, vec_ids: np.ndarray, stats: IOStats) -> np.ndarray:
        """One re-ranking mini-batch: returns the raw vectors, accounting
        page I/O with intra-batch merge + buffer dedup.

        Buffer insertions are deferred until the whole mini-batch is
        accounted: the buffer is the INTER-mini-batch mechanism, so with
        ``intra_merge=False`` same-page requests inside one batch each
        cost an I/O instead of being silently absorbed by the buffer
        (keeps the Fig. 12 per-mechanism attribution honest)."""
        pages = self.layout.page_of[vec_ids]
        stats.pages_requested += len(pages)
        wanted = pages if not self.intra_merge else np.unique(pages)
        # per-mechanism attribution invariant (Fig. 12):
        #   pages_requested - ios == intra_merged + buffer_hits
        stats.intra_merged += len(pages) - len(wanted)
        buf = self.buffer
        read_this_batch: List[int] = []       # read order (dups included)
        for p in wanted:
            p = int(p)
            if self.use_buffer and buf.hit(p):
                stats.buffer_hits += 1
                continue
            stats.ios += 1
            stats.bytes_read += self.layout.page_bytes
            read_this_batch.append(p)
        if self.use_buffer:
            # sequential inserts in read order: LRU recency matches the
            # actual read sequence (a repeat moves its page to the tail)
            for p in read_this_batch:
                buf.insert(p)
        return self.vectors[vec_ids]
