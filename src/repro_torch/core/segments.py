"""Segmented index: immutable epoch-stamped views + a delta segment
(DESIGN.md §10).

  * Every reader — executor dispatch, candidate collection, the delta
    merge in ``_finish_into`` — works against ONE :class:`IndexView`
    pinned at the start of its window.  Views are frozen dataclasses
    published by a single atomic reference assignment, so a reader can
    never observe torn multi-tier state.
  * Inserts append to the small mutable *delta segment* — raw float32
    rows scanned exactly (numpy, on the host) and merged into the top-k
    after the PQ scan + re-rank.  No clustering, PQ encode, or SSD
    traffic on the insert path.
  * Deletes tombstone in the owning segment: a copy-on-write flip of the
    sealed tombstone array, or a functional update of the delta's flags.
  * A background :class:`SegmentCompactor` (its critical sections under
    the ``compaction``-ranked witness lock) seals the delta into the
    immutable PQ/posting/SSD tiers — assignment to the existing
    centroids and PQ encode on the index's device, tombstoned delta rows
    purged — while queries keep serving against the old view; the swap
    is one epoch-bumped reference assignment.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import TYPE_CHECKING, Optional, Tuple

import numpy as np

from repro_torch.core import navgraph as ng
from repro_torch.core.filters import AttributeTable, Predicate

if TYPE_CHECKING:                                   # pragma: no cover
    import torch
    from repro_torch.core.clustering import PostingLists


# ---------------------------------------------------------------------------
# Delta segment
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeltaSegment:
    """The mutable tail of the index, snapshotted functionally.

    Every mutation returns a NEW ``DeltaSegment`` (arrays are never
    written in place), so a published :class:`IndexView` holds a delta
    that can never change under its readers.  Global ids are positional:
    row ``i`` is vector ``base + i``; compaction seals a PREFIX of the
    rows, so surviving rows keep their global ids with a higher base.
    """

    base: int                   # global id of row 0
    vectors: np.ndarray         # (D, dim) float32, raw (un-rotated) space
    tombstoned: np.ndarray      # (D,) bool
    # per-row metadata columns (core/filters.py), local row-space; None
    # normalizes to an empty table so pre-filter constructors keep working
    attrs: Optional[AttributeTable] = None

    def __post_init__(self):
        if self.attrs is None:
            object.__setattr__(
                self, "attrs", AttributeTable.empty(len(self.vectors)))

    @staticmethod
    def empty(base: int, dim: int) -> "DeltaSegment":
        return DeltaSegment(base=int(base),
                            vectors=np.zeros((0, dim), np.float32),
                            tombstoned=np.zeros((0,), bool))

    def __len__(self) -> int:
        return len(self.vectors)

    @property
    def ids(self) -> np.ndarray:
        """Global ids of every row (including tombstoned ones)."""
        return np.arange(self.base, self.base + len(self.vectors),
                         dtype=np.int64)

    def live_count(self) -> int:
        return int(len(self.tombstoned) - np.count_nonzero(self.tombstoned))

    def append(self, vectors: np.ndarray,
               attributes=None) -> "DeltaSegment":
        vecs = np.atleast_2d(vectors)
        return DeltaSegment(
            base=self.base,
            vectors=np.concatenate([self.vectors, vecs]),
            tombstoned=np.concatenate(
                [self.tombstoned, np.zeros(len(vecs), bool)]),
            attrs=self.attrs.append(len(vecs), attributes))

    def tombstone(self, local_ids: np.ndarray) -> "DeltaSegment":
        flags = self.tombstoned.copy()
        flags[local_ids] = True
        return DeltaSegment(base=self.base, vectors=self.vectors,
                            tombstoned=flags, attrs=self.attrs)

    def drop_prefix(self, n: int) -> "DeltaSegment":
        """The segment left after sealing rows ``[0, n)`` — survivors keep
        their global ids because the base advances by exactly ``n``."""
        return DeltaSegment(base=self.base + int(n),
                            vectors=self.vectors[n:],
                            tombstoned=self.tombstoned[n:],
                            attrs=self.attrs.drop_prefix(n))

    def scan(self, query: np.ndarray,
             filt: Optional[Predicate] = None
             ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact squared-L2 over live rows matching ``filt`` -> (global
        ids, dists).

        Same metric as ``heuristic_rerank``'s SSD re-scoring, so the two
        result streams merge with one lexsort on ``(dist, id)``.  The
        predicate applies BEFORE the distance computation — selectivity
        shrinks the delta scan exactly like it shrinks the sealed one.
        """
        live = np.flatnonzero(~self.tombstoned)
        if filt is not None and len(live):
            live = live[filt.mask(self.attrs, live)]
        if not len(live):
            return (np.zeros((0,), np.int64), np.zeros((0,), np.float32))
        vecs = self.vectors[live]
        diff = vecs - query.astype(np.float32)[None]
        d2 = np.einsum("ij,ij->i", diff, diff).astype(np.float32)
        return self.base + live.astype(np.int64), d2


# ---------------------------------------------------------------------------
# Immutable view
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IndexView:
    """One consistent, epoch-stamped binding of every tier.

    Published by atomic reference assignment (``index._view = view``);
    readers pin a view once per scan window and never lock.  All arrays
    reachable from a view are treated as immutable: compaction builds
    fresh posting/tombstone/code objects instead of extending in place,
    and ``SSDSim``/``StorageLayout`` extension is prefix-preserving
    (sealed rows never move), so a reader holding an old view stays
    internally consistent forever.
    """

    epoch: int
    codes: "torch.Tensor"       # (n_rows, M) uint8 — sealed PQ segment(s)
    posting: "PostingLists"     # sealed DRAM ID metadata (row-space members)
    tombstones: np.ndarray      # (n_sealed,) bool — ID-space
    graph: ng.NavGraph
    delta: DeltaSegment
    # per-row metadata columns, ID-space over the sealed prefix (the
    # tombstone filter runs first, so purged ids never reach a lookup)
    attrs: Optional[AttributeTable] = None
    # seal-time purge indirection (DESIGN.md §11): compaction drops
    # tombstoned delta rows instead of encoding them, so physical code/SSD
    # rows and global ids diverge.  ``id_of`` maps physical row -> global
    # id (strictly increasing); ``row_of`` maps global id -> physical row
    # (-1 for purged ids).  None normalizes to the identity, so
    # constructors predating the purge keep working unchanged.
    id_of: Optional[np.ndarray] = None      # (n_rows,) int64
    row_of: Optional[np.ndarray] = None     # (n_sealed,) int64

    def __post_init__(self):
        if self.attrs is None:
            object.__setattr__(
                self, "attrs", AttributeTable.empty(self.n_sealed))
        if self.id_of is None:
            object.__setattr__(
                self, "id_of", np.arange(self.n_sealed, dtype=np.int64))
        if self.row_of is None:
            object.__setattr__(
                self, "row_of",
                row_of_from_id_of(self.id_of, self.n_sealed))

    @property
    def n_sealed(self) -> int:
        """Sealed ids ever published (id-space; includes purged ids)."""
        return len(self.tombstones)

    @property
    def n_rows(self) -> int:
        """Physical sealed rows (``== len(codes)``; <= n_sealed)."""
        return len(self.id_of)

    @property
    def n_total(self) -> int:
        return self.n_sealed + len(self.delta)

    # ------------------------------------------------------------- queries
    def candidate_ids(self, query: np.ndarray, top_m: int,
                      dedup: bool = True,
                      filt: Optional[Predicate] = None) -> np.ndarray:
        """Stages ②③⑤ over the SEALED segments: graph traversal -> row
        collection -> dedup -> tombstone filter -> predicate filter.
        Posting members are physical ROW indices; the ids returned are
        global and ``< n_sealed`` by construction — posting lists,
        tombstones, and the id map in one view always describe the same
        sealed prefix, so no gather can run past the code array.
        ``filt`` drops non-matching ids HERE, before any ADC
        work is attributed to them."""
        return self.collect_candidates(query, top_m, dedup=dedup,
                                       filt=filt)[0]

    def collect_candidates(self, query: np.ndarray, top_m: int,
                           dedup: bool = True,
                           filt: Optional[Predicate] = None
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """``(filtered_ids, prefilter_ids)`` — the second array is the
        candidate set BEFORE the predicate (after dedup + tombstones), so
        callers can prove selectivity shrank the scan
        (``QueryStats.candidates_prefilter``).  Same object twice when
        ``filt is None``."""
        cids = ng.search(self.graph, query.astype(np.float32), top_m)
        rows = np.concatenate([self.posting.members[c] for c in cids]) \
            if len(cids) else np.zeros((0,), np.int32)
        if dedup:
            rows = np.unique(rows)
        # id_of is strictly increasing, so row order == id order and the
        # dedup above also dedups ids
        ids = self.id_of[rows] if len(rows) else \
            np.zeros((0,), np.int64)
        if len(ids):
            ids = ids[~self.tombstones[ids]]
        if filt is None:
            return ids, ids
        return (ids[filt.mask(self.attrs, ids)] if len(ids) else ids), ids

    def delta_scan(self, query: np.ndarray,
                   filt: Optional[Predicate] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact scan of the delta segment -> (global ids, squared-L2)."""
        return self.delta.scan(query, filt=filt)


def row_of_from_id_of(id_of: np.ndarray, n_ids: int) -> np.ndarray:
    """Invert a physical-row -> global-id map; purged ids map to -1."""
    row_of = np.full(int(n_ids), -1, np.int64)
    row_of[id_of] = np.arange(len(id_of), dtype=np.int64)
    return row_of


# ---------------------------------------------------------------------------
# Background compaction
# ---------------------------------------------------------------------------

class SegmentCompactor:
    """Background thread sealing the delta whenever it holds at least
    ``min_delta`` rows.

    Parks on the index's ``compaction``-ranked condition; inserts notify
    it, so sealing starts within one wakeup of the threshold being
    crossed (``poll_s`` bounds the latency when a notify is missed).
    The heavy work — assignment, PQ encode (on the index's device), SSD
    extension — runs in :meth:`FusionANNSIndex.compact` OUTSIDE the lock;
    only the claim/publish critical sections hold it, so inserts,
    deletes, and queries keep flowing mid-compaction.

    A seal that raises ends the thread; the exception is kept and
    re-raised by :meth:`stop`, so a seal that never happened cannot pass
    unnoticed.
    """

    def __init__(self, index, *, min_delta: int = 64,
                 poll_s: float = 0.05):
        self.index = index
        self.min_delta = int(min_delta)
        self.poll_s = float(poll_s)
        self._stop_requested = False    # written under index._mut_cond
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "SegmentCompactor":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._loop, name="segment-compactor", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        idx = self.index
        try:
            while True:
                with idx._mut_cond:  # acquires: compaction
                    while (not self._stop_requested
                           and len(idx._view.delta) < self.min_delta):
                        idx._mut_cond.wait(self.poll_s)
                    if self._stop_requested:
                        return
                idx.compact()
        except BaseException as exc:  # noqa: BLE001 — re-raised by stop()
            self._error = exc

    def stop(self, *, flush: bool = False) -> None:
        """Stop the thread and re-raise the exception a seal raised in
        it, if any; with ``flush=True`` then seal any remaining delta
        rows (drain-to-sealed)."""
        t = self._thread
        if t is not None:
            with self.index._mut_cond:  # acquires: compaction
                self._stop_requested = True
                self.index._mut_cond.notify_all()
            t.join(timeout=300.0)
            if t.is_alive():
                raise RuntimeError("segment compactor did not stop within "
                                   "300 s")
            self._thread = None
            self._stop_requested = False
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc
        if flush:
            self.index.compact()
