"""Segmented index: immutable epoch-stamped views + a delta segment
(DESIGN.md §10).

  * Every reader — executor dispatch, candidate collection, the delta
    merge in ``_finish_into`` — works against ONE :class:`IndexView`
    pinned at the start of its window.  Views are frozen dataclasses
    published by a single atomic reference assignment, so a reader can
    never observe torn multi-tier state.
  * The delta segment holds raw float32 rows, scanned exactly and merged
    into the top-k after the PQ scan + re-rank.

This slice of the port serves queries over views loaded from a snapshot
or built in one go; inserts, deletes and the background compactor of the
JAX package's ``core/segments.py`` come in a later slice.
"""

from __future__ import annotations

import dataclasses
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
    """The unsealed tail of the index (as a snapshot restores it).

    Arrays are never written in place, so a published :class:`IndexView`
    holds a delta that can never change under its readers.  Global ids
    are positional: row ``i`` is vector ``base + i``."""

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
