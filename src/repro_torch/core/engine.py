"""FusionANNS engine: offline index build (§3 Offline) + the 8-step online
query pipeline (§3 Online), on one GPU.

Tier placement (DESIGN.md §2):
  * navigation graph + posting-list vector-IDs  -> host numpy ("DRAM")
  * PQ codes + codebooks                        -> GPU memory ("HBM")
  * raw vectors                                 -> SSDSim (4 KB page model)

Every entry point takes ``device=None``, which means ``"cuda"``: with no
card and no device asked for, it raises.  Tests pass ``device="cpu"``,
where the kernels' plain versions run.

Updates (DESIGN.md §10): the index is SEGMENTED.  The built tiers are
immutable sealed segments described by one epoch-stamped
:class:`~repro_torch.core.segments.IndexView`; inserts land in a small
mutable delta segment (scanned exactly on the host, merged after the PQ
scan + re-rank), deletes tombstone in the owning segment, and
:meth:`FusionANNSIndex.compact` — usually driven by the background
:class:`~repro_torch.core.segments.SegmentCompactor` — seals the delta
into the immutable tiers (assignment and PQ encode on the index's
device) under the ``compaction``-ranked witness lock.  Readers never
lock: they pin ``index.view()`` once per scan window.  Snapshots are the
JAX package's format v2, readable by either package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.analysis.concurrency.witness import (make_condition,
                                                      make_lock)
from repro_torch.configs.base import ANNSConfig
from repro_torch.core import clustering, navgraph as ng, opq, pq
from repro_torch.core.executor import (PlanOverrides, QueryExecutor,  # noqa: F401
                                       QueryPlan, QueryResult, QueryStats)
from repro_torch.core.filters import AttributeTable
from repro_torch.core.futures import BatchTicket
from repro_torch.core.io_sim import SSDSim, StorageLayout
from repro_torch.core.segments import (DeltaSegment, IndexView,
                                      SegmentCompactor)
from repro_torch.kernels.l2dist.ops import l2_distances

# the JAX package's snapshot format (manifest.json + arrays.npz, DESIGN.md
# §10); v1 snapshots carry no id map and no attributes
SNAPSHOT_FORMAT_VERSION = 2
_SNAPSHOT_COMPAT_VERSIONS = (1, 2)
_SNAPSHOT_MANIFEST = "manifest.json"
_SNAPSHOT_ARRAYS = "arrays.npz"


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: raise rather than run elsewhere unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch versions instead")
    return torch.device("cuda")


class FusionANNSIndex:
    """The four-tier index with segmented streaming updates.

    Immutable-per-epoch state (codes, posting lists, sealed tombstones,
    nav graph, delta segment) lives in ``self._view`` — an
    :class:`IndexView` published by one atomic reference assignment under
    ``_mut_lock`` (rank ``compaction``).  Readers access it lock-free via
    :meth:`view` / the properties below; mutators (:meth:`insert`,
    :meth:`delete`, :meth:`compact`) never let a reader observe torn
    multi-tier state because every published view's tiers describe
    exactly the same id range.
    """

    def __init__(self, cfg: ANNSConfig, codebook: pq.PQCodebook,
                 codes: torch.Tensor, posting: clustering.PostingLists,
                 graph: ng.NavGraph, ssd: SSDSim,
                 rotation: Optional[np.ndarray] = None,
                 tombstones: Optional[np.ndarray] = None,
                 attributes=None, id_of: Optional[np.ndarray] = None):
        self.cfg = cfg
        self.codebook = codebook                 # HBM tier
        self.ssd = ssd                           # SSD tier: raw vectors
        # OPQ rotation of a loaded snapshot: applied to queries before the
        # LUT build only — clustering/graph/re-rank stay in raw space
        self.rotation = rotation
        # id-space size: with a seal-time-purged snapshot the tombstone
        # array covers MORE ids than there are physical code rows
        n_ids = (int(codes.shape[0]) if tombstones is None
                 else int(len(tombstones)))
        tomb = (np.zeros(n_ids, bool) if tombstones is None
                else np.asarray(tombstones, bool))
        self._mut_lock = make_lock("compaction")
        self._mut_cond = make_condition("compaction", self._mut_lock)
        self._compacting = False                 # guarded-by: _mut_lock
        self._compactor: Optional[SegmentCompactor] = None
        dim = int(ssd.vectors.shape[1])
        attrs = (AttributeTable.from_columns(n_ids, attributes)
                 if attributes else None)
        self._view = IndexView(
            epoch=0, codes=codes, posting=posting, tombstones=tomb,
            graph=graph, delta=DeltaSegment.empty(n_ids, dim),
            attrs=attrs, id_of=id_of)
        self._executor: Optional[QueryExecutor] = None
        self.build_seconds: Dict[str, float] = {}

    # deepcopy/pickle: locks and threads are per-process; a copy starts
    # with fresh ones (and no background compactor or executor)
    def __getstate__(self):
        state = self.__dict__.copy()
        for key in ("_mut_lock", "_mut_cond", "_compactor", "_executor"):
            state.pop(key, None)
        state["_compacting"] = False
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._mut_lock = make_lock("compaction")
        self._mut_cond = make_condition("compaction", self._mut_lock)
        self._compactor = None
        self._executor = None

    # ------------------------------------------------------ view plumbing
    def view(self) -> IndexView:
        """Pin the current epoch's consistent binding of every tier."""
        return self._view

    @property
    def device(self) -> torch.device:
        return self._view.codes.device

    @property
    def epoch(self) -> int:
        return self._view.epoch

    @property
    def codes(self) -> torch.Tensor:
        return self._view.codes

    @property
    def posting(self) -> clustering.PostingLists:
        return self._view.posting

    @property
    def tombstones(self) -> np.ndarray:
        return self._view.tombstones

    @property
    def graph(self) -> ng.NavGraph:
        return self._view.graph

    @property
    def n_total(self) -> int:
        return self._view.n_total

    @property
    def delta_size(self) -> int:
        return len(self._view.delta)

    def _lut_query(self, q: np.ndarray) -> np.ndarray:
        return q @ self.rotation if self.rotation is not None else q

    # ------------------------------------------------------------------ build
    @staticmethod
    def build(data: np.ndarray, cfg: ANNSConfig, seed: int = 0,
              *, intra_merge: bool = True, use_buffer: bool = True,
              optimized_layout: bool = True, use_opq: bool = False,
              attributes=None, device=None) -> "FusionANNSIndex":
        """Build every tier from raw vectors ``data`` (N, D) on ``device``.
        ``use_opq`` trains an OPQ rotation (``core/opq.py``) and encodes
        the rotated rows.  Wall time of each stage lands in
        ``index.build_seconds``."""
        dev = resolve_device(device)
        n, d = data.shape
        secs: Dict[str, float] = {}
        rng = np.random.default_rng(seed)
        t = time.perf_counter()
        data32 = np.ascontiguousarray(data, np.float32)
        # 1. posting lists (hierarchical balanced clustering + Eq.2 replicas)
        n_clusters = max(4, int(n * cfg.n_posting_fraction))
        posting = clustering.build_posting_lists(
            rng, data32, n_clusters, eps=cfg.replication_eps,
            max_replicas=cfg.max_replicas, device=dev)
        secs["posting_lists"] = time.perf_counter() - t
        # 2. navigation graph over centroids (DRAM)
        t = time.perf_counter()
        graph = ng.build_navgraph(posting.centroids, degree=cfg.graph_degree,
                                  device=dev)
        secs["navgraph"] = time.perf_counter() - t
        del data32
        # 3. PQ codes pinned in HBM (optionally OPQ-rotated — beyond-paper);
        # the raw rows cross to the device once
        t = time.perf_counter()
        rows = torch.from_numpy(np.ascontiguousarray(data)).to(dev)
        gen = torch.Generator().manual_seed(seed)
        rotation = None
        if use_opq:
            ocb, _ = opq.train_opq(gen, rows, cfg.pq_m, cfg.pq_nbits,
                                   device=dev)
            cb, rotation = ocb.cb, ocb.rotation
            codes = opq.encode(ocb, rows)
        else:
            cb = pq.train_codebooks(gen, rows, cfg.pq_m, cfg.pq_nbits,
                                    device=dev)
            codes = pq.encode(cb, rows)
        del rows
        secs["pq"] = time.perf_counter() - t
        # 4. raw vectors on SSD, bucketed by primary centroid (§4.3)
        t = time.perf_counter()
        layout = StorageLayout.build(
            posting.primary, posting.n_clusters,
            vec_bytes=data.dtype.itemsize * d, page_bytes=cfg.page_bytes,
            optimized=optimized_layout)
        ssd = SSDSim(data, layout, buffer_pages=cfg.dram_buffer_pages,
                     intra_merge=intra_merge, use_buffer=use_buffer)
        secs["ssd_layout"] = time.perf_counter() - t
        # NOTE: intermediate posting-list *contents* are discarded here —
        # only the ID metadata survives in DRAM (paper §4.1).
        index = FusionANNSIndex(cfg=cfg, codebook=cb, codes=codes,
                                posting=posting, graph=graph, ssd=ssd,
                                rotation=rotation, attributes=attributes)
        index.build_seconds = secs
        return index

    # --------------------------------------------------------------- updates
    def insert(self, vectors: np.ndarray,
               attributes=None) -> np.ndarray:
        """Append vectors to the delta segment; returns their new ids.

        ``attributes`` maps column name -> per-row ints (filtered search,
        DESIGN.md §11); columns absent here backfill UNSET and never
        match a predicate.  O(rows) on the host — no clustering, PQ
        encode, or SSD traffic here; sealing is compaction's job.  The
        ids are published atomically WITH the rows (one view swap), so a
        concurrent query either sees none of the batch or all of it.
        """
        vecs = np.atleast_2d(np.asarray(vectors, np.float32))
        with self._mut_cond:  # acquires: compaction
            cur = self._view
            new_ids = np.arange(cur.n_total, cur.n_total + len(vecs),
                                dtype=np.int64)
            self._view = dataclasses.replace(
                cur, epoch=cur.epoch + 1,
                delta=cur.delta.append(vecs, attributes))
            self._mut_cond.notify_all()          # wake the compactor
        return new_ids

    def delete(self, ids: np.ndarray) -> None:
        """Tombstone ids in their owning segment (sealed array copy-on-
        write, or a functional delta update).  Deleting an id that was
        never published (``>= n_total``) raises ``ValueError``."""
        idarr = np.atleast_1d(np.asarray(ids, np.int64))
        with self._mut_cond:  # acquires: compaction
            cur = self._view
            if len(idarr) and (int(idarr.min()) < 0
                               or int(idarr.max()) >= cur.n_total):
                bad = idarr[(idarr < 0) | (idarr >= cur.n_total)]
                raise ValueError(
                    f"delete: id(s) {bad[:8].tolist()} not published — "
                    f"index currently holds ids [0, {cur.n_total})")
            sealed = idarr[idarr < cur.n_sealed]
            local = idarr[idarr >= cur.n_sealed] - cur.delta.base
            tomb = cur.tombstones
            if len(sealed):
                tomb = tomb.copy()
                tomb[sealed] = True
            delta = cur.delta.tombstone(local) if len(local) else cur.delta
            self._view = dataclasses.replace(
                cur, epoch=cur.epoch + 1, tombstones=tomb, delta=delta)

    def compact(self, *, wait: bool = True) -> int:
        """Seal the current delta into the immutable tiers.  Returns the
        number of rows sealed (0 if the delta was empty, or if another
        thread is already compacting and ``wait=False``).

        Three phases: (1) claim — snapshot the delta prefix under the
        lock and take the single-compactor token; (2) seal — assign to
        the existing centroids and PQ-encode on the index's device, and
        extend the SSD tier, OUTSIDE the lock (queries, inserts, and
        deletes keep flowing); (3) publish — one epoch-bumped view swap
        under the lock.  Inserts that raced phase 2 stay in the (shrunk)
        delta; deletes that raced it land in the sealed tombstone array.
        """
        with self._mut_cond:  # acquires: compaction
            while self._compacting:
                if not wait:
                    return 0
                self._mut_cond.wait()
            view0 = self._view
            d0 = len(view0.delta)
            if d0 == 0:
                return 0
            self._compacting = True
        try:
            self._seal(view0, d0)
        finally:
            with self._mut_cond:  # acquires: compaction
                self._compacting = False
                self._mut_cond.notify_all()
        return d0

    def _seal(self, view0: IndexView, d0: int) -> None:
        """Phase 2+3 of :meth:`compact` — heavy work lock-free, publish
        atomic.  Only ever runs under the ``_compacting`` token, so
        ``view0``'s sealed tiers are still current at publish time.

        Rows tombstoned at claim time are PURGED here: no PQ code, no
        posting membership, no SSD page.  Global ids stay stable — the
        id space keeps counting purged rows — so the published view
        carries ``id_of``/``row_of`` maps between physical rows and ids,
        both strictly increasing.  Assignment and encoding are per row,
        so posting members, codes and ``id_of`` do not depend on where
        seals cut the delta; the SSD page layout does."""
        delta_vecs = view0.delta.vectors[:d0]
        snap_tomb = view0.delta.tombstoned[:d0]
        n_sealed = view0.n_sealed
        live_local = np.flatnonzero(~snap_tomb)
        n_live = len(live_local)
        live_vecs = delta_vecs[live_local]
        live_gids = (n_sealed + live_local).astype(np.int64)
        # DRAM tier: the survivors against the EXISTING centroids (on the
        # device); posting members are physical ROW indices
        members = list(view0.posting.members)
        primary = view0.posting.primary
        codes = view0.codes
        if n_live:
            new_pl = clustering.assign_with_replication(
                live_vecs, view0.posting.centroids, self.device,
                eps=self.cfg.replication_eps,
                max_replicas=self.cfg.max_replicas)
            for c in range(view0.posting.n_clusters):
                mem = new_pl.members[c]
                if len(mem):
                    members[c] = np.concatenate(
                        [members[c],
                         (mem + view0.n_rows).astype(np.int32)])
            primary = np.concatenate([primary, new_pl.primary])
            # HBM tier: PQ-encode the survivors (rotated if OPQ) into a
            # NEW tensor: windows in flight still scan view0.codes
            if self.rotation is not None:
                new_codes = opq.encode(opq.OPQCodebook(
                    rotation=self.rotation, cb=self.codebook), live_vecs)
            else:
                new_codes = pq.encode(self.codebook, live_vecs)
            codes = torch.cat([view0.codes, new_codes])
            # SSD tier: fresh pages bucketed by primary centroid (§4.3).
            # Prefix-preserving rebinds — rows a published view can name
            # never move, so readers of any older view stay consistent.
            lay = self.ssd.layout
            order = np.argsort(new_pl.primary, kind="stable")
            page_of = np.empty(n_live, np.int64)
            page_of[order] = lay.n_pages + np.arange(n_live) // lay.per_page
            self.ssd.vectors = np.concatenate(
                [self.ssd.vectors,
                 live_vecs.astype(self.ssd.vectors.dtype)])
            lay.page_of = np.concatenate([lay.page_of, page_of])
            lay.n_pages = int(lay.page_of.max()) + 1
        posting = clustering.PostingLists(
            centroids=view0.posting.centroids, members=members,
            primary=primary)
        id_of = np.concatenate([view0.id_of, live_gids])
        # publish: sealed tombstones take the PUBLISH-time delta flags — a
        # delete that raced the seal missed the purge (its row IS
        # encoded), but the candidate-collection tombstone filter still
        # drops it.  Attributes are id-space: ALL d0 rows carry over.
        with self._mut_cond:  # acquires: compaction
            cur = self._view
            tomb = np.concatenate([cur.tombstones,
                                   cur.delta.tombstoned[:d0]])
            self._view = IndexView(
                epoch=cur.epoch + 1, codes=codes, posting=posting,
                tombstones=tomb, graph=cur.graph,
                delta=cur.delta.drop_prefix(d0),
                attrs=cur.attrs.extend(cur.delta.attrs.head(d0)),
                id_of=id_of)
            self._mut_cond.notify_all()

    def start_compactor(self, *, min_delta: int = 64,
                        poll_s: float = 0.05) -> SegmentCompactor:
        """Run background compaction on its own thread: seals the delta
        whenever it reaches ``min_delta`` rows."""
        if self._compactor is None:
            self._compactor = SegmentCompactor(
                self, min_delta=min_delta, poll_s=poll_s).start()
        return self._compactor

    def stop_compactor(self, *, flush: bool = False) -> None:
        """Stop the background compactor; re-raises the exception a seal
        raised on its thread.  ``flush=True`` then seals what is left."""
        compactor = self._compactor
        if compactor is not None:
            self._compactor = None
            compactor.stop(flush=flush)

    # ------------------------------------------------------------- snapshots
    def save_snapshot(self, path: str) -> str:
        """Checkpoint every tier — PQ codes + codebooks, nav graph,
        posting lists, SSD layout + raw vectors, tombstones, and the live
        delta segment — to ``path/`` in the JAX package's format v2
        (manifest.json + arrays.npz), which either package loads.

        The view ref is pinned under the compaction lock; the copies to
        the host and file I/O run outside it.  SSD arrays are truncated
        to the view's physical rows, so a compaction racing the save
        cannot leak rows the captured view does not publish.
        """
        with self._mut_cond:  # acquires: compaction
            view = self._view
        n_sealed = view.n_sealed
        n_rows = view.n_rows                  # physical rows (<= n_sealed)
        lay = self.ssd.layout
        page_of = np.asarray(lay.page_of[:n_rows], np.int64)
        arrays: Dict[str, np.ndarray] = {
            "codes": view.codes.cpu().numpy(),
            "codebooks": self.codebook.codebooks.float().cpu().numpy(),
            "graph_points": view.graph.points,
            "graph_neighbors": view.graph.neighbors,
            "posting_centroids": view.posting.centroids,
            "posting_primary": view.posting.primary,
            "posting_members_flat": (
                np.concatenate(view.posting.members)
                if view.posting.n_clusters else np.zeros(0, np.int32)),
            "posting_offsets": np.cumsum(
                [0] + [len(m) for m in view.posting.members]).astype(np.int64),
            "tombstones": view.tombstones,
            "ssd_vectors": np.asarray(self.ssd.vectors[:n_rows]),
            "ssd_page_of": page_of,
            "id_of": view.id_of,
            "delta_vectors": view.delta.vectors,
            "delta_tombstoned": view.delta.tombstoned,
        }
        for name, col in view.attrs.columns.items():
            arrays[f"attr_sealed_{name}"] = col
        for name, col in view.delta.attrs.columns.items():
            arrays[f"attr_delta_{name}"] = col
        if self.rotation is not None:
            arrays["rotation"] = np.asarray(self.rotation, np.float32)
        if view.graph.super_centroids is not None:
            arrays["graph_super_centroids"] = view.graph.super_centroids
            arrays["graph_super_assign"] = view.graph.super_assign
        manifest = {
            "format_version": SNAPSHOT_FORMAT_VERSION,
            "epoch": int(view.epoch),
            "n_sealed": int(n_sealed),
            "n_rows": int(n_rows),
            "attr_sealed_cols": sorted(view.attrs.columns),
            "attr_delta_cols": sorted(view.delta.attrs.columns),
            # the JAX loader reads this key; the port's loader ignores it
            "use_kernel": False,
            "cfg": dataclasses.asdict(self.cfg),
            "graph_entry": int(view.graph.entry),
            "ssd": {
                "n_pages": int(page_of.max()) + 1 if n_rows else 0,
                "per_page": int(lay.per_page),
                "page_bytes": int(lay.page_bytes),
                "buffer_pages": int(self.ssd.buffer_pages),
                "intra_merge": bool(self.ssd.intra_merge),
                "use_buffer": bool(self.ssd.use_buffer),
            },
        }
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, _SNAPSHOT_MANIFEST), "w") as fh:
            json.dump(manifest, fh, indent=1)
        np.savez(os.path.join(path, _SNAPSHOT_ARRAYS), **arrays)
        return path

    # ------------------------------------------------------------- snapshots
    @classmethod
    def load_snapshot(cls, path: str, device=None) -> "FusionANNSIndex":
        """Rebuild a full index — sealed tiers AND delta segment, at the
        saved epoch — from a snapshot directory the JAX package's
        ``FusionANNSIndex.save_snapshot`` wrote.  Codes and codebooks go to
        ``device``; the host tiers stay numpy.  It also reads what
        :meth:`save_snapshot` writes.  The manifest's
        ``use_kernel`` flag is read and ignored: the device of the codes
        decides between kernel and plain version."""
        dev = resolve_device(device)
        with open(os.path.join(path, _SNAPSHOT_MANIFEST)) as fh:
            manifest = json.load(fh)
        if manifest["format_version"] not in _SNAPSHOT_COMPAT_VERSIONS:
            raise ValueError(
                f"snapshot format {manifest['format_version']} not in "
                f"{_SNAPSHOT_COMPAT_VERSIONS}")
        with np.load(os.path.join(path, _SNAPSHOT_ARRAYS)) as npz:
            arr = {k: npz[k] for k in npz.files}
        cfg = ANNSConfig(**manifest["cfg"])
        offsets = arr["posting_offsets"]
        flat = arr["posting_members_flat"]
        posting = clustering.PostingLists(
            centroids=arr["posting_centroids"],
            members=[flat[offsets[i]:offsets[i + 1]]
                     for i in range(len(offsets) - 1)],
            primary=arr["posting_primary"])
        graph = ng.NavGraph(
            points=arr["graph_points"], neighbors=arr["graph_neighbors"],
            entry=manifest["graph_entry"],
            super_centroids=arr.get("graph_super_centroids"),
            super_assign=arr.get("graph_super_assign"))
        ssd_meta = manifest["ssd"]
        layout = StorageLayout(
            page_of=arr["ssd_page_of"], n_pages=ssd_meta["n_pages"],
            per_page=ssd_meta["per_page"], page_bytes=ssd_meta["page_bytes"])
        ssd = SSDSim(arr["ssd_vectors"], layout,
                     buffer_pages=ssd_meta["buffer_pages"],
                     intra_merge=ssd_meta["intra_merge"],
                     use_buffer=ssd_meta["use_buffer"])
        codes = torch.from_numpy(arr["codes"]).to(dev)
        id_of = arr.get("id_of")
        n_sealed = int(manifest["n_sealed"])
        sealed_attrs = AttributeTable.from_columns(
            n_sealed, {name: arr[f"attr_sealed_{name}"]
                       for name in manifest.get("attr_sealed_cols", [])})
        delta_attrs = AttributeTable.from_columns(
            len(arr["delta_vectors"]),
            {name: arr[f"attr_delta_{name}"]
             for name in manifest.get("attr_delta_cols", [])})
        index = cls(cfg=cfg, codebook=pq.PQCodebook(
                        codebooks=torch.from_numpy(arr["codebooks"]).to(dev)),
                    codes=codes, posting=posting, graph=graph, ssd=ssd,
                    rotation=arr.get("rotation"),
                    tombstones=arr["tombstones"], id_of=id_of)
        # restore the delta + epoch too: answers must match the donor's,
        # including its unsealed tail
        index._view = IndexView(
            epoch=manifest["epoch"], codes=codes, posting=posting,
            tombstones=np.asarray(arr["tombstones"], bool), graph=graph,
            delta=DeltaSegment(base=n_sealed,
                               vectors=arr["delta_vectors"],
                               tombstoned=np.asarray(
                                   arr["delta_tombstoned"], bool),
                               attrs=delta_attrs),
            attrs=sealed_attrs, id_of=id_of)
        return index

    # ------------------------------------------------------------------ query
    def candidate_ids(self, query: np.ndarray, top_m: int,
                      dedup: bool = True) -> np.ndarray:
        """Stages ②③⑤ against the current view's sealed segments."""
        return self._view.candidate_ids(query, top_m, dedup)

    @property
    def executor(self) -> QueryExecutor:
        """The unified QueryPlan -> QueryExecutor pipeline (core.executor),
        shared by all the public query paths."""
        if self._executor is None:
            self._executor = QueryExecutor(self)
        return self._executor

    def make_executor(self, mesh=None) -> QueryExecutor:
        """A FRESH executor over this index (multi-replica serving: each
        replica owns its own executor and dispatch lock).  All executors
        share the index's published view — an executor pins
        ``index.view()`` per scan window, so every insert/delete/compaction
        epoch reaches every replica at its next dispatch.  A ``mesh``
        raises (``QueryExecutor.attach_mesh``): the multi-GPU scan is not
        ported yet."""
        return QueryExecutor(self, mesh=mesh)

    def plan(self, *, k: Optional[int] = None, top_m: Optional[int] = None,
             top_n: Optional[int] = None, **kw) -> QueryPlan:
        return QueryPlan.from_config(self.cfg, k=k, top_m=top_m,
                                     top_n=top_n, **kw)

    def submit(self, queries: np.ndarray, *, k: Optional[int] = None,
               top_m: Optional[int] = None, top_n: Optional[int] = None,
               overrides: Optional[List[Optional[PlanOverrides]]] = None,
               **kw) -> BatchTicket:
        """Futures-first entry point (DESIGN.md §3): host traversal +
        kernel launch, then return immediately.  ``kw`` passes plan knobs
        through (``window=``, ``inflight_depth=``, ``fused=``,
        ``lut_int8=``, ``filter=``, ...); ``overrides`` carries per-query
        ``PlanOverrides`` for mixed-``k`` windows."""
        return self.executor.submit(
            queries, self.plan(k=k, top_m=top_m, top_n=top_n, **kw),
            overrides=overrides)

    def search(self, request):
        """Typed single-request serve (DESIGN.md §6): accepts a
        :class:`~repro_torch.serve.client.SearchRequest` and returns its
        :class:`~repro_torch.serve.client.SearchResponse` through the
        shared executor's Backend-protocol path — same ids as
        :meth:`query`."""
        return self.executor.submit(request).result()

    def query(self, query: np.ndarray, *, k: Optional[int] = None,
              top_m: Optional[int] = None, top_n: Optional[int] = None,
              disable_early_stop: bool = False) -> QueryResult:
        """Single query == a window of one through the unified executor."""
        return self.executor.run_one(query, self.plan(
            k=k, top_m=top_m, top_n=top_n,
            disable_early_stop=disable_early_stop))

    def batch_query(self, queries: np.ndarray, *, k: Optional[int] = None,
                    top_m: Optional[int] = None, top_n: Optional[int] = None,
                    disable_early_stop: bool = False) -> List[QueryResult]:
        """Per-query windows (window=1): no inter-query candidate sharing."""
        return self.executor.run(queries, self.plan(
            k=k, top_m=top_m, top_n=top_n,
            disable_early_stop=disable_early_stop, window=1))

    def query_batch_fused(self, queries: np.ndarray, *,
                          k: Optional[int] = None,
                          top_m: Optional[int] = None,
                          top_n: Optional[int] = None) -> List[QueryResult]:
        """Batched mode: one ADC scan over the UNION of the batch's
        candidate ids with all B LUTs, per-query masking + top-n —
        inter-query dedup is the paper's §4.3 redundancy insight applied
        to the scan.  One window through the unified executor."""
        return self.executor.run(queries, self.plan(
            k=k, top_m=top_m, top_n=top_n))


# ---------------------------------------------------------------------------
# Evaluation helpers
# ---------------------------------------------------------------------------

def ground_truth(data: np.ndarray, queries: np.ndarray, k: int,
                 device=None, chunk: int = 1 << 20) -> np.ndarray:
    """Exact top-k ids per query: brute-force squared L2 on ``device``,
    ``|q|² - 2q·vᵀ + |v|²`` in float32 by the ``l2dist`` kernel
    (``kernels.l2dist.l2_distances``) over chunks of rows, with a running
    (stable, lowest-id-first) top-k."""
    dev = resolve_device(device)
    q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(dev)
    best_d = torch.empty(len(q), 0, device=dev)
    best_i = torch.empty(len(q), 0, dtype=torch.int64, device=dev)
    for s in range(0, len(data), chunk):
        blk = torch.from_numpy(np.ascontiguousarray(data[s:s + chunk])).to(
            dev).float()
        d2 = l2_distances(q, blk)
        ids = torch.arange(s, s + len(blk), device=dev).expand(len(q), -1)
        cat_d = torch.cat([best_d, d2], 1)
        cat_i = torch.cat([best_i, ids], 1)
        order = torch.sort(cat_d, dim=1, stable=True)[1][:, :k]
        best_d = torch.gather(cat_d, 1, order)
        best_i = torch.gather(cat_i, 1, order)
    return best_i.cpu().numpy()


def recall_at_k(result_ids: np.ndarray, gt_ids: np.ndarray, k: int) -> float:
    """Recall@k — |result ∩ gt| / k, averaged over queries."""
    hits = 0
    for r, g in zip(np.atleast_2d(result_ids), np.atleast_2d(gt_ids)):
        hits += len(set(r[:k].tolist()) & set(g[:k].tolist()))
    return hits / (len(np.atleast_2d(gt_ids)) * k)
