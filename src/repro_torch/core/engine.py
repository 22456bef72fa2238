"""FusionANNS engine: offline index build (§3 Offline) + the 8-step online
query pipeline (§3 Online), on one GPU.

Tier placement (DESIGN.md §2):
  * navigation graph + posting-list vector-IDs  -> host numpy ("DRAM")
  * PQ codes + codebooks                        -> GPU memory ("HBM")
  * raw vectors                                 -> SSDSim (4 KB page model)

Every entry point takes ``device=None``, which means ``"cuda"``: with no
card and no device asked for, it raises.  Tests pass ``device="cpu"``,
where the kernels' plain versions run.

The tiers are described by one epoch-stamped
:class:`~repro_torch.core.segments.IndexView` (sealed segments plus the
delta segment a snapshot may carry); readers pin ``index.view()`` once per
scan window.  Insert, delete, compaction and ``save_snapshot`` come in a
later slice of the port.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ANNSConfig
from repro_torch.core import clustering, navgraph as ng, pq
from repro_torch.core.executor import (PlanOverrides, QueryExecutor,  # noqa: F401
                                       QueryPlan, QueryResult, QueryStats)
from repro_torch.core.filters import AttributeTable
from repro_torch.core.futures import BatchTicket
from repro_torch.core.io_sim import SSDSim, StorageLayout
from repro_torch.core.segments import DeltaSegment, IndexView
from repro_torch.kernels.l2dist.ops import l2_distances

# the JAX package's snapshot format (manifest.json + arrays.npz, DESIGN.md
# §10); v1 snapshots carry no id map and no attributes
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
    """The four-tier index.  The tiers of the current epoch live in
    ``self._view``, published by one reference assignment."""

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
        dim = int(ssd.vectors.shape[1])
        attrs = (AttributeTable.from_columns(n_ids, attributes)
                 if attributes else None)
        self._view = IndexView(
            epoch=0, codes=codes, posting=posting, tombstones=tomb,
            graph=graph, delta=DeltaSegment.empty(n_ids, dim),
            attrs=attrs, id_of=id_of)
        self._executor: Optional[QueryExecutor] = None
        self.build_seconds: Dict[str, float] = {}

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

    def _lut_query(self, q: np.ndarray) -> np.ndarray:
        return q @ self.rotation if self.rotation is not None else q

    # ------------------------------------------------------------------ build
    @staticmethod
    def build(data: np.ndarray, cfg: ANNSConfig, seed: int = 0,
              *, intra_merge: bool = True, use_buffer: bool = True,
              optimized_layout: bool = True, attributes=None,
              device=None) -> "FusionANNSIndex":
        """Build every tier from raw vectors ``data`` (N, D) on ``device``.
        Wall time of each stage lands in ``index.build_seconds``."""
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
        # 3. PQ codes pinned in HBM; the raw rows cross to the device once
        t = time.perf_counter()
        rows = torch.from_numpy(np.ascontiguousarray(data)).to(dev)
        cb = pq.train_codebooks(torch.Generator().manual_seed(seed), rows,
                                cfg.pq_m, cfg.pq_nbits, device=dev)
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
                                attributes=attributes)
        index.build_seconds = secs
        return index

    # ------------------------------------------------------------- snapshots
    @classmethod
    def load_snapshot(cls, path: str, device=None) -> "FusionANNSIndex":
        """Rebuild a full index — sealed tiers AND delta segment, at the
        saved epoch — from a snapshot directory the JAX package's
        ``FusionANNSIndex.save_snapshot`` wrote.  Codes and codebooks go to
        ``device``; the host tiers stay numpy.  The manifest's
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
