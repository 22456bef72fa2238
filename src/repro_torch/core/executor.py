"""Unified query execution: ``QueryPlan`` -> ``QueryExecutor``.

Every public query entry point on :class:`~repro_torch.core.engine.
FusionANNSIndex` (``query``, ``batch_query``, ``query_batch_fused``,
``submit``) runs the SAME stage list, parameterized only by the batch
window:

  ① graph-traverse   navigation graph over centroids (DRAM tier, host)
  ② collect + dedup  posting-list vector-IDs, tombstone + predicate filter
  ③ union dedup      inter-query candidate dedup across the window — the
                     paper's §4.3 redundancy insight applied to the scan
  ④ LUT build        per-query ADC tables on the GPU
  ⑤ ADC scan         the window's candidates on the GPU
                     (``core.distributed``): the dense batch kernel over
                     the union bucket, or the fused LUT→ADC→top-k kernel
                     over each query's own rows (``fused=True``)
  ⑥ top-n merge      per-query top-n on the GPU, then host-side
                     (distance, id) lexicographic ordering
  ⑦ heuristic rerank Algorithm 1 against the SSD tier (host)

Tier placement: navigation graph + posting-list IDs in host numpy
("DRAM"); PQ codes + codebooks in GPU memory ("HBM"); raw vectors behind
the 4 KB-page SSD simulator.

Windows + pipelining: ``QueryPlan.window`` splits a batch into fixed-size
scan windows, and an ``_InflightQueue`` keeps up to ``inflight_depth``
windows dispatched: their kernels run on the CUDA stream and their
(dist, id) pairs copy into pinned host memory without blocking the host,
which meanwhile re-ranks the oldest window (DESIGN.md §3).  ``run()`` is
submit-then-wait, so every path returns bit-identical ids.  Per-request
knobs ride along as ``PlanOverrides`` without splitting the scan (the
scan uses the window-max ``top_n``; each query's merge + re-rank applies
its own effective plan).

Per-query accounting is shared: a window of size B attributes ``u = |union|``
scanned candidates and ``4u/B`` host->device bytes to each member, so
``query`` (B=1) and the fused paths report through one ``QueryStats``
schema.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.concurrency.witness import make_lock
from repro_torch.core import pq
from repro_torch.core.distributed import (sharded_adc_topn_rows,
                                          sharded_adc_topn_window, to_host,
                                          window_scan_ready)
from repro_torch.core.filters import Predicate
from repro_torch.core.futures import (BatchTicket, DeadlineExceeded,
                                      QueryFuture)
from repro_torch.core.rerank import heuristic_rerank

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.engine import FusionANNSIndex


# what every mesh entry point raises (``attach_mesh``,
# ``FusionANNSIndex.make_executor``, ``ReplicaRouter``,
# ``ServingStackConfig``) until the multi-GPU scan is ported
MESH_NOT_PORTED = ("the multi-GPU scan (a mesh) is ROADMAP queue 1 item 3 "
                   "and is not ported yet")

# additive QueryStats counters accumulated per served response — the single
# source of truth for every backend's ``stats_rollup()`` (executor, batching
# service, replica router)
QUERY_STATS_FIELDS = ("ios", "pages_requested", "buffer_hits", "ssd_bytes",
                      "h2d_bytes", "candidates_scanned",
                      "candidates_prefilter", "rerank_batches",
                      "rerank_scored")


@dataclasses.dataclass
class QueryStats:
    ios: int
    pages_requested: int
    buffer_hits: int
    ssd_bytes: int
    h2d_bytes: int               # vector-IDs sent CPU -> accelerator
    candidates_scanned: int      # PQ distance calculations (union, per window)
    candidates_prefilter: int    # union size BEFORE the predicate filter —
    #                              scanned/prefilter is the observed
    #                              selectivity, proving filtering happened
    #                              at collection, not after top-k
    rerank_batches: int
    rerank_scored: int
    early_stopped: bool
    t_graph: float = 0.0
    t_scan: float = 0.0
    t_rerank: float = 0.0


@dataclasses.dataclass
class QueryResult:
    ids: np.ndarray
    dists: np.ndarray
    stats: QueryStats


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """Per-run knobs for one pass through the unified stage list."""

    k: int
    top_m: int
    top_n: int
    rerank_batch: int = 32
    rerank_eps: float = 0.05
    rerank_beta: int = 2
    disable_early_stop: bool = False
    window: int = 0              # scan-window size; 0 = whole batch at once
    overlap_rerank: bool = False  # legacy spelling of inflight_depth=2
    inflight_depth: int = 0      # dispatched windows in flight; 0 = auto
    deadline_s: Optional[float] = None  # relative to submit(); None = never
    fused: bool = False          # stage ④⑤⑥ in one LUT→ADC→top-k kernel
    lut_int8: bool = False       # fig10 accuracy level: int8 ADC tables
    # metadata predicate (core/filters.py) applied at candidate collection
    # — stage ②/⑤ row lists shrink BEFORE the ADC scan (DESIGN.md §11)
    filter: Optional[Predicate] = None

    @staticmethod
    def from_config(cfg, *, k: Optional[int] = None,
                    top_m: Optional[int] = None, top_n: Optional[int] = None,
                    **kw) -> "QueryPlan":
        # explicit ``is None`` so k=0 / top_n=0 are honored, not conflated
        # with "use the config default"
        return QueryPlan(k=cfg.top_k if k is None else k,
                         top_m=cfg.top_m if top_m is None else top_m,
                         top_n=cfg.top_n if top_n is None else top_n,
                         rerank_batch=cfg.rerank_batch,
                         rerank_eps=cfg.rerank_eps, rerank_beta=cfg.rerank_beta,
                         **kw)

    def override(self, ov: Optional["PlanOverrides"] = None,
                 **kw) -> "QueryPlan":
        """Layered plan merge: the base, then the non-None fields of
        ``ov``, then the non-None keywords — each layer last-non-None-wins.
        Explicit zeros are honored; only ``None`` means "keep the layer
        below" (DESIGN.md §3), so ``override(PlanOverrides(k=0), k=None)``
        keeps k=0."""
        merged = {}
        if ov is not None:
            merged.update({f.name: getattr(ov, f.name)
                           for f in dataclasses.fields(ov)
                           if getattr(ov, f.name) is not None})
        merged.update({name: v for name, v in kw.items() if v is not None})
        return dataclasses.replace(self, **merged)

    def effective_depth(self) -> int:
        """In-flight window depth: explicit ``inflight_depth`` wins; else
        the legacy ``overlap_rerank`` flag maps to depth 2 (one window
        re-ranking while one scan is in flight)."""
        if self.inflight_depth:
            return max(1, self.inflight_depth)
        return 2 if self.overlap_rerank else 1


@dataclasses.dataclass(frozen=True)
class PlanOverrides:
    """Per-request layer merged onto a window's base :class:`QueryPlan`.

    Only the knobs that make sense per-query inside a shared scan window:
    the scan itself runs once at the window-max ``top_n``; ``k``/``top_n``
    shape each query's merge + re-rank, ``top_m`` its graph traversal, and
    ``deadline_s`` (relative to ``submit()``) bounds when its re-rank may
    still start."""

    k: Optional[int] = None
    top_m: Optional[int] = None
    top_n: Optional[int] = None
    deadline_s: Optional[float] = None
    filter: Optional[Predicate] = None

    def merge_into(self, plan: QueryPlan) -> QueryPlan:
        return plan.override(self)


@dataclasses.dataclass
class _Window:
    """One dispatched scan window (device work possibly still in flight)."""

    queries: np.ndarray
    plans: List[QueryPlan]       # effective (override-merged) plan per query
    per_q: List[np.ndarray]      # stage ② ids per query
    union: np.ndarray            # stage ③ deduped candidate union
    vals: torch.Tensor           # (B, tk) top-n distances, host memory
    pos: torch.Tensor            # (B, tk) bucket positions, host memory
    t_graph: float
    t_scan_host: float           # host-side LUT/gather/launch time
    start: int = 0               # global index of this window's first query
    wi: int = 0                  # window index within the ticket
    ids_global: bool = False     # fused path: ``pos`` holds physical row ids
    prefilter: int = 0           # union size before the predicate filter
    # the IndexView pinned at dispatch (DESIGN.md §10): candidate
    # collection, the scan, re-rank, and the delta merge in
    # ``_finish_into`` all read THIS epoch's binding
    view: Optional[object] = None
    # completes when ``vals``/``pos`` have landed in host memory (None on
    # the CPU, where they never left it)
    ready: Optional[torch.cuda.Event] = None


class _InflightQueue:
    """Queue of dispatched-but-unretired windows, bounded by depth.

    Depth 1 is the fully synchronous executor; depth d keeps up to d device
    scans in flight while the host re-ranks the oldest window.

    Thread-safety: every method must run under ``self._lock`` (rank
    ``inflight``, one level ABOVE the ticket's bookkeeping lock).  Callers
    acquire it first and nest the ticket lock's ``busy`` accounting INSIDE
    the inflight critical section — descending per the hierarchy — so a
    stall-checking ``BatchTicket.wait()`` can never observe ``busy == 0``
    while a window sits claimed-but-uncounted between the two locks.
    Two-phase dispatch keeps the slow host traversal OUT of both locks:
    ``reserve()`` claims a depth slot (counted by ``full()``),
    ``commit(w)`` fills it, keeping the queue ordered by window index
    even when a pump thread and a ticker dispatch concurrently.
    ``pop_ready()`` removes ANY window whose scan has landed — the
    out-of-order retirement path — while ``pop()`` stays FIFO for the
    blocking pump."""

    def __init__(self, depth: int):
        self.depth = max(1, depth)
        self._lock = make_lock("inflight")
        self._q: deque = deque()         # guarded-by: _lock
        self._reserved = 0               # guarded-by: _lock

    def __len__(self) -> int:            # holds: _lock
        return len(self._q)

    def full(self) -> bool:              # holds: _lock
        return len(self._q) + self._reserved >= self.depth

    def reserve(self) -> None:           # holds: _lock
        self._reserved += 1

    def cancel_reservation(self) -> None:    # holds: _lock
        self._reserved -= 1

    def commit(self, w: _Window) -> None:    # holds: _lock
        """Fill a reserved slot, keeping windows ordered by ``wi``."""
        self._reserved -= 1
        i = len(self._q)
        while i > 0 and self._q[i - 1].wi > w.wi:
            i -= 1
        self._q.insert(i, w)

    def pop(self) -> _Window:            # holds: _lock
        return self._q.popleft()

    def pop_ready(self, ready) -> Optional[_Window]:    # holds: _lock
        """Remove and return the first window (any position) whose scan
        has landed, or None."""
        for i, w in enumerate(self._q):
            if ready(w):
                del self._q[i]
                return w
        return None


class QueryExecutor:
    """Runs the stage list against one index on its device."""

    def __init__(self, index: "FusionANNSIndex", *, mesh=None):
        self.index = index
        # serializes stage ①-⑥ host work (traversal + LUT + launch) across
        # threads: a pump thread and a ticker may both refill depth slots
        self._dispatch_lock = make_lock("executor")
        # Backend-protocol state (DESIGN.md §6): the executor is the
        # queueless backend — submit dispatches immediately, retirement is
        # caller-driven — but it reports through the same rollup schema as
        # the service and the router
        self._backend_lock = make_lock("executor")
        if mesh is not None:
            self.attach_mesh(mesh)
        self._request_tickets: List[BatchTicket] = []   # guarded-by: _backend_lock
        self._next_rid = 0                          # guarded-by: _backend_lock
        # responses served since the last drain(); bounded like the
        # latency window so a long-lived caller that only ever reads
        # futures (never drains) stays O(1) memory
        self._undrained: deque = deque(maxlen=8192)     # guarded-by: _backend_lock
        self._latencies: deque = deque(maxlen=8192)     # guarded-by: _backend_lock
        self.query_stats = dict.fromkeys(QUERY_STATS_FIELDS, 0)  # guarded-by: _backend_lock
        self.query_stats["served"] = 0

    # locks are not deepcopy/pickle-able; a copy gets its own locks and
    # drops in-flight request tickets (their pump closures don't copy)
    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_dispatch_lock", None)
        state.pop("_backend_lock", None)
        state.pop("_request_tickets", None)
        state.pop("_planner", None)        # owns a lock; rebuilt lazily
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._dispatch_lock = make_lock("executor")
        self._backend_lock = make_lock("executor")
        self._request_tickets = []

    # ----------------------------------------------------------- adaptive
    @property
    def planner(self):
        """Lazy deadline-adaptive accuracy resolver (DESIGN.md §11):
        observes served ``QueryStats`` and suggests per-request
        ``top_m``/``top_n`` overrides that the perf model predicts meet a
        deadline.  Created on first use so non-adaptive serving pays
        nothing; its own lock is ``executor``-ranked, and ``observe()``
        must never be called while holding another executor-rank lock."""
        pl = getattr(self, "_planner", None)
        if pl is None:
            from repro_torch.core.perf_model import AdaptivePlanner
            dim = int(self.index.ssd.vectors.shape[1])
            pl = AdaptivePlanner(self.index.cfg, dim=dim)
            self._planner = pl
        return pl

    def attach_mesh(self, mesh) -> "QueryExecutor":
        """Row-sharding the codes over several GPUs is ROADMAP queue 1
        item 3 (multi-GPU scan), not yet ported."""
        raise NotImplementedError(MESH_NOT_PORTED)

    # --------------------------------------------------------------- stages
    def _lut_queries(self, queries: np.ndarray,
                     dev: torch.device) -> torch.Tensor:
        """(B, D) f32 queries in the codebooks' space, on ``dev``."""
        return torch.from_numpy(np.stack(
            [self.index._lut_query(np.asarray(q, np.float32))
             for q in queries])).to(dev)

    def _dispatch(self, queries: np.ndarray,
                  plans: Sequence[QueryPlan]) -> _Window:  # holds: _dispatch_lock
        """Stages ①-⑥: host traversal + device scan for one window, left
        running on the stream.

        Heterogeneous per-query plans share the window's scan: traversal
        uses each query's ``top_m``; the scan runs once at the window-max
        ``top_n`` and each query truncates to its own at merge time."""
        idx = self.index
        # pin ONE epoch's consistent multi-tier binding for the whole
        # window (DESIGN.md §10): traversal, gather, scan, and later the
        # re-rank + delta merge all read this view
        view = idx.view()
        t0 = time.perf_counter()
        # predicate filtering happens HERE, inside candidate collection:
        # per_q holds only matching ids, so the scan below never spends
        # ADC work on a row the filter would discard.  The pre-filter
        # union size rides along as the selectivity witness.
        pairs = [view.collect_candidates(q, p.top_m, filt=p.filter)
                 for q, p in zip(queries, plans)]
        per_q = [p[0] for p in pairs]
        union = (np.unique(np.concatenate(per_q)).astype(np.int64)
                 if sum(len(p) for p in per_q) else np.zeros((0,), np.int64))
        if any(p.filter is not None for p in plans):
            pre_lists = [p[1] for p in pairs]
            prefilter = (len(np.unique(np.concatenate(pre_lists)))
                         if sum(len(p) for p in pre_lists) else 0)
        else:
            prefilter = len(union)
        t1 = time.perf_counter()

        if plans[0].fused:
            return self._dispatch_fused(queries, plans, per_q, union,
                                        view=view, t_graph=t1 - t0,
                                        prefilter=prefilter)
        u = len(union)
        bucket = max(64, 1 << int(np.ceil(np.log2(max(u, 1)))))
        # physical code rows for the gather: ids and rows diverge once a
        # seal-time purge has run (view.row_of maps id -> row; union never
        # contains a purged id because the tombstone filter ran first)
        padded = np.zeros(bucket, np.int64)
        padded[:u] = view.row_of[union]
        # per-query membership: only a query's own candidates compete in its
        # top-n (identical semantics at every window size)
        mask = np.zeros((len(queries), bucket), bool)
        for qi, ids_q in enumerate(per_q):
            mask[qi, np.searchsorted(union, ids_q)] = True

        dev = view.codes.device
        luts = pq.adc_lut_batch(idx.codebook, self._lut_queries(queries, dev))
        cand = view.codes.index_select(0, torch.from_numpy(padded).to(dev))
        scan_top_n = max(p.top_n for p in plans)
        vals, pos = sharded_adc_topn_window(
            cand, luts, torch.from_numpy(mask).to(dev),
            min(scan_top_n, bucket))
        (vals, pos), ready = to_host(vals, pos)
        return _Window(queries=queries, plans=list(plans), per_q=per_q,
                       union=union, vals=vals, pos=pos, t_graph=t1 - t0,
                       t_scan_host=time.perf_counter() - t1, view=view,
                       prefilter=prefilter, ready=ready)

    def _dispatch_fused(self, queries: np.ndarray,
                        plans: Sequence[QueryPlan], per_q, union, *,
                        view, t_graph: float,
                        prefilter: int = 0) -> _Window:  # holds: _dispatch_lock
        """Fused form of stages ④⑤⑥ (``plan.fused``): one LUT→ADC→top-k
        kernel over per-query candidate ROW LISTS.  No union bucket,
        membership mask, or candidate gather ever materialises — the
        kernel reads the resident codes directly and only (distance, row)
        pairs come back.  Trades the §4.3 inter-query dedup of the scan
        itself for one launch; stats keep ``candidates_scanned`` = |union|
        so the two paths report through one schema."""
        idx = self.index
        t1 = time.perf_counter()
        maxlen = max((len(p) for p in per_q), default=0)
        S = max(64, 1 << int(np.ceil(np.log2(max(maxlen, 1)))))
        rows = np.full((len(queries), S), -1, np.int32)
        for qi, ids_q in enumerate(per_q):
            # candidate ids are np.unique'd => ascending, and row_of is
            # strictly increasing over live ids, so the physical row lists
            # stay ascending — pinning top-k tie-breaks to
            # smallest-row == smallest-id, same as the dense path
            rows[qi, :len(ids_q)] = view.row_of[ids_q]
        dev = view.codes.device
        scan_top_n = max(p.top_n for p in plans)
        vals, gids = sharded_adc_topn_rows(
            view.codes, self._lut_queries(queries, dev),
            idx.codebook.codebooks, torch.from_numpy(rows).to(dev),
            min(scan_top_n, S), lut_int8=plans[0].lut_int8)
        (vals, gids), ready = to_host(vals, gids)
        return _Window(queries=queries, plans=list(plans), per_q=per_q,
                       union=union, vals=vals, pos=gids, t_graph=t_graph,
                       t_scan_host=time.perf_counter() - t1,
                       ids_global=True, view=view, prefilter=prefilter,
                       ready=ready)

    def _finish_into(self, w: _Window, futures: Sequence[QueryFuture],
                     deadlines: Sequence[Optional[float]]) -> None:
        """Stages ⑥-⑦: wait for the scan's pairs, merge, re-rank against
        the SSD, and resolve ``futures[w.start + qi]`` per query.
        Cancelled futures skip their re-rank; expired deadlines resolve to
        :class:`~repro_torch.core.futures.DeadlineExceeded` instead of
        starting one."""
        idx = self.index
        B = len(w.queries)
        u = len(w.union)
        t0 = time.perf_counter()
        if w.ready is not None:
            w.ready.synchronize()          # blocks until the pairs land
        vals = w.vals.numpy()
        pos = w.pos.numpy()
        # host launch time + blocking wait: with depth > 1 the gap between
        # dispatch and finish belongs to the PREVIOUS windows' rerank, so
        # wall-clock-since-dispatch would double-count it
        t_scan = w.t_scan_host + (time.perf_counter() - t0)
        for qi, q in enumerate(w.queries):
            fut = futures[w.start + qi]
            if fut.done():                 # cancelled while queued/in flight
                continue
            dl = deadlines[w.start + qi]
            if dl is not None and time.perf_counter() > dl:
                fut._set_exception(DeadlineExceeded(
                    f"deadline passed before re-rank of query "
                    f"{w.start + qi}"))
                continue
            p = w.plans[qi]
            good = np.isfinite(vals[qi])
            # fused windows return physical code rows directly (mapped
            # back to global ids through the pinned view); dense windows
            # return positions into the padded candidate bucket, whose
            # backing ``union`` already holds global ids
            ids_sel = (w.view.id_of[pos[qi][good]] if w.ids_global
                       else w.union[pos[qi][good]])
            d_sel = vals[qi][good]
            # ascending (distance, id)
            order = np.lexsort((ids_sel, d_sel))
            n_eff = min(p.top_n, len(w.per_q[qi]))
            order_ids = ids_sel[order][:n_eff]
            t2 = time.perf_counter()
            q32 = np.asarray(q, np.float32)
            # the SSD tier is row-indexed: purge-surviving rows pack the
            # pages, so the re-rank walks physical rows and the result ids
            # map back through id_of (monotone — ordering is unchanged)
            rr = heuristic_rerank(
                q32, w.view.row_of[order_ids], idx.ssd, p.k,
                batch_size=p.rerank_batch, eps=p.rerank_eps,
                beta=p.rerank_beta,
                disable_early_stop=p.disable_early_stop)
            rr_ids = w.view.id_of[rr.ids] if len(rr.ids) else \
                rr.ids.astype(np.int64)
            ids_out, dists_out = rr_ids, rr.dists
            # delta merge (DESIGN.md §10): the pinned view's unsealed rows
            # are scanned exactly (under the SAME predicate) and merged on
            # (dist, id) — both streams are exact squared-L2, and delta
            # ids (>= n_sealed) never appear in the sealed posting lists,
            # so this is a disjoint k-way merge
            if w.view is not None and len(w.view.delta):
                d_ids, d_d2 = w.view.delta_scan(q32, filt=p.filter)
                if len(d_ids):
                    all_ids = np.concatenate([rr_ids.astype(np.int64),
                                              d_ids])
                    all_d = np.concatenate(
                        [rr.dists, d_d2.astype(rr.dists.dtype)])
                    sel = np.lexsort((all_ids, all_d))[:p.k]
                    ids_out = all_ids[sel]
                    dists_out = all_d[sel]
            stats = QueryStats(
                ios=rr.io.ios, pages_requested=rr.io.pages_requested,
                buffer_hits=rr.io.buffer_hits, ssd_bytes=rr.io.bytes_read,
                h2d_bytes=4 * u // max(B, 1),    # amortised union transfer
                candidates_scanned=u,            # union, ONCE per window
                candidates_prefilter=w.prefilter,
                rerank_batches=rr.batches_run,
                rerank_scored=rr.candidates_scored,
                early_stopped=rr.early_stopped,
                t_graph=w.t_graph / max(B, 1), t_scan=t_scan / max(B, 1),
                t_rerank=time.perf_counter() - t2)
            fut._set_result(QueryResult(ids=ids_out, dists=dists_out,
                                        stats=stats))

    # --------------------------------------------------------------- submit
    def submit(self, queries, plan: Optional[QueryPlan] = None,
               overrides: Optional[Sequence[Optional[PlanOverrides]]] = None
               ):
        """Asynchronous entry point: host-traverse + device-dispatch up to
        ``plan.effective_depth()`` windows, then return a
        :class:`~repro_torch.core.futures.BatchTicket` whose per-query
        futures resolve on demand.

        Remaining windows stay host-side and are dispatched as depth slots
        free up — the pump prefers dispatching window t+1 over blocking on
        window t's scan, which is exactly the paper's CPU/GPU overlap.

        Backend-protocol form (DESIGN.md §6): called with a single
        :class:`~repro_torch.serve.client.SearchRequest` instead of a
        query array, returns a :class:`~repro_torch.core.futures.
        QueryFuture` resolving to a :class:`~repro_torch.serve.client.
        SearchResponse`."""
        from repro_torch.serve.client import SearchRequest
        if isinstance(queries, SearchRequest):
            return self._submit_request(queries)
        if plan is None:
            raise TypeError("submit(queries, plan) requires a QueryPlan "
                            "(only the SearchRequest form may omit it)")
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        n = len(queries)
        if overrides is not None and len(overrides) != n:
            raise ValueError(f"{len(overrides)} overrides for {n} queries")
        plans = [plan if overrides is None or overrides[i] is None
                 else overrides[i].merge_into(plan) for i in range(n)]
        futures = [QueryFuture(tag=i) for i in range(n)]
        ticket = BatchTicket(futures)
        if n == 0:
            return ticket
        t_submit = time.perf_counter()
        deadlines = [None if p.deadline_s is None else t_submit + p.deadline_s
                     for p in plans]
        W = plan.window or n
        starts = list(range(0, n, W))
        inflight = _InflightQueue(plan.effective_depth())
        cursor = [0]          # next undispatched window; under inflight._lock
        lock, cond, busy = ticket._lock, ticket._cond, ticket._busy

        def _claim_dispatch() -> Optional[int]:
            """Claim the next window index + a depth slot, or None when
            nothing is dispatchable.  Takes the inflight lock first and
            bumps the ticket's ``busy`` INSIDE it (rank descends:
            inflight > ticket), so a stall-checking ``wait()`` — which
            must take the inflight lock to observe an empty queue — can
            never see the claim without its busy count."""
            with inflight._lock:               # acquires: inflight
                if cursor[0] < len(starts) and not inflight.full():
                    wi = cursor[0]
                    cursor[0] += 1
                    inflight.reserve()
                    with lock:                 # acquires: ticket
                        busy[0] += 1
                    return wi
            return None

        def _do_dispatch(wi: int) -> None:
            """Stage ①-⑥ for a claimed window — slow host work runs outside
            both locks so a concurrent retire can overlap it."""
            s = starts[wi]
            try:
                with self._dispatch_lock:
                    w = self._dispatch(queries[s:s + W], plans[s:s + W])
            except BaseException as exc:
                for qi in range(s, min(s + W, n)):
                    futures[qi]._set_exception(exc)
                with inflight._lock:           # acquires: inflight
                    inflight.cancel_reservation()
                    with cond:                 # acquires: ticket
                        busy[0] -= 1
                        cond.notify_all()
                raise
            w.start, w.wi = s, wi
            with inflight._lock:               # acquires: inflight
                inflight.commit(w)
                with cond:                     # acquires: ticket
                    ticket.events.append(("dispatch", wi))
                    busy[0] -= 1
                    cond.notify_all()

        def _retire(w: _Window) -> None:
            """Stage ⑥-⑦ for a popped window.  The ``finish`` event is
            recorded when the re-rank COMPLETES (before ``busy`` drops), so
            concurrent retirement shows up as out-of-window-order
            finishes."""
            try:
                self._finish_into(w, futures, deadlines)
            except BaseException as exc:
                for qi in range(len(w.queries)):
                    futures[w.start + qi]._set_exception(exc)
                raise
            finally:
                with cond:                         # acquires: ticket
                    ticket.events.append(("finish", w.wi))
                    busy[0] -= 1
                    cond.notify_all()

        def _pump() -> bool:
            """Blocking progress: prefer dispatching window t+1 over
            blocking on window t's scan (the paper's CPU/GPU overlap);
            retirement is FIFO from this path."""
            wi = _claim_dispatch()
            if wi is not None:
                _do_dispatch(wi)
                return True
            w = None
            with inflight._lock:                   # acquires: inflight
                if len(inflight):
                    w = inflight.pop()
                    with lock:                     # acquires: ticket
                        busy[0] += 1
            if w is not None:
                _retire(w)
                return True
            return False

        def _poll() -> bool:
            """Non-blocking progress (the ticker's entry point): retire ANY
            window whose scan landed — out of order when an older window is
            mid-re-rank on another thread — then refill depth slots."""
            progressed = False
            while True:
                with inflight._lock:               # acquires: inflight
                    w = inflight.pop_ready(
                        lambda x: window_scan_ready(x.ready))
                    if w is not None:
                        with lock:                 # acquires: ticket
                            busy[0] += 1
                if w is not None:
                    _retire(w)
                    progressed = True
                    continue
                wi = _claim_dispatch()
                if wi is None:
                    return progressed
                _do_dispatch(wi)
                progressed = True

        ticket._pump = _pump
        ticket._poll = _poll
        for f in futures:
            f._driver = _pump
        # eager phase: fill the in-flight depth before handing back
        while True:
            wi = _claim_dispatch()
            if wi is None:
                break
            _do_dispatch(wi)
        return ticket

    # ------------------------------------------------------------------ run
    def run(self, queries: np.ndarray, plan: QueryPlan) -> List[QueryResult]:
        """Submit-then-wait: bit-identical ids to ``submit()``/``result()``
        for the same plan, by construction."""
        return self.submit(queries, plan).results()

    def run_one(self, query: np.ndarray, plan: QueryPlan) -> QueryResult:
        return self.run(np.asarray(query, np.float32)[None], plan)[0]

    # ------------------------------------------------- Backend protocol
    # (DESIGN.md §6) — the executor is the queueless backend: submit
    # dispatches the request's scan window immediately (the kernels run
    # on the CUDA stream); retirement is caller-driven (``result()``
    # drives) or opportunistic via ``drain()``.

    def _submit_request(self, request) -> QueryFuture:
        from repro_torch.serve.client import response_from_result
        plan = QueryPlan.from_config(self.index.cfg, k=request.k,
                                     top_n=request.top_n,
                                     deadline_s=request.deadline_s,
                                     filter=request.filter)
        if request.adaptive and request.deadline_s is not None:
            sug = self.planner.suggest(request.deadline_s)
            if sug is not None:
                # the resolver's accuracy level shapes the scan; an
                # EXPLICIT request top_n still wins over the adaptive one
                plan = plan.override(
                    top_m=sug["top_m"],
                    top_n=None if request.top_n is not None
                    else sug["top_n"])
        t0 = time.perf_counter()
        ticket = self.submit(request.query[None], plan)
        inner = ticket.futures[0]
        with self._backend_lock:
            rid = self._next_rid
            self._next_rid += 1
            self._request_tickets = [t for t in self._request_tickets
                                     if not t.done()]
            self._request_tickets.append(ticket)

        def _drive() -> bool:
            try:
                inner.result()             # resolves ``out`` via callback
            except BaseException:          # noqa: BLE001 — stays on inner
                pass
            return True

        out = QueryFuture(tag=request.tag if request.tag is not None
                          else rid, driver=_drive)

        def _on_done(f: QueryFuture):
            latency = time.perf_counter() - t0
            try:
                res = f.result()
            except BaseException as exc:   # noqa: BLE001 — deadline/cancel
                out._set_exception(exc)
                return
            resp = response_from_result(res, latency_s=latency, rid=rid,
                                        tag=request.tag,
                                        tenant=request.tenant)
            with self._backend_lock:
                self._undrained.append(resp)
                self._latencies.append(latency)
                for field in QUERY_STATS_FIELDS:
                    self.query_stats[field] += getattr(res.stats, field)
                self.query_stats["served"] += 1
            # feed the adaptive resolver OUTSIDE _backend_lock: the
            # planner's lock is executor-ranked too, and same-rank
            # nesting is a witnessed lock-order violation
            pl = getattr(self, "_planner", None)
            if pl is not None:
                pl.observe(res.stats)
            out._set_result(resp)

        inner.add_done_callback(_on_done)
        # cancelling the client-facing future skips the query's re-rank
        out.add_done_callback(
            lambda f: inner.cancel() if f.cancelled() else None)
        return out

    def drain(self) -> List:
        """Retire every outstanding request-path ticket and return the
        responses served since the last drain (exceptions stay on their
        futures, matching the service/router drain contract)."""
        with self._backend_lock:
            tickets = list(self._request_tickets)
        for t in tickets:
            t.wait()
        with self._backend_lock:
            self._request_tickets = [t for t in self._request_tickets
                                     if not t.done()]
            out = list(self._undrained)
            self._undrained.clear()
        return out

    def stop(self) -> "QueryExecutor":
        """No threads to stop; equivalent to a final ``drain()``."""
        self.drain()
        return self

    def live_load(self) -> int:
        """Pending request-path futures (the executor has no queue, so
        this is exactly the in-flight count)."""
        with self._backend_lock:
            return sum(1 for t in self._request_tickets
                       for f in t.futures if not f.done())

    def latency_percentiles(self) -> Dict[str, float]:
        """p50/p99 of submit->resolve latency over request-path serves."""
        with self._backend_lock:
            snap = list(self._latencies)
        lat = np.asarray(snap)       # materialise OUTSIDE the lock (PU01)
        if not len(lat):
            return {"p50": 0.0, "p99": 0.0, "n": 0}
        return {"p50": float(np.percentile(lat, 50)),
                "p99": float(np.percentile(lat, 99)), "n": len(lat)}

    def stats_rollup(self) -> Dict[str, object]:
        """The shared rollup shape: summed ``QueryStats`` counters of every
        request-path response plus the served count."""
        with self._backend_lock:
            totals = {f: self.query_stats[f] for f in QUERY_STATS_FIELDS}
            served = self.query_stats["served"]
        return {"served": served, "requests": served,
                "query_stats": totals}
