"""ANNS serving front-end: futures-first request queue + dynamic batching,
with an optional threaded runtime (the port's counterpart of
``repro.serve.anns_service``).

The paper's prototype binds one CPU thread per query (§5); on the card
the natural unit is a *batch* per scan.  This front-end bridges the two:
requests accumulate until ``max_batch`` or ``max_wait_s`` elapses, then
one pass through the unified ``core.executor`` pipeline serves the whole
window — inter-query candidate dedup (§4.3 applied to the scan), the
ADC kernels on the index's device, and per-request latency attribution
all come from the executor, not from per-path code.

``submit()`` takes a typed :class:`~repro_torch.serve.client.
SearchRequest` (raw-vector convenience lives in :class:`~repro_torch.
serve.client.ANNSClient` / ``as_request``) and returns a
:class:`~repro_torch.core.futures.QueryFuture` resolving DIRECTLY to a
:class:`~repro_torch.serve.client.SearchResponse` — ``fut.result().ids``
is the answer — with

* **admission control** — a bounded queue (``max_queue``); submissions past
  the bound raise :class:`BackpressureError` instead of growing latency.
  Only LIVE requests count against the bound: a burst of ``cancel()``
  calls compacts out of the queue at the next submission instead of
  occupying slots until the next pump;
* **per-request plans** — ``k``/``top_n`` ride to the executor as
  ``PlanOverrides``, so a mixed-``k`` batch is honored inside ONE shared
  scan window;
* **deadlines + cancellation** — ``deadline_s`` expires requests at batch
  formation or before their re-rank; ``fut.cancel()`` drops a queued
  request or skips its re-rank mid-flight;
* **pipelining** — ``scan_window``/``inflight_depth`` expose the
  executor's ``_InflightQueue``: a pump batch splits into scan windows and
  the rerank of window t overlaps the in-flight scans of t+1..t+d.

Two harnesses (DESIGN.md §"Threading model"):

* **synchronous** (``threaded=False``, the default — the bit-identical-ids
  guarantee): ``pump()`` drains one batch window inline; a pending future
  drives ``pump(force=True)`` from ``result()``.
* **threaded** (``threaded=True``): a dedicated *pump thread* per replica
  forms batches and drives each ticket's FIFO retirement, while a
  background *ticker thread* calls ``BatchTicket.poll()`` so windows whose
  scan already landed (their CUDA event completed) retire OUT OF ORDER
  while an older window is still re-ranking on the pump thread.  Futures
  are resolved by the pump thread; ``result()`` is a real
  condition-variable wait.  ``stop()`` drains the queue gracefully (zero
  pending futures survive shutdown).

A window's kernels, its copy to the host and the CUDA event that marks
the copy all go on the dispatching thread's current stream (the device's
default stream in a fresh thread; ``core.distributed.to_host``), so the
ticker's ``window_scan_ready`` query, from another thread, always pairs
with the copy it guards.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.analysis.concurrency.witness import make_condition, make_rlock
from repro_torch.core.engine import FusionANNSIndex
# QUERY_STATS_FIELDS lives in core.executor (next to the QueryStats
# schema); re-exported here
from repro_torch.core.executor import QUERY_STATS_FIELDS, PlanOverrides
from repro_torch.core.futures import (BackpressureError, DeadlineExceeded,
                                FutureError, QueryFuture)
from repro_torch.serve.client import (SearchRequest, SearchResponse,
                                response_from_result)

__all__ = ["BatchingANNSService", "Request",
           "BackpressureError", "DeadlineExceeded", "QueryFuture",
           "QUERY_STATS_FIELDS"]


@dataclasses.dataclass
class Request:
    rid: int
    query: np.ndarray
    t_enqueue: float
    k: Optional[int] = None
    top_n: Optional[int] = None
    deadline: Optional[float] = None      # absolute perf_counter time
    future: Optional[QueryFuture] = None
    tag: object = None                    # caller correlation handle
    tenant: Optional[str] = None          # multi-tenant attribution (edge)
    filter: object = None                 # metadata predicate (DESIGN.md §11)
    adaptive: bool = False                # deadline-adaptive accuracy opt-in


class BatchingANNSService:
    def __init__(self, index: FusionANNSIndex, *, max_batch: int = 32,
                 max_wait_s: float = 0.002, scan_window: int = 0,
                 overlap_rerank: bool = False, inflight_depth: int = 0,
                 max_queue: int = 1024, threaded: bool = False,
                 tick_interval_s: float = 2e-4, executor=None,
                 fused: bool = False, lut_int8: bool = False):
        # ``executor`` lets a replica run its OWN pipeline instance over
        # the shared index (multi-replica routing, serve/router.py: each
        # replica owns its executor and dispatch lock); default is the
        # index's shared executor
        self.index = index
        self.executor = executor if executor is not None else index.executor
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.scan_window = scan_window
        self.overlap_rerank = overlap_rerank
        self.inflight_depth = inflight_depth
        # fused LUT→ADC→top-k scan pipeline (plan knob; DESIGN.md §2) and
        # the fig10 int8-LUT accuracy level, inherited by every batch this
        # replica serves
        self.fused = fused
        self.lut_int8 = lut_int8
        self.max_queue = max_queue
        self.tick_interval_s = tick_interval_s
        # one lock guards queue + stats + latencies; the condition wakes
        # the pump thread on submissions and shutdown
        self._lock = make_rlock("service")
        self._cv = make_condition("service", self._lock)
        self._queue: Deque[Request] = deque()     # guarded-by: _lock
        self._next_rid = 0                        # guarded-by: _lock
        self.stats: Dict[str, float] = {
            "batches": 0, "requests": 0, "mean_batch": 0.0,
            "rejected": 0, "expired": 0, "cancelled": 0}  # guarded-by: _lock
        # summed QueryStats counters of every response this replica served
        # (the router's cross-replica rollup reads these); "served" counts
        # only the responses that actually contributed — cancelled/expired
        # requests appear in ``stats`` but never here
        self.query_stats: Dict[str, int] = dict.fromkeys(
            QUERY_STATS_FIELDS, 0)                # guarded-by: _lock
        self.query_stats["served"] = 0
        # enqueue -> resolve per request; bounded so a long-lived replica's
        # percentile window stays O(1) memory (sliding, newest-wins)
        self.latencies_s: Deque[float] = deque(maxlen=8192)  # guarded-by: _lock
        # responses served since the last drain() — the Backend-protocol
        # drain contract; bounded like the latency window so a long-lived
        # replica that is never drained stays O(1) memory
        self._undrained: Deque[SearchResponse] = deque(maxlen=8192)  # guarded-by: _lock
        # per-batch executor event logs (the out-of-order retirement probe)
        self.ticket_events: Deque[List[Tuple[str, int]]] = deque(maxlen=256)  # guarded-by: _lock
        # threaded runtime
        self.threaded = False
        self._running = False                     # guarded-by: _lock
        self._ticker_stop = False
        self._serving = 0   # batches between formation+resolve; guarded-by: _lock
        self._in_flight = 0  # requests inside a forming batch; guarded-by: _lock
        # lock-free single-writer handoff: only _serve_batch_inner (pump
        # thread) writes it; the ticker reads a snapshot and tolerates
        # staleness, so it is deliberately NOT guarded
        self._active_ticket = None
        self._ticker_cv = make_condition("service")   # parks the idle ticker
        self._pump_thread: Optional[threading.Thread] = None
        self._ticker_thread: Optional[threading.Thread] = None
        if threaded:
            self.start()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "BatchingANNSService":
        """Start the pump + ticker threads (idempotent)."""
        with self._lock:
            if self._running:
                return self
            self._running = True
            self._ticker_stop = False
            self.threaded = True
        self._pump_thread = threading.Thread(
            target=self._pump_loop, name="anns-pump", daemon=True)
        self._ticker_thread = threading.Thread(
            target=self._ticker_loop, name="anns-ticker", daemon=True)
        self._pump_thread.start()
        self._ticker_thread.start()
        return self

    def stop(self) -> "BatchingANNSService":
        """Graceful shutdown: the pump thread drains every queued request
        (resolving all futures), then both threads exit.  Idempotent."""
        with self._cv:
            if not self._running and self._pump_thread is None:
                return self
            self._running = False
            self._cv.notify_all()
        if self._pump_thread is not None:
            self._pump_thread.join()
            self._pump_thread = None
        self._ticker_stop = True
        with self._ticker_cv:
            self._ticker_cv.notify_all()
        if self._ticker_thread is not None:
            self._ticker_thread.join()
            self._ticker_thread = None
        self.threaded = False
        return self

    def __enter__(self) -> "BatchingANNSService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # --------------------------------------------------------------- submit
    def submit(self, request: SearchRequest) -> QueryFuture:
        """Enqueue one request; returns its future immediately, resolving
        to a :class:`~repro_torch.serve.client.SearchResponse`.  ``request``
        must be a typed :class:`~repro_torch.serve.client.SearchRequest` (the
        Backend-protocol form; raw-vector convenience lives in
        :class:`~repro_torch.serve.client.ANNSClient` / ``as_request``).

        Raises :class:`BackpressureError` when the queue holds
        ``max_queue`` LIVE requests — cancelled requests are compacted out
        before the admission decision, so a cancel burst frees its slots
        for fresh submissions."""
        if not isinstance(request, SearchRequest):
            raise TypeError(
                "submit() takes a SearchRequest; wrap raw query vectors "
                "with as_request(...) or use ANNSClient "
                f"(got {type(request).__name__})")
        query, k, top_n = request.query, request.k, request.top_n
        deadline_s, tag = request.deadline_s, request.tag
        # materialise the query BEFORE taking the lock: np.asarray on a
        # device tensor is a host sync every other submitter would stall on
        q_arr = np.asarray(query, np.float32)
        with self._cv:
            if len(self._queue) >= self.max_queue:
                self._compact_locked()
            if len(self._queue) >= self.max_queue:
                self.stats["rejected"] += 1
                raise BackpressureError(
                    f"queue full ({self.max_queue} pending); retry later")
            rid = self._next_rid
            self._next_rid += 1
            now = time.perf_counter()
            # key off _running (not .threaded): both are read under _cv, and
            # the pump thread's exit check holds the same lock — so either
            # the pump thread still sees this request (blocking future), or
            # we already observe the shutdown and fall back to the caller-
            # driven future, which pump(force=True) from result() can serve
            threaded = self._running
            fut = QueryFuture(tag=rid if tag is None else tag,
                              driver=None if threaded else self._drive,
                              blocking=threaded)  # fut.tag == rid (no tag)
            self._queue.append(Request(
                rid, q_arr, now, k=k, top_n=top_n,
                deadline=None if deadline_s is None else now + deadline_s,
                future=fut, tag=tag, tenant=request.tenant,
                filter=request.filter, adaptive=request.adaptive))
            self._cv.notify_all()
        return fut

    def _compact_locked(self) -> None:            # holds: _lock
        """Eager-drop cancelled requests (must hold ``_lock``)."""
        live = deque()
        for r in self._queue:
            if r.future is not None and r.future.cancelled():
                self.stats["cancelled"] += 1
            else:
                live.append(r)
        self._queue = live

    def _drive(self) -> bool:
        """Future-side driver (synchronous harness): a pending future
        forces a pump."""
        with self._lock:
            empty = not self._queue
        if empty:
            return False
        self.pump(force=True)
        return True

    # -------------------------------------------------------------- threads
    def _pump_loop(self) -> None:
        """Dedicated pump thread: sleep until a batch window matures (or
        shutdown), serve it, repeat.  On shutdown it drains the queue so
        no future is left pending.

        A failing batch does not kill the replica: its futures were
        already resolved with the error (``_serve_batch``), the failure is
        counted, and the loop keeps serving.  Only non-``Exception``
        escapes (interpreter teardown) stop the thread — after resolving
        every queued future so no waiter hangs."""
        try:
            while True:
                with self._cv:
                    while self._running and \
                            not self._window_ready(time.perf_counter()):
                        if self._queue:
                            age = time.perf_counter() \
                                - self._queue[0].t_enqueue
                            self._cv.wait(max(self.max_wait_s - age, 1e-4))
                        else:
                            self._cv.wait()
                    if not self._running and not self._queue:
                        return
                    force = not self._running   # read under _cv, used after
                try:
                    self.pump(force=force)
                except Exception:             # noqa: BLE001 — poison batch
                    with self._lock:
                        self.stats["pump_errors"] = \
                            self.stats.get("pump_errors", 0) + 1
        except BaseException as exc:          # fail loudly, not silently
            self._fail_pending(exc)
            raise

    def _ticker_loop(self) -> None:
        """Background ticker: opportunistic out-of-order retirement.  Polls
        the in-flight ticket so windows whose scan landed retire
        while the pump thread is still re-ranking an older window.  Parks
        on a condition variable while no ticket is active (no busy-wake on
        an idle replica); any poll error is counted and survived — losing
        the ticker must never silently degrade the replica."""
        while not self._ticker_stop:
            ticket = self._active_ticket
            if ticket is None:
                with self._ticker_cv:
                    if self._active_ticket is None and not self._ticker_stop:
                        self._ticker_cv.wait(0.05)
                continue
            try:
                ticket.poll()
            except Exception:                 # noqa: BLE001 — stay alive;
                with self._lock:              # errors live on the futures
                    self.stats["ticker_errors"] = \
                        self.stats.get("ticker_errors", 0) + 1
            time.sleep(self.tick_interval_s)

    def _fail_pending(self, exc: BaseException) -> None:
        """Resolve every queued future with ``exc`` (pump thread died)."""
        with self._cv:
            while self._queue:
                r = self._queue.popleft()
                if r.future is not None:
                    r.future._set_exception(
                        FutureError(f"serving pump failed: {exc!r}"))

    # ----------------------------------------------------------------- pump
    def _window_ready(self, now: float) -> bool:  # holds: _lock
        if not self._queue:
            return False
        if len(self._queue) >= self.max_batch:
            return True
        return (now - self._queue[0].t_enqueue) >= self.max_wait_s

    def pump(self, force: bool = False) -> List[SearchResponse]:
        """Serve at most one batch window; returns its responses.

        Cancelled requests are dropped at batch formation; requests whose
        deadline already passed resolve to :class:`DeadlineExceeded`
        without consuming a batch slot.  In the threaded runtime this runs
        on the pump thread; batch formation and stats are lock-guarded,
        the executor work runs outside the lock so submissions never block
        behind a scan."""
        now = time.perf_counter()
        batch: List[Request] = []
        with self._lock:
            if not (force and self._queue) and not self._window_ready(now):
                return []
            self._serving += 1
            while self._queue and len(batch) < self.max_batch:
                r = self._queue.popleft()
                if r.future is not None and r.future.cancelled():
                    self.stats["cancelled"] += 1
                    continue
                if r.deadline is not None and now > r.deadline:
                    self.stats["expired"] += 1
                    if r.future is not None:
                        r.future._set_exception(DeadlineExceeded(
                            f"request {r.rid} expired in queue"))
                    continue
                batch.append(r)
            self._in_flight += len(batch)
        try:
            return self._serve_batch(batch)
        finally:
            with self._lock:
                self._serving -= 1
                self._in_flight -= len(batch)

    def _serve_batch(self, batch: List[Request]) -> List[SearchResponse]:
        if not batch:
            return []
        try:
            return self._serve_batch_inner(batch)
        except BaseException as exc:
            # the batch is already out of the queue, so _fail_pending can't
            # reach it: resolve its futures here or their waiters hang
            for r in batch:
                if r.future is not None:
                    r.future._set_exception(
                        FutureError(f"serving pump failed: {exc!r}"))
            raise

    def _serve_batch_inner(self, batch: List[Request]
                           ) -> List[SearchResponse]:
        queries = np.stack([r.query for r in batch])
        plan = self.index.plan(window=self.scan_window,
                               overlap_rerank=self.overlap_rerank,
                               inflight_depth=self.inflight_depth,
                               fused=self.fused, lut_int8=self.lut_int8)
        t0 = time.perf_counter()
        # per-request knobs reach the executor as PlanOverrides — one shared
        # scan window honors a mixed-k batch (deadline re-based to submit).
        # An adaptive request with a still-live deadline lets the perf-model
        # resolver shrink its top_m/top_n to the cheapest accuracy level
        # predicted to fit (explicit caller knobs win over the suggestion).
        overrides = []
        for r in batch:
            top_m, top_n = None, r.top_n
            dl = None if r.deadline is None else r.deadline - t0
            if r.adaptive and dl is not None and dl > 0:
                sug = self.executor.planner.suggest(dl)
                if sug is not None:
                    top_m = sug["top_m"]
                    if top_n is None:
                        top_n = sug["top_n"]
            overrides.append(PlanOverrides(k=r.k, top_m=top_m, top_n=top_n,
                                           deadline_s=dl, filter=r.filter))
        ticket = self.executor.submit(queries, plan, overrides=overrides)
        # propagate cancellations that raced the batch formation
        for r, f in zip(batch, ticket.futures):
            if r.future is not None and r.future.cancelled():
                f.cancel()
        self._active_ticket = ticket          # ticker may now poll it
        with self._ticker_cv:
            self._ticker_cv.notify_all()
        try:
            ticket.wait()                     # exceptions stay on the futures
        finally:
            self._active_ticket = None
            events = list(ticket.events)      # stable: wait() barriered
            with self._lock:
                self.ticket_events.append(events)
        t_serve = time.perf_counter() - t0
        # per-request attribution: shared wall-clock + the executor's
        # per-query stage timings (res.stats.t_graph/t_scan/t_rerank)
        responses: List[SearchResponse] = []
        t_done = time.perf_counter()
        with self._lock:
            self.stats["batches"] += 1
            self.stats["requests"] += len(batch)
            self.stats["mean_batch"] = (self.stats["requests"]
                                        / self.stats["batches"])
            for r, f in zip(batch, ticket.futures):
                if f.cancelled():
                    self.stats["cancelled"] += 1
                    continue
                exc = f.exception()
                if exc is not None:
                    self.stats["expired"] += isinstance(exc, DeadlineExceeded)
                    if r.future is not None:
                        r.future._set_exception(exc)
                    continue
                res = f.result()
                resp = response_from_result(
                    res, latency_s=t_done - r.t_enqueue, rid=r.rid,
                    tag=r.tag, tenant=r.tenant, t_queue_s=t0 - r.t_enqueue,
                    t_serve_s=t_serve, batch_size=len(batch))
                for field in QUERY_STATS_FIELDS:
                    self.query_stats[field] += getattr(res.stats, field)
                self.query_stats["served"] += 1
                if r.future is not None:
                    r.future._set_result(resp)
                self.latencies_s.append(t_done - r.t_enqueue)
                self._undrained.append(resp)
                responses.append(resp)
        # feed the deadline-adaptive resolver OUTSIDE the service lock:
        # its lock is executor-ranked (below service, but observe() also
        # runs a perf-model update that must not serialize submissions).
        # The planner is lazy — it only exists once an adaptive request
        # has asked for a suggestion, so non-adaptive serving pays nothing.
        pl = getattr(self.executor, "_planner", None)
        if pl is not None:
            for resp in responses:
                pl.observe(resp.stats)
        return responses

    def drain(self) -> List[SearchResponse]:
        """Serve everything currently queued or in flight, then return the
        responses served since the last drain — the SAME objects the
        per-request futures resolve to (the unified Backend drain
        contract).
        Synchronous harness: pumps inline; threaded harness: blocks until
        the pump thread goes idle."""
        if self.threaded:
            while True:
                with self._lock:
                    idle = not self._queue and self._serving == 0
                if idle:
                    return self._pop_undrained()
                time.sleep(1e-3)
        while True:
            with self._lock:
                empty = not self._queue
            if empty:
                break
            self.pump(force=True)
        return self._pop_undrained()

    def _pop_undrained(self) -> List[SearchResponse]:
        with self._lock:
            out = list(self._undrained)
            self._undrained.clear()
        return out

    # ---------------------------------------------------------------- stats
    @property
    def epoch(self) -> int:
        """The index's segment-list epoch (DESIGN.md §10) — exposed so
        coalescing layers key result identity on index state."""
        return self.index.epoch

    def live_load(self) -> int:
        """Admission-state load: LIVE (uncancelled) queued requests plus
        requests inside a forming or in-flight batch.  This is what the
        router's join-shortest-queue policy reads — cancelled-but-not-yet-
        compacted requests don't count, so a cancel burst doesn't repel
        traffic from an actually idle replica."""
        with self._lock:
            queued = sum(1 for r in self._queue
                         if r.future is None or not r.future.cancelled())
            return queued + self._in_flight

    def latency_percentiles(self) -> Dict[str, float]:
        """p50/p99 of per-request enqueue->resolve latency (seconds)."""
        with self._lock:
            snap = list(self.latencies_s)
        lat = np.asarray(snap)       # materialise OUTSIDE the lock (PU01)
        if not len(lat):
            return {"p50": 0.0, "p99": 0.0, "n": 0}
        return {"p50": float(np.percentile(lat, 50)),
                "p99": float(np.percentile(lat, 99)),
                "n": len(lat)}

    def stats_rollup(self) -> Dict[str, object]:
        """Single-replica rollup in the router's shape (the Backend
        protocol's uniform reporting surface): service counters plus the
        summed ``QueryStats`` of every served response."""
        with self._lock:
            out: Dict[str, object] = dict(self.stats)
            out["served"] = self.query_stats["served"]
            out["query_stats"] = {f: self.query_stats[f]
                                  for f in QUERY_STATS_FIELDS}
        return out
