"""One serving API: typed requests/responses, a common ``Backend``
protocol, and sync + asyncio front doors (the port's counterpart of
``repro.serve.client``).

The executor, the batching service and the replica router each take
requests; this module gives them one contract (DESIGN.md §6):

* :class:`SearchRequest` / :class:`SearchResponse` — the typed request/
  response pair every serving path speaks.  A response always exposes
  ``ids`` / ``dists`` / ``stats`` (the shared ``QueryStats`` schema) plus
  ``latency_s`` (submit→resolve) and the serving attribution fields.
* :class:`Backend` — the protocol the executor, the batching service, and
  the replica router all implement: ``submit(request) -> QueryFuture``
  (resolving to a :class:`SearchResponse`), ``drain()`` (returns the
  responses served since the last drain — the service/router drain
  contracts are unified here), ``stop()``, ``live_load()``,
  ``latency_percentiles()``, ``stats_rollup()``.  Any front end composes
  with any backend.
* :class:`ANNSClient` — the synchronous front door: ``search()`` blocks
  through admission (no :class:`BackpressureError` reaches the caller)
  and returns the response.
* :class:`AsyncANNSClient` — the asyncio front door over the router (or
  any backend): ``await client.search(req)``, ``search_many()`` streaming
  results in completion order, backpressure that AWAITS admission instead
  of raising, and deadlines mapped to asyncio timeouts.  One event loop
  drives thousands of in-flight requests over N threaded replicas; the
  bridge is ``QueryFuture.add_done_callback`` +
  ``loop.call_soon_threadsafe`` — no thread per request.
* :func:`coalesce_key` / :class:`RequestCoalescer` — the coalescing
  hooks (DESIGN.md §8): identical in-flight queries (same query bytes AND
  same effective plan knobs — k, top_n, deadline_s, fused, lut_int8)
  share ONE backend submit.  Late arrivals get a fresh *attached* future
  mirroring the leader's via ``add_done_callback``; cancelling an
  attached waiter never cancels the shared backend future.  The HTTP
  edge (``serve/edge.py``) turns this on by default; any
  ``AsyncANNSClient`` can opt in via ``coalescer=``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import (Any, AsyncIterator, Callable, Dict, Iterable, List,
                    Optional,
                    Protocol, Sequence, runtime_checkable)

import numpy as np

from repro_torch.analysis.concurrency.witness import make_lock
from repro_torch.core.executor import QueryResult, QueryStats
from repro_torch.core.futures import (BackpressureError, DeadlineExceeded,
                                QueryFuture)

__all__ = ["SearchRequest", "SearchResponse", "Backend", "ANNSClient",
           "AsyncANNSClient", "as_request", "coalesce_key",
           "RequestCoalescer"]


# ---------------------------------------------------------------------------
# Typed request / response
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SearchRequest:
    """One search, fully specified.  ``None`` knobs mean "the index
    config's default" (merged via ``PlanOverrides`` — explicit zeros are
    honored, only ``None`` defers)."""

    query: np.ndarray
    k: Optional[int] = None             # results wanted
    top_n: Optional[int] = None         # re-rank candidate budget
    deadline_s: Optional[float] = None  # relative to submit(); None = never
    tag: Any = None                     # caller correlation handle
    tenant: Optional[str] = None        # multi-tenant attribution (the HTTP
    #                                     edge stamps this from the API key)
    filter: Optional[Any] = None        # metadata predicate (core/filters);
    #                                     the tenant layer conjoins its base
    #                                     predicate underneath this one
    adaptive: bool = False              # let the deadline-adaptive planner
    #                                     pick top_m/top_n for deadline_s

    def __post_init__(self):
        self.query = np.asarray(self.query, np.float32)


@dataclasses.dataclass
class SearchResponse:
    """What every serving path resolves to.

    ``ids``/``dists``/``stats`` are the query result proper; ``latency_s``
    is submit→resolve wall clock; ``rid``/``tag`` correlate with the
    request; the ``t_queue_s``/``t_serve_s``/``batch_size`` attribution
    fields are filled by the batching tiers (a direct executor serve
    reports ``batch_size=1`` and zero queueing)."""

    ids: np.ndarray
    dists: np.ndarray
    stats: QueryStats
    latency_s: float = 0.0
    rid: int = -1
    tag: Any = None
    tenant: Optional[str] = None     # rides from the request (edge auth)
    t_queue_s: float = 0.0           # time waiting for the batch window
    t_serve_s: float = 0.0           # batch execution time (shared)
    batch_size: int = 1


def as_request(query, k: Optional[int] = None, *,
               top_n: Optional[int] = None,
               deadline_s: Optional[float] = None,
               tag: Any = None, tenant: Optional[str] = None,
               filter: Optional[Any] = None,
               adaptive: Optional[bool] = None) -> SearchRequest:
    """Normalize a raw query vector + kwargs into a :class:`SearchRequest`
    (the front-door convenience used by :class:`ANNSClient` /
    :class:`AsyncANNSClient`; backend ``submit`` methods take the typed
    request only).  A ready-made request passes through untouched —
    unless explicit kwargs ride along, which override its fields (a
    fresh request, never a mutation) instead of being silently dropped."""
    if isinstance(query, SearchRequest):
        over = {name: v for name, v in (
            ("k", k), ("top_n", top_n), ("deadline_s", deadline_s),
            ("tag", tag), ("tenant", tenant), ("filter", filter),
            ("adaptive", adaptive)) if v is not None}
        return dataclasses.replace(query, **over) if over else query
    return SearchRequest(query=query, k=k, top_n=top_n,
                         deadline_s=deadline_s, tag=tag, tenant=tenant,
                         filter=filter, adaptive=bool(adaptive))


def response_from_result(res: QueryResult, *, latency_s: float,
                         rid: int = -1, tag: Any = None,
                         tenant: Optional[str] = None,
                         t_queue_s: float = 0.0, t_serve_s: float = 0.0,
                         batch_size: int = 1) -> SearchResponse:
    """Wrap an executor :class:`QueryResult` in the uniform response."""
    return SearchResponse(ids=res.ids, dists=res.dists, stats=res.stats,
                          latency_s=latency_s, rid=rid, tag=tag,
                          tenant=tenant, t_queue_s=t_queue_s,
                          t_serve_s=t_serve_s, batch_size=batch_size)


# ---------------------------------------------------------------------------
# The Backend protocol
# ---------------------------------------------------------------------------

@runtime_checkable
class Backend(Protocol):
    """The uniform serving surface (DESIGN.md §6).

    Implemented by :class:`~repro_torch.core.executor.QueryExecutor` (no
    queue: dispatch at submit, caller-driven retirement),
    :class:`~repro_torch.serve.anns_service.BatchingANNSService` (dynamic
    batching, one replica), and :class:`~repro_torch.serve.router.
    ReplicaRouter` (N replicas over one index).  Every ``submit`` future
    resolves to a :class:`SearchResponse`."""

    def submit(self, request: SearchRequest) -> QueryFuture: ...  # noqa: E704

    def drain(self) -> List[SearchResponse]: ...                  # noqa: E704

    def stop(self): ...                                           # noqa: E704

    def live_load(self) -> int: ...                               # noqa: E704

    def latency_percentiles(self) -> Dict[str, float]: ...        # noqa: E704

    def stats_rollup(self) -> Dict[str, object]: ...              # noqa: E704


# ---------------------------------------------------------------------------
# Request coalescing (DESIGN.md §8)
# ---------------------------------------------------------------------------

def coalesce_key(request: SearchRequest, *, fused: bool = False,
                 lut_int8: bool = False,
                 epoch: Optional[int] = None) -> tuple:
    """Identity of the backend work a request triggers: the query bytes
    plus EVERY effective plan knob — ``k``/``top_n``/``deadline_s`` from
    the request and the serving stack's ``fused``/``lut_int8`` accuracy
    knobs — plus the index's segment-list ``epoch``.  Two requests may
    share one backend submit iff their keys are equal; anything that
    could change the returned ids (or the latency contract, for
    deadlines) keys separately.  The epoch is what keeps coalescing
    honest under streaming updates (DESIGN.md §10): an insert/delete/
    compaction bumps it, so a request arriving after a mutation never
    attaches to a leader dispatched against the pre-mutation view.
    ``filter``, ``tenant``, and ``adaptive`` key separately too
    (DESIGN.md §11): the predicate changes the candidate set, the tenant
    determines the base predicate the tenant layer will stamp (two
    tenants' identical queries must NEVER share a scan — isolation, not
    just correctness), and an adaptive request may serve at a reduced
    accuracy level.  Only ``tag`` is correlation metadata outside the
    key — attached waiters get their own tag stamped onto the shared
    response."""
    q = np.ascontiguousarray(np.asarray(request.query, np.float32))
    return (q.tobytes(), q.shape, request.k, request.top_n,
            request.deadline_s, bool(fused), bool(lut_int8), epoch,
            request.filter, request.tenant, bool(request.adaptive))


class RequestCoalescer:
    """Share one backend submit among identical in-flight requests.

    The first arrival for a key is the LEADER: ``claim()`` hands back the
    key, the caller performs the real (possibly awaited) backend submit,
    then ``publish()`` binds the backend future.  Late arrivals for the
    same key get an ATTACHED future — a fresh :class:`QueryFuture`
    mirroring the leader's via ``add_done_callback``, with their own
    ``tag``/``tenant`` stamped onto the shared :class:`SearchResponse`.
    Cancelling an attached waiter flips only that waiter; the shared
    backend future (and every other waiter) is untouched.  When the
    leader's future resolves the key retires, so a later identical
    request starts a fresh submit (coalescing is an IN-FLIGHT dedup, not
    a response cache).

    Thread-safe: the edge's event loop, replica pump threads (resolving
    leaders), and sync callers may all touch one coalescer."""

    def __init__(self, *, fused: bool = False, lut_int8: bool = False,
                 epoch_source: Optional[Callable[[], int]] = None):
        self.fused = fused
        self.lut_int8 = lut_int8
        # () -> current index epoch (e.g. ``lambda: backend.epoch``);
        # sampled at claim time so a mutation between two identical
        # requests forces the second into its own leader submit
        self.epoch_source = epoch_source
        self._lock = make_lock("coalescer")
        # key -> [master future or None (leader mid-admission), waiters]
        self._inflight: Dict[tuple, list] = {}    # guarded-by: _lock
        self.stats: Dict[str, int] = {
            "leaders": 0, "attached": 0}          # guarded-by: _lock

    def key(self, request: SearchRequest) -> tuple:
        epoch = (None if self.epoch_source is None
                 else int(self.epoch_source()))
        return coalesce_key(request, fused=self.fused,
                            lut_int8=self.lut_int8, epoch=epoch)

    def live(self) -> int:
        """Keys currently in flight (leader submitted or mid-admission)."""
        with self._lock:
            return len(self._inflight)

    def claim(self, request: SearchRequest):
        """Returns ``(True, key)`` when the caller must perform the real
        backend submit (leader; follow with ``publish``/``abandon``), or
        ``(False, attached_future)`` when an identical request is already
        in flight."""
        k = self.key(request)
        with self._lock:
            entry = self._inflight.get(k)
            if entry is not None:
                master = entry[0]
                if master is None or not master.done():
                    self.stats["attached"] += 1
                    fut = self._make_attached(request)
                    if master is None:       # leader still mid-admission
                        entry[1].append((fut, request))
                    else:
                        self._mirror(master, fut, request)
                    return False, fut
                # leader resolved between retire and this claim: recycle
                del self._inflight[k]
            self._inflight[k] = [None, []]
            self.stats["leaders"] += 1
            return True, k

    def publish(self, key: tuple, master: QueryFuture) -> None:
        """Leader's backend submit succeeded: bind the shared future and
        wire every waiter that queued up during admission."""
        with self._lock:
            entry = self._inflight.get(key)
            if entry is None:
                return
            entry[0] = master
            waiters, entry[1] = entry[1], []
        for fut, req in waiters:
            self._mirror(master, fut, req)
        master.add_done_callback(lambda _f: self._retire(key, master))

    def abandon(self, key: tuple, exc: Optional[BaseException]) -> None:
        """Leader's submit failed (client closed, admission error): fail
        any queued waiters and free the key for the next arrival."""
        with self._lock:
            entry = self._inflight.pop(key, None)
        if entry is None:
            return
        for fut, _req in entry[1]:
            if exc is not None:
                fut._set_exception(exc)
            else:
                fut.cancel()

    # ------------------------------------------------------------- internal
    def _retire(self, key: tuple, master: QueryFuture) -> None:
        with self._lock:
            entry = self._inflight.get(key)
            if entry is not None and entry[0] is master:
                del self._inflight[key]

    @staticmethod
    def _make_attached(request: SearchRequest) -> QueryFuture:
        # blocking=True: resolution always comes from the leader's resolver
        # thread via the mirror callback — there is no driver to run
        return QueryFuture(tag=request.tag, blocking=True)

    @staticmethod
    def _mirror(master: QueryFuture, fut: QueryFuture,
                request: SearchRequest) -> None:
        def _copy(f: QueryFuture):
            if fut.done():                  # waiter cancelled on its own
                return
            try:
                resp = f.result()
            except BaseException as exc:    # noqa: BLE001 — incl. Cancelled
                fut._set_exception(exc)
                return
            if isinstance(resp, SearchResponse):
                resp = dataclasses.replace(resp, tag=request.tag,
                                           tenant=request.tenant)
            fut._set_result(resp)
        master.add_done_callback(_copy)


# ---------------------------------------------------------------------------
# Synchronous front door
# ---------------------------------------------------------------------------

class ANNSClient:
    """Blocking client over any :class:`Backend`.

    ``search()`` never surfaces :class:`BackpressureError`: a rejected
    submission waits (``admission_wait_s`` backoff) for the backend to
    drain a slot, then retries — the caller sees admission latency, not an
    exception."""

    def __init__(self, backend: Backend, *, admission_wait_s: float = 1e-3,
                 admission_timeout_s: Optional[float] = None):
        self.backend = backend
        self.admission_wait_s = admission_wait_s
        self.admission_timeout_s = admission_timeout_s
        # a sync client is routinely shared by N producer threads (the
        # examples' drive_producers shape): counters and the stray buffer
        # are lock-guarded so none of them undercount under contention
        self._lock = make_lock("client")
        self.stats: Dict[str, int] = {
            "submitted": 0, "admission_waits": 0}  # guarded-by: _lock
        # responses a caller-driven backend served while WE drained it to
        # free admission slots: the drain contract owes them to whoever
        # calls drain(), so they stay reachable here instead of vanishing
        self.stray_responses: List[SearchResponse] = []  # guarded-by: _lock

    def submit(self, request, k: Optional[int] = None, *,
               top_n: Optional[int] = None,
               deadline_s: Optional[float] = None,
               tag: Any = None) -> QueryFuture:
        """Admit one request (blocking through backpressure); returns the
        backend's future.

        A threaded backend frees slots on its own: rejection becomes a
        plain sleep-retry (never a full-idle ``drain()`` barrier, and the
        backend owner's undrained-responses buffer is left alone).  A
        caller-driven sync-harness backend only makes progress when WE
        pump it: prefer its ``pump()`` surface (keeps the drain contract
        intact); failing that, fall back to ``drain()`` after repeated
        rejections, stashing the responses in ``stray_responses``."""
        req = as_request(request, k, top_n=top_n, deadline_s=deadline_s,
                         tag=tag)
        t0 = time.perf_counter()
        tries = 0
        pump = getattr(self.backend, "pump", None)
        while True:
            try:
                fut = self.backend.submit(req)
            except BackpressureError:
                with self._lock:
                    self.stats["admission_waits"] += 1
                if (self.admission_timeout_s is not None and
                        time.perf_counter() - t0 > self.admission_timeout_s):
                    raise
                tries += 1
                if getattr(self.backend, "threaded", False):
                    # threads free slots on their own; NEVER drain (a
                    # full-idle barrier under sustained traffic, and it
                    # would steal the owner's undrained buffer)
                    time.sleep(self.admission_wait_s)
                elif pump is not None:
                    pump(force=True)       # we ARE the sync harness's pump
                else:
                    time.sleep(self.admission_wait_s)
                    if tries % 16 == 0:    # no progress: caller-driven,
                        drained = self.backend.drain()  # no pump surface
                        with self._lock:
                            self.stray_responses.extend(drained)
                continue
            with self._lock:
                self.stats["submitted"] += 1
            return fut

    def search(self, request, k: Optional[int] = None, *,
               top_n: Optional[int] = None,
               deadline_s: Optional[float] = None,
               tag: Any = None,
               timeout: Optional[float] = None) -> SearchResponse:
        return self.submit(request, k, top_n=top_n, deadline_s=deadline_s,
                           tag=tag).result(timeout=timeout)

    def search_many(self, requests: Iterable, *,
                    timeout: Optional[float] = None) -> List[SearchResponse]:
        """Submit everything (blocking through admission), resolve in
        submission order."""
        futs = [self.submit(r) for r in requests]
        return [f.result(timeout=timeout) for f in futs]


# ---------------------------------------------------------------------------
# Asyncio front door
# ---------------------------------------------------------------------------

class AsyncANNSClient:
    """One event loop over any :class:`Backend` — the deployment front
    door over the router.

    * **bridge** — each backend :class:`QueryFuture` is mirrored into an
      ``asyncio.Future`` via ``add_done_callback`` +
      ``loop.call_soon_threadsafe``: the replica pump thread that resolves
      the query wakes the loop, no thread parks per request.  A backend
      running the caller-driven sync harness (no pump thread) is detected
      and driven from the loop's default thread pool, serialized so the
      single-driver assumption of that harness holds.
    * **admission** — ``max_inflight`` is a client-side
      ``asyncio.Semaphore``; past it, callers AWAIT a slot.  A backend
      :class:`BackpressureError` is absorbed the same way: the coroutine
      sleeps ``admission_poll_s`` and retries until admitted.  ``search``
      never raises ``BackpressureError``.
    * **deadlines** — ``request.deadline_s`` rides to the backend (which
      expires the re-rank) AND bounds the await via ``asyncio.wait_for``;
      an asyncio timeout cancels the backend future and surfaces
      :class:`DeadlineExceeded`, so both expiry paths look identical to
      the caller.
    * **streaming** — ``search_many()`` yields responses in COMPLETION
      order (``asyncio.as_completed``), so a slow re-rank never
      head-of-line-blocks finished neighbours.
    """

    def __init__(self, backend: Backend, *, max_inflight: int = 256,
                 admission_poll_s: float = 1e-3,
                 coalescer: Optional[RequestCoalescer] = None):
        self.backend = backend
        self.max_inflight = max_inflight
        self.admission_poll_s = admission_poll_s
        # optional in-flight dedup of identical requests (DESIGN.md §8):
        # followers attach to the leader's backend future instead of
        # consuming a backend queue slot
        self.coalescer = coalescer
        self._sem = asyncio.Semaphore(max_inflight)
        self._inflight: set = set()        # bridged asyncio futures
        # serializes sync-harness drives; ranked "client" because driving
        # qfut.result() pumps the service (and its ticket/future locks)
        # underneath — client must sit above service in the hierarchy
        self._drive_lock = make_lock("client")
        self.stats: Dict[str, int] = {
            "submitted": 0, "completed": 0, "admission_waits": 0,
            "deadline_timeouts": 0, "coalesced": 0}
        self._closed = False

    # ------------------------------------------------------------- plumbing
    def _settle(self, qfut: QueryFuture) -> None:
        """Thread-pool driver for sync-harness backends: resolve ``qfut``
        by driving its producer.  Exceptions land on the future (the
        bridge callback reads them); serialization keeps the caller-driven
        harness single-driver."""
        with self._drive_lock:
            try:
                qfut.result()
            except BaseException:          # noqa: BLE001 — stays on qfut
                pass

    def _bridge(self, qfut: QueryFuture,
                loop: asyncio.AbstractEventLoop) -> asyncio.Future:
        """Mirror a backend future into the loop.  Resolution (any thread)
        schedules the hand-off; a bridged future the loop already
        cancelled (deadline timeout) is left alone."""
        afut = loop.create_future()

        def _publish(res, exc):
            if afut.done():                # cancelled by wait_for
                return
            if exc is not None:
                afut.set_exception(exc)
            else:
                afut.set_result(res)

        def _on_done(f: QueryFuture):
            try:
                res, exc = f.result(), None
            except BaseException as e:     # noqa: BLE001 — incl. Cancelled
                res, exc = None, e
            loop.call_soon_threadsafe(_publish, res, exc)

        qfut.add_done_callback(_on_done)
        if not qfut.done() and getattr(qfut, "_driver", None) is not None:
            # caller-driven harness: nobody else will resolve this future;
            # drive it off-loop (bounded by the default executor pool)
            loop.run_in_executor(None, self._settle, qfut)
        return afut

    async def _admit(self, req: SearchRequest) -> QueryFuture:
        """Submit, AWAITING admission on backpressure instead of raising
        (the redesign's contract: admission latency, not exceptions)."""
        while True:
            try:
                fut = self.backend.submit(req)
            except BackpressureError:
                self.stats["admission_waits"] += 1
                await asyncio.sleep(self.admission_poll_s)
                continue
            self.stats["submitted"] += 1
            return fut

    async def _submit_or_attach(self, req: SearchRequest) -> QueryFuture:
        """The coalescing hook: a request identical to one already in
        flight (same :func:`coalesce_key`) attaches to the leader's
        backend future instead of submitting — ONE backend submit serves
        the whole duplicate burst.  Cancelling an attached future (the
        deadline/teardown paths above) never cancels the shared one."""
        if self.coalescer is None:
            return await self._admit(req)
        leader, handle = self.coalescer.claim(req)
        if not leader:
            self.stats["coalesced"] += 1
            return handle
        try:
            qfut = await self._admit(req)
        except BaseException as exc:       # noqa: BLE001 — incl. Cancelled
            self.coalescer.abandon(handle, exc)
            raise
        self.coalescer.publish(handle, qfut)
        return qfut

    # ---------------------------------------------------------------- public
    async def search(self, request, k: Optional[int] = None, *,
                     top_n: Optional[int] = None,
                     deadline_s: Optional[float] = None,
                     tag: Any = None) -> SearchResponse:
        """Serve one request end to end: await an inflight slot, await
        admission, await the response.  ``deadline_s`` bounds ALL of it —
        the semaphore wait and the admission retries count against the
        same budget as the scan, so a deadlined request can never wait
        past its deadline just to get admitted.  Expiry — loop-side or
        backend-side — raises :class:`DeadlineExceeded`."""
        if self._closed:
            raise RuntimeError("AsyncANNSClient is closed")
        req = as_request(request, k, top_n=top_n, deadline_s=deadline_s,
                         tag=tag)
        if req.deadline_s is None:
            return await self._search_inner(req, None)
        holder: Dict[str, QueryFuture] = {}
        try:
            return await asyncio.wait_for(self._search_inner(req, holder),
                                          req.deadline_s)
        except asyncio.TimeoutError:
            self.stats["deadline_timeouts"] += 1
            qfut = holder.get("qfut")
            if qfut is not None:           # admitted: skip its re-rank
                qfut.cancel()
            raise DeadlineExceeded(
                f"asyncio deadline of {req.deadline_s}s passed awaiting "
                f"request tag={req.tag!r}") from None

    async def _search_inner(self, req: SearchRequest,
                            holder: Optional[Dict[str, QueryFuture]]
                            ) -> SearchResponse:
        loop = asyncio.get_running_loop()
        async with self._sem:
            qfut = await self._submit_or_attach(req)
            if holder is not None:
                holder["qfut"] = qfut
            afut = self._bridge(qfut, loop)
            self._inflight.add(afut)
            try:
                resp = await afut
                self.stats["completed"] += 1
                return resp
            except asyncio.CancelledError:
                # the caller's task was cancelled (deadline timeout above,
                # a consumer bailing out of search_many, gather teardown):
                # the request is already admitted, so cancel the backend
                # future too — its re-rank is skipped and no backend
                # future outlives its awaiter
                qfut.cancel()
                raise
            finally:
                self._inflight.discard(afut)

    async def search_many(self, requests: Sequence, *,
                          return_exceptions: bool = False
                          ) -> AsyncIterator[SearchResponse]:
        """Submit a whole workload and yield responses AS THEY COMPLETE —
        each one carries its request's ``tag`` for correlation.  With
        ``return_exceptions=True`` failed requests yield their exception
        object instead of aborting the stream."""
        tasks = [asyncio.ensure_future(self.search(r)) for r in requests]
        try:
            for nxt in asyncio.as_completed(tasks):
                try:
                    yield await nxt
                except Exception as exc:   # noqa: BLE001 — per-request
                    if not return_exceptions:
                        raise
                    yield exc
        finally:
            for t in tasks:                # a consumer bailing mid-stream
                if not t.done():           # must not leak pending tasks
                    t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

    async def drain(self) -> None:
        """Await every in-flight request (exceptions stay with their
        awaiters)."""
        while self._inflight:
            await asyncio.gather(*list(self._inflight),
                                 return_exceptions=True)

    async def aclose(self) -> None:
        """Refuse new requests, then settle all in-flight ones.  Zero
        backend futures stay pending past this call (closing BEFORE the
        drain, so no concurrent ``search()`` slips in behind it); the
        backend itself (threads, replicas) is NOT stopped — the client
        does not own it."""
        self._closed = True
        await self.drain()

    async def __aenter__(self) -> "AsyncANNSClient":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.aclose()
