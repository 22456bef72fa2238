"""Multi-replica routing (the port's counterpart of
``repro.serve.router``, without its mesh half).

The threaded :class:`~repro_torch.serve.anns_service.BatchingANNSService`
is the per-replica building block: one pump thread + one ticker per
replica keeps the device busy.  Serving heavy traffic from one box is
then a ROUTING problem — many concurrent query streams over one index.
:class:`ReplicaRouter` fronts N such replicas:

* **no mesh** — every replica owns its executor (its own dispatch lock)
  over the index on the index's device, and the router is a pure
  concurrency layer.  Carving a mesh into per-replica device groups
  waits for the multi-GPU scan: ``mesh=`` anything but ``None`` raises.
* **ELASTIC replica set** — ``add_replica()`` / ``remove_replica()`` grow
  and shrink the set at runtime (the autoscaler's actuators,
  serve/autoscaler.py).  Removal drains: the victim is
  popped from the routing set first, then its pump serves every queued
  request, so zero futures leak.  Each replica ever created owns a stable
  SLOT id; ``stats["routed"]`` is indexed by slot and only grows, so the
  accounting invariant ``submitted == sum(routed) + rejected`` survives
  any scaling history.
* **same futures-first surface** — ``submit() -> QueryFuture`` with
  ``k``/``top_n``/``deadline_s``, backpressure (a submission rejected by
  every replica raises :class:`BackpressureError`), graceful fan-out
  ``stop()`` drain, aggregated ``latency_percentiles()`` and a
  ``QueryStats`` rollup (both include retired replicas' history).
* **pluggable policies** —

  ============= =========================================================
  policy        choice per request
  ============= =========================================================
  round_robin   cycle through replicas (stateless, cache-friendly)
  jsq           join-shortest-queue: each replica's LIVE request count
                (``BatchingANNSService.live_load()`` — uncancelled queued
                + in-flight) picks the least-loaded replica
  deadline      round-robin baseline, but a request carrying a deadline
                spills to the least-loaded replica when that is strictly
                less loaded than the round-robin pick
  ============= =========================================================

  Every policy also SPILLS on backpressure: when the chosen replica's
  queue is full the router tries the remaining replicas (least-loaded
  first) before rejecting.  A spill chain that exhausts EVERY replica
  counts as ``spill_exhausted`` and rejects.
* **update propagation** — founding replicas share ONE segmented index
  object, so ``router.insert()/delete()/compact()`` publish a new
  epoch-stamped :class:`~repro_torch.core.segments.IndexView` that every
  replica's executor pins at its next dispatch.  With ``snapshot_dir=``
  set, ``add_replica()`` HYDRATES the newcomer from a fresh
  ``save_snapshot()`` of the live index, loaded onto the live index's
  device, instead of sharing it; the
  router then fans every mutation out to each distinct index in the
  same order, and because delta append / tombstone / compaction are
  deterministic, hydrated replicas stay in id-for-id lockstep with the
  donor (mutate through the ROUTER, not a bare index, once a hydrated
  replica exists).

Routing never changes results: each replica runs the same unified
executor pipeline over the same index, so ids are bit-identical to a
single-replica ``run()`` under every policy (tests/test_torch_router.py).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.analysis.concurrency.witness import make_lock
from repro_torch.core.engine import FusionANNSIndex
from repro_torch.core.executor import MESH_NOT_PORTED, QUERY_STATS_FIELDS
from repro_torch.core.futures import BackpressureError, QueryFuture
from repro_torch.serve.anns_service import BatchingANNSService
from repro_torch.serve.client import SearchRequest, SearchResponse

__all__ = ["ReplicaRouter", "POLICIES"]

POLICIES = ("round_robin", "jsq", "deadline")

# retired-replica latency history kept for percentile aggregation (bounded:
# removal must not leak memory over a long autoscaling life)
_RETIRED_LATENCIES_MAX = 4096


class ReplicaRouter:
    """Fronts an elastic set of serving replicas with one futures-first
    ``submit()``."""

    def __init__(self, index: FusionANNSIndex, *, n_replicas: int = 2,
                 policy: str = "jsq", mesh=None, threaded: bool = True,
                 snapshot_dir: Optional[str] = None, **svc_kw):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; one of {POLICIES}")
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if mesh is not None:
            raise NotImplementedError(MESH_NOT_PORTED)
        self.index = index
        # with a snapshot dir, scale-ups hydrate a PRIVATE index from disk
        # (save_snapshot -> load_snapshot) instead of sharing ``index``
        self.snapshot_dir = snapshot_dir
        self.policy = policy
        self._lock = make_lock("router")
        # per-replica service knobs, kept so elastically added replicas are
        # configured identically to the founding set
        self._svc_kw = dict(svc_kw)
        # surfaced for coalescing keys (serve/edge.py): these two plan knobs
        # change result ids, so the edge must fold them into the dedup key
        self.fused = bool(svc_kw.get("fused", False))
        self.lut_int8 = bool(svc_kw.get("lut_int8", False))
        # each replica: own executor (own dispatch lock) wrapped by its own
        # pump/ticker service, all launching on the index's device
        self.replicas: List[BatchingANNSService] = [
            BatchingANNSService(index, executor=index.make_executor(),
                                threaded=threaded, **svc_kw)
            for _ in range(n_replicas)]        # guarded-by: _lock
        # per-replica index binding, parallel to ``replicas`` (founding
        # replicas share ``index``; snapshot-hydrated ones own a private
        # copy that mutations fan out to)
        self.indexes: List[FusionANNSIndex] = [
            index] * n_replicas                # guarded-by: _lock
        # stable slot ids, parallel to ``replicas``; slots are never reused
        self.replica_ids: List[int] = list(range(n_replicas))  # guarded-by: _lock
        self._next_slot = n_replicas           # guarded-by: _lock
        # mirrors the replicas' harness (clients read this to pick their
        # backpressure strategy: sleep-retry vs pump-on-behalf)
        self.threaded = threaded
        self._rr = 0       # round-robin cursor; guarded-by: _lock
        self.stats: Dict[str, object] = {
            "submitted": 0, "rejected": 0, "spills": 0,
            "deadline_spills": 0, "spill_exhausted": 0,
            "scale_ups": 0, "scale_downs": 0,
            "routed": [0] * n_replicas}        # guarded-by: _lock
        # removed replicas' history — percentiles and the QueryStats rollup
        # must describe the whole traffic stream, not just survivors
        self._retired_latencies: deque = deque(
            maxlen=_RETIRED_LATENCIES_MAX)     # guarded-by: _lock
        self._retired_query_stats = dict.fromkeys(
            QUERY_STATS_FIELDS, 0)             # guarded-by: _lock
        self._retired = {"requests": 0, "batches": 0, "served": 0,
                         "replicas": []}       # guarded-by: _lock

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ReplicaRouter":
        # snapshot: a concurrent add/remove must not mutate mid-iteration
        with self._lock:
            reps = list(self.replicas)
        for r in reps:
            r.start()
        self.threaded = True
        return self

    def stop(self) -> "ReplicaRouter":
        """Graceful fan-out drain: every replica's pump thread serves its
        remaining queue (zero pending futures survive), in parallel."""
        with self._lock:
            reps = list(self.replicas)
        ts = [threading.Thread(target=r.stop) for r in reps]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        self.threaded = False
        return self

    def __enter__(self) -> "ReplicaRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -------------------------------------------------------------- scaling
    @property
    def n_replicas(self) -> int:
        with self._lock:
            return len(self.replicas)

    def add_replica(self) -> int:
        """Grow the replica set by one: start a fresh replica (same
        service knobs as the founding set, its own executor).  Returns the
        new replica's stable slot id.

        With ``snapshot_dir`` set the newcomer HYDRATES from disk
        (DESIGN.md §10): the live index is checkpointed via
        ``save_snapshot`` and the replica serves a ``load_snapshot`` copy
        on the donor index's device — bit-identical ids at the captured
        epoch, no re-cluster / re-encode, and no shared mutable state with
        the donor; subsequent
        ``router.insert()/delete()/compact()`` fan out to keep it in
        lockstep."""
        with self._lock:
            # hydration happens INSIDE the router lock on purpose: the
            # mutation fan-out also runs under it, so no insert/delete can
            # land between the checkpoint and the newcomer joining
            # ``self.indexes`` (which would be silently missing from the
            # hydrated copy forever).  router > compaction in the lock
            # hierarchy, so save_snapshot's pin underneath is legal.
            if self.snapshot_dir is not None:
                self.index.save_snapshot(self.snapshot_dir)
                new_index = FusionANNSIndex.load_snapshot(
                    self.snapshot_dir, device=self.index.device)
            else:
                new_index = self.index
            new = BatchingANNSService(
                new_index, executor=new_index.make_executor(),
                threaded=False, **self._svc_kw)
            slot = self._next_slot
            self._next_slot += 1
            self.replicas.append(new)
            self.indexes.append(new_index)
            self.replica_ids.append(slot)
            self.stats["routed"].append(0)
            self.stats["scale_ups"] += 1
        if self.threaded:
            new.start()
        return slot

    def remove_replica(self, slot: Optional[int] = None, *,
                       drain: bool = True) -> int:
        """Shrink by one: pop the victim from the routing set (new traffic
        stops landing on it immediately), then stop the victim — its pump
        drains every queued request before exiting, so zero futures leak.
        ``slot`` picks the victim (default: the least-loaded replica).
        Returns the removed slot id.  ``drain=False`` skips the stop (the
        caller owns it)."""
        with self._lock:
            if len(self.replicas) <= 1:
                raise ValueError("cannot remove the last replica")
            if slot is None:
                loads = [r.live_load()            # acquires: service
                         for r in self.replicas]
                i = min(range(len(loads)), key=lambda j: (loads[j], j))
            else:
                try:
                    i = self.replica_ids.index(slot)
                except ValueError:
                    raise ValueError(f"no replica with slot id {slot}") \
                        from None
            victim = self.replicas.pop(i)
            self.indexes.pop(i)
            slot = self.replica_ids.pop(i)
            self.stats["scale_downs"] += 1
            # keep the round-robin cursor in range after the shrink
            self._rr %= len(self.replicas)
        if drain:
            victim.stop()        # pump serves its remaining queue
        # fold the victim's history into the retired accumulators so
        # percentiles/rollups keep describing the full traffic stream
        with victim._lock:                        # acquires: service
            lats = list(victim.latencies_s)
            vstats = dict(victim.stats)
            vqs = dict(victim.query_stats)
        with self._lock:
            self._retired_latencies.extend(lats)
            self._retired["requests"] += int(vstats["requests"])
            self._retired["batches"] += int(vstats["batches"])
            self._retired["served"] += int(vqs["served"])
            self._retired["replicas"].append({"slot": slot, **vstats})
            for f in QUERY_STATS_FIELDS:
                self._retired_query_stats[f] += vqs[f]
        return slot

    def scaling_signals(self) -> Dict[str, object]:
        """One coherent sample of everything the autoscaler keys on:
        aggregate + per-replica live load, the spill/reject counters
        (demand the current set could not place), and queue-latency
        percentiles over the whole stream."""
        with self._lock:
            reps = list(self.replicas)
            spills = int(self.stats["spills"])
            exhausted = int(self.stats["spill_exhausted"])
            rejected = int(self.stats["rejected"])
            submitted = int(self.stats["submitted"])
        loads = [r.live_load() for r in reps]
        pct = self.latency_percentiles()
        return {"n_replicas": len(reps), "live_load": sum(loads),
                "per_replica_load": loads, "submitted": submitted,
                "spills": spills, "spill_exhausted": exhausted,
                "rejected": rejected, "p50": pct["p50"], "p99": pct["p99"],
                "latency_n": pct["n"]}

    # --------------------------------------------------------------- routing
    def _route_order(self, replicas: Sequence[BatchingANNSService],
                     deadline_s: Optional[float]
                     ) -> tuple[Sequence[int], Optional[int]]:
        """Replica indices to try (primary choice first) plus the
        deadline-spill target, if this request jumped the round-robin
        line.  Fallbacks (the backpressure spill path) go least-loaded
        first."""
        n = len(replicas)
        if n == 1:
            return (0,), None
        loads = [r.live_load() for r in replicas]
        by_load = sorted(range(n), key=lambda i: (loads[i], i))
        if self.policy == "jsq":
            return by_load, None
        with self._lock:
            start = self._rr % n
            self._rr = (start + 1) % n
        if self.policy == "deadline" and deadline_s is not None:
            least = by_load[0]
            if loads[least] < loads[start]:
                # deadline-aware spill: tight-deadline traffic jumps to
                # the least-loaded replica instead of waiting in line
                return ([least] + [i for i in by_load if i != least],
                        least)
        # primary = the round-robin pick; backpressure fallbacks go
        # least-loaded first (the documented spill order)
        return [start] + [i for i in by_load if i != start], None

    def submit(self, request: SearchRequest) -> QueryFuture:
        """Route one request; returns the serving replica's future (same
        surface as ``BatchingANNSService.submit`` — a typed
        :class:`~repro_torch.serve.client.SearchRequest` in, a future resolving
        to a :class:`~repro_torch.serve.client.SearchResponse` out).  Tries
        the policy's choice first, spills across the remaining replicas on
        backpressure, and raises :class:`BackpressureError` only when
        EVERY replica's queue is full.  Every call is counted:
        ``submitted == sum(routed) + rejected`` always holds."""
        if not isinstance(request, SearchRequest):
            raise TypeError(
                "submit() takes a SearchRequest; wrap raw query vectors "
                "with as_request(...) or use ANNSClient "
                f"(got {type(request).__name__})")
        req = request
        # snapshot the replica set: a concurrent remove_replica() must not
        # shift indices under the routing loop (the victim still drains any
        # request that raced onto it, so nothing leaks either way)
        with self._lock:
            replicas = list(self.replicas)
            slots = list(self.replica_ids)
            self.stats["submitted"] += 1
        order, dl_target = self._route_order(replicas, req.deadline_s)
        last: Optional[BackpressureError] = None
        for pos, i in enumerate(order):
            try:
                fut = replicas[i].submit(req)
            except BackpressureError as exc:
                last = exc
                continue
            with self._lock:
                self.stats["routed"][slots[i]] += 1
                if pos:
                    self.stats["spills"] += 1
                # counted only when the request actually LANDED on the
                # spill target (not when the spill was merely chosen)
                if dl_target is not None and i == dl_target:
                    self.stats["deadline_spills"] += 1
            return fut
        with self._lock:
            self.stats["rejected"] += 1
            if len(order) > 1:
                # the spill chain visited every replica and none had room
                self.stats["spill_exhausted"] += 1
        raise BackpressureError(
            f"all {len(replicas)} replicas backpressured") from last

    def drain(self) -> List["SearchResponse"]:
        """Serve everything currently queued on every replica; returns the
        responses served since the last drain, across ALL replicas (the
        unified Backend drain contract)."""
        out: List[SearchResponse] = []
        with self._lock:
            reps = list(self.replicas)
        for r in reps:
            out.extend(r.drain())
        return out

    # ----------------------------------------------------------- aggregates
    def live_load(self) -> int:
        with self._lock:
            reps = list(self.replicas)
        return sum(r.live_load() for r in reps)

    def latency_percentiles(self) -> Dict[str, float]:
        """p50/p99 over ALL replicas' per-request enqueue->resolve
        latencies (one traffic stream, N servers — retired replicas'
        recent history included)."""
        with self._lock:
            reps = list(self.replicas)
            lats = list(self._retired_latencies)
        for r in reps:
            with r._lock:                         # acquires: service
                lats.extend(r.latencies_s)
        if not lats:
            return {"p50": 0.0, "p99": 0.0, "n": 0}
        arr = np.asarray(lats)
        return {"p50": float(np.percentile(arr, 50)),
                "p99": float(np.percentile(arr, 99)), "n": len(arr)}

    def stats_rollup(self) -> Dict[str, object]:
        """Router counters + per-replica service stats + the summed
        ``QueryStats`` counters of every response served anywhere —
        including on replicas that have since been removed."""
        with self._lock:
            reps = list(self.replicas)
            totals = dict(self._retired_query_stats)
            requests = self._retired["requests"]
            batches = self._retired["batches"]
            served = self._retired["served"]
            per_replica = [dict(d) for d in self._retired["replicas"]]
        for r in reps:
            with r._lock:                         # acquires: service
                per_replica.append(dict(r.stats))
                requests += int(r.stats["requests"])
                batches += int(r.stats["batches"])
                served += r.query_stats["served"]
                for f in QUERY_STATS_FIELDS:
                    totals[f] += r.query_stats[f]
        with self._lock:
            out = {k: (list(v) if isinstance(v, list) else v)
                   for k, v in self.stats.items()}
        out["requests"] = requests
        out["batches"] = batches
        out["served"] = served
        out["query_stats"] = totals
        out["per_replica"] = per_replica
        return out

    def measured_demand(self):
        """Mean per-query :class:`~repro_torch.core.perf_model.QueryDemand` over
        everything SERVED anywhere (cancelled/expired requests contributed
        no stats, so they don't dilute the mean) — the analytic device
        model's input for the replica-scaling sweep
        (``perf_model.qps_at_replicas``)."""
        from repro_torch.core.perf_model import demand_from_stats
        roll = self.stats_rollup()
        return demand_from_stats(
            roll["query_stats"], roll["served"],
            pq_m=self.index.cfg.pq_m,
            dim=self.index.ssd.vectors.shape[1],
            top_m=self.index.cfg.top_m)

    # -------------------------------------------------------------- updates
    @property
    def epoch(self) -> int:
        """The primary index's segment-list epoch (coalescing keys)."""
        return self.index.epoch

    def _distinct_indexes_locked(self) -> List[FusionANNSIndex]:  # holds: _lock
        seen: set = set()
        out: List[FusionANNSIndex] = []
        for ix in [self.index] + list(self.indexes):
            if id(ix) not in seen:
                seen.add(id(ix))
                out.append(ix)
        return out

    def insert(self, vectors: np.ndarray,
               attributes=None) -> np.ndarray:
        """Append to every distinct index's delta segment (founding
        replicas share one; snapshot-hydrated replicas own copies kept in
        lockstep by this fan-out).  Each replica's executor pins the new
        epoch's view at its next dispatch.  ``attributes`` maps column
        name -> per-row metadata ints (DESIGN.md §11), carried to every
        index identically.  Returns the new global ids (identical on
        every index by determinism)."""
        vecs = np.atleast_2d(np.asarray(vectors, np.float32))
        with self._lock:
            ids = None
            for ix in self._distinct_indexes_locked():
                out = ix.insert(vecs, attributes=attributes)
                ids = out if ids is None else ids
        return ids

    def delete(self, ids: np.ndarray) -> None:
        """Tombstone ids in the owning segment of every distinct index —
        filtered at candidate collection by every replica from its next
        pinned view."""
        with self._lock:
            for ix in self._distinct_indexes_locked():
                ix.delete(ids)

    def compact(self, *, wait: bool = True) -> int:
        """Seal every distinct index's delta into its immutable tiers
        (same deterministic op on each, so hydrated replicas stay
        bit-identical).  Returns rows sealed on the primary index."""
        with self._lock:
            sealed = 0
            for ix in self._distinct_indexes_locked():
                n = ix.compact(wait=wait)
                if ix is self.index:
                    sealed = n
        return sealed
