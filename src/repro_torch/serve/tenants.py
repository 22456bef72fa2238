"""Per-tenant namespaces over any Backend (DESIGN.md §11; the port's
counterpart of ``repro.serve.tenants``).

One index, many tenants: a recsys workload and a RAG workload share the
same sealed/delta segments, but each tenant must only ever see its own
rows, pay for its own traffic, and show up in its own books.  This module
is that boundary, layered as a :class:`~repro_torch.serve.client.Backend`
wrapper so it composes with every front door (the sync/async clients, the
HTTP edge) and every backend (executor, batching service, replica
router):

* **namespace isolation** — each :class:`TenantConfig` carries a *base
  predicate* (``filter=``, e.g. ``Eq("tenant", 7)``); ``submit()``
  conjoins it UNDER the request's own filter via
  :func:`~repro_torch.core.filters.combine`, so a request can narrow its
  tenant's view but never widen it.  Predicates fail closed (UNSET rows
  never match — ``core/filters.py``), which makes the base predicate an
  isolation boundary rather than a convention: a row without the tenant
  column is invisible to every tenant.
* **admission quotas** — a per-tenant :class:`TokenBucket` (the edge
  re-exports it) gates ``submit`` BEFORE the
  backend sees the request.  A drained bucket raises
  :class:`QuotaExceeded` — deliberately NOT a
  :class:`~repro_torch.core.futures.BackpressureError`, so the async client's
  admission retry loop never spins on a quota the caller has to back off
  from (the edge maps it to HTTP 429 + Retry-After).
* **per-tenant books** — submitted/ok/error counters, a bounded latency
  window with percentiles, and summed ``QueryStats`` per tenant, rolled
  up via :meth:`TenantManager.tenant_rollup` and folded into the Backend
  ``stats_rollup()``.

Locking: one ``tenant``-ranked lock guards buckets + books.  It is never
held across a backend call, and it ranks BELOW ``service`` because the
accounting runs in future done-callbacks, which the batching service
fires while holding its own lock.

Requests with ``tenant=None`` pass through untouched (no quota, no base
predicate, no books) — the open-edge/direct-caller path.  A request
naming an UNKNOWN tenant is refused (``ValueError``): fail closed, never
serve a namespace that was not provisioned.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict, Optional, Sequence

import numpy as np

from repro_torch.analysis.concurrency.witness import make_lock
from repro_torch.core.executor import QUERY_STATS_FIELDS
from repro_torch.core.filters import Predicate, combine
from repro_torch.core.futures import QueryFuture
from repro_torch.serve.client import SearchRequest

__all__ = ["TenantConfig", "TokenBucket", "QuotaExceeded", "TenantManager"]


@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """One API tenant: the key that authenticates it, its rate limit
    (``rate_qps <= 0`` = unlimited; ``burst`` caps how far an idle tenant
    can pre-accumulate), and the base predicate that defines its
    namespace (``None`` = the whole index)."""

    name: str
    api_key: str
    rate_qps: float = 0.0
    burst: int = 8
    filter: Optional[Predicate] = None


class TokenBucket:
    """Classic token bucket with an injectable clock (tests tick it
    deterministically).  ``try_acquire`` never blocks; ``retry_after``
    says how long until one token exists.  Not thread-safe on its own —
    :class:`TenantManager` serializes access under its lock."""

    def __init__(self, rate: float, burst: int = 8,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = max(int(burst), 1)
        self.clock = clock
        self._tokens = float(self.burst)
        self._t = clock()

    def _refill(self) -> None:
        now = self.clock()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._t) * self.rate)
        self._t = now

    def try_acquire(self) -> bool:
        if self.rate <= 0:
            return True
        self._refill()
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False

    def refund(self) -> None:
        """Return one token (an admitted request the backend then refused
        with backpressure did not actually run)."""
        if self.rate > 0:
            self._tokens = min(float(self.burst), self._tokens + 1.0)

    def retry_after(self) -> float:
        if self.rate <= 0:
            return 0.0
        self._refill()
        missing = max(1.0 - self._tokens, 0.0)
        return missing / self.rate


class QuotaExceeded(RuntimeError):
    """A tenant is over its admission quota.  Plain ``RuntimeError`` on
    purpose: the async client's admission loop retries
    ``BackpressureError`` (a transient backend condition), but a quota is
    a caller-side contract — it must surface, not spin."""

    def __init__(self, tenant: str, retry_after: float):
        super().__init__(f"tenant {tenant!r} over quota; "
                         f"retry after {retry_after:.3f}s")
        self.tenant = tenant
        self.retry_after = float(retry_after)


def _fresh_book() -> Dict[str, int]:
    return {"submitted": 0, "ok": 0, "errors": 0, "quota_rejected": 0}


class TenantManager:
    """Backend wrapper enforcing tenant namespaces, quotas, and books.

    Implements the full Backend protocol; everything it does not override
    (``insert``/``delete``/``compact``, ``fused``/``lut_int8``/
    ``threaded``, ``scaling_signals`` …) proxies to the wrapped backend,
    so the manager is a drop-in layer anywhere a backend goes."""

    def __init__(self, backend, tenants: Sequence[TenantConfig] = (), *,
                 clock: Callable[[], float] = time.monotonic):
        self.backend = backend
        self._specs: Dict[str, TenantConfig] = {t.name: t for t in tenants}
        # guards buckets + books; NEVER held across a backend call (see
        # module docstring for why it ranks below "service")
        self._lock = make_lock("tenant")
        self._buckets: Dict[str, TokenBucket] = {       # guarded-by: _lock
            t.name: TokenBucket(t.rate_qps, t.burst, clock)
            for t in tenants}
        self._books: Dict[str, Dict[str, int]] = {      # guarded-by: _lock
            t.name: _fresh_book() for t in tenants}
        self._latencies: Dict[str, Deque[float]] = {    # guarded-by: _lock
            t.name: deque(maxlen=2048) for t in tenants}
        self._totals: Dict[str, Dict[str, int]] = {     # guarded-by: _lock
            t.name: dict.fromkeys(QUERY_STATS_FIELDS, 0) for t in tenants}

    # ---------------------------------------------------------------- submit
    def submit(self, request: SearchRequest) -> QueryFuture:
        """Quota-gate, stamp the tenant's base predicate UNDER the
        request's filter, forward, and hook per-tenant accounting onto the
        backend future.  ``tenant=None`` passes through untouched; an
        unknown tenant is refused (fail closed)."""
        name = request.tenant
        if name is None:
            return self.backend.submit(request)
        spec = self._specs.get(name)
        if spec is None:
            raise ValueError(f"unknown tenant {name!r}; provisioned: "
                             f"{sorted(self._specs)}")
        with self._lock:
            bucket = self._buckets[name]
            if not bucket.try_acquire():
                self._books[name]["quota_rejected"] += 1
                wait = bucket.retry_after()
            else:
                wait = None
        if wait is not None:
            raise QuotaExceeded(name, wait)
        eff = combine(spec.filter, request.filter)
        if eff is not request.filter:
            request = dataclasses.replace(request, filter=eff)
        try:
            fut = self.backend.submit(request)
        except BaseException:
            with self._lock:                # backpressure/refusal: the
                self._buckets[name].refund()  # token was never spent on work
            raise
        with self._lock:
            self._books[name]["submitted"] += 1
        fut.add_done_callback(lambda f: self._account(name, f))
        return fut

    def _account(self, name: str, fut: QueryFuture) -> None:
        # runs in whatever thread resolved the future — possibly while the
        # batching service holds its "service" lock, which is why _lock
        # ranks below it
        try:
            resp = fut.result()
        except BaseException:               # noqa: BLE001 — incl. Cancelled
            with self._lock:
                self._books[name]["errors"] += 1
            return
        latency = float(resp.latency_s)    # materialise OUTSIDE the lock
        counts = [int(getattr(resp.stats, f)) for f in QUERY_STATS_FIELDS]
        with self._lock:
            self._books[name]["ok"] += 1
            self._latencies[name].append(latency)
            totals = self._totals[name]
            for field, c in zip(QUERY_STATS_FIELDS, counts):
                totals[field] += c

    # ----------------------------------------------------------- observation
    def tenant_names(self) -> list:
        return sorted(self._specs)

    def base_filter(self, name: str) -> Optional[Predicate]:
        return self._specs[name].filter

    def tenant_percentiles(self, name: str) -> Dict[str, float]:
        with self._lock:
            snap = list(self._latencies[name])
        lat = np.asarray(snap)       # materialise OUTSIDE the lock (PU01)
        if not len(lat):
            return {"p50": 0.0, "p99": 0.0, "n": 0}
        return {"p50": float(np.percentile(lat, 50)),
                "p99": float(np.percentile(lat, 99)), "n": len(lat)}

    def tenant_rollup(self) -> Dict[str, Dict[str, object]]:
        """Per-tenant books: counters + latency percentiles + summed
        ``QueryStats`` — the isolation witness (two tenants' rollups never
        mix)."""
        with self._lock:
            snap = {name: (dict(self._books[name]),
                           dict(self._totals[name]))
                    for name in self._specs}
        out: Dict[str, Dict[str, object]] = {}
        for name, (book, totals) in snap.items():
            out[name] = {**book, "latency": self.tenant_percentiles(name),
                         "query_stats": totals}
        return out

    # ------------------------------------------------------ Backend protocol
    def drain(self):
        return self.backend.drain()

    def stop(self):
        return self.backend.stop()

    def live_load(self) -> int:
        return self.backend.live_load()

    def latency_percentiles(self) -> Dict[str, float]:
        return self.backend.latency_percentiles()

    def stats_rollup(self) -> Dict[str, object]:
        roll = dict(self.backend.stats_rollup())
        roll["tenants"] = self.tenant_rollup()
        return roll

    @property
    def epoch(self) -> int:
        return self.backend.epoch

    def __getattr__(self, name: str):
        # everything else (insert/delete/compact, fused/lut_int8/threaded,
        # scaling_signals, pump, …) is the wrapped backend's business
        if name == "backend":              # copy/pickle re-entry guard
            raise AttributeError(name)
        return getattr(self.backend, name)
