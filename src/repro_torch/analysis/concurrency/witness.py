"""Lock hierarchy + runtime lock-order witness (the port's own copy of
``repro.analysis.concurrency.witness``: the port imports nothing of the
JAX package, and the repo's concurrency lint exempts any module whose
path ends in ``analysis/concurrency/witness.py``).

This module is deliberately import-light (stdlib only, no torch/numpy): it
is imported by ``core/futures.py`` and every serving module at startup.

Declared hierarchy (DESIGN.md §9)
---------------------------------
Outer locks rank HIGHER; a thread may acquire a lock only while every
lock it already holds ranks strictly above it.  Acquisition therefore
always descends::

    autoscaler > client > router > service > tenant > compaction
               > coalescer > executor > inflight > ticket > future

``compaction`` guards index mutation (the segmented index's delta append
/ tombstone / seal-publish critical sections, ``core/segments.py``); it
sits below ``service``/``router`` so a serving layer may mutate its index
while holding its own lock, and above ``coalescer``/``executor`` so the
mutation path can never invert against a dispatch.  ``tenant`` guards
the tenant manager's quota buckets and per-tenant books
(``serve/tenants.py``): it is never held across a backend call, and it
sits BELOW ``service`` because the accounting runs in future
done-callbacks, which the batching service fires while holding its own
lock.  ``inflight`` is the
executor's ``_InflightQueue`` lock: it is acquired first when claiming or
retiring a depth slot, with the owning ticket's bookkeeping lock nested
inside it (descending), so a stall-checking ``BatchTicket.wait()`` can
never observe a claimed-but-uncounted window.

Factories
---------
Every lock in the serving stack is created through :func:`make_lock`,
:func:`make_rlock`, or :func:`make_condition` with its rank name — the
static passes read ranks straight out of these calls, and the purity lint
(PU03) rejects bare ``threading.Lock()`` anywhere else.  With
``LINT_LOCKS`` unset the factories return plain ``threading`` primitives
(zero overhead); with ``LINT_LOCKS=1`` they return instrumented
:class:`OrderedLock` objects that record every nested acquisition edge in
the process-wide :data:`WITNESS` and log any order inversion against the
hierarchy.  ``LINT_LOCKS=strict`` additionally RAISES
:class:`LockOrderViolation` at the offending acquire (unit tests; the
stress gates use record mode so a violation fails the test cleanly via
the conftest guard instead of wedging a pump thread mid-protocol).
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["HIERARCHY", "LEVEL", "LockOrderViolation", "OrderedLock",
           "Witness", "WITNESS", "enabled", "strict",
           "make_lock", "make_rlock", "make_condition"]

# innermost first: LEVEL[x] < LEVEL[y] means x must be acquired inside y
HIERARCHY: Tuple[str, ...] = ("future", "ticket", "inflight", "executor",
                              "coalescer", "compaction", "tenant",
                              "service", "router", "client", "autoscaler")
LEVEL: Dict[str, int] = {name: i for i, name in enumerate(HIERARCHY)}


class LockOrderViolation(BaseException):
    """A lock was acquired while holding a lock at or below its level.

    Subclasses ``BaseException`` on purpose: the serving stack's pump and
    ticker loops survive ``Exception`` (a poison batch must not kill a
    replica), but a lock-order inversion is a latent deadlock and must
    never be absorbed by those handlers.
    """


def enabled() -> bool:
    return bool(os.environ.get("LINT_LOCKS"))


def strict() -> bool:
    return os.environ.get("LINT_LOCKS", "").lower() == "strict"


class Witness:
    """Process-wide recorder of actual nested lock acquisitions.

    Thread-local held-lock stacks; a shared edge set ``(outer_rank,
    inner_rank)`` and a violation log.  ``strict=True`` raises at the
    offending acquire instead of only recording.
    """

    def __init__(self, strict: bool = False):
        self.strict = strict
        self._tls = threading.local()
        # meta-lock for the shared edge/violation registries only; it is
        # never held across a ranked-lock acquire, so it cannot deadlock
        self._reg = threading.Lock()
        self.edges: Set[Tuple[str, str]] = set()
        self.violations: List[Dict[str, object]] = []

    # ------------------------------------------------------------ per-thread
    def _stack(self) -> List["OrderedLock"]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    # ------------------------------------------------------------- protocol
    def before_acquire(self, lock: "OrderedLock") -> None:
        """Order check — runs BEFORE the blocking acquire, so a genuine
        inversion is reported rather than deadlocking silently."""
        held = self._stack()
        if not held:
            return
        bad = []
        for h in held:
            if h is lock:               # re-entrant acquire (RLock): fine
                continue
            with self._reg:
                self.edges.add((h.rank, lock.rank))
            if LEVEL[h.rank] <= LEVEL[lock.rank]:
                bad.append(h.rank)
        if bad:
            frame = sys._getframe(2)
            site = f"{frame.f_code.co_filename}:{frame.f_lineno}"
            record = {"thread": threading.current_thread().name,
                      "held": [h.rank for h in held],
                      "acquiring": lock.rank, "site": site}
            with self._reg:
                self.violations.append(record)
            if self.strict:
                raise LockOrderViolation(
                    f"acquiring {lock.rank!r} (level {LEVEL[lock.rank]}) "
                    f"while holding {bad!r} at or below it "
                    f"(held stack: {[h.rank for h in held]}) at {site}; "
                    f"declared hierarchy: {' < '.join(HIERARCHY)}")

    def after_acquire(self, lock: "OrderedLock") -> None:
        self._stack().append(lock)

    def on_release(self, lock: "OrderedLock", count: int = 1) -> None:
        st = self._stack()
        for _ in range(count):
            # releases may be non-LIFO (condition-variable hand-offs):
            # drop the newest frame for THIS lock, wherever it sits
            for i in range(len(st) - 1, -1, -1):
                if st[i] is lock:
                    del st[i]
                    break

    def held_count(self, lock: "OrderedLock") -> int:
        return sum(1 for h in self._stack() if h is lock)

    # -------------------------------------------------------------- reading
    def witnessed_edges(self) -> Set[Tuple[str, str]]:
        with self._reg:
            return set(self.edges)

    def drain_violations(self) -> List[Dict[str, object]]:
        with self._reg:
            out, self.violations = self.violations, []
            return out

    def reset(self) -> None:
        with self._reg:
            self.edges.clear()
            self.violations.clear()


#: the process-wide witness the factories bind to under LINT_LOCKS
WITNESS = Witness()


class OrderedLock:
    """Rank-aware wrapper over ``threading.Lock``/``RLock``.

    Implements the full lock protocol plus the private hooks
    ``threading.Condition`` uses (``_is_owned`` / ``_release_save`` /
    ``_acquire_restore``), so ``threading.Condition(OrderedLock(...))``
    behaves exactly like a Condition over the raw primitive while keeping
    the witness's held-stack bookkeeping correct across ``wait()`` (the
    lock is fully released while parked, so no false inversions against a
    parked pump thread)."""

    __slots__ = ("rank", "_inner", "_witness", "_reentrant")

    def __init__(self, rank: str, witness: Optional[Witness] = None, *,
                 reentrant: bool = False):
        if rank not in LEVEL:
            raise ValueError(f"unknown lock rank {rank!r}; "
                             f"one of {HIERARCHY}")
        self.rank = rank
        self._reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()
        self._witness = witness if witness is not None else WITNESS

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._witness.before_acquire(self)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._witness.after_acquire(self)
        return got

    def release(self) -> None:
        self._inner.release()
        self._witness.on_release(self)

    def __enter__(self) -> "OrderedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __repr__(self) -> str:
        kind = "RLock" if self._reentrant else "Lock"
        return f"OrderedLock({self.rank!r}, {kind})"

    # ---------------------------------------------- Condition integration
    def _is_owned(self) -> bool:
        inner_owned = getattr(self._inner, "_is_owned", None)
        if inner_owned is not None:
            return inner_owned()
        if self._inner.acquire(False):      # plain Lock heuristic, as in
            self._inner.release()           # threading.Condition
            return False
        return True

    def _release_save(self):
        """Fully release (any re-entrant depth) for ``Condition.wait``."""
        depth = max(self._witness.held_count(self), 1)
        saver = getattr(self._inner, "_release_save", None)
        state = saver() if saver is not None else self._inner.release()
        self._witness.on_release(self, count=depth)
        return (state, depth)

    def _acquire_restore(self, saved) -> None:
        state, depth = saved
        self._witness.before_acquire(self)
        restorer = getattr(self._inner, "_acquire_restore", None)
        if restorer is not None:
            restorer(state)
        else:
            self._inner.acquire()
        for _ in range(depth):
            self._witness.after_acquire(self)


# ---------------------------------------------------------------------------
# Factories — the only place serving code creates locks
# ---------------------------------------------------------------------------

def _witness() -> Witness:
    WITNESS.strict = strict()
    return WITNESS


def make_lock(rank: str) -> threading.Lock:
    """A mutex at ``rank``: plain ``threading.Lock`` normally, an
    instrumented :class:`OrderedLock` under ``LINT_LOCKS``."""
    if enabled():
        return OrderedLock(rank, _witness(), reentrant=False)
    if rank not in LEVEL:
        raise ValueError(f"unknown lock rank {rank!r}; one of {HIERARCHY}")
    return threading.Lock()


def make_rlock(rank: str) -> threading.RLock:
    """Re-entrant variant of :func:`make_lock`."""
    if enabled():
        return OrderedLock(rank, _witness(), reentrant=True)
    if rank not in LEVEL:
        raise ValueError(f"unknown lock rank {rank!r}; one of {HIERARCHY}")
    return threading.RLock()


def make_condition(rank: str, lock=None) -> threading.Condition:
    """A condition variable at ``rank``.  Pass ``lock`` to share an
    existing factory-made lock (e.g. a service's ``_cv`` over its
    ``_lock``); otherwise a fresh non-reentrant lock at ``rank`` backs
    it."""
    if lock is None:
        lock = make_lock(rank)
    return threading.Condition(lock)
