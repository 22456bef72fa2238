"""Futures for asynchronous query submission (thread-safe).

The paper's throughput rests on keeping the CPU re-rank of batch *t*
overlapped with the GPU scan of batch *t+1* (§3, §4.2).  Here the
"stream" is the CUDA stream: device work is in flight the moment the
scan is launched, and the host only blocks when it *reads* the result
(a CUDA event marks when the window's (dist, id) pairs have landed).
This module gives that overlap a public shape:

* :class:`QueryFuture` — one per submitted query.  ``done()/result()/
  cancel()/exception()`` mirror ``concurrent.futures`` semantics.  Two
  producer styles coexist:

  - **driver-based** (synchronous harness): a pending future *drives* its
    producer (the executor's in-flight queue, or the serving pump loop)
    from ``result()`` instead of parking a thread;
  - **blocking** (threaded serving runtime): a dedicated pump thread owns
    progress, and ``result()``/``exception()`` are real waits on the
    future's condition variable until the producer resolves it.

  State transitions (``_set_result``/``_set_exception``/``cancel``) are
  atomic under a per-future lock, so producer threads, ticker threads,
  and caller threads may touch one future concurrently.
* :class:`BatchTicket` — the handle ``QueryExecutor.submit`` returns
  immediately after host traversal + device dispatch.  It owns the pump
  that retires in-flight scan windows and the ``events`` ordering probe
  (``("dispatch", t)`` / ``("finish", t)``) that tests use to assert the
  host dispatched window t+1 before blocking on window t.  A ``finish``
  event is recorded when the window's re-rank *completes*, so a ticker
  thread retiring a younger window while an older one is still re-ranking
  shows up as out-of-window-order ``finish`` events.

Cancellation is per-query and takes effect at the per-query stage: the
shared window scan is already in flight on the device, so ``cancel()``
skips the query's SSD re-rank (the expensive host stage) and leaves the
scan untouched.  Deadlines behave the same way: they are checked when the
query's re-rank would start, never mid-kernel.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Tuple

from repro_torch.analysis.concurrency.witness import make_condition, make_rlock

__all__ = [
    "QueryFuture", "BatchTicket",
    "FutureError", "CancelledError", "DeadlineExceeded", "BackpressureError",
]


class FutureError(RuntimeError):
    """Base class for query-future failures."""


class CancelledError(FutureError):
    """Raised by ``result()``/``exception()`` on a cancelled future."""


class DeadlineExceeded(FutureError):
    """The request's deadline passed before its re-rank stage started."""


class BackpressureError(FutureError):
    """Admission control: the serving queue is full; retry later."""


_PENDING, _CANCELLED, _DONE, _ERROR = range(4)

# bounded condition-variable wait so a caller parked on a future whose
# producer died still re-checks state (and any caller timeout) regularly
_WAIT_SLICE_S = 0.05


class QueryFuture:
    """Result handle for one submitted query.

    ``result()`` drives the producer (``_driver`` — set by whoever created
    the future) until this future resolves, or — for ``blocking=True``
    futures owned by a pump thread — waits on the future's condition
    variable until the producer resolves it.
    """

    __slots__ = ("_state", "_result", "_exc", "_driver", "_blocking",
                 "_cond", "_callbacks", "tag")

    def __init__(self, tag: Any = None,
                 driver: Optional[Callable[[], bool]] = None,
                 blocking: bool = False):
        self._cond = make_condition("future")
        self._state = _PENDING                   # guarded-by: _cond
        self._result: Any = None                 # guarded-by: _cond
        self._exc: Optional[BaseException] = None   # guarded-by: _cond
        self._driver = driver
        self._blocking = blocking
        self._callbacks: List[Callable[["QueryFuture"], None]] = []  # guarded-by: _cond
        self.tag = tag

    # -------------------------------------------------------------- queries
    def done(self) -> bool:
        """True once resolved — with a result, an exception, or cancelled."""
        # _state transitions are monotonic (pending -> terminal) and an
        # int read is atomic in CPython: a stale False means "poll again"
        # lint-ok: GB01 lock-free fast path on a monotonic state word
        return self._state != _PENDING

    def cancelled(self) -> bool:
        # lint-ok: GB01 lock-free fast path, same monotonicity as done()
        return self._state == _CANCELLED

    # ------------------------------------------------------------- commands
    def cancel(self) -> bool:
        """Cancel if still pending.  The shared scan is not recalled (it is
        already on the device); the query's re-rank is skipped.  Returns
        True if this call (or a previous one) cancelled the future."""
        with self._cond:
            if self._state == _CANCELLED:
                return True
            if self._state != _PENDING:
                return False
            self._state = _CANCELLED
            self._cond.notify_all()
        self._run_callbacks()
        return True

    # ------------------------------------------------------------ callbacks
    def add_done_callback(self, fn: Callable[["QueryFuture"], None]) -> None:
        """Call ``fn(self)`` exactly once when this future resolves — with
        a result, an exception, or a cancellation.  If the future is
        already resolved the callback fires immediately, in the calling
        thread; otherwise it fires in whichever thread resolves the future
        (producer thread, ticker, or a caller driving the sync harness).

        The registered-vs-fired decision is atomic under the per-future
        lock, so a callback registered concurrently with resolution never
        fires twice and never gets lost.  Callbacks run OUTSIDE the lock
        (an asyncio bridge calling ``loop.call_soon_threadsafe`` from the
        callback must not deadlock against a caller holding it); a raising
        callback does not poison the future or its other callbacks."""
        with self._cond:
            if self._state == _PENDING:
                self._callbacks.append(fn)
                return
        try:
            fn(self)
        except Exception:                  # noqa: BLE001 — callback's problem
            pass

    def _run_callbacks(self) -> None:
        with self._cond:
            cbs, self._callbacks = self._callbacks, []
        for fn in cbs:
            try:
                fn(self)
            except Exception:              # noqa: BLE001 — callback's problem
                pass

    # ----------------------------------------------------------------- wait
    def _await(self, timeout: Optional[float], what: str) -> None:
        """Block (or drive) until resolved; raises TimeoutError on caller
        timeout and FutureError when no producer can make progress."""
        deadline = (time.perf_counter() + timeout
                    if timeout is not None else None)
        while True:
            with self._cond:
                if self._state != _PENDING:
                    return
                if deadline is not None and time.perf_counter() > deadline:
                    raise TimeoutError(f"QueryFuture.{what} timed out")
                driver, blocking = self._driver, self._blocking
                if driver is None:
                    if not blocking:
                        raise FutureError(
                            "QueryFuture is pending with no producer "
                            "(was the service queue dropped?)")
                    # a pump thread owns progress: park on the condition
                    # variable until it resolves us (bounded slices so a
                    # dead producer or a caller timeout is still noticed)
                    slice_s = _WAIT_SLICE_S if deadline is None else \
                        min(_WAIT_SLICE_S,
                            max(deadline - time.perf_counter(), 0.0))
                    self._cond.wait(slice_s)
                    continue
            # drive OUTSIDE the lock: the producer resolves futures (and
            # takes their locks) from inside its own critical sections
            if not driver():
                if not blocking:
                    raise FutureError(
                        "QueryFuture is pending but its producer made no "
                        "progress (was the service queue dropped?)")
                time.sleep(0.0005)

    def result(self, timeout: Optional[float] = None) -> Any:
        self._await(timeout, "result")
        with self._cond:
            if self._state == _CANCELLED:
                raise CancelledError("query was cancelled")
            if self._state == _ERROR:
                raise self._exc
            return self._result

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        """The stored exception (None if the future holds a result).
        Waits/drives like ``result()``; raises on cancellation."""
        self._await(timeout, "exception")
        with self._cond:
            if self._state == _CANCELLED:
                raise CancelledError("query was cancelled")
            return self._exc

    # ------------------------------------------------- producer-side setters
    def _set_result(self, value: Any) -> None:
        with self._cond:
            if self._state != _PENDING:
                return
            self._result = value
            self._state = _DONE
            self._cond.notify_all()
        self._run_callbacks()

    def _set_exception(self, exc: BaseException) -> None:
        with self._cond:
            if self._state != _PENDING:
                return
            self._exc = exc
            self._state = _ERROR
            self._cond.notify_all()
        self._run_callbacks()


class BatchTicket:
    """Handle for one ``submit()`` call: the per-query futures plus the
    pump that makes progress on the in-flight window queue.

    ``events`` records ``("dispatch", t)`` / ``("finish", t)`` in host
    order — the ordering probe for the pipelining contract ("dispatch
    window t+1 before blocking on window t's scan").  ``finish`` is
    appended when the window's re-rank completes, so concurrent retirement
    (pump thread + ticker) surfaces as out-of-window-order finishes.

    Thread-safety: ``_lock``/``_cond`` guard the event list and the
    ``_busy`` work-in-progress counter (windows currently being dispatched
    or retired by some thread); the executor's pump/poll closures maintain
    them.  ``wait()`` blocks on ``_cond`` instead of spinning when another
    thread holds the only remaining work.
    """

    def __init__(self, futures: List[QueryFuture],
                 events: Optional[List[Tuple[str, int]]] = None):
        self.futures = futures
        self._lock = make_rlock("ticket")
        self._cond = make_condition("ticket", self._lock)
        self.events: List[Tuple[str, int]] = events if events is not None \
            else []                              # guarded-by: _lock
        self._pump: Callable[[], bool] = lambda: False
        self._poll: Callable[[], bool] = lambda: False
        # windows mid-dispatch/mid-retire, any thread
        self._busy = [0]                         # guarded-by: _lock

    def __len__(self) -> int:
        return len(self.futures)

    def done(self) -> bool:
        return all(f.done() for f in self.futures)

    def poll(self) -> bool:
        """Non-blocking progress: retire any window whose device scan
        already landed (possibly out of order — younger windows may finish
        while an older one is still re-ranking on another thread), and
        dispatch queued windows into freed depth slots.  Returns True if
        anything advanced."""
        return self._poll()

    def _stall_message(self) -> str:             # holds: _lock
        pending = [f.tag for f in self.futures if not f.done()]
        disp = {wi for kind, wi in self.events if kind == "dispatch"}
        fin = {wi for kind, wi in self.events if kind == "finish"}
        stalled = sorted(disp - fin)
        where = (f"stalled window(s) {stalled}" if stalled
                 else "window(s) never dispatched")
        return (f"BatchTicket.wait(): producer made no progress but "
                f"{len(pending)} future(s) are still pending "
                f"(tags {pending[:8]}{'...' if len(pending) > 8 else ''}); "
                f"{where}")

    def wait(self) -> "BatchTicket":
        """Drive the pump until every future is resolved.  Exceptions stay
        stored on their futures; ``wait()`` itself never raises them —
        but a genuine stall (no dispatchable or retirable work, no other
        thread mid-window, futures still pending) raises
        :class:`FutureError` naming the stalled window instead of
        returning silently and letting ``results()`` fail far from the
        cause."""
        while not self.done():
            if self._pump():
                continue
            # nothing to dispatch or retire HERE — either another thread
            # is mid-window (wait for it) or the ticket is truly stalled
            with self._cond:
                if self._busy[0] > 0:
                    self._cond.wait(_WAIT_SLICE_S)
                    continue
            if self.done():
                break
            with self._cond:
                msg = self._stall_message()
            raise FutureError(msg)
        # barrier: let concurrent retirements finish their bookkeeping
        # (the finish event is appended before _busy drops to 0)
        with self._cond:
            while self._busy[0] > 0:
                self._cond.wait(_WAIT_SLICE_S)
        return self

    def results(self) -> List[Any]:
        """``wait()`` then collect in submission order.  Re-raises the
        first stored exception (cancellation / deadline), so plain callers
        that never cancel get a clean ``List[QueryResult]``."""
        self.wait()
        return [f.result() for f in self.futures]
