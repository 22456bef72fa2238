"""Elastic replica autoscaling (the port's counterpart of
``repro.serve.autoscaler``).

The :class:`~repro_torch.serve.router.ReplicaRouter` turned multi-replica
serving into a routing problem; this module turns replica COUNT into a
control problem.  :class:`ReplicaAutoscaler` samples the router's
``scaling_signals()`` — live load, backpressure spills, queue-latency
percentiles — and grows/shrinks the replica set within
``[min_replicas, max_replicas]`` by calling the router's
``add_replica()`` / ``remove_replica(drain=True)`` actuators.  Without a
mesh (the only form ported so far) every replica serves the one index on
its device; a resize adds or drains a pump/ticker pair.

Scaling decisions are HYSTERETIC — a serving tier that flaps burns its
win on replica start-up and drain churn:

* **scale up** when the per-replica live load exceeds ``high_water``, or
  the spill/reject counters moved since the last tick (the current set
  demonstrably could not place demand), or queue p99 exceeds
  ``p99_bound_s`` — but never within ``scale_up_cooldown_s`` of the last
  resize, and never above the analytic model's
  :func:`~repro_torch.core.perf_model.max_useful_replicas` bound once
  measured demand exists (past that point a shared resource binds and more
  replicas serve nothing extra).
* **scale down** only when per-replica load sat below ``low_water`` for
  ``down_ticks`` CONSECUTIVE samples with no spills in between, outside
  ``scale_down_cooldown_s`` of any resize.  The victim is the
  least-loaded replica; its removal drains (zero leaked futures).

The control loop is a plain ``tick()`` method so tests drive it
deterministically with a fake clock; ``start()`` wraps it in a daemon
thread for live serving.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

from repro_torch.analysis.concurrency.witness import make_lock
from repro_torch.serve.router import ReplicaRouter

__all__ = ["AutoscalerConfig", "ReplicaAutoscaler"]


@dataclasses.dataclass
class AutoscalerConfig:
    min_replicas: int = 1
    max_replicas: int = 4
    interval_s: float = 0.05           # background-loop sampling period
    high_water: float = 8.0            # live requests PER replica -> grow
    low_water: float = 1.0             # live requests per replica -> shrink
    p99_bound_s: Optional[float] = None   # queue p99 above this -> grow
    scale_up_cooldown_s: float = 0.1
    scale_down_cooldown_s: float = 0.5
    down_ticks: int = 3                # consecutive calm samples to shrink
    threads_per_replica: int = 8       # model-bound input
    model_min_gain: float = 1.02       # qps gain ratio that still "counts"

    def __post_init__(self) -> None:
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if self.low_water >= self.high_water:
            raise ValueError("low_water must be < high_water")


class ReplicaAutoscaler:
    """Drives a :class:`ReplicaRouter`'s replica count from its own load
    signals.  ``tick()`` is the whole control law (pure given the clock);
    ``start()``/``stop()`` run it on a daemon thread.

    When the router carries a ``snapshot_dir`` (DESIGN.md §10), every
    scale-up this controller triggers hydrates the new replica from a
    fresh ``save_snapshot`` of the live index — checkpoint/restore
    instead of a from-scratch rebuild, so elastic capacity arrives at
    the donor's exact epoch with bit-identical ids."""

    def __init__(self, router: ReplicaRouter,
                 config: Optional[AutoscalerConfig] = None,
                 clock: Callable[[], float] = time.monotonic, **kw):
        self.router = router
        self.cfg = config or AutoscalerConfig(**kw)
        self.clock = clock
        self._lock = make_lock("autoscaler")
        self._thread: Optional[threading.Thread] = None
        # _last_resize_t/_calm_ticks/_seen are control-thread-confined
        # (only tick() touches them, and ticks never overlap), so they are
        # deliberately unguarded
        self._stop_evt = threading.Event()
        self._last_resize_t: Optional[float] = None
        self._last_resize_was_up = False
        self._calm_ticks = 0
        # spill/reject deltas are what signal "couldn't place demand";
        # absolute counters only ever grow
        self._seen = {"spills": 0, "spill_exhausted": 0, "rejected": 0}
        self.events: List[Dict[str, object]] = []  # guarded-by: _lock
        self.stats: Dict[str, int] = {
            "ticks": 0, "scale_ups": 0, "scale_downs": 0,
            "capped_by_model": 0, "capped_by_max": 0}  # guarded-by: _lock

    # ------------------------------------------------------------- signals
    def _model_cap(self) -> Optional[int]:
        """The analytic model's ceiling on useful replicas, from measured
        demand.  None until the router has served traffic (an idle tier
        has no demand profile to model)."""
        roll = self.router.stats_rollup()
        if roll["served"] <= 0:
            return None
        from repro_torch.core.perf_model import DeviceModel, max_useful_replicas
        return max_useful_replicas(
            self.router.measured_demand(), DeviceModel(),
            threads_per_replica=self.cfg.threads_per_replica,
            min_gain=self.cfg.model_min_gain,
            cap=self.cfg.max_replicas)

    def _in_cooldown(self, now: float, window_s: float) -> bool:
        return (self._last_resize_t is not None
                and now - self._last_resize_t < window_s)

    # ---------------------------------------------------------- control law
    def tick(self) -> Optional[str]:
        """One control-loop step: sample, decide, actuate.  Returns the
        action taken (``"scale_up"``/``"scale_down"``) or None."""
        cfg = self.cfg
        now = self.clock()
        sig = self.router.scaling_signals()
        n = sig["n_replicas"]
        per_replica = sig["live_load"] / max(n, 1)
        new_spills = (sig["spills"] - self._seen["spills"]
                      + sig["spill_exhausted"]
                      - self._seen["spill_exhausted"]
                      + sig["rejected"] - self._seen["rejected"])
        for k in self._seen:
            self._seen[k] = int(sig[k])
        with self._lock:
            self.stats["ticks"] += 1

        overloaded = per_replica > cfg.high_water or new_spills > 0
        if (cfg.p99_bound_s is not None and sig["latency_n"] > 0
                and sig["p99"] > cfg.p99_bound_s):
            overloaded = True

        action: Optional[str] = None
        if overloaded:
            self._calm_ticks = 0
            if n < cfg.max_replicas \
                    and not self._in_cooldown(now, cfg.scale_up_cooldown_s):
                cap = self._model_cap()
                if cap is not None and n >= cap:
                    with self._lock:
                        self.stats["capped_by_model"] += 1
                else:
                    slot = self.router.add_replica()
                    self._last_resize_t, self._last_resize_was_up = now, True
                    with self._lock:
                        self.stats["scale_ups"] += 1
                    action = "scale_up"
                    self._record(now, action, sig, slot=slot)
            elif n >= cfg.max_replicas:
                with self._lock:
                    self.stats["capped_by_max"] += 1
        elif per_replica < cfg.low_water:
            self._calm_ticks += 1
            # a shrink right after a grow would flap: the down-cooldown
            # window starts at the LAST resize, whichever direction
            if (self._calm_ticks >= cfg.down_ticks
                    and n > cfg.min_replicas
                    and not self._in_cooldown(
                        now, cfg.scale_down_cooldown_s)):
                slot = self.router.remove_replica(drain=True)
                self._last_resize_t, self._last_resize_was_up = now, False
                self._calm_ticks = 0
                with self._lock:
                    self.stats["scale_downs"] += 1
                action = "scale_down"
                self._record(now, action, sig, slot=slot)
        else:
            self._calm_ticks = 0
        return action

    def _record(self, now: float, action: str, sig: Dict[str, object],
                **extra) -> None:
        # sample the router BEFORE taking our lock: n_replicas takes the
        # router's lock, and nested acquisition here buys nothing
        n = self.router.n_replicas
        with self._lock:
            self.events.append({"t": now, "action": action,
                                "n_replicas": n,
                                "live_load": sig["live_load"],
                                "p99": sig["p99"], **extra})

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ReplicaAutoscaler":
        """Run ``tick()`` every ``interval_s`` on a daemon thread
        (idempotent)."""
        with self._lock:
            if self._thread is not None:
                return self
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._loop, name="replica-autoscaler", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop_evt.wait(self.cfg.interval_s):
            try:
                self.tick()
            except Exception:        # noqa: BLE001 — a bad sample must not
                with self._lock:     # kill the control loop
                    self.stats["tick_errors"] = \
                        self.stats.get("tick_errors", 0) + 1

    def stop(self) -> "ReplicaAutoscaler":
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        return self

    def __enter__(self) -> "ReplicaAutoscaler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
