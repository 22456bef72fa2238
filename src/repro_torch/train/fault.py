"""Fault tolerance: supervised training with checkpoint/restart, bounded
retries and straggler deadlines: the port of the JAX package's
``train/fault.py``.

Failures are injected through ``FaultInjector`` (on a cluster the signal
is a missing heartbeat or a collective's timeout), and the supervisor
takes the recovery path production would: catch -> restore the latest
checkpoint -> (optionally re-place it on a resized mesh) -> resume from
its step.  :func:`reshard_state` is the elastic resize: every leaf moves
to its new sharding's placement (the port keeps a leaf whole on its
mesh's first device), its value unchanged.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.loop import TrainConfig, run

log = logging.getLogger("repro_torch.fault")


class WorkerFailure(RuntimeError):
    """Simulated node failure."""


class StragglerTimeout(RuntimeError):
    """Step exceeded its deadline (straggler mitigation trigger)."""


@dataclasses.dataclass
class FaultInjector:
    """Raises WorkerFailure at the given global steps (each fires once)."""

    fail_at_steps: List[int] = dataclasses.field(default_factory=list)
    fired: set = dataclasses.field(default_factory=set)

    def __call__(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise WorkerFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class StepDeadline:
    """Straggler mitigation: track per-step wall time; steps beyond
    ``deadline_s`` raise so the supervisor can re-dispatch (in this
    single-host harness that means: record + continue)."""

    deadline_s: float = 60.0
    history: List[float] = dataclasses.field(default_factory=list)
    _t: float = 0.0

    def start(self) -> None:
        self._t = time.time()

    def finish(self) -> None:
        dt = time.time() - self._t
        self.history.append(dt)
        if dt > self.deadline_s:
            raise StragglerTimeout(f"step took {dt:.1f}s > {self.deadline_s}s")

    def p99(self) -> float:
        return float(np.percentile(self.history, 99)) if self.history else 0.0


def supervise(make_train_step: Callable[[], Callable],
              init_state_fn: Callable[[], Any],
              batch_iter_fn: Callable[[int], Iterable],
              tcfg: TrainConfig,
              *,
              total_steps: int,
              max_restarts: int = 5,
              on_step: Optional[Callable[[int], None]] = None,
              shardings_fn: Optional[Callable[[], Any]] = None,
              device=None):
    """Run to ``total_steps`` surviving worker failures: on one, restore
    the latest checkpoint of ``tcfg.ckpt_dir`` onto ``device`` (None: the
    card) and resume from its step (from ``init_state_fn()`` and step 0
    where there is none), at most ``max_restarts`` times.  A checkpoint
    already there when it starts is resumed from.  ``shardings_fn()``,
    where given, is the restored state's tree of shardings (a mesh that
    may have shrunk or grown since the checkpoint): the state is
    re-placed by :func:`reshard_state`.  Returns (state, restarts,
    history)."""

    def restore():
        state, step = ckpt_lib.restore(tcfg.ckpt_dir, device=device)
        if shardings_fn is not None:
            state = reshard_state(state, shardings_fn())
        return state, step

    restarts = 0
    history: List[Dict] = []
    train_step = make_train_step()
    last = ckpt_lib.latest_step(tcfg.ckpt_dir) if tcfg.ckpt_dir else None
    if last is not None:
        state, step = restore()
    else:
        state, step = init_state_fn(), 0

    while step < total_steps:
        try:
            state, step, h = run(
                train_step, state,
                batch_iter_fn(total_steps - step), tcfg,
                start_step=step, on_step=on_step)
            history.extend(h)
        except WorkerFailure as e:
            restarts += 1
            log.warning("worker failure (%s); restart %d/%d",
                        e, restarts, max_restarts)
            if restarts > max_restarts:
                raise
            del state                      # its memory, before the restore
            last = ckpt_lib.latest_step(tcfg.ckpt_dir)
            if last is None:
                state, step = init_state_fn(), 0
            else:
                state, step = restore()
    return state, restarts, history


def reshard_state(state, new_shardings):
    """Elastic resize: re-place every tensor of ``state`` under the leaf at
    the same place in ``new_shardings``, a tree like ``state``: a
    ``sharding.spec.NamedSharding`` (its mesh's first device, where the
    port keeps a whole leaf), a device, or None (left where it is).  The
    values are unchanged."""
    def place(x, s):
        if s is None:
            return x
        return torch.as_tensor(x).to(getattr(s, "device", s))
    return tree.tree_map(place, state, new_shardings)
