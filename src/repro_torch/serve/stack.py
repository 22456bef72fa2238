"""One constructor for the whole serving stack (the port's counterpart of
``repro.serve.stack``).

:func:`make_serving_stack` is the single place that turns a
:class:`ServingStackConfig` into a started router, so the serving shape
(replica count, policy, batching window, pipeline depth, accuracy knobs)
is declared once and reused everywhere — deployment scripts, the HTTP
edge and ``chip_smoke.py`` all build on it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from repro_torch.core.engine import FusionANNSIndex
from repro_torch.core.executor import MESH_NOT_PORTED
from repro_torch.serve.router import ReplicaRouter

__all__ = ["ServingStackConfig", "make_serving_stack"]


@dataclasses.dataclass
class ServingStackConfig:
    """The serving shape, declared once.  Field defaults are the
    reference's (small batches + a tight window: latency-lean interactive
    serving)."""

    n_replicas: int = 2
    policy: str = "jsq"
    mesh: object = None                 # a mesh raises: not ported yet
    threaded: bool = True
    max_batch: int = 16
    max_wait_s: float = 0.0005
    scan_window: int = 8
    inflight_depth: int = 2
    overlap_rerank: bool = False
    max_queue: int = 1024
    fused: bool = False
    lut_int8: bool = False
    # snapshot directory (DESIGN.md §10): scale-ups hydrate new replicas
    # from ``save_snapshot``/``load_snapshot`` instead of sharing the live
    # index, and ``make_serving_stack(index=None)`` boots the whole stack
    # from an existing checkpoint on disk
    snapshot_dir: Optional[str] = None
    # where ``make_serving_stack(index=None)`` loads the snapshot's codes
    # and codebooks; None means the card (and raises without one).  A
    # given index keeps its own device, and so do replicas hydrated from it
    device: object = None

    def __post_init__(self) -> None:
        if self.mesh is not None:
            raise NotImplementedError(MESH_NOT_PORTED)


def make_serving_stack(index: Optional[FusionANNSIndex] = None,
                       config: Optional[ServingStackConfig] = None,
                       **overrides) -> ReplicaRouter:
    """Build the serving stack for ``index``: a
    :class:`~repro_torch.serve.router.ReplicaRouter` over ``n_replicas``
    batching replicas, configured from ``config`` (or a fresh default)
    with keyword ``overrides`` applied on top.  Started when
    ``threaded=True`` (the default) — callers own the ``stop()``.

    ``index=None`` requires ``snapshot_dir`` pointing at a
    ``save_snapshot`` checkpoint: the stack hydrates its index from disk
    onto ``device`` (replica restart without rebuilding), answering with
    bit-identical ids to the index the snapshot was taken from."""
    cfg = dataclasses.replace(config or ServingStackConfig(), **overrides)
    if index is None:
        if cfg.snapshot_dir is None or not os.path.isdir(cfg.snapshot_dir):
            raise ValueError(
                "make_serving_stack(index=None) needs snapshot_dir= "
                "pointing at an existing save_snapshot() directory")
        index = FusionANNSIndex.load_snapshot(cfg.snapshot_dir,
                                              device=cfg.device)
    return ReplicaRouter(
        index, n_replicas=cfg.n_replicas, policy=cfg.policy,
        threaded=cfg.threaded, snapshot_dir=cfg.snapshot_dir,
        max_batch=cfg.max_batch,
        max_wait_s=cfg.max_wait_s, scan_window=cfg.scan_window,
        inflight_depth=cfg.inflight_depth,
        overlap_rerank=cfg.overlap_rerank, max_queue=cfg.max_queue,
        fused=cfg.fused, lut_int8=cfg.lut_int8)
