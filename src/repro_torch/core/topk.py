"""Two-level distributed top-k: shard-local top-k, the (value, id) pairs
copied to the mesh's first device, merged there (the port's counterpart
of ``repro.core.topk``).

This is the pattern FusionANNS needs for its sharded ADC scan (step 7:
per-shard candidate lists merged into the global top-n).  Only
(k x n_shards) (value, id) pairs cross devices — never the scores.

Selection is a stable sort, not ``torch.topk``: ``lax.top_k`` keeps the
lowest index among equal values, and ``torch.topk`` promises no order of
ties on CUDA.  Shards are concatenated in shard order, so a stable merge
gives ties to the lowest global index, as ``lax.top_k`` over the
all-gathered array does.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch

from repro_torch.sharding.spec import P, ShardCtx, axes_tuple, shard_map

Axes = Union[str, Tuple[str, ...]]


def _select(vals: torch.Tensor, k: int, largest: bool
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first k of a stable sort along the last axis (largest first
    when ``largest``): equal values keep ascending index order."""
    v, pos = torch.sort(vals, dim=-1, descending=largest, stable=True)
    return v[..., :k], pos[..., :k]


def local_topk_merge(vals: torch.Tensor, idx: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard (vals, idx) of shape (..., n*k) into the global
    top-k (largest first)."""
    v, pos = _select(vals, k, True)
    return v, torch.gather(idx, -1, pos)


def sharded_topk(scores: torch.Tensor, k: int, ctx: ShardCtx, *,
                 shard_axes: Axes, batch_axes: Axes = "batch",
                 largest: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """scores (B, V) -> (vals, global ids) each (B, k), on the mesh's
    first device.

    V is split over the mesh axes ``shard_axes`` and B over
    ``batch_axes`` (a logical rule name, resolved through ``ctx.rules``,
    or mesh axes), as ``PartitionSpec(batch, shard_axes)`` places them in
    the JAX package: ``sharding.spec.shard_map`` puts each block on its
    logical device, its top-k runs there, and only its pairs move to the
    mesh's first device, concatenated in shard order for the merge.
    B and V must split evenly (``shard_map`` refuses otherwise), and k
    may not pass V (nor may ``lax.top_k``'s)."""
    if k > scores.shape[-1]:
        raise ValueError(f"k={k} exceeds the {scores.shape[-1]} scores a row")
    if ctx.mesh is None:
        return _select(scores, k, largest)
    mesh = ctx.mesh
    axes = axes_tuple(shard_axes)
    b_spec = (getattr(ctx.rules, batch_axes)
              if isinstance(batch_axes, str) and hasattr(ctx.rules,
                                                         batch_axes)
              else batch_axes)
    nb = math.prod(mesh.shape.get(a, 1) for a in axes_tuple(b_spec))
    ns = math.prod(mesh.shape.get(a, 1) for a in axes)
    b, v = scores.shape
    if b % nb or v % ns:
        raise ValueError(f"scores {tuple(scores.shape)} do not split into "
                         f"{nb} x {ns} blocks")
    v_loc = v // ns

    def local(shard, block):
        sv, pos = _select(block, min(k, v_loc), largest)
        return sv, pos + shard.axis_index(axes) * v_loc

    blocks = P(b_spec, axes)
    part_v, part_i = shard_map(local, mesh, (blocks,), (blocks, blocks))(
        scores)
    mv, pos = _select(part_v, k, largest)
    return mv, torch.gather(part_i, -1, pos)
