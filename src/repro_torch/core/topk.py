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

from typing import Tuple, Union

import torch

from repro_torch.sharding.spec import ShardCtx, axes_tuple

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
    the JAX package: the block (b, s) goes to the logical device at that
    position of the mesh, its top-k runs there, and only its pairs move.
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
    grid = mesh.grid_ids(axes_tuple(b_spec), axes)
    nb, ns = grid.shape
    b, v = scores.shape
    if b % nb or v % ns:
        raise ValueError(f"scores {tuple(scores.shape)} do not split into "
                         f"{nb} x {ns} blocks")
    b_loc, v_loc = b // nb, v // ns
    out = mesh.first_device
    vals, ids = [], []
    for bi in range(nb):
        part_v, part_i = [], []
        for si in range(ns):
            block = scores[bi * b_loc:(bi + 1) * b_loc,
                           si * v_loc:(si + 1) * v_loc].to(
                               mesh.device(grid[bi, si]))
            sv, si_pos = _select(block, min(k, v_loc), largest)
            part_v.append(sv.to(out))
            part_i.append((si_pos + si * v_loc).to(out))
        mv, pos = _select(torch.cat(part_v, -1), k, largest)
        vals.append(mv)
        ids.append(torch.gather(torch.cat(part_i, -1), -1, pos))
    return torch.cat(vals), torch.cat(ids)
