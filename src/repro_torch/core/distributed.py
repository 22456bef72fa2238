"""Distributed FusionANNS scan: PQ codes row-sharded over a mesh's logical
devices (the paper's "pinned in GPU HBM" tier, scaled to several cards —
DESIGN.md §2), and the copy of a window's (dist, id) pairs to the host.

Per query batch each shard runs the port's kernel for its function on
its own device — ``pq_adc_topk`` (``adc_scan_topk``) for
:func:`sharded_adc_topn`, ``pq_adc_topk_batch`` (``adc_scan_batch``) for
:func:`sharded_adc_topn_batch`, :func:`sharded_adc_topn_window` and the
executor's :func:`sharded_adc_topn_bucket`, ``pq_adc_fused_topk``
(``adc_fused_topk``, its spill route included) for
:func:`sharded_adc_topn_rows` — and takes a *local* top-n; only the
(dist, global-id) pairs are copied to the mesh's first device and merged
there by a stable sort, shards in order, so equal distances go to the
lowest global id as ``lax.top_k`` over the all-gathered pairs does.
Vector contents never cross devices: the paper's ID-only invariant.
One process drives every shard (as ``shard_map`` does in the JAX
package); a shard's launches run on its device's current stream.

``ctx.mesh is None`` is the one-device path: the same kernels over the
whole codes tensor.  Codes come as one tensor, split evenly on entry
(``ValueError`` where the rows do not divide, as ``shard_map`` refuses
them), or as a :class:`CodeShards` placement the executor keeps per
codes version.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels.pq_adc.ops import (pq_adc_fused_topk, pq_adc_topk,
                                            pq_adc_topk_batch)
from repro_torch.sharding.spec import LOCAL_CTX, ShardCtx, axes_tuple

BLOCK_N = 65536      # rows a block of the reference's blocked batch scan

Replicated = Union[torch.Tensor, Tuple[torch.Tensor, ...]]


@dataclasses.dataclass(frozen=True)
class CodeShards:
    """The codes tier row-sharded over a mesh's ``corpus`` axes: shard s
    holds rows ``[starts[s], starts[s + 1])`` as ``parts[s]`` on its
    logical device's device — a view where that is the source's device,
    a copy on another card."""

    parts: Tuple[torch.Tensor, ...]
    starts: Tuple[int, ...]


def shard_devices(ctx: ShardCtx) -> List[torch.device]:
    """The device of each corpus shard of ``ctx.mesh``, in shard order."""
    mesh = ctx.mesh
    return mesh.devices_of(mesh.grid_ids(axes_tuple(ctx.rules.corpus)))


def shard_codes(codes: torch.Tensor, ctx: ShardCtx, *,
                even: bool = True) -> CodeShards:
    """Split ``codes`` (N, M) into contiguous row shards, one a corpus
    shard of ``ctx.mesh``, each placed on its device.  ``even``: N must
    divide by the shard count (``ValueError`` otherwise); else the shards
    take ceil(N / S) rows and the last fewer, so no row is padded or
    copied on the source's own device."""
    devs = shard_devices(ctx)
    n, s = int(codes.shape[0]), len(devs)
    if even and n % s:
        raise ValueError(f"{n} code rows do not split over {s} shards")
    n_loc = -(-n // s)
    starts = tuple(min(i * n_loc, n) for i in range(s + 1))
    return CodeShards(
        parts=tuple(codes[starts[i]:starts[i + 1]].to(dev)
                    for i, dev in enumerate(devs)),
        starts=starts)


def _placed(codes: Union[torch.Tensor, CodeShards], ctx: ShardCtx, *,
            ragged: bool) -> CodeShards:
    if isinstance(codes, torch.Tensor):
        return shard_codes(codes, ctx)
    if len(codes.parts) != len(shard_devices(ctx)):
        raise ValueError(f"{len(codes.parts)} code shards for a mesh of "
                         f"{len(shard_devices(ctx))} corpus shards")
    if not ragged and len({p.shape[0] for p in codes.parts}) > 1:
        raise ValueError("this function takes equal code shards")
    return codes


def replicate_to_mesh(x: Replicated, ctx: ShardCtx) -> Replicated:
    """``x`` on each corpus shard's device, in shard order: one copy per
    device other than ``x``'s own, shared by the shards on that device
    (so a mesh of logical devices on one card copies nothing).  A tuple
    (already replicated) and, without a mesh, ``x`` itself come back
    unchanged."""
    if ctx.mesh is None or isinstance(x, tuple):
        return x
    copies = {}
    out = []
    for dev in shard_devices(ctx):
        if dev not in copies:
            copies[dev] = x.to(dev)
        out.append(copies[dev])
    return tuple(out)


def _merge(vals: Sequence[torch.Tensor], ids: Sequence[torch.Tensor],
           width: int, dev: torch.device
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The shards' (..., tk_s) pairs on ``dev``, in shard order, merged by
    a stable sort on distance: the first ``width``, (+inf, -1) after the
    last pair."""
    v = torch.cat([x.to(dev) for x in vals], dim=-1)
    i = torch.cat([x.to(dev) for x in ids], dim=-1)
    sv, pos = torch.sort(v, dim=-1, stable=True)
    sv, si = sv[..., :width], torch.gather(i, -1, pos[..., :width])
    short = width - sv.shape[-1]
    if short > 0:
        shape = (*sv.shape[:-1], short)
        sv = torch.cat([sv, torch.full(shape, torch.inf, dtype=sv.dtype,
                                       device=dev)], dim=-1)
        si = torch.cat([si, torch.full(shape, -1, dtype=si.dtype,
                                       device=dev)], dim=-1)
    return sv, si


def sharded_adc_topn(codes, lut: Replicated, top_n: int,
                     ctx: ShardCtx = LOCAL_CTX
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """codes (N, M) uint8 row-sharded over the ``corpus`` axes, lut
    (M, K) f32 -> (dists (tk,), global ids (tk,)), tk = min(top_n, N) on
    one device and, on a mesh, min(top_n, rows a shard) as in the JAX
    package."""
    if ctx.mesh is None:
        return pq_adc_topk(codes, lut, top_n)
    sh = _placed(codes, ctx, ragged=False)
    tk = min(top_n, sh.parts[0].shape[0])
    luts = replicate_to_mesh(lut, ctx)
    vals, ids = [], []
    for part, start, lut_s in zip(sh.parts, sh.starts, luts):
        v, i = pq_adc_topk(part, lut_s, tk)
        vals.append(v)
        ids.append(i + start)
    return _merge(vals, ids, tk, ctx.mesh.first_device)


def sharded_adc_topn_batch(codes, luts: Replicated, top_n: int,
                           ctx: ShardCtx = LOCAL_CTX, *,
                           blocked: bool = True
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched queries: luts (B, M, K) -> ((B, tk) dists, (B, tk) global
    ids); tk = min(top_n, N) on one device.  On a mesh the widths are the
    JAX package's: ``blocked`` (its scan in blocks of 65,536 rows, each
    shard's rows whole blocks, else ``ValueError``) gives min(top_n,
    block), ``blocked=False`` min(top_n, rows a shard).  Each shard runs
    the dense kernel over its rows (each code byte read once a batch)."""
    if ctx.mesh is None:
        return pq_adc_topk_batch(codes, luts, top_n)
    sh = _placed(codes, ctx, ragged=False)
    n_loc = sh.parts[0].shape[0]
    if blocked:
        bn = min(BLOCK_N, n_loc)
        if bn and n_loc % bn:
            raise ValueError(f"{n_loc} rows a shard are not whole blocks "
                             f"of {bn}")
        tk = min(top_n, bn)
    else:
        tk = min(top_n, n_loc)
    reps = replicate_to_mesh(luts, ctx)
    vals, ids = [], []
    for part, start, luts_s in zip(sh.parts, sh.starts, reps):
        v, i = pq_adc_topk_batch(part, luts_s, tk)
        vals.append(v)
        ids.append(i + start)
    return _merge(vals, ids, tk, ctx.mesh.first_device)


def sharded_adc_topn_window(codes, luts: Replicated, mask: torch.Tensor,
                            top_n: int, ctx: ShardCtx = LOCAL_CTX
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate-bucket scan with per-query membership: codes (N, M)
    uint8 row-sharded over the ``corpus`` axes, luts (B, M, K) f32, mask
    (B, N) bool (True where row N is one of query B's candidates; its
    columns split as the rows) -> (dists (B, tk), bucket positions
    (B, tk)), tk = min(top_n, N).  Masked-out slots surface as +inf."""
    if ctx.mesh is None:
        return pq_adc_topk_batch(codes, luts, top_n, mask=mask)
    sh = _placed(codes, ctx, ragged=False)
    n_loc = sh.parts[0].shape[0]
    reps = replicate_to_mesh(luts, ctx)
    vals, ids = [], []
    for s, (part, luts_s) in enumerate(zip(sh.parts, reps)):
        lo, hi = sh.starts[s], sh.starts[s + 1]
        v, i = pq_adc_topk_batch(part, luts_s, min(top_n, n_loc),
                                 mask=mask[:, lo:hi].to(part.device))
        vals.append(v)
        ids.append(i + lo)
    return _merge(vals, ids, min(top_n, n_loc * len(sh.parts)),
                  ctx.mesh.first_device)


def sharded_adc_topn_bucket(codes, rows: np.ndarray, luts: Replicated,
                            mask: np.ndarray, top_n: int, ctx: ShardCtx
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The executor's dense window on a mesh, without a gather across
    devices: bucket position j < len(rows) holds code row ``rows[j]``
    (ascending), the positions after it padding; mask (B, bucket) bool
    per-query membership; luts (B, M, K).  Returns (dists (B, tk), bucket
    positions (B, tk)), tk = min(top_n, bucket).

    Since ``rows`` ascends, the rows shard s owns are one run of bucket
    positions: the shard gathers that run from its own code shard, scans
    it with its own mask columns (one ``adc_scan_batch`` launch; none for
    an empty run) and offsets its positions by the run's start.  The
    finite pairs are those of the one-device scan of the gathered bucket;
    the slots after them hold +inf."""
    sh = _placed(codes, ctx, ragged=True)
    reps = replicate_to_mesh(luts, ctx)
    bounds = np.searchsorted(rows, np.asarray(sh.starts))
    vals, ids = [], []
    for s, (part, luts_s) in enumerate(zip(sh.parts, reps)):
        a, b = int(bounds[s]), int(bounds[s + 1])
        if a == b:
            continue
        dev = part.device
        cand = part.index_select(0, torch.from_numpy(
            rows[a:b] - sh.starts[s]).to(dev))
        m = torch.from_numpy(np.ascontiguousarray(mask[:, a:b])).to(dev)
        v, i = pq_adc_topk_batch(cand, luts_s, min(top_n, b - a), mask=m)
        vals.append(v)
        ids.append(i + a)
    out = ctx.mesh.first_device
    if not vals:
        vals = [torch.empty(len(mask), 0, device=out)]
        ids = [torch.empty(len(mask), 0, dtype=torch.int64, device=out)]
    return _merge(vals, ids, min(top_n, mask.shape[1]), out)


def shard_row_lists(rows: np.ndarray, starts: Sequence[int]
                    ) -> List[np.ndarray]:
    """Each shard's candidate lists from rows (B, S) of GLOBAL row ids
    (-1 = pad, ascending per query): shard s's rows in
    ``[starts[s], starts[s + 1])`` as LOCAL ids, in their order, leading
    the -1 pads (``adc_fused_topk`` deals chunks on that promise), in
    (B, max(64, pow2(longest))) int32."""
    b = rows.shape[0]
    out = []
    for s in range(len(starts) - 1):
        lo, hi = starts[s], starts[s + 1]
        mine = (rows >= lo) & (rows < hi)
        longest = int(mine.sum(1).max(initial=0))
        width = max(64, 1 << max(0, longest - 1).bit_length())
        lst = np.full((b, width), -1, np.int32)
        col = np.cumsum(mine, axis=1) - 1
        qi = np.broadcast_to(np.arange(b)[:, None], rows.shape)
        lst[qi[mine], col[mine]] = rows[mine] - lo
        out.append(lst)
    return out


def sharded_adc_topn_rows(codes, queries: Replicated,
                          codebooks: Replicated, rows: torch.Tensor,
                          top_n: int, ctx: ShardCtx = LOCAL_CTX, *,
                          lut_int8: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused form (``fused=`` plan knob): LUT build + ADC scan + partial
    top-k over per-query candidate ROW LISTS rows (B, S) int32 of GLOBAL
    row ids (-1 = pad, ascending per query) -> (dists (B, tk), global row
    ids (B, tk)), tk = min(top_n, S); empty slots come back as (+inf, -1).

    On a mesh each shard's lists are built on the host
    (:func:`shard_row_lists`) and scanned by one ``adc_fused_topk``
    launch on its device, its top min(top_n, its list width); the
    placement may be ragged (the executor's)."""
    if ctx.mesh is None:
        return pq_adc_fused_topk(codes, queries, codebooks, rows, top_n,
                                 lut_int8=lut_int8)
    sh = _placed(codes, ctx, ragged=True)
    rows_np = rows.cpu().numpy()
    q_reps = replicate_to_mesh(queries, ctx)
    cb_reps = replicate_to_mesh(codebooks, ctx)
    lists = shard_row_lists(rows_np, sh.starts)
    vals, ids = [], []
    for s, part in enumerate(sh.parts):
        lst = torch.from_numpy(lists[s]).to(part.device)
        v, lid = pq_adc_fused_topk(part, q_reps[s], cb_reps[s], lst,
                                   min(top_n, lst.shape[1]),
                                   lut_int8=lut_int8)
        vals.append(v)
        ids.append(torch.where(lid >= 0, lid + sh.starts[s], lid))
    return _merge(vals, ids, min(top_n, rows_np.shape[1]),
                  ctx.mesh.first_device)


def to_host(*tensors: torch.Tensor
            ) -> Tuple[Tuple[torch.Tensor, ...], Optional[torch.cuda.Event]]:
    """Start copying a window's device outputs into pinned host memory
    without blocking, and return the host tensors with a CUDA event that
    completes when they have landed (None for CPU tensors, which are
    already on the host).  On a mesh the outputs are the merge's, on the
    mesh's first device: the event is recorded there after the merge, and
    the copies of the shards' pairs to that device ordered its stream
    after theirs."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return tensors, None
    out = []
    with torch.cuda.device(dev):
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            out.append(h)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(dev))
    return tuple(out), ready


def window_scan_ready(ready: Optional[torch.cuda.Event]) -> bool:
    """True when a window's scan outputs have landed on the host.  Used by
    the futures layer for non-blocking progress (``BatchTicket.poll``)."""
    return ready is None or ready.query()
