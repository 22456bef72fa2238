"""Wrappers of the ADC kernels, their plain versions, and the top-k glue.

Four kernels, written in CUDA C++ for ``sm_90a`` (``csrc/``):

* ``adc_scan`` (:func:`pq_adc`) — one query's distances, the port of the
  Pallas ``pq_adc_scan``; plain version ``ref.pq_adc_ref``.
* ``adc_scan_topk`` (:func:`pq_adc_topk`) — one query's scan with a
  running top-k in each block of a persistent grid (:func:`topk_plan`),
  the port of the Pallas ``pq_adc_scan_topk``; plain version
  :func:`pq_adc_topk_plain`.
* ``adc_scan_batch`` (:func:`pq_adc_batch`) — the dense batch scan, the
  port of the Pallas ``pq_adc_scan_batch``; plain version
  ``ref.pq_adc_batch_ref``.
* ``adc_fused_topk`` (:func:`pq_adc_fused_topk`) — LUT build, ADC scan of
  each query's candidate rows and its top-k in one launch, one thread
  block cluster a query (:func:`fused_plan`) merging its CTAs' lists
  through distributed shared memory, f32 or int8 LUT, the port of the
  Pallas ``pq_adc_scan_fused`` and of its merge; plain version
  :func:`pq_adc_fused_topk_plain`.  Where a large top-k over a long
  window does not fit that plan, its spill route (:func:`fused_route`,
  counted as ``adc_fused_topk[spill]``): one launch too, a cluster a
  query selecting the query's best keys across its CTAs (a radix select
  over histograms summed through distributed shared memory), each CTA
  sorting only its share of them, no global scratch.

A wrapper runs the plain version when its tensors lie on the CPU.  On a
CUDA tensor it launches the kernel, or raises: it checks device, dtype,
shape and contiguity first, and the ``cudaError_t`` the launch returns
after.  It allocates the outputs with ``torch.empty`` and launches on the
current stream without synchronising.  Each launch adds one to
``LAUNCHES[<kernel name>]`` (``repro_torch.kernels.launch``).

Top-k selection everywhere is a stable ascending sort, so equal distances
keep the lower position — the lower row — as ``lax.top_k`` does in the JAX
package (DESIGN.md §2).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.launch import (LAUNCHES,  # noqa: F401
                                        check, launch, reset_launches)
from repro_torch.kernels.pq_adc.ref import (build_luts_ref, fma_f32,
                                            pq_adc_batch_ref, pq_adc_ref,
                                            pq_adc_rows_ref)

_SMEM_MAX = 232448              # bytes of shared memory a block may use
_MAX_QUERIES_PER_BLOCK = 8      # adc_scan_batch.cu: kMaxQ
_DENSE_ROWS = 128               # adc_scan_batch.cu: rows a block's pass takes
_DENSE_PAD = 4                  # adc_scan_batch.cu: floats after each LUT
_BARRIER_BYTES = 16             # adc_scan_batch.cu: its static mbarrier
_FUSED_TILE = 1024              # adc_fused_topk.cu: kTile, slots a tile
_FUSED_MAX_CLUSTER = 8          # adc_fused_topk.cu: kMaxCluster
_FUSED_MAX_CAP = 4096           # adc_fused_topk.cu: kMaxCap, keys a CTA
_FUSED_MIN_SLOTS = 64           # fewest slots a CTA of a cluster > 1 takes
_FUSED_STATIC_SMEM = 2048       # adc_fused_topk.cu: room for its static Shared
_SPILL_MAX_CAP = 16384          # adc_fused_topk.cu: kSpillMaxCap
_SPILL_MIN_CAP = 2048           # the least buffer that leaves a round keys
_SPILL_HIST_BYTES = 3 * 256 * 4  # adc_fused_topk.cu: kHistWords
_TOPK_ROUND = 2048              # adc_scan_topk.cu: kRound, rows a round
_TOPK_MAX_TK = 2048             # adc_scan_topk.cu: kMaxTk, keys a block keeps
_TOPK_BUF = 4096                # adc_scan_topk.cu: kBuf, candidate slots
_TOPK_BLOCKS_PER_SM = 2         # adc_scan_topk.cu: __launch_bounds__
_INV255 = 1.0 / 255.0           # rounds to the float32 XLA folds `/ 255.0`


def _vec16(codes: torch.Tensor) -> int:
    return int(codes.shape[1] % 16 == 0 and codes.data_ptr() % 16 == 0)


def load_width(m: int, address: int) -> int:
    """The widest load, in bytes (16, 8, 4, 2 or 1), that reads every
    code row of M bytes from a table at ``address`` whole and aligned."""
    return next(w for w in (16, 8, 4, 2, 1)
                if m % w == 0 and address % w == 0)


def _check_lut(codes: torch.Tensor, lut: torch.Tensor) -> Tuple[int, int, int]:
    dev = codes.device
    check("codes", codes, torch.uint8, 2, dev)
    check("lut", lut, torch.float32, 2, dev)
    n, m = codes.shape
    lm, k = lut.shape
    if lm != m or k > 256 or m * k * 4 > _SMEM_MAX:
        raise ValueError(f"lut {tuple(lut.shape)} does not fit codes "
                         f"{tuple(codes.shape)} (K <= 256, M*K*4 bytes of "
                         f"shared memory)")
    return n, m, k


# ------------------------------------------------------------ single query
def pq_adc(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """codes (N, M) uint8, lut (M, K) f32 -> distances (N,) f32."""
    if codes.device.type == "cpu":
        return pq_adc_ref(codes, lut)
    n, m, k = _check_lut(codes, lut)
    out = torch.empty(n, dtype=torch.float32, device=codes.device)
    if n:
        launch("adc_scan", codes.device, codes.data_ptr(), lut.data_ptr(),
               out.data_ptr(), n, m, k, _vec16(codes))
    return out


def pq_adc_topk_plain(codes: torch.Tensor, lut: torch.Tensor, topk: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`pq_adc_topk`."""
    d = pq_adc_ref(codes, lut)
    tk = min(topk, d.shape[0])
    vals, pos = torch.sort(d, stable=True)
    return vals[:tk], pos[:tk].to(torch.int32)


class TopkPlan(NamedTuple):
    """Launch shape of ``adc_scan_topk``: ``grid`` blocks, block i owning
    rows ``[i * rows, (i + 1) * rows)`` (the last block fewer), each
    keeping its best ``tk``."""
    grid: int
    rows: int
    tk: int


def topk_plan(n: int, topk: int, sms: int) -> TopkPlan:
    """The persistent grid of ``adc_scan_topk`` for one query's top-k of
    N rows on a card of ``sms`` SMs.

    Two blocks an SM split the rows into contiguous ranges, ascending
    from block to block (at least one round of 2,048 rows a block).  A
    block keeps tk = min(topk, rows) keys, at most 2,048, and appends up
    to one round of candidates behind them in its 4,096 slots.  A topk
    above 2,048 cuts the ranges to 2,048 rows, each block's every row
    kept: more blocks, not a wave, the same result."""
    grid = max(1, min(sms * _TOPK_BLOCKS_PER_SM, -(-n // _TOPK_ROUND)))
    rows = -(-n // grid)
    if min(topk, rows) > _TOPK_MAX_TK:
        rows = _TOPK_MAX_TK
    grid = -(-n // rows)
    return TopkPlan(grid, rows, min(topk, rows))


def pq_adc_topk(codes: torch.Tensor, lut: torch.Tensor, topk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One query's scan + top-k: codes (N, M) uint8, lut (M, K) f32 ->
    (dists (tk,) f32, row ids (tk,) int32) ascending, tk = min(topk, N) —
    real rows only, equal distances in ascending row order.

    Each block of the kernel's grid (:func:`topk_plan`) scans one
    contiguous range of rows and keeps its best ``plan.tk`` (dist, row)
    pairs, sorted; the blocks, in ascending row order, are merged here by
    a stable sort of ``grid * tk`` pairs, so the result is the
    (dist, row) order of all N rows."""
    if codes.device.type == "cpu":
        return pq_adc_topk_plain(codes, lut, topk)
    n, m, k = _check_lut(codes, lut)
    dev = codes.device
    tk_out = min(topk, n)
    if tk_out <= 0:
        return (torch.empty(0, dtype=torch.float32, device=dev),
                torch.empty(0, dtype=torch.int32, device=dev))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = topk_plan(n, topk, sms)
    if m * k * 4 + _TOPK_BUF * 8 > _SMEM_MAX:
        raise ValueError(f"M={m}, K={k} leaves no shared memory for the "
                         f"top-k keys")
    vals = torch.empty(plan.grid * plan.tk, dtype=torch.float32, device=dev)
    ids = torch.empty(plan.grid * plan.tk, dtype=torch.int32, device=dev)
    launch("adc_scan_topk", dev, codes.data_ptr(), lut.data_ptr(),
           vals.data_ptr(), ids.data_ptr(), n, m, k, *plan, _vec16(codes))
    merged, pos = torch.sort(vals, stable=True)
    return merged[:tk_out], ids[pos[:tk_out]]


# --------------------------------------------------------------- dense scan
class DensePlan(NamedTuple):
    """Launch shape of ``adc_scan_batch``: the queries split into ``tiles``
    tiles of ``q_max`` or ``q_max - 1`` queries (tile t holds queries
    ``b*t//tiles .. b*(t+1)//tiles``); ``grid_y`` blocks walk the tiles,
    ``grid_x`` blocks stride over the rows of each, 128 rows a pass of a
    block (1,024 threads, eight on a row)."""
    tiles: int
    q_max: int
    grid_x: int
    grid_y: int


def dense_plan(b: int, n: int, m: int, k: int, sms: int) -> DensePlan:
    """The one-wave grid of ``adc_scan_batch`` for B queries over N rows of
    M codes into K-entry LUTs on a card of ``sms`` SMs.

    A block's LUT tile (``q_max`` LUTs of (M*K + 4)*4 bytes) takes most of
    an SM's shared memory, so one block resides on an SM and the grid
    holds at most ``sms`` blocks: ``grid_y`` = min(tiles, sms) of them walk
    the tiles and ``grid_x`` <= sms // grid_y stride over the rows, at
    least one pass of rows each.  Tiles are as few as the shared memory
    allows and differ by at most one query (6 or 7 at B = 64, M = 32,
    K = 256)."""
    lut_bytes = (m * k + _DENSE_PAD) * 4
    fit = min(_MAX_QUERIES_PER_BLOCK,
              (_SMEM_MAX - _BARRIER_BYTES) // lut_bytes)
    if fit < 1:
        raise ValueError(f"one LUT of M={m}, K={k} exceeds shared memory")
    tiles = -(-b // fit)
    grid_y = min(tiles, sms)
    grid_x = max(1, min(sms // grid_y, -(-n // _DENSE_ROWS)))
    return DensePlan(tiles, -(-b // tiles), grid_x, grid_y)


def pq_adc_batch(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """codes (N, M) uint8, luts (B, M, K) f32 -> distances (B, N) f32."""
    if codes.device.type == "cpu":
        return pq_adc_batch_ref(codes, luts)
    dev = codes.device
    check("codes", codes, torch.uint8, 2, dev)
    check("luts", luts, torch.float32, 3, dev)
    n, m = codes.shape
    b, lm, k = luts.shape
    if lm != m or k > 256:
        raise ValueError(f"luts {tuple(luts.shape)} do not fit codes "
                         f"{tuple(codes.shape)} (K <= 256)")
    out = torch.empty(b, n, dtype=torch.float32, device=dev)
    if n == 0 or b == 0:
        return out
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = dense_plan(b, n, m, k, sms)
    launch("adc_scan_batch", dev, codes.data_ptr(), luts.data_ptr(),
           out.data_ptr(), n, m, k, b, plan.tiles, plan.grid_x, plan.grid_y,
           _vec16(codes))
    return out


def pq_adc_topk_batch(codes: torch.Tensor, luts: torch.Tensor, topk: int, *,
                      mask: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched scan + per-query (optionally masked) top-k.

    codes (N, M) x luts (B, M, K) [x mask (B, N) bool] ->
    (dists (B, tk), row indices (B, tk)) ascending, tk = min(topk, N).
    ``mask`` is the executor's per-query candidate membership: False rows
    (other queries' candidates, padding) score +inf and sort last."""
    d = pq_adc_batch(codes, luts)
    if mask is not None:
        d = d.masked_fill(~mask, torch.inf)
    tk = min(topk, d.shape[1])
    vals, pos = torch.sort(d, dim=1, stable=True)
    return vals[:, :tk], pos[:, :tk]


# -------------------------------------------------------------- fused scan
def quantize_luts(luts: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fig10 accuracy levels: asymmetric int8 quantisation of the ADC
    tables, per (query, subquantizer).  (B, M, K) f32 ->
    (q8 (B, M, K) int8, scale (B, M) f32, zp (B, M) f32); dequant is
    ``fma(q8 + 128, scale, zp)``, accumulated in fp32."""
    lo = luts.amin(-1, keepdim=True)
    hi = luts.amax(-1, keepdim=True)
    scale = (hi - lo).clamp_min(1e-12) * torch.tensor(
        _INV255, dtype=torch.float32, device=luts.device)
    q8 = (torch.round((luts - lo) / scale) - 128.0).to(torch.int8)
    return q8, scale[..., 0], lo[..., 0]


def _rows_scan_int8(codes, q8, scale, zp, rows) -> torch.Tensor:
    """int8-LUT form of ``ref.pq_adc_rows_ref``: gather int8 entries,
    dequantise each, accumulate in fp32 (the "fp32 merge")."""
    b, m, _ = q8.shape
    crow = codes[rows.clamp_min(0).long()].long()             # (B, S, M)
    d = torch.zeros(rows.shape, dtype=torch.float32, device=q8.device)
    for mm in range(m):
        g = torch.gather(q8[:, mm, :], 1, crow[:, :, mm]).float()
        d = d + fma_f32(g + 128.0, scale[:, mm:mm + 1], zp[:, mm:mm + 1])
    return d.masked_fill(rows < 0, torch.inf)


def pq_adc_fused_topk_plain(codes: torch.Tensor, queries: torch.Tensor,
                            codebooks: torch.Tensor, rows: torch.Tensor,
                            topk: int, *, lut_int8: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`pq_adc_fused_topk`."""
    luts = build_luts_ref(codebooks, queries)
    if lut_int8:
        d = _rows_scan_int8(codes, *quantize_luts(luts), rows)
    else:
        d = pq_adc_rows_ref(codes, luts, rows)
    tk = min(topk, rows.shape[1])
    vals, pos = torch.sort(d, dim=1, stable=True)
    return vals[:, :tk], torch.gather(rows, 1, pos[:, :tk])


class FusedPlan(NamedTuple):
    """Launch shape of ``adc_fused_topk``: one thread block cluster of
    ``cluster`` CTAs a query; the query's 32-slot chunks dealt to its CTAs
    in turn (CTA r scans chunks r, r + cluster, ...), at most ``slots``
    slots a CTA; each CTA keeps its best ``keep`` = min(tk, slots) keys
    in a buffer of ``cap`` keys; ``smem`` dynamic shared-memory bytes a
    CTA (the LUT, the key buffer, and an inbox for the other CTAs' kept
    keys)."""
    cluster: int
    slots: int
    keep: int
    cap: int
    smem: int


def _pow2ceil(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def _fused_cluster(b: int, s: int, sms: int) -> int:
    """The cluster of ``adc_fused_topk``: the largest power of two up to 8
    that keeps B * cluster within two CTAs an SM and gives each CTA at
    least 64 slots."""
    c = 1
    while (2 * c <= _FUSED_MAX_CLUSTER and b * 2 * c <= 2 * sms
           and s >= 2 * c * _FUSED_MIN_SLOTS):
        c *= 2
    return c


def _fused_cap(slots: int, keep: int) -> int:
    return -(-max(32, _pow2ceil(keep), min(slots, _FUSED_MAX_CAP)) // 32) * 32


def fused_plan(b: int, s: int, tk: int, m: int, k: int,
               sms: int) -> FusedPlan:
    """The grid of ``adc_fused_topk``'s one-launch route for B queries of
    S slots each, their top tk, M x K LUTs, on a card of ``sms`` SMs.

    The cluster is the largest power of two up to 8 that keeps B *
    cluster within two CTAs an SM and gives each CTA at least 64 slots
    (B = 64 on 132 SMs: 4; B = 1: 8).  Chunks dealt in turn give each CTA
    its share of a query's valid rows, which lead its pads.  A CTA's key
    buffer holds all its slots, up to 4,096, and at least max(32,
    pow2ceil(keep)) for its sort, in multiples of 32; a CTA of more slots
    selects whenever the next tile of 1,024 might not fit, so keep must
    leave a tile's room (tk <= 3,072), or a larger cluster, up to 8, takes
    fewer slots a CTA.  Beyond that, and past the shared memory (the other
    CTAs' (cluster - 1) * keep kept keys come to each CTA), it raises:
    :func:`fused_route` then takes the spill route."""
    c = _fused_cluster(b, s, sms)
    chunks = -(-s // 32)
    while True:
        slots = -(-chunks // c) * 32
        keep = min(tk, slots)
        cap = _fused_cap(slots, keep)
        fits = cap <= _FUSED_MAX_CAP and (cap >= slots
                                          or cap >= keep + _FUSED_TILE)
        if fits or c == _FUSED_MAX_CLUSTER:
            break
        c *= 2
    smem = -(-m * k // 4) * 16 + cap * 8 + (c - 1) * keep * 8
    if not fits or smem > _SMEM_MAX - _FUSED_STATIC_SMEM:
        raise ValueError(f"adc_fused_topk takes at most {_FUSED_MAX_CAP} keys "
                         f"a CTA and {_SMEM_MAX - _FUSED_STATIC_SMEM} B of "
                         f"shared memory: S={s}, tk={tk}, M={m}, K={k} "
                         f"need {cap} and {smem}")
    return FusedPlan(c, slots, keep, cap, smem)


class FusedRoute(NamedTuple):
    """How ``adc_fused_topk`` serves a window: ``key`` is the launch key
    (``adc_fused_topk``, the one-launch route; or ``adc_fused_topk[spill]``,
    the spill route, one launch too); ``plan`` the cluster a query, each
    CTA's slots, the keys a round keeps, the key buffer and the shared
    memory."""
    key: str
    plan: FusedPlan


def fused_route(b: int, s: int, tk: int, m: int, k: int,
                sms: int) -> FusedRoute:
    """The route of ``adc_fused_topk`` for B queries of S slots each,
    their top tk, M x K LUTs, on a card of ``sms`` SMs.

    Where :func:`fused_plan` fits, its one launch, unchanged.  Elsewhere
    (a large tk over a long window: the inbox of (cluster - 1) * keep
    keys, or keep + a tile, past what a CTA holds) the spill route: the
    same cluster a query (four CTAs at B = 64 on 132 SMs), each CTA's key
    buffer a power of two, ``cap``, at most 16,384 keys and within shared
    memory beside the LUT and the select's histograms: room for all its
    slots and for twice the keys it may keep, min(tk, slots), where that
    fits.  A round keeps the query's ``keep = min(tk, cap / 2)`` best (a
    CTA's sorted share and its inbox of the others' fill at most the
    buffer); where a CTA's slots fit the buffer it holds all its valid
    keys, else the cluster selects its best keep every (cap - keep) /
    1,024 tiles; rounds of keep keys repeat the scan until tk are
    written (one round at B = 64, S = 32,768, tk = 4,096).  Raises
    ``ValueError`` only where B passes the grid's 65,535 rows or the LUT
    leaves no room for a 2,048-key buffer."""
    try:
        plan = fused_plan(b, s, tk, m, k, sms)
        return FusedRoute("adc_fused_topk", plan)
    except ValueError:
        pass
    c = _fused_cluster(b, s, sms)
    slots = -(-(-(-s // 32)) // c) * 32
    lut = -(-m * k // 4) * 16
    cap_max = _SPILL_MAX_CAP
    while cap_max >= _SPILL_MIN_CAP and (lut + cap_max * 8 + _SPILL_HIST_BYTES
                                         > _SMEM_MAX - _FUSED_STATIC_SMEM):
        cap_max //= 2
    if b > 65535 or cap_max < _SPILL_MIN_CAP:
        raise ValueError(f"adc_fused_topk takes at most 65535 queries a "
                         f"window and {_SMEM_MAX - _FUSED_STATIC_SMEM} B of "
                         f"shared memory: B={b}, M={m}, K={k} leave no room "
                         f"for {_SPILL_MIN_CAP} keys beside a {lut} B LUT")
    cap = min(cap_max, max(64, _pow2ceil(slots),
                           2 * _pow2ceil(min(tk, slots))))
    return FusedRoute("adc_fused_topk[spill]", FusedPlan(
        c, slots, min(tk, cap // 2), cap, lut + cap * 8 + _SPILL_HIST_BYTES))


def pq_adc_fused_topk(codes: torch.Tensor, queries: torch.Tensor,
                      codebooks: torch.Tensor, rows: torch.Tensor,
                      topk: int, *, lut_int8: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused query pipeline: LUT build -> ADC scan -> top-k over each
    query's OWN candidate rows, one launch per scan window, merge
    included.

    codes (N, M) uint8 (the whole HBM tier — no per-window candidate
    gather); queries (B, M*dsub) f32 with any rotation already applied;
    codebooks (M, K, dsub) f32; rows (B, S) int32 row ids, -1 = pad, each
    query's sorted ascending, pads after its rows.  Returns (dists (B, tk),
    row ids (B, tk)) ascending by (dist, slot), tk = min(topk, S); slots
    past a query's candidate count come back as (+inf, -1).  On the card
    a row >= N is a pad too.

    On the card this is one launch of ``adc_fused_topk`` on the grid of
    :func:`fused_route`: each query's cluster builds its LUT, scans its
    slots and writes the query's tk pairs itself (no sort, gather or
    scratch after it), on the one-launch route where :func:`fused_plan`
    fits, else (a large tk over a long window) on the spill route,
    counted as ``adc_fused_topk[spill]``."""
    if codes.device.type == "cpu":
        return pq_adc_fused_topk_plain(codes, queries, codebooks, rows, topk,
                                       lut_int8=lut_int8)
    dev = codes.device
    check("codes", codes, torch.uint8, 2, dev)
    check("queries", queries, torch.float32, 2, dev)
    check("codebooks", codebooks, torch.float32, 3, dev)
    check("rows", rows, torch.int32, 2, dev)
    n, m = codes.shape
    cm, k, dsub = codebooks.shape
    b, s = rows.shape
    if cm != m or k > 256 or queries.shape != (b, m * dsub):
        raise ValueError(
            f"shapes do not fit: codes {tuple(codes.shape)}, codebooks "
            f"{tuple(codebooks.shape)}, queries {tuple(queries.shape)}, "
            f"rows {tuple(rows.shape)}")
    tk_out = min(topk, s)
    if b == 0 or tk_out == 0:
        return (torch.empty(b, tk_out, dtype=torch.float32, device=dev),
                torch.empty(b, tk_out, dtype=torch.int32, device=dev))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    route = fused_route(b, s, tk_out, m, k, sms)
    plan = route.plan
    vals = torch.empty(b, tk_out, dtype=torch.float32, device=dev)
    ids = torch.empty(b, tk_out, dtype=torch.int32, device=dev)
    launch(route.key, dev, rows.data_ptr(), codes.data_ptr(),
           queries.data_ptr(), codebooks.data_ptr(), vals.data_ptr(),
           ids.data_ptr(), b, s, n, m, k, dsub, tk_out, plan.cluster,
           plan.slots, plan.keep, plan.cap, load_width(m, codes.data_ptr()),
           int(lut_int8), int(route.key != "adc_fused_topk"))
    return vals, ids
