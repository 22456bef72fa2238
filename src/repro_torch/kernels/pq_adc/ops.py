"""Wrappers of the ADC kernels, their plain versions, and the top-k glue.

Two kernels, written in CUDA C++ for ``sm_90a`` (``csrc/``):

* ``adc_scan_batch`` (:func:`pq_adc_batch`) — the dense batch scan, the
  port of the Pallas ``pq_adc_scan_batch``; plain version
  ``ref.pq_adc_batch_ref``.
* ``adc_fused_topk`` (:func:`pq_adc_fused_topk`) — LUT build, ADC scan of
  each query's candidate rows and block-local top-k in one launch, f32 or
  int8 LUT, the port of the Pallas ``pq_adc_scan_fused``; plain version
  :func:`pq_adc_fused_topk_plain`.

A wrapper runs the plain version when its tensors lie on the CPU.  On a
CUDA tensor it launches the kernel, or raises: it checks device, dtype,
shape and contiguity first, and the ``cudaError_t`` the launch returns
after.  It allocates the outputs with ``torch.empty`` and launches on the
current stream without synchronising.  Each launch adds one to
``LAUNCHES[<kernel name>]``.

Top-k selection everywhere is a stable ascending sort, so equal distances
keep the lower position — the lower row — as ``lax.top_k`` does in the JAX
package (DESIGN.md §2).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels.pq_adc.build import load
from repro_torch.kernels.pq_adc.ref import (build_luts_ref, fma_f32,
                                            pq_adc_batch_ref,
                                            pq_adc_rows_ref)

# kernel launches since the last reset_launches()
LAUNCHES = {"adc_scan_batch": 0, "adc_fused_topk": 0}

_SMEM_MAX = 232448              # bytes of shared memory a block may use
_MAX_QUERIES_PER_BLOCK = 8      # adc_scan_batch.cu: kMaxQ
_FUSED_BLOCK_S = 2048           # candidate slots per fused-kernel block
_INV255 = 1.0 / 255.0           # rounds to the float32 XLA folds `/ 255.0`

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "adc_scan_batch": (_P, _P, _P) + (_I,) * 7 + (_P,),
    "adc_fused_topk": (_P, _P, _P, _P, _P, _P) + (_I,) * 10 + (_P,),
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    fn = getattr(load(name), name)
    fn.argtypes = list(_SIGNATURES[name])
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(name: str, *args) -> None:
    err = _kernel(name)(*args)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    LAUNCHES[name] += 1


def _vec16(codes: torch.Tensor) -> int:
    return int(codes.shape[1] % 16 == 0 and codes.data_ptr() % 16 == 0)


# --------------------------------------------------------------- dense scan
def pq_adc_batch(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """codes (N, M) uint8, luts (B, M, K) f32 -> distances (B, N) f32."""
    if codes.device.type == "cpu":
        return pq_adc_batch_ref(codes, luts)
    dev = codes.device
    _check("codes", codes, torch.uint8, 2, dev)
    _check("luts", luts, torch.float32, 3, dev)
    n, m = codes.shape
    b, lm, k = luts.shape
    if lm != m or k > 256:
        raise ValueError(f"luts {tuple(luts.shape)} do not fit codes "
                         f"{tuple(codes.shape)} (K <= 256)")
    qb = min(_MAX_QUERIES_PER_BLOCK, b, _SMEM_MAX // (m * k * 4))
    if qb < 1:
        raise ValueError(f"one LUT of M={m}, K={k} exceeds shared memory")
    out = torch.empty(b, n, dtype=torch.float32, device=dev)
    if n == 0 or b == 0:
        return out
    # rows per block: at least two blocks per SM over the whole grid, each
    # scanning 256..8192 rows (its LUT tile fill is amortised over them)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_block = -(-n // max(1, -(-2 * sms // -(-b // qb))))
    per_block = min(8192, max(256, -(-per_block // 256) * 256))
    with torch.cuda.device(dev):
        _launch("adc_scan_batch", codes.data_ptr(), luts.data_ptr(),
                out.data_ptr(), n, m, k, b, qb, per_block, _vec16(codes),
                torch.cuda.current_stream(dev).cuda_stream)
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


def pq_adc_fused_topk(codes: torch.Tensor, queries: torch.Tensor,
                      codebooks: torch.Tensor, rows: torch.Tensor,
                      topk: int, *, lut_int8: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused query pipeline: LUT build -> ADC scan -> partial top-k
    over each query's OWN candidate rows, one launch per scan window.

    codes (N, M) uint8 (the whole HBM tier — no per-window candidate
    gather); queries (B, M*dsub) f32 with any rotation already applied;
    codebooks (M, K, dsub) f32; rows (B, S) int32 row ids, -1 = pad, each
    query's sorted ascending.  Returns (dists (B, tk), row ids (B, tk))
    ascending, tk = min(topk, S); slots past a query's candidate count
    come back as (+inf, -1)."""
    if codes.device.type == "cpu":
        return pq_adc_fused_topk_plain(codes, queries, codebooks, rows, topk,
                                       lut_int8=lut_int8)
    dev = codes.device
    _check("codes", codes, torch.uint8, 2, dev)
    _check("queries", queries, torch.float32, 2, dev)
    _check("codebooks", codebooks, torch.float32, 3, dev)
    _check("rows", rows, torch.int32, 2, dev)
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
    block_s = min(_FUSED_BLOCK_S, 1 << (s - 1).bit_length())
    smem = m * k * 4 + block_s * 8 + (m * 8 + m * k if lut_int8 else 0)
    if smem > _SMEM_MAX:
        raise ValueError(f"M={m}, K={k} needs {smem} B of shared memory")
    tk = min(topk, block_s)
    nb = -(-s // block_s)
    vals = torch.empty(b, nb * tk, dtype=torch.float32, device=dev)
    ids = torch.empty(b, nb * tk, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch("adc_fused_topk", rows.data_ptr(), codes.data_ptr(),
                queries.data_ptr(), codebooks.data_ptr(), vals.data_ptr(),
                ids.data_ptr(), b, s, n, m, k, dsub, block_s, tk,
                int(lut_int8), _vec16(codes),
                torch.cuda.current_stream(dev).cuda_stream)
    # cross-block merge: blocks are in ascending slot order and each is
    # sorted by (dist, slot), so a stable sort keeps (dist, slot) order
    merged, pos = torch.sort(vals, dim=1, stable=True)
    return merged[:, :tk_out], torch.gather(ids, 1, pos[:, :tk_out])
