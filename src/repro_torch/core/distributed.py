"""Executor stage ⑤ on one device: the ADC scan of a window and its
per-query top-n, and the copy of the (dist, id) pairs back to the host.

These are the single-device branches of the JAX package's
``sharded_adc_topn_window`` / ``sharded_adc_topn_rows``; row-sharding the
codes over several GPUs (``torch.distributed``) is a later slice.  Only
(dist, id) pairs leave the device — the paper's ID-only discipline (§4.2).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.pq_adc.ops import (pq_adc_fused_topk,
                                            pq_adc_topk_batch)


def sharded_adc_topn_window(codes: torch.Tensor, luts: torch.Tensor,
                            mask: torch.Tensor, top_n: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate-bucket scan with per-query membership: codes (N, M)
    uint8, luts (B, M, K) f32, mask (B, N) bool (True where row N is one
    of query B's candidates) -> (dists (B, tk), bucket positions (B, tk)),
    tk = min(top_n, N).  Masked-out slots surface as +inf."""
    return pq_adc_topk_batch(codes, luts, top_n, mask=mask)


def sharded_adc_topn_rows(codes: torch.Tensor, queries: torch.Tensor,
                          codebooks: torch.Tensor, rows: torch.Tensor,
                          top_n: int, *, lut_int8: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused form (``fused=`` plan knob): LUT build + ADC scan + partial
    top-k over per-query candidate ROW LISTS rows (B, S) int32 (-1 = pad,
    ascending per query) -> (dists (B, tk), row ids (B, tk)),
    tk = min(top_n, S); empty slots come back as (+inf, -1)."""
    return pq_adc_fused_topk(codes, queries, codebooks, rows, top_n,
                             lut_int8=lut_int8)


def to_host(*tensors: torch.Tensor
            ) -> Tuple[Tuple[torch.Tensor, ...], Optional[torch.cuda.Event]]:
    """Start copying a window's device outputs into pinned host memory
    without blocking, and return the host tensors with a CUDA event that
    completes when they have landed (None for CPU tensors, which are
    already on the host)."""
    if tensors[0].device.type == "cpu":
        return tensors, None
    out = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        out.append(h)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(tensors[0].device))
    return tuple(out), ready


def window_scan_ready(ready: Optional[torch.cuda.Event]) -> bool:
    """True when a window's scan outputs have landed on the host.  Used by
    the futures layer for non-blocking progress (``BatchTicket.poll``)."""
    return ready is None or ready.query()
