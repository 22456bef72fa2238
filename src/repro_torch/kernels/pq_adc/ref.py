"""Plain PyTorch versions of the PQ ADC stages (Eq. 1).

These state the kernels' arithmetic, operation for operation, and are
what runs for CPU tensors:

* a LUT entry is ``Σ_j (c_j - q_j)²`` over the sub-vector, the first
  square rounded on its own and every later term fused into the running
  sum with one rounding (``fma``) — what XLA:CPU compiles the JAX
  package's jitted ``jnp.sum((cb - q) ** 2, -1)`` to;
* an ADC distance is ``Σ_m lut[m, code_m]`` added in order m = 0, 1, ...
  from 0.0, one rounding per add.

The CUDA kernels in ``csrc/`` do the same operations in the same order
(compiled with ``-fmad=false``, fused steps written as ``__fmaf_rn``), so
for the same inputs they give the same bits.
"""

from __future__ import annotations

import torch


def fma_f32(a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` with ONE rounding, as a hardware FMA.

    The product of two float32 values is exact in float64; the float64
    sum is rounded to odd (its last bit set when inexact), which makes the
    final rounding to float32 correct."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    t = s - p
    err = (p - (s - t)) + (cd - t)              # exact error of s (TwoSum)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def build_luts_ref(codebooks: torch.Tensor,
                   queries: torch.Tensor) -> torch.Tensor:
    """ADC distance tables, batched: codebooks (M, K, dsub), queries
    (B, M*dsub) -> (B, M, K) squared-L2 per sub-space (Eq. 1's table)."""
    b = queries.shape[0]
    m, k, dsub = codebooks.shape
    qs = queries.float().reshape(b, m, 1, dsub)
    acc = None
    for j in range(dsub):
        d = codebooks[None, :, :, j] - qs[..., j]              # (B, M, K)
        acc = d * d if acc is None else fma_f32(d, d, acc)
    return acc


def pq_adc_ref(codes: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """One query: codes (N, M) uint8, lut (M, K) f32 -> (N,) f32."""
    return pq_adc_batch_ref(codes, lut[None])[0]


def pq_adc_batch_ref(codes: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """codes (N, M) uint8, luts (B, M, K) f32 -> (B, N) f32."""
    b, m, _ = luts.shape
    d = torch.zeros(b, codes.shape[0], dtype=torch.float32,
                    device=luts.device)
    for mm in range(m):
        d = d + luts[:, mm, :][:, codes[:, mm].long()]
    return d


def pq_adc_rows_ref(codes: torch.Tensor, luts: torch.Tensor,
                    rows: torch.Tensor) -> torch.Tensor:
    """Segmented per-query scan: codes (N, M) uint8, luts (B, M, K) f32,
    rows (B, S) int32 row ids into ``codes`` (-1 = pad) -> distances
    (B, S) f32 with +inf at pad slots.  Each query scans only ITS
    candidate rows (the paper's per-query candidate-list formulation)."""
    b, m, _ = luts.shape
    crow = codes[rows.clamp_min(0).long()].long()             # (B, S, M)
    d = torch.zeros(rows.shape, dtype=torch.float32, device=luts.device)
    for mm in range(m):
        d = d + torch.gather(luts[:, mm, :], 1, crow[:, :, mm])
    return d.masked_fill(rows < 0, torch.inf)
