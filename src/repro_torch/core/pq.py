"""Product quantisation (paper §2.2): codebook training (k-means per
sub-space, vectorised over sub-spaces), encoding, and the ADC distance
tables of Eq. (1).

Both training and encoding walk the rows in chunks: the JAX package's
one-hot (M, N, K) assignment and (M, N, K) distance array would take
hundreds of GB at N = 10M.  Training accumulates per-centroid sums with
``index_add_`` in f64: on the card it adds in no fixed order, and f32
sums of SIFT's integers pass 2^24 at 10M rows, so f32 sums would round
differently from run to run and so would the codebook.  The initial centroids come from a ``torch.Generator``,
so a port-built codebook differs from the JAX package's (which draws with
``jax.random``); ``encode`` of a given codebook is the same function.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.clustering import full_f32
from repro_torch.kernels.pq_adc.ref import build_luts_ref

# rows per chunk: the (M, chunk, K) f32 distance block stays ~2 GB at
# M = 32, K = 256
_CHUNK = 65536


@dataclasses.dataclass(frozen=True)
class PQCodebook:
    """codebooks: (M, K, dsub) — M sub-spaces, K=2^nbits centroids each."""

    codebooks: torch.Tensor

    @property
    def m(self) -> int:
        return self.codebooks.shape[0]

    @property
    def k(self) -> int:
        return self.codebooks.shape[1]

    @property
    def dsub(self) -> int:
        return self.codebooks.shape[2]


def _split_subspaces(x: torch.Tensor, m: int) -> torch.Tensor:
    n, d = x.shape
    if d % m:
        raise ValueError(f"dim {d} not divisible by M={m}")
    return x.reshape(n, m, d // m).transpose(0, 1)             # (M, N, dsub)


def _rows(data, s: int, e: int, device: torch.device) -> torch.Tensor:
    """Rows ``[s, e)`` of host or device ``data`` as f32 on ``device``."""
    blk = data[s:e]
    if isinstance(blk, np.ndarray):
        blk = torch.from_numpy(np.ascontiguousarray(blk))
    return blk.to(device=device, dtype=torch.float32)


def _assign(sub: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(M, n, dsub) x (M, K, dsub) -> (M, n) nearest centroid, ties to the
    lowest index (as ``jnp.argmin``); the products in full f32."""
    with full_f32:
        prod = torch.bmm(sub, centers.transpose(1, 2))
    d2 = ((sub ** 2).sum(-1)[:, :, None] - 2.0 * prod
          + (centers ** 2).sum(-1)[:, None, :])
    return torch.argmin(d2, dim=-1)


def train_codebooks(gen: torch.Generator, data, m: int, nbits: int = 8,
                    iters: int = 12, *, device: torch.device
                    ) -> PQCodebook:
    """Vectorised per-sub-space k-means (Lloyd) from a random sample of
    rows.  ``data`` is (N, D), numpy or torch; ``gen`` is a CPU
    generator."""
    k = 2 ** nbits
    n, d = data.shape
    dsub = d // m
    init = (torch.randperm(n, generator=gen)[:k] if n >= k
            else torch.randint(n, (k,), generator=gen))
    pick = (data[init.numpy()] if isinstance(data, np.ndarray)
            else data[init.to(data.device)])
    centers = _split_subspaces(torch.as_tensor(pick).to(
        device=device, dtype=torch.float32), m).contiguous()  # (M, K, dsub)
    offs = (torch.arange(m, device=device) * k)[:, None]
    for _ in range(iters):
        sums = torch.zeros(m * k, dsub, dtype=torch.float64, device=device)
        cnts = torch.zeros(m * k, dtype=torch.float64, device=device)
        for s in range(0, n, _CHUNK):
            sub = _split_subspaces(_rows(data, s, s + _CHUNK, device), m)
            flat = (_assign(sub, centers) + offs).reshape(-1)
            sums.index_add_(0, flat, sub.reshape(-1, dsub).double())
            cnts.index_add_(0, flat, torch.ones_like(flat, dtype=sums.dtype))
        sums = sums.reshape(m, k, dsub)
        cnts = cnts.reshape(m, k, 1)
        centers = torch.where(cnts > 0, (sums / cnts.clamp_min(1.0)).float(),
                              centers)
    return PQCodebook(codebooks=centers)


def encode(cb: PQCodebook, data) -> torch.Tensor:
    """-> PQ codes (N, M) uint8 (nbits=8) on the codebook's device."""
    device = cb.codebooks.device
    n = data.shape[0]
    out = torch.empty(n, cb.m, dtype=torch.uint8, device=device)
    for s in range(0, n, _CHUNK):
        sub = _split_subspaces(_rows(data, s, s + _CHUNK, device), cb.m)
        out[s:s + sub.shape[1]] = _assign(sub, cb.codebooks).T.to(
            torch.uint8)
    return out


def decode(cb: PQCodebook, codes: torch.Tensor) -> torch.Tensor:
    """Approximate reconstruction (tests)."""
    n, m = codes.shape
    rows = torch.gather(cb.codebooks, 1, codes.T.long()[:, :, None].expand(
        m, n, cb.dsub))
    return rows.transpose(0, 1).reshape(n, -1)


def adc_lut(cb: PQCodebook, query: torch.Tensor) -> torch.Tensor:
    """Distance lookup table for one query: (M, K) squared-L2 per
    sub-space, ``Σ (c - q)²`` as the JAX package's ``pq.adc_lut``."""
    qs = query.float().reshape(cb.m, 1, cb.dsub)
    return ((cb.codebooks - qs) ** 2).sum(-1)


def adc_lut_batch(cb: PQCodebook, queries: torch.Tensor) -> torch.Tensor:
    """(B, D) -> (B, M, K) ADC distance tables (paper step 1)."""
    return build_luts_ref(cb.codebooks, queries)
