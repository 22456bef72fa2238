"""Synthetic data (host-side numpy; deterministic by seed).

``lm_batch`` draws the LM trainer's token batches.

``clustered_vectors`` draws from a Gaussian mixture so IVF clustering and
the paper's "re-rank candidates are spatially close" locality claim (§4.3)
are actually exercised rather than vacuous, as they would be on iid
uniform data.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def lm_batch(rng: np.random.Generator, batch: int, seq: int,
             vocab: int) -> Dict[str, np.ndarray]:
    """Uniform token ids: ``tokens`` (batch, seq) int32 and ``labels``,
    the same rows shifted by one (the reference's draw, number for
    number)."""
    tokens = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int32)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def clustered_vectors(rng: np.random.Generator, n: int, dim: int,
                      n_clusters: Optional[int] = None,
                      spread: float = 0.15,
                      dtype=np.float32,
                      chunk: Optional[int] = None) -> np.ndarray:
    """``chunk=None`` draws exactly the JAX package's stream (so both
    packages index the same data).  ``chunk=c`` draws ``c`` rows at a
    time in float32, so a 10M x 128 set never makes the 10 GB float64
    temporary of the one-shot draw; it is a different stream of the same
    mixture."""
    n_clusters = n_clusters or max(8, n // 500)
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32)
    if chunk is None:
        assign = rng.integers(0, n_clusters, n)
        x = centers[assign] + spread * rng.standard_normal(
            (n, dim)).astype(np.float32)
        return _to_dtype(x, dtype)
    out = np.empty((n, dim), dtype)
    for s in range(0, n, chunk):
        c = min(chunk, n - s)
        assign = rng.integers(0, n_clusters, c)
        x = centers[assign] + np.float32(spread) * rng.standard_normal(
            (c, dim), dtype=np.float32)
        out[s:s + c] = _to_dtype(x, dtype)
    return out


def _to_dtype(x: np.ndarray, dtype) -> np.ndarray:
    if np.issubdtype(dtype, np.integer):
        lo = np.iinfo(dtype).min
        hi = np.iinfo(dtype).max
        x = np.clip(np.round(128 * x), lo, hi)
    return x.astype(dtype)
