"""Plain PyTorch version of the exact-L2 kernel (``csrc/l2dist.cu``)."""

from __future__ import annotations

import torch


def l2dist_ref(queries: torch.Tensor, vectors: torch.Tensor) -> torch.Tensor:
    """queries (B, D), vectors (N, D), f32 or bf16 -> squared L2 (B, N)
    f32, as ``(|q|^2 - 2 q.v) + |v|^2`` in f32."""
    q = queries.float()
    v = vectors.float()
    return ((q * q).sum(-1)[:, None] - 2.0 * (q @ v.T)
            + (v * v).sum(-1)[None, :])
