"""Plain PyTorch version of the flash-attention forward kernel
(``csrc/flash_attn_fwd_wgmma.cu``, ``csrc/flash_attn_fwd_tf32.cu``),
GQA-aware: einsum, mask, softmax, einsum."""

from __future__ import annotations

import math
from typing import Optional

import torch


def flash_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, scale: Optional[float] = None
                   ) -> torch.Tensor:
    """q (B, S, H, dh), k (B, T, Hk, dh), v (B, T, Hk, dv) -> (B, S, H,
    dv) in q's dtype; computed in f32, query head h reads KV head h // (H
    / Hk); causal keeps key t for query s where s >= t (aligned at the top
    left)."""
    b, s, h, dh = q.shape
    t, hk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qf = q.float().reshape(b, s, hk, h // hk, dh) * scale
    sc = torch.einsum("bskgd,btkd->bkgst", qf, k.float())
    if causal:
        mask = (torch.arange(s, device=q.device)[:, None]
                >= torch.arange(t, device=q.device)[None, :])
        sc = torch.where(mask, sc, -1e30)
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return o.reshape(b, s, h, v.shape[-1]).to(q.dtype)
