"""Plain PyTorch versions of the flash-attention kernels, GQA-aware.

* :func:`flash_attn_ref`: the forward (``csrc/flash_attn_fwd_wgmma.cu``,
  ``csrc/flash_attn_fwd_tf32.cu``): einsum, mask, softmax, einsum; with
  ``return_lse`` also each row's logsumexp, as the kernels write it.
* :func:`flash_attn_bwd_ref`: the backward (``csrc/flash_attn_bwd.cu``),
  the port of the reference's ``_flash_bwd``
  (``repro/models/layers.py``): D = rowsum(dO * O), then per KV block P =
  exp(s - lse), dV, dP, dS = P (dP - D), dQ and dK, in f32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

_NEG_INF = -1e30  # the reference's finite mask value


def flash_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, scale: Optional[float] = None,
                   return_lse: bool = False):
    """q (B, S, H, dh), k (B, T, Hk, dh), v (B, T, Hk, dv) -> (B, S, H,
    dv) in q's dtype; computed in f32, query head h reads KV head h // (H
    / Hk); causal keeps key t for query s where s >= t (aligned at the top
    left).  With ``return_lse``, (out, lse): lse (B, H, S) f32, the
    natural-log logsumexp of each row's scaled scores."""
    b, s, h, dh = q.shape
    t, hk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qf = q.float().reshape(b, s, hk, h // hk, dh) * scale
    sc = torch.einsum("bskgd,btkd->bkgst", qf, k.float())
    if causal:
        mask = (torch.arange(s, device=q.device)[:, None]
                >= torch.arange(t, device=q.device)[None, :])
        sc = torch.where(mask, sc, _NEG_INF)
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    out = o.reshape(b, s, h, v.shape[-1]).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(sc, dim=-1).reshape(b, h, s)


def flash_attn_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       out: torch.Tensor, lse: torch.Tensor,
                       dout: torch.Tensor, *, causal: bool = True,
                       scale: Optional[float] = None, q_offset: int = 0,
                       block_size: int = 512,
                       compute: torch.dtype = torch.float32):
    """The attention VJP from the forward's residuals: q (B, S, H, dh), k
    (B, T, Hk, dh), v (B, T, Hk, dv), dv <= dh, out and dout (B, S, H,
    dv), lse (B, H, S) or the reference's (B, Hk, G, S) f32 (the same
    memory, h = kh * G + g) -> (dq, dk, dv), each in its input's dtype,
    computed in ``compute`` (f32, the reference's) a KV block of
    ``min(block_size, T)`` keys at a time (T a multiple of it), queries at
    global positions ``q_offset + s``.  Scores are recomputed from
    ``lse``: nothing of size S x T outlives a block.  ``compute=
    torch.float64`` evaluates the same function almost exactly: the
    yardstick of a kernel whose f32 sums run in another order than this
    version's (each f32 order is off the exact gradient by its own
    rounding)."""
    B, S, H, dh = q.shape
    T, Hk = k.shape[1], k.shape[2]
    dhv = v.shape[-1]
    G = H // Hk
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    bs = min(block_size, T)
    n_blocks = T // bs
    if n_blocks * bs != T:
        raise ValueError(f"T={T} not divisible by block {bs}")
    dev = q.device
    lse = lse.to(compute).reshape(B, Hk, G, S)
    qf = q.to(compute).reshape(B, S, Hk, G, dh)
    do = dout.to(compute).reshape(B, S, Hk, G, dhv)
    of = out.to(compute).reshape(B, S, Hk, G, dhv)
    delta = torch.sum(do * of, dim=-1).permute(0, 2, 3, 1)     # (B,Hk,G,S)
    kf, vf = k.to(compute), v.to(compute)
    q_pos = q_offset + torch.arange(S, device=dev)
    dq = torch.zeros((B, S, Hk, G, dh), dtype=compute, device=dev)
    dk_blocks, dv_blocks = [], []
    for blk in range(n_blocks):
        kblk = kf[:, blk * bs:(blk + 1) * bs]
        vblk = vf[:, blk * bs:(blk + 1) * bs]
        s = scale * torch.einsum("bskgd,btkd->bkgst", qf, kblk)
        if causal:
            k_pos = blk * bs + torch.arange(bs, device=dev)
            mask = q_pos[:, None] >= k_pos[None, :]
            s = torch.where(mask, s, _NEG_INF)
        p = torch.exp(s - lse[..., None])                      # (B,Hk,G,S,bs)
        dv_blocks.append(torch.einsum("bkgst,bskgd->btkd", p, do))
        dp = torch.einsum("bskgd,btkd->bkgst", do, vblk)
        ds = p * (dp - delta[..., None])
        dq = dq + scale * torch.einsum("bkgst,btkd->bskgd", ds, kblk)
        dk_blocks.append(scale * torch.einsum("bkgst,bskgd->btkd", ds, qf))
    dk = torch.cat(dk_blocks, dim=1)
    dvv = torch.cat(dv_blocks, dim=1)
    return (dq.reshape(B, S, H, dh).to(q.dtype), dk.to(k.dtype),
            dvv.to(v.dtype))
