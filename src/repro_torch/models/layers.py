"""Model building blocks, the serving half: the port's counterpart of the
JAX package's ``models/layers.py``.

* Norms, rotary embedding (with ChatGLM's ``fraction``), the SwiGLU FFN
  and decode attention over a KV cache are plain PyTorch, as the JAX
  functions are plain ``jnp`` (their products go to cuBLAS, as the JAX
  ones went to XLA).
* :func:`blockwise_attention` is the model's attention forward (train and
  prefill).  On CUDA tensors it launches the port's flash kernel
  (``kernels.flash_attn.flash_attention``: ``flash_attn_fwd_wgmma`` in
  bf16, ``flash_attn_fwd_tf32`` in f32), the Hopper counterpart of the
  Pallas ``flash_attention_fwd``; a shape that kernel lacks raises.  On
  CPU tensors it runs :func:`_attention_fwd_scan`, the torch port of the
  reference's online-softmax scan over KV blocks, which is the plain
  version and never runs on the card's main path.

MoE (``moe_block``) and MLA (``mla_qkv``, ``mla_decode_absorbed``) and
the flash VJP are not ported yet (ROADMAP queue 1).  :class:`ShardCtx`
and :data:`LOCAL_CTX` are ``sharding.spec``'s.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.sharding.spec import LOCAL_CTX, ShardCtx  # noqa: F401

_NEG_INF = -1e30  # finite mask value: avoids (-inf) - (-inf) = nan paths


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * w.float()).to(dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding (NeoX-half style; ``fraction`` < 1 rotates only
# the leading dims of each head — ChatGLM's "2d" RoPE uses fraction=0.5).
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, rotary_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin tables (..., rotary_dim // 2), f32."""
    half = rotary_dim // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=positions.device) / half)
    angles = positions.float()[..., None] * freq          # (..., half)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               fraction: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, dh); cos/sin: (B, S, half) or (S, half)."""
    dh = x.shape[-1]
    rotary_dim = int(dh * fraction)
    if rotary_dim % 2:
        rotary_dim -= 1
    half = rotary_dim // 2
    xr, xp = x[..., :rotary_dim], x[..., rotary_dim:]
    x1, x2 = xr[..., :half], xr[..., half:]
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    elif cos.dim() == 3:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    cos, sin = cos.float(), sin.float()
    x1f, x2f = x1.float(), x2.float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# Blockwise (flash-style) attention
# ---------------------------------------------------------------------------

def _attention_fwd_scan(q, k, v, causal: bool, q_offset: int,
                        block_size: int, scale: float):
    """The plain version: a streaming forward over KV blocks with an f32
    running (max, sumexp, acc), GQA-aware, causal at a global query
    offset.  Returns (out (B, S, H, dhv) in q's dtype, lse (B, Hk, G, S)
    f32), as the reference's scan does."""
    B, S, H, dh = q.shape
    T, Hk = k.shape[1], k.shape[2]
    dhv = v.shape[-1]
    G = H // Hk
    bs = min(block_size, T)
    n_blocks = T // bs
    assert n_blocks * bs == T, f"T={T} not divisible by block {bs}"

    dev = q.device
    qf = (q.float() * scale).reshape(B, S, Hk, G, dh)
    kf, vf = k.float(), v.float()
    q_pos = q_offset + torch.arange(S, device=dev)
    m = torch.full((B, Hk, G, S), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hk, G, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, S, Hk, G, dhv), dtype=torch.float32, device=dev)
    for blk in range(n_blocks):
        kblk = kf[:, blk * bs:(blk + 1) * bs]
        vblk = vf[:, blk * bs:(blk + 1) * bs]
        s = torch.einsum("bskgd,btkd->bkgst", qf, kblk)
        if causal:
            k_pos = blk * bs + torch.arange(bs, device=dev)
            mask = q_pos[:, None] >= k_pos[None, :]          # (S, bs)
            s = torch.where(mask, s, _NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        pv = torch.einsum("bkgst,btkd->bskgd", p, vblk)
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    lse = m + torch.log(torch.clamp(l, min=1e-30))        # (B,Hk,G,S)
    l_t = l.permute(0, 3, 1, 2)                            # (B,S,Hk,G)
    out = acc / torch.clamp(l_t, min=1e-30)[..., None]
    return out.reshape(B, S, H, dhv).to(q.dtype), lse


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, q_offset: int = 0,
                        block_size: int = 512,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,S,H,dh) k/v: (B,T,Hk,dh[v]) -> (B,S,H,dhv), in q's dtype.

    T must be a multiple of ``min(block_size, T)``, as in the reference.
    CPU tensors run the plain scan.  CUDA tensors launch
    ``kernels.flash_attn.flash_attention``, which takes ``q_offset == 0``,
    a v width equal to q's and dh <= 256; any other shape raises
    ``ValueError`` naming it (ROADMAP queue 3)."""
    dh = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    T = k.shape[1]
    bs = min(block_size, T)
    assert (T // bs) * bs == T, f"T={T} not divisible by block {bs}"
    if q.device.type == "cpu":
        return _attention_fwd_scan(q, k, v, causal, q_offset, block_size,
                                   scale)[0]
    if q_offset != 0:
        raise ValueError(f"q_offset={q_offset}: the flash kernel takes "
                         f"queries at offset 0 only")
    if v.shape[-1] != dh:
        raise ValueError(f"v width {v.shape[-1]} != q/k width {dh}: the "
                         f"flash kernel takes k and v of one shape")
    return flash_attention(q, k, v, causal=causal, scale=scale)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-step decode: q (B,1,H,dh) against a KV cache (B,T,Hk,dh),
    positions at or past ``cache_len`` (B,) masked.  As in the reference,
    q is scaled in f32 and rounded to the cache's dtype, the probabilities
    rounded to it before the second product, and both products
    accumulate in f32 (the cache is read in f32: a bf16 product is exact
    there)."""
    B, _, H, dh = q.shape
    T, Hk = k_cache.shape[1], k_cache.shape[2]
    G = H // Hk
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    cdt = k_cache.dtype
    qf = (q.float() * scale).to(cdt).float().reshape(B, Hk, G, dh)
    s = torch.einsum("bkgd,btkd->bkgt", qf, k_cache.float())
    valid = (torch.arange(T, device=q.device)[None]
             < cache_len[:, None])                          # (B, T)
    s = torch.where(valid[:, None, None], s, _NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    o = o / torch.clamp(l, min=1e-30)
    return o.reshape(B, 1, H, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def swiglu_ffn(x: torch.Tensor, wi: torch.Tensor,
               wo: torch.Tensor) -> torch.Tensor:
    """wi: (D, 2F) fused gate|up; wo: (F, D)."""
    gu = x @ wi.to(x.dtype)
    gate, up = torch.chunk(gu, 2, dim=-1)
    return (F.silu(gate) * up) @ wo.to(x.dtype)
