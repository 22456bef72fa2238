"""Decoder-only LM, the dense serving half: the port's counterpart of the
JAX package's ``models/transformer.py``.

One code path parameterised by :class:`LMConfig`: MHA / GQA with optional
QKV bias, per-head qk RMSNorm and partial RoPE, and a dense SwiGLU FFN —
qwen3-0.6b, qwen1.5-4b and chatglm3-6b.  MoE and MLA configs raise
``NotImplementedError`` (ROADMAP queue 1), as does a :class:`ShardCtx`
with a mesh.

Params are a dict of tensors with the reference's keys and its stacked
``(n_layers, ...)`` layout; a Python loop over layers takes the place of
``lax.scan``.  :func:`lm_decode_step` writes the KV cache in place at
``pos`` and returns it (the reference returns a new cache).  f32 products
run with TF32 off (``core.clustering.full_f32``: the caller's setting is
restored afterwards), so an f32 forward and decode step are f32 on the
card as on the CPU.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.core.clustering import full_f32
from repro_torch.core.engine import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import LOCAL_CTX, ShardCtx


def _dense_only(cfg: LMConfig, ctx: ShardCtx = LOCAL_CTX) -> None:
    if cfg.moe or cfg.mla:
        raise NotImplementedError(
            f"{cfg.name}: MoE and MLA models are not ported yet (ROADMAP "
            f"queue 1); the port serves the dense LMs")
    if ctx.mesh is not None:
        raise NotImplementedError(
            "models on a mesh are not ported yet (ROADMAP queue 1): pass "
            "LOCAL_CTX")


def _precision(dtype: torch.dtype):
    """f32 products in full f32 (TF32 off) inside; other dtypes as set."""
    return full_f32 if dtype == torch.float32 else contextlib.nullcontext()


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _block_shapes(cfg: LMConfig) -> Dict[str, Any]:
    """A dense block's param shapes (the reference's ``_block_shapes``
    without its MoE and MLA entries)."""
    D, H, Hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s: Dict[str, Any] = {"ln1": (D,), "ln2": (D,),
                         "wq": (D, H * dh), "wk": (D, Hk * dh),
                         "wv": (D, Hk * dh), "wo": (H * dh, D),
                         "wi": (D, 2 * cfg.d_ff), "wof": (cfg.d_ff, D)}
    if cfg.qkv_bias:
        s.update(bq=(H * dh,), bk=(Hk * dh,), bv=(Hk * dh,))
    if cfg.qk_norm:
        s.update(q_norm=(dh,), k_norm=(dh,))
    return s


def _normal(gen: torch.Generator, shape, std: float,
            device: torch.device) -> torch.Tensor:
    """``std`` times standard normals drawn by ``gen`` on its own device,
    f32, placed on ``device``."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * std).to(device)


def _init_stack(gen: torch.Generator, shapes: Dict[str, Any], n: int,
                device: torch.device) -> Dict[str, torch.Tensor]:
    out = {}
    for name, shape in sorted(shapes.items()):
        full = (n,) + tuple(shape)
        if name.startswith(("ln", "q_norm", "k_norm")):
            out[name] = torch.ones(full, dtype=torch.float32, device=device)
        elif name.startswith("b"):
            out[name] = torch.zeros(full, dtype=torch.float32, device=device)
        else:
            std = 0.02 if name not in ("wo", "wof") \
                else 0.02 / math.sqrt(2 * max(n, 1))
            out[name] = _normal(gen, full, std, device)
    return out


def init_lm(gen: torch.Generator, cfg: LMConfig,
            device=None) -> Dict[str, Any]:
    """Random f32 params of the reference's shapes and stds, drawn by
    ``gen`` (on its own device) and placed on ``device`` (None: the
    card).  The numbers differ from ``jax.random``'s: carry the
    reference's params across with :func:`params_from_numpy`."""
    _dense_only(cfg)
    dev = resolve_device(device)
    params: Dict[str, Any] = {
        "embed": _normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dev),
        "blocks": _init_stack(gen, _block_shapes(cfg), cfg.n_layers,
                              dev),
        "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                 device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal(gen, (cfg.d_model, cfg.vocab_size), 0.02,
                                    dev)
    return params


def params_from_numpy(tree, device=None):
    """A tree of numpy arrays (e.g. ``jax.tree.map(np.asarray, params)``
    of the reference's ``init_lm``) as the port's params: the same dict
    keys, each array copied to a tensor of its dtype on ``device`` (None:
    the card)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), device=dev)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _layer(stack: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in stack.items()}


def _qkv(x, p, cfg: LMConfig):
    """Projections, bias, per-head qk RMSNorm: q (B,S,H,dh), k/v
    (B,S,Hk,dh) in x's dtype."""
    B, S, _ = x.shape
    H, Hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(B, S, H, dh)
    k = k.reshape(B, S, Hk, dh)
    v = v.reshape(B, S, Hk, dh)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _attn(x, p, cfg: LMConfig, rope):
    B, S, _ = x.shape
    q, k, v = _qkv(x, p, cfg)
    cos, sin = rope
    q = L.apply_rope(q, cos, sin, cfg.rope_fraction)
    k = L.apply_rope(k, cos, sin, cfg.rope_fraction)
    o = L.blockwise_attention(q, k, v, causal=True)
    return o.reshape(B, S, cfg.n_heads * cfg.d_head) @ p["wo"].to(x.dtype)


def _ffn(x, p):
    return L.swiglu_ffn(x, p["wi"].to(x.dtype), p["wof"].to(x.dtype))


def _block(x, p, cfg: LMConfig, rope):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + _attn(h, p, cfg, rope)
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _ffn(h, p)


def _rotary_dim(cfg: LMConfig) -> int:
    return int(cfg.d_head * cfg.rope_fraction) // 2 * 2


def _head(params, x, cfg: LMConfig, dtype: torch.dtype) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(dtype)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _tokens(params, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params["embed"].device).long()


def _trunk(params, tokens: torch.Tensor, cfg: LMConfig,
           dtype: torch.dtype) -> torch.Tensor:
    """tokens (B, S) -> the last block's output (B, S, D) in ``dtype``."""
    S = tokens.shape[1]
    x = params["embed"][tokens].to(dtype)
    positions = torch.arange(S, device=x.device)
    rope = L.rope_tables(positions, _rotary_dim(cfg), cfg.rope_theta)
    for i in range(cfg.n_layers):
        x = _block(x, _layer(params["blocks"], i), cfg, rope)
    return x


def lm_forward(params, tokens, cfg: LMConfig, ctx: ShardCtx = LOCAL_CTX,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V) in ``dtype``, on the params'
    device."""
    _dense_only(cfg, ctx)
    with _precision(dtype):
        tokens = _tokens(params, tokens)
        return _head(params, _trunk(params, tokens, cfg, dtype), cfg, dtype)


def lm_prefill(params, tokens, cfg: LMConfig, ctx: ShardCtx = LOCAL_CTX,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Prefill pass: last-position logits (B, V), as ``lm_forward(...)[:,
    -1]`` (the head is applied to the last position only).  Cache
    write-back is the decode path's job, as in the reference."""
    _dense_only(cfg, ctx)
    with _precision(dtype):
        tokens = _tokens(params, tokens)
        x = _trunk(params, tokens, cfg, dtype)
        return _head(params, x[:, -1], cfg, dtype)


# ---------------------------------------------------------------------------
# Serving: decode with a KV cache
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: LMConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device=None) -> Dict[str, torch.Tensor]:
    """Zeroed KV cache of the reference's keys and shapes on ``device``
    (None: the card)."""
    _dense_only(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _decode_attn_gqa(x, p, cfg: LMConfig, kc, vc, pos: int):
    """One layer's decode attention; writes this step's k and v into the
    layer's cache views ``kc``/``vc`` (B, T, Hk, dh) at ``pos``."""
    B = x.shape[0]
    q, k, v = _qkv(x, p, cfg)
    cos, sin = L.rope_tables(torch.full((B, 1), pos, device=x.device),
                             _rotary_dim(cfg), cfg.rope_theta)
    q = L.apply_rope(q, cos, sin, cfg.rope_fraction)
    k = L.apply_rope(k, cos, sin, cfg.rope_fraction)
    kc[:, pos:pos + 1] = k.to(kc.dtype)
    vc[:, pos:pos + 1] = v.to(vc.dtype)
    cache_len = torch.full((B,), pos + 1, dtype=torch.int32, device=x.device)
    o = L.decode_attention(q, kc, vc, cache_len)
    return o.reshape(B, 1, cfg.n_heads * cfg.d_head) @ p["wo"].to(x.dtype)


def lm_decode_step(params, cache: Dict[str, torch.Tensor], tokens, pos: int,
                   cfg: LMConfig, ctx: ShardCtx = LOCAL_CTX,
                   dtype: torch.dtype = torch.bfloat16):
    """One decode step: tokens (B, 1) at position ``pos``.

    Returns (logits (B, 1, V), cache): the cache is written in place."""
    _dense_only(cfg, ctx)
    with _precision(dtype):
        x = params["embed"][_tokens(params, tokens)].to(dtype)
        for i in range(cfg.n_layers):
            p = _layer(params["blocks"], i)
            h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
            x = x + _decode_attn_gqa(h, p, cfg, cache["k"][i],
                                     cache["v"][i], pos)
            h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
            x = x + _ffn(h, p)
        return _head(params, x, cfg, dtype), cache
