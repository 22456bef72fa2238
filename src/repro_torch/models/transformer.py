"""Decoder-only LM: the port's counterpart of the JAX package's
``models/transformer.py`` (forward, loss, prefill and decode).

One code path parameterised by :class:`LMConfig`, covering the repo's
five LMs: MHA / GQA with optional QKV bias, per-head qk RMSNorm and
partial RoPE, or MLA (DeepSeek-V2) with its compressed-KV absorbed
decode; a dense SwiGLU FFN or the MoE (routed experts, shared experts,
the first ``first_k_dense`` layers dense in their own stack,
``dense_blocks``).

On a :class:`ShardCtx` with a mesh the forward, loss, prefill and decode
step are the reference's sharded ones: the MoE is expert-parallel
(``layers.moe_block``: the all-to-all dispatch in the forward, each
shard's own experts summed in decode), and the reference's sharding
constraints (``ctx.constrain``) check their specs against the mesh and
change no value: the activations stay whole on its first device.
:func:`lm_param_specs` and :func:`kv_cache_specs` are the reference's
layouts (``models.api`` records them; ``launch.dryrun`` counts them).

Params are a dict of tensors with the reference's keys and its stacked
``(n_layers, ...)`` layout; a Python loop over layers takes the place of
``lax.scan``.  :func:`init_lm` may store them in bf16 (``dtype``), drawn
one layer at a time, so a model of 16B params fits the card; every
product casts its weight to the compute dtype.  :func:`lm_decode_step`
writes the KV cache in place at ``pos`` and returns it (the reference
returns a new cache).  f32 products run with TF32 off
(``core.clustering.full_f32``: the caller's setting is restored
afterwards), so an f32 forward and decode step are f32 on the card as on
the CPU.

:func:`lm_loss` is the reference's: masked next-token cross entropy, with
accuracy and the token count.  Where grad is enabled, each block's
forward is rematerialised in the backward (``torch.utils.checkpoint``,
non-reentrant), as the reference's ``_scan_blocks`` wraps each block in
``jax.checkpoint`` (full remat, its default): a block keeps only its
input, and the attention's flash forward runs twice a step.  The
backward runs after ``lm_forward``'s precision context has closed, so a
caller that wants f32 gradients in full f32 holds its backward under
``core.clustering.full_f32`` (``train.loop.make_train_step`` does).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.core.clustering import full_f32
from repro_torch.core.engine import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.layers import LOCAL_CTX, ShardCtx
from repro_torch.sharding.spec import P, Rules


def _n_main(cfg: LMConfig) -> int:
    """Layers of the main stack, ``blocks``: all of them, or the MoE
    layers after the ``first_k_dense`` dense ones."""
    return cfg.n_layers - cfg.first_k_dense if cfg.moe else cfg.n_layers


def _precision(dtype: torch.dtype):
    """f32 products in full f32 (TF32 off) inside; other dtypes as set."""
    return full_f32 if dtype == torch.float32 else contextlib.nullcontext()


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _block_shapes(cfg: LMConfig, moe: bool, d_ff: int) -> Dict[str, Any]:
    """A block's param shapes: attention (GQA or MLA), then a dense FFN
    of width ``d_ff`` or, where ``moe``, the router, the experts and the
    shared experts."""
    D, H, Hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s: Dict[str, Any] = {"ln1": (D,), "ln2": (D,)}
    if cfg.mla:
        qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        s.update(
            wq=(D, H * qk),
            wdkv=(D, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
            kv_norm=(cfg.kv_lora_rank,),
            wuk=(cfg.kv_lora_rank, H * cfg.qk_nope_head_dim),
            wuv=(cfg.kv_lora_rank, H * cfg.v_head_dim),
            wo=(H * cfg.v_head_dim, D),
        )
    else:
        s.update(wq=(D, H * dh), wk=(D, Hk * dh), wv=(D, Hk * dh),
                 wo=(H * dh, D))
        if cfg.qkv_bias:
            s.update(bq=(H * dh,), bk=(Hk * dh,), bv=(Hk * dh,))
        if cfg.qk_norm:
            s.update(q_norm=(dh,), k_norm=(dh,))
    if moe:
        F = cfg.moe_d_ff
        s.update(router=(D, cfg.n_experts),
                 w1=(cfg.n_experts, D, 2 * F),
                 w2=(cfg.n_experts, F, D))
        if cfg.n_shared_experts:
            Fs = F * cfg.n_shared_experts
            s.update(ws1=(D, 2 * Fs), ws2=(Fs, D))
    else:
        s.update(wi=(D, 2 * d_ff), wof=(d_ff, D))
    return s


def _block_specs(cfg: LMConfig, r: Rules, moe: bool) -> Dict[str, P]:
    """A stacked block's param specs (the leading layer axis unsplit)."""
    fs, tp, ep = r.fsdp, r.tensor, r.expert
    s: Dict[str, P] = {"ln1": P(None, None), "ln2": P(None, None)}
    if cfg.mla:
        s.update(wq=P(None, fs, tp), wdkv=P(None, fs, None),
                 kv_norm=P(None, None),
                 wuk=P(None, fs, tp), wuv=P(None, fs, tp),
                 wo=P(None, tp, fs))
    else:
        s.update(wq=P(None, fs, tp), wk=P(None, fs, tp), wv=P(None, fs, tp),
                 wo=P(None, tp, fs))
        if cfg.qkv_bias:
            s.update(bq=P(None, tp), bk=P(None, tp), bv=P(None, tp))
        if cfg.qk_norm:
            s.update(q_norm=P(None, None), k_norm=P(None, None))
    if moe:
        s.update(router=P(None, fs, None),
                 w1=P(None, ep, fs, None), w2=P(None, ep, None, fs))
        if cfg.n_shared_experts:
            s.update(ws1=P(None, fs, tp), ws2=P(None, tp, fs))
    else:
        s.update(wi=P(None, fs, tp), wof=P(None, tp, fs))
    return s


def lm_param_specs(cfg: LMConfig, r: Rules) -> Dict[str, Any]:
    """The params' specs under rules ``r``: the tree of :func:`init_lm`'s
    params, a ``PartitionSpec`` a leaf."""
    specs: Dict[str, Any] = {
        "embed": P(r.tensor, r.fsdp),
        "blocks": _block_specs(cfg, r, cfg.moe),
        "final_norm": P(None),
    }
    if cfg.moe and cfg.first_k_dense:
        specs["dense_blocks"] = _block_specs(cfg, r, False)
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(r.fsdp, r.tensor)
    return specs


def _normal(gen: torch.Generator, shape, std: float, device: torch.device,
            dtype: torch.dtype = torch.float32,
            per_layer: bool = False) -> torch.Tensor:
    """``std`` times standard normals drawn by ``gen`` on its own device
    in f32, stored in ``dtype`` on ``device``.  In f32, or where not
    ``per_layer``, in one draw; else one draw per index of the leading
    (layer) axis, so the f32 transient is one layer's.  On the meta
    device, the shape alone: nothing is drawn or allocated
    (``models.api``'s abstract cells)."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    if dtype == torch.float32 or not per_layer:
        x = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device)
        return (x * std).to(device=device, dtype=dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        x = torch.randn(shape[1:], generator=gen, dtype=torch.float32,
                        device=gen.device)
        out[i] = x * std
    return out


def _init_stack(gen: torch.Generator, shapes: Dict[str, Any], n: int,
                device: torch.device,
                dtype: torch.dtype = torch.float32
                ) -> Dict[str, torch.Tensor]:
    out = {}
    for name, shape in sorted(shapes.items()):
        full = (n,) + tuple(shape)
        if name.startswith(("ln", "q_norm", "k_norm", "kv_norm")):
            out[name] = torch.ones(full, dtype=dtype, device=device)
        elif name.startswith("b"):
            out[name] = torch.zeros(full, dtype=dtype, device=device)
        else:
            std = 0.02 if name not in ("wo", "wof", "w2") \
                else 0.02 / math.sqrt(2 * max(n, 1))
            out[name] = _normal(gen, full, std, device, dtype,
                                per_layer=True)
    return out


def init_lm(gen: torch.Generator, cfg: LMConfig, device=None,
            dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Random params of the reference's shapes and stds, drawn by ``gen``
    (on its own device) in f32 and stored in ``dtype`` on ``device``
    (None: the card).  bf16 storage draws each stacked param one layer at
    a time (other numbers than the f32 default's single draws).  The
    numbers differ from ``jax.random``'s: carry the reference's params
    across with :func:`params_from_numpy`."""
    dev = resolve_device(device)
    params: Dict[str, Any] = {
        "embed": _normal(gen, (cfg.vocab_size, cfg.d_model), 0.02, dev,
                         dtype),
        "blocks": _init_stack(gen, _block_shapes(cfg, cfg.moe, cfg.d_ff),
                              _n_main(cfg), dev, dtype),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    }
    if cfg.moe and cfg.first_k_dense:
        params["dense_blocks"] = _init_stack(
            gen, _block_shapes(cfg, False, cfg.dense_d_ff or cfg.d_ff),
            cfg.first_k_dense, dev, dtype)
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal(gen, (cfg.d_model, cfg.vocab_size), 0.02,
                                    dev, dtype)
    return params


def params_from_numpy(tree, device=None):
    """A tree of numpy arrays (e.g. ``jax.tree.map(np.asarray, params)``
    of the reference's ``init_lm``, ``init_sage`` or a recsys ``init_*``)
    as the port's params: the same dict keys and list positions, each
    array copied to a tensor of its dtype on ``device`` (None: the
    card)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, dev) for v in tree]
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


def _attn(x, p, cfg: LMConfig, rope, ctx: ShardCtx):
    B, S, _ = x.shape
    q, k, v = _qkv(x, p, cfg)
    cos, sin = rope
    q = L.apply_rope(q, cos, sin, cfg.rope_fraction)
    k = L.apply_rope(k, cos, sin, cfg.rope_fraction)
    o = L.blockwise_attention(q, k, v, causal=True)
    o = ctx.constrain(o, "batch", "tensor", None, None)
    return o.reshape(B, S, cfg.n_heads * cfg.d_head) @ p["wo"].to(x.dtype)


def _mla_weights(p, cfg: LMConfig) -> Dict[str, torch.Tensor]:
    """A layer's MLA params with ``wq``, ``wuk`` and ``wuv`` per head, as
    ``layers.mla_qkv`` takes them."""
    H, lr = cfg.n_heads, cfg.kv_lora_rank
    pr = dict(p)
    pr["wq"] = p["wq"].reshape(cfg.d_model, H, -1)
    pr["wuk"] = p["wuk"].reshape(lr, H, cfg.qk_nope_head_dim)
    pr["wuv"] = p["wuv"].reshape(lr, H, cfg.v_head_dim)
    return pr


def _mla_attn(x, p, cfg: LMConfig, positions, ctx: ShardCtx):
    """MLA's prefill: the expanded q, k (192 wide at DeepSeek-V2) and v
    (128) through ``blockwise_attention``, scaled by 1/sqrt(nope + rope)."""
    B, S, _ = x.shape
    q, k, v, _ = L.mla_qkv(x, _mla_weights(p, cfg), cfg, positions)
    scale = 1.0 / math.sqrt(cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    o = L.blockwise_attention(q, k, v, causal=True, scale=scale)
    o = ctx.constrain(o, "batch", "tensor", None, None)
    return (o.reshape(B, S, cfg.n_heads * cfg.v_head_dim)
            @ p["wo"].to(x.dtype))


def _ffn_or_moe(x, p, cfg: LMConfig, ctx: ShardCtx, moe: bool,
                seq_sharded: bool = True):
    if not moe:
        return L.swiglu_ffn(x, p["wi"].to(x.dtype), p["wof"].to(x.dtype))
    return L.moe_block(x, p["router"], p["w1"], p["w2"], p.get("ws1"),
                       p.get("ws2"), cfg=cfg, ctx=ctx,
                       seq_sharded=seq_sharded)


def _block(x, p, cfg: LMConfig, rope, positions, ctx: ShardCtx,
           moe: bool):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.mla:
        x = x + _mla_attn(h, p, cfg, positions, ctx)
    else:
        x = x + _attn(h, p, cfg, rope, ctx)
    x = ctx.constrain(x, "batch", "tensor", None)
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + _ffn_or_moe(h, p, cfg, ctx, moe)
    return ctx.constrain(x, "batch", "tensor", None)


def _stacks(params, cfg: LMConfig):
    """(stack, its cache keys' suffix, moe) in the order the layers run:
    the dense first layers, then the main stack."""
    out = []
    if cfg.moe and cfg.first_k_dense:
        out.append((params["dense_blocks"], "_dense", False))
    out.append((params["blocks"], "", cfg.moe))
    return out


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


def _trunk(params, tokens: torch.Tensor, cfg: LMConfig, ctx: ShardCtx,
           dtype: torch.dtype) -> torch.Tensor:
    """tokens (B, S) -> the last block's output (B, S, D) in ``dtype``."""
    S = tokens.shape[1]
    x = ctx.constrain(params["embed"][tokens].to(dtype), "batch", "tensor",
                      None)
    positions = torch.arange(S, device=x.device)
    # MLA computes its own tables over the rope sub-dims
    rope = (None if cfg.mla else
            L.rope_tables(positions, _rotary_dim(cfg), cfg.rope_theta))
    for stack, _, moe in _stacks(params, cfg):
        grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in stack.values())
        # each layer's params as views from one unbind per stacked param,
        # whose backward writes each layer's gradient once into one
        # stacked tensor (indexing each layer would give each a
        # zero-filled gradient of the whole stack, summed over the layers)
        names = list(stack)
        for p in zip(*(stack[n].unbind(0) for n in names)):
            p = dict(zip(names, p))
            if grad:
                x = checkpoint(_block, x, p, cfg, rope, positions, ctx, moe,
                               use_reentrant=False)
            else:
                x = _block(x, p, cfg, rope, positions, ctx, moe)
    return x


def lm_forward(params, tokens, cfg: LMConfig, ctx: ShardCtx = LOCAL_CTX,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V) in ``dtype``, on the params'
    device."""
    with _precision(dtype):
        tokens = _tokens(params, tokens)
        logits = _head(params, _trunk(params, tokens, cfg, ctx, dtype), cfg,
                       dtype)
        return ctx.constrain(logits, "batch", "tensor", None)


def lm_loss(params, batch, cfg: LMConfig, ctx: ShardCtx = LOCAL_CTX,
            dtype: torch.dtype = torch.bfloat16):
    """Next-token cross entropy of ``batch`` (``tokens`` and ``labels``
    (B, S), an optional ``mask`` (B, S), numpy arrays or tensors):
    (loss, {"loss", "accuracy", "tokens"}), each a 0-d f32 tensor on the
    params' device, the mean over the mask's tokens (at least 1)."""
    logits = lm_forward(params, batch["tokens"], cfg, ctx, dtype)
    dev = logits.device
    labels = torch.as_tensor(batch["labels"], device=dev).long()
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    mask = batch.get("mask")
    mask = (torch.ones(labels.shape, dtype=torch.float32, device=dev)
            if mask is None else torch.as_tensor(mask, device=dev).float())
    n = torch.clamp(torch.sum(mask), min=1.0)
    loss = torch.sum((lse - ll) * mask) / n
    acc = torch.sum((torch.argmax(logits, -1) == labels) * mask) / n
    return loss, {"loss": loss, "accuracy": acc, "tokens": n}


def lm_prefill(params, tokens, cfg: LMConfig, ctx: ShardCtx = LOCAL_CTX,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Prefill pass: last-position logits (B, V), as ``lm_forward(...)[:,
    -1]`` (the head is applied to the last position only).  Cache
    write-back is the decode path's job, as in the reference."""
    with _precision(dtype):
        tokens = _tokens(params, tokens)
        x = _trunk(params, tokens, cfg, ctx, dtype)
        return _head(params, x[:, -1], cfg, dtype)


# ---------------------------------------------------------------------------
# Serving: decode with a KV cache
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: LMConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device=None) -> Dict[str, torch.Tensor]:
    """Zeroed KV cache of the reference's keys and shapes on ``device``
    (None: the card): ``k``/``v`` (n_layers, B, T, Hk, dh), or under MLA
    the compressed ``ckv`` (n, B, T, lora) and ``kpe`` (n, B, T, rope)
    of the main stack, with ``ckv_dense``/``kpe_dense`` for the
    ``first_k_dense`` layers."""
    dev = resolve_device(device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)
    if cfg.mla:
        n = _n_main(cfg)
        cache = {"ckv": zeros(n, batch, max_len, cfg.kv_lora_rank),
                 "kpe": zeros(n, batch, max_len, cfg.qk_rope_head_dim)}
        if cfg.first_k_dense:
            n = cfg.first_k_dense
            cache["ckv_dense"] = zeros(n, batch, max_len, cfg.kv_lora_rank)
            cache["kpe_dense"] = zeros(n, batch, max_len,
                                       cfg.qk_rope_head_dim)
        return cache
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": zeros(*shape), "v": zeros(*shape)}


def kv_cache_specs(cfg: LMConfig, r: Rules, *, seq_axes) -> Dict[str, P]:
    """The cache's specs: sequence-sharded over ``seq_axes`` (the decode
    attention's reductions run over the sharded T dimension in the
    reference)."""
    if cfg.mla:
        specs = {"ckv": P(None, r.batch, seq_axes, None),
                 "kpe": P(None, r.batch, seq_axes, None)}
        if cfg.first_k_dense:
            specs["ckv_dense"] = P(None, r.batch, seq_axes, None)
            specs["kpe_dense"] = P(None, r.batch, seq_axes, None)
        return specs
    return {"k": P(None, r.batch, seq_axes, None, None),
            "v": P(None, r.batch, seq_axes, None, None)}


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


def _decode_attn_mla(x, p, cfg: LMConfig, ckv_c, kpe_c, pos: int):
    """One layer's MLA decode; writes this step's compressed (c_kv, k_pe)
    into the layer's cache views ``ckv_c`` (B, T, lora) / ``kpe_c`` (B,
    T, rope) at ``pos``, then attends in the absorbed form."""
    B = x.shape[0]
    dt = x.dtype
    lr, rd = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    ckr = x @ p["wdkv"].to(dt)
    c_kv, k_pe = ckr[..., :lr], ckr[..., lr:]
    c_kv = L.rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
    positions = torch.full((B, 1), pos, device=x.device)
    cos, sin = L.rope_tables(positions, rd, cfg.rope_theta)
    k_pe = L.apply_rope(k_pe[:, :, None, :], cos, sin)[:, :, 0]
    ckv_c[:, pos:pos + 1] = c_kv.to(ckv_c.dtype)
    kpe_c[:, pos:pos + 1] = k_pe.to(kpe_c.dtype)
    cache_len = torch.full((B,), pos + 1, dtype=torch.int32, device=x.device)
    o = L.mla_decode_absorbed(x, _mla_weights(p, cfg), cfg, ckv_c, kpe_c,
                              cache_len, positions)
    return (o.reshape(B, 1, cfg.n_heads * cfg.v_head_dim)
            @ p["wo"].to(dt))


def lm_decode_step(params, cache: Dict[str, torch.Tensor], tokens, pos: int,
                   cfg: LMConfig, ctx: ShardCtx = LOCAL_CTX,
                   dtype: torch.dtype = torch.bfloat16):
    """One decode step: tokens (B, 1) at position ``pos``, through the
    dense first layers and then the main stack.  Without a mesh the MoE
    takes the B tokens through the reference's local path: its capacity
    holds at least k pairs an expert, so B = 1 drops none, and a larger B
    may drop a pair as the reference does.  On a mesh it takes them
    replicated over the expert axis at capacity B (none dropped), as the
    reference's decode does.

    Returns (logits (B, 1, V), cache): the cache is written in place."""
    names = ("ckv", "kpe") if cfg.mla else ("k", "v")
    attn = _decode_attn_mla if cfg.mla else _decode_attn_gqa
    with _precision(dtype):
        x = params["embed"][_tokens(params, tokens)].to(dtype)
        x = ctx.constrain(x, "batch", None, None)
        for stack, suffix, moe in _stacks(params, cfg):
            c0, c1 = cache[names[0] + suffix], cache[names[1] + suffix]
            for i in range(stack["ln1"].shape[0]):
                p = _layer(stack, i)
                h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
                x = x + attn(h, p, cfg, c0[i], c1[i], pos)
                h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
                x = x + _ffn_or_moe(h, p, cfg, ctx, moe, seq_sharded=False)
                x = ctx.constrain(x, "batch", None, None)
        return _head(params, x, cfg, dtype), cache
