"""Model building blocks, the serving half: the port's counterpart of the
JAX package's ``models/layers.py``.

* Norms, rotary embedding (with ChatGLM's ``fraction``), the SwiGLU FFN
  and decode attention over a KV cache are plain PyTorch, as the JAX
  functions are plain ``jnp`` (their products go to cuBLAS, as the JAX
  ones went to XLA).
* :func:`blockwise_attention` is the model's attention (train and
  prefill).  On CUDA tensors it launches the port's flash kernel
  (``kernels.flash_attn.flash_attention``: ``flash_attn_fwd_wgmma`` in
  bf16, ``flash_attn_fwd_tf32`` in f32), the Hopper counterpart of the
  Pallas ``flash_attention_fwd``; a shape that kernel lacks raises.  On
  CPU tensors it runs :func:`_attention_fwd_scan`, the torch port of the
  reference's online-softmax scan over KV blocks, which is the plain
  version and never runs on the card's main path.  Where a gradient is
  wanted (grad enabled and an input requiring it) it runs
  :class:`_FlashAttention`, the reference's custom VJP (``_flash_fwd`` /
  ``_flash_bwd``): the forward also writes each row's logsumexp and
  saves (q, k, v, out, lse), O(S) residuals, and the backward recomputes
  the scores from them (``kernels.flash_attn.flash_attention_bwd``: the
  ``flash_attn_bwd`` kernel on the card, ``flash_attn_bwd_ref`` on the
  CPU).  The reference's ``REPRO_FLASH_VJP`` ablation switch (autograd
  through the scan) is not ported: the port keeps its default.

* :func:`moe_block` is the reference's MoE: capacity-bounded,
  cumsum-slotted dispatch, every expert's FFN as one batched product, a
  gated combine; shared experts through :func:`swiglu_ffn`.  Routing is
  deterministic on the card: ties go to the lowest expert id, as
  ``lax.top_k`` sends them (a stable sort, not ``torch.topk``), the
  router's product runs in full f32 (TF32 off:
  ``core.clustering.full_f32``), each kept slot is written once and the
  combine sums each token's k outputs in a fixed order (no atomics).  On
  a :class:`ShardCtx` with a mesh it is expert-parallel as the
  reference's ``shard_map`` regions are, written as stages
  (``sharding.spec``): the all-to-all dispatch for train and prefill,
  each shard's own experts and a sum over shards for decode.
* :func:`mla_qkv` and :func:`mla_decode_absorbed` are DeepSeek-V2's MLA:
  the prefill expands the compressed KV and runs
  :func:`blockwise_attention` with v narrower than q and k; decode
  absorbs ``W_UK`` and ``W_UV`` and attends over the compressed cache.

* :func:`segment_reduce` is ``jax.ops.segment_sum`` / ``segment_max``
  in a fixed order of adds (the recsys and GNN models' reductions);
  :func:`gather_rows` is their row gathers, whose backward sums each
  id's rows through it (the reference's scatter-add, in the gathered
  dtype), so a training step repeats bit for bit on the card.

:class:`ShardCtx` and :data:`LOCAL_CTX` are ``sharding.spec``'s.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig
from repro_torch.core.clustering import full_f32
from repro_torch.kernels.flash_attn.ops import (flash_attention,
                                                flash_attention_bwd,
                                                flash_bwd_width)
from repro_torch.sharding.spec import (LOCAL_CTX, P, ShardCtx, all_to_all,
                                       per_shard, psum, shard_merge,
                                       shard_split)

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


def _offset_zero(q_offset: int) -> None:
    if q_offset != 0:
        raise ValueError(f"q_offset={q_offset}: the flash kernel takes "
                         f"queries at offset 0 only")


def _attention_fwd(q, k, v, causal: bool, q_offset: int, block_size: int,
                   scale: float):
    """The VJP's forward: (out, lse (B, H, S) f32).  CPU tensors run the
    plain scan (its (B, Hk, G, S) lse is the same memory); CUDA tensors
    launch the flash kernel with its lse, after checking that the
    backward kernel takes the shape (``flash_bwd_width`` raises
    ``ValueError`` naming it)."""
    if q.device.type == "cpu":
        out, lse = _attention_fwd_scan(q, k, v, causal, q_offset,
                                       block_size, scale)
        return out, lse.reshape(q.shape[0], q.shape[2], q.shape[1])
    _offset_zero(q_offset)
    flash_bwd_width(q.shape[-1], v.shape[-1])
    return flash_attention(q, k, v, causal=causal, scale=scale,
                           return_lse=True)


class _FlashAttention(torch.autograd.Function):
    """The reference's ``_flash_attention`` custom VJP: the forward saves
    (q, k, v, out, lse), the backward recomputes the scores block by
    block from lse, so no S x T tensor outlives the forward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, block_size, scale):
        out, lse = _attention_fwd(q, k, v, causal, q_offset, block_size,
                                  scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, block_size, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, q_offset, block_size, scale = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), causal=causal,
                                         scale=scale, q_offset=q_offset,
                                         block_size=block_size)
        return dq, dk, dv, None, None, None, None


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, q_offset: int = 0,
                        block_size: int = 512,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,S,H,dh) k/v: (B,T,Hk,dh[v]) -> (B,S,H,dhv), in q's dtype.

    T must be a multiple of ``min(block_size, T)``, as in the reference.
    Where grad is enabled and q, k or v requires it, the custom VJP
    (:class:`_FlashAttention`); else the forward alone.  CPU tensors run
    the plain scan (and the plain backward).  CUDA tensors launch
    ``kernels.flash_attn.flash_attention``, which takes ``q_offset == 0``,
    dh <= 256 and a v width up to q's (MLA's 128 against 192), and for a
    gradient ``flash_attention_bwd``, which takes q/k up to 128 wide with
    v up to q's width, or up to 192 with v up to 128 (MLA's training);
    any other shape raises ``ValueError`` naming it, a gradient's in the
    forward before any launch (ROADMAP queue 3)."""
    dh = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    T = k.shape[1]
    bs = min(block_size, T)
    assert (T // bs) * bs == T, f"T={T} not divisible by block {bs}"
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, q_offset, block_size,
                                     scale)
    if q.device.type == "cpu":
        return _attention_fwd_scan(q, k, v, causal, q_offset, block_size,
                                   scale)[0]
    _offset_zero(q_offset)
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


# ---------------------------------------------------------------------------
# Segment reductions (the recsys EmbeddingBag, GNN message passing)
# ---------------------------------------------------------------------------

def segment_order(segment_ids: torch.Tensor,
                  num_segments: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """What :func:`segment_reduce` needs of ``segment_ids`` (L,), computed
    once for every reduction over the same ids: the rows whose id lies in
    [0, num_segments), stably sorted by id, and each segment's length."""
    seg = segment_ids.long()
    rows = torch.nonzero((seg >= 0) & (seg < num_segments)).squeeze(1)
    seg, perm = torch.sort(seg[rows], stable=True)
    return rows[perm], torch.bincount(seg, minlength=num_segments)


def segment_reduce(values: torch.Tensor, segment_ids: Optional[torch.Tensor],
                   num_segments: int, mode: str = "sum",
                   order: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> torch.Tensor:
    """``jax.ops.segment_sum`` (``mode="sum"``) or ``segment_max``
    (``"max"``) over axis 0: values (L, ...) and segment_ids (L,) in any
    order -> (num_segments, ...).  Rows whose id lies outside [0,
    num_segments) are dropped; an empty segment is 0 (sum) or -inf (max).
    ``order`` is :func:`segment_order` of the ids, where the caller has it.

    The rows are sorted by segment id (stable) and each segment reduced
    in that order by ``torch.segment_reduce``, so the card adds in a
    fixed order and two runs give the same bits (``index_add_`` and
    ``scatter_reduce`` add in no fixed order there)."""
    if mode not in ("sum", "max"):
        raise ValueError(mode)
    rows, lengths = (segment_order(segment_ids, num_segments)
                     if order is None else order)
    if rows.numel() == 0:
        return torch.full((num_segments,) + tuple(values.shape[1:]),
                          0.0 if mode == "sum" else -torch.inf,
                          dtype=values.dtype, device=values.device)
    return torch.segment_reduce(values[rows], mode, lengths=lengths,
                                axis=0, unsafe=True)


class _GatherRows(torch.autograd.Function):
    """``table[ids]`` in ``dtype``, whose backward sums each id's
    gradient rows in a fixed order (see :func:`gather_rows`)."""

    @staticmethod
    def forward(ctx, table, ids, dtype):
        ctx.save_for_backward(ids)
        ctx.table = (tuple(table.shape), table.dtype)
        rows = table[ids]
        return rows if dtype is None else rows.to(dtype)

    @staticmethod
    def backward(ctx, grad):
        ids, = ctx.saved_tensors
        shape, dtype = ctx.table
        flat = ids.reshape(-1)
        sums = segment_reduce(grad.reshape(flat.shape[0], *shape[1:]), flat,
                              shape[0])
        return sums.to(dtype), None, None


def gather_rows(table: torch.Tensor, ids: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``table[ids]`` (rows of ``table`` (V, ...) at int64 ``ids`` of any
    shape), rounded to ``dtype`` where given: the reference's
    ``jnp.take(table.astype(dtype), ids, axis=0)``.

    The backward is the reference's scatter-add: each id's gradient rows,
    in ``dtype`` (the gathered rows' type), summed in the order the ids
    come (:func:`segment_reduce`, whose sums round to their dtype at each
    add, as the reference's scatter into a buffer of that dtype does),
    then cast to the table's dtype.  So two runs on the card give the
    same bits, where the backward of ``table[ids]`` adds with atomics in
    no fixed order, and a bf16 gather's gradient is summed in bf16, as
    the reference sums it."""
    return _GatherRows.apply(table, ids, dtype)


# ---------------------------------------------------------------------------
# MoE, the local path (one shard) of the reference's expert-parallel MoE
# ---------------------------------------------------------------------------

def _capacity(n_tokens: int, top_k: int, n_experts: int,
              factor: float) -> int:
    c = int(math.ceil(n_tokens * top_k / n_experts * factor))
    return max(c, top_k)


def _router(x: torch.Tensor, router_w: torch.Tensor, cfg: LMConfig):
    """x (t, D) -> gates (t, k) f32 (renormalised, times
    ``router_scale``) and expert ids (t, k), the most probable first and,
    among equal probabilities, the lowest id first (``lax.top_k``'s
    order).  The product is f32 with TF32 off, so a bf16 forward routes
    on the card as it does on the CPU."""
    with full_f32:
        logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gates, eids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eids = gates[:, :cfg.moe_top_k], eids[:, :cfg.moe_top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates * cfg.router_scale, eids


def _expert_slots(eids: torch.Tensor, n_experts: int):
    """Rank of each (token, k) pair within its expert (cumsum-slotting
    over the token-major flattened pairs).  The one-hot is laid out (E, t*k), so the cumsum runs
    along its contiguous last axis: CUDA scans an outer axis with one
    thread a column, serially (tens of ms a layer at t*k = 49,152)."""
    eid_flat = eids.reshape(-1)                                 # (t*k,)
    onehot = (eid_flat[None, :] == torch.arange(
        n_experts, device=eids.device)[:, None]).long()
    pos = torch.cumsum(onehot, dim=1) - onehot
    pos_flat = pos.gather(0, eid_flat[None, :])[0]
    return eid_flat, pos_flat


def _expert_ffn(buf: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """buf (E, cap, D) through each expert's SwiGLU: w1 (E, D, 2F), w2
    (E, F, D)."""
    gu = torch.bmm(buf, w1.to(dtype))
    gate, up = torch.chunk(gu, 2, dim=-1)
    return torch.bmm(F.silu(gate) * up, w2.to(dtype))


def _moe_dispatch(x: torch.Tensor, router_w, cfg: LMConfig, cap: int,
                  lo: int = 0, n_local: Optional[int] = None):
    """Route x (t, D) and slot each (token, k) pair to experts [lo, lo +
    n_local) (default: all E) at capacity ``cap``: (buf (n_local, cap,
    D), slot (t*k,), gates (t, k)).  A pair past its expert's capacity,
    or routed to another shard's expert, goes to the bucket row
    ``n_local * cap`` and adds zero."""
    t, D = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    n_local = E if n_local is None else n_local
    gates, eids = _router(x, router_w, cfg)
    eid_flat, pos_flat = _expert_slots(eids, E)
    keep = (eid_flat >= lo) & (eid_flat < lo + n_local) & (pos_flat < cap)
    slot = torch.where(keep, (eid_flat - lo) * cap + pos_flat, n_local * cap)
    tok_idx = torch.arange(t, device=x.device).repeat_interleave(k)
    # each kept slot is written once; only the discarded bucket row takes
    # duplicates (the reference adds into zeros, the same buffer)
    buf = x.new_zeros(n_local * cap + 1, D)
    buf[slot] = x[tok_idx]
    return buf[:-1].reshape(n_local, cap, D), slot, gates


def _moe_combine(y: torch.Tensor, slot: torch.Tensor, gates: torch.Tensor
                 ) -> torch.Tensor:
    """The experts' outputs y (n, cap, D) back to the tokens: each pair's
    slot row times its gate (the bucket row zero), a token's k outputs
    summed in k's order, in y's dtype, as the reference's scatter-add
    into zeros sums them; no atomics."""
    t, k = gates.shape
    D = y.shape[-1]
    y = torch.cat([y.reshape(-1, D), y.new_zeros(1, D)])
    y_pair = (y[slot] * gates.reshape(-1, 1).to(y.dtype)).reshape(t, k, D)
    out = y_pair[:, 0]
    for j in range(1, k):
        out = out + y_pair[:, j]
    return out


def _moe_local_a2a(x: torch.Tensor, router_w, w1, w2, *,
                   cfg: LMConfig) -> torch.Tensor:
    """The reference's ``_moe_local_a2a`` with one shard (no all-to-all):
    x (t, D) -> (t, D)."""
    cap = _capacity(x.shape[0], cfg.moe_top_k, cfg.n_experts,
                    cfg.capacity_factor)
    buf, slot, gates = _moe_dispatch(x, router_w, cfg, cap)
    return _moe_combine(_expert_ffn(buf, w1, w2, x.dtype), slot, gates)


def _expert_shards(ctx: ShardCtx, cfg: LMConfig, w1, w2):
    """The expert axis, its shard count and each logical id's experts'
    weights (on its device), as ``P(expert, None, None)`` splits them."""
    mesh, r = ctx.mesh, ctx.rules
    axis = r.expert
    n = mesh.shape[axis]
    if cfg.n_experts % n:
        raise ValueError(f"{cfg.n_experts} experts do not split over the "
                         f"{n} shards of mesh axis {axis!r}")
    spec = P(r.expert, None, None)
    return axis, n, shard_split(w1, mesh, spec), shard_split(w2, mesh, spec)


def _moe_mesh_a2a(x: torch.Tensor, router_w, w1, w2, *, cfg: LMConfig,
                  ctx: ShardCtx) -> torch.Tensor:
    """The reference's sequence-sharded MoE on a mesh (``shard_map`` over
    ``_moe_local_a2a`` with its two ``all_to_all``s), as stages: x (B, S,
    D) split ``P(batch, tensor, None)``; each shard routes its own tokens
    at a capacity from its own token count (so where pairs drop, this is
    another function than the one-device MoE, as the reference's is);
    the (E, cap, D) buffers re-split so each shard holds its E/n experts'
    slots from every shard of its group (E/n, n*cap, D); each shard's
    experts run on its device with its own weights; the outputs go back
    and each shard combines its tokens'."""
    mesh, r = ctx.mesh, ctx.rules
    axis, _, w1s, w2s = _expert_shards(ctx, cfg, w1, w2)
    x_spec = P(r.batch, r.tensor, None)
    xs = shard_split(x, mesh, x_spec)
    rws = shard_split(router_w, mesh, P(None, None))
    E, k = cfg.n_experts, cfg.moe_top_k

    def dispatch(sh, xl, rw):
        t = xl.shape[0] * xl.shape[1]
        cap = _capacity(t, k, E, cfg.capacity_factor)
        return _moe_dispatch(xl.reshape(t, -1), rw, cfg, cap)
    routed = per_shard(mesh, dispatch, xs, rws)
    bufs = all_to_all({i: d[0] for i, d in routed.items()}, mesh, axis,
                      split_axis=0, concat_axis=1)
    # each stage's buffers go as soon as the next stage holds its own
    # (E x cap x D a shard: gigabytes at full width)
    routed = {i: d[1:] for i, d in routed.items()}
    ys = per_shard(mesh, lambda sh, b, a, c: _expert_ffn(b, a, c, x.dtype),
                   bufs, w1s, w2s)
    del bufs
    ys = all_to_all(ys, mesh, axis, split_axis=1, concat_axis=0)
    outs = {i: _moe_combine(ys.pop(i), *d).reshape(xs[i].shape)
            for i, d in routed.items()}
    return shard_merge(outs, mesh, x_spec)


def _moe_mesh_replicated(x: torch.Tensor, router_w, w1, w2, *,
                         cfg: LMConfig, ctx: ShardCtx) -> torch.Tensor:
    """The reference's ``_moe_local_replicated`` on a mesh (decode): x
    (B, S, D) split ``P(batch, None, None)``, so every shard of an expert
    group sees the same tokens; each routes them at capacity t (a decode
    drops no pair), runs only its own E/n experts and combines their
    outputs; the partial outputs are summed over the expert axis in shard
    order (``psum``)."""
    mesh, r = ctx.mesh, ctx.rules
    axis, n, w1s, w2s = _expert_shards(ctx, cfg, w1, w2)
    x_spec = P(r.batch, None, None)
    xs = shard_split(x, mesh, x_spec)
    rws = shard_split(router_w, mesh, P(None, None))
    E, k = cfg.n_experts, cfg.moe_top_k
    e_loc = E // n

    def body(sh, xl, rw, a, c):
        t = xl.shape[0] * xl.shape[1]
        cap = min(t, _capacity(t, k, E, 1e9))
        buf, slot, gates = _moe_dispatch(xl.reshape(t, -1), rw, cfg, cap,
                                         lo=sh.axis_index(axis) * e_loc,
                                         n_local=e_loc)
        y = _expert_ffn(buf, a, c, x.dtype)
        return _moe_combine(y, slot, gates).reshape(xl.shape)
    outs = psum(per_shard(mesh, body, xs, rws, w1s, w2s), mesh, axis)
    return shard_merge(outs, mesh, x_spec)


def moe_block(x: torch.Tensor, router_w, w1, w2, shared_w1, shared_w2, *,
              cfg: LMConfig, ctx: ShardCtx = LOCAL_CTX,
              seq_sharded: bool = True) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D): routed experts, then the shared
    experts' SwiGLU (``shared_w1`` None: none).  Without a mesh the
    reference's local path (the same for prefill and decode).  On a mesh
    the experts are sharded over the ``expert`` axis: ``seq_sharded``
    (train, prefill) takes tokens sequence-sharded over it through the
    all-to-all dispatch (:func:`_moe_mesh_a2a`); False (decode) takes
    them replicated, each shard computing its own experts, the partial
    outputs summed (:func:`_moe_mesh_replicated`)."""
    B, S, D = x.shape
    if ctx.mesh is None:
        out = _moe_local_a2a(x.reshape(B * S, D), router_w, w1, w2,
                             cfg=cfg).reshape(B, S, D)
    else:
        fn = _moe_mesh_a2a if seq_sharded else _moe_mesh_replicated
        out = fn(x, router_w, w1, w2, cfg=cfg, ctx=ctx)
    if shared_w1 is not None:
        out = out + swiglu_ffn(x, shared_w1.to(x.dtype),
                               shared_w2.to(x.dtype))
    return out


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): the prefill expands c_kv; decode uses the absorbed
# form against the compressed cache (c_kv, k_pe)
# ---------------------------------------------------------------------------

def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, C) times w (C, H, n) -> (B, S, H, n) in x's dtype."""
    return (x @ w.reshape(w.shape[0], -1).to(x.dtype)).reshape(
        *x.shape[:2], w.shape[1], w.shape[2])


def mla_qkv(x: torch.Tensor, p, cfg: LMConfig, positions: torch.Tensor):
    """x (B, S, D), ``p["wq"]`` (D, H, qk), ``p["wuk"]`` (lora, H, nope),
    ``p["wuv"]`` (lora, H, v) -> q (B,S,H,qk_dim), k (B,S,H,qk_dim), v
    (B,S,H,v_dim) and the compressed (c_kv, k_pe) pair for the cache."""
    B, S, _ = x.shape
    H = cfg.n_heads
    nd, rd, lr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
    q = _heads(x, p["wq"])
    q_nope, q_pe = q[..., :nd], q[..., nd:]
    ckr = x @ p["wdkv"].to(x.dtype)
    c_kv, k_pe = ckr[..., :lr], ckr[..., lr:]
    c_kv = rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
    cos, sin = rope_tables(positions, rd, cfg.rope_theta)
    q_pe = apply_rope(q_pe, cos, sin)
    k_pe = apply_rope(k_pe[:, :, None, :], cos, sin)[:, :, 0]  # shared head
    k_nope = _heads(c_kv, p["wuk"])
    v = _heads(c_kv, p["wuv"])
    k = torch.cat([k_nope, k_pe[:, :, None].expand(B, S, H, rd)], dim=-1)
    qq = torch.cat([q_nope, q_pe], dim=-1)
    return qq, k, v, (c_kv, k_pe)


def mla_decode_absorbed(x: torch.Tensor, p, cfg: LMConfig,
                        ckv_cache: torch.Tensor, kpe_cache: torch.Tensor,
                        cache_len: torch.Tensor,
                        positions: torch.Tensor) -> torch.Tensor:
    """x: (B,1,D); caches (B,T,lora) / (B,T,rd) -> (B,1,H,v_dim).

    As in the reference: ``q`` absorbed through ``W_UK`` in f32, then
    ``q_t``, ``q_pe`` and the normalised probabilities rounded to the
    cache's dtype (to f32 on CPU tensors, where the reference also
    computes in f32), every product accumulated in f32 (the cache read in
    f32: a product of two bf16 values is exact there)."""
    nd, rd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = _heads(x, p["wq"])
    q_nope, q_pe = q[..., :nd], q[..., nd:]
    cos, sin = rope_tables(positions, rd, cfg.rope_theta)
    q_pe = apply_rope(q_pe, cos, sin)
    cdt = (torch.float32 if ckv_cache.device.type == "cpu"
           else ckv_cache.dtype)
    q_t = torch.einsum("bshn,chn->bshc", q_nope.float(),
                       p["wuk"].float()).to(cdt)
    scale = 1.0 / math.sqrt(nd + rd)
    ckv = ckv_cache.float()
    s = (torch.einsum("bshc,btc->bhst", q_t.float(), ckv)
         + torch.einsum("bshr,btr->bhst", q_pe.to(cdt).float(),
                        kpe_cache.float())) * scale
    T = ckv_cache.shape[1]
    valid = (torch.arange(T, device=x.device)[None]
             < cache_len[:, None])                           # (B, T)
    s = torch.where(valid[:, None, None], s, _NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    pr = torch.exp(s - m)
    l = torch.sum(pr, dim=-1, keepdim=True)
    o_c = torch.einsum("bhst,btc->bshc",
                       (pr / torch.clamp(l, min=1e-30)).to(cdt).float(), ckv)
    o = torch.einsum("bshc,chv->bshv", o_c, p["wuv"].float())
    return o.to(x.dtype)
