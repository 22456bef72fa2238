"""RecSys architectures: DLRM, Wide&Deep, BERT4Rec, MIND (the port's
counterpart of the JAX package's ``models/recsys.py``).

* The embedding lookup is the hot path.  Every row gather goes through
  ``layers.gather_rows``, whose backward sums each id's gradient rows in
  a fixed order (the reference's scatter-add; on the card the backward
  of ``table[ids]`` adds with atomics in no fixed order).
  :func:`embedding_bag_ragged` is
  a gather, then a segment reduction in a fixed order
  (``layers.segment_reduce``): the reference's ``jax.ops.segment_*``
  semantics, which ``F.embedding_bag`` does not have (an empty bag's max
  is -inf there, not 0; segment ids may come in any order; ids past
  ``n_bags`` are dropped).  :func:`embedding_bag_dense` is the fixed
  multi-hot fast path; with ``gather_dtype`` it gathers the rows first and
  rounds them after, the same values as rounding the table first, without
  a copy of DLRM's 7 GB of tables on every call, and sums their gradient
  in that dtype, as the reference's scatter into the rounded table does.
* BERT4Rec's attention is ``layers.blockwise_attention(causal=False)``:
  the flash kernel on the card (``flash_attn_fwd_tf32[32]``, the narrow
  instance, at its head width 32 in f32, reading the q, k and v split
  from the block's product as they lie), the plain scan on the CPU.
* :func:`score_all_items` is a bf16 product (cuBLAS, as the reference's
  is XLA's) and a top-k that gives ties to the lowest id, as
  ``lax.top_k`` does (``core.topk._select``, a stable sort); on a mesh
  the reference's two-level ``core.topk.sharded_topk`` over the item
  shards (each shard's top k on its logical device, the pairs merged in
  shard order: the same ids).
* f32 products run in full f32 (TF32 off: ``clustering.full_f32``).
* On a mesh the forwards are the reference's: its sharding constraints
  (``ctx.constrain``) check their specs and change no value; the
  ``*_param_specs`` are its layouts (tables row-sharded over ``corpus``,
  or over ``tensor`` for bulk serving; MLPs replicated).

Parameters are nested dicts and lists of tensors, drawn by an explicit
``torch.Generator`` (other numbers than ``jax.random``'s: carry the
reference's across with ``transformer.params_from_numpy``).  Not ported:
the reference's ``REPRO_OPT_RECSYS`` switch (the port keeps its default,
bf16 gathers from B >= 16,384, and the tensor-axis table layout of bulk
serving that goes with it).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RecsysConfig
from repro_torch.core.clustering import full_f32
from repro_torch.core.engine import resolve_device
from repro_torch.core.topk import _select, sharded_topk
from repro_torch.models.layers import (LOCAL_CTX, ShardCtx,
                                       blockwise_attention, gather_rows,
                                       rms_norm, segment_order,
                                       segment_reduce)
from repro_torch.models.transformer import _normal
from repro_torch.sharding.spec import P, Rules

BULK_GATHER_BATCH = 16384   # bf16 gathers from this batch on (recsys.py:147)


def _ids(x, device: torch.device) -> torch.Tensor:
    """Ids (numpy or tensor) as int64 on ``device``."""
    return torch.as_tensor(x, device=device).long()


# ---------------------------------------------------------------------------
# EmbeddingBag
# ---------------------------------------------------------------------------

def embedding_bag_ragged(table: torch.Tensor, flat_ids, segment_ids,
                         n_bags: int, mode: str = "mean") -> torch.Tensor:
    """EmbeddingBag over ragged bags: table (V, d), flat_ids (L,) and
    segment_ids (L,), the bag of each id -> (n_bags, d).  ``sum``,
    ``mean`` (an empty bag 0) or ``max`` (an empty bag -inf)."""
    dev = table.device
    seg = _ids(segment_ids, dev)
    rows = gather_rows(table, _ids(flat_ids, dev))             # (L, d)
    if mode == "sum":
        return segment_reduce(rows, seg, n_bags)
    if mode == "mean":
        order = segment_order(seg, n_bags)
        s = segment_reduce(rows, None, n_bags, order=order)
        c = order[1].to(rows.dtype)            # each bag's count of ids
        return s / torch.clamp(c, min=1.0)[:, None]
    if mode == "max":
        return segment_reduce(rows, seg, n_bags, "max")
    raise ValueError(mode)


def embedding_bag_dense(tables: torch.Tensor, ids, mode: str = "mean",
                        gather_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """Fixed multi-hot fast path: tables (T, V, d), ids (B, T, M) ->
    (B, T, d).  ``gather_dtype`` rounds the gathered rows to it (the
    reference rounds the table first: the same values) and sums their
    gradient in it, as the reference's scatter into the rounded table
    does (``layers.gather_rows``)."""
    T, V, d = tables.shape
    ids = _ids(ids, tables.device)
    flat = ids + V * torch.arange(T, device=ids.device)[None, :, None]
    gathered = gather_rows(tables.reshape(T * V, d), flat,
                           gather_dtype)                      # (B, T, M, d)
    if mode == "sum":
        return gathered.sum(dim=2)
    if mode == "mean":
        return gathered.mean(dim=2)
    raise ValueError(mode)


def _mlp_init(gen: torch.Generator, dims, device: torch.device
              ) -> List[Dict[str, torch.Tensor]]:
    return [{"w": _normal(gen, (dims[i], dims[i + 1]),
                          1.0 / math.sqrt(dims[i]), device),
             "b": torch.zeros((dims[i + 1],), dtype=torch.float32,
                              device=device)}
            for i in range(len(dims) - 1)]


def _mlp_specs(dims, r: Rules):
    """Ranking MLPs are small (<= 1024 wide) with awkward widths (13,
    415, ...): replicated; the embedding tables carry the memory and are
    sharded."""
    return [{"w": P(None, None), "b": P(None)} for _ in range(len(dims) - 1)]


def _table_rows(r: Rules, bulk_serving: bool):
    """The tables' row axes: ``tensor`` for bulk serving (small
    all-reduce groups for the lookup), ``corpus`` otherwise."""
    return r.tensor if bulk_serving else r.corpus


def _mlp_apply(layers, x: torch.Tensor, final_act=None) -> torch.Tensor:
    for i, p in enumerate(layers):
        x = x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)
        if i < len(layers) - 1:
            x = F.relu(x)
        elif final_act is not None:
            x = final_act(x)
    return x


# ---------------------------------------------------------------------------
# DLRM [arXiv:1906.00091]
# ---------------------------------------------------------------------------

def _dlrm_top_dims(cfg: RecsysConfig):
    """Top-MLP input: the pairwise dots among (bottom output + n_sparse)
    features, then the bottom output (MLPerf DLRM)."""
    n_f = cfg.n_sparse + 1
    return [n_f * (n_f - 1) // 2 + cfg.embed_dim] + list(cfg.top_mlp)


def init_dlrm(gen: torch.Generator, cfg: RecsysConfig,
              device=None) -> Dict[str, Any]:
    dev = resolve_device(device)
    return {
        "tables": _normal(gen, (cfg.n_sparse, cfg.vocab_size,
                                cfg.embed_dim), 0.05, dev),
        "bot": _mlp_init(gen, list(cfg.bot_mlp), dev),
        "top": _mlp_init(gen, _dlrm_top_dims(cfg), dev),
    }


def dlrm_param_specs(cfg: RecsysConfig, r: Rules,
                     bulk_serving: bool = False):
    """Bulk serving reshards the tables to the tensor axis; training keeps
    them corpus-sharded (the reference's iteration C2b)."""
    return {
        "tables": P(None, _table_rows(r, bulk_serving), None),
        "bot": _mlp_specs(list(cfg.bot_mlp), r),
        "top": _mlp_specs(_dlrm_top_dims(cfg), r),
    }


def dlrm_forward(params, dense, sparse_ids, cfg: RecsysConfig,
                 ctx: ShardCtx = LOCAL_CTX) -> torch.Tensor:
    """dense (B, 13) f32; sparse_ids (B, 26, M) -> logit (B,)."""
    dev = params["tables"].device
    dense = torch.as_tensor(dense, device=dev)
    with full_f32:
        x = _mlp_apply(params["bot"], dense)                   # (B, d)
        gdt = (torch.bfloat16 if sparse_ids.shape[0] >= BULK_GATHER_BATCH
               else None)
        emb = embedding_bag_dense(params["tables"], sparse_ids,
                                  gather_dtype=gdt).to(x.dtype)
        emb = ctx.constrain(emb, "batch", None, None)
        feats = torch.cat([x[:, None], emb], dim=1)            # (B, F, d)
        inter = torch.bmm(feats, feats.transpose(1, 2))        # (B, F, F)
        iu, ju = torch.triu_indices(feats.shape[1], feats.shape[1], 1,
                                    device=dev)
        top_in = torch.cat([x, inter[:, iu, ju]], dim=-1)
        return _mlp_apply(params["top"], top_in)[:, 0]


# ---------------------------------------------------------------------------
# Wide & Deep [arXiv:1606.07792]
# ---------------------------------------------------------------------------

def init_wide_deep(gen: torch.Generator, cfg: RecsysConfig,
                   device=None) -> Dict[str, Any]:
    dev = resolve_device(device)
    deep_dims = [cfg.n_sparse * cfg.embed_dim] + list(cfg.mlp) + [1]
    return {
        "tables": _normal(gen, (cfg.n_sparse, cfg.vocab_size,
                                cfg.embed_dim), 0.05, dev),
        "wide": _normal(gen, (cfg.n_sparse, cfg.vocab_size, 1), 0.01, dev),
        "deep": _mlp_init(gen, deep_dims, dev),
        "bias": torch.zeros((), dtype=torch.float32, device=dev),
    }


def wide_deep_param_specs(cfg: RecsysConfig, r: Rules,
                          bulk_serving: bool = False):
    rows = _table_rows(r, bulk_serving)
    deep_dims = [cfg.n_sparse * cfg.embed_dim] + list(cfg.mlp) + [1]
    return {
        "tables": P(None, rows, None),
        "wide": P(None, rows, None),
        "deep": _mlp_specs(deep_dims, r),
        "bias": P(),
    }


def wide_deep_forward(params, sparse_ids, cfg: RecsysConfig,
                      ctx: ShardCtx = LOCAL_CTX) -> torch.Tensor:
    """sparse_ids (B, T, M) -> logit (B,)."""
    B = sparse_ids.shape[0]
    gdt = torch.bfloat16 if B >= BULK_GATHER_BATCH else None
    with full_f32:
        emb = embedding_bag_dense(params["tables"], sparse_ids,
                                  gather_dtype=gdt)
        emb = ctx.constrain(emb, "batch", None, None).float()
        deep = _mlp_apply(params["deep"], emb.reshape(B, -1))[:, 0]
        wide = embedding_bag_dense(params["wide"], sparse_ids,
                                   mode="sum").float().sum(dim=(1, 2))
        return deep + wide + params["bias"].to(deep.dtype)


# ---------------------------------------------------------------------------
# BERT4Rec [arXiv:1904.06690]
# ---------------------------------------------------------------------------

def init_bert4rec(gen: torch.Generator, cfg: RecsysConfig,
                  device=None) -> Dict[str, Any]:
    dev = resolve_device(device)
    d, std = cfg.embed_dim, 0.02

    def ones():
        return torch.ones((d,), dtype=torch.float32, device=dev)
    item = _normal(gen, (cfg.vocab_size, d), std, dev)
    pos = _normal(gen, (cfg.seq_len, d), std, dev)
    blocks = [{"ln1": ones(), "ln2": ones(),
               "wqkv": _normal(gen, (d, 3 * d), std, dev),
               "wo": _normal(gen, (d, d), std, dev),
               "wi": _normal(gen, (d, 4 * d), std, dev),
               "wof": _normal(gen, (4 * d, d), std, dev)}
              for _ in range(cfg.n_blocks)]
    return {"item_embed": item, "pos_embed": pos, "final_ln": ones(),
            "blocks": blocks}


def bert4rec_param_specs(cfg: RecsysConfig, r: Rules):
    blk = {"ln1": P(None), "ln2": P(None), "wqkv": P(None, None),
           "wo": P(None, None), "wi": P(None, None), "wof": P(None, None)}
    return {"item_embed": P(r.corpus, None), "pos_embed": P(None, None),
            "final_ln": P(None),
            "blocks": [dict(blk) for _ in range(cfg.n_blocks)]}


def bert4rec_encode(params, item_ids, cfg: RecsysConfig,
                    ctx: ShardCtx = LOCAL_CTX,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """item_ids (B, S) -> the sequence's representation (B, S, d), through
    bidirectional blocks."""
    ids = _ids(item_ids, params["item_embed"].device)
    B, S = ids.shape
    d, H = cfg.embed_dim, cfg.n_heads
    with full_f32:
        x = (gather_rows(params["item_embed"], ids)
             + params["pos_embed"][None, :S]).to(dtype)
        x = ctx.constrain(x, "batch", None, None)
        for p in params["blocks"]:
            h = rms_norm(x, p["ln1"])
            qkv = (h @ p["wqkv"].to(dtype)).reshape(B, S, 3 * H, d // H)
            q, k, v = torch.split(qkv, H, dim=2)
            a = blockwise_attention(q, k, v, causal=False,
                                    block_size=min(512, S))
            x = x + a.reshape(B, S, d) @ p["wo"].to(dtype)
            h = rms_norm(x, p["ln2"])
            # jax.nn.gelu's default is the tanh approximation
            x = x + F.gelu(h @ p["wi"].to(dtype),
                           approximate="tanh") @ p["wof"].to(dtype)
        return rms_norm(x, params["final_ln"])


def _sampled_softmax(logits: torch.Tensor):
    loss = torch.mean(torch.logsumexp(logits, -1) - logits[:, 0])
    acc = torch.mean((torch.argmax(logits, -1) == 0).float())
    return loss, {"loss": loss, "accuracy": acc}


def bert4rec_sampled_loss(params, item_ids, mask_pos, pos_items, neg_items,
                          cfg: RecsysConfig, ctx: ShardCtx = LOCAL_CTX):
    """Sampled-softmax masked-item loss: mask_pos (B,) the masked
    position, pos_items (B,), neg_items (B, n_neg)."""
    h = bert4rec_encode(params, item_ids, cfg, ctx)            # (B, S, d)
    dev = h.device
    hm = h[torch.arange(h.shape[0], device=dev), _ids(mask_pos, dev)]
    cand = torch.cat([_ids(pos_items, dev)[:, None], _ids(neg_items, dev)],
                     dim=1)
    ce = gather_rows(params["item_embed"], cand).to(h.dtype)   # (B, N, d)
    with full_f32:
        logits = torch.einsum("bd,bnd->bn", hm, ce).float()
    return _sampled_softmax(logits)


def bert4rec_user_embedding(params, item_ids, cfg: RecsysConfig,
                            ctx: ShardCtx = LOCAL_CTX) -> torch.Tensor:
    return bert4rec_encode(params, item_ids, cfg, ctx)[:, -1]  # (B, d)


# ---------------------------------------------------------------------------
# MIND [arXiv:1904.08030]: multi-interest capsule routing
# ---------------------------------------------------------------------------

def init_mind(gen: torch.Generator, cfg: RecsysConfig,
              device=None) -> Dict[str, Any]:
    dev = resolve_device(device)
    d = cfg.embed_dim
    return {
        "item_embed": _normal(gen, (cfg.vocab_size, d), 0.02, dev),
        "bilinear": _normal(gen, (d, d), 1.0 / math.sqrt(d), dev),
        "proj": _mlp_init(gen, [d, 2 * d, d], dev),
    }


def mind_param_specs(cfg: RecsysConfig, r: Rules):
    return {"item_embed": P(r.corpus, None), "bilinear": P(None, None),
            "proj": _mlp_specs([cfg.embed_dim, 2 * cfg.embed_dim,
                                cfg.embed_dim], r)}


def _squash(z: torch.Tensor) -> torch.Tensor:
    n2 = torch.sum(torch.square(z), dim=-1, keepdim=True)
    return (n2 / (1.0 + n2)) * z / torch.sqrt(n2 + 1e-9)


def mind_interests(params, hist_ids, cfg: RecsysConfig,
                   ctx: ShardCtx = LOCAL_CTX) -> torch.Tensor:
    """hist_ids (B, L) -> interest capsules (B, K, d), by dynamic
    routing (``capsule_iters`` rounds, the reference's ``lax.scan``)."""
    e = gather_rows(params["item_embed"],
                    _ids(hist_ids, params["item_embed"].device))
    e = ctx.constrain(e, "batch", None, None)
    B, Lh, _ = e.shape
    with full_f32:
        eS = e @ params["bilinear"].to(e.dtype)                # (B, L, d)
        b = torch.zeros((B, cfg.n_interests, Lh), dtype=e.dtype,
                        device=e.device)
        u = None
        for _ in range(cfg.capsule_iters):
            c = torch.softmax(b, dim=1)                        # over K
            u = _squash(torch.einsum("bkl,bld->bkd", c, eS))
            b = b + torch.einsum("bkd,bld->bkl", u, eS)
        return _mlp_apply(params["proj"], u)


def mind_sampled_loss(params, hist_ids, pos_items, neg_items,
                      cfg: RecsysConfig, ctx: ShardCtx = LOCAL_CTX,
                      pow_p: float = 2.0):
    """Sampled softmax over the positive and ``n_neg`` negatives, each
    candidate attending over the interests (label-aware attention)."""
    interests = mind_interests(params, hist_ids, cfg, ctx)     # (B, K, d)
    dev = interests.device
    cand = torch.cat([_ids(pos_items, dev)[:, None], _ids(neg_items, dev)],
                     dim=1)
    ce = gather_rows(params["item_embed"], cand)               # (B, N, d)
    with full_f32:
        att = torch.einsum("bkd,bnd->bkn", interests, ce)
        w = torch.softmax(torch.pow(torch.clamp(att, min=0.0) + 1e-6,
                                    pow_p), dim=1)
        user = torch.einsum("bkn,bkd->bnd", w, interests)      # (B, N, d)
        logits = torch.sum(user * ce, dim=-1).float()
    return _sampled_softmax(logits)


# ---------------------------------------------------------------------------
# Shared serving / retrieval heads
# ---------------------------------------------------------------------------

def score_all_items(user_emb: torch.Tensor, item_table: torch.Tensor,
                    k: int, ctx: ShardCtx = LOCAL_CTX, shard_axes=None):
    """user_emb (B, d) x item_table (V, d) -> the top k (values (B, k)
    bf16, ids (B, k) int32): a bf16 product, then the largest k, equal
    scores in ascending id (``lax.top_k``'s order).  On a mesh the (B, V)
    scores are split ``P(batch, shard_axes)`` (default: the ``tensor``
    axis; batch already takes the data axes) and reduced by the
    two-level ``sharded_topk``: only k pairs a shard move."""
    scores = user_emb.to(torch.bfloat16) @ item_table.to(torch.bfloat16).T
    if ctx.mesh is not None:
        axes = shard_axes if shard_axes is not None else ctx.rules.tensor
        scores = ctx.constrain(scores, "batch", "tensor")
        vals, ids = sharded_topk(scores, k, ctx, shard_axes=axes)
        return vals, ids.int()
    vals, ids = _select(scores, k, True)
    # a copy, so the sorted (B, V) buffer is not kept alive by a view
    return vals.contiguous(), ids.int()


def bce_loss(logits: torch.Tensor, labels):
    """Binary cross entropy on logits, and the accuracy at 0."""
    logits = logits.float()
    labels = torch.as_tensor(labels, device=logits.device).float()
    loss = torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))
    acc = torch.mean(((logits > 0) == (labels > 0.5)).float())
    return loss, {"loss": loss, "accuracy": acc}
