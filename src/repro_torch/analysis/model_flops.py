"""Analytic "useful work" (MODEL_FLOPS) per (arch x shape) cell: the
port of the JAX package's ``analysis/model_flops.py``, pure arithmetic on
the port's configs.

LM convention: 6·N·D for training (N = params, D = tokens; MoE uses
N_active), plus the causal-attention term 12·L·H·dh·S per token /2 (causal)
— MaxText-style MFU accounting.  Forward-only passes are 1/3 of train.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import GNNConfig, LMConfig, RecsysConfig


def _lm_attn_fwd_flops(cfg: LMConfig, B: int, S: int) -> float:
    # scores + values: 2 * 2 * H*dh * S^2/2 (causal) per layer
    if cfg.mla:
        d_qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        per_layer = 2.0 * B * S * S / 2 * cfg.n_heads * (d_qk
                                                         + cfg.v_head_dim)
    else:
        per_layer = 4.0 * B * S * S / 2 * cfg.n_heads * cfg.d_head
    return cfg.n_layers * per_layer


def lm_model_flops(cfg: LMConfig, step: str, dims: Dict[str, int]) -> float:
    B, S = dims["global_batch"], dims["seq_len"]
    n_active = cfg.n_active_params()
    if step == "train_step":
        return 6.0 * n_active * B * S + 3.0 * _lm_attn_fwd_flops(cfg, B, S)
    if step == "prefill":
        return 2.0 * n_active * B * S + _lm_attn_fwd_flops(cfg, B, S)
    # decode: 1 token per sequence; attention reads the whole cache
    if cfg.mla:
        attn = cfg.n_layers * B * S * (
            2.0 * cfg.n_heads * cfg.kv_lora_rank * 2
            + 2.0 * cfg.n_heads * cfg.qk_rope_head_dim)
    else:
        attn = cfg.n_layers * B * S * 4.0 * cfg.n_heads * cfg.d_head
    return 2.0 * n_active * B + attn


def gnn_model_flops(cfg: GNNConfig, shape_id: str,
                    dims: Dict[str, int]) -> float:
    d_feat = dims.get("d_feat", cfg.d_feat)
    n_classes = dims.get("n_classes", cfg.n_classes)
    dh = cfg.d_hidden
    if shape_id == "minibatch_lg":
        B = dims["batch_nodes"]
        f0, f1 = dims["fanout0"], dims["fanout1"]
        n_l1 = B * (1 + f0)                    # nodes transformed at layer 1
        fwd = (2.0 * n_l1 * 2 * d_feat * dh    # self+neigh matmuls
               + 2.0 * B * 2 * dh * n_classes
               + 2.0 * B * f0 * f1 * d_feat)   # aggregation adds
        return 3.0 * fwd
    n_nodes = dims["n_nodes"] * dims.get("batch", 1)
    n_edges = dims["n_edges"] * dims.get("batch", 1)
    fwd = (2.0 * n_nodes * 2 * d_feat * dh
           + 2.0 * n_nodes * 2 * dh * n_classes
           + 2.0 * n_edges * (d_feat + dh))    # two rounds of segment_sum
    return 3.0 * fwd


def recsys_model_flops(cfg: RecsysConfig, step: str,
                       dims: Dict[str, int]) -> float:
    B = dims.get("batch", 1)
    d = cfg.embed_dim

    def mlp_flops(dims_list, batch):
        return sum(2.0 * batch * a * b
                   for a, b in zip(dims_list[:-1], dims_list[1:]))

    if cfg.kind == "dlrm":
        n_f = cfg.n_sparse + 1
        top = [n_f * (n_f - 1) // 2 + d] + list(cfg.top_mlp)
        fwd = (mlp_flops(list(cfg.bot_mlp), B) + mlp_flops(top, B)
               + 2.0 * B * n_f * n_f * d          # dot interaction
               + B * cfg.n_sparse * cfg.multi_hot * d)  # bag reduce
    elif cfg.kind == "wide_deep":
        deep = [cfg.n_sparse * d] + list(cfg.mlp) + [1]
        fwd = mlp_flops(deep, B) + B * cfg.n_sparse * (d + 1)
    elif cfg.kind == "bert4rec":
        S, db = cfg.seq_len, cfg.embed_dim
        per_blk = (2.0 * B * S * db * 3 * db + 2.0 * B * S * db * db
                   + 4.0 * B * S * db * 4 * db
                   + 4.0 * B * S * S * db)
        fwd = cfg.n_blocks * per_blk
    else:                                        # mind
        Lh, K = cfg.hist_len, cfg.n_interests
        fwd = (2.0 * B * Lh * d * d              # bilinear
               + cfg.capsule_iters * 4.0 * B * K * Lh * d
               + mlp_flops([d, 2 * d, d], B * K))
    if step == "train_step":
        n_neg = 128
        fwd += 2.0 * B * n_neg * d
        return 3.0 * fwd
    if step == "retrieval":
        return 2.0 * B * dims["n_candidates"] * d
    if cfg.kind in ("bert4rec", "mind"):
        fwd += 2.0 * B * cfg.vocab_size * d      # score all items
    return fwd


def model_flops(cfg, step: str, shape_id: str, dims: Dict[str, int]) -> float:
    if isinstance(cfg, LMConfig):
        return lm_model_flops(cfg, step, dims)
    if isinstance(cfg, GNNConfig):
        return gnn_model_flops(cfg, shape_id, dims)
    if isinstance(cfg, RecsysConfig):
        return recsys_model_flops(cfg, step, dims)
    raise TypeError(type(cfg))
