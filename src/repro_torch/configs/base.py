"""Config dataclasses and the (arch x shape) cell definitions: the port's
copy of the JAX package's ``configs/base.py``, pure data.

Every architecture has a module ``repro_torch.configs.<arch_id>`` that
exports ``CONFIG`` (the full published config) and ``REDUCED`` (a tiny
config of the same family for CPU tests); ``repro_torch.configs.registry``
maps the ``--arch`` ids to them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    qkv_bias: bool = False
    qk_norm: bool = False
    # Fraction of head dims that receive rotary embedding (ChatGLM "2d" RoPE
    # rotates only the first half of each head).
    rope_fraction: float = 1.0
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    first_k_dense: int = 0          # deepseek: first k layers use dense FFN
    dense_d_ff: int = 0             # d_ff of those dense layers
    router_scale: float = 1.0       # deepseek routed_scaling_factor
    # --- MLA ---
    mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    @property
    def is_gqa(self) -> bool:
        return self.n_kv_heads < self.n_heads

    def n_params(self) -> int:
        """Analytic parameter count (used for 6*N*D model FLOPs)."""
        d, H, Hk, dh, L, V = (self.d_model, self.n_heads, self.n_kv_heads,
                              self.d_head, self.n_layers, self.vocab_size)
        if self.mla:
            qk_d = self.qk_nope_head_dim + self.qk_rope_head_dim
            attn = (d * H * qk_d                      # W_Q
                    + d * (self.kv_lora_rank + self.qk_rope_head_dim)  # W_DKV
                    + self.kv_lora_rank * H * (self.qk_nope_head_dim
                                               + self.v_head_dim)      # W_UK/UV
                    + H * self.v_head_dim * d)        # W_O
        else:
            attn = d * (H + 2 * Hk) * dh + H * dh * d
            if self.qkv_bias:
                attn += (H + 2 * Hk) * dh
        per_layer = attn
        if self.moe:
            moe_layers = L - self.first_k_dense
            ffn_moe = 3 * d * self.moe_d_ff * (self.n_experts
                                               + self.n_shared_experts)
            router = d * self.n_experts
            dense_ff = self.dense_d_ff or self.d_ff
            total_ffn = (moe_layers * (ffn_moe + router)
                         + self.first_k_dense * 3 * d * dense_ff)
        else:
            total_ffn = L * 3 * d * self.d_ff
        total = L * per_layer + total_ffn + 2 * V * d + (2 * L + 1) * d
        return int(total)

    def n_active_params(self) -> int:
        """Activated params per token (MoE: only routed top-k + shared)."""
        if not self.moe:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        moe_layers = L - self.first_k_dense
        full = self.n_params()
        all_experts = moe_layers * 3 * d * self.moe_d_ff * self.n_experts
        active = moe_layers * 3 * d * self.moe_d_ff * self.moe_top_k
        return int(full - all_experts + active)


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int = 2
    d_hidden: int = 128
    aggregator: str = "mean"
    sample_sizes: Tuple[int, ...] = (25, 10)
    d_feat: int = 602
    n_classes: int = 41


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    kind: str                       # dlrm | wide_deep | bert4rec | mind
    embed_dim: int
    n_sparse: int = 0
    vocab_size: int = 1_000_000     # rows per sparse table (or item vocab)
    n_dense: int = 0
    bot_mlp: Tuple[int, ...] = ()
    top_mlp: Tuple[int, ...] = ()
    mlp: Tuple[int, ...] = ()
    interaction: str = "dot"
    # bert4rec
    n_blocks: int = 0
    n_heads: int = 0
    seq_len: int = 0
    # mind
    n_interests: int = 0
    capsule_iters: int = 0
    hist_len: int = 50
    multi_hot: int = 1              # ids per sparse field (embedding bag size)


@dataclasses.dataclass(frozen=True)
class ANNSConfig:
    """FusionANNS index configuration (paper §4)."""

    name: str
    n_vectors: int
    dim: int
    dtype: str = "float32"           # raw vector dtype on the SSD tier
    pq_m: int = 32                   # sub-spaces (bytes per PQ code)
    pq_nbits: int = 8                # 256 centroids / sub-space
    n_posting_fraction: float = 0.10 # posting lists = 10% of N (paper §4.1)
    replication_eps: float = 0.10    # Eq. 2 epsilon
    max_replicas: int = 8            # paper: each vector in <= 8 clusters
    graph_degree: int = 32           # navigation graph out-degree
    top_m: int = 64                  # nearest posting lists per query
    top_n: int = 256                 # candidates sent to re-ranking
    top_k: int = 10                  # final neighbours
    rerank_batch: int = 32           # mini-batch size (Alg. 1 BatchSize)
    rerank_eps: float = 0.05         # Alg. 1 epsilon (change-rate threshold)
    rerank_beta: int = 2             # Alg. 1 beta (stability count)
    page_bytes: int = 4096           # SSD page
    dram_buffer_pages: int = 1024    # per-query DRAM page buffer


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (architecture x input-shape) dry-run cell."""

    shape_id: str
    step: str                      # train_step | prefill | serve_step | forward
    dims: Dict[str, int]


LM_SHAPES = (
    ShapeCell("train_4k", "train_step", dict(seq_len=4096, global_batch=256)),
    ShapeCell("prefill_32k", "prefill", dict(seq_len=32768, global_batch=32)),
    ShapeCell("decode_32k", "serve_step", dict(seq_len=32768, global_batch=128)),
    ShapeCell("long_500k", "serve_step", dict(seq_len=524288, global_batch=1)),
)

GNN_SHAPES = (
    ShapeCell("full_graph_sm", "train_step",
              dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7)),
    ShapeCell("minibatch_lg", "train_step",
              dict(n_nodes=232965, n_edges=114615892, batch_nodes=1024,
                   fanout0=15, fanout1=10, d_feat=602, n_classes=41)),
    ShapeCell("ogb_products", "train_step",
              dict(n_nodes=2449029, n_edges=61859140, d_feat=100,
                   n_classes=47)),
    ShapeCell("molecule", "train_step",
              dict(n_nodes=30, n_edges=64, batch=128, d_feat=16, n_classes=2)),
)

RECSYS_SHAPES = (
    ShapeCell("train_batch", "train_step", dict(batch=65536)),
    ShapeCell("serve_p99", "serve_step", dict(batch=512)),
    ShapeCell("serve_bulk", "serve_step", dict(batch=262144)),
    ShapeCell("retrieval_cand", "retrieval", dict(batch=1, n_candidates=1_000_000)),
)


def shapes_for(cfg: Any) -> Tuple[ShapeCell, ...]:
    if isinstance(cfg, LMConfig):
        return LM_SHAPES
    if isinstance(cfg, GNNConfig):
        return GNN_SHAPES
    if isinstance(cfg, RecsysConfig):
        return RECSYS_SHAPES
    raise TypeError(f"no shapes for {type(cfg)}")
