"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B]: MoE 128 experts top-8, GQA kv=4."""

from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="qwen3-moe-30b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=128,
    d_ff=768,            # per-expert intermediate
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe=True,
    n_experts=128,
    n_shared_experts=0,
    moe_top_k=8,
    moe_d_ff=768,
)

REDUCED = LMConfig(
    name="qwen3-moe-reduced",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_head=32,
    d_ff=64,
    vocab_size=512,
    qk_norm=True,
    moe=True,
    n_experts=8,
    n_shared_experts=0,
    moe_top_k=2,
    moe_d_ff=64,
)
