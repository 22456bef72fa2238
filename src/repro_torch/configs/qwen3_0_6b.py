"""Qwen3-0.6B [hf:Qwen/Qwen3 family]: GQA kv=8, qk_norm (per-head RMSNorm)."""

from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="qwen3-0.6b",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

REDUCED = LMConfig(
    name="qwen3-0.6b-reduced",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_head=32,
    d_ff=384,
    vocab_size=512,
    qk_norm=True,
    tie_embeddings=True,
)
