"""Qwen1.5-4B [hf:Qwen/Qwen1.5-4B family]: dense, MHA (kv=heads), QKV bias."""

from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="qwen1.5-4b",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_head=128,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=5_000_000.0,
)

REDUCED = LMConfig(
    name="qwen1.5-4b-reduced",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_head=32,
    d_ff=352,
    vocab_size=512,
    qkv_bias=True,
)
