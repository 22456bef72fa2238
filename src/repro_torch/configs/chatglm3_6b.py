"""ChatGLM3-6B [arXiv:2406.12793]: GQA kv=2, 2D RoPE (half dims), QKV bias."""

from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="chatglm3-6b",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_head=128,
    d_ff=13696,
    vocab_size=65024,
    qkv_bias=True,
    rope_fraction=0.5,   # GLM applies rotary to half of each head's dims
)

REDUCED = LMConfig(
    name="chatglm3-6b-reduced",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_head=32,
    d_ff=416,
    vocab_size=512,
    qkv_bias=True,
    rope_fraction=0.5,
)
