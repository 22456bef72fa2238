"""DeepSeek-V2-Lite (16B total / 2.4B active) [arXiv:2405.04434].

MLA: kv_lora_rank=512, qk_nope=128, qk_rope=64, v_head=128, 16 heads.
MoE: 64 routed experts top-6 + 2 shared (assignment header says "MoE 64e
top-6"; the parenthetical "160 routed" matches full V2, not Lite — we follow
the primary 64e spec and arXiv:2405.04434 Lite appendix), moe_d_ff=1408,
first layer dense with d_ff=10944.
"""

from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    name="deepseek-v2-lite-16b",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,
    vocab_size=102400,
    mla=True,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    moe=True,
    n_experts=64,
    n_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1408,
    first_k_dense=1,
    dense_d_ff=10944,
)

REDUCED = LMConfig(
    name="deepseek-v2-lite-reduced",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_head=32,
    d_ff=96,
    vocab_size=512,
    mla=True,
    kv_lora_rank=64,
    qk_nope_head_dim=32,
    qk_rope_head_dim=16,
    v_head_dim=32,
    moe=True,
    n_experts=8,
    n_shared_experts=1,
    moe_top_k=2,
    moe_d_ff=96,
    first_k_dense=1,
    dense_d_ff=256,
)
