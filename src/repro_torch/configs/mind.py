"""MIND [arXiv:1904.08030]: multi-interest capsule network, 4 interests."""

from repro_torch.configs.base import RecsysConfig

CONFIG = RecsysConfig(
    name="mind",
    kind="mind",
    embed_dim=64,
    n_interests=4,
    capsule_iters=3,
    hist_len=50,
    vocab_size=1_048_576,  # 2^20 (~10^6 rows, mesh-divisible)
    interaction="multi-interest",
)

REDUCED = RecsysConfig(
    name="mind-reduced",
    kind="mind",
    embed_dim=16,
    n_interests=2,
    capsule_iters=2,
    hist_len=8,
    vocab_size=512,
    interaction="multi-interest",
)
