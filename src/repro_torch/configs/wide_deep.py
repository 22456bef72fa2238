"""Wide&Deep [arXiv:1606.07792]: 40 sparse fields, embed 32, MLP 1024-512-256."""

from repro_torch.configs.base import RecsysConfig

CONFIG = RecsysConfig(
    name="wide-deep",
    kind="wide_deep",
    embed_dim=32,
    n_sparse=40,
    vocab_size=1_048_576,  # 2^20 (~10^6 rows, mesh-divisible)
    mlp=(1024, 512, 256),
    interaction="concat",
    multi_hot=1,
)

REDUCED = RecsysConfig(
    name="wide-deep-reduced",
    kind="wide_deep",
    embed_dim=8,
    n_sparse=6,
    vocab_size=512,
    mlp=(64, 32),
    interaction="concat",
    multi_hot=1,
)
