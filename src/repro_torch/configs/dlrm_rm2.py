"""DLRM-RM2 [arXiv:1906.00091]: 13 dense + 26 sparse, dot interaction."""

from repro_torch.configs.base import RecsysConfig

CONFIG = RecsysConfig(
    name="dlrm-rm2",
    kind="dlrm",
    embed_dim=64,
    n_sparse=26,
    n_dense=13,
    vocab_size=1_048_576,  # 2^20 (~10^6 rows, mesh-divisible)
    bot_mlp=(13, 512, 256, 64),
    top_mlp=(512, 512, 256, 1),
    interaction="dot",
    multi_hot=1,
)

REDUCED = RecsysConfig(
    name="dlrm-rm2-reduced",
    kind="dlrm",
    embed_dim=16,
    n_sparse=6,
    n_dense=13,
    vocab_size=512,
    bot_mlp=(13, 32, 16),
    top_mlp=(64, 32, 1),
    interaction="dot",
    multi_hot=1,
)
