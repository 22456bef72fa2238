"""BERT4Rec [arXiv:1904.06690]: bidirectional seq recommender, d=64."""

from repro_torch.configs.base import RecsysConfig

CONFIG = RecsysConfig(
    name="bert4rec",
    kind="bert4rec",
    embed_dim=64,
    n_blocks=2,
    n_heads=2,
    seq_len=200,
    vocab_size=1_048_576,   # 2^20 rows (~10^6; mesh-divisible), retrieval scores exactly 1M
    interaction="bidir-seq",
)

REDUCED = RecsysConfig(
    name="bert4rec-reduced",
    kind="bert4rec",
    embed_dim=16,
    n_blocks=2,
    n_heads=2,
    seq_len=16,
    vocab_size=512,
    interaction="bidir-seq",
)
