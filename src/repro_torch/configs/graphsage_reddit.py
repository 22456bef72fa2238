"""GraphSAGE [arXiv:1706.02216]: 2 layers, d=128, mean agg, fanout 25-10."""

from repro_torch.configs.base import GNNConfig

CONFIG = GNNConfig(
    name="graphsage-reddit",
    n_layers=2,
    d_hidden=128,
    aggregator="mean",
    sample_sizes=(25, 10),
    d_feat=602,
    n_classes=41,
)

REDUCED = GNNConfig(
    name="graphsage-reduced",
    n_layers=2,
    d_hidden=32,
    aggregator="mean",
    sample_sizes=(5, 3),
    d_feat=16,
    n_classes=4,
)
