"""FusionANNS index configs for the paper's three billion-scale datasets
(Table 1) plus reduced variants used by tests/benches on CPU."""

from repro_torch.configs.base import ANNSConfig

SIFT1B = ANNSConfig(
    name="sift1b", n_vectors=1_000_000_000, dim=128, dtype="uint8",
    pq_m=32, top_m=64, top_n=512, top_k=10,
)
SPACEV1B = ANNSConfig(
    name="spacev1b", n_vectors=1_000_000_000, dim=100, dtype="int8",
    pq_m=25, top_m=64, top_n=512, top_k=10,
)
DEEP1B = ANNSConfig(
    name="deep1b", n_vectors=1_000_000_000, dim=96, dtype="float32",
    pq_m=24, top_m=64, top_n=512, top_k=10,
)

# Reduced, CPU-runnable index configs (same structure, small N).
SIFT_SMALL = ANNSConfig(
    name="sift-small", n_vectors=20_000, dim=32, dtype="float32",
    pq_m=8, n_posting_fraction=0.02, top_m=16, top_n=128, top_k=10,
    rerank_batch=16, graph_degree=12,
)
SIFT_MEDIUM = ANNSConfig(
    name="sift-medium", n_vectors=100_000, dim=64, dtype="float32",
    pq_m=16, n_posting_fraction=0.01, top_m=32, top_n=256, top_k=10,
    rerank_batch=32, graph_degree=16,
)

DATASETS = {c.name: c for c in
            (SIFT1B, SPACEV1B, DEEP1B, SIFT_SMALL, SIFT_MEDIUM)}
