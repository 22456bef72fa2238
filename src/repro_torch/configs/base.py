"""Index configuration (``ANNSConfig``), the port's copy of the JAX
package's ``configs/base.ANNSConfig``."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ANNSConfig:
    """FusionANNS index configuration (paper §4)."""

    name: str
    n_vectors: int
    dim: int
    dtype: str = "float32"           # raw vector dtype on the SSD tier
    pq_m: int = 32                   # sub-spaces (bytes per PQ code)
    pq_nbits: int = 8                # 256 centroids / sub-space
    n_posting_fraction: float = 0.10 # posting lists = 10% of N (paper §4.1)
    replication_eps: float = 0.10    # Eq. 2 epsilon
    max_replicas: int = 8            # paper: each vector in <= 8 clusters
    graph_degree: int = 32           # navigation graph out-degree
    top_m: int = 64                  # nearest posting lists per query
    top_n: int = 256                 # candidates sent to re-ranking
    top_k: int = 10                  # final neighbours
    rerank_batch: int = 32           # mini-batch size (Alg. 1 BatchSize)
    rerank_eps: float = 0.05         # Alg. 1 epsilon (change-rate threshold)
    rerank_beta: int = 2             # Alg. 1 beta (stability count)
    page_bytes: int = 4096           # SSD page
    dram_buffer_pages: int = 1024    # per-query DRAM page buffer
