"""Host-side edge partitioning for a destination-partitioned GNN (host
numpy, the port's own copy of the reference's ``data/partition.py``):
edges range-partitioned by destination node, every shard padded to equal
length with zero-weight edges, as ``models.gnn.sage_forward_full_dstpart``
takes them on a mesh."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def pad_nodes(features: np.ndarray, labels: np.ndarray, mask: np.ndarray,
              n_shards: int):
    """Pad node arrays so n_nodes % n_shards == 0 (zero rows, masked
    out)."""
    n = len(features)
    pad = (-n) % n_shards
    if pad:
        features = np.pad(features, ((0, pad), (0, 0)))
        labels = np.pad(labels, (0, pad))
        mask = np.pad(mask, (0, pad))
    return features, labels, mask


def partition_edges_by_dst(edges: np.ndarray, n_nodes: int, n_shards: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (edges (n_shards * E_max, 2) grouped by owning shard, weights
    (n_shards * E_max,) f32).  Every shard holds E_max edges: its own with
    weight 1, then zero-weight edges (0 -> the shard's first node), which
    add nothing to a weighted mean."""
    assert n_nodes % n_shards == 0
    n_loc = n_nodes // n_shards
    dst = edges[:, 1]
    shard = dst // n_loc
    groups = [edges[shard == i] for i in range(n_shards)]
    e_max = max((len(g) for g in groups), default=1) or 1
    out_e = np.zeros((n_shards * e_max, 2), edges.dtype)
    out_w = np.zeros((n_shards * e_max,), np.float32)
    for i, g in enumerate(groups):
        s = i * e_max
        out_e[s:s + len(g)] = g
        out_w[s:s + len(g)] = 1.0
        out_e[s + len(g):s + e_max] = [0, i * n_loc]
    return out_e, out_w
