"""Graph utilities (host numpy, the port's own copy of the reference's
``data/graphs.py``): synthetic graphs, CSR over incoming edges and the
uniform neighbour sampler of the ``minibatch_lg`` cell.  For the same
``np.random.Generator`` state every function returns the reference's
arrays bit for bit."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def random_graph(rng: np.random.Generator, n_nodes: int, n_edges: int,
                 d_feat: int, n_classes: int) -> Dict[str, np.ndarray]:
    """Random edges (E, 2) int32 src -> dst, destinations drawn toward
    high ids (``rng.power(3.0)``: a heavy-tailed in-degree), standard
    normal features (N, d_feat) f32 and uniform labels (N,) int32."""
    src = rng.integers(0, n_nodes, n_edges)
    dst = (n_nodes * rng.power(3.0, n_edges)).astype(np.int64) % n_nodes
    edges = np.stack([src, dst], axis=1).astype(np.int32)
    return {
        "edges": edges,
        "features": rng.standard_normal((n_nodes, d_feat)).astype(np.float32),
        "labels": rng.integers(0, n_classes, n_nodes).astype(np.int32),
    }


def build_csr(edges: np.ndarray, n_nodes: int) -> Tuple[np.ndarray,
                                                        np.ndarray]:
    """Edge list (E, 2) src -> dst => (indptr (N + 1,) int64, the sources
    int32 grouped by destination in edge order)."""
    dst = edges[:, 1]
    order = np.argsort(dst, kind="stable")
    sorted_src = edges[order, 0].astype(np.int32)
    counts = np.bincount(dst, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, sorted_src


def neighbor_sample(rng: np.random.Generator, indptr: np.ndarray,
                    indices: np.ndarray, nodes: np.ndarray,
                    fanout: int) -> np.ndarray:
    """Uniform fanout sampling with replacement: (B,) -> (B, fanout)
    int32; a node without in-neighbours samples itself."""
    starts = indptr[nodes]
    degs = indptr[nodes + 1] - starts
    r = rng.integers(0, np.maximum(degs, 1)[:, None], (len(nodes), fanout))
    picked = indices[np.minimum(starts[:, None] + r,
                                len(indices) - 1 if len(indices) else 0)] \
        if len(indices) else np.zeros((len(nodes), fanout), np.int32)
    picked = np.where(degs[:, None] > 0, picked, nodes[:, None])
    return picked.astype(np.int32)


def sample_two_hop(rng: np.random.Generator, indptr, indices, batch_nodes,
                   fanouts: Tuple[int, int], features: np.ndarray):
    """The dense minibatch of ``sage_forward_minibatch``: the batch's
    features (B, F), the 1-hop's (B, f0, F) and the 2-hop's
    (B, f0, f1, F)."""
    f0, f1 = fanouts
    hop1 = neighbor_sample(rng, indptr, indices, batch_nodes, f0)
    hop2 = neighbor_sample(rng, indptr, indices, hop1.reshape(-1), f1)
    hop2 = hop2.reshape(len(batch_nodes), f0, f1)
    return features[batch_nodes], features[hop1], features[hop2]


def block_diagonal_batch(rng: np.random.Generator, n_graphs: int,
                         nodes_per: int, edges_per: int, d_feat: int,
                         n_classes: int) -> Dict[str, np.ndarray]:
    """Small graphs (molecules) flattened into one block-diagonal graph:
    edges, features, each node's ``graph_ids`` and a label a graph."""
    offs = np.arange(n_graphs)[:, None] * nodes_per
    src = rng.integers(0, nodes_per, (n_graphs, edges_per)) + offs
    dst = rng.integers(0, nodes_per, (n_graphs, edges_per)) + offs
    edges = np.stack([src.reshape(-1), dst.reshape(-1)], 1).astype(np.int32)
    n_nodes = n_graphs * nodes_per
    return {
        "edges": edges,
        "features": rng.standard_normal((n_nodes, d_feat)).astype(np.float32),
        "graph_ids": np.repeat(np.arange(n_graphs), nodes_per).astype(
            np.int32),
        "labels": rng.integers(0, n_classes, n_graphs).astype(np.int32),
    }
