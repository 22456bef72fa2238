"""GraphSAGE [arXiv:1706.02216] (the port's counterpart of the JAX
package's ``models/gnn.py``).

Message passing is a gather of the sources, then a sum into the
destinations over an edge list: ``layers.segment_reduce``, which sorts
the edges by destination (stable, once a forward) and reduces each
segment in that order, so the card adds in a fixed order and two runs
give the same bits (``index_add_`` adds in no fixed order there).  The
gather is ``layers.gather_rows``, whose backward sums each source's
messages' gradients the same way.
Three modes, all on one device:

* full graph: edges (E, 2) + features (N, F);
* minibatch: the dense sampled neighbourhoods of ``data.graphs``
  (B, f0, F) / (B, f0, f1, F);
* batched small graphs: block-diagonal flattening and a mean readout a
  graph.

f32 products run in full f32 (TF32 off: ``clustering.full_f32``).  Not
ported: ``sage_forward_full_dstpart`` and ``sage_param_specs`` (the mesh
half, ROADMAP queue 1 item 5); a :class:`ShardCtx` with a mesh raises.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import GNNConfig
from repro_torch.core.clustering import full_f32
from repro_torch.core.engine import resolve_device
from repro_torch.models.layers import (LOCAL_CTX, ShardCtx, gather_rows,
                                      segment_order, segment_reduce)
from repro_torch.models.transformer import _local_only, _normal


def init_sage(gen: torch.Generator, cfg: GNNConfig,
              d_feat: Optional[int] = None,
              n_classes: Optional[int] = None,
              device=None) -> Dict[str, Any]:
    """Each layer's ``w_self`` and ``w_neigh`` (normal, std 1 /
    sqrt(fan-in)) and a zero ``b``, drawn by ``gen`` on its own device."""
    dev = resolve_device(device)
    d_feat = d_feat or cfg.d_feat
    n_classes = n_classes or cfg.n_classes
    dims = [d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [n_classes]
    layers = []
    for i in range(cfg.n_layers):
        std = 1.0 / math.sqrt(dims[i])
        w = [_normal(gen, (dims[i], dims[i + 1]), std, dev) for _ in range(2)]
        layers.append({"w_self": w[0], "w_neigh": w[1],
                       "b": torch.zeros((dims[i + 1],), dtype=torch.float32,
                                        device=dev)})
    return {"layers": layers}


def _mean_aggregate(h: torch.Tensor, edges, n_nodes: int, ctx: ShardCtx,
                    weights=None, dst_offset=None,
                    order=None) -> torch.Tensor:
    """h (N, d), edges (E, 2) src -> dst: the weighted mean over each
    node's in-neighbours (N', d), N' = ``n_nodes``.  ``weights`` (E,)
    weighs the edges (0 pads a shard exactly); ``dst_offset`` shifts the
    destinations (a destination-partitioned shard's local ids); an edge
    whose destination falls outside [0, N') is dropped.  ``order`` is
    ``segment_order`` of the shifted destinations, where the caller has
    it: the edges are then not sorted again."""
    edges = torch.as_tensor(edges, device=h.device).long()
    src, dst = edges[:, 0], edges[:, 1]
    if dst_offset is not None:
        dst = dst - dst_offset
    if order is None:
        order = segment_order(dst, n_nodes)
    if weights is None:
        # unit weights: the degree is each destination's edge count
        agg = segment_reduce(gather_rows(h, src), None, n_nodes,
                             order=order)
        deg = order[1].to(h.dtype)
    else:
        # the messages and the weights in one reduction
        weights = torch.as_tensor(weights, device=h.device).to(h.dtype)
        both = segment_reduce(torch.cat([gather_rows(h, src)
                                         * weights[:, None],
                                         weights[:, None]], dim=1),
                              None, n_nodes, order=order)
        agg, deg = both[:, :-1], both[:, -1]
    return agg / torch.clamp(deg, min=1.0)[:, None]


def _sage_layer(h_self: torch.Tensor, h_neigh: torch.Tensor, p, *,
                final: bool) -> torch.Tensor:
    dt = h_self.dtype
    out = (h_self @ p["w_self"].to(dt) + h_neigh @ p["w_neigh"].to(dt)
           + p["b"].to(dt))
    if final:
        return out
    out = F.relu(out).float()
    # L2 normalise (GraphSAGE §3.1 line 7)
    norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
    return (out / torch.clamp(norm, min=1e-6)).to(dt)


def sage_forward_full(params, feats: torch.Tensor, edges, cfg: GNNConfig,
                      ctx: ShardCtx = LOCAL_CTX, weights=None
                      ) -> torch.Tensor:
    """Full-graph forward: feats (N, F), edges (E, 2) -> logits (N, C)."""
    _local_only(ctx)
    n_nodes = feats.shape[0]
    edges = torch.as_tensor(edges, device=feats.device).long()
    order = segment_order(edges[:, 1], n_nodes)      # once a forward
    h = feats
    with full_f32:
        for i, p in enumerate(params["layers"]):
            h_neigh = _mean_aggregate(h, edges, n_nodes, ctx, weights,
                                      order=order)
            h = _sage_layer(h, h_neigh, p, final=(i == cfg.n_layers - 1))
    return h


def sage_forward_minibatch(params, feats0: torch.Tensor,
                           feats1: torch.Tensor, feats2: torch.Tensor,
                           cfg: GNNConfig) -> torch.Tensor:
    """Sampled 2-hop forward: feats0 (B, F) the batch, feats1 (B, f0, F)
    the 1-hop, feats2 (B, f0, f1, F) the 2-hop.  Layer 1 runs on (1-hop,
    mean of its 2-hop) and (batch, mean of its 1-hop); layer 2 on
    (batch, mean of the 1-hop's layer-1 outputs)."""
    assert cfg.n_layers == 2
    p1, p2 = params["layers"]
    with full_f32:
        h1_hop1 = _sage_layer(feats1, feats2.mean(dim=2), p1, final=False)
        h1_self = _sage_layer(feats0, feats1.mean(dim=1), p1, final=False)
        return _sage_layer(h1_self, h1_hop1.mean(dim=1), p2, final=True)


def sage_forward_batched(params, feats: torch.Tensor, edges, graph_ids,
                         n_graphs: int, cfg: GNNConfig,
                         ctx: ShardCtx = LOCAL_CTX) -> torch.Tensor:
    """Block-diagonal batched small graphs, then a mean readout a graph
    -> (G, C)."""
    node_logits = sage_forward_full(params, feats, edges, cfg, ctx)
    order = segment_order(torch.as_tensor(graph_ids, device=feats.device),
                          n_graphs)
    summed = segment_reduce(node_logits, None, n_graphs, order=order)
    counts = order[1].to(node_logits.dtype)
    return summed / torch.clamp(counts, min=1.0)[:, None]


def sage_loss(logits: torch.Tensor, labels, mask=None):
    """Cross entropy over the nodes (or graphs) where ``mask`` is set (all
    by default), and the accuracy there."""
    logits = logits.float()
    labels = torch.as_tensor(labels, device=logits.device).long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    per = lse - ll
    mask = (torch.ones_like(per) if mask is None
            else torch.as_tensor(mask, device=logits.device).to(per.dtype))
    n = torch.clamp(torch.sum(mask), min=1.0)
    loss = torch.sum(per * mask) / n
    acc = torch.sum((torch.argmax(logits, -1) == labels).to(per.dtype)
                    * mask) / n
    return loss, {"loss": loss, "accuracy": acc}
