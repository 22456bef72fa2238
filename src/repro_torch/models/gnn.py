"""GraphSAGE [arXiv:1706.02216] (the port's counterpart of the JAX
package's ``models/gnn.py``).

Message passing is a gather of the sources, then a sum into the
destinations over an edge list: ``layers.segment_reduce``, which sorts
the edges by destination (stable, once a forward) and reduces each
segment in that order, so the card adds in a fixed order and two runs
give the same bits (``index_add_`` adds in no fixed order there).  The
gather is ``layers.gather_rows``, whose backward sums each source's
messages' gradients the same way.
Three modes:

* full graph: edges (E, 2) + features (N, F); on a mesh also
  destination-partitioned (:func:`sage_forward_full_dstpart`: each shard
  aggregates its own node range, one all-gather of the hidden states in
  bf16 between the layers);
* minibatch: the dense sampled neighbourhoods of ``data.graphs``
  (B, f0, F) / (B, f0, f1, F);
* batched small graphs: block-diagonal flattening and a mean readout a
  graph.

f32 products run in full f32 (TF32 off: ``clustering.full_f32``).  On a
mesh :func:`sage_forward_full` is the reference's one-device forward (no
sharding constraint in it); :func:`sage_param_specs` replicates the
weights (the edges are what is sharded).
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
from repro_torch.models.transformer import _normal
from repro_torch.sharding.spec import (P, Rules, all_gather, axes_tuple,
                                       per_shard, shard_merge, shard_split)


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


def sage_param_specs(cfg: GNNConfig, r: Rules) -> Dict[str, Any]:
    """SAGE's weights are small (d_feat x 128) and d_feat rarely divides
    the mesh (1433, 602, 100, ...): replicated; the edges are sharded."""
    layer = {"w_self": P(None, None), "w_neigh": P(None, None), "b": P(None)}
    return {"layers": [dict(layer) for _ in range(cfg.n_layers)]}


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


def sage_forward_full_dstpart(params, feats: torch.Tensor, edges, weights,
                              cfg: GNNConfig, ctx: ShardCtx) -> torch.Tensor:
    """The reference's destination-partitioned full-graph forward on a
    mesh: feats (N, F) replicated; edges (E, 2) and weights (E,) split
    over the ``corpus`` axes in blocks that hold exactly the edges whose
    destination lies in the shard's N/P nodes (``data.partition.
    partition_edges_by_dst``: zero-weight edges pad each block) ->
    logits (N, C) on the mesh's first device.

    Each shard, on its logical device, aggregates and transforms only its
    own nodes (layer 1); the hidden states are rounded to bf16 and
    all-gathered in shard order (the reference ships their 16-bit
    patterns); each shard then runs layer 2 on its nodes.  The gathered
    copy carries no gradient, as the reference's integer bit patterns
    carry none: a shard's own hidden states reach layer 2's self term
    with their gradient, its neighbours' reach the aggregation without
    one (ROADMAP queue 3 records this fault of the reference's training
    gradient; the port keeps the sharded function's)."""
    if ctx.mesh is None:
        raise ValueError("sage_forward_full_dstpart runs on a mesh")
    if cfg.n_layers != 2:
        raise ValueError(f"the dst-partitioned forward has 2 layers, not "
                         f"{cfg.n_layers}")
    mesh = ctx.mesh
    axes = axes_tuple(ctx.rules.corpus)
    n_shards = math.prod(mesh.shape[a] for a in axes)
    n_nodes = feats.shape[0]
    if n_nodes % n_shards:
        raise ValueError(f"{n_nodes} nodes do not split over {n_shards} "
                         f"shards")
    n_loc = n_nodes // n_shards
    p1, p2 = params["layers"]
    edges = torch.as_tensor(edges, device=feats.device).long()
    weights = torch.as_tensor(weights, device=feats.device).to(feats.dtype)
    fs = shard_split(feats, mesh, P(None, None))
    es = shard_split(edges, mesh, P(axes, None))
    ws = shard_split(weights, mesh, P(axes))

    def on(dev, p):
        return {k: v.to(dev) for k, v in p.items()}

    def layer1(sh, f, e, w):
        lo = sh.axis_index(axes) * n_loc
        order = segment_order(e[:, 1] - lo, n_loc)   # both layers' sums
        with full_f32:
            neigh = _mean_aggregate(f, e, n_loc, None, w, dst_offset=lo,
                                    order=order)
            h1 = _sage_layer(f[lo:lo + n_loc], neigh, on(sh.device, p1),
                             final=False)
        return h1, order
    first = per_shard(mesh, layer1, fs, es, ws)
    h1s = all_gather({i: h.detach().to(torch.bfloat16)
                      for i, (h, _) in first.items()}, mesh, axes, dim=0)

    def layer2(sh, h1g, e, w):
        h1_l, order = first[sh.lid]
        lo = sh.axis_index(axes) * n_loc
        with full_f32:
            neigh = _mean_aggregate(h1g.to(h1_l.dtype), e, n_loc, None, w,
                                    dst_offset=lo, order=order)
            return _sage_layer(h1_l, neigh, on(sh.device, p2), final=True)
    outs = per_shard(mesh, layer2, h1s, es, ws)
    return shard_merge(outs, mesh, P(axes, None))


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
