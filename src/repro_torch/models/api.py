"""Uniform Arch API (the port's counterpart of the JAX package's
``models/api.py``): for every (arch x shape) cell, the step function,
its abstract inputs and, on a mesh, their shardings.

``build_cell(arch_id, shape_id, mesh=None, reduced=False)`` returns a
:class:`Cell`:

* ``fn``      the step callable (``train_step`` / ``prefill`` /
              ``serve_step`` / ``retrieval``), on tensors of one device
              (the mesh's first: the sharded parts of the step place
              their shards themselves);
* ``args``    a tuple of trees of meta tensors (``device="meta"``: the
              shapes and dtypes, nothing allocated), where the reference
              has ``jax.ShapeDtypeStruct``;
* ``in_shardings`` None without a mesh; on one, the reference's spec
              tree of the args as ``sharding.spec.NamedSharding``s (a
              mesh and a ``PartitionSpec`` a leaf): what
              ``launch.dryrun`` counts per device;
* ``init_fn`` the arch's ``init_*`` as ``init_fn(gen, device)``;
* ``loss_fn`` a train cell's loss ``(params, batch) -> (loss, metrics)``
              (the function its ``fn`` differentiates), for callers that
              train it otherwise (``train.loop.make_train_step``'s
              microbatches).

:func:`realize` makes real arguments: params from ``init_fn`` with an
explicit ``torch.Generator``, the other leaves drawn from
``np.random.default_rng(seed)`` in JAX's flattening order, so they equal
the reference's bit for bit.  A train step is ``train.loop.
make_train_step`` at ``TrainConfig(opt=OptimizerConfig())``:
``value_and_grad`` then ``optim.adamw.adamw_update``.
On a mesh every branch is the reference's: the rules of the mesh (an
LM's decode at B = 1 shards its cache over every axis and replicates
the batch; a retrieval cell replicates its one query), the sharded
functions (expert-parallel MoE, the destination-partitioned SAGE
forward, the two-level top-k) and their spec trees.

Two switches of the reference are not ported; the port keeps their
defaults: ``REPRO_OPT_SERVE_PARAMS`` (on: an LM's ``serve_step`` takes
bf16 params in its abstract args, with or without a mesh, and on a mesh
they are sharded over the tensor / expert axes only, ``fsdp=None``) and
``REPRO_OPT_GNN`` (on: a full-graph cell on a mesh pads its nodes to
the mesh's size and runs ``gnn.sage_forward_full_dstpart`` on edges
with weights).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs import base as cfgs
from repro_torch.configs.base import GNNConfig, LMConfig, RecsysConfig, \
    ShapeCell
from repro_torch.configs.registry import get_config
from repro_torch.core.clustering import full_f32
from repro_torch.core.engine import resolve_device
from repro_torch.core.topk import _select, sharded_topk
from repro_torch.models import gnn, recsys, transformer as tfm
from repro_torch.models.layers import LOCAL_CTX
from repro_torch.optim.adamw import (OptimizerConfig, adamw_init,
                                     opt_state_specs)
from repro_torch.sharding.spec import (NamedSharding, P, Rules, ShardCtx,
                                       rules_for_mesh)
from repro_torch.train.loop import TrainConfig, make_train_step

META = torch.device("meta")


@dataclasses.dataclass
class Cell:
    arch: str
    shape_id: str
    step: str
    fn: Callable
    args: Tuple[Any, ...]
    in_shardings: Optional[Tuple[Any, ...]]
    donate_argnums: Tuple[int, ...] = ()
    init_fn: Optional[Callable] = None      # init_fn(gen, device) -> params
    bounds: Optional[Dict[str, int]] = None  # int-leaf upper bounds by name
    loss_fn: Optional[Callable] = None      # a train cell's loss


def _struct(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def realize(cell: Cell, seed: int = 0, device=None):
    """Real arguments for a cell on ``device`` (None: the card).  Params
    come from ``cell.init_fn`` with ``torch.Generator(device)`` seeded
    ``seed`` (other numbers than ``jax.random``'s); the other leaves from
    ``np.random.default_rng(seed)``, as the reference draws them: int
    leaves in [0, bound) (``cell.bounds`` matched by key substring, else
    2), float leaves 0.1 * N(0, 1)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    bounds = cell.bounds or {}

    def conc(name: str, x):
        if not (isinstance(x, torch.Tensor) and x.device.type == "meta"):
            return x
        shape = tuple(x.shape)
        if not x.dtype.is_floating_point:
            hi = 2
            for key, b in bounds.items():
                if key in name:
                    hi = b
                    break
            draw = np.asarray(rng.integers(0, max(hi, 1), shape))
        else:
            draw = np.asarray(0.1 * rng.standard_normal(shape))
        return torch.from_numpy(draw).to(device=dev, dtype=x.dtype)

    args = list(cell.args)
    if cell.init_fn is not None:
        params = cell.init_fn(torch.Generator(device=dev).manual_seed(seed),
                              dev)
        if cell.step == "train_step":
            args[0] = {"params": params, "opt": adamw_init(params)}
        else:
            args[0] = params
    rest = tuple(args[1:])
    drawn = [conc(key, x) for key, x in tree.keyed_leaves(rest)]
    return (args[0],) + tuple(tree.unflatten_like(rest, drawn))


def _shardings(mesh, spec_tree):
    """The spec tree as ``NamedSharding``s on ``mesh`` (None: None)."""
    if mesh is None:
        return None
    return tree.tree_map(lambda sp: NamedSharding(mesh, sp), spec_tree)


def _ctx(mesh, rules: Optional[Rules] = None) -> ShardCtx:
    if mesh is None:
        return LOCAL_CTX
    return ShardCtx(mesh=mesh, rules=rules or rules_for_mesh(mesh))


OPT = OptimizerConfig()


# ---------------------------------------------------------------------------
# Generic train-step wrapper (loss_fn closed over config)
# ---------------------------------------------------------------------------

def _make_train_step(loss_fn):
    return make_train_step(loss_fn, TrainConfig(opt=OPT))


def _state_structs(init_fn, specs, mesh):
    """The train state's abstract tree (``init_fn`` on the meta device
    and AdamW's moments of the same shapes) and, on a mesh, its
    shardings (the moments laid out as the params)."""
    params = init_fn(torch.Generator(), META)
    state = {"params": params, "opt": adamw_init(params)}
    sh = None
    if mesh is not None:
        sh = _shardings(mesh, {"params": specs,
                               "opt": opt_state_specs(specs)})
    return state, sh


def _train_cell(arch: str, shape_id: str, loss_fn, init_k, batch, specs,
                mesh, batch_specs) -> Cell:
    state, state_sh = _state_structs(init_k, specs, mesh)
    sh = (state_sh, _shardings(mesh, batch_specs)) if mesh else None
    return Cell(arch, shape_id, "train_step", _make_train_step(loss_fn),
                (state, batch), sh, donate_argnums=(0,), init_fn=init_k,
                loss_fn=loss_fn)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _lm_cell(arch: str, cfg: LMConfig, cell: ShapeCell, mesh,
             dims: Dict[str, int]) -> Cell:
    rules = rules_for_mesh(mesh) if mesh is not None else Rules()
    B, S = dims["global_batch"], dims["seq_len"]
    specs = tfm.lm_param_specs(cfg, rules)

    def init_k(gen, device=None):
        return tfm.init_lm(gen, cfg, device=device)

    if cell.step == "train_step":
        loss = functools.partial(tfm.lm_loss, cfg=cfg, ctx=_ctx(mesh, rules))
        batch = {"tokens": _struct((B, S), torch.int32),
                 "labels": _struct((B, S), torch.int32)}
        tok = P(rules.batch, rules.tensor)
        return _train_cell(arch, cell.shape_id, lambda p, b: loss(p, b),
                           init_k, batch, specs, mesh,
                           {"tokens": tok, "labels": tok})

    params = init_k(torch.Generator(), META)
    if cell.step == "prefill":
        fn = functools.partial(tfm.lm_prefill, cfg=cfg, ctx=_ctx(mesh, rules))
        sh = ((_shardings(mesh, specs),
               _shardings(mesh, P(rules.batch, rules.tensor)))
              if mesh else None)
        return Cell(arch, cell.shape_id, "prefill", fn,
                    (params, _struct((B, S), torch.int32)), sh,
                    init_fn=init_k)

    # serve_step (decode): the KV cache is sequence-sharded.  At B = 1
    # (long_500k) T takes every mesh axis and the batch none; decode_32k
    # shards B over the batch axes and T over the model axis.  Serving
    # params are bf16 and sharded over the tensor / expert axes only
    # (the reference's REPRO_OPT_SERVE_PARAMS default); the cache is
    # written in place and returned
    ctx_rules = rules
    if B == 1 and mesh is not None:
        rules = dataclasses.replace(rules, batch=None,
                                    tensor=tuple(mesh.axis_names))
        ctx_rules = dataclasses.replace(rules, tensor=None)
    seq_axes = rules.tensor
    ctx = _ctx(mesh, ctx_rules)

    def serve_step(params, cache, tokens, pos):
        return tfm.lm_decode_step(params, cache, tokens, int(pos), cfg, ctx)

    params = tree.tree_map(
        lambda x: _struct(x.shape, torch.bfloat16)
        if x.dtype.is_floating_point else x, params)
    cache = tfm.init_kv_cache(cfg, B, S, device=META)
    tokens = _struct((B, 1), torch.int32)
    pos = _struct((), torch.int32)
    sh = None
    if mesh is not None:
        # params always tensor-shard over "model" only (the all-axes
        # tensor rule of B = 1 is the cache's, not the weights')
        serve_rules = dataclasses.replace(rules, fsdp=None, tensor="model")
        sh = (_shardings(mesh, tfm.lm_param_specs(cfg, serve_rules)),
              _shardings(mesh, tfm.kv_cache_specs(cfg, rules,
                                                  seq_axes=seq_axes)),
              _shardings(mesh, P(rules.batch, None)),
              NamedSharding(mesh, P()))
    return Cell(arch, cell.shape_id, "serve_step", serve_step,
                (params, cache, tokens, pos), sh, donate_argnums=(1,),
                init_fn=init_k)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _gnn_cell(arch: str, cfg: GNNConfig, cell: ShapeCell, mesh,
              dims: Dict[str, int]) -> Cell:
    rules = rules_for_mesh(mesh) if mesh is not None else Rules()
    ctx = _ctx(mesh, rules)
    n_dev = 1 if mesh is None else mesh.size
    d_feat = dims.get("d_feat", cfg.d_feat)
    n_classes = dims.get("n_classes", cfg.n_classes)
    specs = gnn.sage_param_specs(cfg, rules)

    def init_k(gen, device=None):
        return gnn.init_sage(gen, cfg, d_feat, n_classes, device=device)

    f32, i32 = torch.float32, torch.int32
    if cell.shape_id == "minibatch_lg":
        B = dims["batch_nodes"]
        f0, f1 = dims["fanout0"], dims["fanout1"]

        def loss_fn(p, b):
            logits = gnn.sage_forward_minibatch(
                p, b["feats0"], b["feats1"], b["feats2"], cfg)
            return gnn.sage_loss(logits, b["labels"])
        batch = {"feats0": _struct((B, d_feat), f32),
                 "feats1": _struct((B, f0, d_feat), f32),
                 "feats2": _struct((B, f0, f1, d_feat), f32),
                 "labels": _struct((B,), i32)}
        bspec = {"feats0": P(rules.batch, None),
                 "feats1": P(rules.batch, None, None),
                 "feats2": P(rules.batch, None, None, None),
                 "labels": P(rules.batch)}
        return _train_cell(arch, cell.shape_id, loss_fn, init_k, batch,
                           specs, mesh, bspec)

    # full graph (sm / ogb_products) and molecule: one dummy node absorbs
    # the padding edges, the labels' mask excludes it; edges padded to
    # the device count.  On a mesh a full graph runs destination-
    # partitioned (the reference's REPRO_OPT_GNN default): nodes padded
    # to the mesh's size, edges with weights (0 pads a shard)
    use_dstpart = mesh is not None and cell.shape_id != "molecule"
    n_nodes = dims["n_nodes"] * dims.get("batch", 1) + 1
    if use_dstpart:
        n_nodes = _pad_to(n_nodes, n_dev)
    n_edges = _pad_to(dims["n_edges"] * dims.get("batch", 1), n_dev)
    is_mol = cell.shape_id == "molecule"
    n_graphs = dims.get("batch", 1)

    def loss_fn(p, b):
        if is_mol:
            logits = gnn.sage_forward_batched(
                p, b["features"], b["edges"], b["graph_ids"], n_graphs, cfg,
                ctx)
            return gnn.sage_loss(logits, b["labels"])
        if use_dstpart:
            logits = gnn.sage_forward_full_dstpart(
                p, b["features"], b["edges"], b["edge_weight"], cfg, ctx)
        else:
            logits = gnn.sage_forward_full(p, b["features"], b["edges"],
                                           cfg, ctx)
        return gnn.sage_loss(logits, b["labels"], b["mask"])

    batch = {"features": _struct((n_nodes, d_feat), f32),
             "edges": _struct((n_edges, 2), i32)}
    bspec = {"features": P(None, None), "edges": P(rules.corpus, None)}
    if is_mol:
        batch["graph_ids"] = _struct((n_nodes,), i32)
        batch["labels"] = _struct((n_graphs,), i32)
        bspec["graph_ids"] = P(None)
        bspec["labels"] = P(None)
    else:
        batch["labels"] = _struct((n_nodes,), i32)
        batch["mask"] = _struct((n_nodes,), f32)
        bspec["labels"] = P(None)
        bspec["mask"] = P(None)
        if use_dstpart:
            batch["edge_weight"] = _struct((n_edges,), f32)
            bspec["edge_weight"] = P(rules.corpus)
    return _train_cell(arch, cell.shape_id, loss_fn, init_k, batch, specs,
                       mesh, bspec)


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------

_INITS = {"dlrm": recsys.init_dlrm, "wide_deep": recsys.init_wide_deep,
          "bert4rec": recsys.init_bert4rec, "mind": recsys.init_mind}


def _recsys_specs(cfg: RecsysConfig, rules: Rules, bulk: bool):
    kind = cfg.kind
    if kind == "dlrm":
        return recsys.dlrm_param_specs(cfg, rules, bulk_serving=bulk)
    if kind == "wide_deep":
        return recsys.wide_deep_param_specs(cfg, rules, bulk_serving=bulk)
    if kind == "bert4rec":
        return recsys.bert4rec_param_specs(cfg, rules)
    return recsys.mind_param_specs(cfg, rules)


def _recsys_cell(arch: str, cfg: RecsysConfig, cell: ShapeCell, mesh,
                 dims: Dict[str, int]) -> Cell:
    rules = rules_for_mesh(mesh) if mesh is not None else Rules()
    B = dims.get("batch", 1)
    if B == 1 and mesh is not None:          # retrieval_cand: replicate batch
        rules = dataclasses.replace(rules, batch=None)
    ctx = _ctx(mesh, rules)
    kind = cfg.kind
    if kind not in _INITS:
        raise ValueError(kind)

    def init_k(gen, device=None):
        return _INITS[kind](gen, cfg, device)

    # only large serving batches take the tensor-axis table layout
    bulk = cell.step == "serve_step" and B >= recsys.BULK_GATHER_BATCH
    specs = _recsys_specs(cfg, rules, bulk)
    n_neg = 127
    f32, i32 = torch.float32, torch.int32
    b_ = rules.batch

    def batch_struct():
        if kind == "dlrm":
            return ({"dense": _struct((B, cfg.n_dense), f32),
                     "sparse_ids": _struct((B, cfg.n_sparse, cfg.multi_hot),
                                           i32),
                     "labels": _struct((B,), f32)},
                    {"dense": P(b_, None), "sparse_ids": P(b_, None, None),
                     "labels": P(b_)})
        if kind == "wide_deep":
            return ({"sparse_ids": _struct((B, cfg.n_sparse, cfg.multi_hot),
                                           i32),
                     "labels": _struct((B,), f32)},
                    {"sparse_ids": P(b_, None, None), "labels": P(b_)})
        if kind == "bert4rec":
            return ({"item_ids": _struct((B, cfg.seq_len), i32),
                     "mask_pos": _struct((B,), i32),
                     "pos_items": _struct((B,), i32),
                     "neg_items": _struct((B, n_neg), i32)},
                    {"item_ids": P(b_, None), "mask_pos": P(b_),
                     "pos_items": P(b_), "neg_items": P(b_, None)})
        return ({"hist_ids": _struct((B, cfg.hist_len), i32),
                 "pos_items": _struct((B,), i32),
                 "neg_items": _struct((B, n_neg), i32)},
                {"hist_ids": P(b_, None), "pos_items": P(b_),
                 "neg_items": P(b_, None)})

    def loss_fn(p, b):
        if kind == "dlrm":
            logit = recsys.dlrm_forward(p, b["dense"], b["sparse_ids"], cfg,
                                        ctx)
            return recsys.bce_loss(logit, b["labels"])
        if kind == "wide_deep":
            logit = recsys.wide_deep_forward(p, b["sparse_ids"], cfg, ctx)
            return recsys.bce_loss(logit, b["labels"])
        if kind == "bert4rec":
            return recsys.bert4rec_sampled_loss(
                p, b["item_ids"], b["mask_pos"], b["pos_items"],
                b["neg_items"], cfg, ctx)
        return recsys.mind_sampled_loss(
            p, b["hist_ids"], b["pos_items"], b["neg_items"], cfg, ctx)

    if cell.step == "train_step":
        batch, bspec = batch_struct()
        return _train_cell(arch, cell.shape_id, loss_fn, init_k, batch,
                           specs, mesh, bspec)

    params = init_k(torch.Generator(), META)
    psh = _shardings(mesh, specs)

    if cell.step == "serve_step":
        k = 100

        def serve_step(p, b):
            if kind == "dlrm":
                return torch.sigmoid(recsys.dlrm_forward(
                    p, b["dense"], b["sparse_ids"], cfg, ctx))
            if kind == "wide_deep":
                return torch.sigmoid(recsys.wide_deep_forward(
                    p, b["sparse_ids"], cfg, ctx))
            if kind == "bert4rec":
                u = recsys.bert4rec_user_embedding(p, b["item_ids"], cfg, ctx)
                return recsys.score_all_items(u, p["item_embed"], k, ctx)
            # MIND: the maximum over the interests, scored one interest at
            # a time, so one (B, V) score buffer is live at a time (the
            # reference's fori_loop)
            interests = recsys.mind_interests(p, b["hist_ids"], cfg, ctx)
            best = torch.full((interests.shape[0], k), -1e30,
                              dtype=torch.float32, device=interests.device)
            for i in range(cfg.n_interests):
                v, _ = recsys.score_all_items(interests[:, i],
                                              p["item_embed"], k, ctx)
                best = torch.maximum(best, v.float())
            return best

        # serving batches don't need labels
        batch, bspec = batch_struct()
        drop = ("labels", "pos_items", "neg_items", "mask_pos")
        batch = {kk: v for kk, v in batch.items() if kk not in drop}
        bspec = {kk: v for kk, v in bspec.items() if kk in batch}
        return Cell(arch, cell.shape_id, "serve_step", serve_step,
                    (params, batch),
                    (psh, _shardings(mesh, bspec)) if mesh else None,
                    init_fn=init_k)

    # retrieval_cand: one query against the rows of the item (or first)
    # table; rows past n_candidates (exactly 10^6 of 2^20) are masked out
    # of the top k, whose ties go to the lowest id (lax.top_k's order).
    # On a mesh the scores follow the table's rows (corpus-sharded) into
    # the two-level top-k
    n_cand = dims["n_candidates"]
    k = 100
    row_axes = rules.corpus

    def retrieval(p, query):
        table = p["item_embed"] if "item_embed" in p else p["tables"][0]
        cand = table.to(query.dtype)
        with full_f32:
            scores = query @ cand.T
        V = cand.shape[0]
        if V > n_cand:
            scores = torch.where(
                torch.arange(V, device=scores.device)[None] < n_cand,
                scores, -1e30)
        if ctx.mesh is not None:
            vals, ids = sharded_topk(scores, k, ctx, shard_axes=row_axes,
                                     batch_axes=None)
        else:
            vals, ids = _select(scores, k, True)
        return vals, ids.int()

    query = _struct((B, cfg.embed_dim), f32)
    sh = ((psh, NamedSharding(mesh, P(None, None))) if mesh else None)
    return Cell(arch, cell.shape_id, "retrieval", retrieval, (params, query),
                sh, init_fn=init_k)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def get_shape_cell(cfg, shape_id: str) -> ShapeCell:
    for c in cfgs.shapes_for(cfg):
        if c.shape_id == shape_id:
            return c
    raise KeyError(shape_id)


REDUCED_DIMS = {
    "seq_len": 64, "global_batch": 4, "batch": 4, "n_candidates": 512,
    "n_nodes": 64, "n_edges": 128, "batch_nodes": 8, "fanout0": 3,
    "fanout1": 2, "d_feat": 16, "n_classes": 4,
}


def build_cell(arch_id: str, shape_id: str, mesh=None,
               reduced: bool = False,
               dim_overrides: Optional[Dict[str, int]] = None) -> Cell:
    """The (arch x shape) cell, on one device or on ``mesh`` (a
    ``launch.mesh.Mesh``; a mesh on ``meta`` only places shapes)."""
    cfg = get_config(arch_id, reduced=reduced)
    cell = get_shape_cell(cfg, shape_id)
    dims = dict(cell.dims)
    if reduced:
        dims = {k: min(v, REDUCED_DIMS.get(k, v)) for k, v in dims.items()}
        if "batch" in dims and shape_id == "molecule":
            dims["batch"] = 4
    if dim_overrides:
        dims.update(dim_overrides)
    if isinstance(cfg, LMConfig):
        return _lm_cell(arch_id, cfg, cell, mesh, dims)
    if isinstance(cfg, GNNConfig):
        return _gnn_cell(arch_id, cfg, cell, mesh, dims)
    if isinstance(cfg, RecsysConfig):
        return _recsys_cell(arch_id, cfg, cell, mesh, dims)
    raise TypeError(type(cfg))
