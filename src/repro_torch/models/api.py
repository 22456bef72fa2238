"""Uniform Arch API (the port's counterpart of the JAX package's
``models/api.py``): for every (arch x shape) cell, the step function and
its abstract inputs, on one device.

``build_cell(arch_id, shape_id, mesh=None, reduced=False)`` returns a
:class:`Cell`:

* ``fn``      the step callable (``train_step`` / ``prefill`` /
              ``serve_step`` / ``retrieval``), on tensors of one device;
* ``args``    a tuple of trees of meta tensors (``device="meta"``: the
              shapes and dtypes, nothing allocated), where the reference
              has ``jax.ShapeDtypeStruct``;
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
An LM's ``serve_step`` takes bf16 params in its abstract args, as the
reference's ``REPRO_OPT_SERVE_PARAMS`` default does (no switch here).
``in_shardings`` is always None: a mesh raises (ROADMAP queue 1 item 5),
and ``REPRO_OPT_GNN``, which the reference reads on a mesh only, is not
read.
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
from repro_torch.core.topk import _select
from repro_torch.models import gnn, recsys, transformer as tfm
from repro_torch.models.layers import LOCAL_CTX
from repro_torch.optim.adamw import OptimizerConfig, adamw_init
from repro_torch.sharding.spec import ShardCtx
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


OPT = OptimizerConfig()


# ---------------------------------------------------------------------------
# Generic train-step wrapper (loss_fn closed over config)
# ---------------------------------------------------------------------------

def _make_train_step(loss_fn):
    return make_train_step(loss_fn, TrainConfig(opt=OPT))


def _state_structs(init_fn):
    """The train state's abstract tree: ``init_fn`` on the meta device
    and AdamW's moments of the same shapes (the reference's shardings of
    it belong to the mesh branch, queue 1 item 5)."""
    params = init_fn(torch.Generator(), META)
    return {"params": params, "opt": adamw_init(params)}


def _train_cell(arch: str, shape_id: str, loss_fn, init_k, batch) -> Cell:
    state = _state_structs(init_k)
    return Cell(arch, shape_id, "train_step", _make_train_step(loss_fn),
                (state, batch), None, donate_argnums=(0,), init_fn=init_k,
                loss_fn=loss_fn)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _lm_cell(arch: str, cfg: LMConfig, cell: ShapeCell,
             dims: Dict[str, int]) -> Cell:
    B, S = dims["global_batch"], dims["seq_len"]
    ctx = LOCAL_CTX

    def init_k(gen, device=None):
        return tfm.init_lm(gen, cfg, device=device)

    if cell.step == "train_step":
        loss = functools.partial(tfm.lm_loss, cfg=cfg, ctx=ctx)
        batch = {"tokens": _struct((B, S), torch.int32),
                 "labels": _struct((B, S), torch.int32)}
        return _train_cell(arch, cell.shape_id, lambda p, b: loss(p, b),
                           init_k, batch)

    params = init_k(torch.Generator(), META)
    if cell.step == "prefill":
        fn = functools.partial(tfm.lm_prefill, cfg=cfg, ctx=ctx)
        return Cell(arch, cell.shape_id, "prefill", fn,
                    (params, _struct((B, S), torch.int32)), None,
                    init_fn=init_k)

    # serve_step (decode): the reference's serving params are bf16
    # (REPRO_OPT_SERVE_PARAMS, on by default); the cache is written in
    # place and returned
    def serve_step(params, cache, tokens, pos):
        return tfm.lm_decode_step(params, cache, tokens, int(pos), cfg, ctx)

    params = tree.tree_map(
        lambda x: _struct(x.shape, torch.bfloat16)
        if x.dtype.is_floating_point else x, params)
    cache = tfm.init_kv_cache(cfg, B, S, device=META)
    tokens = _struct((B, 1), torch.int32)
    pos = _struct((), torch.int32)
    return Cell(arch, cell.shape_id, "serve_step", serve_step,
                (params, cache, tokens, pos), None, donate_argnums=(1,),
                init_fn=init_k)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _gnn_cell(arch: str, cfg: GNNConfig, cell: ShapeCell,
              dims: Dict[str, int]) -> Cell:
    ctx = LOCAL_CTX
    n_dev = 1
    d_feat = dims.get("d_feat", cfg.d_feat)
    n_classes = dims.get("n_classes", cfg.n_classes)

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
        return _train_cell(arch, cell.shape_id, loss_fn, init_k, batch)

    # full graph (sm / ogb_products) and molecule: one dummy node absorbs
    # the padding edges, the labels' mask excludes it; edges padded to
    # the device count (1).  The reference's destination-partitioned
    # aggregation (REPRO_OPT_GNN) runs on a mesh only.
    n_nodes = dims["n_nodes"] * dims.get("batch", 1) + 1
    n_edges = _pad_to(dims["n_edges"] * dims.get("batch", 1), n_dev)
    is_mol = cell.shape_id == "molecule"
    n_graphs = dims.get("batch", 1)

    def loss_fn(p, b):
        if is_mol:
            logits = gnn.sage_forward_batched(
                p, b["features"], b["edges"], b["graph_ids"], n_graphs, cfg,
                ctx)
            return gnn.sage_loss(logits, b["labels"])
        logits = gnn.sage_forward_full(p, b["features"], b["edges"], cfg,
                                       ctx)
        return gnn.sage_loss(logits, b["labels"], b["mask"])

    batch = {"features": _struct((n_nodes, d_feat), f32),
             "edges": _struct((n_edges, 2), i32)}
    if is_mol:
        batch["graph_ids"] = _struct((n_nodes,), i32)
        batch["labels"] = _struct((n_graphs,), i32)
    else:
        batch["labels"] = _struct((n_nodes,), i32)
        batch["mask"] = _struct((n_nodes,), f32)
    return _train_cell(arch, cell.shape_id, loss_fn, init_k, batch)


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------

_INITS = {"dlrm": recsys.init_dlrm, "wide_deep": recsys.init_wide_deep,
          "bert4rec": recsys.init_bert4rec, "mind": recsys.init_mind}


def _recsys_cell(arch: str, cfg: RecsysConfig, cell: ShapeCell,
                 dims: Dict[str, int]) -> Cell:
    B = dims.get("batch", 1)
    ctx = LOCAL_CTX
    kind = cfg.kind
    if kind not in _INITS:
        raise ValueError(kind)

    def init_k(gen, device=None):
        return _INITS[kind](gen, cfg, device)

    n_neg = 127
    f32, i32 = torch.float32, torch.int32

    def batch_struct():
        if kind == "dlrm":
            return {"dense": _struct((B, cfg.n_dense), f32),
                    "sparse_ids": _struct((B, cfg.n_sparse, cfg.multi_hot),
                                          i32),
                    "labels": _struct((B,), f32)}
        if kind == "wide_deep":
            return {"sparse_ids": _struct((B, cfg.n_sparse, cfg.multi_hot),
                                          i32),
                    "labels": _struct((B,), f32)}
        if kind == "bert4rec":
            return {"item_ids": _struct((B, cfg.seq_len), i32),
                    "mask_pos": _struct((B,), i32),
                    "pos_items": _struct((B,), i32),
                    "neg_items": _struct((B, n_neg), i32)}
        return {"hist_ids": _struct((B, cfg.hist_len), i32),
                "pos_items": _struct((B,), i32),
                "neg_items": _struct((B, n_neg), i32)}

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
        return _train_cell(arch, cell.shape_id, loss_fn, init_k,
                           batch_struct())

    params = init_k(torch.Generator(), META)

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
        batch = {kk: v for kk, v in batch_struct().items()
                 if kk not in ("labels", "pos_items", "neg_items",
                               "mask_pos")}
        return Cell(arch, cell.shape_id, "serve_step", serve_step,
                    (params, batch), None, init_fn=init_k)

    # retrieval_cand: one query against the rows of the item (or first)
    # table; rows past n_candidates (exactly 10^6 of 2^20) are masked out
    # of the top k, whose ties go to the lowest id (lax.top_k's order)
    n_cand = dims["n_candidates"]
    k = 100

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
        vals, ids = _select(scores, k, True)
        return vals, ids.int()

    query = _struct((B, cfg.embed_dim), f32)
    return Cell(arch, cell.shape_id, "retrieval", retrieval, (params, query),
                None, init_fn=init_k)


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
    """The (arch x shape) cell on one device; a mesh raises (queue 1
    item 5)."""
    if mesh is not None:
        tfm._local_only(ShardCtx(mesh=mesh))
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
        return _lm_cell(arch_id, cfg, cell, dims)
    if isinstance(cfg, GNNConfig):
        return _gnn_cell(arch_id, cfg, cell, dims)
    if isinstance(cfg, RecsysConfig):
        return _recsys_cell(arch_id, cfg, cell, dims)
    raise TypeError(type(cfg))
