"""The models on a mesh of 4 logical devices sharing one CUDA card
(``chip_smoke.py`` phase 16's checks at the reduced configs).  Marked
``gpu``: without a CUDA device they skip (the flash kernels have no CPU
mode).  This file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_mesh.py

Tolerances: the MoE LM's prefill on (1, 4) against one device at
capacity factor 16 (no pair dropped on either) 1e-5 relative L2 a row
(the same f32 function, the experts' products batched otherwise);
decode logits rtol = atol = 2e-3 (phase 10 (b)'s limit), tokens equal;
gradients and the next train step 1e-4 relative L2 a leaf
(``TRAIN_GRAD_RTOL``); SAGE's dst-partitioned logits within the bf16
bound of the hidden states it gathers (2^-8 of each) plus 1e-5 of the
largest; ids, dropped pairs and moved leaves exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.configs.registry import get_config
from repro_torch.data.graphs import random_graph
from repro_torch.data.partition import partition_edges_by_dst
from repro_torch.data.synthetic import lm_batch
from repro_torch.kernels import launch
from repro_torch.kernels.flash_attn import flash_bwd_plan, flash_plan
from repro_torch.launch.mesh import Mesh
from repro_torch.models import api as A
from repro_torch.models import gnn as G
from repro_torch.models import layers as L
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import OptimizerConfig, opt_state_specs
from repro_torch.sharding.spec import (LOCAL_CTX, NamedSharding, ShardCtx,
                                       rules_for_mesh)
from repro_torch.train.fault import reshard_state
from repro_torch.train.loop import (TrainConfig, init_state,
                                    make_train_step, value_and_grad)

pytestmark = pytest.mark.gpu
ARCH = "qwen3-moe-30b-a3b"
ROW_REL = 1e-5
DECODE_TOL = 2e-3
GRAD_REL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = saved


def _ctx(shape, dev):
    n = int(np.prod(shape))
    mesh = Mesh(np.arange(n).reshape(shape), ("data", "model"), [dev] * n)
    return ShardCtx(mesh=mesh, rules=rules_for_mesh(mesh))


def _lm(dev, cf=16.0, **kw):
    cfg = dataclasses.replace(get_config(ARCH, reduced=True),
                              capacity_factor=cf, **kw)
    params = T.init_lm(torch.Generator(device=dev).manual_seed(0), cfg,
                       device=dev)
    return cfg, params


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def test_cuda_mesh_prefill_matches_one_device(cuda):
    cfg, params = _lm(cuda)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 64))).to(cuda)
    key = flash_plan(torch.float32, cfg.d_head).key
    out = {}
    for name, ctx in (("one", LOCAL_CTX), ("mesh", _ctx((1, 4), cuda))):
        launch.reset_launches()
        with torch.no_grad():
            out[name] = T.lm_prefill(params, toks, cfg, ctx,
                                     dtype=torch.float32)
        torch.cuda.synchronize()
        assert {k: v for k, v in launch.LAUNCHES.items() if v} == {
            key: cfg.n_layers}
    err = (out["mesh"] - out["one"]).norm(dim=-1) / out["one"].norm(dim=-1)
    assert float(err.max()) <= ROW_REL


def test_cuda_mesh_drops_follow_each_shards_capacity(cuda):
    cfg, params = _lm(cuda, cf=1.0)
    ctx = _ctx((1, 4), cuda)
    x = torch.randn((2, 64, cfg.d_model), generator=torch.Generator(
        device=cuda).manual_seed(2), device=cuda)
    p = {k: v[0] for k, v in params["blocks"].items()}
    seen, dispatch = [], L._moe_dispatch

    def recording(xl, rw, c, cap, lo=0, n_local=None):
        buf, slot, gates = dispatch(xl, rw, c, cap, lo, n_local)
        seen.append((xl, cap, slot))
        return buf, slot, gates
    L._moe_dispatch = recording
    try:
        with torch.no_grad():
            L.moe_block(x, p["router"], p["w1"], p["w2"], None, None,
                        cfg=cfg, ctx=ctx)
    finally:
        L._moe_dispatch = dispatch
    assert len(seen) == 4
    dropped = 0
    for xl, cap, slot in seen:
        _, eids = L._router(xl, p["router"], cfg)
        e = eids.reshape(-1).cpu().numpy()
        rank = np.array([(e[:i] == e[i]).sum() for i in range(len(e))])
        host_cap = L._capacity(xl.shape[0], cfg.moe_top_k, cfg.n_experts,
                               1.0)
        assert cap == host_cap
        np.testing.assert_array_equal(
            (slot == cfg.n_experts * cap).cpu().numpy(), rank >= cap)
        dropped += int((rank >= cap).sum())
    assert dropped > 0


def test_cuda_mesh_decode_gives_one_device_tokens(cuda):
    cfg, params = _lm(cuda, cf=1.25)
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 4))).to(cuda)
    runs = {}
    for name, ctx in (("one", LOCAL_CTX), ("mesh", _ctx((1, 4), cuda))):
        cache = T.init_kv_cache(cfg, 2, 12, dtype=torch.float32,
                                device=cuda)
        toks, logits = [], []
        with torch.no_grad():
            for p in range(4):
                lg, cache = T.lm_decode_step(params, cache,
                                             prompt[:, p:p + 1], p, cfg,
                                             ctx, dtype=torch.float32)
            for i in range(8):
                nxt = lg[:, -1].argmax(-1)
                toks.append(nxt)
                lg, cache = T.lm_decode_step(params, cache, nxt[:, None],
                                             4 + i, cfg, ctx,
                                             dtype=torch.float32)
                logits.append(lg)
        runs[name] = (torch.stack(toks, 1), torch.cat(logits, 1))
    assert torch.equal(runs["mesh"][0], runs["one"][0])
    assert torch.allclose(runs["mesh"][1], runs["one"][1], rtol=DECODE_TOL,
                          atol=DECODE_TOL)


def test_cuda_mesh_gradient_reshard_and_next_step(cuda):
    cfg, params = _lm(cuda, n_layers=1)
    ctx = _ctx((1, 4), cuda)
    half = ShardCtx(mesh=ctx.mesh.submesh(np.array([[0, 1]])),
                    rules=ctx.rules)
    batch = lm_batch(np.random.default_rng(4), 2, 64, cfg.vocab_size)

    def loss(c):
        return lambda p, b: T.lm_loss(p, b, cfg, c, dtype=torch.float32)
    launch.reset_launches()
    g_mesh, _ = value_and_grad(loss(ctx), params, batch)
    torch.cuda.synchronize()
    assert {k: v for k, v in launch.LAUNCHES.items() if v} == {
        flash_plan(torch.float32, cfg.d_head).key: 2,
        flash_bwd_plan(torch.float32, cfg.d_head, t=64).key: 1}
    g_one, _ = value_and_grad(loss(LOCAL_CTX), params, batch)
    for g, w in zip(tree.leaves(g_mesh), tree.leaves(g_one), strict=True):
        assert _rel(g, w) <= GRAD_REL
    tcfg = TrainConfig(opt=OptimizerConfig(lr=1e-3, warmup_steps=2))
    state1, _ = make_train_step(loss(ctx), tcfg)(init_state(params, tcfg),
                                                 batch)
    specs = T.lm_param_specs(cfg, ctx.rules)
    moved = reshard_state(state1, tree.tree_map(
        lambda s: NamedSharding(half.mesh, s),
        {"params": specs, "opt": opt_state_specs(specs)}))
    for a, b in zip(tree.leaves(state1), tree.leaves(moved), strict=True):
        assert torch.equal(a, b) and b.device == half.mesh.first_device
    s2a, _ = make_train_step(loss(half), tcfg)(moved, batch)
    s2b, _ = make_train_step(loss(ctx), tcfg)(state1, batch)
    for a, b in zip(tree.leaves(s2a), tree.leaves(s2b), strict=True):
        assert _rel(a, b) <= GRAD_REL


def test_cuda_sage_cell_on_a_mesh(cuda):
    ctx = _ctx((2, 2), cuda)
    cfg = get_config("graphsage-reddit", reduced=True)
    cell = A.build_cell("graphsage-reddit", "full_graph_sm", mesh=ctx.mesh,
                        reduced=True)
    n_pad, f = cell.args[1]["features"].shape
    g = random_graph(np.random.default_rng(5), 64, 128, f, 4)
    feats = torch.zeros((n_pad, f), device=cuda)
    feats[:64] = torch.from_numpy(g["features"]).to(cuda)
    pe, pw = partition_edges_by_dst(g["edges"], n_pad, 4)
    params = cell.init_fn(torch.Generator(device=cuda).manual_seed(0), cuda)
    with torch.no_grad():
        got = G.sage_forward_full_dstpart(params, feats, pe, pw, cfg, ctx)
        again = G.sage_forward_full_dstpart(params, feats, pe, pw, cfg, ctx)
        edges = torch.from_numpy(g["edges"]).to(cuda).long()
        want = G.sage_forward_full(params, feats[:64], edges, cfg)
        p1, p2 = params["layers"]
        h1 = G._sage_layer(feats[:64], G._mean_aggregate(
            feats[:64], edges, 64, None), p1, final=False)
        bound = 2.0 ** -8 * (G._mean_aggregate(h1.abs(), edges, 64, None)
                             @ p2["w_neigh"].abs())
    assert torch.equal(got, again)
    assert bool(((got[:64] - want).abs()
                 <= bound + 1e-5 * want.abs().max()).all())


def test_cuda_retrieval_and_scores_on_a_mesh(cuda):
    ctx = _ctx((2, 2), cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    for arch in ("dlrm-rm2", "bert4rec"):
        cell = A.build_cell(arch, "retrieval_cand", mesh=ctx.mesh,
                            reduced=True)
        one = A.build_cell(arch, "retrieval_cand", reduced=True)
        params = one.init_fn(gen, cuda)
        table = (params["item_embed"] if "item_embed" in params
                 else params["tables"][0])
        q = torch.randn((1, table.shape[1]), generator=gen, device=cuda)
        V = table.shape[0]
        tied = [V // 4 - 1, V // 4, V // 2, 3 * V // 4]
        table[tied] = 3.0 * q[0]
        vm, im = cell.fn(params, q)
        v1, i1 = one.fn(params, q)
        assert torch.equal(im, i1) and torch.equal(vm, v1)
        assert im[0, :4].tolist() == tied
    user = torch.randn((8, table.shape[1]), generator=gen, device=cuda)
    sv, si = R.score_all_items(user, table, 10, ctx)
    ov, oi = R.score_all_items(user, table, 10)
    assert torch.equal(si, oi) and torch.equal(sv, ov)
