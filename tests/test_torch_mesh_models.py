"""The port's models on a mesh of logical CPU devices against the JAX
package's sharded functions.

The JAX side runs in one subprocess with 4 forced host devices (as
``tests/test_torch_distributed.py`` does), on inputs drawn from a seed
with numpy; the port's side runs here on ``launch.mesh.Mesh``es of
logical CPU devices of the same shapes: (1, 4), (2, 2) and (2, 1).

* ``moe_block`` sequence-sharded (the all-to-all dispatch) and
  replicated (decode), at capacity factor 1.0, where pairs drop at each
  shard's own capacity (so the sharded function differs from the
  one-device one, and the port must reproduce the sharded one), and at
  16, where none drops; its gradient against ``jax.grad`` through the
  sharded function.
* ``lm_forward`` and ``lm_decode_step`` of the reduced Qwen3-30B-A3B and
  DeepSeek-V2-Lite on a mesh (the reference's params carried across).
* ``sage_forward_full_dstpart`` and its loss's gradient (the hidden
  states cross the mesh in bf16 and carry no gradient there, as the
  reference's bit patterns carry none), ``score_all_items`` on a mesh
  (ties planted across the shard boundary).
* The spec trees (``lm_param_specs``, ``kv_cache_specs``,
  ``opt_state_specs``, the ``*_param_specs`` and every reduced
  ``build_cell``'s ``in_shardings``) leaf by leaf against the reference's
  ``PartitionSpec``s on an ``AbstractMesh``, which needs no devices; the
  per-device bytes ``launch.dryrun`` records for full cells against the
  reference's ``NamedSharding.shard_shape``; ``model_flops`` for every
  (arch x shape) exactly; the ``Roofline`` terms at the H100's rates; a
  ``reshard_state`` round trip bit for bit, and ``supervise`` restoring a
  checkpoint onto a shrunk mesh.

Tolerances: f32 functions 1e-5 relative to the output's largest value
(the same operations summed in another order); gradients 1e-5 likewise;
the reduced LMs' f32 logits 1e-4, as ``tests/test_torch_models.py``;
SAGE's dst-partitioned logits 1e-5 (both sides round the hidden states
to bf16 at the same place); ids, slots and dropped pairs exactly.
"""

import dataclasses
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.analysis import model_flops as ref_flops
from repro.configs import shapes_for as ref_shapes_for
from repro.configs.registry import get_config as ref_config
from repro.models import api as RA
from repro.models import gnn as RG
from repro.models import recsys as RR
from repro.models import transformer as RT
from repro.optim import adamw as ropt
from repro.sharding import spec as rspec
from repro_torch import tree
from repro_torch.analysis import model_flops as pflops
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data.graphs import random_graph
from repro_torch.data.partition import partition_edges_by_dst
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import api as A
from repro_torch.models import gnn as G
from repro_torch.models import layers as L
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as popt
from repro_torch.sharding import spec
from repro_torch.data.synthetic import lm_batch
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.train.fault import FaultInjector, reshard_state, supervise
from repro_torch.train.loop import TrainConfig, init_state, make_train_step

MESHES = {"1x4": (1, 4), "2x2": (2, 2), "2x1": (2, 1)}
FACTORS = (1.0, 16.0)
F32_REL = 1e-5
LOGIT_TOL = 1e-4
MOE_ARCH = "qwen3-moe-30b-a3b"
LM_ARCHS = ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b")
LM_MESHES = ("1x4", "2x2")
LM_BS = (2, 8)           # B, S of the LMs' forward; decode fills 3 places
DECODE_STEPS = 3
SAGE = (64, 200, 16, 4)  # nodes, edges, features, classes
SCORE_K = 8
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _moe_inputs():
    cfg = get_config(MOE_ARCH, reduced=True)
    rng = np.random.default_rng(3)
    D, E, F = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    w = {"x": rng.standard_normal((4, 8, D)),
         "router": 0.3 * rng.standard_normal((D, E)),
         "w1": 0.1 * rng.standard_normal((E, D, 2 * F)),
         "w2": 0.1 * rng.standard_normal((E, F, D))}
    w["cot"] = rng.standard_normal(w["x"].shape)
    return {k: v.astype(np.float32) for k, v in w.items()}


def _inputs():
    x = {f"moe_{k}": v for k, v in _moe_inputs().items()}
    rng = np.random.default_rng(5)
    for arch in LM_ARCHS:
        cfg = get_config(arch, reduced=True)
        x[f"tok_{arch}"] = rng.integers(0, cfg.vocab_size,
                                        LM_BS).astype(np.int32)
    g = random_graph(rng, *SAGE)
    pe, pw = partition_edges_by_dst(g["edges"], SAGE[0], 4)
    x.update(sage_feats=g["features"], sage_edges=g["edges"],
             sage_pe=pe, sage_pw=pw, sage_labels=g["labels"])
    # integer embeddings: the bf16 scores are exact; rows 30/31 and 33/34
    # repeat rows 2 and 40, so equal scores sit across the shard boundary
    user = rng.integers(-3, 4, (4, 16)).astype(np.float32)
    table = rng.integers(-3, 4, (64, 16)).astype(np.float32)
    table[[30, 33]] = table[2]
    table[[31, 34]] = table[40]
    x.update(score_user=user, score_table=table)
    x["coll_x"] = rng.standard_normal((8, 16)).astype(np.float32)
    return x


_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
sys.path.insert(0, sys.argv[1])
import dataclasses
import functools
import jax, jax.numpy as jnp, numpy as np
from repro.configs.registry import get_config
from repro.configs.graphsage_reddit import REDUCED as gcfg
from repro.models import gnn, recsys
from repro.models import layers as L
from repro.models import transformer as T
from repro.models.layers import ShardCtx
from repro.sharding.spec import rules_for_mesh

x = dict(np.load(sys.argv[2]))
out = {}
MESHES = {"1x4": (1, 4), "2x2": (2, 2), "2x1": (2, 1)}


def ctx_of(name):
    n = int(np.prod(MESHES[name]))       # Auto axes: constraints apply
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(
        MESHES[name]), ("data", "model"))
    return mesh, ShardCtx(mesh=mesh, rules=rules_for_mesh(mesh))


base = get_config("qwen3-moe-30b-a3b", reduced=True)
w = [jnp.asarray(x["moe_" + k]) for k in ("x", "router", "w1", "w2")]
cot = jnp.asarray(x["moe_cot"])
for name in MESHES:
    mesh, ctx = ctx_of(name)
    for seq in (True, False):
        for cf in (1.0, 16.0):
            cfg = dataclasses.replace(base, capacity_factor=cf)

            def f(xx, r, a, b, cfg=cfg, ctx=ctx, seq=seq):
                return L.moe_block(xx, r, a, b, None, None, cfg=cfg,
                                   ctx=ctx, seq_sharded=seq)
            with mesh:
                out[f"moe/{name}/{seq}/{cf}"] = jax.jit(f)(*w)
                if cf == 1.0:
                    g = jax.jit(jax.grad(
                        lambda *a, f=f: jnp.sum(f(*a) * cot),
                        argnums=(0, 1, 2, 3)))(*w)
                    for i, gi in enumerate(g):
                        out[f"moegrad/{name}/{seq}/{i}"] = gi

for arch in ("qwen3-moe-30b-a3b", "deepseek-v2-lite-16b"):
    cfg = get_config(arch, reduced=True)
    params = T.init_lm(jax.random.key(1), cfg)
    for i, leaf in enumerate(jax.tree.leaves(params)):
        out[f"params/{arch}/{i}"] = leaf
    toks = jnp.asarray(x["tok_" + arch])
    for name in ("1x4", "2x2"):
        mesh, ctx = ctx_of(name)
        with mesh:
            out[f"fwd/{arch}/{name}"] = jax.jit(functools.partial(
                T.lm_forward, cfg=cfg, ctx=ctx, dtype=jnp.float32))(
                    params, toks)
            cache = T.init_kv_cache(cfg, toks.shape[0], toks.shape[1],
                                    dtype=jnp.float32)
            step = jax.jit(functools.partial(
                T.lm_decode_step, cfg=cfg, ctx=ctx, dtype=jnp.float32))
            for p in range(3):
                logits, cache = step(params, cache, toks[:, p:p + 1],
                                     jnp.int32(p))
                out[f"dec/{arch}/{name}/{p}"] = logits

mesh, ctx = ctx_of("2x2")
gp = gnn.init_sage(jax.random.key(2), gcfg, d_feat=16, n_classes=4)
for i, leaf in enumerate(jax.tree.leaves(gp)):
    out[f"sage_params/{i}"] = leaf
feats = jnp.asarray(x["sage_feats"])
pe, pw = jnp.asarray(x["sage_pe"]), jnp.asarray(x["sage_pw"])
labels = jnp.asarray(x["sage_labels"])
with mesh:
    fwd = jax.jit(lambda p: gnn.sage_forward_full_dstpart(
        p, feats, pe, pw, gcfg, ctx))
    out["sage/logits"] = fwd(gp)
    g = jax.jit(jax.grad(lambda p: gnn.sage_loss(fwd(p), labels)[0]))(gp)
    for i, leaf in enumerate(jax.tree.leaves(g)):
        out[f"sage_grad/{i}"] = leaf
    v, ids = jax.jit(lambda u, t: recsys.score_all_items(u, t, 8, ctx))(
        jnp.asarray(x["score_user"]), jnp.asarray(x["score_table"]))
    out["score/vals"] = v.astype(jnp.float32)
    out["score/ids"] = ids
from jax.sharding import PartitionSpec as P
from repro.sharding.spec import shard_map_compat
cx = jnp.asarray(x["coll_x"])
for name in ("1x4", "2x2"):
    mesh, ctx = ctx_of(name)
    bodies = {
        "a2a": (lambda v: jax.lax.all_to_all(v, "model", 0, 1, tiled=True),
                P("data", "model")),
        "psum": (lambda v: jax.lax.psum(v, "model"), P("data", None)),
        "gather": (lambda v: jax.lax.all_gather(v, "model", axis=1,
                                                tiled=True),
                   P("data", None)),
        "index": (lambda v: v + jax.lax.axis_index(("data", "model")),
                  P("data", "model")),
    }
    with mesh:
        for op, (body, out_spec) in bodies.items():
            out[f"coll/{name}/{op}"] = jax.jit(shard_map_compat(
                body, mesh, (P("data", "model"),), out_spec))(cx)
np.savez(sys.argv[3], **{k: np.asarray(v) for k, v in out.items()})
print("ok")
"""


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def ref(inputs, tmp_path_factory):
    """The JAX sharded functions' outputs on 4 forced host devices."""
    tmp = tmp_path_factory.mktemp("mesh_models")
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, os.path.join(REPO, "src"),
         str(tmp / "in.npz"), str(tmp / "out.npz")],
        capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(tmp / "out.npz"))


def _mesh(name):
    shape = MESHES[name]
    n = int(np.prod(shape))
    return Mesh(np.arange(n).reshape(shape), ("data", "model"), ["cpu"] * n)


def _ctx(name):
    mesh = _mesh(name)
    return spec.ShardCtx(mesh=mesh, rules=spec.rules_for_mesh(mesh))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rel=F32_REL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _ref_tree(ref, prefix, like):
    """The reference's leaves ``prefix/i`` in the tree of ``like`` (a JAX
    tree), as the port's params on the CPU."""
    leaves = [ref[f"{prefix}/{i}"] for i in range(len(jax.tree.leaves(like)))]
    return T.params_from_numpy(
        jax.tree.unflatten(jax.tree.structure(like), leaves), "cpu")


# ------------------------------------------------------------ the stages
COLLECTIVES = ("a2a", "psum", "gather", "index")


@pytest.mark.parametrize("op", COLLECTIVES)
@pytest.mark.parametrize("mesh", LM_MESHES)
def test_stages_match_shard_map_collectives(inputs, ref, mesh, op):
    """``shard_split`` by ``P("data", "model")``, one collective (or the
    axis index) per logical id, ``shard_merge`` by the out spec: the JAX
    ``shard_map`` of the same body: exactly, except ``psum``, which sums
    in shard order where XLA may sum in another (1e-5)."""
    ctx = _ctx(mesh)
    m, x = ctx.mesh, _t(inputs["coll_x"])
    parts = spec.shard_split(x, m, spec.P("data", "model"))
    if op == "a2a":
        parts, out = spec.all_to_all(parts, m, "model", 0, 1), \
            spec.P("data", "model")
    elif op == "psum":
        parts, out = spec.psum(parts, m, "model"), spec.P("data", None)
    elif op == "gather":
        parts, out = spec.all_gather(parts, m, "model", 1), \
            spec.P("data", None)
    else:
        body = spec.shard_map(
            lambda sh, v: v + sh.axis_index(("data", "model")), m,
            (spec.P("data", "model"),), spec.P("data", "model"))
        _close(body(x), ref[f"coll/{mesh}/index"], 0.0)
        return
    _close(spec.shard_merge(parts, m, out), ref[f"coll/{mesh}/{op}"],
           F32_REL if op == "psum" else 0.0)


def test_constrain_and_named_check_the_spec():
    """``constrain`` keeps the value and the tensor whole on the mesh's
    first device; a spec that names no axis of the mesh, or too many
    dimensions, raises as JAX refuses it; a ``NamedSharding``'s block
    shape and device."""
    ctx = _ctx("2x2")
    x = torch.arange(8.0).reshape(2, 4)
    assert ctx.constrain(x, "batch", "tensor") is x
    assert spec.constrain(x, None, spec.P("nope")) is x
    with pytest.raises(ValueError, match="not an axis"):
        spec.constrain(x, ctx.mesh, spec.P("pod", None))
    with pytest.raises(ValueError, match="entries"):
        spec.constrain(x, ctx.mesh, spec.P("data", None, None))
    sh = spec.NamedSharding(ctx.mesh, spec.P("data", "model"))
    assert sh.spec == rspec.P("data", "model")
    assert sh.shard_shape((6, 8)) == (3, 4)
    assert sh.device == ctx.mesh.first_device


# ------------------------------------------------------------------- MoE
def _moe(inputs, cf, ctx, seq, requires_grad=False):
    cfg = dataclasses.replace(get_config(MOE_ARCH, reduced=True),
                              capacity_factor=cf)
    w = [_t(inputs["moe_" + k]).requires_grad_(requires_grad)
         for k in ("x", "router", "w1", "w2")]
    return w, L.moe_block(*w, None, None, cfg=cfg, ctx=ctx,
                          seq_sharded=seq)


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("seq", [True, False], ids=["a2a", "replicated"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_moe_block_matches_sharded_reference(inputs, ref, mesh, seq, cf):
    _, got = _moe(inputs, cf, _ctx(mesh), seq)
    _close(got, ref[f"moe/{mesh}/{seq}/{cf}"])
    if cf == 16.0 or not seq:
        # no pair drops at 16, nor in decode (capacity t): the one-device
        # function, where none drops either
        _close(got, _moe(inputs, 16.0, spec.LOCAL_CTX, True)[1])
    else:
        # each shard's own capacity drops other pairs than one device's
        _, local = _moe(inputs, cf, spec.LOCAL_CTX, True)
        assert float((got - local).abs().max()) > 1e-3


@pytest.mark.parametrize("seq", [True, False], ids=["a2a", "replicated"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_moe_block_grad_matches_sharded_reference(inputs, ref, mesh, seq):
    w, out = _moe(inputs, 1.0, _ctx(mesh), seq, requires_grad=True)
    grads = torch.autograd.grad((out * _t(inputs["moe_cot"])).sum(), w)
    for i, g in enumerate(grads):
        _close(g, ref[f"moegrad/{mesh}/{seq}/{i}"])


def test_moe_dropped_pairs_follow_each_shards_capacity(inputs):
    """At capacity factor 1.0 on (1, 4) each shard slots its own 8 tokens
    at its own capacity: the pairs it drops are those past that capacity
    in its own token order."""
    cfg = dataclasses.replace(get_config(MOE_ARCH, reduced=True),
                              capacity_factor=1.0)
    ctx = _ctx("1x4")
    x = _t(inputs["moe_x"])
    seen = []
    dispatch = L._moe_dispatch

    def recording(xl, rw, c, cap, lo=0, n_local=None):
        buf, slot, gates = dispatch(xl, rw, c, cap, lo, n_local)
        seen.append((xl, cap, slot))
        return buf, slot, gates
    L._moe_dispatch = recording
    try:
        L.moe_block(x, *(_t(inputs["moe_" + k]) for k in
                         ("router", "w1", "w2")), None, None, cfg=cfg,
                    ctx=ctx)
    finally:
        L._moe_dispatch = dispatch
    assert len(seen) == 4
    dropped = 0
    for xl, cap, slot in seen:
        assert cap == L._capacity(xl.shape[0], cfg.moe_top_k,
                                  cfg.n_experts, 1.0)
        _, eids = L._router(xl, _t(inputs["moe_router"]), cfg)
        e = eids.reshape(-1).numpy()
        rank = np.array([(e[:i] == e[i]).sum() for i in range(len(e))])
        np.testing.assert_array_equal(
            (slot == cfg.n_experts * cap).numpy(), rank >= cap)
        dropped += int((rank >= cap).sum())
    assert dropped > 0


# ------------------------------------------------------------------- LMs
def _lm(arch, ref):
    cfg = get_config(arch, reduced=True)
    like = jax.eval_shape(lambda: RT.init_lm(jax.random.key(1),
                                             ref_config(arch, reduced=True)))
    return cfg, _ref_tree(ref, f"params/{arch}", like)


@pytest.mark.parametrize("mesh", LM_MESHES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_forward_on_a_mesh(inputs, ref, arch, mesh):
    cfg, params = _lm(arch, ref)
    got = T.lm_forward(params, _t(inputs[f"tok_{arch}"]), cfg, _ctx(mesh),
                       dtype=torch.float32)
    _close(got, ref[f"fwd/{arch}/{mesh}"], LOGIT_TOL)


@pytest.mark.parametrize("mesh", LM_MESHES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_decode_step_on_a_mesh(inputs, ref, arch, mesh):
    cfg, params = _lm(arch, ref)
    toks = _t(inputs[f"tok_{arch}"])
    cache = T.init_kv_cache(cfg, *LM_BS, dtype=torch.float32, device="cpu")
    for p in range(DECODE_STEPS):
        logits, cache = T.lm_decode_step(params, cache, toks[:, p:p + 1], p,
                                         cfg, _ctx(mesh),
                                         dtype=torch.float32)
        _close(logits, ref[f"dec/{arch}/{mesh}/{p}"], LOGIT_TOL)


# ------------------------------------------------------------ SAGE, score
def _sage(ref):
    cfg = get_config("graphsage-reddit", reduced=True)
    like = jax.eval_shape(lambda: RG.init_sage(
        jax.random.key(2), ref_config("graphsage-reddit", reduced=True),
        d_feat=16, n_classes=4))
    return cfg, _ref_tree(ref, "sage_params", like)


def test_sage_dstpart_matches_sharded_reference(inputs, ref):
    cfg, params = _sage(ref)
    got = G.sage_forward_full_dstpart(params, _t(inputs["sage_feats"]),
                                      inputs["sage_pe"], inputs["sage_pw"],
                                      cfg, _ctx("2x2"))
    _close(got, ref["sage/logits"])


def test_sage_dstpart_grad_matches_sharded_reference(inputs, ref):
    """The loss's gradient: the gathered hidden states carry none, as the
    reference's bit patterns carry none (so it is not the one-device
    forward's gradient)."""
    cfg, params = _sage(ref)
    xs = [p.requires_grad_() for p in tree.leaves(params)]
    p = tree.unflatten_like(params, xs)
    logits = G.sage_forward_full_dstpart(p, _t(inputs["sage_feats"]),
                                         inputs["sage_pe"],
                                         inputs["sage_pw"], cfg,
                                         _ctx("2x2"))
    loss = G.sage_loss(logits, inputs["sage_labels"])[0]
    grads = torch.autograd.grad(loss, xs)
    for i, g in enumerate(grads):
        _close(g, ref[f"sage_grad/{i}"])


def test_score_all_items_on_a_mesh(inputs, ref):
    vals, ids = R.score_all_items(_t(inputs["score_user"]),
                                  _t(inputs["score_table"]), SCORE_K,
                                  _ctx("2x2"))
    np.testing.assert_array_equal(ids.numpy(), ref["score/ids"])
    np.testing.assert_array_equal(vals.float().numpy(), ref["score/vals"])
    one = R.score_all_items(_t(inputs["score_user"]),
                            _t(inputs["score_table"]), SCORE_K)
    np.testing.assert_array_equal(ids.numpy(), one[1].numpy())


# ------------------------------------------------------------ spec trees
def _abstract(shape):
    names = ("pod", "data", "model") if len(shape) == 3 else ("data",
                                                              "model")
    return AbstractMesh(shape, names)


def _port_mesh(shape, device="cpu"):
    names = ("pod", "data", "model") if len(shape) == 3 else ("data",
                                                              "model")
    n = math.prod(shape)
    return Mesh(np.arange(n).reshape(shape), names, [device] * n)


def _same_specs(got, want):
    """Two spec trees, leaf by leaf: the port's ``PartitionSpec`` (or
    ``NamedSharding``) against the reference's."""
    unwrap = lambda s: s.spec if hasattr(s, "spec") else s  # noqa: E731
    g = [(k, tuple(unwrap(s))) for k, s in tree.keyed_leaves(got)]
    w = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda s: isinstance(s, (rspec.P,
                                               jax.sharding.Sharding)))[0]
    w = [(jax.tree_util.keystr(p), tuple(unwrap(s))) for p, s in w]
    assert g == w


RULES = {"single": ("SINGLE_POD_RULES",), "multi": ("MULTI_POD_RULES",)}


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if hasattr(get_config(a), "n_heads")
                                  and hasattr(get_config(a), "d_head")])
def test_lm_param_and_cache_specs(arch, rules):
    name = RULES[rules][0]
    pr, rr = getattr(spec, name), getattr(rspec, name)
    cfg, rcfg = get_config(arch), ref_config(arch)
    _same_specs(T.lm_param_specs(cfg, pr), RT.lm_param_specs(rcfg, rr))
    for seq in ("model", ("data", "model")):
        _same_specs(T.kv_cache_specs(cfg, pr, seq_axes=seq),
                    RT.kv_cache_specs(rcfg, rr, seq_axes=seq))
    _same_specs(popt.opt_state_specs(T.lm_param_specs(cfg, pr)),
                ropt.opt_state_specs(RT.lm_param_specs(rcfg, rr)))


@pytest.mark.parametrize("bulk", [False, True])
@pytest.mark.parametrize("arch", ["dlrm-rm2", "wide-deep", "bert4rec",
                                  "mind", "graphsage-reddit"])
def test_recsys_and_sage_param_specs(arch, bulk):
    cfg, rcfg = get_config(arch), ref_config(arch)
    pr, rr = spec.SINGLE_POD_RULES, rspec.SINGLE_POD_RULES
    fn = {"dlrm-rm2": "dlrm_param_specs",
          "wide-deep": "wide_deep_param_specs",
          "bert4rec": "bert4rec_param_specs", "mind": "mind_param_specs",
          "graphsage-reddit": "sage_param_specs"}[arch]
    port, refm = (G, RG) if arch == "graphsage-reddit" else (R, RR)
    kw = {"bulk_serving": bulk} if "dlrm" in fn or "wide" in fn else {}
    _same_specs(getattr(port, fn)(cfg, pr, **kw),
                getattr(refm, fn)(rcfg, rr, **kw))


CELLS = [(a, s.shape_id) for a in ARCH_IDS for s in
         ref_shapes_for(ref_config(a))]


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_build_cell_on_a_mesh_has_the_reference_specs(arch, shape):
    """Every reduced cell on a (2, 2) mesh: step, argument shapes and
    dtypes, and the spec of every argument leaf."""
    got = A.build_cell(arch, shape, mesh=_port_mesh((2, 2)), reduced=True)
    want = RA.build_cell(arch, shape, mesh=_abstract((2, 2)), reduced=True)
    assert got.step == want.step
    assert [tuple(x.shape) for x in tree.leaves(got.args)] == \
        [tuple(x.shape) for x in jax.tree.leaves(want.args)]
    _same_specs(got.in_shardings, want.in_shardings)


# --------------------------------------------------------- dryrun, flops
def _ref_bytes(cell):
    args = jax.tree.leaves(cell.args)
    shs = jax.tree.leaves(cell.in_shardings,
                          is_leaf=lambda s: isinstance(
                              s, jax.sharding.Sharding))
    return sum(math.prod(s.shard_shape(x.shape)) * np.dtype(x.dtype).itemsize
               for x, s in zip(args, shs, strict=True))


DRY = [("qwen3-0.6b", "train_4k", False), ("qwen3-moe-30b-a3b",
                                            "decode_32k", False),
       ("deepseek-v2-lite-16b", "prefill_32k", True),
       ("qwen1.5-4b", "long_500k", False), ("bert4rec", "serve_bulk", False),
       ("dlrm-rm2", "train_batch", True), ("mind", "retrieval_cand", False),
       ("graphsage-reddit", "ogb_products", False)]


@pytest.mark.parametrize("arch,shape,multi", DRY,
                         ids=[f"{a}-{s}-{'multi' if m else 'single'}"
                              for a, s, m in DRY])
def test_dryrun_bytes_match_reference_shard_shapes(arch, shape, multi):
    rec = dryrun.run_cell(arch, shape, multi)
    want = RA.build_cell(arch, shape, mesh=_abstract(
        (2, 16, 16) if multi else (16, 16)))
    assert rec["ok"] and rec["n_chips"] == (512 if multi else 256)
    assert rec["memory"]["argument_bytes"] == _ref_bytes(want)
    cfg = ref_config(arch)
    dims = next(c for c in ref_shapes_for(cfg) if c.shape_id == shape).dims
    assert rec["model_flops"] == ref_flops.model_flops(
        cfg, rec["step"], shape, dims)


def test_dryrun_anns_cell_and_resume(tmp_path):
    out = tmp_path / "dry.jsonl"
    for _ in range(2):
        dryrun.main(["--anns", "--mesh", "single", "--out", str(out)])
    lines = out.read_text().splitlines()
    assert len(lines) == 1                  # the second run skipped it
    import json
    rec = json.loads(lines[0])
    assert rec["memory"]["argument_bytes"] == (2 ** 30 * 32 // 256
                                               + 64 * 32 * 256 * 4)


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_model_flops_match_reference(arch, shape):
    cfg, rcfg = get_config(arch), ref_config(arch)
    for c, rc in zip(dryrun.shapes_for(cfg), ref_shapes_for(rcfg)):
        if c.shape_id == shape:
            assert pflops.model_flops(cfg, c.step, shape, c.dims) == \
                ref_flops.model_flops(rcfg, rc.step, shape, rc.dims)


ROOFS = [(1e15, 1e9, 1e8, "compute"), (1e12, 1e12, 1e8, "memory"),
         (1e12, 1e9, 1e12, "collective")]


@pytest.mark.parametrize("flops,hbm,coll,bound", ROOFS,
                         ids=[r[-1] for r in ROOFS])
def test_roofline_terms_match_reference(monkeypatch, flops, hbm, coll,
                                        bound):
    """The port's ``Roofline`` against the reference's formulas, the
    reference's TPU rates swapped for the port's H100 ones: every term of
    ``to_dict`` exactly."""
    from repro.analysis import roofline as rroof
    from repro_torch.analysis import roofline as proof
    monkeypatch.setattr(rroof, "PEAK_FLOPS", proof.PEAK_FLOPS)
    monkeypatch.setattr(rroof, "HBM_BW", proof.HBM_BW)
    monkeypatch.setattr(rroof, "ICI_BW", proof.LINK_BW)
    kw = dict(flops=flops, hbm_bytes=hbm, coll_bytes=coll,
              coll_breakdown={"all-gather": int(coll)},
              model_flops=0.75 * flops * 256, n_chips=256)
    got = proof.Roofline(**kw).to_dict()
    want = rroof.Roofline(**kw).to_dict()
    assert got == {k: want[k] for k in got}
    assert got["bottleneck"] == bound


def test_production_mesh_places_shapes_only():
    mesh = make_production_mesh(multi_pod=True)
    assert mesh.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh.first_device == torch.device("meta")
    sh = spec.NamedSharding(mesh, spec.P(("pod", "data", "model"), None))
    assert sh.shard_shape((2 ** 30, 32)) == (2 ** 21, 32)


def test_reshard_state_round_trip_bit_for_bit():
    """A train state moved from (1, 4) to its (1, 2) submesh and back:
    every leaf bit for bit, on the placement its sharding names."""
    cell = A.build_cell(MOE_ARCH, "train_4k", mesh=_mesh("1x4"),
                        reduced=True)
    state = A.realize(cell, seed=3, device="cpu")[0]
    half = _mesh("1x4").submesh(np.array([[0, 1]]))
    specs = tree.tree_map(lambda s: s.spec, cell.in_shardings[0])
    to_half = tree.tree_map(lambda s: spec.NamedSharding(half, s), specs)
    moved = reshard_state(state, to_half)
    back = reshard_state(moved, cell.in_shardings[0])
    for a, b, c in zip(tree.leaves(state), tree.leaves(moved),
                       tree.leaves(back), strict=True):
        assert a.dtype == b.dtype == c.dtype
        assert torch.equal(a.view(torch.uint8) if a.dim() else a, b.view(
            torch.uint8) if b.dim() else b)
        assert torch.equal(a, c) and b.device == half.first_device


def test_supervise_restores_onto_a_resized_mesh(tmp_path):
    """``supervise(shardings_fn=...)``: the reduced MoE LM trains on
    (1, 4); a failure at step 3 restores the step-2 checkpoint onto the
    (1, 2) submesh through ``reshard_state``.  The state the next step is
    handed is the checkpointed one bit for bit, each leaf on its new
    sharding's device, and the run ends bit-equal to one that never
    failed (every step the same batch, so a replayed step is the same
    step)."""
    cfg = get_config(MOE_ARCH, reduced=True)
    ctx = _ctx("1x4")
    half = ctx.mesh.submesh(np.array([[0, 1]]))
    specs = T.lm_param_specs(cfg, ctx.rules)
    to_half = tree.tree_map(lambda s: spec.NamedSharding(half, s),
                            {"params": specs,
                             "opt": popt.opt_state_specs(specs)})
    batch = lm_batch(np.random.default_rng(6), 2, 16, cfg.vocab_size)

    def train(name, on_step, shardings_fn):
        tcfg = TrainConfig(opt=OptimizerConfig(lr=1e-3, warmup_steps=1,
                                               total_steps=10),
                           ckpt_every=2, ckpt_dir=str(tmp_path / name))
        seen = []

        def make_step():
            step = make_train_step(
                lambda p, b: T.lm_loss(p, b, cfg, ctx, dtype=torch.float32),
                tcfg)

            def recorded(state, b):
                seen.append(tree.tree_map(torch.clone, state))
                return step(state, b)
            return recorded

        def init():
            return init_state(T.init_lm(torch.Generator().manual_seed(0),
                                        cfg, device="cpu"), tcfg)
        state, restarts, _ = supervise(
            make_step, init, lambda n: [batch] * n, tcfg, total_steps=5,
            on_step=on_step, shardings_fn=shardings_fn, device="cpu")
        return state, restarts, seen

    asked = []

    def shardings():
        asked.append(1)
        return to_half
    state, restarts, seen = train("failed", FaultInjector([3]), shardings)
    assert restarts == 1 and len(asked) == 1 and len(seen) == 6
    # seen[2] is the state checkpointed at step 2; seen[3] its restore
    for a, b, s in zip(tree.leaves(seen[2]), tree.leaves(seen[3]),
                       tree.leaves(to_half), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
        assert b.device == s.device
    clean, restarts, _ = train("clean", None, None)
    assert restarts == 0
    for a, b in zip(tree.leaves(state), tree.leaves(clean), strict=True):
        assert torch.equal(a, b)
