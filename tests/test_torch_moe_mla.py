"""The port's MoE and MLA (``repro_torch.models``: ``moe_block`` on its
local path, ``mla_qkv``, ``mla_decode_absorbed``, the MoE/MLA LMs, their
cache and decode, greedy serving and the launcher) against the JAX
package's, on the CPU, on the same numpy-seeded inputs and on the
reference's own params carried across by ``params_from_numpy``.

Tolerances, as ``tests/test_torch_models.py``: f32 functions 1e-5 (the
same operations, summed in another order); f32 logits of the reduced
LMs and their decode steps 1e-4; bf16 functions and logits within 2^-6
of the largest reference value (each side rounds its layer outputs to
bf16, at other places in the two frameworks); the port's own decode
against its forward 2e-3, the reference's limit (``tests/test_serve.py``),
at a capacity factor of 16 (the reference's own choice there: at the
default 1.25 the forward drops pairs that one-token decode steps never
drop).  Routing ids and slots are integers and compared exactly; the
cases plant ties (equal router probabilities go to the lowest expert
id, as ``lax.top_k`` sends them) and drops (a capacity factor of 0.25).
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_config
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.serve.engine import LMServer as RefServer
from repro.serve.engine import ServeConfig as RefServeConfig
from repro_torch.configs.registry import get_config
from repro_torch.kernels.flash_attn import flash_attn_ref
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve.engine import LMServer, ServeConfig
from repro_torch.sharding.spec import ShardCtx, rules_for_mesh

F32_TOL = 1e-5
LOGIT_TOL = 1e-4
BF16_REL = 2.0 ** -6
MOE = ["qwen3-moe-30b-a3b", "deepseek-v2-lite-16b"]
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _j(x, dtype=jnp.float32):
    return jnp.asarray(x).astype(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_bf16(got, want):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=BF16_REL * np.abs(want).max())


# ------------------------------------------------------------------- MoE
def _moe_inputs(arch, router="random", seed=0, tokens=(3, 16)):
    """A reduced MoE arch's config and numpy inputs of moe_block: x,
    router (random, or with planted ties: all zero, or three zero
    columns), experts and shared experts."""
    cfg = get_config(arch, reduced=True)
    rng = np.random.default_rng(seed)
    D, E, F = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    Fs = F * max(cfg.n_shared_experts, 1)
    w = {"x": rng.standard_normal((*tokens, D)),
         "router": 0.3 * rng.standard_normal((D, E)),
         "w1": 0.1 * rng.standard_normal((E, D, 2 * F)),
         "w2": 0.1 * rng.standard_normal((E, F, D)),
         "ws1": 0.1 * rng.standard_normal((D, 2 * Fs)),
         "ws2": 0.1 * rng.standard_normal((Fs, D))}
    if router == "all_tied":          # every probability 1/E
        w["router"][:] = 0
    elif router == "some_tied":       # three experts of logit 0 each
        w["router"][:, [1, 4, 5]] = 0
    return cfg, {k: v.astype(np.float32) for k, v in w.items()}


@pytest.mark.parametrize("router", ["random", "all_tied", "some_tied"])
@pytest.mark.parametrize("arch", MOE)
def test_router_and_slots_match_reference(arch, router):
    """Gates to 1e-5 and expert ids exactly, ties to the lowest id; each
    pair's slot within its expert exactly."""
    cfg, w = _moe_inputs(arch, router)
    x = w["x"].reshape(-1, cfg.d_model)
    gates, eids = L._router(_t(x), _t(w["router"]), cfg)
    rg, re = RL._router(_j(x), _j(w["router"]), cfg)
    np.testing.assert_array_equal(eids.numpy(), np.asarray(re))
    np.testing.assert_allclose(_np(gates), _np(rg), rtol=F32_TOL,
                               atol=F32_TOL)
    cap = L._capacity(x.shape[0], cfg.moe_top_k, cfg.n_experts,
                      cfg.capacity_factor)
    assert cap == RL._capacity(x.shape[0], cfg.moe_top_k, cfg.n_experts,
                               cfg.capacity_factor)
    for got, want in zip(L._expert_slots(eids, cfg.n_experts),
                         RL._expert_slots(re, cfg.n_experts, cap)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if router == "all_tied":          # every token to experts 0 .. k-1
        assert (eids.numpy() == np.arange(cfg.moe_top_k)).all()


@pytest.mark.parametrize("factor", [None, 0.25], ids=["cfg", "drops"])
@pytest.mark.parametrize("router", ["random", "all_tied", "some_tied"])
@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared"])
def test_moe_block_matches_reference(shared, router, factor):
    """moe_block in f32 at 1e-5: routed experts alone and with shared
    experts, at the config's capacity factor and at 0.25, where pairs
    drop (planted: the same pairs must drop on both sides), and with
    tied router probabilities."""
    cfg, w = _moe_inputs("deepseek-v2-lite-16b", router)
    if factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=factor)
        t = w["x"].shape[0] * w["x"].shape[1]
        cap = L._capacity(t, cfg.moe_top_k, cfg.n_experts, factor)
        _, eids = L._router(_t(w["x"].reshape(t, -1)), _t(w["router"]), cfg)
        _, pos = L._expert_slots(eids, cfg.n_experts)
        assert int((pos >= cap).sum()) > 0           # drops are planted
    names = ("x", "router", "w1", "w2") + (("ws1", "ws2") if shared
                                           else ())
    pad = () if shared else (None, None)
    got = L.moe_block(*(_t(w[k]) for k in names), *pad, cfg=cfg)
    want = RL.moe_block(*(_j(w[k]) for k in names), *pad, cfg=cfg,
                        ctx=RL.LOCAL_CTX)
    assert got.shape == w["x"].shape and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_moe_block_bf16_matches_reference():
    cfg, w = _moe_inputs("qwen3-moe-30b-a3b", "some_tied")
    got = L.moe_block(_t(w["x"], torch.bfloat16), _t(w["router"]),
                      _t(w["w1"]), _t(w["w2"]), None, None, cfg=cfg)
    want = RL.moe_block(_j(w["x"], jnp.bfloat16), _j(w["router"]),
                        _j(w["w1"]), _j(w["w2"]), None, None, cfg=cfg,
                        ctx=RL.LOCAL_CTX)
    assert got.dtype == torch.bfloat16
    _close_bf16(got, want)


MESHES = {"2x1": (2, 1), "1x4": (1, 4), "2x2": (2, 2)}


@pytest.mark.parametrize("seq", [True, False], ids=["a2a", "replicated"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_moe_block_on_a_mesh_matches_one_device(mesh, seq):
    """moe_block on a mesh of logical CPU devices, expert-parallel (the
    all-to-all dispatch, or each shard's experts summed in decode), with
    shared experts, at a capacity factor of 16 (no pair drops on a shard
    or on one device): the reference's one-device function at 1e-5.
    (``tests/test_torch_mesh_models.py`` holds the sharded function
    against the reference's sharded one where pairs drop.)"""
    cfg, w = _moe_inputs("qwen3-moe-30b-a3b", tokens=(4, 8))
    cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    shape = MESHES[mesh]
    n = int(np.prod(shape))
    m = Mesh(np.arange(n).reshape(shape), ("data", "model"), ["cpu"] * n)
    ctx = ShardCtx(mesh=m, rules=rules_for_mesh(m))
    names = ("x", "router", "w1", "w2", "ws1", "ws2")
    got = L.moe_block(*(_t(w[k]) for k in names), cfg=cfg, ctx=ctx,
                      seq_sharded=seq)
    want = RL.moe_block(*(_j(w[k]) for k in names), cfg=cfg,
                        ctx=RL.LOCAL_CTX)
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL,
                               atol=F32_TOL)


# ------------------------------------------------------------------- MLA
def _mla_params(rng, cfg):
    D, H = cfg.d_model, cfg.n_heads
    lr, rd, nd, vd = (cfg.kv_lora_rank, cfg.qk_rope_head_dim,
                      cfg.qk_nope_head_dim, cfg.v_head_dim)
    return {"wq": 0.1 * rng.standard_normal((D, H, nd + rd)),
            "wdkv": 0.1 * rng.standard_normal((D, lr + rd)),
            "kv_norm": 1 + 0.1 * rng.standard_normal(lr),
            "wuk": 0.1 * rng.standard_normal((lr, H, nd)),
            "wuv": 0.1 * rng.standard_normal((lr, H, vd))}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mla_qkv_matches_reference(rng, dtype):
    cfg = get_config("deepseek-v2-lite-16b", reduced=True)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    p = {k: v.astype(np.float32) for k, v in _mla_params(rng, cfg).items()}
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    pos = np.arange(9, dtype=np.int32)
    got = L.mla_qkv(_t(x, tdt), {k: _t(v) for k, v in p.items()}, cfg,
                    torch.from_numpy(pos))
    want = RL.mla_qkv(_j(x, jdt), {k: _j(v) for k, v in p.items()}, cfg,
                      jnp.asarray(pos))
    flat = lambda r: (*r[:3], *r[3])                  # noqa: E731
    for g, w in zip(flat(got), flat(want), strict=True):
        assert tuple(g.shape) == w.shape and g.dtype == tdt
        if dtype == "f32":
            np.testing.assert_allclose(_np(g), _np(w), rtol=F32_TOL,
                                       atol=F32_TOL)
        else:
            _close_bf16(g, w)


@pytest.mark.parametrize("cache", ["f32", "bf16"])
def test_mla_decode_absorbed_matches_reference(rng, cache):
    """The absorbed decode over an f32 and a bf16 compressed cache, some
    rows' lengths short of T; f32 arithmetic on both sides (the CPU), so
    1e-5 either way."""
    cfg = get_config("deepseek-v2-lite-16b", reduced=True)
    tdt, jdt = ((torch.float32, jnp.float32) if cache == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    p = {k: v.astype(np.float32) for k, v in _mla_params(rng, cfg).items()}
    B, T = 3, 10
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.standard_normal((B, T, cfg.kv_lora_rank)).astype(np.float32)
    kpe = rng.standard_normal((B, T, cfg.qk_rope_head_dim)).astype(
        np.float32)
    n = np.array([1, 6, 10], np.int32)
    pos = (n - 1)[:, None]
    got = L.mla_decode_absorbed(_t(x), {k: _t(v) for k, v in p.items()},
                                cfg, _t(ckv, tdt), _t(kpe, tdt),
                                torch.from_numpy(n), torch.from_numpy(pos))
    want = RL.mla_decode_absorbed(_j(x), {k: _j(v) for k, v in p.items()},
                                  cfg, _j(ckv, jdt), _j(kpe, jdt),
                                  jnp.asarray(n), jnp.asarray(pos))
    assert tuple(got.shape) == (B, 1, cfg.n_heads, cfg.v_head_dim)
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("dk,dv", [(48, 32), (192, 128), (64, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_narrow_v_attention_matches_reference(rng, dk, dv, causal):
    """v narrower than q and k (MLA's prefill): the flash kernels' plain
    version and the model's attention against the reference's
    blockwise_attention, scale 1/sqrt(dk)."""
    B, S, H, Hk = 2, 24, 4, 2
    q = rng.standard_normal((B, S, H, dk)).astype(np.float32)
    k = rng.standard_normal((B, S, Hk, dk)).astype(np.float32)
    v = rng.standard_normal((B, S, Hk, dv)).astype(np.float32)
    want = _np(RL.blockwise_attention(_j(q), _j(k), _j(v), causal=causal,
                                      block_size=8))
    for got in (flash_attn_ref(_t(q), _t(k), _t(v), causal=causal),
                L.blockwise_attention(_t(q), _t(k), _t(v), causal=causal,
                                      block_size=8)):
        assert tuple(got.shape) == (B, S, H, dv)
        np.testing.assert_allclose(_np(got), want, rtol=F32_TOL,
                                   atol=F32_TOL)


# ------------------------------------------------------------ the models
@functools.lru_cache(maxsize=None)
def _params(arch):
    """The reference's seeded params and the port's copy of them."""
    rcfg = ref_config(arch, reduced=True)
    rp = RT.init_lm(jax.random.key(0), rcfg)
    return rp, T.params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("arch", MOE)
def test_moe_init_lm_shapes_and_stds(arch):
    """The reference's keys (``dense_blocks`` for DeepSeek's first
    layer), shapes and stds (``w2`` scaled by its stack's depth, ``ws2``
    not, ``kv_norm`` ones); bf16 storage keeps them, in bf16."""
    cfg = get_config(arch, reduced=True)
    rp, _ = _params(arch)
    ref = dict(_leaves(jax.tree.map(np.asarray, rp)))
    for dtype in (torch.float32, torch.bfloat16):
        port = dict(_leaves(T.init_lm(torch.Generator().manual_seed(0), cfg,
                                      device="cpu", dtype=dtype)))
        assert port.keys() == ref.keys()
        for name, r in ref.items():
            p = port[name]
            assert tuple(p.shape) == r.shape and p.dtype == dtype, name
            np.testing.assert_allclose(p.float().std().item()
                                       if p.numel() > 1 else 0, r.std(),
                                       rtol=0.15, atol=1e-7, err_msg=name)
            np.testing.assert_allclose(p.float().mean().item(), r.mean(),
                                       atol=2e-3, err_msg=name)


def test_init_lm_default_draws_are_unchanged():
    """The f32 default draws each param in one call, as before bf16
    storage existed: the embedding is 0.02 times the generator's first
    normals, and the stacked weights follow in key order."""
    cfg = get_config("qwen3-0.6b", reduced=True)
    params = T.init_lm(torch.Generator().manual_seed(3), cfg, device="cpu")
    gen = torch.Generator().manual_seed(3)
    want = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen) * 0.02
    assert torch.equal(params["embed"], want)
    blocks = params["blocks"]
    for name in sorted(blocks):
        if blocks[name].std() > 0:          # the first normal stack
            shape = tuple(blocks[name].shape)
            assert torch.equal(blocks[name],
                               torch.randn(shape, generator=gen) * 0.02)
            break


@pytest.mark.parametrize("arch", MOE)
def test_moe_lm_forward_and_prefill_match_reference(arch):
    cfg, rcfg = get_config(arch, reduced=True), ref_config(arch, reduced=True)
    rp, pp = _params(arch)
    toks = _tokens(cfg, 2, 16)
    want = RT.lm_forward(rp, jnp.asarray(toks), rcfg, dtype=jnp.float32)
    got = T.lm_forward(pp, toks, cfg, dtype=torch.float32)
    assert got.shape == (2, 16, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(
        _np(T.lm_prefill(pp, toks, cfg, dtype=torch.float32)),
        _np(RT.lm_prefill(rp, jnp.asarray(toks), rcfg, dtype=jnp.float32)),
        rtol=LOGIT_TOL, atol=LOGIT_TOL)
    got16 = T.lm_forward(pp, toks, cfg)                 # default: bf16
    assert got16.dtype == torch.bfloat16
    _close_bf16(got16, RT.lm_forward(rp, jnp.asarray(toks), rcfg))
    _close_bf16(T.lm_prefill(pp, toks, cfg),
                RT.lm_prefill(rp, jnp.asarray(toks), rcfg))


@pytest.mark.parametrize("arch", MOE)
def test_moe_kv_cache_and_decode_step_match_reference(arch):
    """The cache's keys (``ckv``/``kpe`` and their ``_dense`` twins under
    MLA) and shapes; each decode step's logits and the cache it writes
    in place equal the reference's; a bf16 cache too."""
    cfg, rcfg = get_config(arch, reduced=True), ref_config(arch, reduced=True)
    rp, pp = _params(arch)
    B, S, steps = 2, 8, 5
    rc = RT.init_kv_cache(rcfg, B, S, dtype=jnp.float32)
    pc = T.init_kv_cache(cfg, B, S, dtype=torch.float32, device="cpu")
    assert pc.keys() == rc.keys()
    for key in rc:
        assert tuple(pc[key].shape) == rc[key].shape
        assert not pc[key].any()
    toks = _tokens(cfg, B, steps, seed=1)
    for pos in range(steps):
        rl, rc = RT.lm_decode_step(rp, rc, jnp.asarray(toks[:, pos:pos + 1]),
                                   pos, rcfg, dtype=jnp.float32)
        pl, pc2 = T.lm_decode_step(pp, pc, toks[:, pos:pos + 1], pos, cfg,
                                   dtype=torch.float32)
        assert pc2 is pc                                  # written in place
        np.testing.assert_allclose(_np(pl), _np(rl), rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL, err_msg=f"pos {pos}")
        for key in rc:
            np.testing.assert_allclose(_np(pc[key]), _np(rc[key]),
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL)
    rc16 = RT.init_kv_cache(rcfg, B, S)
    pc16 = T.init_kv_cache(cfg, B, S, device="cpu")
    assert all(c.dtype == torch.bfloat16 for c in pc16.values())
    rl, _ = RT.lm_decode_step(rp, rc16, jnp.asarray(toks[:, :1]), 0, rcfg)
    pl, _ = T.lm_decode_step(pp, pc16, toks[:, :1], 0, cfg)
    _close_bf16(pl, rl)


@pytest.mark.parametrize("arch", MOE)
def test_moe_decode_matches_forward(arch):
    """The port's step-by-step decode equals its own teacher-forced
    forward at 2e-3, at a capacity factor of 16."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              capacity_factor=16.0)
    _, pp = _params(arch)
    B, S = 2, 12
    toks = _tokens(cfg, B, S)
    full = T.lm_forward(pp, toks, cfg, dtype=torch.float32)
    cache = T.init_kv_cache(cfg, B, S, dtype=torch.float32, device="cpu")
    dec = torch.cat([T.lm_decode_step(pp, cache, toks[:, p:p + 1], p, cfg,
                                      dtype=torch.float32)[0]
                     for p in range(S)], dim=1)
    np.testing.assert_allclose(_np(dec), _np(full), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", MOE)
def test_moe_greedy_generate_matches_reference(rng, arch):
    """Greedy ``LMServer.generate`` gives the reference server's tokens on
    the same params (f32 decode steps agree to ~1e-6), and the same
    tokens twice."""
    rp, pp = _params(arch)
    rcfg, cfg = ref_config(arch, reduced=True), get_config(arch, reduced=True)
    ref = RefServer(rp, rcfg, RefServeConfig(max_len=32))
    port = LMServer(pp, cfg, ServeConfig(max_len=32))
    prompts = rng.integers(0, cfg.vocab_size, (2, 6), dtype=np.int32)
    want = ref.generate(prompts, 8)
    got = port.generate(prompts, 8)
    assert got["tokens"].dtype == np.int32 and got["tokens"].shape == (2, 8)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(port.generate(prompts, 8)["tokens"],
                                  got["tokens"])


@pytest.mark.parametrize("arch", MOE)
def test_launch_serve_lm_moe_on_cpu(arch):
    """``python -m repro_torch.launch.serve --mode lm`` serves the MoE
    archs, reduced, on the CPU."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "lm",
         "--arch", arch, "--reduced", "--device", "cpu"], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["shape"] == [2, 16] and res["tokens_per_s"] > 0
