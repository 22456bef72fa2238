"""The port's model layers and dense LM (``repro_torch.models``) against
the JAX package's ``repro.models``, on the CPU, on the same numpy-seeded
inputs and on the reference's own params carried across by
``params_from_numpy``.

Tolerances: f32 functions 1e-5 (the same operations, summed in another
order; the RoPE tables' ``theta ** x`` may differ by an ulp); f32 logits
of the reduced LMs and their decode steps 1e-4 (two layers of the above);
bf16 functions and logits within 2^-6 of the largest reference value
(each side rounds its layer outputs to bf16, at most 2^-8 of a value, and
the roundings fall at other places in the two frameworks); the port's own
decode against its forward 2e-3, the reference's limit
(``tests/test_serve.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_config
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.sharding.spec import ShardCtx, rules_for_mesh

F32_TOL = 1e-5
LOGIT_TOL = 1e-4
BF16_REL = 2.0 ** -6
DENSE = ["qwen3-0.6b", "qwen1.5-4b", "chatglm3-6b"]


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


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_norms_match_reference(rng, dtype):
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    b = (0.1 * rng.standard_normal(16)).astype(np.float32)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    got = [L.rms_norm(_t(x, tdt), _t(w), 1e-6),
           L.layer_norm(_t(x, tdt), _t(w), _t(b), 1e-6)]
    want = [RL.rms_norm(_j(x, jdt), _j(w), 1e-6),
            RL.layer_norm(_j(x, jdt), _j(w), _j(b), 1e-6)]
    for g, r in zip(got, want):
        assert g.dtype == tdt
        if dtype == "f32":
            np.testing.assert_allclose(_np(g), _np(r), rtol=F32_TOL,
                                       atol=F32_TOL)
        else:
            _close_bf16(g, r)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("batched", [False, True], ids=["S", "BS"])
def test_rope_matches_reference(rng, fraction, batched):
    B, S, H, dh = 2, 9, 3, 16
    x = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    pos = (rng.integers(0, 4096, (B, S)) if batched
           else np.arange(S)).astype(np.int32)
    rd = int(dh * fraction) // 2 * 2
    cos, sin = L.rope_tables(torch.from_numpy(pos), rd, 1e6)
    rcos, rsin = RL.rope_tables(jnp.asarray(pos), rd, 1e6)
    for g, r in ((cos, rcos), (sin, rsin)):
        np.testing.assert_allclose(_np(g), _np(r), rtol=F32_TOL,
                                   atol=F32_TOL)
    got = L.apply_rope(_t(x), cos, sin, fraction)
    want = RL.apply_rope(_j(x), rcos, rsin, fraction)
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL,
                               atol=F32_TOL)
    if fraction < 1:                     # the tail of each head passes
        np.testing.assert_array_equal(_np(got)[..., rd:], x[..., rd:])


# the reference's cases (tests/test_layers.py), forward only, and a query
# offset (chunked prefill) and a v width other than q's (MLA)
@pytest.mark.parametrize("B,S,T,H,Hk,dh,dhv,causal,bs,off", [
    (2, 16, 16, 4, 2, 8, 8, True, 8, 0),
    (1, 8, 8, 2, 2, 16, 16, False, 4, 0),
    (2, 32, 32, 6, 3, 8, 8, True, 16, 0),
    (1, 24, 24, 4, 1, 8, 8, True, 8, 0),            # MQA
    (2, 8, 24, 4, 2, 8, 8, True, 8, 16),             # q at offset 16
    (1, 12, 12, 4, 4, 16, 8, True, 4, 0),            # dhv != dh
])
def test_blockwise_attention_matches_reference(rng, B, S, T, H, Hk, dh, dhv,
                                               causal, bs, off):
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, T, Hk, dh)).astype(np.float32)
    v = rng.standard_normal((B, T, Hk, dhv)).astype(np.float32)
    got = L.blockwise_attention(_t(q), _t(k), _t(v), causal=causal,
                                q_offset=off, block_size=bs)
    want = RL.blockwise_attention(_j(q), _j(k), _j(v), causal=causal,
                                  q_offset=off, block_size=bs)
    assert got.shape == (B, S, H, dhv)
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL,
                               atol=F32_TOL)
    scale = 1.0 / np.sqrt(dh)
    _, lse = L._attention_fwd_scan(_t(q), _t(k), _t(v), causal, off, bs,
                                   scale)
    _, rlse = RL._attention_fwd_scan(_j(q), _j(k), _j(v), causal, off, bs,
                                     scale)
    np.testing.assert_allclose(_np(lse), _np(rlse), rtol=F32_TOL,
                               atol=F32_TOL)


def test_blockwise_attention_bf16_and_block_precondition(rng):
    q, k, v = (rng.standard_normal((1, 16, 4, 8)).astype(np.float32)
               for _ in range(3))
    got = L.blockwise_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                                _t(v, torch.bfloat16), block_size=8)
    want = RL.blockwise_attention(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16),
                                  _j(v, jnp.bfloat16), block_size=8)
    assert got.dtype == torch.bfloat16
    _close_bf16(got, want)
    with pytest.raises(AssertionError, match="not divisible"):
        L.blockwise_attention(_t(q), _t(k), _t(v), block_size=6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_attention_matches_reference(rng, dtype):
    B, T, H, Hk, dh = 3, 10, 4, 2, 8
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    q = rng.standard_normal((B, 1, H, dh)).astype(np.float32)
    kc = rng.standard_normal((B, T, Hk, dh)).astype(np.float32)
    vc = rng.standard_normal((B, T, Hk, dh)).astype(np.float32)
    n = np.array([1, 6, 10], np.int32)
    got = L.decode_attention(_t(q), _t(kc, tdt), _t(vc, tdt),
                             torch.from_numpy(n))
    want = RL.decode_attention(_j(q), _j(kc, jdt), _j(vc, jdt),
                               jnp.asarray(n))
    np.testing.assert_allclose(_np(got), _np(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_swiglu_matches_reference(rng):
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    wi = (0.2 * rng.standard_normal((16, 48))).astype(np.float32)
    wo = (0.2 * rng.standard_normal((24, 16))).astype(np.float32)
    np.testing.assert_allclose(
        _np(L.swiglu_ffn(_t(x), _t(wi), _t(wo))),
        _np(RL.swiglu_ffn(_j(x), _j(wi), _j(wo))), rtol=F32_TOL,
        atol=F32_TOL)


# ------------------------------------------------------------ transformer
@functools.lru_cache(maxsize=None)
def _params(arch):
    """The reference's seeded params and the port's copy of them."""
    rcfg = ref_config(arch, reduced=True)
    rp = RT.init_lm(jax.random.key(0), rcfg)
    return rp, T.params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", DENSE)
def test_init_lm_shapes_and_stds(arch):
    cfg = get_config(arch, reduced=True)
    rp, _ = _params(arch)
    port = T.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    ref = jax.tree.map(np.asarray, rp)
    assert port.keys() == ref.keys()
    assert port["blocks"].keys() == ref["blocks"].keys()
    flat = [("embed", port["embed"], ref["embed"])] + [
        (k, port["blocks"][k], ref["blocks"][k]) for k in ref["blocks"]]
    for name, p, r in flat:
        assert tuple(p.shape) == r.shape and p.dtype == torch.float32, name
        # ones, zeros or normals of the reference's std (to 15%)
        np.testing.assert_allclose(p.std().item() if p.numel() > 1 else 0,
                                   r.std(), rtol=0.15, atol=1e-7,
                                   err_msg=name)
        np.testing.assert_allclose(p.mean().item(), r.mean(), atol=2e-3,
                                   err_msg=name)


@pytest.mark.parametrize("arch", DENSE)
def test_lm_forward_and_prefill_match_reference(arch):
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


@pytest.mark.parametrize("arch", DENSE)
def test_kv_cache_and_decode_step_match_reference(arch):
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
    # a bf16 cache, as the reference's default
    rc16 = RT.init_kv_cache(rcfg, B, S)
    pc16 = T.init_kv_cache(cfg, B, S, device="cpu")
    assert pc16["k"].dtype == torch.bfloat16
    rl, _ = RT.lm_decode_step(rp, rc16, jnp.asarray(toks[:, :1]), 0, rcfg)
    pl, _ = T.lm_decode_step(pp, pc16, toks[:, :1], 0, cfg)
    _close_bf16(pl, rl)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward(arch):
    """The port's step-by-step decode through the cache equals its own
    teacher-forced forward, at the reference's 2e-3."""
    cfg = get_config(arch, reduced=True)
    _, pp = _params(arch)
    B, S = 2, 12
    toks = _tokens(cfg, B, S)
    full = T.lm_forward(pp, toks, cfg, dtype=torch.float32)
    cache = T.init_kv_cache(cfg, B, S, dtype=torch.float32, device="cpu")
    dec = torch.cat([T.lm_decode_step(pp, cache, toks[:, p:p + 1], p, cfg,
                                      dtype=torch.float32)[0]
                     for p in range(S)], dim=1)
    np.testing.assert_allclose(_np(dec), _np(full), rtol=2e-3, atol=2e-3)


MESHES = {"2x1": (2, 1), "1x4": (1, 4), "2x2": (2, 2)}


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_dense_lm_on_a_mesh_is_the_one_device_lm(mesh):
    """A dense LM on a mesh: the reference's sharding constraints change
    no value, so the forward and the decode steps are the one-device
    ones bit for bit, and the reference's within LOGIT_TOL."""
    cfg = get_config("qwen3-0.6b", reduced=True)
    rp, pp = _params("qwen3-0.6b")
    shape = MESHES[mesh]
    n = int(np.prod(shape))
    m = Mesh(np.arange(n).reshape(shape), ("data", "model"), ["cpu"] * n)
    ctx = ShardCtx(mesh=m, rules=rules_for_mesh(m))
    toks = _tokens(cfg, 2, 8)
    got = T.lm_forward(pp, toks, cfg, ctx, dtype=torch.float32)
    assert torch.equal(got, T.lm_forward(pp, toks, cfg,
                                         dtype=torch.float32))
    want = RT.lm_forward(rp, jnp.asarray(toks), ref_config(
        "qwen3-0.6b", reduced=True), dtype=jnp.float32)
    np.testing.assert_allclose(_np(got), _np(want), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    caches = [T.init_kv_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
              for _ in range(2)]
    for p in range(3):
        a = T.lm_decode_step(pp, caches[0], toks[:, p:p + 1], p, cfg, ctx,
                             dtype=torch.float32)[0]
        b = T.lm_decode_step(pp, caches[1], toks[:, p:p + 1], p, cfg,
                             dtype=torch.float32)[0]
        assert torch.equal(a, b)


