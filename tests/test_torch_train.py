"""The port's training path (``repro_torch.train``, ``models.transformer.
lm_loss``, the flash VJP in ``models.layers``, ``data.synthetic.lm_batch``,
``launch.train``) against the JAX package's, on the CPU, at the reduced
configs (``REDUCED``: 2 layers, d 128, dh 32), on numpy-seeded inputs and
the reference's own params carried across by ``params_from_numpy``.

Tolerances: attention gradients rtol 1e-5 / atol 1e-5 (the same f32
operations; sums of up to 32 terms in another order); ``lm_loss`` and its
gradients rtol 1e-4 / atol 1e-5 (two layers of the above, an f32 softmax
over the vocabulary); three train steps: losses 1e-5 relative, gradient
norms 1e-4 (the norm of gradients held to 1e-4), each step's gradients (at the reference's params) rtol 1e-4 /
atol 1e-5, and params within
1e-5 plus the step's lr times 2 * (1 + wd) for each step where a
gradient lies within the gradients' own atol (1e-5) of 0 (Adam's sign
effect: at step 1 m^/sqrt(v^) = g / (|g| + eps) ~ sign(g), so a gradient
the two frameworks put on opposite sides of 0 moves the parameter by a
whole lr either way; with int8 EF compression also where g + residual
lies within 1e-4 of a step of a rounding edge, where the transmitted
value may differ by a step) and 1e-5 + 1e-4 relative elsewhere; such
elements are under 5% of all outside the routed experts' weights (w1,
w2: an expert's gradient comes from the few tokens routed to it, so more
of it lies within atol of 0), and a gradient exactly 0 on both sides (an
expert no token reached) is held to the strict bound.  The three steps
run on the dense arch and on both MoE archs (Qwen3-30B-A3B;
DeepSeek-V2-Lite with MLA, v narrower than q and k).  Under EF a step that differs is carried
in the residual into later steps, so there the params are held to the
first bound everywhere and to the second on all but 1% of elements.  Microbatching is held to the full batch
as the reference holds it (rtol 2e-3, atol 2e-5 on the params) and its
gradients to 1e-5.  Checkpoints: equal leaves, bit for bit.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_config
from repro.data.synthetic import lm_batch as ref_lm_batch
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.optim.adamw import OptimizerConfig as RefOptimizerConfig
from repro.train import checkpoint as rckpt
from repro.train.loop import TrainConfig as RefTrainConfig
from repro.train.loop import init_state as ref_init_state
from repro.train.loop import make_train_step as ref_make_train_step
from repro_torch import tree
from repro_torch.configs.registry import get_config
from repro_torch.data.synthetic import lm_batch
from repro_torch.kernels.flash_attn import (flash_attention_bwd,
                                            flash_attn_bwd_ref, flash_attn_ref)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import (FaultInjector, StepDeadline,
                                     StragglerTimeout, WorkerFailure,
                                     reshard_state, supervise)
from repro_torch.train.loop import (TrainConfig, value_and_grad,
                                    init_state, make_train_step, run)

ATTN_TOL = 1e-5
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5
ARCH = "qwen3-0.6b"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ref_params(arch, seed=0):
    cfg = ref_config(arch, reduced=True)
    return cfg, RT.init_lm(jax.random.key(seed), cfg)


def _port(ref_params):
    return T.params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")


def _loss_fns(arch):
    cfg, rcfg = get_config(arch, reduced=True), ref_config(arch, reduced=True)

    def loss_fn(p, batch):
        return T.lm_loss(p, batch, cfg, dtype=torch.float32)

    def ref_loss_fn(p, batch):
        return RT.lm_loss(p, batch, rcfg, RL.LOCAL_CTX, dtype=jnp.float32)
    return loss_fn, ref_loss_fn


def _batch(cfg, batch=2, seq=16, seed=0):
    return lm_batch(np.random.default_rng(seed), batch, seq, cfg.vocab_size)


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _close_trees(got, want, rtol, atol):
    pairs = list(zip(tree.keyed_leaves(got), jax.tree_util.tree_leaves(want),
                     strict=True))
    for (key, a), b in pairs:
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=rtol,
                                   atol=atol, err_msg=key)


# ------------------------------------------------------------- attention
# the reference's cases (tests/test_layers.py), a v narrower than q and k
# (MLA), and queries at an offset (chunked prefill)
@pytest.mark.parametrize("B,S,T_,H,Hk,dh,dhv,causal,bs,off", [
    (2, 16, 16, 4, 2, 8, 8, True, 8, 0),
    (1, 8, 8, 2, 2, 16, 16, False, 4, 0),
    (2, 32, 32, 6, 3, 8, 8, True, 16, 0),
    (1, 24, 24, 4, 1, 8, 8, True, 8, 0),            # MQA
    (1, 12, 12, 4, 4, 16, 8, True, 4, 0),           # dhv < dh
    (2, 8, 24, 4, 2, 8, 8, True, 8, 16),            # q at offset 16
])
def test_attention_grads_match_reference(rng, B, S, T_, H, Hk, dh, dhv,
                                         causal, bs, off):
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, T_, Hk, dh)).astype(np.float32)
    v = rng.standard_normal((B, T_, Hk, dhv)).astype(np.float32)
    xs = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = L.blockwise_attention(*xs, causal=causal, q_offset=off,
                                block_size=bs)
    assert out.grad_fn is not None
    torch.sin(out).sum().backward()
    want = jax.grad(lambda a, b, c: jnp.sum(jnp.sin(RL.blockwise_attention(
        a, b, c, causal=causal, q_offset=off, block_size=bs))),
        argnums=(0, 1, 2))(q, k, v)
    for x, w in zip(xs, want):
        np.testing.assert_allclose(_np(x.grad), np.asarray(w),
                                   rtol=ATTN_TOL, atol=ATTN_TOL)


def test_attention_without_grad_runs_the_forward_alone(rng):
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 8, 2, 8)).astype(
        np.float32)) for _ in range(3))
    assert L.blockwise_attention(q, k, v).grad_fn is None
    q.requires_grad_()
    with torch.no_grad():
        assert L.blockwise_attention(q, k, v).grad_fn is None


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_bwd_ref_matches_reference_vjp(rng, causal):
    """``flash_attn_bwd_ref`` (the kernel's plain version) on the
    reference's own residuals equals its ``_flash_bwd``; the plain
    forward's lse (B, H, S) is the reference scan's (B, Hk, G, S)."""
    B, S, H, Hk, dh = 2, 16, 4, 2, 8
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, S, H, dh), (B, S, Hk, dh), (B, S, Hk, dh), (B, S, H, dh)))
    scale = 1 / np.sqrt(dh)
    out, lse = RL._attention_fwd_scan(q, k, v, causal, 0, 8, scale)
    want = RL._flash_bwd(causal, 0, 8, scale, (q, k, v, out, lse), do)
    got = flash_attn_bwd_ref(*(torch.from_numpy(np.array(x)) for x in (
        q, k, v, out, lse, do)), causal=causal, scale=scale, block_size=8)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=ATTN_TOL,
                                   atol=ATTN_TOL)
    o2, lse2 = flash_attn_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=causal, return_lse=True)
    assert lse2.shape == (B, H, S)
    np.testing.assert_allclose(_np(lse2), np.asarray(lse).reshape(B, H, S),
                               rtol=ATTN_TOL, atol=ATTN_TOL)
    np.testing.assert_allclose(_np(o2), np.asarray(out), rtol=ATTN_TOL,
                               atol=ATTN_TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dh,dv", [(48, 32), (24, 8)], ids=["48x32",
                                                            "24x8"])
def test_flash_attention_bwd_narrow_v_matches_reference(rng, causal, dh,
                                                        dv):
    """The backward's entry point (``flash_attention_bwd``, on CPU tensors
    its plain version) with v narrower than q and k (MLA's training: the
    reduced DeepSeek config's 48 x 32), GQA, on the reference's residuals,
    equals its ``_flash_bwd``; dq and dk keep q's width, dv v's."""
    B, S, H, Hk = 2, 32, 4, 2
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, S, H, dh), (B, S, Hk, dh), (B, S, Hk, dv), (B, S, H, dv)))
    scale = 1 / np.sqrt(dh)
    out, lse = RL._attention_fwd_scan(q, k, v, causal, 0, 16, scale)
    want = RL._flash_bwd(causal, 0, 16, scale, (q, k, v, out, lse), do)
    lse_t = torch.from_numpy(np.array(lse)).reshape(B, H, S)
    got = flash_attention_bwd(*(torch.from_numpy(np.array(x)) for x in (
        q, k, v, out)), lse_t, torch.from_numpy(do), causal=causal,
        block_size=16)
    for a, b, x in zip(got, want, (q, k, v)):
        assert a.shape == x.shape
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=ATTN_TOL,
                                   atol=ATTN_TOL)


# ------------------------------------------------------------------ loss
@pytest.mark.parametrize("arch", [ARCH, "qwen3-moe-30b-a3b",
                                  "deepseek-v2-lite-16b"])
def test_lm_loss_and_grads_match_reference(arch):
    rcfg, rparams = _ref_params(arch)
    loss_fn, ref_loss_fn = _loss_fns(arch)
    batch = _batch(rcfg, seed=3)
    batch["mask"] = (np.arange(16)[None] < np.array([[16], [11]])).astype(
        np.float32)
    (rloss, rm), rgrads = jax.value_and_grad(ref_loss_fn, has_aux=True)(
        rparams, _jbatch(batch))
    grads, m = value_and_grad(loss_fn, _port(rparams), batch)
    for k in ("loss", "accuracy", "tokens"):
        assert float(m[k]) == pytest.approx(float(rm[k]), rel=LOSS_RTOL)
    _close_trees(grads, rgrads, LOSS_RTOL, LOSS_ATOL)


def test_lm_loss_rematerialises_under_grad(monkeypatch):
    """Each block runs once in the forward and once more in the backward
    (the reference's full remat); without grad, once."""
    cfg = get_config(ARCH, reduced=True)
    params = T.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    calls = []
    block = T._block
    monkeypatch.setattr(T, "_block", lambda *a: calls.append(1) or block(*a))
    loss_fn, _ = _loss_fns(ARCH)
    value_and_grad(loss_fn, params, _batch(cfg))
    assert len(calls) == 2 * cfg.n_layers
    calls.clear()
    T.lm_loss(params, _batch(cfg), cfg, dtype=torch.float32)
    assert len(calls) == cfg.n_layers


def test_lm_batch_matches_reference():
    got = lm_batch(np.random.default_rng(5), 3, 7, 100)
    want = ref_lm_batch(np.random.default_rng(5), 3, 7, 100)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == np.int32
    np.testing.assert_array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])


# ------------------------------------------------------------ train step
def _opt():
    return dict(lr=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.01)


def _on_rounding_edge(x: np.ndarray) -> np.ndarray:
    """Where int8 EF quantisation (``round(x / scale)``) of x may round
    either way: within 1e-4 of a step of a half-integer."""
    y = np.abs(x) / (np.abs(x).max() / 127)
    return np.abs(y - np.floor(y) - 0.5) < 1e-4


# the dense arch keeps its ids; the MoE archs (DeepSeek-V2-Lite with MLA)
# at their reduced configs beside it
STEP_CASES = [pytest.param(arch, bits, id=("" if arch == ARCH else
                                           arch + "-") + bid)
              for arch in (ARCH, "qwen3-moe-30b-a3b", "deepseek-v2-lite-16b")
              for bits, bid in ((0, "plain"), (8, "ef_int8"))]


@pytest.mark.parametrize("arch,bits", STEP_CASES)
def test_three_train_steps_match_reference(arch, bits):
    rcfg, rparams = _ref_params(arch)
    loss_fn, ref_loss_fn = _loss_fns(arch)
    tcfg = TrainConfig(opt=OptimizerConfig(**_opt()), grad_compress_bits=bits)
    rtcfg = RefTrainConfig(opt=RefOptimizerConfig(**_opt()),
                           grad_compress_bits=bits)
    step, rstep = make_train_step(loss_fn, tcfg), ref_make_train_step(
        ref_loss_fn, rtcfg)
    state, rstate = init_state(_port(rparams), tcfg), ref_init_state(
        rparams, rtcfg)
    rng = np.random.default_rng(1)
    near_zero = None
    slack = 0.0
    for i in range(3):
        batch = lm_batch(rng, 2, 16, rcfg.vocab_size)
        # the port's gradient at the reference's params (so a parameter
        # moved by the sign effect cannot spread into later comparisons)
        grads, _ = value_and_grad(loss_fn, _port(rstate["params"]), batch)
        _, rgrads = jax.value_and_grad(ref_loss_fn, has_aux=True)(
            rstate["params"], _jbatch(batch))
        _close_trees(grads, rgrads, LOSS_RTOL, LOSS_ATOL)
        residuals = rstate.get("ef")
        state, m = step(state, batch)
        rstate, rm = rstep(rstate, _jbatch(batch))
        for k, rel in (("loss", 1e-5), ("accuracy", 1e-5), ("lr", 1e-5),
                       ("grad_norm", LOSS_RTOL)):
            assert float(m[k]) == pytest.approx(float(rm[k]), rel=rel)
        # both exactly 0 (an expert no token reached): Adam moves both
        # sides alike, so those are held to the strict bound
        zero = [(np.abs(np.asarray(g)) <= LOSS_ATOL)
                & ~((np.asarray(g) == 0) & (_np(p) == 0))
                for g, p in zip(jax.tree_util.tree_leaves(rgrads),
                                tree.leaves(grads))]
        if bits:     # and where g + r lies on a rounding edge of int8
            zero = [z | _on_rounding_edge(np.asarray(g) + np.asarray(r))
                    for z, g, r in zip(zero, jax.tree_util.tree_leaves(
                        rgrads), jax.tree_util.tree_leaves(residuals))]
        near_zero = zero if near_zero is None else [
            a | b for a, b in zip(near_zero, zero)]
        slack += float(rm["lr"]) * 2 * (1 + _opt()["weight_decay"])
        outside = total = 0
        for (key, a), b, z in zip(tree.keyed_leaves(state["params"]),
                                  jax.tree_util.tree_leaves(rstate["params"]),
                                  near_zero, strict=True):
            a, b = _np(a), np.asarray(b)
            assert np.all(np.abs(a - b) <= 1e-5 + slack), key
            far = ~np.isclose(a, b, rtol=1e-4, atol=1e-5) & ~z
            assert bits or not far.any(), key
            outside, total = outside + int(far.sum()), total + a.size
        assert outside <= 1e-2 * total
        # rare, outside the routed experts (w1, w2: each expert's gradient
        # comes from the few of the batch's tokens routed to it, so more of
        # it lies within atol of 0; the bounds above still hold it)
        dense = [z for (key, _), z in zip(tree.keyed_leaves(state["params"]),
                                          near_zero)
                 if not key.endswith(("['w1']", "['w2']"))]
        flagged = sum(int(z.sum()) for z in dense)
        assert flagged < 5e-2 * sum(z.size for z in dense)
    assert int(state["opt"]["step"]) == 3


def test_microbatching_matches_full_batch():
    cfg = get_config(ARCH, reduced=True)
    loss_fn, _ = _loss_fns(ARCH)
    params = T.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    base = TrainConfig(opt=OptimizerConfig(lr=1e-3, warmup_steps=0,
                                           total_steps=10))
    micro = TrainConfig(opt=base.opt, microbatches=2)
    batch = _batch(cfg, batch=4)
    s1, m1 = make_train_step(loss_fn, base)(init_state(params, base), batch)
    s2, m2 = make_train_step(loss_fn, micro)(init_state(params, micro), batch)
    assert float(m2["grad_norm"]) == pytest.approx(float(m1["grad_norm"]),
                                                   rel=1e-5)
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    for a, b in zip(tree.leaves(s1["params"]), tree.leaves(s2["params"])):
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-3, atol=2e-5)
    g1, _ = value_and_grad(loss_fn, params, batch)
    halves = [value_and_grad(loss_fn, params, {k: v[i:i + 2] for k, v in
                                                batch.items()})[0]
              for i in (0, 2)]
    for a, b, c in zip(tree.leaves(g1), *(tree.leaves(h) for h in halves)):
        np.testing.assert_allclose(_np(a), (_np(b) + _np(c)) / 2,
                                   rtol=1e-5, atol=1e-7)


def test_loss_decreases():
    """The reference's recipe: one batch repeated, lr 1e-3, 25 steps."""
    cfg = get_config(ARCH, reduced=True)
    loss_fn, _ = _loss_fns(ARCH)
    tcfg = TrainConfig(opt=OptimizerConfig(lr=1e-3, warmup_steps=2,
                                           total_steps=40))
    step = make_train_step(loss_fn, tcfg)
    state = init_state(T.init_lm(torch.Generator().manual_seed(0), cfg,
                                 device="cpu"), tcfg)
    batch = _batch(cfg)
    losses = []
    for _ in range(25):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5


def test_train_step_leaves_its_inputs_alone():
    cfg = get_config(ARCH, reduced=True)
    loss_fn, _ = _loss_fns(ARCH)
    tcfg = TrainConfig(opt=OptimizerConfig(**_opt()))
    params = T.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    before = {k: v.clone() for k, v in params["blocks"].items()}
    state = init_state(params, tcfg)
    new, _ = make_train_step(loss_fn, tcfg)(state, _batch(cfg))
    assert all(not t.requires_grad for t in tree.leaves(new))
    for k, v in before.items():
        assert torch.equal(params["blocks"][k], v)
        assert not params["blocks"][k].requires_grad
    assert int(state["opt"]["step"]) == 0 and int(new["opt"]["step"]) == 1


# ------------------------------------------------------------ checkpoints
def _ref_state(seed=0):
    rcfg, rparams = _ref_params(ARCH, seed)
    return ref_init_state(rparams, RefTrainConfig())


def test_checkpoint_written_by_reference_restores_in_port(tmp_path):
    rstate = _ref_state()
    rstate["opt"]["m"]["embed"] = rstate["params"]["embed"] * 3
    rstate["opt"]["step"] = jnp.asarray(7, jnp.int32)
    rckpt.save(str(tmp_path), 7, rstate)
    got, step = ckpt.restore(str(tmp_path), device="cpu")
    assert step == 7
    pairs = list(zip(tree.keyed_leaves(got),
                     jax.tree_util.tree_leaves(rstate), strict=True))
    for (key, a), b in pairs:
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, key
        np.testing.assert_array_equal(a.numpy(), b, err_msg=key)
    like = tree.tree_map(lambda x: torch.empty(x.shape, device="meta"), got)
    again, _ = ckpt.restore(str(tmp_path), like, device="cpu")
    assert [k for k, _ in tree.keyed_leaves(again)] == [
        k for k, _ in tree.keyed_leaves(got)]


def test_checkpoint_written_by_port_restores_in_reference(tmp_path):
    cfg = get_config(ARCH, reduced=True)
    tcfg = TrainConfig(opt=OptimizerConfig(**_opt()))
    state = init_state(T.init_lm(torch.Generator().manual_seed(0), cfg,
                                 device="cpu"), tcfg)
    state, _ = make_train_step(_loss_fns(ARCH)[0], tcfg)(state, _batch(cfg))
    ckpt.save(str(tmp_path), 1, state)
    proto = jax.eval_shape(lambda: _ref_state())
    rstate, step = rckpt.restore(str(tmp_path), proto)
    assert step == 1
    pairs = list(zip(tree.keyed_leaves(state),
                     jax.tree_util.tree_leaves(rstate), strict=True))
    for (key, a), b in pairs:
        b = np.asarray(b)
        assert b.dtype == a.numpy().dtype, key
        np.testing.assert_array_equal(a.numpy(), b, err_msg=key)
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        keys = [e["key"] for e in json.load(f)["keys"]]
    assert keys == sorted(keys) and "['opt']['m']['blocks']['wq']" in keys


def test_checkpoint_bf16_and_int_leaves_round_trip(tmp_path):
    """A bf16 leaf is written as its 16-bit patterns (dtype "bfloat16" in
    the manifest) and read back bit for bit."""
    t = {"w": torch.randn(5, 3).to(torch.bfloat16),
         "n": torch.arange(4, dtype=torch.int64), "s": torch.tensor(3),
         "seq": [torch.ones(2), torch.zeros(1, dtype=torch.int32)]}
    ckpt.save(str(tmp_path), 2, t)
    with open(tmp_path / "step_00000002" / "manifest.json") as f:
        dtypes = {e["key"]: e["dtype"] for e in json.load(f)["keys"]}
    assert dtypes["['w']"] == "bfloat16" and dtypes["['n']"] == "int64"
    got, _ = ckpt.restore(str(tmp_path), device="cpu")
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), t["w"].view(torch.int16))
    assert torch.equal(got["n"], t["n"]) and int(got["s"]) == 3
    assert torch.equal(got["seq"][1], t["seq"][1])


def test_checkpoint_gc_latest_and_atomicity(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, {"x": torch.zeros(3)}, keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert len([d for d in os.listdir(tmp_path)
                if d.startswith("step_")]) == 2
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert ckpt.latest_step(str(tmp_path)) == 5    # tmp dirs ignored
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), device="cpu")


# ----------------------------------------------------------------- faults
def _supervised(tmp_path, on_step, total, fail_at=()):
    cfg = get_config(ARCH, reduced=True)
    loss_fn, _ = _loss_fns(ARCH)
    tcfg = TrainConfig(opt=OptimizerConfig(lr=1e-3, warmup_steps=1,
                                           total_steps=30),
                       ckpt_every=5, ckpt_dir=str(tmp_path))

    def init_fn():
        return init_state(T.init_lm(torch.Generator().manual_seed(0), cfg,
                                    device="cpu"), tcfg)

    def batches(n):
        rng = np.random.default_rng(0)
        for _ in range(n):
            yield lm_batch(rng, 2, 16, cfg.vocab_size)
    return supervise(lambda: make_train_step(loss_fn, tcfg), init_fn,
                     batches, tcfg, total_steps=total, max_restarts=5,
                     on_step=on_step, device="cpu")


def test_supervisor_survives_injected_failures(tmp_path):
    state, restarts, history = _supervised(tmp_path, FaultInjector([7, 13]),
                                           20)
    assert restarts == 2
    assert int(state["opt"]["step"]) >= 20
    assert ckpt.latest_step(str(tmp_path)) == 20


def test_supervisor_resumes_from_checkpoint_not_zero(tmp_path):
    """After a crash at step 7 with ckpt_every=5, training resumes from 5."""
    seen = []

    def on_step(step):
        seen.append(step)
        if step == 7 and 7 not in seen[:-1]:
            raise WorkerFailure("boom")
    state, restarts, _ = _supervised(tmp_path, on_step, 10)
    assert restarts == 1
    assert seen[seen.index(7) + 1] == 5
    assert int(state["opt"]["step"]) == 10
    # a supervisor started over an existing checkpoint resumes from it
    seen.clear()
    _, restarts, _ = _supervised(tmp_path, on_step, 12)
    assert restarts == 0 and seen == [10, 11]


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    def always(step):
        if step == 2:
            raise WorkerFailure("again")
    with pytest.raises(WorkerFailure):
        _supervised(tmp_path, always, 4)


def test_straggler_deadline():
    import time
    d = StepDeadline(deadline_s=0.01)
    d.start()
    time.sleep(0.03)
    with pytest.raises(StragglerTimeout):
        d.finish()
    assert d.p99() > 0.01


def test_reshard_state_replaces_values_unchanged():
    state = {"a": torch.arange(3.0), "b": {"c": torch.ones(2)}}
    kept = reshard_state(state, {"a": None, "b": {"c": torch.device("cpu")}})
    assert kept["a"] is state["a"] and torch.equal(kept["b"]["c"],
                                                   state["b"]["c"])


def test_run_logs_and_checkpoints(tmp_path):
    cfg = get_config(ARCH, reduced=True)
    tcfg = TrainConfig(opt=OptimizerConfig(**_opt()), ckpt_every=2,
                       ckpt_dir=str(tmp_path), keep_ckpts=1)
    state = init_state(T.init_lm(torch.Generator().manual_seed(0), cfg,
                                 device="cpu"), tcfg)
    rng = np.random.default_rng(0)
    batches = [lm_batch(rng, 2, 8, cfg.vocab_size) for _ in range(4)]
    _, step, history = run(make_train_step(_loss_fns(ARCH)[0], tcfg), state,
                           batches, tcfg, start_step=3, log_every=2)
    assert step == 7
    assert [h["step"] for h in history] == [4, 6]
    assert ckpt.latest_step(str(tmp_path)) == 6
    assert len(os.listdir(tmp_path)) == 1


def test_launch_train_cli(monkeypatch, capsys, tmp_path):
    from repro_torch.launch import train as launch_train
    log = tmp_path / "h.json"
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", ARCH, "--reduced", "--device", "cpu", "--steps",
        "10", "--batch", "2", "--seq", "8", "--log", str(log),
        "--microbatches", "2", "--grad-compress-bits", "8"])
    launch_train.main()
    out = capsys.readouterr().out
    assert "params=" in out and "over 10 steps" in out
    assert [h["step"] for h in json.loads(log.read_text())] == [1, 10]
