"""The port's optimizer and gradient compression (``repro_torch.optim``)
against the JAX package's ``repro.optim``, on the CPU, on the same
numpy-seeded inputs.

Tolerances: the schedule and the global norm 1e-6 relative (f32
arithmetic in the same order of operations; the norm's sums in another
order); an AdamW step's params and moments 1e-6 relative and 1e-7
absolute (the same elementwise f32 operations); EF compression exact
where the quantised values agree, which they do away from a rounding
boundary (checked on the inputs used), else one quantisation step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as RA
from repro.optim import compress as RC
from repro_torch import tree
from repro_torch.optim import adamw as A
from repro_torch.optim import compress as C

REL = 1e-6


def _cfg(**kw):
    base = dict(lr=1e-2, warmup_steps=3, total_steps=20, weight_decay=0.01,
                clip_norm=1.0)
    base.update(kw)
    return A.OptimizerConfig(**base), RA.OptimizerConfig(**base)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _tree(rng, scale=1.0):
    return {"a": (scale * rng.standard_normal((3, 4))).astype(np.float32),
            "b": {"c": (scale * rng.standard_normal(5)).astype(np.float32),
                  "d": (scale * rng.standard_normal((2, 2))).astype(
                      np.float32)}}


def _torch(t):
    return tree.tree_map(lambda x: torch.from_numpy(np.array(x)), t)


@pytest.mark.parametrize("warmup,total,floor", [(10, 100, 0.1), (0, 10, 0.0),
                                                (3, 3, 0.5)])
def test_cosine_lr_matches_reference(warmup, total, floor):
    cfg, rcfg = _cfg(lr=0.7, warmup_steps=warmup, total_steps=total,
                     min_lr_frac=floor)
    for s in range(total + 3):
        got = float(A.cosine_lr(torch.tensor(s, dtype=torch.int32), cfg))
        want = float(RA.cosine_lr(jnp.asarray(s, jnp.int32), rcfg))
        assert got == pytest.approx(want, rel=REL, abs=1e-9)
        assert float(A.cosine_lr(s, cfg)) == pytest.approx(got, rel=REL)


def test_global_norm_matches_reference(rng):
    t = _tree(rng)
    got = float(A.global_norm(_torch(t)))
    want = float(RA.global_norm(jax.tree.map(jnp.asarray, t)))
    assert got == pytest.approx(want, rel=REL)
    assert float(A.global_norm({"a": torch.tensor([3.0]),
                                "b": torch.tensor([4.0])})) == 5.0


@pytest.mark.parametrize("grad_scale", [0.1, 100.0], ids=["unclipped",
                                                          "clipped"])
def test_adamw_steps_match_reference(rng, grad_scale):
    cfg, rcfg = _cfg()
    p0 = _tree(rng)
    params, rparams = _torch(p0), jax.tree.map(jnp.asarray, p0)
    state, rstate = A.adamw_init(params), RA.adamw_init(rparams)
    assert int(state["step"]) == 0 and state["step"].dtype == torch.int32
    for _ in range(5):
        g = _tree(rng, grad_scale)
        params, state, m = A.adamw_update(_torch(g), state, params, cfg)
        rparams, rstate, rm = RA.adamw_update(
            jax.tree.map(jnp.asarray, g), rstate, rparams, rcfg)
        for k in ("grad_norm", "lr"):
            assert float(m[k]) == pytest.approx(float(rm[k]), rel=REL)
        for got, want in ((params, rparams), (state["m"], rstate["m"]),
                          (state["v"], rstate["v"])):
            for a, b in zip(tree.leaves(got), jax.tree_util.tree_leaves(want)):
                np.testing.assert_allclose(_np(a), np.asarray(b), rtol=REL,
                                           atol=1e-7)
        assert int(state["step"]) == int(rstate["step"])
    if grad_scale > 1:
        assert float(m["grad_norm"]) > cfg.clip_norm     # recorded pre-clip


def test_adamw_optimizes_quadratic():
    cfg = A.OptimizerConfig(lr=0.1, warmup_steps=1, total_steps=200,
                            weight_decay=0.0, clip_norm=100.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = A.adamw_init(params)
    for _ in range(150):
        params, state, _ = A.adamw_update({"w": 2.0 * params["w"]}, state,
                                          params, cfg)
    assert float(params["w"].abs().max()) < 0.2


def test_apply_updates():
    got = A.apply_updates({"a": torch.ones(2), "b": [torch.zeros(1)]},
                          {"a": torch.full((2,), 2.0), "b": [torch.ones(1)]})
    assert got["a"].tolist() == [3.0, 3.0] and got["b"][0].tolist() == [1.0]


@pytest.mark.parametrize("bits", [4, 8])
def test_compress_decompress_matches_reference(rng, bits):
    g = rng.standard_normal(257).astype(np.float32)
    dq, res = C.compress_decompress(torch.from_numpy(g), bits)
    rdq, rres = RC.compress_decompress(jnp.asarray(g), bits)
    step = float(np.abs(g).max()) / (2 ** (bits - 1) - 1)
    np.testing.assert_allclose(_np(dq), np.asarray(rdq), rtol=0,
                               atol=1e-6 * step)
    np.testing.assert_allclose(_np(res), np.asarray(rres), rtol=0,
                               atol=1e-6 * step)
    assert float(res.abs().max()) <= step / 2 * (1 + 1e-6)   # quantisation
    np.testing.assert_allclose(_np(dq + res), g, rtol=1e-6, atol=1e-6)


def test_ef_compress_grads_matches_reference(rng):
    g, r = _tree(rng), _tree(rng, 0.1)
    got, res = C.ef_compress_grads(_torch(g), _torch(r), 8)
    want, rres = RC.ef_compress_grads(jax.tree.map(jnp.asarray, g),
                                      jax.tree.map(jnp.asarray, r), 8)
    for a, b in zip(tree.leaves(got) + tree.leaves(res),
                    jax.tree_util.tree_leaves(want)
                    + jax.tree_util.tree_leaves(rres)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    zeros = C.ef_init(_torch(g))
    assert all(float(z.abs().max()) == 0 and z.dtype == torch.float32
               for z in tree.leaves(zeros))


def test_ef_training_converges():
    """int8-EF AdamW still optimizes (the reference's sanity check)."""
    cfg = A.OptimizerConfig(lr=0.1, warmup_steps=1, total_steps=300,
                            weight_decay=0.0)
    params = {"w": torch.tensor([4.0, -2.0, 1.0])}
    state, residual = A.adamw_init(params), C.ef_init(params)
    for _ in range(200):
        grads, residual = C.ef_compress_grads({"w": 2.0 * params["w"]},
                                              residual, 8)
        params, state, _ = A.adamw_update(grads, state, params, cfg)
    assert float(params["w"].abs().max()) < 0.3


def test_tree_keys_are_jax_keystr(rng):
    t = {"opt": {"m": {"blocks": {"wq": 1, "ln1": 2}}, "step": 3},
         "params": [4, (5, 6)]}
    got = tree.keyed_leaves(t)
    want = [(jax.tree_util.keystr(p), x) for p, x in
            jax.tree_util.tree_flatten_with_path(t)[0]]
    assert got == want
    back = tree.from_keyed(got)
    assert back == {"opt": {"m": {"blocks": {"wq": 1, "ln1": 2}}, "step": 3},
                    "params": [4, [5, 6]]}
