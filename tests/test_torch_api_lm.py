"""The port's Arch API at the LM cells (``repro_torch.models.api``,
``train_4k``, ``prefill_32k``, ``decode_32k``, ``long_500k`` of the five
LMs, reduced) against ``jax.jit`` of the JAX package's cells, on the
reference's realized arguments carried across.  Every LM step computes
in bf16, the reference's default (``lm_loss``, ``lm_prefill`` and
``lm_decode_step`` with no dtype), so the tolerances are bf16's:

* prefill logits, decode logits and the written cache: within 2^-6 of
  the largest magnitude (``tests/test_torch_models.py``'s bf16 rule);
* a train step's loss within 2^-8 relative (one bf16 rounding), its
  gradient norm within 2^-6, its accuracy within 2 tokens' share, its
  lr and token count equal; AdamW's moments within 2^-4 relative L2 a
  leaf (bf16 gradients, their products rounded at other places: 0.04 on
  Qwen1.5-4B's zero-initialised biases, ~0.005 elsewhere); the updated
  params within rtol 1e-5 / atol 1e-9 plus lr times the difference of
  the two steps' normalised updates m^ / (sqrt(v^) + eps), each from its
  own moments (at step 1 that update is g / (|g| + eps) ~ sign(g): a
  gradient the two frameworks put on either side of 0, or near eps,
  moves the parameter by up to 2 lr, as ``tests/test_torch_train.py``
  holds it).
"""

import jax
import numpy as np
import pytest

from repro.configs import shapes_for
from repro.configs.registry import ARCH_IDS, get_config
from repro.models import api as RA
from repro_torch import tree
from repro_torch.models import api as A
from repro_torch.optim.adamw import cosine_lr

from test_torch_api import _np, _rel, to_port

LM_CASES = [(a, s.shape_id) for a in ARCH_IDS
            if type(get_config(a)).__name__ == "LMConfig"
            for s in shapes_for(get_config(a, reduced=True))]
BF16_ROW = 2.0 ** -6
LOSS_REL = 2.0 ** -8
MOMENT_REL = 2.0 ** -4


def _close_bf16(got, want, msg=""):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=BF16_ROW * np.abs(want).max(),
                               err_msg=msg)


def _check_lm_train_step(got, want, tokens: int):
    (gs, gm), (ws, wm) = got, want
    assert gm.keys() == wm.keys()
    assert float(gm["lr"]) == float(wm["lr"])
    assert float(gm["tokens"]) == float(wm["tokens"])
    assert float(gm["loss"]) == pytest.approx(float(wm["loss"]),
                                              rel=LOSS_REL)
    assert float(gm["grad_norm"]) == pytest.approx(float(wm["grad_norm"]),
                                                   rel=BF16_ROW)
    assert abs(float(gm["accuracy"]) - float(wm["accuracy"])) <= 2 / tokens
    wl = dict((jax.tree_util.keystr(p), x) for p, x in
              jax.tree_util.tree_flatten_with_path(ws)[0])
    gl = dict(tree.keyed_leaves(gs))
    assert gl.keys() == wl.keys()
    assert int(gl["['opt']['step']"]) == int(wl["['opt']['step']"]) == 1
    lr = float(cosine_lr(1, A.OPT))
    for key, w in wl.items():
        if key.startswith("['opt']['m']") or key.startswith("['opt']['v']"):
            assert _rel(gl[key], w) <= MOMENT_REL, key
        if not key.startswith("['params']"):
            continue
        tail = key[len("['params']"):]
        g, r = _np(gl[key]), _np(w)
        du = np.abs(_update(gl, tail) - _update(wl, tail))
        assert (np.abs(g - r) <= 1e-5 * np.abs(r) + 1e-9
                + lr * du * (1 + 1e-3)).all(), key


def _update(leaves, tail: str) -> np.ndarray:
    """AdamW's first normalised update, m^ / (sqrt(v^) + eps), from a
    step's own moments."""
    o = A.OPT
    m = _np(leaves["['opt']['m']" + tail]).astype(np.float64) / (1 - o.b1)
    v = _np(leaves["['opt']['v']" + tail]).astype(np.float64) / (1 - o.b2)
    return m / (np.sqrt(v) + o.eps)


@pytest.mark.parametrize("arch,shape", LM_CASES,
                         ids=[f"{a}-{s}" for a, s in LM_CASES])
def test_lm_step_matches_reference(arch, shape):
    rc = RA.build_cell(arch, shape, reduced=True)
    pc = A.build_cell(arch, shape, reduced=True)
    args = RA.realize(rc)
    want = jax.jit(rc.fn)(*args)
    got = pc.fn(*to_port(args))
    if pc.step == "train_step":
        _check_lm_train_step(got, want, args[1]["tokens"].size)
    elif pc.step == "prefill":
        assert tuple(got.shape) == tuple(want.shape)
        _close_bf16(got, want)
    else:
        logits, cache = got
        wlogits, wcache = want
        _close_bf16(logits, wlogits)
        assert cache.keys() == wcache.keys()
        for key in wcache:
            assert str(cache[key].dtype).endswith(str(wcache[key].dtype))
            _close_bf16(cache[key], wcache[key], key)


def test_lm_train_loss_is_sane():
    """A reduced LM's train cell starts near ln(vocab) on an ``lm_batch``,
    as the reference's ``test_lm_train_loss_is_sane``."""
    from repro_torch.data.synthetic import lm_batch
    pc = A.build_cell("qwen3-0.6b", "train_4k", reduced=True)
    state, _ = A.realize(pc, device="cpu")
    cfg = get_config("qwen3-0.6b", reduced=True)
    batch = lm_batch(np.random.default_rng(0), 2, 32, cfg.vocab_size)
    _, m = pc.fn(state, batch)
    assert abs(float(m["loss"]) - np.log(cfg.vocab_size)) < 0.5
    assert np.isfinite(float(m["grad_norm"]))
