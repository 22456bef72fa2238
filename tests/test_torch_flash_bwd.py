"""The attention backward kernel's design on the CPU: its planner
(``flash_bwd_plan``: instance, width, term count) and a plain-torch
emulation of its arithmetic held against the reference's ``_flash_bwd``
(``repro/models/layers.py``).

The kernel (``csrc/flash_attn_bwd.cu``) runs every product on bf16
tensor cores: each f32 operand is split into bf16 terms, x = x0 + x1 +
x2 (x0 = bf16(x), x1 = bf16(x - x0), x2 = bf16(x - x0 - x1)), and a
product is summed over the term pairs (i, j) with i + j <= 2.  q, k, v and
dO take the planner's terms (one for bf16 inputs, which are exact in
bf16; three for f32); P and dS always three.  The emulation forms the
same products exactly (bf16 terms held in f64) and rounds each sum to f32
where the kernel's f32 accumulators hold it.  Tolerances are the smoke's
(``chip_smoke.BWD_RTOL``): relative L2 1e-4 for f32 gradients, against
the reference; 6.7e-5 for gradients rounded to bf16 (on bf16 inputs),
against the same f32 arithmetic on unsplit operands rounded alike, so
that only the term split shows.  One bf16 term of P and dS (what SDPA's
bf16 backward does) fails the bf16 limit: the test holds the design to
its three.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro_torch.kernels.flash_attn import (BWD_BF16_KEY, BWD_KEY,
                                            flash_bwd_plan, flash_bwd_width)

BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 6.7e-5}
P_TERMS = 3                     # terms of P and dS in the kernel


@pytest.mark.parametrize("dh", [1, 6, 36, 64, 96, 100, 128])
@pytest.mark.parametrize("dtype,key,terms", [
    (torch.float32, BWD_KEY, 3), (torch.bfloat16, BWD_BF16_KEY, 1),
    (torch.float16, BWD_KEY, 3), (torch.uint8, BWD_BF16_KEY, 1)])
def test_bwd_plan(dtype, key, terms, dh):
    plan = flash_bwd_plan(dtype, dh)
    w = -(-dh // 8) * 8                     # bf16 operands: 16-byte rows
    assert plan == (key, 64 if w <= 64 else 128, w, terms)
    assert plan.width == flash_bwd_width(dh) and plan.width >= dh
    assert flash_bwd_plan(dtype, dh, dh) == plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_plan_rejects_what_it_lacks(dtype):
    for dh in (0, 129, 192, 256):
        with pytest.raises(ValueError, match="head width"):
            flash_bwd_plan(dtype, dh)
    with pytest.raises(ValueError, match="head width 192"):
        flash_bwd_plan(dtype, 192, 128)                 # MLA's widths
    with pytest.raises(ValueError, match="dv == dh"):
        flash_bwd_plan(dtype, 64, 32)
    with pytest.raises(ValueError, match="dv == dh"):
        flash_bwd_plan(dtype, 128, 64)


# ------------------------------------------------------------- emulation
def _terms(x: torch.Tensor, n) -> list:
    """x (f32) as n bf16 terms, each held exactly in f64; ``None``: x
    itself, unsplit, in f64."""
    if n is None:
        return [x.double()]
    out, r = [], x.float()
    for _ in range(n):
        t = r.to(torch.bfloat16).float()
        out.append(t.double())
        r = r - t
    return out


def _product(eq: str, a: list, b: list) -> torch.Tensor:
    """The sum over term pairs (i, j), i + j <= 2, of einsum(eq, a_i,
    b_j): exact products summed in f64, rounded once to f32."""
    acc = None
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            if i + j <= 2:
                p = torch.einsum(eq, x, y)
                acc = p if acc is None else acc + p
    return acc.float()


def emulate_bwd(q, k, v, out, lse, do, *, causal, scale, terms_in,
                terms_p=P_TERMS):
    """The kernel's arithmetic in plain torch: q, k, v and dO split into
    ``terms_in`` bf16 terms, P and dS into ``terms_p``, every sum rounded
    to f32 where the kernel holds it in f32; with ``terms_in=None`` the
    same f32 arithmetic with nothing split (each product of f32 operands
    exact, rounded once).  Returns (dq, dk, dv) in f32, unrounded to the
    inputs' dtype."""
    if terms_in is None:
        terms_p = None
    B, S, H, dh = q.shape
    T, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    qt = _terms(q.float().reshape(B, S, Hk, G, dh), terms_in)
    dot = _terms(do.float().reshape(B, S, Hk, G, dh), terms_in)
    kt, vt = _terms(k.float(), terms_in), _terms(v.float(), terms_in)
    delta = (do.float() * out.float()).sum(-1).reshape(B, S, Hk, G).permute(0, 2, 3, 1)[..., None]
    lse = lse.reshape(B, Hk, G, S)[..., None]               # (B,Hk,G,S,1)
    s = _product("bskgd,btkd->bkgst", qt, kt)
    p = torch.exp(s * scale - lse)
    if causal:
        keep = torch.arange(S)[:, None] >= torch.arange(T)[None, :]
        p = torch.where(keep, p, 0.0)
    dp = _product("bskgd,btkd->bkgst", dot, vt)
    ds = p * (dp - delta)
    pt, dst = _terms(p, terms_p), _terms(ds, terms_p)
    dv = _product("bkgst,bskgd->btkd", pt, dot)
    dk = _product("bkgst,bskgd->btkd", dst, qt) * scale
    dq = _product("bkgst,btkd->bskgd", dst, kt) * scale
    return dq.reshape(B, S, H, dh), dk, dv


def _rel(got: torch.Tensor, want) -> float:
    w = torch.as_tensor(np.array(jnp.asarray(want, jnp.float32))
                        if not isinstance(want, torch.Tensor) else want)
    g, w = got.double(), w.double()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def _case(dtype, S, H, Hk, dh, causal, seed):
    """Inputs from a seed rounded to ``dtype``, the reference's forward
    residuals (out in ``dtype``, lse f32) and its ``_flash_bwd`` on them,
    run on the values in f32 (its arithmetic; on bf16 inputs the f32
    gradients before its final cast to bf16); the residuals as torch
    tensors of ``dtype`` (lse f32)."""
    rng = np.random.default_rng(seed)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    q, k, v, do = (jnp.asarray(rng.standard_normal(sh).astype(np.float32),
                               jdt)
                   for sh in ((1, S, H, dh), (1, S, Hk, dh), (1, S, Hk, dh),
                              (1, S, H, dh)))
    scale = 1 / math.sqrt(dh)
    out, lse = RL._attention_fwd_scan(q, k, v, causal, 0, 128, scale)
    f32 = [x.astype(jnp.float32) for x in (q, k, v, out, lse, do)]
    want = RL._flash_bwd(causal, 0, 128, scale, tuple(f32[:5]), f32[5])

    def tt(x, x32):
        return torch.tensor(np.asarray(x32)).to(
            dtype if x.dtype == jdt else torch.float32)
    return [tt(x, y) for x, y in zip((q, k, v, out, lse, do), f32)], \
        want, scale


CASES = [(256, 4, 4), (512, 4, 2)]
CASE_IDS = ["S256-G1", "S512-G2"]


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("S,H,Hk", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_emulated_kernel_matches_reference_bwd(dtype, causal, S, H, Hk, dh):
    """The planner's terms for q, k, v and dO, three for P and dS: the
    f32 gradients within the smoke's f32 limit of the reference's
    ``_flash_bwd`` (on bf16 inputs, before either side rounds them to
    bf16), and, rounded to the inputs' dtype, within that dtype's limit
    of the same arithmetic on unsplit operands rounded alike: the terms
    lose nothing a rounding to bf16 shows.  (Two f32 evaluations in other
    orders, e.g. the plain torch backward and the reference's, differ by
    up to 1e-4 after the rounding at these sizes: a few flipped roundings
    of large elements dominate the relative L2.)"""
    (q, k, v, out, lse, do), want, scale = _case(dtype, S, H, Hk, dh,
                                                 causal, seed=S + H + Hk)
    plan = flash_bwd_plan(dtype, dh)
    got = emulate_bwd(q, k, v, out, lse, do, causal=causal, scale=scale,
                      terms_in=plan.terms)
    unsplit = emulate_bwd(q, k, v, out, lse, do, causal=causal, scale=scale,
                        terms_in=None)
    for name, g, w, e, x in zip(("dq", "dk", "dv"), got, want, unsplit,
                                (q, k, v)):
        assert g.dtype == torch.float32 and g.shape == x.shape, name
        assert _rel(g, w) <= BWD_RTOL[torch.float32], (name, _rel(g, w))
        r = _rel(g.to(dtype), e.to(dtype))
        assert r <= BWD_RTOL[dtype], (name, r)


def test_one_term_of_p_fails_the_bf16_limit():
    """P and dS rounded to bf16 once (SDPA's bf16 backward) miss the bf16
    limit by far, against the unsplit arithmetic and the reference: the
    kernel's three terms are what meet it."""
    (q, k, v, out, lse, do), want, scale = _case(torch.bfloat16, 512, 4, 2,
                                                 64, True, seed=518)
    got = emulate_bwd(q, k, v, out, lse, do, causal=True, scale=scale,
                      terms_in=1, terms_p=1)
    unsplit = emulate_bwd(q, k, v, out, lse, do, causal=True, scale=scale,
                        terms_in=None)
    bf = torch.bfloat16
    assert max(_rel(g.to(bf), e.to(bf)) for g, e in zip(got, unsplit)) > \
        10 * BWD_RTOL[bf]
    assert max(_rel(g, w) for g, w in zip(got, want)) > 10 * BWD_RTOL[bf]
