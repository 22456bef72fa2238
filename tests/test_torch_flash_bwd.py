"""The attention backward kernel's design on the CPU: its planner
(``flash_bwd_plan``: key, instance (kD, kDv), widths, term count; v
narrower than q and k on the ``[dv]`` keys, MLA's (192, 128) on its own
instance) and a plain-torch emulation of its arithmetic held against the
reference's ``_flash_bwd`` (``repro/models/layers.py``), also where v is
narrower than q and k.

The kernel (``csrc/flash_attn_bwd.cu``) runs every product on bf16
tensor cores: each f32 operand is split into bf16 terms, x = x0 + x1 +
x2 (x0 = bf16(x), x1 = bf16(x - x0), x2 = bf16(x - x0 - x1)), and a
product is summed over the term pairs (i, j) with i + j <= 2.  q, k, v and
dO take the planner's terms (one for bf16 inputs, which are exact in
bf16; three for f32); P and dS always three.  The emulation forms the
same products exactly (bf16 terms held in f64) and rounds each sum to f32
where the kernel's f32 accumulators hold it; at (192, 128) it forms P in
base 2, as that instance does.  Tolerances are the smoke's
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
from repro_torch.kernels.flash_attn import (BWD_BF16_DV_KEY, BWD_BF16_KEY,
                                            BWD_DV_KEY, BWD_KEY,
                                            BWD_NARROW_KEY, flash_bwd_plan,
                                            flash_bwd_schedule,
                                            flash_bwd_width)
from repro_torch.kernels.flash_attn.ops import SMEM_CAP

BWD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 6.7e-5}
P_TERMS = 3                     # terms of P and dS in the kernel


# (dh, dv): one width (dv None), and v narrower than q and k: the reduced
# DeepSeek config's MLA (48, 32) on the 64 instance, DeepSeek-V2's (192,
# 128), and (136, 96) padded within the (192, 128) instance; BERT4Rec's 32,
# 20 and (32, 16), on the narrow instance in f32 where T <= 256
WIDTHS = [(dh, None) for dh in (1, 6, 36, 64, 96, 100, 128)] + [
    (48, 32), (192, 128), (136, 96)] + [(32, None), (20, None), (32, 16)]


@pytest.mark.parametrize("dh,dv", WIDTHS,
                         ids=[str(dh) if dv is None else f"{dh}x{dv}"
                              for dh, dv in WIDTHS])
@pytest.mark.parametrize("dtype,key,terms", [
    (torch.float32, BWD_KEY, 3), (torch.bfloat16, BWD_BF16_KEY, 1),
    (torch.float16, BWD_KEY, 3), (torch.uint8, BWD_BF16_KEY, 1)])
def test_bwd_plan(dtype, key, terms, dh, dv):
    plan = flash_bwd_plan(dtype, dh, dv)
    w = -(-dh // 8) * 8                     # bf16 operands: 16-byte rows
    wv = w if dv is None else -(-dv // 8) * 8
    if dv is not None:                      # v narrower: the [dv] keys
        key = {BWD_KEY: BWD_DV_KEY, BWD_BF16_KEY: BWD_BF16_DV_KEY}[key]
    instance = (64, 64) if w <= 64 else (128, 128) if w <= 128 else (192,
                                                                     128)
    assert plan == (key, instance, (w, wv), terms)
    assert plan.widths == flash_bwd_width(dh, dv) and plan.widths[0] >= dh
    assert plan.widths[1] <= instance[1]
    if dv is None:
        assert flash_bwd_plan(dtype, dh, dh) == plan
    # with the keys counted: f32 at q/k <= 32 and T <= 256 takes the narrow
    # instance, whatever v's width; T = 257, bf16 and wider q/k keep theirs
    for t in (1, 200, 256, 257):
        narrow = terms == 3 and w <= 32 and t <= 256
        assert flash_bwd_plan(dtype, dh, dv, t) == (
            (BWD_NARROW_KEY, (32, 32), (w, wv), 3) if narrow else plan)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_plan_rejects_what_it_lacks(dtype):
    for dh in (0, 193, 256):
        with pytest.raises(ValueError, match=f"head width {dh}"):
            flash_bwd_plan(dtype, dh)
    with pytest.raises(ValueError, match="head width 256"):
        flash_bwd_plan(dtype, 256, 256)
    for dh, dv in ((192, 192), (129, 129), (192, 136)):   # both past 128
        with pytest.raises(ValueError, match=rf"\({dh}, {dv}\)"):
            flash_bwd_plan(dtype, dh, dv)
    for dh, dv in ((64, 96), (128, 192), (32, 48), (64, 0)):  # v past q
        with pytest.raises(ValueError, match=f"v width {dv}"):
            flash_bwd_plan(dtype, dh, dv)


# (instance, terms) -> the (dK/dV, dQ) launches: threads, rows a block,
# streamed rows, stages, dynamic shared memory.  (32, 32), f32 only: one
# kernel of four warpgroups, a (batch, KV head)'s 256 keys resident, 32
# query rows a stage, two stages (its launch in both places).  (64, 64) and
# (128, 128) as the one-warpgroup kernels have run them since their
# redesign; (192,
# 128) on two warpgroups, 64 streamed rows in bf16, 16 in f32 (its
# three-term residency leaves no room for two 32-row stages)
SCHEDULES = {
    ((32, 32), 3): ((512, 256, 32, 2, 206336), (512, 256, 32, 2, 206336)),
    ((64, 64), 3): ((128, 64, 32, 4, 148480), (128, 64, 32, 4, 148480)),
    ((64, 64), 1): ((128, 64, 32, 4, 50176), (128, 64, 32, 2, 33792)),
    ((128, 128), 3): ((128, 64, 32, 2, 197632), (128, 64, 32, 2, 197632)),
    ((128, 128), 1): ((128, 64, 32, 4, 99328), (128, 64, 32, 2, 66560)),
    ((192, 128), 3): ((256, 64, 16, 3, 220160), (256, 64, 16, 3, 220160)),
    ((192, 128), 1): ((256, 64, 64, 4, 222208), (256, 64, 64, 4, 222208)),
}


@pytest.mark.parametrize("instance,terms", list(SCHEDULES),
                         ids=[f"{a}x{b}-t{t}" for (a, b), t in SCHEDULES])
def test_bwd_schedule(instance, terms):
    """Each kernel's shared memory, with 2 KB for its static barriers,
    is within ``SMEM_CAP``, and its ring holds two stages or more; the
    launches are the ones stated (the kernel's ``Schedule`` reports the
    same, ``test_torch_cuda.py``)."""
    sch = flash_bwd_schedule(instance, terms)
    assert tuple(tuple(k) for k in sch) == SCHEDULES[instance, terms]
    kd, kdv = instance
    for k in sch:
        assert k.smem + 2048 <= SMEM_CAP and k.stages >= 2
        assert k.smem >= terms * (kd + kdv) * 2 * (k.rows + k.stages
                                                   * k.streamed)
    if kd > 128:                # two warpgroups: 64 rows each, two stages
        assert sch.dkdv.threads == 256 and sch.dkdv.streamed <= 64
    if kd == 32:                # one kernel: four warpgroups of 64 keys
        assert sch.dkdv == sch.dq and sch.dkdv.threads == 4 * 128
        assert sch.dkdv.rows == 4 * 64


def test_bwd_schedule_rejects_what_it_lacks():
    for inst in ((96, 96), (192, 192), (256, 256)):
        with pytest.raises(ValueError, match="no backward instance"):
            flash_bwd_schedule(inst, 3)
    with pytest.raises(ValueError, match="2 terms"):
        flash_bwd_schedule((64, 64), 2)
    with pytest.raises(ValueError, match="three terms"):
        flash_bwd_schedule((32, 32), 1)      # bf16 keeps (64, 64)


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


def _narrow_grads(pt, dst, qt, kt, dot, S, T, G, scale):
    """dV, dK and dQ in the narrow instance's order of sums: dV and dK per
    stage of 32 query rows of one query head (heads outer), each stage's
    product rounded to f32 and added to the running f32 sum; dQ per step of
    16 keys, rounded to f32, the steps of each warpgroup's 64 keys added in
    order, then the four warpgroups' partials in order."""
    def rows(ts, g, s0):            # (B, Hk, G, S, T): a stage's queries
        return [x[:, :, g, s0:s0 + 32] for x in ts]

    def qrows(ts, g, s0):           # (B, S, Hk, G, d): the same
        return [x[:, s0:s0 + 32, :, g] for x in ts]
    dv = dk = 0
    for g in range(G):
        for s0 in range(0, S, 32):
            dv = dv + _product("bkst,bskd->btkd", rows(pt, g, s0),
                               qrows(dot, g, s0))
            dk = dk + _product("bkst,bskd->btkd", rows(dst, g, s0),
                               qrows(qt, g, s0))
    dq = 0
    for w0 in range(0, T, 64):
        part = 0
        for k0 in range(w0, min(w0 + 64, T), 16):
            part = part + _product("bkgst,btkd->bskgd",
                                   [x[..., k0:k0 + 16] for x in dst],
                                   [x[:, k0:k0 + 16] for x in kt])
        dq = dq + part
    return dq * scale, dk * scale, dv


def emulate_bwd(q, k, v, out, lse, do, *, causal, scale, terms_in,
                terms_p=P_TERMS, base2=False, narrow=False):
    """The kernel's arithmetic in plain torch: q, k, v and dO split into
    ``terms_in`` bf16 terms, P and dS into ``terms_p``, every sum rounded
    to f32 where the kernel holds it in f32; with ``terms_in=None`` the
    same f32 arithmetic with nothing split (each product of f32 operands
    exact, rounded once).  ``base2``: P as the (192, 128) and the narrow
    instances form it, 2^(S scale2 - lse2) with scale2 = scale log2(e) and
    lse2 = lse log2(e) each rounded to f32 (else exp(S scale - lse)).
    ``narrow``: the narrow instance's order of sums (S and dP in one
    chain each, as here; dV, dK and dQ as ``_narrow_grads``).  Returns
    (dq, dk, dv) in f32, unrounded to the inputs' dtype."""
    if terms_in is None:
        terms_p = None
    B, S, H, dh = q.shape
    T, Hk, dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // Hk
    qt = _terms(q.float().reshape(B, S, Hk, G, dh), terms_in)
    dot = _terms(do.float().reshape(B, S, Hk, G, dv), terms_in)
    kt, vt = _terms(k.float(), terms_in), _terms(v.float(), terms_in)
    delta = (do.float() * out.float()).sum(-1).reshape(B, S, Hk, G).permute(0, 2, 3, 1)[..., None]
    lse = lse.reshape(B, Hk, G, S)[..., None]               # (B,Hk,G,S,1)
    s = _product("bskgd,btkd->bkgst", qt, kt)
    if base2:
        log2e = torch.tensor(math.log2(math.e), dtype=torch.float32)
        scale2 = torch.tensor(scale, dtype=torch.float32) * log2e
        p = torch.exp2(s * scale2 - lse.float() * log2e)
    else:
        p = torch.exp(s * scale - lse)
    if causal:
        keep = torch.arange(S)[:, None] >= torch.arange(T)[None, :]
        p = torch.where(keep, p, 0.0)
    dp = _product("bskgd,btkd->bkgst", dot, vt)
    ds = p * (dp - delta)
    pt, dst = _terms(p, terms_p), _terms(ds, terms_p)
    if narrow:
        dq, dk, dv = _narrow_grads(pt, dst, qt, kt, dot, S, T, G, scale)
        return dq.reshape(B, S, H, dh), dk, dv
    dv = _product("bkgst,bskgd->btkd", pt, dot)
    dk = _product("bkgst,bskgd->btkd", dst, qt) * scale
    dq = _product("bkgst,btkd->bskgd", dst, kt) * scale
    return dq.reshape(B, S, H, dh), dk, dv


def _rel(got: torch.Tensor, want) -> float:
    w = torch.as_tensor(np.array(jnp.asarray(want, jnp.float32))
                        if not isinstance(want, torch.Tensor) else want)
    g, w = got.double(), w.double()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def _case(dtype, S, H, Hk, dh, causal, seed, dv=None):
    """Inputs from a seed rounded to ``dtype`` (v and dO ``dv`` wide, dh
    when None), the reference's forward
    residuals (out in ``dtype``, lse f32) and its ``_flash_bwd`` on them,
    run on the values in f32 (its arithmetic; on bf16 inputs the f32
    gradients before its final cast to bf16); the residuals as torch
    tensors of ``dtype`` (lse f32)."""
    rng = np.random.default_rng(seed)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    dv = dh if dv is None else dv
    q, k, v, do = (jnp.asarray(rng.standard_normal(sh).astype(np.float32),
                               jdt)
                   for sh in ((1, S, H, dh), (1, S, Hk, dh), (1, S, Hk, dv),
                              (1, S, H, dv)))
    scale = 1 / math.sqrt(dh)
    blk = 128 if S % 128 == 0 else S        # the reference's KV blocks
    out, lse = RL._attention_fwd_scan(q, k, v, causal, 0, blk, scale)
    f32 = [x.astype(jnp.float32) for x in (q, k, v, out, lse, do)]
    want = RL._flash_bwd(causal, 0, blk, scale, tuple(f32[:5]), f32[5])

    def tt(x, x32):
        return torch.tensor(np.asarray(x32)).to(
            dtype if x.dtype == jdt else torch.float32)
    return [tt(x, y) for x, y in zip((q, k, v, out, lse, do), f32)], \
        want, scale


CASES = [(256, 4, 4), (512, 4, 2)]
CASE_IDS = ["S256-G1", "S512-G2"]


# q/k and v widths: one width on each instance up to 128; v narrower on
# the 64 instance (the reduced DeepSeek config) and on the (192, 128);
# BERT4Rec's 32, run at its S = T = 200 (the case's G): in f32 the narrow
# instance, in bf16 the (64, 64) one
WIDTHS_EMU = [(64, None), (128, None), (48, 32), (192, 128), (32, None)]
NARROW_S = 200


@pytest.mark.parametrize("dh,dv", WIDTHS_EMU,
                         ids=[str(dh) if dv is None else f"{dh}x{dv}"
                              for dh, dv in WIDTHS_EMU])
@pytest.mark.parametrize("S,H,Hk", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_emulated_kernel_matches_reference_bwd(dtype, causal, S, H, Hk, dh,
                                               dv):
    """The planner's terms for q, k, v and dO, three for P and dS (with
    the narrow instance's order of sums at dh 32 in f32, S = T = 200): the
    f32 gradients within the smoke's f32 limit of the reference's
    ``_flash_bwd`` (on bf16 inputs, before either side rounds them to
    bf16), and, rounded to the inputs' dtype, within that dtype's limit
    of the same arithmetic on unsplit operands rounded alike: the terms
    lose nothing a rounding to bf16 shows.  (Two f32 evaluations in other
    orders, e.g. the plain torch backward and the reference's, differ by
    up to 1e-4 after the rounding at these sizes: a few flipped roundings
    of large elements dominate the relative L2.)"""
    if dh <= 32:
        S = NARROW_S
    (q, k, v, out, lse, do), want, scale = _case(dtype, S, H, Hk, dh,
                                                 causal, seed=S + H + Hk,
                                                 dv=dv)
    plan = flash_bwd_plan(dtype, dh, dv, S)
    narrow = plan.instance == (32, 32)
    assert narrow == (dtype == torch.float32 and dh <= 32)
    base2 = plan.instance in ((192, 128), (32, 32))
    got = emulate_bwd(q, k, v, out, lse, do, causal=causal, scale=scale,
                      terms_in=plan.terms, base2=base2, narrow=narrow)
    unsplit = emulate_bwd(q, k, v, out, lse, do, causal=causal, scale=scale,
                          terms_in=None, base2=base2, narrow=narrow)
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
