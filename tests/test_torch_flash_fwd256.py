"""The bf16 flash forward's launch schedules and, on the CPU, its (256,
256) instance's arithmetic against the reference's Pallas kernel.

``flash_schedule`` states each instance's launch on
``csrc/flash_attn_fwd_wgmma.cu`` (threads, keys a KV tile, stages,
dynamic shared memory; the kernel's ``Schedule`` computes the same, and
``tests/test_torch_cuda.py`` holds the two together on the card).  The
(256, 256) instance runs its two consumer warpgroups alone (256 threads,
so a thread may hold 255 registers) on 80-key tiles in a ring of two
stages; the others keep a producer warpgroup.

``emulate_wide`` repeats the (256, 256) instance's arithmetic in torch:
bf16 inputs; blocks of 128 query rows, each taking the KV tiles of 80
keys up to its last row's diagonal; each tile's scores in f32 (bf16
products, exact in f32, summed in f32), scaled by scale * log2(e), masked
(-1e30 above the diagonal, -inf past T), the running max and sum in f32,
the weights exp2(x - m) summed in f32 and rounded to bf16 for the P V
product, the output rescaled a tile, then divided by max(l, 1e-30) and
rounded to bf16.  It is held against the JAX package's
``flash_attention_fwd`` run in interpret mode on the same bf16 values,
within the smoke's bf16 limits (``chip_smoke.check_attn``): 5e-2 an
element and each (b, s, h) row's L2 error within 2^-6 of its norm (the
reference keeps P in f32; P rounded to bf16 moves a row by at most 2^-8
of its weight).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import flash_attention as j_flash
from repro_torch.kernels.flash_attn import (flash_plan, flash_schedule)
from repro_torch.kernels.flash_attn.ops import SMEM_CAP

ELEM_TOL = 5e-2                 # chip_smoke.FLASH_TOL[torch.bfloat16]
ROW_RTOL = 2.0 ** -6            # chip_smoke.FLASH_ROW_RTOL
BQ = 128                        # query rows a block
BARRIERS = 17 * 8               # the kernel's static mbarriers
LOG2E = 1.4426950408889634


# ------------------------------------------------------------- schedules
@pytest.mark.parametrize("instance,want", [
    ((64, 64), (384, 128, 4, 148_480)),
    ((128, 128), (384, 96, 4, 230_400)),
    ((192, 128), (384, 96, 2, 173_056)),
    ((256, 256), (256, 80, 2, 230_400)),
], ids=str)
def test_flash_schedule(instance, want):
    """Each instance's launch: the three with v at most 128 wide as before
    (a producer warpgroup, 96- or 128-key tiles, as many stages as fit);
    (256, 256) on 256 threads and 80-key tiles, two stages."""
    sch = flash_schedule(instance)
    assert tuple(sch) == want
    kdh, kdv = instance
    assert sch.smem == (BQ * kdh + sch.stages * sch.kv_tile
                        * (kdh + kdv)) * 2 + 1024
    assert sch.stages >= 2 and sch.smem + BARRIERS <= SMEM_CAP
    assert sch.kv_tile % 16 == 0          # P V's k16 steps


def test_wide_schedule_is_consumers_alone():
    """(256, 256): two warpgroups and no producer, so ptxas may give a
    thread 255 registers (O is 128 floats a thread; S 40, P 20 at 80
    keys), and the q tile and two stages of K and V fit 232,448 bytes."""
    sch = flash_schedule((256, 256))
    assert sch.threads == 256 and 65_536 // sch.threads >= 255
    assert 256 // 2 + sch.kv_tile // 2 + sch.kv_tile // 4 <= 255
    assert sch.smem <= 232_448 == SMEM_CAP
    assert all(flash_schedule(i).threads == 384 for i in
               ((64, 64), (128, 128), (192, 128)))


def test_flash_schedule_rejects_other_widths():
    for inst in ((96, 96), (256, 128), (192, 192), (32, 32)):
        with pytest.raises(ValueError, match="no instance"):
            flash_schedule(inst)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_every_plan_has_a_schedule(dtype):
    """Every width flash_plan takes lands on an instance with a schedule;
    q/k above 192 or v above 128 on the 256-thread one.  f32 q/k up to 32
    wide land on the f32 kernel's narrow (32, 32) instance instead, which
    the bf16 kernel has not (its launch is the f32 kernel's own)."""
    for dh in range(1, 257):
        for dv in {dh, max(1, dh // 2), min(dh, 128)}:
            inst = flash_plan(dtype, dh, dv).instance
            dp, dvp = flash_plan(dtype, dh, dv).widths
            if dtype == torch.float32 and dp <= 32:
                assert inst == (32, 32), (dh, dv)
                continue
            wide = flash_schedule(inst).threads == 256
            assert wide == (dp > 192 or dvp > 128), (dh, dv)


# ------------------------------------------------------------- emulation
def emulate_wide(q, k, v, *, causal, scale=None, kv_tile=None):
    """The (256, 256) instance's arithmetic (module docstring) on q (B, S,
    H, dh), k (B, T, Hk, dh), v (B, T, Hk, dv) bf16 -> (B, S, H, dv)
    bf16.  ``kv_tile`` defaults to the schedule's."""
    kv_tile = kv_tile or flash_schedule((256, 256)).kv_tile
    b, s, h, dh = q.shape
    t, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    g = h // hk
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    scale_log2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    qf = q.float().transpose(1, 2)                           # (B, H, S, dh)
    kf = k.float().repeat_interleave(g, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(g, dim=2).transpose(1, 2)
    out = torch.empty(b, h, s, dv)
    n_kv_all = -(-t // kv_tile)
    for q0 in range(0, s, BQ):
        rows = torch.arange(q0, min(q0 + BQ, s))
        n_kv = (min(n_kv_all, int(rows[-1]) // kv_tile + 1) if causal
                else n_kv_all)
        qb = qf[:, :, rows]
        m = torch.full((b, h, len(rows)), -1e30)
        l = torch.zeros(b, h, len(rows))
        acc = torch.zeros(b, h, len(rows), dv)
        for j in range(n_kv):
            keys = torch.arange(j * kv_tile, min((j + 1) * kv_tile, t))
            x = (qb @ kf[:, :, keys].transpose(-1, -2)) * scale_log2
            if causal:
                x = x.masked_fill(keys[None, :] > rows[:, None], -1e30)
            m_new = torch.maximum(m, x.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + p.bfloat16().float() @ vf[:, :,
                                                                    keys]
            m = m_new
        out[:, :, rows] = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).bfloat16()


def _check(got, want):
    g, w = got.float(), torch.as_tensor(want, dtype=torch.float32)
    assert float((g - w).abs().max()) <= ELEM_TOL
    row = (g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
    assert float(row.max()) <= ROW_RTOL, float(row.max())


# (S, T, block_q, block_k of the reference's grid): S and T off the
# 128-row blocks and the 80-key tiles, S != T both ways, T below one tile
SHAPES = [(200, 200, 40, 40), (280, 200, 40, 40), (200, 280, 40, 40),
          (24, 56, 8, 8)]


@pytest.mark.parametrize("dh", [256, 200])
@pytest.mark.parametrize("S,T,bq,bk", SHAPES,
                         ids=[f"S{s}-T{t}" for s, t, _, _ in SHAPES])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_emulated_wide_instance_matches_reference(causal, S, T, bq, bk, dh):
    """The emulation on bf16 inputs (H 4, Hk 2: G = 2) against the JAX
    package's Pallas kernel in interpret mode on the same values."""
    rng = np.random.default_rng(S + 3 * T + dh + causal)
    q, k, v = (rng.standard_normal(sh).astype(np.float32) for sh in
               ((1, S, 4, dh), (1, T, 2, dh), (1, T, 2, dh)))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(j_flash(jq, jk, jv, causal=causal, block_q=bq,
                              block_k=bk, use_kernel=True), np.float32)
    tq, tk, tv = (torch.tensor(np.asarray(x.astype(jnp.float32))).bfloat16()
                  for x in (jq, jk, jv))
    got = emulate_wide(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == (1, S, 4, dh)
    _check(got, want)


def test_emulated_wide_instance_narrow_v_matches_plain():
    """v narrower than q and k (256 x 128, the ``[dv]`` key on this
    instance), which the reference's Pallas kernel does not take: the
    emulation against the port's plain version on the same bf16 values."""
    from repro_torch.kernels.flash_attn import flash_attn_ref
    rng = np.random.default_rng(7)
    q, k, v = (torch.tensor(rng.standard_normal(sh).astype(
        np.float32)).bfloat16() for sh in
        ((1, 200, 4, 256), (1, 280, 2, 256), (1, 280, 2, 128)))
    for causal in (True, False):
        _check(emulate_wide(q, k, v, causal=causal),
               flash_attn_ref(q, k, v, causal=causal))
