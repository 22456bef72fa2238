"""The port's single-query ADC, exact-L2 and flash-attention ops
(``repro_torch.kernels``) against the JAX package's, on the CPU.

The port's wrappers run their plain versions for CPU tensors; the JAX ops
run both as the Pallas kernel in interpret mode and on their jnp path.
Inputs come from numpy seeds; bf16 inputs are rounded once in numpy's
hands and handed to both packages as the same values.  The case sets are
those of ``tests/test_kernels.py``.  Tolerances:

* ADC distances rtol 1e-5 (M f32 terms summed in another order), ids
  exactly;
* L2 rtol = atol = 1e-4 in f32 (D products summed in another order) and
  5e-2 in bf16 (as the JAX package's own test);
* flash attention 2e-5 in f32 (an online softmax against a plain one)
  and 5e-2 in bf16 (one rounding of the output to bf16 on each side).

The launch planners that size the CUDA kernels (which flash kernel a
dtype and head width go to, which L2 kernel a dtype and width go to; the
dense scan's one-wave grid; the fused scan's clusters, key buffers and
code-load widths, and its merge in the launch, replayed in torch) and
``build.py``'s library names are pure Python and are held here too.  The CUDA kernels against their plain
versions are in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.engine import ground_truth as j_ground_truth
from repro.kernels.flash_attn import flash_attention as j_flash
from repro.kernels.l2dist import l2_distances as j_l2
from repro.kernels.pq_adc import pq_adc as j_pq_adc
from repro.kernels.pq_adc import pq_adc_topk as j_pq_adc_topk
from repro_torch.core.engine import ground_truth
from repro_torch.kernels import build, launch
from repro_torch.kernels.flash_attn import (flash_attention, flash_attn_ref,
                                            flash_instance, flash_kernel)
from repro_torch.kernels.l2dist import (l2_distances, l2_instance,
                                        l2_kernel, l2_plan, l2dist_ref)
from repro_torch.kernels.pq_adc import ops, ref

ADC_RTOL = 1e-5
MODES = pytest.mark.parametrize("use_kernel", [True, False],
                                ids=["pallas_interpret", "jnp"])


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _adc_case(seed, n, m, k=256, offset=0.0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, k, (n, m)).astype(np.uint8)
    lut = (rng.random((m, k)) + offset).astype(np.float32)
    return codes, lut


# ------------------------------------------------------------ single-query
@pytest.mark.parametrize("n,m,block", [
    (64, 8, 64), (256, 16, 64), (1000, 32, 128), (4096, 25, 1024),
    (100, 8, 1024),   # n < block
])
@MODES
def test_pq_adc_matches_jax(n, m, block, use_kernel):
    codes, lut = _adc_case(n + m, n, m)
    want = np.asarray(j_pq_adc(jnp.asarray(codes), jnp.asarray(lut),
                               block_n=block, use_kernel=use_kernel))
    got = ops.pq_adc(_t(codes), _t(lut))
    assert got.dtype == torch.float32 and tuple(got.shape) == (n,)
    np.testing.assert_allclose(got.numpy(), want, rtol=ADC_RTOL)


@pytest.mark.parametrize("k_entries", [16, 64, 256])
@MODES
def test_pq_adc_lut_widths_match_jax(k_entries, use_kernel):
    codes, lut = _adc_case(k_entries, 128, 8, k=k_entries)
    want = np.asarray(j_pq_adc(jnp.asarray(codes), jnp.asarray(lut),
                               block_n=64, use_kernel=use_kernel))
    np.testing.assert_allclose(ops.pq_adc(_t(codes), _t(lut)).numpy(), want,
                               rtol=ADC_RTOL)
    v, i = ops.pq_adc_topk(_t(codes), _t(lut), 10)
    jv, ji = j_pq_adc_topk(jnp.asarray(codes), jnp.asarray(lut), 10,
                           block_n=64, use_kernel=use_kernel)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=ADC_RTOL)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


@pytest.mark.parametrize("n,m,topk,block", [
    (256, 8, 10, 64), (1024, 16, 50, 256), (555, 8, 10, 128),
    (2048 + 7, 8, 32, 2048),   # last block: 2041 pads, LUT >= 1
    (5, 8, 16, 1024), (1, 8, 8, 1024), (100, 8, 256, 1024),   # n < topk
])
@MODES
def test_pq_adc_topk_matches_jax(n, m, topk, block, use_kernel):
    codes, lut = _adc_case(7 * n + topk, n, m, offset=1.0)
    jv, ji = j_pq_adc_topk(jnp.asarray(codes), jnp.asarray(lut), topk,
                           block_n=block, use_kernel=use_kernel)
    v, i = ops.pq_adc_topk(_t(codes), _t(lut), topk)
    assert tuple(v.shape) == tuple(i.shape) == (min(topk, n),)
    assert i.dtype == torch.int32
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=ADC_RTOL)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert np.all(np.isfinite(v.numpy()))
    assert np.all((i.numpy() >= 0) & (i.numpy() < n))


@pytest.mark.parametrize("topk", [1, 7, 60, 500])
def test_pq_adc_topk_ties_go_to_the_lowest_row(topk):
    """Every code row appears three times in a row: equal distances must
    come out in ascending row order, and the result must be the first
    ``topk`` of a stable sort of ``pq_adc``."""
    rng = np.random.default_rng(5)
    codes = np.repeat(rng.integers(0, 256, (100, 8)).astype(np.uint8), 3, 0)
    lut = _t(rng.random((8, 256)).astype(np.float32))
    v, i = ops.pq_adc_topk(_t(codes), lut, topk)
    d = ops.pq_adc(_t(codes), lut)
    sv, si = torch.sort(d, stable=True)
    assert torch.equal(v, sv[:topk]) and torch.equal(i.long(), si[:topk])
    tie = v[1:] == v[:-1]
    assert torch.all(i[1:][tie] > i[:-1][tie])


# ------------------------------------------------------------------- l2
def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 values, held as f32."""
    return x.astype(jnp.bfloat16).astype(np.float32)


@pytest.mark.parametrize("b,n,d,bf16", [
    (1, 64, 32, False), (8, 256, 96, False), (16, 100, 128, True),
    (128, 1000, 100, False),
    # above the resident query tile (d > 128), the streamed widths of the
    # tensor-core kernel: Text2Image-1B's 200, 384, GIST1M's 960; bf16 at
    # an even width off 16 bytes; f32 at a width off 16 bytes (4-byte
    # copies on the card)
    (3, 200, 200, False), (5, 130, 384, False), (2, 128, 960, False),
    (8, 100, 130, True), (7, 90, 102, False),
])
@MODES
def test_l2_distances_match_jax(b, n, d, bf16, use_kernel):
    rng = np.random.default_rng(b * 1000 + n + d)
    q = rng.standard_normal((b, d)).astype(np.float32)
    v = rng.standard_normal((n, d)).astype(np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    if bf16:
        q, v = _bf16(q), _bf16(v)
    want = np.asarray(j_l2(jnp.asarray(q, jdt), jnp.asarray(v, jdt),
                           block_q=32, block_n=128, use_kernel=use_kernel))
    got = l2_distances(_t(q).to(tdt), _t(v).to(tdt))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, n)
    tol = 5e-2 if bf16 else 1e-4
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_l2_self_distance_zero():
    v = _t(np.random.default_rng(0).standard_normal((32, 64)).astype(
        np.float32))
    np.testing.assert_allclose(np.diag(l2_distances(v, v).numpy()), 0.0,
                               atol=1e-3)


def test_ground_truth_matches_jax():
    """Port ground truth (through ``l2_distances``) == the JAX package's
    numpy ground truth, ids exactly, on tie-free float data; chunks and
    the running top-k cross several chunk boundaries."""
    rng = np.random.default_rng(9)
    data = rng.standard_normal((3000, 24)).astype(np.float32)
    queries = rng.standard_normal((37, 24)).astype(np.float32)
    want = j_ground_truth(data, queries, 10)
    for chunk in (1 << 20, 700):
        got = ground_truth(data, queries, 10, device="cpu", chunk=chunk)
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- flash
@pytest.mark.parametrize("B,S,H,Hk,dh,causal,bq,bk", [
    (2, 16, 4, 2, 8, True, 8, 8),
    (1, 32, 2, 2, 16, False, 16, 8),
    (2, 64, 6, 3, 8, True, 16, 16),
    (1, 24, 4, 1, 8, True, 8, 8),       # MQA
    (1, 16, 2, 2, 8, True, 16, 16),     # single block
    # head widths the card takes on padded tensor-core instances (96, 80)
    # and on the CUDA cores (6, DeepSeek-V2's qk width 192, 256)
    (1, 16, 2, 1, 96, True, 8, 8),
    (1, 32, 4, 2, 80, False, 16, 16),
    (2, 16, 2, 2, 6, True, 8, 8),
    (1, 16, 2, 1, 192, True, 16, 8),
    (1, 16, 2, 2, 256, False, 8, 16),
])
@MODES
def test_flash_attention_matches_jax(B, S, H, Hk, dh, causal, bq, bk,
                                     use_kernel):
    rng = np.random.default_rng(B * 100 + S + H + dh)
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hk, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hk, dh)).astype(np.float32)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, block_q=bq, block_k=bk,
                              use_kernel=use_kernel))
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, S, H, dh)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@MODES
def test_flash_attention_bf16_matches_jax(use_kernel):
    rng = np.random.default_rng(1)
    q, k, v = (_bf16(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 32, 4, 8), (1, 32, 2, 8), (1, 32, 2, 8)))
    want = np.asarray(j_flash(*(jnp.asarray(x, jnp.bfloat16)
                                for x in (q, k, v)),
                              block_q=16, block_k=16, use_kernel=use_kernel),
                      np.float32)
    got = flash_attention(*(_t(x).to(torch.bfloat16) for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2,
                               atol=5e-2)


def test_flash_attention_scale_and_ragged_kv():
    """An explicit scale and S != T: the plain version equals a direct
    softmax over the top-left-aligned causal mask."""
    rng = np.random.default_rng(2)
    q = _t(rng.standard_normal((1, 5, 4, 8)).astype(np.float32))
    k = _t(rng.standard_normal((1, 9, 2, 8)).astype(np.float32))
    v = _t(rng.standard_normal((1, 9, 2, 8)).astype(np.float32))
    got = flash_attention(q, k, v, causal=True, scale=0.3)
    for s in range(5):
        for h in range(4):
            sc = 0.3 * (k[0, :s + 1, h // 2] @ q[0, s, h])
            want = torch.softmax(sc, 0) @ v[0, :s + 1, h // 2]
            torch.testing.assert_close(got[0, s, h], want, rtol=2e-5,
                                       atol=2e-5)


# ------------------------------------------------------- CPU dispatching
def test_new_wrappers_run_plain_versions_on_cpu_tensors():
    rng = np.random.default_rng(3)
    codes = _t(rng.integers(0, 256, (50, 8)).astype(np.uint8))
    lut = _t(rng.random((8, 256)).astype(np.float32))
    q = _t(rng.standard_normal((3, 16)).astype(np.float32))
    x = _t(rng.standard_normal((1, 8, 2, 8)).astype(np.float32))
    before = dict(launch.LAUNCHES)
    assert torch.equal(ops.pq_adc(codes, lut), ref.pq_adc_ref(codes, lut))
    assert all(torch.equal(a, b) for a, b in zip(
        ops.pq_adc_topk(codes, lut, 5), ops.pq_adc_topk_plain(codes, lut, 5)))
    assert torch.equal(l2_distances(q, q), l2dist_ref(q, q))
    assert torch.equal(flash_attention(x, x[:, :, :1], x[:, :, :1]),
                       flash_attn_ref(x, x[:, :, :1], x[:, :, :1]))
    assert launch.LAUNCHES == before


# ------------------------------------------------------- launch planners
@pytest.mark.parametrize("dtype,dh,kernel", [
    (torch.bfloat16, 128, "flash_attn_fwd_wgmma"),
    (torch.bfloat16, 64, "flash_attn_fwd_wgmma"),
    (torch.bfloat16, 96, "flash_attn_fwd_wgmma"),   # padded to 128
    (torch.bfloat16, 32, "flash_attn_fwd_wgmma"),   # padded to 64
    (torch.bfloat16, 8, "flash_attn_fwd_wgmma"),
    (torch.bfloat16, 36, "flash_attn_fwd"),         # rows off 16 bytes
    (torch.bfloat16, 6, "flash_attn_fwd"),
    (torch.bfloat16, 136, "flash_attn_fwd"),        # wider than 128
    (torch.bfloat16, 192, "flash_attn_fwd"),
    (torch.bfloat16, 256, "flash_attn_fwd"),
    (torch.float32, 128, "flash_attn_fwd_tf32"),
    (torch.float32, 64, "flash_attn_fwd_tf32"),
    (torch.float32, 96, "flash_attn_fwd_tf32"),     # padded to 128
    (torch.float32, 32, "flash_attn_fwd_tf32"),     # padded to 64
    (torch.float32, 36, "flash_attn_fwd_tf32"),
    (torch.float32, 8, "flash_attn_fwd_tf32"),
    (torch.float32, 6, "flash_attn_fwd"),           # rows off 16 bytes
    (torch.float32, 1, "flash_attn_fwd"),
    (torch.float32, 132, "flash_attn_fwd"),         # wider than 128
    (torch.float32, 192, "flash_attn_fwd"),
    (torch.float32, 256, "flash_attn_fwd"),
])
def test_flash_kernel_rule(dtype, dh, kernel):
    """Up to dh = 128, bf16 with dh % 8 == 0 goes to the bf16 tensor-core
    kernel and f32 with dh % 4 == 0 to the 3xTF32 one (three TF32
    products keep f32's tolerance, one would break it): their rows lie on
    TMA's 16-byte stride.  Every other head width up to 256 goes to the
    CUDA-core one.  A tensor-core kernel at a width other than its
    instance's 64 or 128 counts its launches apart."""
    assert flash_kernel(dtype, dh) == kernel
    key = flash_instance(dtype, dh)
    if kernel != "flash_attn_fwd" and dh not in (64, 128):
        assert key == f"{kernel}[padded]"
    else:
        assert key == kernel
    assert key in launch.LAUNCHES


@pytest.mark.parametrize("dh", [0, 257, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_kernel_rule_limits(dtype, dh):
    """The card's kernels take 1 <= dh <= 256: past that the rule raises,
    naming the limit (the wrapper raises so on CUDA tensors; on the CPU it
    runs the plain version, which takes any width, as the JAX package
    does)."""
    with pytest.raises(ValueError, match="256"):
        flash_kernel(dtype, dh)


@pytest.mark.parametrize("dtype,d,kernel", [
    (torch.float32, 128, "l2dist_wgmma"),     # the ground-truth chunk
    (torch.float32, 96, "l2dist_wgmma"),
    (torch.float32, 100, "l2dist_wgmma"),     # d off the 32-column slice
    (torch.float32, 4, "l2dist_wgmma"),
    (torch.float32, 1, "l2dist_wgmma"),       # row stride off 16 bytes:
    (torch.float32, 102, "l2dist_wgmma"),     # 4-byte cp.async copies
    (torch.float32, 132, "l2dist_wgmma"),     # the query tile streamed
    (torch.float32, 960, "l2dist_wgmma"),     # GIST1M
    (torch.float32, 131, "l2dist_wgmma"),
    (torch.bfloat16, 128, "l2dist_wgmma"),    # the chunk in bf16
    (torch.bfloat16, 96, "l2dist_wgmma"),
    (torch.bfloat16, 100, "l2dist_wgmma"),    # SPACEV1B: cp.async loads
    (torch.bfloat16, 960, "l2dist_wgmma"),    # the query tile streamed
    (torch.bfloat16, 102, "l2dist_wgmma"),    # 4-byte granules
    (torch.bfloat16, 2, "l2dist_wgmma"),
    (torch.bfloat16, 126, "l2dist_wgmma"),
    (torch.bfloat16, 101, "l2dist"),          # odd: rows on 2 bytes
    (torch.bfloat16, 1, "l2dist"),
    (torch.bfloat16, 129, "l2dist"),
    (torch.bfloat16, 130, "l2dist_wgmma"),    # streamed, off 16 bytes
])
def test_l2_kernel_rule(dtype, d, kernel):
    """f32 of every width and bf16 of every even width go to the
    tensor-core kernel (f32 loaded by TMA where d % 4 == 0, else by 4-byte
    cp.async copies; the query tile resident up to d = 128, streamed
    above); odd bf16 widths, whose rows lie on 2 bytes, to the CUDA-core
    one.  The tensor-core kernel counts its launches apart: f32 above 128,
    and in bf16 rows on the 16-byte stride (d % 8 == 0), the other even
    widths, and widths above 128."""
    assert l2_kernel(dtype, d) == kernel
    key = l2_instance(dtype, d)
    if kernel == "l2dist":
        assert key == kernel
    elif dtype == torch.float32:
        assert key == ("l2dist_wgmma[d>128]" if d > 128 else "l2dist_wgmma")
    elif d > 128:
        assert key == "l2dist_wgmma[bf16,d>128]"
    else:
        assert key == ("l2dist_wgmma[bf16]" if d % 8 == 0
                       else "l2dist_wgmma[bf16,off16]")
    assert key in launch.LAUNCHES


@pytest.mark.parametrize("b,n,sms", [
    (256, 1 << 20, 132),        # the ground-truth chunk on an H100
    (1, 777, 132), (3, 5003, 132), (129, 1000, 132), (256, 128, 132),
    (1000, 10_000, 132), (20_000, 300, 132), (5, 1, 1), (300, 999, 4),
])
def test_l2_plan_covers_every_tile_once(b, n, sms):
    """The tensor-core L2 kernel's grid: one row of blocks per 128-query
    tile, at most one block per SM where the query tiles fit, and the
    kernel's loop (block (x, y) takes vector tiles x, x + grid_x, ...)
    computes every (query tile, vector tile) pair once."""
    gx = l2_plan(b, n, sms)
    q_tiles, v_tiles = -(-b // 128), -(-n // 128)
    gy = q_tiles                        # l2dist_wgmma.cu's grid rows
    assert 1 <= gx <= v_tiles
    assert gx * gy <= max(sms, q_tiles)
    seen = np.zeros((q_tiles, v_tiles), np.int64)
    for y in range(gy):
        for x in range(gx):
            seen[y, x::gx] += 1
    assert (seen == 1).all()


def test_l2_plan_of_the_ground_truth_chunk():
    """256 queries x 2^20 vectors on 132 SMs: 66 x 2 blocks, each pair of
    rows in step over 124 or 125 of the 8,192 vector tiles."""
    assert l2_plan(256, 1 << 20, 132) == 66


@pytest.mark.parametrize("n,topk,sms", [
    (10_000_000, 512, 132),     # the smoke's phase 5 on an H100
    (1, 10, 132), (5, 512, 132), (777, 512, 132), (2048 + 7, 32, 132),
    (2_000_001, 2048, 132), (2_000_001, 512, 132), (50_000, 4000, 132),
    (50_000, 20_000, 132), (10_000_000, 100_000, 132), (1000, 7, 1),
    (123_457, 2048, 4), (123_457, 2049, 4),
])
def test_topk_plan_covers_every_row_once(n, topk, sms):
    """adc_scan_topk's grid: block i owns rows [i * rows, (i + 1) * rows),
    so the ranges are ascending, none is empty and together they hold
    every row once; each block keeps min(topk, rows) keys, at most 2,048
    (its 4,096 slots leave room for one more round of 2,048 rows); two
    blocks an SM where that keeps topk, more otherwise."""
    plan = ops.topk_plan(n, topk, sms)
    starts = [i * plan.rows for i in range(plan.grid)]
    ends = [min(n, s + plan.rows) for s in starts]
    assert starts[0] == 0 and ends[-1] == n
    assert all(s < e for s, e in zip(starts, ends))
    assert all(e == s for e, s in zip(ends, starts[1:]))
    assert plan.tk == min(topk, plan.rows)
    assert plan.tk <= 2048
    assert plan.grid <= 2 * sms or plan.rows == plan.tk == 2048
    if topk <= 2048:
        assert plan.grid <= 2 * sms


@pytest.mark.parametrize("n,topk", [(1, 10), (5, 3), (2048 + 7, 32),
                                    (30_001, 512), (30_001, 9000)])
def test_topk_plan_merge_is_the_stable_order(n, topk):
    """What the kernel's blocks write (each range's best tk by
    (dist, row), the last block padded with (+inf, INT_MAX)), merged as
    the wrapper merges it, is the first min(topk, N) of a stable sort of
    all N distances, ties from repeated code rows and +inf included."""
    rng = np.random.default_rng(40)
    d = torch.from_numpy(np.repeat(rng.integers(0, 50, -(-n // 3)), 3)[:n]
                         .astype(np.float32))
    d[::7] = torch.inf
    plan = ops.topk_plan(n, topk, sms=4)
    vals, ids = [], []
    for i in range(plan.grid):
        rows = torch.arange(i * plan.rows, min(n, (i + 1) * plan.rows))
        order = torch.sort(d[rows], stable=True)[1][:plan.tk]
        pad = plan.tk - len(order)
        vals.append(torch.cat([d[rows][order], torch.full((pad,), torch.inf)]))
        ids.append(torch.cat([rows[order], torch.full((pad,), 2**31 - 1)]))
    merged, pos = torch.sort(torch.cat(vals), stable=True)
    want_v, want_i = torch.sort(d, stable=True)
    k = min(topk, n)
    assert torch.equal(merged[:k], want_v[:k])
    assert torch.equal(torch.cat(ids)[pos[:k]], want_i[:k])


def test_library_path_hashes_every_header(tmp_path, monkeypatch):
    """A library's name changes with its source and with every header it
    includes: one of its csrc/, the shared Hopper header beside the
    packages, and a header that one of those includes, so an edit to any
    of them rebuilds it; a header it does not include (of another
    package, or shared but unused) leaves it as it was."""
    for pkg in ("l2dist", "pq_adc"):
        (tmp_path / pkg / "csrc").mkdir(parents=True)
    src = tmp_path / "l2dist" / "csrc" / "l2dist_wgmma.cu"
    own = tmp_path / "l2dist" / "csrc" / "own.cuh"
    shared = tmp_path / "hopper.cuh"
    nested = tmp_path / "nested.cuh"
    unused = tmp_path / "unused.cuh"
    other = tmp_path / "pq_adc" / "csrc" / "adc_common.cuh"
    includes = {src: '#include <stdint.h>\n#include "own.cuh"\n'
                     '#include "hopper.cuh"\n',
                own: '#include "nested.cuh"\n'}
    for f in (src, own, shared, nested, unused, other):
        f.write_text(includes.get(f, "") + "// v1\n")
    monkeypatch.setattr(build, "KERNELS", tmp_path)
    assert sorted(build.headers("l2dist_wgmma")) == sorted(
        [own, shared, nested])
    names = {build.library_path("l2dist_wgmma").name}
    for f in (src, own, shared, nested):
        f.write_text(includes.get(f, "") + "// v2\n")
        names.add(build.library_path("l2dist_wgmma").name)
    for f in (other, unused):
        f.write_text("// v2\n")
    assert build.library_path("l2dist_wgmma").name in names
    assert len(names) == 5
    assert all(n.startswith("libl2dist_wgmma-") for n in names)


@pytest.mark.parametrize("b,n,m,k,sms", [
    (64, 32_768, 32, 256, 132),      # the dense window on an H100
    (1, 777, 32, 256, 132),
    (9, 300_001, 32, 256, 132),
    (9, 5, 8, 256, 132),
    (130, 3001, 32, 256, 132),
    (1000, 10, 32, 256, 132),        # more tiles than SMs
    (64, 1 << 21, 8, 256, 132),
    (64, 100, 16, 16, 4),
    (3, 1, 1, 1, 1),
])
def test_dense_plan_one_wave_every_row_once(b, n, m, k, sms):
    """The dense grid: at most one block per SM, a LUT tile within 232,448
    bytes of shared memory (each LUT padded by 4 floats, and the block's
    mbarrier), query tiles that differ by at most one, and the kernel's
    loops (block (x, y) takes tiles y, y + grid_y, ... and rows x*P + i,
    x*P + i + grid_x*P, ... for i < P = 128 rows a pass) scan every
    (tile, row) once."""
    plan = ops.dense_plan(b, n, m, k, sms)
    assert plan.grid_x * plan.grid_y <= sms
    assert 1 <= plan.q_max <= 8
    assert plan.q_max * (m * k + 4) * 4 + 16 <= 232_448
    sizes = [b * (t + 1) // plan.tiles - b * t // plan.tiles
             for t in range(plan.tiles)]
    assert sum(sizes) == b and min(sizes) >= 1
    assert max(sizes) == plan.q_max and max(sizes) - min(sizes) <= 1
    rows = 128
    seen = np.zeros((plan.tiles, n), np.int64)
    for y in range(plan.grid_y):
        for tile in range(y, plan.tiles, plan.grid_y):
            for x in range(plan.grid_x):
                for start in range(x * rows, n, plan.grid_x * rows):
                    seen[tile, start:start + rows] += 1
    assert (seen == 1).all()


def test_dense_plan_balances_the_serving_window():
    """B = 64 at M = 32, K = 256: ten tiles of 6 or 7 queries (not nine of
    7 and one of 1), 13 x 10 blocks on 132 SMs."""
    plan = ops.dense_plan(64, 32_768, 32, 256, 132)
    assert plan == ops.DensePlan(tiles=10, q_max=7, grid_x=13, grid_y=10)
    with pytest.raises(ValueError):
        ops.dense_plan(1, 10, 256, 256, 132)    # one LUT over 227 KB


FUSED_SHAPES = [
    (64, 1024, 512, 32, 256, 132),   # the smoke's first serving window
    (64, 8192, 512, 32, 256, 132),   # a window of several tiles a CTA
    (64, 2048, 2048, 32, 256, 132), (1, 3000, 10, 32, 256, 132),
    (5, 37, 37, 8, 256, 132), (256, 1024, 512, 32, 256, 132),
    (130, 64, 64, 25, 256, 132), (64, 1024, 512, 24, 256, 132),
    (1, 1 << 16, 2048, 32, 256, 132),   # 8 CTAs of 8,192 slots
    (1, 1 << 15, 2000, 32, 256, 132),   # 8 CTAs of 4,096; 7 x 2,000
                                        # keys pushed to each
    (3, 100, 1, 3, 255, 4), (1, 1, 1, 1, 1, 1),
]


@pytest.mark.parametrize("b,s,tk,m,k,sms", FUSED_SHAPES)
def test_fused_plan_covers_every_slot_once(b, s, tk, m, k, sms):
    """adc_fused_topk's grid: a cluster of a power of two up to 8 CTAs a
    query, within two CTAs an SM over the batch where it is more than
    one; CTA r owns the 32-slot chunks r, r + cluster, ... (the kernel's
    loop), at most ``slots`` slots, together every slot once; its key
    buffer a multiple of 32 keys, at most 4,096, room for its sort (a
    power of two >= keep, >= 32) and for what it appends before it must
    select (all its slots, or keep + a tile of 1,024); its shared memory
    the kernel's layout (the LUT, the key buffer, the other CTAs' kept
    keys) within the card's 227 KB."""
    plan = ops.fused_plan(b, s, tk, m, k, sms)
    c = plan.cluster
    assert c in (1, 2, 4, 8)
    assert c == 1 or b * c <= 2 * sms
    seen = np.zeros(s, np.int64)
    chunks = -(-s // 32)
    for r in range(c):
        own = (chunks - r + c - 1) // c if r < chunks else 0
        assert own * 32 <= plan.slots
        for base in range(0, own, 32):              # a tile: 32 chunks
            for u in range(4):
                for warp in range(8):
                    ch = base + u * 8 + warp
                    if ch < own:
                        p = (ch * c + r) * 32 + np.arange(32)
                        seen[p[p < s]] += 1
    assert (seen == 1).all()
    assert plan.slots == -(-chunks // c) * 32
    assert plan.keep == min(tk, plan.slots)
    assert plan.cap % 32 == 0 and plan.cap <= 4096
    pow2 = 32
    while pow2 < plan.keep:
        pow2 *= 2
    assert plan.cap >= pow2
    assert plan.cap >= min(plan.slots, plan.keep + 1024)
    assert plan.smem == (-(-m * k // 4) * 16 + plan.cap * 8
                         + (c - 1) * plan.keep * 8)
    assert plan.smem + 2048 <= 232_448


def test_fused_plan_fills_the_card_at_the_serving_window():
    """B = 64 on 132 SMs: four CTAs a query, 256 CTAs (two an SM, about),
    256 slots each, at the main path's S = 1,024; at S = 8,192 each CTA
    takes two tiles into a 2,048-key buffer and selects once; each CTA
    receives the other three CTAs' kept keys."""
    assert ops.fused_plan(64, 1024, 512, 32, 256, 132) == ops.FusedPlan(
        cluster=4, slots=256, keep=256, cap=256, smem=40960)
    assert ops.fused_plan(64, 8192, 512, 32, 256, 132) == ops.FusedPlan(
        cluster=4, slots=2048, keep=512, cap=2048, smem=61440)
    assert ops.fused_plan(1, 3000, 512, 32, 256, 132).cluster == 8
    assert ops.fused_plan(132, 1024, 512, 32, 256, 132).cluster == 2
    assert ops.fused_plan(133, 1024, 512, 32, 256, 132).cluster == 1


def test_fused_plan_raises_past_its_buffer():
    """tk > 3,072 with more than 4,096 slots a CTA even at 8 CTAs has no
    key buffer the kernel takes; 7 peers' 4,000 kept keys (224 KB) and a
    LUT past shared memory neither."""
    with pytest.raises(ValueError):
        ops.fused_plan(1, 1 << 16, 4000, 32, 256, 132)
    with pytest.raises(ValueError):
        ops.fused_plan(1, 1 << 15, 4000, 32, 256, 132)
    with pytest.raises(ValueError):
        ops.fused_plan(64, 1024, 512, 256, 256, 132)


@pytest.mark.parametrize("m,address,width", [
    (32, 0, 16), (32, 256, 16), (16, 48, 16), (32, 8, 8), (24, 0, 8),
    (25, 0, 1), (100, 0, 4), (32, 1, 1), (6, 2, 2), (8, 4, 4)])
def test_load_width(m, address, width):
    """The fused scan's code loads: the widest of 16, 8, 4, 2, 1 bytes
    that divides both M and the table's address (DEEP1B's M = 24 in 8
    bytes, SPACEV1B's M = 25 a byte at a time)."""
    assert ops.load_width(m, address) == width


def _fused_merge_replay(d, valid, tk, plan):
    """What adc_fused_topk writes for one query of distances ``d`` (S,)
    with ``valid`` (S,) slots, replayed in torch: each CTA (32-slot chunks
    dealt in turn) keeps its best
    ``plan.keep`` valid keys by (dist, slot), sorted; a key's output
    position is its index in its list plus the count of keys below it in
    each other CTA's list; positions below tk are written, those from the
    cluster's key count to tk get (+inf, -1)."""
    s, c = d.shape[0], plan.cluster
    lists = []
    for r in range(c):
        slots = torch.arange(s)[(torch.arange(s) // 32) % c == r]
        slots = slots[valid[slots]]
        order = torch.sort(d[slots], stable=True)[1][:plan.keep]
        lists.append(slots[order])
    out_d = torch.full((tk,), torch.inf)
    out_s = torch.full((tk,), -1, dtype=torch.int64)
    written = torch.zeros(tk, dtype=torch.int64)
    for r, own in enumerate(lists):
        for i, x in enumerate(own.tolist()):
            pos = i
            for q, other in enumerate(lists):
                if q != r:
                    pos += int(((d[other] < d[x]) |
                                ((d[other] == d[x]) & (other < x))).sum())
            if pos < tk:
                out_d[pos], out_s[pos] = d[x], x
                written[pos] += 1
    total = sum(len(x) for x in lists)
    assert (written[:min(total, tk)] == 1).all()
    return out_d, out_s


@pytest.mark.parametrize("s,tk,valid_share", [
    (1024, 512, 0.5), (1024, 512, 0.3), (8192, 512, 0.5), (3000, 10, 0.9),
    (2048, 2048, 0.6), (300, 300, 1.0), (130, 512, 0.0)])
def test_fused_merge_in_the_launch_is_the_stable_order(s, tk, valid_share):
    """The merge by rank across a query's cluster, on its plan (64
    queries on 132 SMs: four CTAs, or one where S is short), gives the
    first tk of a stable sort of the query's distances with pads at
    +inf: ties from repeated distances to the lowest slot, every position
    written once, pads (and a query with none valid) as (+inf, -1)."""
    rng = np.random.default_rng(41)
    tk = min(tk, s)
    plan = ops.fused_plan(64, s, tk, 32, 256, 132)
    n_valid = int(s * valid_share)
    d = torch.from_numpy(rng.integers(0, 40, s).astype(np.float32))
    valid = torch.zeros(s, dtype=torch.bool)
    valid[:n_valid] = True
    got_d, got_s = _fused_merge_replay(d, valid, tk, plan)
    want_d, want_s = torch.sort(d.masked_fill(~valid, torch.inf), stable=True)
    want_s = torch.where(valid[want_s], want_s, -1)
    assert torch.equal(got_d, want_d[:tk])
    assert torch.equal(got_s, want_s[:tk])
