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

Both wrappers also take any real dtype, mixed dtypes and views, as the
JAX ones do: uint8, int8, f16 and mixed inputs against the JAX ops, L2 on
integers exactly (every sum an integer below 2^24 on both sides), f16
flash outputs to 2e-3 (each side rounds its f32 result to f16 once, 2^-11
of values below 4).

The launch planners that size the CUDA kernels (which dtype the L2 and
flash kernels compute inputs in, which flash kernel, instance and padded
width a dtype and head width go to, which L2 instance and width a dtype
and width go to; the dense scan's one-wave grid; the fused scan's
clusters, key buffers and code-load widths, its route past them, and
both of its merges, replayed in torch) and ``build.py``'s library names
are pure Python and are held here too.  The CUDA kernels against their plain
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
                                            flash_instance, flash_kernel,
                                            flash_plan, flash_width)
from repro_torch.kernels.l2dist import (l2_distances, l2_instance,
                                        l2_kernel, l2_plan, l2_width,
                                        l2dist_ref)
from repro_torch.kernels.launch import operand_dtype
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


# (numpy dtype, jnp dtype, torch dtype) of each input kind
_KINDS = {"u8": (np.uint8, jnp.uint8, torch.uint8),
          "i8": (np.int8, jnp.int8, torch.int8),
          "f16": (np.float16, jnp.float16, torch.float16),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16),
          "f32": (np.float32, jnp.float32, torch.float32)}


def _kind_values(rng, kind, shape):
    """Values of ``kind`` made in numpy: integers across the type's range
    (below 2^8 in magnitude), normal floats otherwise (bf16 ones rounded
    to bf16 first)."""
    if kind == "u8":
        return rng.integers(0, 256, shape).astype(np.uint8)
    if kind == "i8":
        return rng.integers(-128, 128, shape).astype(np.int8)
    x = rng.standard_normal(shape).astype(np.float32)
    return _bf16(x) if kind == "bf16" else x.astype(_KINDS[kind][0])


@pytest.mark.parametrize("q_kind,v_kind,d", [
    ("u8", "u8", 128),      # SIFT1B's data: bf16 on the card, exactly
    ("i8", "i8", 100),      # SPACEV1B's
    ("u8", "u8", 101),      # an odd width: zero-padded to 104 on the card
    ("f16", "f16", 96),     # f32 on the card
    ("u8", "f32", 64),      # mixed: f32
    ("i8", "bf16", 36),     # mixed, both exact in bf16: bf16
])
@MODES
def test_l2_distances_any_dtype_match_jax(q_kind, v_kind, d, use_kernel):
    """L2 over inputs of any real dtype, as the JAX op takes them (its
    kernel widens both to f32): integers exactly, since every product and
    sum is an integer below 2^24 on both sides; floats to f32's 1e-4."""
    rng = np.random.default_rng(d)
    q, v = (_kind_values(rng, kind, shape)
            for kind, shape in ((q_kind, (5, d)), (v_kind, (300, d))))
    want = np.asarray(j_l2(jnp.asarray(q, _KINDS[q_kind][1]),
                           jnp.asarray(v, _KINDS[v_kind][1]), block_q=8,
                           block_n=128, use_kernel=use_kernel))
    got = l2_distances(_t(q).to(_KINDS[q_kind][2]),
                       _t(v).to(_KINDS[v_kind][2]))
    assert got.dtype == torch.float32 and tuple(got.shape) == (5, 300)
    if all(kind in ("u8", "i8") for kind in (q_kind, v_kind)):
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_l2_distances_take_strided_views():
    """A transposed and a column-sliced view give the distances of their
    contiguous copies (the card copies them before its loads), to f32's
    1e-5 (the CPU's matrix product may sum a view in another order)."""
    rng = np.random.default_rng(12)
    q = _t(rng.standard_normal((40, 7)).astype(np.float32)).T   # (7, 40)
    v = _t(rng.standard_normal((90, 50)).astype(np.float32))[:, 5:45]
    assert not (q.is_contiguous() or v.is_contiguous())
    torch.testing.assert_close(
        l2_distances(q, v), l2_distances(q.contiguous(), v.contiguous()),
        rtol=1e-5, atol=1e-4)


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
    # BERT4Rec's attention (two heads of 32, S = T = 200, not causal): the
    # card's narrow (32, 32) instance in f32
    (2, 200, 2, 2, 32, False, 200, 40),
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


@pytest.mark.parametrize("kinds,dh", [
    (("f16", "f16", "f16"), 64),        # f32 on the card, f16 out
    (("f16", "f32", "bf16"), 36),       # mixed: f32
    (("f32", "u8", "i8"), 40),          # integer keys and values
    (("bf16", "i8", "u8"), 24),         # all exact in bf16: bf16
])
@MODES
def test_flash_attention_any_dtype_match_jax(kinds, dh, use_kernel):
    """Attention over inputs of any real dtype, mixed, as the JAX op takes
    them (its kernel widens each to f32 and returns q's dtype): f32
    outputs to 2e-5, f16 to 2e-3, bf16 to 5e-2 (each side rounds its f32
    result once to q's dtype)."""
    rng = np.random.default_rng(dh)
    shapes = ((1, 32, 4, dh), (1, 32, 2, dh), (1, 32, 2, dh))
    vals = [_kind_values(rng, kind, shape)
            for kind, shape in zip(kinds, shapes)]
    # integer keys and values kept small, so scores stay in softmax range
    vals = [x // 16 if x.dtype.kind in "ui" else x for x in vals]
    want = np.asarray(j_flash(*(jnp.asarray(x, _KINDS[kd][1])
                                for x, kd in zip(vals, kinds)),
                              block_q=16, block_k=16, use_kernel=use_kernel))
    got = flash_attention(*(_t(x).to(_KINDS[kd][2])
                            for x, kd in zip(vals, kinds)))
    assert got.dtype == _KINDS[kinds[0]][2]
    tol = {"f32": 2e-5, "f16": 2e-3, "bf16": 5e-2}[kinds[0]]
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               rtol=tol, atol=tol)


def test_flash_attention_takes_strided_views():
    """Views of q, k and v (heads sliced out of a wider tensor) give the
    output of their contiguous copies."""
    rng = np.random.default_rng(13)
    x = _t(rng.standard_normal((1, 24, 6, 16)).astype(np.float32))
    q, k, v = x[:, :, :4], x[:, :, 4:5], x[:, :, 5:6]
    assert not q.is_contiguous()
    assert torch.equal(flash_attention(q, k, v),
                       flash_attention(*(y.contiguous() for y in (q, k, v))))


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
    (torch.bfloat16, 36, "flash_attn_fwd_wgmma"),   # rows off 16 bytes
    (torch.bfloat16, 6, "flash_attn_fwd_wgmma"),
    (torch.bfloat16, 136, "flash_attn_fwd_wgmma"),  # the 256 instance
    (torch.bfloat16, 192, "flash_attn_fwd_wgmma"),
    (torch.bfloat16, 256, "flash_attn_fwd_wgmma"),
    (torch.float32, 128, "flash_attn_fwd_tf32"),
    (torch.float32, 64, "flash_attn_fwd_tf32"),
    (torch.float32, 96, "flash_attn_fwd_tf32"),     # padded to 128
    (torch.float32, 32, "flash_attn_fwd_tf32"),     # the narrow instance
    (torch.float32, 36, "flash_attn_fwd_tf32"),     # padded to 64
    (torch.float32, 8, "flash_attn_fwd_tf32"),
    (torch.float32, 6, "flash_attn_fwd_tf32"),      # rows off 16 bytes
    (torch.float32, 1, "flash_attn_fwd_tf32"),
    (torch.float32, 132, "flash_attn_fwd_tf32"),    # the 256 instance
    (torch.float32, 192, "flash_attn_fwd_tf32"),
    (torch.float32, 256, "flash_attn_fwd_tf32"),
])
def test_flash_kernel_rule(dtype, dh, kernel):
    """bf16 goes to the bf16 tensor-core kernel and f32 to the 3xTF32 one
    (three TF32 products keep f32's tolerance, one would break it) at
    every head width up to 256.  A head width off TMA's 16-byte row
    stride (bf16 dh % 8, f32 dh % 4) is padded with zero columns to it
    and counts as [stride-pad]; on it, above 128 the 256 instance counts
    as [256], f32 up to 32 the narrow (32, 32) instance as [32], and a
    width other than an instance's 64 or 128 as [padded]."""
    assert flash_kernel(dtype, dh) == kernel
    key = flash_instance(dtype, dh)
    step = 8 if dtype == torch.bfloat16 else 4
    if dh % step:
        assert key == f"{kernel}[stride-pad]"
    elif dh > 128:
        assert key == f"{kernel}[256]"
    elif dh <= 32 and dtype == torch.float32:
        assert key == f"{kernel}[32]"
    elif dh not in (64, 128):
        assert key == f"{kernel}[padded]"
    else:
        assert key == kernel
    assert key in launch.LAUNCHES


@pytest.mark.parametrize("dtype,dh,width,key", [
    (torch.bfloat16, 129, 136, "flash_attn_fwd_wgmma[stride-pad]"),
    (torch.bfloat16, 136, 136, "flash_attn_fwd_wgmma[256]"),
    (torch.bfloat16, 200, 200, "flash_attn_fwd_wgmma[256]"),
    (torch.bfloat16, 255, 256, "flash_attn_fwd_wgmma[stride-pad]"),
    (torch.bfloat16, 100, 104, "flash_attn_fwd_wgmma[stride-pad]"),
    (torch.bfloat16, 1, 8, "flash_attn_fwd_wgmma[stride-pad]"),
    (torch.float32, 129, 132, "flash_attn_fwd_tf32[stride-pad]"),
    (torch.float32, 132, 132, "flash_attn_fwd_tf32[256]"),
    (torch.float32, 254, 256, "flash_attn_fwd_tf32[stride-pad]"),
    (torch.float32, 66, 68, "flash_attn_fwd_tf32[stride-pad]"),
    (torch.float32, 6, 8, "flash_attn_fwd_tf32[stride-pad]"),
    (torch.uint8, 96, 96, "flash_attn_fwd_wgmma[padded]"),   # bf16
    (torch.int8, 100, 104, "flash_attn_fwd_wgmma[stride-pad]"),
    (torch.float16, 66, 68, "flash_attn_fwd_tf32[stride-pad]"),  # f32
    (torch.float64, 256, 256, "flash_attn_fwd_tf32[256]"),
])
def test_flash_rule_wide_and_off_stride(dtype, dh, width, key):
    """129..256 and the widths off the 16-byte stride: the head width the
    kernel sees (the next multiple of 8 in bf16, of 4 in f32) and the key
    a launch counts under, for inputs that compute in bf16 (uint8, int8,
    bf16) or in f32 (every other dtype)."""
    assert flash_width(dtype, dh) == width
    assert flash_instance(dtype, dh) == key
    assert key in launch.LAUNCHES


@pytest.mark.parametrize("dtypes,want", [
    ((torch.uint8,), torch.bfloat16), ((torch.int8,), torch.bfloat16),
    ((torch.bfloat16,), torch.bfloat16),
    ((torch.uint8, torch.int8), torch.bfloat16),
    ((torch.bfloat16, torch.uint8, torch.int8), torch.bfloat16),
    ((torch.float16,), torch.float32), ((torch.float32,), torch.float32),
    ((torch.float64,), torch.float32), ((torch.int16,), torch.float32),
    ((torch.int32,), torch.float32), ((torch.int64,), torch.float32),
    ((torch.bool,), torch.float32),
    ((torch.uint8, torch.float32), torch.float32),
    ((torch.bfloat16, torch.float16), torch.float32),
    ((torch.bfloat16, torch.bfloat16, torch.float32), torch.float32),
])
def test_operand_dtype_rule(dtypes, want):
    """The kernels compute in bf16 where every input is uint8, int8 or
    bf16 (each value exact in bf16) and in f32, the JAX kernels' type,
    for any other mix."""
    assert operand_dtype(*dtypes) == want


def test_operand_dtype_refuses_complex():
    with pytest.raises(TypeError):
        operand_dtype(torch.complex64)


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


@pytest.mark.parametrize("dtype,dh,dv,key", [
    (torch.bfloat16, 192, 128, "flash_attn_fwd_wgmma[dv]"),   # MLA
    (torch.float32, 192, 128, "flash_attn_fwd_tf32[dv]"),
    (torch.bfloat16, 48, 32, "flash_attn_fwd_wgmma[dv]"),     # reduced MLA
    (torch.bfloat16, 100, 60, "flash_attn_fwd_wgmma[dv]"),    # off stride
    (torch.float32, 6, 2, "flash_attn_fwd_tf32[dv]"),
    (torch.bfloat16, 128, 128, "flash_attn_fwd_wgmma"),       # dv == dh
    (torch.float32, 192, 192, "flash_attn_fwd_tf32[256]"),
    (torch.bfloat16, 100, 100, "flash_attn_fwd_wgmma[stride-pad]"),
])
def test_flash_instance_narrow_v(dtype, dh, dv, key):
    """v narrower than q and k counts as ``<kernel>[dv]`` whatever the
    strides (both dtypes: the instances with a V width of their own); a v
    as wide as q keeps the key of its head width; a v wider than q, or
    of no width, raises."""
    assert flash_instance(dtype, dh, dv) == key
    assert key in launch.LAUNCHES
    for bad in (dh + 1, 0):
        with pytest.raises(ValueError, match="v width"):
            flash_instance(dtype, dh, bad)


_BF, _F32 = torch.bfloat16, torch.float32
_WG, _TF = "flash_attn_fwd_wgmma", "flash_attn_fwd_tf32"


@pytest.mark.parametrize("dtype,dh,dv,instance,widths,key", [
    (_BF, 192, 128, (192, 128), (192, 128), f"{_WG}[dv]"),      # MLA
    (_F32, 192, 128, (192, 128), (192, 128), f"{_TF}[dv]"),
    (_BF, 48, 32, (64, 64), (48, 32), f"{_WG}[dv]"),            # reduced
    (_BF, 100, 60, (128, 128), (104, 64), f"{_WG}[dv]"),        # off stride
    (_F32, 6, 2, (32, 32), (8, 4), f"{_TF}[dv]"),
    (_BF, 128, 128, (128, 128), (128, 128), _WG),                # dv == dh
    (_F32, 192, 192, (256, 256), (192, 192), f"{_TF}[256]"),
    (_BF, 100, 100, (128, 128), (104, 104), f"{_WG}[stride-pad]"),
    (_F32, 160, 64, (192, 128), (160, 64), f"{_TF}[dv]"),
    (_BF, 160, 64, (192, 128), (160, 64), f"{_WG}[dv]"),
    (_F32, 256, 128, (256, 256), (256, 128), f"{_TF}[dv]"),
    (_BF, 256, 128, (256, 256), (256, 128), f"{_WG}[dv]"),
    (_F32, 136, 120, (192, 128), (136, 120), f"{_TF}[dv]"),
    (_BF, 136, 120, (192, 128), (136, 120), f"{_WG}[dv]"),
    (_BF, 192, 136, (256, 256), (192, 136), f"{_WG}[dv]"),      # v > 128
    (_F32, 190, 130, (256, 256), (192, 132), f"{_TF}[dv]"),
    (_F32, 64, None, (64, 64), (64, 64), _TF),                   # dense
    (_F32, 128, None, (128, 128), (128, 128), _TF),
    (_BF, 64, None, (64, 64), (64, 64), _WG),
    (_BF, 96, None, (128, 128), (96, 96), f"{_WG}[padded]"),
    (_F32, 96, None, (128, 128), (96, 96), f"{_TF}[padded]"),
    (_F32, 256, None, (256, 256), (256, 256), f"{_TF}[256]"),
    (_BF, 256, None, (256, 256), (256, 256), f"{_WG}[256]"),
    # f32 up to 32 wide: the narrow instance (BERT4Rec's heads of 32)
    (_F32, 32, None, (32, 32), (32, 32), f"{_TF}[32]"),
    (_F32, 20, None, (32, 32), (20, 20), f"{_TF}[32]"),
    (_F32, 8, None, (32, 32), (8, 8), f"{_TF}[32]"),
    (_F32, 6, None, (32, 32), (8, 8), f"{_TF}[stride-pad]"),
    (_F32, 1, None, (32, 32), (4, 4), f"{_TF}[stride-pad]"),
    (_F32, 32, 16, (32, 32), (32, 16), f"{_TF}[dv]"),
    (_F32, 30, 10, (32, 32), (32, 12), f"{_TF}[dv]"),
    (_F32, 36, None, (64, 64), (36, 36), f"{_TF}[padded]"),
    (_F32, 33, None, (64, 64), (36, 36), f"{_TF}[stride-pad]"),
    # bf16 keeps (64, 64) there: no model of the repo runs bf16 at dh <= 32
    (_BF, 32, None, (64, 64), (32, 32), f"{_WG}[padded]"),
    (_BF, 32, 16, (64, 64), (32, 16), f"{_WG}[dv]"),
    (_BF, 8, None, (64, 64), (8, 8), f"{_WG}[padded]"),
], ids=str)
def test_flash_plan(dtype, dh, dv, instance, widths, key):
    """The instance both kernels' C entry points pick, the widths the
    wrapper passes them (rounded to the 16-byte row stride) and the launch
    key: in f32 (32, 32) up to 32, then in both dtypes (64, 64) up to 64,
    (128, 128) up to 128, (192, 128) up to 192 with v at most 128 wide
    (MLA's prefill, in f32 as in bf16: no v padded to q's width), (256,
    256) for the rest."""
    plan = flash_plan(dtype, dh, dv)
    assert plan == (instance, widths, key)
    assert plan.key == flash_instance(dtype, dh, dv)
    assert key in launch.LAUNCHES


@pytest.mark.parametrize("dtype", [_F32, _BF], ids=["f32", "bf16"])
def test_flash_plan_takes_the_smallest_instance_that_holds(dtype):
    """For every pair 1 <= dv <= dh <= 256 the plan's instance holds the
    widths it passes (kDh >= q/k's, kDv >= v's), and no instance earlier in
    its dtype's order does: (32, 32) in f32 only, then (64, 64), (128,
    128), (192, 128), (256, 256)."""
    order = (((32, 32),) if dtype == _F32 else ()) + (
        (64, 64), (128, 128), (192, 128), (256, 256))
    for dh in range(1, 257, 3):
        for dv in range(1, dh + 1, 5):
            plan = flash_plan(dtype, dh, dv)
            dp, dvp = plan.widths
            assert (dp, dvp) == (flash_width(dtype, dh),
                                 flash_width(dtype, dv))
            holds = [i for i in order if i[0] >= dp and i[1] >= dvp]
            assert plan.instance == holds[0]


def test_tma_view_rule():
    """``launch.tma_view``: the f32 kernel reads q, k and v split from one
    (B, S, 3H, dh) tensor (BERT4Rec's encode) as they lie, and a (B, H,
    S, dh) tensor's transpose too; it refuses another dtype or width, a
    view 4 bytes off a 16-byte boundary, a last axis that is not
    unit-stride and rows off 16 bytes (all copied first).
    ``launch.tma_strides`` gives the leading axes' strides, 16 bytes'
    worth on an axis of length 1."""
    x = torch.zeros(2, 200, 6, 32)
    q, k, v = torch.split(x, 2, dim=2)
    assert all(launch.tma_view(t, torch.float32, 32) for t in (q, k, v))
    assert launch.tma_strides(q) == (38400, 192, 32)
    assert k.data_ptr() - q.data_ptr() == 256
    assert launch.tma_view(torch.zeros(2, 2, 200, 32).transpose(1, 2),
                           torch.float32, 32)
    assert launch.tma_view(x[:, :, :1], torch.float32, 32)       # Hk = 1
    assert launch.tma_strides(x[:, :, :1]) == (38400, 192, 4)
    assert not launch.tma_view(q, torch.bfloat16, 32)            # dtype
    assert not launch.tma_view(q, torch.float32, 36)             # width
    flat = torch.zeros(2 * 200 * 2 * 32 + 1)
    off = flat[1:].view(2, 200, 2, 32)                           # 4 bytes off
    assert off.data_ptr() % 16 == 4
    assert not launch.tma_view(off, torch.float32, 32)
    assert not launch.tma_view(torch.zeros(2, 200, 2, 64)[..., ::2],
                               torch.float32, 32)                # last stride
    rows = torch.zeros(2, 200, 2, 33)[..., :32]                  # 132 B rows
    assert rows.stride(-1) == 1 and rows.data_ptr() % 16 == 0
    assert not launch.tma_view(rows, torch.float32, 32)


def test_flash_attention_narrow_v_on_cpu_runs_the_plain_version():
    """On CPU tensors the wrapper runs its plain version at dv < dh, as
    at dv == dh, and launches nothing."""
    rng = np.random.default_rng(11)
    q, k = (_t(rng.standard_normal((2, 20, h, 48)).astype(np.float32))
            for h in (4, 2))
    v = _t(rng.standard_normal((2, 20, 2, 32)).astype(np.float32))
    before = dict(launch.LAUNCHES)
    got = flash_attention(q, k, v, causal=True)
    assert got.shape == (2, 20, 4, 32)
    assert torch.equal(got, flash_attn_ref(q, k, v, causal=True))
    assert launch.LAUNCHES == before


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
    (torch.bfloat16, 101, "l2dist_wgmma"),    # odd: zero-padded to 104
    (torch.bfloat16, 1, "l2dist_wgmma"),
    (torch.bfloat16, 129, "l2dist_wgmma"),
    (torch.bfloat16, 130, "l2dist_wgmma"),    # streamed, off 16 bytes
])
def test_l2_kernel_rule(dtype, d, kernel):
    """Every dtype and width go to the tensor-core kernel: f32 loaded by
    TMA where d % 4 == 0, else by 4-byte cp.async copies; bf16 of even
    width by cp.async; odd bf16 widths, whose rows lie on 2 bytes, copied
    with zero columns to a multiple of 8 first; the query tile resident
    up to d = 128,
    streamed above.  It counts its launches apart: f32 above 128, and in
    bf16 odd widths, rows on the 16-byte stride (d % 8 == 0), the other
    even widths, and widths above 128."""
    assert l2_kernel(dtype, d) == kernel
    key = l2_instance(dtype, d)
    if dtype == torch.bfloat16 and d % 2:
        assert key == "l2dist_wgmma[bf16,odd]"
        assert l2_width(dtype, d) == -(-d // 8) * 8
    elif dtype == torch.float32:
        assert key == ("l2dist_wgmma[d>128]" if d > 128 else "l2dist_wgmma")
    elif d > 128:
        assert key == "l2dist_wgmma[bf16,d>128]"
    else:
        assert key == ("l2dist_wgmma[bf16]" if d % 8 == 0
                       else "l2dist_wgmma[bf16,off16]")
    assert key in launch.LAUNCHES


@pytest.mark.parametrize("dtype,d,width,key", [
    (torch.uint8, 128, 128, "l2dist_wgmma[int8]"),        # SIFT1B
    (torch.int8, 100, 100, "l2dist_wgmma[int8,off16]"),   # SPACEV1B
    (torch.uint8, 64, 64, "l2dist_wgmma[int8]"),
    (torch.int8, 4, 4, "l2dist_wgmma[int8,off16]"),
    (torch.uint8, 104, 104, "l2dist_wgmma[int8,off16]"),  # 8-byte copies
    (torch.uint8, 101, 104, "l2dist_wgmma[bf16,odd]"),    # stay on bf16
    (torch.int8, 3, 8, "l2dist_wgmma[bf16,odd]"),
    (torch.uint8, 257, 264, "l2dist_wgmma[bf16,odd]"),
    (torch.uint8, 130, 130, "l2dist_wgmma[bf16,d>128]"),
    (torch.int8, 98, 98, "l2dist_wgmma[bf16,off16]"),
    (torch.float16, 96, 96, "l2dist_wgmma"),             # f32
    (torch.float16, 101, 101, "l2dist_wgmma"),
    (torch.float64, 960, 960, "l2dist_wgmma[d>128]"),
    (torch.int32, 128, 128, "l2dist_wgmma"),
])
def test_l2_rule_of_other_dtypes(dtype, d, width, key):
    """8-bit inputs (uint8, int8) of d <= 128 with d % 4 == 0 take the
    8-bit instances as they are, ``[int8]`` on TMA's 16-byte row stride
    and ``[int8,off16]`` off it; other 8-bit widths (odd, d % 4 != 0,
    d > 128) compute in bf16 on its instances, odd widths zero-padded to
    a multiple of 8; every other dtype the f32 ones at its own width."""
    assert l2_width(dtype, d) == width
    assert l2_instance(dtype, d) == key
    assert key in launch.LAUNCHES


@pytest.mark.parametrize("qdt,vdt", [
    (torch.uint8, torch.uint8), (torch.int8, torch.int8),
    (torch.uint8, torch.int8), (torch.int8, torch.uint8)])
@pytest.mark.parametrize("d", [4, 32, 100, 128])
def test_l2_8bit_exact_in_int32(qdt, vdt, d):
    """The 8-bit instances' arithmetic: |q|^2 - 2 q.v + |v|^2 evaluated
    exactly (int64 here, int32 on the card), cast once to f32, equals
    l2dist_ref bit for bit for u8 and s8 and their mixes, at the extremes
    of their ranges (0 / 255, -128 / 127), so the wrapper takes them with
    no cast; each mix is one of those instances.  u8 or s8 alone stay
    below 128 * 255^2 < 2^24; a mix reaches 128 * 383^2 > 2^24, where
    |q|^2 - 2 q.v is still below 2^24 (exact in f32), so the plain
    version's last add rounds once, as the one conversion does."""
    rng = np.random.default_rng(d)
    ends = {torch.uint8: (0, 255), torch.int8: (-128, 127)}

    def draw(dt, rows):
        lo, hi = ends[dt]
        x = rng.choice(np.array([lo, hi]), (rows, d))
        x[1::2] = rng.integers(lo, hi + 1, (rows // 2, d))
        x[0] = hi if lo == 0 else lo            # the largest squares
        return torch.from_numpy(x.astype(np.int64))
    q, v = draw(qdt, 9), draw(vdt, 301)
    head = (q * q).sum(1)[:, None] - 2 * q @ v.T
    exact = head + (v * v).sum(1)[None, :]
    assert int(head.abs().max()) < 1 << 24
    want = l2dist_ref(q.to(qdt), v.to(vdt))
    assert torch.equal(exact.to(torch.float32), want)
    assert l2_instance(qdt, d, vdt) == ("l2dist_wgmma[int8]" if d % 16 == 0
                                        else "l2dist_wgmma[int8,off16]")


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


# (B, S, tk): the windows the executor makes for a large top_n (S the
# next power of two of the longest candidate list, tk = min(top_n, S))
ROUTE_SHAPES = [(b, s, tk) for b in (1, 8, 64) for s in (1 << 15, 1 << 16)
                for tk in (3072, 4096)] + [
    (1, 1 << 15, 1 << 15), (1, 1 << 16, 1 << 16), (64, 1 << 17, 4096),
    (64, 1024, 512), (64, 8192, 512), (1, 3000, 10), (5, 37, 37),
    (1, 1 << 16, 2048), (64, 1 << 15, 512)]


@pytest.mark.parametrize("b,s,tk", ROUTE_SHAPES)
def test_fused_route_serves_every_window(b, s, tk):
    """fused_route keeps fused_plan's one launch wherever it fits (the
    serving windows of rows 2 and 2b among them) and takes the spill
    route elsewhere: fused_plan's cluster a query (at most 8), every slot
    dealt to one CTA, each CTA's key buffer a power of two up to 16,384
    keys, room for all its slots and twice what it may keep where that
    fits; a round keeps keep = min(tk, cap / 2), so a CTA's sorted share
    and its inbox of the others' shares (keep keys in all) fit the buffer
    together, and where the slots pass the buffer a tile's appends fit
    beside keep; its shared memory the LUT, the buffer (inbox included)
    and the select's two histograms and sums (3 KB), within the card's
    227 KB.  Every tk <= S is served, up to S = 2^17."""
    m, k, sms = 32, 256, 132
    route = ops.fused_route(b, s, tk, m, k, sms)
    try:
        want = ops.fused_plan(b, s, tk, m, k, sms)
    except ValueError:
        want = None
    if want is not None:
        assert route == ops.FusedRoute("adc_fused_topk", want)
        return
    plan, c = route.plan, route.plan.cluster
    assert route.key == "adc_fused_topk[spill]"
    assert route.key in launch.LAUNCHES
    assert c == ops._fused_cluster(b, s, sms) and c in (1, 2, 4, 8)
    chunks = -(-s // 32)
    assert plan.slots == -(-chunks // c) * 32
    seen = np.zeros(s, np.int64)
    for r in range(c):
        own = (chunks - r + c - 1) // c if r < chunks else 0
        assert own * 32 <= plan.slots
        for ch in range(own):
            p = (ch * c + r) * 32 + np.arange(32)
            seen[p[p < s]] += 1
    assert (seen == 1).all()
    cap = plan.cap

    def pow2ceil(x):
        return 1 << (x - 1).bit_length()
    assert cap & (cap - 1) == 0 and 64 <= cap <= 16384
    assert cap == min(16384, max(64, pow2ceil(plan.slots),
                                 2 * pow2ceil(min(tk, plan.slots))))
    assert plan.keep == min(tk, cap // 2)
    assert plan.slots <= cap or plan.keep + 1024 <= cap
    assert plan.smem == -(-m * k // 4) * 16 + cap * 8 + 3 * 256 * 4
    assert plan.smem + 2048 <= 232_448


def test_fused_route_keeps_the_serving_windows_on_one_launch():
    """The smoke's windows (S = 1,024 and 8,192 at topk 512) run the
    one-launch code of rows 2 and 2b; a top_n of 4,096 over lists past
    16,384 rows (S = 32,768), which fused_plan refuses, takes the spill
    route: one cluster of four CTAs a query (256 CTAs at B = 64, two an
    SM), 8,192 slots and an 8,192-key buffer each (its sorted share and
    the inbox of the others' in it), one round of 4,096."""
    for s in (1024, 8192):
        assert ops.fused_route(64, s, 512, 32, 256, 132).key == \
            "adc_fused_topk"
    route = ops.fused_route(64, 1 << 15, 4096, 32, 256, 132)
    assert route == ops.FusedRoute("adc_fused_topk[spill]", ops.FusedPlan(
        cluster=4, slots=8192, keep=4096, cap=8192, smem=101376))


def test_fused_route_raises_past_the_grid_and_shared_memory():
    """Past 65,535 queries a window (the grid's rows) or a LUT that leaves
    no room for a 2,048-key buffer, no route serves: it raises."""
    with pytest.raises(ValueError, match="65535"):
        ops.fused_route(65536, 1 << 15, 4096, 32, 256, 132)
    with pytest.raises(ValueError):
        ops.fused_route(64, 1024, 512, 256, 256, 132)


@pytest.mark.parametrize("b,s,tk,valid_share", [
    (1, 1 << 15, 4096, 0.6), (1, 1 << 15, 3072, 0.3),
    (1, 1 << 16, 4096, 0.55), (1, 1 << 15, 1 << 15, 0.8),
    (64, 1 << 15, 4096, 0.5), (64, 1 << 15, 4096, 0.0),
    (64, 1 << 17, 4096, 0.7), (64, 1 << 17, 40_000, 0.4),
    (1, 1 << 16, 1 << 16, 0.9)])
def test_fused_spill_merge_is_the_stable_order(b, s, tk, valid_share):
    """The spill route replayed on its plan for a window of B queries
    (``_spill_replay``: the scan's cluster selects every (cap - keep) /
    1,024 tiles where the slots pass the buffer, the final select, each
    CTA's sorted share placed by rank, rounds of keep keys), with ties
    (integer distances below 3,000), gives the first tk of a stable sort
    of the query's distances: ties to the lowest slot, every position
    written once, pads (and a query with none valid) as (+inf, -1); at tk
    = S (seven and eight rounds), at S = 2^17 (selects mid-scan) and at tk
    = 40,000 (five rounds of 8,192)."""
    rng = np.random.default_rng(42)
    route = ops.fused_route(b, s, tk, 32, 256, 132)
    assert route.key == "adc_fused_topk[spill]"
    n_valid = int(s * valid_share)
    d = torch.from_numpy(rng.integers(0, 3000, s).astype(np.float32))
    valid = torch.zeros(s, dtype=torch.bool)
    valid[:n_valid] = True
    got_d, got_s = _spill_replay(d, valid, tk, route.plan)
    want_d, want_s = torch.sort(d.masked_fill(~valid, torch.inf), stable=True)
    want_s = torch.where(valid[want_s], want_s, -1)
    assert torch.equal(got_d, want_d[:tk])
    assert torch.equal(got_s, want_s[:tk])


def _spill_keys(d: np.ndarray, slot: np.ndarray) -> np.ndarray:
    """adc_fused_topk.cu's key_of: (dist, slot) as one ordered uint64,
    the float's bits made monotone (distances here are >= 0)."""
    u = d.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((u | np.uint64(0x80000000)) << np.uint64(32)) | slot.astype(
        np.uint64)


def _cluster_select(bufs, want, tau):
    """adc_fused_topk.cu's cluster_select replayed: 8-bit digits from the
    top over the CTAs' summed counts until the digits found select
    exactly ``want`` keys; each CTA keeps its keys at or below them, and
    tau drops to the least key above them.  Keeps all where the cluster
    holds no more than want."""
    if sum(len(x) for x in bufs) <= want:
        return bufs, tau
    prefix, need = 0, want
    for shift in range(56, -1, -8):
        hist = np.zeros(256, np.int64)
        for x in bufs:
            if shift < 56:
                x = x[((x ^ np.uint64(prefix)) >> np.uint64(shift + 8)) == 0]
            hist += np.bincount(((x >> np.uint64(shift)) & np.uint64(255))
                                .astype(np.int64), minlength=256)
        cum = np.cumsum(hist)
        digit = int(np.searchsorted(cum, need))
        prefix |= digit << shift
        need -= int(cum[digit] - hist[digit])
        if hist[digit] == need:
            break
    top = prefix >> shift
    if top < (2 ** 64 - 1) >> shift:
        tau = min(tau, (top + 1) << shift)
    return [x[(x >> np.uint64(shift)) <= np.uint64(top)] for x in bufs], tau


def _spill_replay(d, valid, tk, plan):
    """What the spill route writes for one query of distances ``d`` (S,)
    with ``valid`` (S,) slots, replayed in numpy on ``plan``: each CTA of
    the cluster appends its tile's valid keys above the round's lower
    bound and below tau (32-slot chunks dealt in turn, 32 chunks a tile),
    the cluster selects mid-scan every (cap - want) / 1,024 tiles where
    its slots pass the buffer and once after the scan; each CTA's kept
    keys, sorted, go to base + index + the count of keys below each in
    every other CTA's list; rounds repeat above the last round's largest
    key until tk are written or the keys run out."""
    s, c = d.shape[0], plan.cluster
    dn, vn = d.numpy(), valid.numpy()
    keys = _spill_keys(dn, np.arange(s))
    chunks, tiles = -(-s // 32), -(-(plan.slots // 32) // 32)
    out_d = torch.full((tk,), torch.inf)
    out_s = torch.full((tk,), -1, dtype=torch.int64)
    written = np.zeros(tk, np.int64)
    base, lower = 0, 0
    while True:
        want = min(plan.keep, tk - base)
        every = (plan.cap - want) // 1024 if plan.slots > plan.cap else tiles
        tau = 2 ** 64 - 1
        bufs = [np.zeros(0, np.uint64) for _ in range(c)]
        for j in range(tiles):
            for r in range(c):
                ch = np.arange(32 * j, 32 * j + 32)
                ch = ch[ch * c + r < chunks]
                p = ((ch * c + r)[:, None] * 32 + np.arange(32)).ravel()
                p = p[(p < s)]
                x = keys[p[vn[p]]]
                x = x[(x < np.uint64(tau)) & (x > np.uint64(lower))]
                bufs[r] = np.concatenate([bufs[r], x])
                assert len(bufs[r]) <= plan.cap
            if (j + 1) % every == 0 and j + 1 < tiles:
                bufs, tau = _cluster_select(bufs, want, tau)
        bufs, tau = _cluster_select(bufs, want, tau)
        lists = [np.sort(x) for x in bufs]
        total = sum(len(x) for x in lists)
        for r, x in enumerate(lists):
            # the sort's power of two and the inbox (the others' keys)
            size = max(32, 1 << (len(x) - 1).bit_length())
            assert size + total - len(x) <= plan.cap
            pos = base + np.arange(len(x))
            for q in range(c):
                if q != r:
                    pos = pos + np.searchsorted(lists[q], x)
            slot = (x & np.uint64(0xFFFFFFFF)).astype(np.int64)
            out_d[pos] = torch.from_numpy(dn[slot])
            out_s[pos] = torch.from_numpy(slot)
            written[pos] += 1
        base += total
        if total < want or base >= tk:
            break
        lower = max(int(x[-1]) for x in lists if len(x))
    assert (written[:min(base, tk)] == 1).all() and not written[base:].any()
    return out_d, out_s


@pytest.mark.parametrize("m,address,width", [
    (32, 0, 16), (32, 256, 16), (16, 48, 16), (32, 8, 8), (24, 0, 8),
    (25, 0, 1), (100, 0, 4), (32, 1, 1), (6, 2, 2), (8, 4, 4)])
def test_load_width(m, address, width):
    """The fused scan's code loads: the widest of 16, 8, 4, 2, 1 bytes
    that divides both M and the table's address (DEEP1B's M = 24 in 8
    bytes, SPACEV1B's M = 25 a byte at a time)."""
    assert ops.load_width(m, address) == width


def _fused_merge_replay(d, valid, tk, plan, ctas=None):
    """What adc_fused_topk writes for one query of distances ``d`` (S,)
    with ``valid`` (S,) slots, replayed in torch: each of the query's
    CTAs (its cluster, or ``ctas`` on the spill route; 32-slot chunks
    dealt in turn) keeps its best
    ``plan.keep`` valid keys by (dist, slot), sorted; a key's output
    position is its index in its list plus the count of keys below it in
    each other CTA's list; positions below tk are written, those from the
    query's key count to tk get (+inf, -1)."""
    s, c = d.shape[0], ctas or plan.cluster
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
