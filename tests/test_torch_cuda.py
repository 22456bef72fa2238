"""The CUDA kernels of ``repro_torch`` against their plain versions, on
the card.  Marked ``gpu``: without a CUDA device they skip (a CUDA kernel
has no CPU mode).  This file imports no JAX, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerances: the dense ADC scan bit for bit, other ADC distances to rtol
1e-5 (M f32 terms; in fact the kernels repeat the plain versions'
operations in order and agree to the bit), ids exactly; exact L2 rtol 1e-5 with atol 1e-3 (D products summed in
another order than cuBLAS's, on values of size D); flash attention 2e-5
in f32 (an online softmax against a plain one) and, in bf16, 5e-2 for
every element and 2^-6 for each (b, s, h) row's L2 error over the row's
L2 norm (the output's one rounding to bf16 may fall on either side; the
tensor-core kernel also rounds P to bf16 before the second product, at
most 2^-8 of a row's weight; an elementwise limit alone would miss a
wrong K/V tile in a long row, whose outputs are small).  TF32 is off for
the plain versions' products.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import launch
from repro_torch.kernels.flash_attn import flash_attention, flash_attn_ref
from repro_torch.kernels.l2dist import l2_distances, l2dist_ref
from repro_torch.kernels.pq_adc import ops, ref

RTOL = 1e-5
BF16_ROW_RTOL = 2.0 ** -6


def _codes(rng, n, m):
    return rng.integers(0, 256, (n, m)).astype(np.uint8)


def _rows(rng, b, s, n, all_pad_last=False):
    rows = np.full((b, s), -1, np.int32)
    for i in range(b - (1 if all_pad_last else 0)):
        c = int(rng.integers(0, min(s, n) + 1))
        rows[i, :c] = np.sort(rng.choice(n, c, replace=False))
    return rows


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_attn_close(got, want):
    """Flash attention against its plain version (tolerances above)."""
    g, w = got.float(), want.float()
    tol = 2e-5 if want.dtype == torch.float32 else 5e-2
    torch.testing.assert_close(g, w, rtol=tol, atol=tol)
    if want.dtype == torch.bfloat16:
        row = (g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
        assert float(row.max()) <= BF16_ROW_RTOL


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,m,k", [
    (64, 32_768, 32, 256),     # the dense window's shape on the main path
    (1, 1, 8, 256), (1, 1, 32, 256), (64, 777, 8, 256), (64, 777, 32, 256),
    (1, 777, 32, 256), (64, 9000, 8, 256), (64, 9000, 32, 256),
    (5, 300_001, 8, 256), (5, 300_001, 32, 256), (9, 300_001, 32, 256),
    (9, 5, 8, 256),
    (130, 3001, 32, 256),      # more tiles than one per block of a column
    (9, 5000, 3, 255),         # M*K*4 off 16 bytes: the 4-byte cp.async fill
])
def test_cuda_dense_kernel_matches_plain(cuda, b, n, m, k):
    """One wave, balanced query tiles, asynchronous LUT fill: the
    distances keep the plain version's adds in order, bit for bit."""
    rng = np.random.default_rng(26)
    codes = _t(rng.integers(0, k, (n, m)).astype(np.uint8)).to(cuda)
    luts = _t(rng.standard_normal((b, m, k)).astype(np.float32)).to(cuda)
    before = launch.LAUNCHES["adc_scan_batch"]
    got = ops.pq_adc_batch(codes, luts)
    torch.cuda.synchronize()
    assert launch.LAUNCHES["adc_scan_batch"] == before + 1
    assert torch.equal(got, ref.pq_adc_batch_ref(codes, luts))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 32])
@pytest.mark.parametrize("lut_int8", [False, True], ids=["f32", "int8"])
def test_cuda_fused_kernel_matches_plain(cuda, m, lut_int8):
    rng = np.random.default_rng(22)
    n, dsub = 40_000, 4
    codes = _t(np.repeat(_codes(rng, n // 4, m), 4, axis=0)).to(cuda)
    cb = _t(rng.standard_normal((m, 256, dsub)).astype(np.float32)).to(cuda)
    for b, s, topk in ((1, 3000, 10), (64, 5000, 512), (5, 37, 512)):
        q = _t(rng.standard_normal((b, m * dsub)).astype(np.float32)).to(cuda)
        rows = _t(_rows(rng, b, s, n, all_pad_last=b > 1)).to(cuda)
        kv, ki = ops.pq_adc_fused_topk(codes, q, cb, rows, topk,
                                       lut_int8=lut_int8)
        pv, pi = ops.pq_adc_fused_topk_plain(codes, q, cb, rows, topk,
                                             lut_int8=lut_int8)
        torch.cuda.synchronize()
        np.testing.assert_allclose(kv.cpu().numpy(), pv.cpu().numpy(),
                                   rtol=RTOL)
        np.testing.assert_array_equal(ki.cpu().numpy(), pi.cpu().numpy())


@pytest.mark.gpu
def test_cuda_wrappers_reject_bad_inputs(cuda):
    codes = torch.zeros(10, 8, dtype=torch.uint8, device=cuda)
    luts = torch.zeros(2, 8, 256, device=cuda)
    with pytest.raises(TypeError):
        ops.pq_adc_batch(codes, luts.double())
    with pytest.raises(ValueError):
        ops.pq_adc_batch(codes, luts[:, :4].contiguous())
    with pytest.raises(ValueError):
        ops.pq_adc_batch(codes, luts.transpose(0, 1))
    with pytest.raises(ValueError):
        ops.pq_adc_batch(codes, luts.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 32])
def test_cuda_single_query_kernels_match_plain(cuda, m):
    """pq_adc bit-equal to its plain version; pq_adc_topk ids equal to a
    stable argsort: ragged N, N < topk, a mostly-padding last block, and
    ties from repeated code rows."""
    rng = np.random.default_rng(23)
    for n, topk in ((1, 10), (5, 16), (777, 512), (2048 + 7, 32),
                    (300_001, 512), (50_000, 4000)):
        codes = _t(np.repeat(_codes(rng, -(-n // 3), m), 3, axis=0)[:n])
        codes = codes.to(cuda)
        lut = _t((rng.random((m, 256)) + 1.0).astype(np.float32)).to(cuda)
        d = ops.pq_adc(codes, lut)
        v, i = ops.pq_adc_topk(codes, lut, topk)
        pv, pi = ops.pq_adc_topk_plain(codes, lut, topk)
        torch.cuda.synchronize()
        assert torch.equal(d, ref.pq_adc_ref(codes, lut))
        assert torch.equal(v, pv) and torch.equal(i, pi)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_l2dist_matches_plain(cuda, dtype):
    rng = np.random.default_rng(24)
    for b, n, d in ((1, 1, 1), (3, 777, 100), (129, 1000, 128),
                    (256, 5003, 96)):
        q = _t(rng.standard_normal((b, d)).astype(np.float32))
        v = _t(rng.standard_normal((n, d)).astype(np.float32))
        q, v = q.to(cuda, dtype), v.to(cuda, dtype)
        got = l2_distances(q, v)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, l2dist_ref(q, v), rtol=RTOL,
                                   atol=1e-3)
    # integers: every partial sum is exact in f32, so the two agree exactly
    q = _t(rng.integers(0, 256, (37, 128)).astype(np.float32)).to(cuda)
    v = _t(rng.integers(0, 256, (3001, 128)).astype(np.float32)).to(cuda)
    if dtype == torch.float32:
        assert torch.equal(l2_distances(q, v), l2dist_ref(q, v))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_flash_attention_matches_plain(cuda, dtype):
    rng = np.random.default_rng(25)
    for B, S, T, H, Hk, dh, causal in (
            (2, 16, 16, 4, 2, 8, True), (1, 32, 32, 2, 2, 16, False),
            (2, 100, 100, 6, 3, 64, True), (1, 24, 24, 4, 1, 8, True),
            (1, 70, 130, 4, 2, 128, True), (1, 130, 70, 4, 4, 128, True),
            (1, 257, 257, 8, 2, 128, False)):
        q = _t(rng.standard_normal((B, S, H, dh)).astype(np.float32))
        k = _t(rng.standard_normal((B, T, Hk, dh)).astype(np.float32))
        v = _t(rng.standard_normal((B, T, Hk, dh)).astype(np.float32))
        q, k, v = (x.to(cuda, dtype) for x in (q, k, v))
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        _assert_attn_close(got, flash_attn_ref(q, k, v, causal=causal))


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_cuda_flash_wgmma_matches_plain(cuda, dh, causal):
    """The tensor-core kernel: S and T off the 128-row tiles, S != T both
    ways, MQA (Hk = 1), G = 2, B = 2."""
    rng = np.random.default_rng(27)
    for B, S, T, H, Hk in ((2, 200, 200, 4, 2), (1, 70, 300, 4, 1),
                           (1, 300, 70, 2, 1), (2, 1, 129, 2, 2),
                           (1, 513, 513, 8, 4)):
        q, k, v = (_t(rng.standard_normal(shape).astype(np.float32)).to(
            cuda, torch.bfloat16) for shape in (
                (B, S, H, dh), (B, T, Hk, dh), (B, T, Hk, dh)))
        before = dict(launch.LAUNCHES)
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert launch.LAUNCHES["flash_attn_fwd_wgmma"] == \
            before["flash_attn_fwd_wgmma"] + 1
        assert launch.LAUNCHES["flash_attn_fwd"] == before["flash_attn_fwd"]
        _assert_attn_close(got, flash_attn_ref(q, k, v, causal=causal))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,dh,offset,kernel", [
    (torch.bfloat16, 128, 0, "flash_attn_fwd_wgmma"),
    (torch.bfloat16, 64, 0, "flash_attn_fwd_wgmma"),
    (torch.bfloat16, 96, 0, "flash_attn_fwd"),
    (torch.bfloat16, 128, 1, "flash_attn_fwd_wgmma"),   # copied to align
    (torch.float32, 128, 0, "flash_attn_fwd"),
    (torch.float32, 64, 0, "flash_attn_fwd"),
])
def test_cuda_flash_dispatch_launches(cuda, dtype, dh, offset, kernel):
    """f32 and bf16 of another head width run on the CUDA-core kernel,
    bf16 at dh 64 or 128 on the tensor-core one, also from views that do
    not start on a 16-byte boundary; the launch count of the kernel that
    ran, and only it, goes up."""
    rng = np.random.default_rng(28)
    shapes = ((1, 100, 4, dh), (1, 100, 2, dh), (1, 100, 2, dh))
    qkv = []
    for shape in shapes:
        x = _t(rng.standard_normal(shape).astype(np.float32)).to(cuda, dtype)
        flat = torch.empty(x.numel() + offset, dtype=dtype, device=cuda)
        flat[offset:] = x.reshape(-1)
        qkv.append(flat[offset:].view(shape))
    before = dict(launch.LAUNCHES)
    got = flash_attention(*qkv, causal=True)
    torch.cuda.synchronize()
    grew = {name for name, c in launch.LAUNCHES.items() if c != before[name]}
    assert grew == {kernel}
    assert launch.LAUNCHES[kernel] == before[kernel] + 1
    _assert_attn_close(got, flash_attn_ref(*qkv, causal=True))


@pytest.mark.gpu
def test_cuda_new_wrappers_reject_bad_inputs(cuda):
    x = torch.zeros(1, 8, 4, 16, device=cuda)
    with pytest.raises(ValueError):
        flash_attention(x, x[:, :, :3].contiguous(), x[:, :, :3].contiguous())
    with pytest.raises(TypeError):
        flash_attention(x, x.half(), x.half())
    with pytest.raises(ValueError):
        l2_distances(x[0, 0], x[0, 0, :, :8].contiguous())
    with pytest.raises(TypeError):
        l2_distances(x[0, 0], x[0, 0].double())
    with pytest.raises(ValueError):
        ops.pq_adc(torch.zeros(4, 8, dtype=torch.uint8, device=cuda),
                   torch.zeros(4, 256, device=cuda))
