"""The CUDA kernels of ``repro_torch`` against their plain versions, on
the card.  Marked ``gpu``: without a CUDA device they skip (a CUDA kernel
has no CPU mode).  This file imports no JAX, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerances: the dense and fused ADC scans bit for bit, other ADC
distances to rtol 1e-5 (M f32 terms; in fact the kernels repeat the plain
versions' operations in order and agree to the bit), ids exactly; exact L2 rtol
1e-5 with atol 1e-3 (D products summed in another order than cuBLAS's, on
values of size D; the tensor-core kernel's 3xTF32 product also drops the
lo*lo term, about 2^-22 of each product; its bf16 products are exact in
f32) and bit for bit on integer data below 256 in f32 and bf16 (every
partial sum an integer below 2^24; below 128 where d > 132, since
960 * 127^2 < 2^24); flash attention 2e-5
in f32 (an online softmax against a plain one; the 3xTF32 kernel at dh 64
and 128 drops only the lo*lo terms) and, in bf16, 5e-2 for
every element and 2^-6 for each (b, s, h) row's L2 error over the row's
L2 norm (the output's one rounding to bf16 may fall on either side; the
tensor-core kernel also rounds P to bf16 before the second product, at
most 2^-8 of a row's weight; an elementwise limit alone would miss a
wrong K/V tile in a long row, whose outputs are small).  TF32 is off for
the plain versions' products.  Both wrappers take any real dtype, mixed
dtypes and views (the kernels compute in ``launch.operand_dtype``); each
such case against the plain version on the same inputs, integer L2 bit
for bit; f16 flash outputs to 2e-3 (each side rounds its f32 result to
f16 once).  The fused scan's spill route (a large tk over a long window)
is held bit for bit, as its one launch is; two posting-list builds from
one seed must agree bit for bit.  Index mutation on the card: a seal is
reproducible (two copies seal the same rows to the same tiers, one of
them with TF32 switched on by the caller), its codes are ``pq.encode`` of
the live rows on the card, the background compactor under concurrent
``submit()`` seals every row once and re-raises a planted seal error from
``stop()``, and a snapshot round trip onto the card answers with equal
ids and distances.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import clustering, pq
from repro_torch.kernels import launch
from repro_torch.kernels.flash_attn import (flash_attention, flash_attn_ref,
                                            flash_instance, flash_kernel)
from repro_torch.kernels.l2dist import (l2_distances, l2_instance,
                                        l2_kernel, l2dist_ref)
from repro_torch.kernels.launch import operand_dtype
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
    tol = {torch.float32: 2e-5, torch.float16: 2e-3}.get(want.dtype, 5e-2)
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


def _fused_case(rng, cuda, n, m, b, s, dsub=4):
    """Inputs of the fused scan: every code row four times (exact ties),
    ascending rows of random length per query, pads after them, the last
    query all pads; query 1's last three rows replaced by rows >= N (pads
    on the card).  Returns the kernel's rows and the plain version's
    (rows >= N as -1) with the queries and codebooks."""
    cb = _t(rng.standard_normal((m, 256, dsub)).astype(np.float32)).to(cuda)
    q = _t(rng.standard_normal((b, m * dsub)).astype(np.float32)).to(cuda)
    rows = _rows(rng, b, s, n, all_pad_last=b > 1)
    if b > 2:
        cnt = int((rows[1] >= 0).sum())
        if cnt >= 3:
            rows[1, cnt - 3:cnt] = n + np.array([0, 7, 100])
    plain_rows = np.where(rows >= n, -1, rows).astype(np.int32)
    return q, cb, _t(rows).to(cuda), _t(plain_rows).to(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 24, 25, 32])
@pytest.mark.parametrize("lut_int8", [False, True], ids=["f32", "int8"])
def test_cuda_fused_kernel_matches_plain(cuda, m, lut_int8):
    """The one-launch fused kernel against its plain version, values bit
    for bit and ids equal: M = 8, DEEP1B's 24 (8-byte code loads),
    SPACEV1B's 25 (a byte at a time), 32 (16-byte loads), and the codes
    at a 1-byte offset (byte loads at every M); B = 1 (a cluster of 8
    CTAs), B = 64 at S = 1,024 (four CTAs of one tile), 2,048 with topk
    above S, and 8,192 (four CTAs of two tiles that select), valid slots
    from none to all of S, so below and above tk; B = 5 at S = 37 (one
    CTA); rows >= N; an all-pad query; exact ties from repeated code
    rows."""
    rng = np.random.default_rng(22)
    n = 40_000
    codes = _t(np.repeat(_codes(rng, n // 4, m), 4, axis=0)).to(cuda)
    flat = torch.empty(n * m + 1, dtype=torch.uint8, device=cuda)
    flat[1:] = codes.reshape(-1)
    for b, s, topk in ((1, 3000, 10), (64, 1024, 512), (64, 2048, 3000),
                       (64, 8192, 512), (5, 37, 512)):
        q, cb, rows, plain_rows = _fused_case(rng, cuda, n, m, b, s)
        for cds in (codes, flat[1:].view(n, m)):
            kv, ki = ops.pq_adc_fused_topk(cds, q, cb, rows, topk,
                                           lut_int8=lut_int8)
            pv, pi = ops.pq_adc_fused_topk_plain(cds, q, cb, plain_rows,
                                                 topk, lut_int8=lut_int8)
            torch.cuda.synchronize()
            assert torch.equal(kv, pv), (b, s, topk)
            assert torch.equal(ki, pi), (b, s, topk)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,cluster", [
    (5, 37, 1),        # one CTA a query
    (64, 1024, 4),     # the serving window: a cluster of four
    (64, 8192, 4),     # CTAs of two tiles, each selecting before the merge
])
@pytest.mark.parametrize("lut_int8", [False, True], ids=["f32", "int8"])
def test_cuda_fused_topk_one_launch(cuda, monkeypatch, b, s, cluster,
                                    lut_int8):
    """pq_adc_fused_topk on the card is one launch of adc_fused_topk and
    nothing else: torch.sort and torch.gather raise while it runs, and the
    launch counts rise by one, for that kernel only, whether a query's
    CTAs are one or a cluster that merges in the launch."""
    rng = np.random.default_rng(34)
    n, m, topk = 40_000, 32, 512
    codes = _t(_codes(rng, n, m)).to(cuda)
    q, cb, rows, plain_rows = _fused_case(rng, cuda, n, m, b, s)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ops.fused_plan(b, s, min(topk, s), m, 256, sms).cluster == cluster

    def refuse(*a, **kw):
        raise AssertionError("the fused wrapper sorted or gathered")
    before = dict(launch.LAUNCHES)
    with monkeypatch.context() as mp:
        mp.setattr(torch, "sort", refuse)
        mp.setattr(torch, "gather", refuse)
        kv, ki = ops.pq_adc_fused_topk(codes, q, cb, rows, topk,
                                       lut_int8=lut_int8)
        torch.cuda.synchronize()
    grew = {k: c - before[k] for k, c in launch.LAUNCHES.items()
            if c != before[k]}
    assert grew == {"adc_fused_topk": 1}
    pv, pi = ops.pq_adc_fused_topk_plain(codes, q, cb, plain_rows, topk,
                                         lut_int8=lut_int8)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


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
@pytest.mark.parametrize("m", [8, 16, 32])
def test_cuda_single_query_kernels_match_plain(cuda, m):
    """pq_adc bit-equal to its plain version; pq_adc_topk values and ids
    equal to a stable argsort: ragged N, N < topk, a short last block,
    ties from repeated code rows, a topk that fills the candidate buffer
    (2,048 + one round of 2,048 rows = 4,096: every round that finds a
    candidate compacts), and rows in descending distance (every row
    beats the running threshold, so the buffer fills and compacts again
    and again); M = 8 (codes read a byte at a time), 16 and 32 (16-byte
    code chunks loaded ahead)."""
    rng = np.random.default_rng(23)
    for n, topk, descending in (
            (1, 10, False), (5, 16, False), (777, 512, False),
            (2048 + 7, 32, False), (300_001, 512, False),
            (50_000, 4000, False), (2_000_001, 2048, False),
            (2_000_001, 512, True)):
        codes = _t(np.repeat(_codes(rng, -(-n // 3), m), 3, axis=0)[:n])
        lut = _t((rng.random((m, 256)) + 1.0).astype(np.float32))
        if descending:
            order = torch.sort(ref.pq_adc_ref(codes, lut), descending=True,
                               stable=True)[1]
            codes = codes[order]
        codes, lut = codes.to(cuda), lut.to(cuda)
        d = ops.pq_adc(codes, lut)
        v, i = ops.pq_adc_topk(codes, lut, topk)
        pv, pi = ops.pq_adc_topk_plain(codes, lut, topk)
        torch.cuda.synchronize()
        assert torch.equal(d, ref.pq_adc_ref(codes, lut))
        assert torch.equal(v, pv) and torch.equal(i, pi)


def _l2_launched(q, v):
    """l2_distances(q, v) and the one kernel it launched, which must be
    the one l2_kernel names, counted under l2_instance's key."""
    before = dict(launch.LAUNCHES)
    got = l2_distances(q, v)
    torch.cuda.synchronize()
    grew = {name for name, c in launch.LAUNCHES.items() if c != before[name]}
    assert grew == {l2_instance(operand_dtype(q.dtype, v.dtype),
                                q.shape[1])}
    return got


def _aligned_or_not(x, offset):
    """x itself, or a copy of it that starts ``offset`` elements into a
    fresh buffer (off a 16-byte boundary for offset % 4 != 0)."""
    if not offset:
        return x
    flat = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    flat[offset:] = x.reshape(-1)
    return flat[offset:].view(x.shape)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_l2dist_matches_plain(cuda, dtype):
    """The kernel of l2_kernel's rule at every width (132 and 960 with the
    query tile streamed; bf16 at d 1 copied with a zero column), with
    ragged B and N, edge tiles and a k tail; integer data bit for bit."""
    rng = np.random.default_rng(24)
    ran = set()
    for b, n, d in ((1, 1, 1), (3, 777, 100), (129, 1000, 128),
                    (256, 5003, 96), (3, 777, 102), (129, 1000, 132),
                    (5, 5003, 960)):
        q = _t(rng.standard_normal((b, d)).astype(np.float32))
        v = _t(rng.standard_normal((n, d)).astype(np.float32))
        q, v = q.to(cuda, dtype), v.to(cuda, dtype)
        got = _l2_launched(q, v)
        ran.add(l2_kernel(dtype, d))
        torch.testing.assert_close(got, l2dist_ref(q, v), rtol=RTOL,
                                   atol=1e-3)
    # odd bf16 widths (d 1) too, zero-padded to a multiple of 8
    assert ran == {"l2dist_wgmma"}
    # integers below 256 (exact in bf16 too): every partial sum is exact in
    # f32, so the two agree exactly (at d 132 still below 2^24: 132 * 255^2)
    for d in (128, 132):
        q = _t(rng.integers(0, 256, (37, d)).astype(np.float32))
        v = _t(rng.integers(0, 256, (3001, d)).astype(np.float32))
        q, v = q.to(cuda, dtype), v.to(cuda, dtype)
        assert torch.equal(_l2_launched(q, v), l2dist_ref(q, v))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 3, 129, 256])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("dtype,n,d", [
    *((torch.float32, n, d) for n, d in ((777, 4), (5003, 96), (777, 100),
                                         (5003, 128), (777, 1), (5003, 6),
                                         (777, 102))),
    *((torch.bfloat16, n, d) for n, d in (
        (777, 4), (5003, 96), (777, 100), (5003, 128), (777, 2), (5003, 6),
        (777, 36), (5003, 102), (777, 126), (777, 8), (5003, 104))),
], ids=lambda x: {torch.float32: "f32", torch.bfloat16: "bf16"}.get(x, x))
def test_cuda_l2dist_wgmma_matches_plain(cuda, b, n, d, offset, dtype):
    """The tensor-core kernel in both instantiations: ragged B and N, d
    off the 128-byte k-slice, views that do not start on a 16-byte
    boundary (copied first); normal values to the L2 tolerance, integers
    bit for bit.  f32 loads by TMA where d % 4 == 0, by 4-byte cp.async
    copies at d 1, 6 and 102; bf16 by cp.async in 16-byte granules
    where rows lie on the 16-byte stride (d 8, 96, 104, 128), else in
    8-byte (d % 4 == 0) or 4-byte ones (2, 4, 6, 36, 100, 102, 126); the
    columns past d (up to the 64-column k-slice) and the rows past B and N
    read as zeros, a k tail in one slice (2, 4, 6, 8, 36) or in the second
    (100, 102, 104, 126)."""
    rng = np.random.default_rng(29)
    assert l2_kernel(dtype, d) == "l2dist_wgmma"
    if dtype == torch.bfloat16:
        assert l2_instance(dtype, d) == ("l2dist_wgmma[bf16]" if d % 8 == 0
                                         else "l2dist_wgmma[bf16,off16]")

    def make(shape, ints):
        x = rng.integers(0, 256, shape) if ints else rng.standard_normal(shape)
        x = _t(x.astype(np.float32)).to(cuda, dtype)
        return _aligned_or_not(x, offset)

    for ints in (False, True):
        q, v = make((b, d), ints), make((n, d), ints)
        got = _l2_launched(q, v)
        want = l2dist_ref(q, v)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=1e-3)
        if ints:
            assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 129, 256])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("dtype,n,d", [
    *((torch.float32, n, d) for n, d in (
        (777, 129), (5003, 131), (777, 132), (5003, 200), (777, 256),
        (5003, 384), (777, 960))),
    *((torch.bfloat16, n, d) for n, d in (
        (5003, 130), (777, 132), (5003, 200), (777, 256), (5003, 384),
        (777, 960))),
], ids=lambda x: {torch.float32: "f32", torch.bfloat16: "bf16"}.get(x, x))
def test_cuda_l2dist_wgmma_streamed_matches_plain(cuda, b, n, d, offset,
                                                  dtype):
    """The tensor-core kernel above d = 128, where the query tile's
    k-slices ride the ring beside the vectors': ragged B and N, views off
    a 16-byte boundary (copied first), a k tail in the last slice (129,
    130, 131, 132, 200, 384) or none (256, 960); f32 by TMA where
    d % 4 == 0, by 4-byte cp.async copies at 129 and 131; bf16 by
    cp.async granules of 16 bytes (d % 8 == 0) or 4 (130); normal values
    to the L2 tolerance, integers in [0, 128) bit for bit (960 * 127^2 <
    2^24, so every partial sum is exact)."""
    rng = np.random.default_rng(35)
    assert l2_kernel(dtype, d) == "l2dist_wgmma"
    assert l2_instance(dtype, d) == ("l2dist_wgmma[bf16,d>128]"
                                     if dtype == torch.bfloat16
                                     else "l2dist_wgmma[d>128]")

    def make(shape, ints):
        x = rng.integers(0, 128, shape) if ints else rng.standard_normal(
            shape)
        x = _t(x.astype(np.float32)).to(cuda, dtype)
        return _aligned_or_not(x, offset)

    for ints in (False, True):
        q, v = make((b, d), ints), make((n, d), ints)
        got = _l2_launched(q, v)
        want = l2dist_ref(q, v)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=1e-3)
        if ints:
            assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 132, 256])
@pytest.mark.parametrize("int_side", ["queries", "vectors"])
def test_cuda_l2dist_wgmma_cross_terms(cuda, int_side, d):
    """One operand small integers (its lo part is 0), the other normal,
    so every distance is about 5 d and its limit about 1e-3 + 5e-5 d: a
    dropped or doubled hi*lo or lo*hi product moves each distance by
    2 * sum(int * lo), about 0.006 RMS at d = 128 (limit 0.0074) and
    0.008 at 256 (limit 0.014), and the largest of the 387k by several
    times the limit; d = 128 keeps the query tile resident, 132 and 256
    stream it (the q split of every landed slice)."""
    rng = np.random.default_rng(30)
    b, n = 129, 3001
    ints = rng.integers(-3, 4, (b if int_side == "queries" else n, d))
    normal = rng.standard_normal((n if int_side == "queries" else b, d))
    q, v = ((ints, normal) if int_side == "queries" else (normal, ints))
    q, v = (_t(x.astype(np.float32)).to(cuda) for x in (q, v))
    torch.testing.assert_close(_l2_launched(q, v), l2dist_ref(q, v),
                               rtol=RTOL, atol=1e-3)


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
        grew = {name: c - before[name]
                for name, c in launch.LAUNCHES.items() if c != before[name]}
        assert grew == {"flash_attn_fwd_wgmma": 1}
        _assert_attn_close(got, flash_attn_ref(q, k, v, causal=causal))


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_cuda_flash_tf32_matches_plain(cuda, dh, causal):
    """The 3xTF32 tensor-core kernel (f32) on the shapes of the bf16 one:
    S and T off the 64-row q tiles and 32-key KV tiles, S != T both ways,
    MQA (Hk = 1), G = 2, B = 2, a single query row, an odd number of KV
    tiles (the two warpgroups take unequal shares); f32's 2e-5."""
    rng = np.random.default_rng(32)
    for B, S, T, H, Hk in ((2, 200, 200, 4, 2), (1, 70, 300, 4, 1),
                           (1, 300, 70, 2, 1), (2, 1, 129, 2, 2),
                           (1, 513, 513, 8, 4), (1, 33, 33, 2, 2)):
        q, k, v = (_t(rng.standard_normal(shape).astype(np.float32)).to(
            cuda) for shape in ((B, S, H, dh), (B, T, Hk, dh),
                                (B, T, Hk, dh)))
        before = dict(launch.LAUNCHES)
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        grew = {name: c - before[name]
                for name, c in launch.LAUNCHES.items() if c != before[name]}
        assert grew == {"flash_attn_fwd_tf32": 1}
        _assert_attn_close(got, flash_attn_ref(q, k, v, causal=causal))


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [64, 96, 128, 192, 256])
@pytest.mark.parametrize("side", ["scores", "values"])
def test_cuda_flash_tf32_lo_terms(cuda, dh, side):
    """Inputs on which every lo term of the 3xTF32 kernel moves the
    output past f32's 2e-5: a TF32 hi part keeps 11 bits, so each lo part
    is about 1.4e-4 of its value.  "scores": q and k twice as large, so a
    score moves by ~8e-4 (base 2) when Q hi * K lo or Q lo * K hi is
    dropped, a weight by ~5.6e-4 of itself; "values": v eight times as
    large, so a dropped P hi * V lo or P lo * V hi moves the output by
    ~1e-3 or ~5e-4 against a limit of ~1.8e-4.  Causal, so the first rows
    of each head, over a few keys, carry the whole error.  dh = 96 runs on
    the 128 instance, its last box never loaded; 192 and 256 on the 256
    instance, the two warpgroups each taking half the head width."""
    rng = np.random.default_rng(33)
    B, S, H, Hk = 2, 80, 4, 2
    gain = dict(scores=(2.0, 2.0, 1.0), values=(1.0, 1.0, 8.0))[side]
    q, k, v = (_t((g * rng.standard_normal(shape)).astype(np.float32)).to(
        cuda) for g, shape in zip(gain, ((B, S, H, dh), (B, S, Hk, dh),
                                         (B, S, Hk, dh))))
    before = dict(launch.LAUNCHES)
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    key = flash_instance(torch.float32, dh)
    assert launch.LAUNCHES[key] == before[key] + 1
    _assert_attn_close(got, flash_attn_ref(q, k, v, causal=True))


def _flash_case(rng, cuda, dtype, shape, dh, causal):
    """One flash call on the card against its plain version: the one
    launch it made must be the one flash_instance names."""
    B, S, T, H, Hk = shape
    q, k, v = (_t(rng.standard_normal(sh).astype(np.float32)).to(
        cuda, dtype) for sh in ((B, S, H, dh), (B, T, Hk, dh),
                                (B, T, Hk, dh)))
    before = dict(launch.LAUNCHES)
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    grew = {name: c - before[name] for name, c in launch.LAUNCHES.items()
            if c != before[name]}
    assert grew == {flash_instance(dtype, dh): 1}
    assert got.dtype == dtype and got.shape == q.shape
    _assert_attn_close(got, flash_attn_ref(q, k, v, causal=causal))


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [8, 16, 32, 48, 80, 96, 112])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_flash_padded_heads_match_plain(cuda, dtype, dh, causal):
    """The tensor-core kernels at head widths other than 64 and 128: the
    64 instance up to dh = 64, the 128 one above, the tensor maps' inner
    extent the true dh (TMA fills the columns past it with zeros; at f32
    dh <= 32 and 68..96 a box lies wholly past dh and is never loaded),
    stores masked to dh, scale 1/sqrt(dh); S and T off the tiles, S != T
    both ways, MQA (Hk = 1), G = 2; f32's 2e-5 and the bf16 limits."""
    rng = np.random.default_rng(36)
    assert flash_instance(dtype, dh) == f"{flash_kernel(dtype, dh)}[padded]"
    for shape in ((2, 200, 200, 4, 2), (1, 70, 300, 4, 1),
                  (1, 300, 70, 2, 1), (1, 33, 33, 2, 2)):
        _flash_case(rng, cuda, dtype, shape, dh, causal)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,dh", [
    (torch.float32, 6), (torch.float32, 132), (torch.float32, 192),
    (torch.float32, 256), (torch.bfloat16, 6), (torch.bfloat16, 36),
    (torch.bfloat16, 132), (torch.bfloat16, 192), (torch.bfloat16, 256),
], ids=lambda x: {torch.float32: "f32", torch.bfloat16: "bf16"}.get(x, x))
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_cuda_flash_cuda_cores_match_plain(cuda, dtype, dh, causal):
    """The head widths the retired CUDA-core kernel took, now on the
    tensor cores: rows off 16 bytes (6; bf16 36), copied with zero columns
    to the stride ([stride-pad]), and above 128 (132, DeepSeek-V2's 192,
    256) on the 256 instances ([256]); S and T off the tiles, S != T both
    ways, MQA, G = 2."""
    rng = np.random.default_rng(37)
    step = 8 if dtype == torch.bfloat16 else 4
    assert flash_instance(dtype, dh) == flash_kernel(dtype, dh) + (
        "[stride-pad]" if dh % step else "[256]")
    for shape in ((2, 100, 100, 4, 2), (1, 70, 130, 4, 1),
                  (1, 130, 70, 2, 1)):
        _flash_case(rng, cuda, dtype, shape, dh, causal)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_flash_dh192_no_longer_raises(cuda, dtype):
    """dh = 192 (DeepSeek-V2's qk width) raised on the card when the
    CUDA-core kernel stopped at 128, while the JAX package and the CPU
    path computed it; it now runs on the tensor cores' 256 instance
    (counted as [256]), and dh = 257 raises, naming the limit."""
    rng = np.random.default_rng(38)
    assert flash_instance(dtype, 192) == f"{flash_kernel(dtype, 192)}[256]"
    _flash_case(rng, cuda, dtype, (1, 64, 64, 2, 1), 192, True)
    x = torch.zeros(1, 8, 2, 257, device=cuda, dtype=dtype)
    with pytest.raises(ValueError, match="256"):
        flash_attention(x, x, x)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,dh,offset,kernel", [
    (torch.bfloat16, 128, 0, "flash_attn_fwd_wgmma"),
    (torch.bfloat16, 64, 0, "flash_attn_fwd_wgmma"),
    (torch.bfloat16, 96, 0, "flash_attn_fwd_wgmma[padded]"),
    (torch.bfloat16, 36, 0, "flash_attn_fwd_wgmma[stride-pad]"),
    (torch.bfloat16, 128, 1, "flash_attn_fwd_wgmma"),   # copied to align
    (torch.bfloat16, 96, 1, "flash_attn_fwd_wgmma[padded]"),
    (torch.float32, 128, 0, "flash_attn_fwd_tf32"),
    (torch.float32, 64, 0, "flash_attn_fwd_tf32"),
    (torch.float32, 96, 0, "flash_attn_fwd_tf32[padded]"),
    (torch.float32, 6, 0, "flash_attn_fwd_tf32[stride-pad]"),
    (torch.bfloat16, 192, 1, "flash_attn_fwd_wgmma[256]"),
    (torch.float32, 256, 1, "flash_attn_fwd_tf32[256]"),
    (torch.float32, 128, 1, "flash_attn_fwd_tf32"),     # copied to align
    (torch.float32, 96, 1, "flash_attn_fwd_tf32[padded]"),
])
def test_cuda_flash_dispatch_launches(cuda, dtype, dh, offset, kernel):
    """Every head width up to 256 runs on the tensor-core kernels (bf16 on
    flash_attn_fwd_wgmma, f32 in 3xTF32 on flash_attn_fwd_tf32; other than
    64 and 128 counted as [padded], above 128 as [256], off the 16-byte
    row stride as [stride-pad]), also from views that do not start on a
    16-byte boundary; the launch count of the kernel that ran, and only
    it, goes up."""
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
    """Shapes that do not fit, tensors on another device and complex
    dtypes raise; f16 and f64 operands, which raised before the wrappers
    took any real dtype, now give the plain version's result."""
    x = torch.randn(1, 8, 4, 16, device=cuda)
    with pytest.raises(ValueError):
        flash_attention(x, x[:, :, :3].contiguous(), x[:, :, :3].contiguous())
    with pytest.raises(ValueError):
        flash_attention(x, x.cpu(), x.cpu())
    with pytest.raises(TypeError):
        flash_attention(x, x.to(torch.complex64), x)
    _assert_attn_close(flash_attention(x, x.half(), x.half()),
                       flash_attn_ref(x, x.half(), x.half()))
    with pytest.raises(ValueError):
        l2_distances(x[0, 0], x[0, 0, :, :8].contiguous())
    with pytest.raises(ValueError):
        l2_distances(x[0, 0], x[0, 0].cpu())
    torch.testing.assert_close(l2_distances(x[0, 0], x[0, 0].double()),
                               l2dist_ref(x[0, 0], x[0, 0].double()),
                               rtol=RTOL, atol=1e-3)
    with pytest.raises(ValueError):
        ops.pq_adc(torch.zeros(4, 8, dtype=torch.uint8, device=cuda),
                   torch.zeros(4, 256, device=cuda))


@pytest.mark.gpu
def test_cuda_pq_training_is_reproducible(cuda):
    """Two trainings from one seed give the same codebook bit for bit.
    With 2 centroids a sub-space each holds about 200k integer rows, so
    its sums pass 2^24, where f32 sums from the card's unordered
    index_add_ would round differently from run to run."""
    rng = np.random.default_rng(31)
    data = _t(rng.integers(0, 256, (400_000, 8)).astype(np.uint8)).to(cuda)
    cbs = [pq.train_codebooks(torch.Generator().manual_seed(0), data, 2, 1,
                              device=cuda).codebooks for _ in range(2)]
    assert torch.equal(*cbs)


# ------------------------------------------------- the fused spill route
@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 8, 64])
@pytest.mark.parametrize("s,tk", [(1 << 15, 3072), (1 << 15, 4096),
                                  (1 << 16, 3072), (1 << 16, 4096)])
@pytest.mark.parametrize("lut_int8", [False, True], ids=["f32", "int8"])
def test_cuda_fused_spill_route_matches_plain(cuda, b, s, tk, lut_int8):
    """A top_n of 3,072 or 4,096 over lists past 16,384 rows, on the route
    fused_route names: the spill route (the kernel and its merge kernel,
    one count under adc_fused_topk[spill]) wherever fused_plan's one
    launch refuses, which is every case but B = 64 at tk = 3,072 (one
    launch, a cluster of up to eight CTAs); values and ids bit-equal to
    the plain version, with rows >= N, an all-pad query, exact ties from
    repeated code rows and valid slots from none to S."""
    rng = np.random.default_rng(43)
    n, m = 200_000, 32
    codes = _t(np.repeat(_codes(rng, n // 4, m), 4, axis=0)).to(cuda)
    q, cb, rows, plain_rows = _fused_case(rng, cuda, n, m, b, s)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    key = ops.fused_route(b, s, tk, m, 256, sms).key
    assert (key == "adc_fused_topk") == (b == 64 and tk == 3072)
    before = dict(launch.LAUNCHES)
    kv, ki = ops.pq_adc_fused_topk(codes, q, cb, rows, tk, lut_int8=lut_int8)
    torch.cuda.synchronize()
    grew = {k: c - before[k] for k, c in launch.LAUNCHES.items()
            if c != before[k]}
    assert grew == {key: 1}
    pv, pi = ops.pq_adc_fused_topk_plain(codes, q, cb, plain_rows, tk,
                                         lut_int8=lut_int8)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1 << 15, 1 << 16])
@pytest.mark.parametrize("lut_int8", [False, True], ids=["f32", "int8"])
def test_cuda_fused_spill_route_tk_equals_s(cuda, s, lut_int8):
    """tk = S for one query: every CTA keeps all its slots (4,096) and the
    merge places all S of them, valid rows first, pads as (+inf, -1)."""
    rng = np.random.default_rng(44)
    n, m = 100_000, 32
    codes = _t(np.repeat(_codes(rng, n // 4, m), 4, axis=0)).to(cuda)
    cb = _t(rng.standard_normal((m, 256, 4)).astype(np.float32)).to(cuda)
    q = _t(rng.standard_normal((1, m * 4)).astype(np.float32)).to(cuda)
    rows = np.full((1, s), -1, np.int32)
    c = s - 777
    rows[0, :c] = np.sort(rng.choice(n, c, replace=False))
    rows = _t(rows).to(cuda)
    kv, ki = ops.pq_adc_fused_topk(codes, q, cb, rows, s, lut_int8=lut_int8)
    pv, pi = ops.pq_adc_fused_topk_plain(codes, q, cb, rows, s,
                                         lut_int8=lut_int8)
    torch.cuda.synchronize()
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


@pytest.mark.gpu
def test_cuda_fused_query_plan_top_n_4096(cuda):
    """QueryPlan(fused=True, top_n=4096) served on the card over lists past
    16,384 rows: the spill route launched, and the fused ids equal the
    dense window's for every query (the port's contract)."""
    import dataclasses
    from repro_torch.configs.anns_datasets import SIFT_SMALL
    from repro_torch.core.engine import FusionANNSIndex
    from repro_torch.data.synthetic import clustered_vectors
    n, dim = 34_000, 16
    cfg = dataclasses.replace(SIFT_SMALL, n_vectors=n, dim=dim, pq_m=4,
                              n_posting_fraction=4 / n, top_m=2, top_n=4096)
    rows = clustered_vectors(np.random.default_rng(5), n + 8, dim,
                             n_clusters=4)
    index = FusionANNSIndex.build(rows[:n], cfg, device=cuda)
    queries = rows[n:]
    assert max(len(index.view().collect_candidates(x, cfg.top_m)[0])
               for x in queries) > 16_384
    before = dict(launch.LAUNCHES)
    fused = index.submit(queries, fused=True).results()
    torch.cuda.synchronize()
    assert launch.LAUNCHES["adc_fused_topk[spill]"] > \
        before["adc_fused_topk[spill]"]
    dense = index.submit(queries).results()
    np.testing.assert_array_equal(np.stack([r.ids for r in fused]),
                                  np.stack([r.ids for r in dense]))


# ------------------------------------------ any dtype, views (L2, flash)
def _values(rng, dtype, shape):
    if dtype == torch.uint8:
        return _t(rng.integers(0, 256, shape).astype(np.uint8))
    if dtype == torch.int8:
        return _t(rng.integers(-128, 128, shape).astype(np.int8))
    return _t(rng.standard_normal(shape).astype(np.float32)).to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("q_dtype,v_dtype,d", [
    (torch.uint8, torch.uint8, 128),      # SIFT1B: bf16, exactly
    (torch.int8, torch.int8, 100),        # SPACEV1B
    (torch.uint8, torch.uint8, 101),      # odd: zero-padded to 104
    (torch.uint8, torch.uint8, 960),      # streamed, integers below 128
    (torch.float16, torch.float16, 96),   # f32
    (torch.float64, torch.float32, 132),
    (torch.uint8, torch.float32, 64),     # mixed: f32
    (torch.int8, torch.bfloat16, 36),     # mixed, both exact in bf16
    (torch.int32, torch.int16, 20),       # f32, integers exact
], ids=str)
def test_cuda_l2_any_dtype_matches_plain(cuda, q_dtype, v_dtype, d):
    """l2_distances on the card over any real dtypes, as the JAX wrapper
    takes them: the kernel launched is the one l2_instance names for the
    operand dtype; integers bit for bit (at d = 960 below 128, so every
    sum stays below 2^24), floats to the L2 tolerance."""
    rng = np.random.default_rng(45)
    q, v = _values(rng, q_dtype, (37, d)), _values(rng, v_dtype, (3001, d))
    if d == 960:                  # below 128: every sum below 2^24
        q, v = q // 2, v // 2
    q, v = q.to(cuda), v.to(cuda)
    got = _l2_launched(q, v)
    want = l2dist_ref(q, v)
    if not (q.dtype.is_floating_point or v.dtype.is_floating_point):
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.uint8], ids=str)
def test_cuda_l2_strided_views_match_plain(cuda, dtype):
    """A transposed query block and a column-sliced vector table (views,
    not contiguous) are copied before the loads and give the plain
    version's distances (integers bit for bit)."""
    rng = np.random.default_rng(46)
    q, v = (_values(rng, dtype, shape).to(cuda)
            for shape in ((64, 40), (2000, 80)))
    if dtype != torch.uint8:                  # integers: exact sums
        q, v = q.round(), v.round()
    q, v = q.T, v[:, 8:72]                    # (40, 64), (2000, 64)
    assert not (q.is_contiguous() or v.is_contiguous())
    assert torch.equal(_l2_launched(q, v), l2dist_ref(q, v))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [3, 101, 257])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.uint8], ids=str)
def test_cuda_l2_odd_bf16_widths_bit_equal(cuda, d, dtype):
    """Odd widths computed in bf16 (bf16 and uint8 inputs) run on the
    tensor-core kernel, zero-padded to a multiple of 8 by a kernel of the
    same launch (l2dist_wgmma[bf16,odd]; 257 with the query tile
    streamed): on integers below 256 bit-equal to the plain version, as
    zero columns add nothing to any sum."""
    rng = np.random.default_rng(47)
    q, v = (_t(rng.integers(0, 256, shape).astype(np.float32)).to(
        cuda, dtype) for shape in ((130, d), (5003, d)))
    assert l2_instance(operand_dtype(dtype), d) == "l2dist_wgmma[bf16,odd]"
    assert torch.equal(_l2_launched(q, v), l2dist_ref(q, v))


@pytest.mark.gpu
@pytest.mark.parametrize("dtypes", [
    (torch.float16,) * 3, (torch.float16, torch.float32, torch.bfloat16),
    (torch.float32, torch.uint8, torch.int8),
    (torch.bfloat16, torch.int8, torch.uint8), (torch.float64,) * 3,
], ids=str)
@pytest.mark.parametrize("dh", [64, 100])
def test_cuda_flash_any_dtype_matches_plain(cuda, dtypes, dh):
    """flash_attention on the card over any real dtypes, mixed, as the JAX
    wrapper takes them: the launch is the one flash_instance names for
    the operand dtype, the output in q's dtype, within q's tolerance of
    the plain version (integers kept small, so scores stay in range)."""
    rng = np.random.default_rng(48)
    shapes = ((2, 70, 4, dh), (2, 90, 2, dh), (2, 90, 2, dh))
    q, k, v = (_values(rng, dt, sh) for dt, sh in zip(dtypes, shapes))
    q, k, v = (x // 16 if not x.dtype.is_floating_point else x
               for x in (q, k, v))
    q, k, v = (x.to(cuda) for x in (q, k, v))
    before = dict(launch.LAUNCHES)
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    grew = {name for name, c in launch.LAUNCHES.items() if c != before[name]}
    assert grew == {flash_instance(operand_dtype(*dtypes), dh)}
    assert got.dtype == dtypes[0] and got.shape == q.shape
    want = flash_attn_ref(q, k, v, causal=True)
    if dtypes[0] == torch.float64:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        _assert_attn_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_cuda_flash_strided_views_match_plain(cuda, dtype):
    """q, k and v sliced out of one wider tensor (views, not contiguous)
    are copied before the loads and give the plain version's output."""
    rng = np.random.default_rng(49)
    x = _values(rng, dtype, (1, 130, 7, 64)).to(cuda)
    q, k, v = x[:, :, :4], x[:, :, 4:6], x[:, :, 5:7]
    assert not q.is_contiguous()
    _assert_attn_close(flash_attention(q, k, v, causal=True),
                       flash_attn_ref(q, k, v, causal=True))


# ------------------------------- flash above 128 and off the row stride
@pytest.mark.gpu
@pytest.mark.parametrize("dtype,dh", [
    (torch.bfloat16, 129), (torch.bfloat16, 192), (torch.bfloat16, 256),
    (torch.bfloat16, 100), (torch.bfloat16, 250),
    (torch.float32, 129), (torch.float32, 192), (torch.float32, 256),
    (torch.float32, 66), (torch.float32, 200),
], ids=str)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_cuda_flash_wide_and_off_stride_match_plain(cuda, dtype, dh, causal):
    """The 256 instances (bf16: 64-key tiles, O += P V as m64n256k16; f32:
    the head width split between the two warpgroups, 16-key tiles) and
    the widths off the 16-byte stride (zero-padded copies, the scale of
    the true dh, the output cut back to dh): S and T off the tiles, S !=
    T both ways, MQA (Hk = 1), G = 2, a single query row; held to
    chip_smoke.check_attn's limits."""
    rng = np.random.default_rng(50)
    for shape in ((2, 200, 200, 4, 2), (1, 70, 300, 4, 1),
                  (1, 300, 70, 2, 1), (1, 1, 33, 2, 2), (1, 129, 129, 2, 1)):
        _flash_case(rng, cuda, dtype, shape, dh, causal)


# ------------------------------------------------ posting-list builds
@pytest.mark.gpu
def test_cuda_posting_lists_are_reproducible(cuda):
    """Two builds of the posting lists from one seed on float32 data (as
    DEEP1B's) give the same centroids bit for bit and the same members.
    Eight clusters of 60,000 rows hold about 7,500 rows each, so the
    polish step's per-centroid sums add thousands of f32 rows, where an
    unordered sum on the card would round differently from run to run."""
    data = np.random.default_rng(51).standard_normal(
        (60_000, 32)).astype(np.float32)
    builds = [clustering.build_posting_lists(np.random.default_rng(0), data,
                                             8, device=cuda)
              for _ in range(2)]
    assert max(len(m) for m in builds[0].members) > 2000
    np.testing.assert_array_equal(builds[0].centroids, builds[1].centroids)
    for a, b in zip(builds[0].members, builds[1].members):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ index mutation
@pytest.fixture
def small_index(cuda):
    """A small index built on the card, rows to insert, and queries."""
    from repro_torch.configs.anns_datasets import SIFT_SMALL
    from repro_torch.core.engine import FusionANNSIndex
    from repro_torch.data.synthetic import clustered_vectors
    rng = np.random.default_rng(61)
    n = 8192
    data = clustered_vectors(rng, n + 2048 + 64, 32, n_clusters=32)
    cfg = dataclasses.replace(SIFT_SMALL, n_vectors=n, dim=32)
    index = FusionANNSIndex.build(data[:n], cfg, device=cuda)
    return index, data[n:n + 2048], data[n + 2048:]


def _same_answers(a, b, queries):
    for plan in ({}, {"fused": True}, {"fused": True, "lut_int8": True}):
        for ra, rb in zip(a.submit(queries, window=16, **plan).results(),
                          b.submit(queries, window=16, **plan).results(),
                          strict=True):
            np.testing.assert_array_equal(ra.ids, rb.ids)
            np.testing.assert_array_equal(ra.dists, rb.dists)


def _same_sealed_tiers(a, b):
    av, bv = a.view(), b.view()
    assert torch.equal(av.codes, bv.codes)
    for x, y in zip(av.posting.members, bv.posting.members, strict=True):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(av.posting.primary, bv.posting.primary)
    np.testing.assert_array_equal(av.id_of, bv.id_of)
    np.testing.assert_array_equal(av.tombstones, bv.tombstones)


@pytest.mark.gpu
def test_cuda_seal_is_reproducible_and_encodes_as_pq(small_index):
    index, rows, queries = small_index
    twin = copy.deepcopy(index)
    n_rows = index.view().n_rows
    for ix in (index, twin):
        ids = ix.insert(rows)
        ix.delete(ids[::7])
    index.compact()
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True    # the caller's choice
    try:
        twin.compact()
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    _same_sealed_tiers(index, twin)
    live = np.delete(rows, np.arange(0, len(rows), 7), axis=0)
    assert index.codes.is_cuda
    assert torch.equal(index.codes[n_rows:],
                       pq.encode(index.codebook, torch.from_numpy(
                           live).to(index.device)))
    _same_answers(index, twin, queries)


@pytest.mark.gpu
def test_cuda_compactor_under_submit_seals_every_row(small_index):
    index, rows, queries = small_index
    once = copy.deepcopy(index)
    index.start_compactor(min_delta=256, poll_s=0.001)
    tickets, ids = [], []
    for s in range(0, len(rows), 128):
        ids.append(index.insert(rows[s:s + 128]))
        tickets.append(index.submit(queries, window=16))
    for t in tickets:
        t.results()
    index.stop_compactor(flush=True)
    once.insert(rows)
    once.compact()
    assert index.delta_size == 0
    id_of = index.view().id_of
    assert (np.diff(id_of) > 0).all()
    assert np.isin(np.concatenate(ids), id_of).all()
    _same_sealed_tiers(index, once)
    _same_answers(index, once, queries)


@pytest.mark.gpu
def test_cuda_compactor_reraises_planted_seal_error(small_index):
    import time
    index, rows, queries = small_index

    def broken_seal(view0, d0):
        pq.encode(index.codebook, torch.from_numpy(rows).to(index.device))
        raise RuntimeError("planted seal fault")

    index._seal = broken_seal
    index.start_compactor(min_delta=1, poll_s=0.001)
    index.insert(rows[:4])
    deadline = time.time() + 60
    while index._compactor._thread.is_alive() and time.time() < deadline:
        index.submit(queries, window=16).results()
    with pytest.raises(RuntimeError, match="planted seal fault"):
        index.stop_compactor(flush=True)
    assert index.delta_size == 4


@pytest.mark.gpu
def test_cuda_snapshot_round_trip_answers_bit_identically(small_index,
                                                          tmp_path):
    from repro_torch.core.engine import FusionANNSIndex
    index, rows, queries = small_index
    ids = index.insert(rows[:1024])
    index.compact()
    tail = index.insert(rows[1024:])
    index.delete(np.concatenate([ids[:5], tail[:5], [3]]))
    index.save_snapshot(str(tmp_path / "snap"))
    loaded = FusionANNSIndex.load_snapshot(str(tmp_path / "snap"),
                                           device="cuda")
    assert loaded.codes.is_cuda and torch.equal(loaded.codes, index.codes)
    assert loaded.delta_size == index.delta_size
    _same_answers(index, loaded, np.concatenate([queries, rows[::64]]))


# ------------------------------------------------------ serving stack
@pytest.mark.gpu
@pytest.mark.parametrize("plan", [{}, {"fused": True},
                                  {"fused": True, "lut_int8": True}],
                         ids=["dense", "fused", "fused_int8"])
def test_cuda_threaded_stack_answers_as_batch_query(small_index, plan,
                                                    tmp_path):
    """A threaded two-replica stack on the card (pump and ticker threads
    per replica, each window's CUDA event polled from the ticker) answers
    every query as ``batch_query`` (dense) or ``query_batch_fused``
    (fused) does, launches its kernel, hydrates a third replica onto the
    card, and leaves no future pending after ``stop()``."""
    from repro_torch.serve.client import ANNSClient, SearchRequest
    from repro_torch.serve.stack import make_serving_stack
    index, rows, queries = small_index
    qs = np.concatenate([queries, rows[:192]])
    want = (index.submit(qs, **plan).results() if plan
            else index.batch_query(qs))
    kernel = "adc_fused_topk" if plan else "adc_scan_batch"
    launch.reset_launches()
    stack = make_serving_stack(index, n_replicas=2, threaded=True,
                               snapshot_dir=str(tmp_path / "snap"), **plan)
    try:
        futs = [ANNSClient(stack).submit(SearchRequest(query=q, tag=i))
                for i, q in enumerate(qs)]
        stack.add_replica()
        assert stack.indexes[-1].codes.is_cuda
        futs += [stack.submit(SearchRequest(query=q)) for q in qs[:64]]
        got = [f.result(timeout=300) for f in futs]
    finally:
        stack.stop()
    assert all(f.done() for f in futs)
    assert launch.LAUNCHES[kernel] >= 1
    for w, g in zip(want + want[:64], got, strict=True):
        np.testing.assert_array_equal(g.ids, w.ids)
        np.testing.assert_array_equal(g.dists, w.dists)
    assert stack.stats_rollup()["served"] == len(qs) + 64
