"""The CUDA kernels of ``repro_torch`` against their plain versions, on
the card.  Marked ``gpu``: without a CUDA device they skip (a CUDA kernel
has no CPU mode).  This file imports no JAX, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerance: distances to rtol 1e-5 (M f32 terms; in fact the kernels
repeat the plain versions' operations in order and agree to the bit);
ids exactly.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.pq_adc import ops, ref

RTOL = 1e-5


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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 32])
def test_cuda_dense_kernel_matches_plain(cuda, m):
    rng = np.random.default_rng(21)
    for n, b in ((1, 1), (777, 64), (9000, 64), (300_001, 5)):
        codes = _t(_codes(rng, n, m)).to(cuda)
        luts = _t(rng.random((b, m, 256)).astype(np.float32)).to(cuda)
        got = ops.pq_adc_batch(codes, luts)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(),
                                   ref.pq_adc_batch_ref(codes, luts).cpu(),
                                   rtol=RTOL)


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
