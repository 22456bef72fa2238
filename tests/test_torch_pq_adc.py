"""The port's ADC ops (``repro_torch.kernels.pq_adc``) against the JAX
package's (``repro.kernels.pq_adc``), on the CPU.

The port's wrappers run their plain versions for CPU tensors; the JAX ops
run both as the Pallas kernel in interpret mode and as their jnp path.
Inputs come from numpy seeds.  Tolerances: distances to rtol 1e-5 (M f32
terms; the Pallas interpreter builds its LUT in another rounding order),
ids exactly.  The CUDA kernels against their plain versions are in
``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.pq_adc import ops as jops
from repro.kernels.pq_adc.ref import build_luts_ref as j_build_luts
from repro_torch.kernels.pq_adc import ops, ref

RTOL = 1e-5


def _codes(rng, n, m, distinct=256):
    return rng.integers(0, distinct, (n, m)).astype(np.uint8)


def _rows(rng, b, s, n, all_pad_last=False):
    rows = np.full((b, s), -1, np.int32)
    for i in range(b - (1 if all_pad_last else 0)):
        c = int(rng.integers(0, min(s, n) + 1))
        rows[i, :c] = np.sort(rng.choice(n, c, replace=False))
    return rows


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# M in {4, 8} x B in {1, 5}, each at a ragged N (not a block multiple)
SHAPES = [(4, 1, 37), (4, 5, 601), (8, 1, 601), (8, 5, 37)]


@pytest.mark.parametrize("m,b,n", SHAPES)
@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["pallas_interpret", "jnp"])
def test_dense_masked_topk_matches_jax(m, b, n, use_kernel):
    rng = np.random.default_rng(m * 100 + b * 10 + n)
    codes = _codes(rng, n, m)
    luts = rng.random((b, m, 256)).astype(np.float32)
    mask = rng.random((b, n)) < 0.4
    topk = 50
    jd = np.asarray(jops.pq_adc_batch(jnp.asarray(codes), jnp.asarray(luts),
                                      use_kernel=use_kernel, interpret=True))
    td = ops.pq_adc_batch(_t(codes), _t(luts)).numpy()
    np.testing.assert_allclose(td, jd, rtol=RTOL)
    jv, ji = jops.pq_adc_topk_batch(jnp.asarray(codes), jnp.asarray(luts),
                                    topk, mask=jnp.asarray(mask),
                                    use_kernel=use_kernel, interpret=True)
    tv, ti = ops.pq_adc_topk_batch(_t(codes), _t(luts), topk,
                                   mask=_t(mask))
    assert tuple(tv.shape) == (b, min(topk, n))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# and SPACEV1B's M = 25 (code rows off every wide load on the card)
@pytest.mark.parametrize("m,b,n", SHAPES + [(25, 5, 601)])
@pytest.mark.parametrize("lut_int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["pallas_interpret", "jnp"])
def test_fused_topk_matches_jax(m, b, n, lut_int8, use_kernel):
    rng = np.random.default_rng(7 + m * 100 + b * 10 + n)
    dsub = 4
    codes = _codes(rng, n, m)
    cb = rng.standard_normal((m, 256, dsub)).astype(np.float32)
    q = rng.standard_normal((b, m * dsub)).astype(np.float32)
    s = 150                                  # not a multiple of any block
    rows = _rows(rng, b, s, n)
    for topk in (10, 400):
        jv, ji = jops.pq_adc_fused_topk(
            jnp.asarray(codes), jnp.asarray(q), jnp.asarray(cb),
            jnp.asarray(rows), topk, lut_int8=lut_int8,
            use_kernel=use_kernel, interpret=True)
        tv, ti = ops.pq_adc_fused_topk(_t(codes), _t(q), _t(cb), _t(rows),
                                       topk, lut_int8=lut_int8)
        assert tuple(tv.shape) == np.asarray(jv).shape == (b, min(topk, s))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_luts_and_quantization_match_jax():
    rng = np.random.default_rng(3)
    cb = rng.standard_normal((8, 256, 4)).astype(np.float32)
    q = rng.standard_normal((5, 32)).astype(np.float32)
    luts = ref.build_luts_ref(_t(cb), _t(q))
    jl = np.asarray(j_build_luts(jnp.asarray(cb), jnp.asarray(q)))
    np.testing.assert_allclose(luts.numpy(), jl, rtol=1e-6)
    q8, scale, zp = ops.quantize_luts(luts)
    j8, js, jz = map(np.asarray, jops.quantize_luts(jnp.asarray(
        luts.numpy())))
    np.testing.assert_array_equal(q8.numpy(), j8)
    np.testing.assert_allclose(scale.numpy(), js, rtol=1e-6)
    np.testing.assert_array_equal(zp.numpy(), jz)


def test_fma_f32_rounds_once():
    """fma_f32 is the correctly rounded a*b+c: (1+2^-12)^2 - 1 keeps the
    2^-24 term that a separately rounded product would lose."""
    a = torch.tensor([1 + 2 ** -12], dtype=torch.float32)
    c = torch.tensor([-1.0], dtype=torch.float32)
    assert ref.fma_f32(a, a, c).item() == 2 ** -11 + 2 ** -24
    assert (a * a + c).item() == 2 ** -11


@pytest.mark.parametrize("lut_int8", [False, True], ids=["f32", "int8"])
def test_fused_contracts(lut_int8):
    """Output length min(topk, S); (+inf, -1) pads; an all-pad query; ties
    to the lowest row (every code row is repeated 3 times)."""
    rng = np.random.default_rng(11)
    m, dsub, n = 8, 2, 300
    codes = np.repeat(_codes(rng, n // 3, m), 3, axis=0)
    cb = rng.standard_normal((m, 256, dsub)).astype(np.float32)
    q = rng.standard_normal((4, m * dsub)).astype(np.float32)
    rows = _rows(rng, 4, 90, n, all_pad_last=True)
    rows[0, :30] = np.arange(30)                    # 10 triples of ties
    rows[0, 30:] = -1
    for topk in (5, 60, 500):
        v, i = ops.pq_adc_fused_topk(_t(codes), _t(q), _t(cb), _t(rows),
                                     topk, lut_int8=lut_int8)
        v, i = v.numpy(), i.numpy()
        assert v.shape == i.shape == (4, min(topk, 90))
        assert np.all(np.isinf(v[3])) and np.all(i[3] == -1)
        for qi in range(4):
            cnt = int((rows[qi] >= 0).sum())
            assert np.all(np.isinf(v[qi, cnt:])) and np.all(i[qi, cnt:] == -1)
            assert np.all(np.isfinite(v[qi, :min(cnt, topk)]))
            assert np.all(np.diff(v[qi, :cnt]) >= 0)
        # query 0: rows 3t, 3t+1, 3t+2 tie; each run must be ascending
        run = i[0, :min(topk, 30)]
        d = v[0, :min(topk, 30)]
        for j in range(1, len(run)):
            if d[j] == d[j - 1]:
                assert run[j] > run[j - 1]


def test_dense_contracts():
    rng = np.random.default_rng(12)
    codes = np.repeat(_codes(rng, 20, 4), 2, axis=0)      # pairs tie
    luts = rng.random((2, 4, 256)).astype(np.float32)
    for topk in (3, 40, 100):
        v, i = ops.pq_adc_topk_batch(_t(codes), _t(luts), topk)
        assert tuple(v.shape) == (2, min(topk, 40))
        for qi in range(2):
            d, r = v[qi].numpy(), i[qi].numpy()
            tie = d[1:] == d[:-1]
            assert np.all(r[1:][tie] > r[:-1][tie])
    mask = np.zeros((2, 40), bool)
    mask[0, :5] = True
    v, i = ops.pq_adc_topk_batch(_t(codes), _t(luts), 10, mask=_t(mask))
    assert np.all(np.isfinite(v[0, :5].numpy()))
    assert np.all(np.isinf(v[0, 5:].numpy()))
    assert np.all(np.isinf(v[1].numpy()))


def test_int8_error_within_half_scale():
    rng = np.random.default_rng(13)
    m, dsub, n = 8, 4, 500
    codes = _codes(rng, n, m)
    cb = rng.standard_normal((m, 256, dsub)).astype(np.float32)
    q = rng.standard_normal((3, m * dsub)).astype(np.float32)
    rows = _rows(rng, 3, 200, n)
    rows[:, :120] = np.sort(rng.choice(n, (3, 120)), axis=1)
    luts = ref.build_luts_ref(_t(cb), _t(q))
    _, scale, _ = ops.quantize_luts(luts)
    bound = scale.sum(-1, keepdim=True).numpy() / 2
    d32 = ref.pq_adc_rows_ref(_t(codes), luts, _t(rows)).numpy()
    d8 = ops._rows_scan_int8(_t(codes), *ops.quantize_luts(luts),
                             _t(rows)).numpy()
    fin = np.isfinite(d32)
    assert np.array_equal(fin, np.isfinite(d8))
    err = np.abs(d8[fin] - d32[fin])
    # the JAX package's bound (tests/test_kernel_props.py), per query
    assert np.all(err <= np.broadcast_to(bound, d32.shape)[fin] + 1e-5)
