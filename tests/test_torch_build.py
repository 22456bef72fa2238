"""The rest of the port's build against the JAX package, on the CPU:
OPQ (``core/opq.py``) and ``FusionANNSIndex.build(use_opq=True)``.

Given the reference's ``OPQCodebook``, the port's ``encode`` gives exactly
its codes and ``adc_lut`` its tables to rtol 1e-6.  A port-trained OPQ
starts its codebooks from a ``torch.Generator`` draw, not ``jax.random``,
so it differs from the reference's; its reconstruction error stays within
5% of the reference's on the same data, its rotation is orthonormal to
1e-4, and an OPQ index's recall@10 is within 0.05 of the reference's.
The incremental navigation graph is in ``test_torch_build_navgraph.py``.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import opq as ropq
from repro.core.engine import (FusionANNSIndex as RefIndex, ground_truth,
                               recall_at_k)
from repro.data.synthetic import clustered_vectors as ref_vectors
from repro_torch.core import opq, pq
from repro_torch.core.engine import FusionANNSIndex

CPU = torch.device("cpu")


def _skewed(seed, n, dim):
    """Anisotropic data (a random linear map), where OPQ should win."""
    rng = np.random.default_rng(seed)
    base = ref_vectors(rng, n, dim, n_clusters=12)
    a = rng.standard_normal((dim, dim)).astype(np.float32)
    a[:, :dim // 4] *= 4.0
    return base @ a


@pytest.fixture(scope="module")
def trained():
    data = _skewed(0, 1500, 32)
    ref, _ = ropq.train_opq(jax.random.key(0), data, m=8, iters=4)
    return data, ref


def _port_codebook(ref):
    return opq.OPQCodebook(rotation=np.asarray(ref.rotation).copy(),
                           cb=pq.PQCodebook(torch.from_numpy(
                               np.asarray(ref.cb.codebooks).copy())))


def test_encode_and_lut_under_reference_codebook(trained):
    data, ref = trained
    port = _port_codebook(ref)
    np.testing.assert_array_equal(opq.encode(port, data).numpy(),
                                  np.asarray(ropq.encode(ref, data)))
    for q in data[:20]:
        np.testing.assert_allclose(opq.adc_lut(port, q).numpy(),
                                   np.asarray(ropq.adc_lut(ref, q)),
                                   rtol=1e-6)
    np.testing.assert_allclose(opq.reconstruction_error(port, data),
                               ropq.reconstruction_error(ref, data),
                               rtol=1e-5)


@pytest.mark.parametrize("seed,n,dim,m", [(0, 1500, 32, 8),
                                          (3, 800, 16, 4)])
def test_train_opq_error_and_orthonormality(seed, n, dim, m):
    data = _skewed(seed, n, dim)
    ref, _ = ropq.train_opq(jax.random.key(seed), data, m=m, iters=4)
    port, err = opq.train_opq(torch.Generator().manual_seed(seed), data, m,
                              device=CPU)
    ref_err = ropq.reconstruction_error(ref, data)
    assert abs(opq.reconstruction_error(port, data) - ref_err) \
        <= 0.05 * ref_err
    assert np.isfinite(err)
    r = port.rotation
    assert np.abs(r.T @ r - np.eye(dim)).max() <= 1e-4
    # and it beats plain PQ on skewed data, as the reference's does
    cb = pq.train_codebooks(torch.Generator().manual_seed(seed), data, m,
                            iters=8, device=CPU)
    plain = opq.reconstruction_error(
        opq.OPQCodebook(rotation=np.eye(dim, dtype=np.float32), cb=cb), data)
    assert opq.reconstruction_error(port, data) < plain


def test_build_use_opq_recall_close_to_reference(anns_bundle):
    b = anns_bundle
    ref = RefIndex.build(b.data, b.cfg, use_opq=True)
    port = FusionANNSIndex.build(b.data, b.cfg, use_opq=True, device=CPU)
    assert port.rotation is not None and port.rotation.shape == (32, 32)
    gt = ground_truth(b.data, b.queries, 10)
    r_ref = recall_at_k(np.stack([r.ids for r in ref.query_batch_fused(
        b.queries)]), gt, 10)
    r_port = recall_at_k(np.stack([r.ids for r in port.query_batch_fused(
        b.queries)]), gt, 10)
    assert abs(r_port - r_ref) <= 0.05
    # the port's codes are the rotated rows under its own codebook
    np.testing.assert_array_equal(
        port.codes.numpy(),
        pq.encode(port.codebook, b.data.astype(np.float32)
                  @ port.rotation).numpy())
    # the reference's rotation and codebook, encoded by the port
    ref_cb = opq.OPQCodebook(rotation=ref.rotation, cb=pq.PQCodebook(
        torch.from_numpy(np.asarray(ref.codebook.codebooks).copy())))
    np.testing.assert_array_equal(opq.encode(ref_cb, b.data).numpy(),
                                  np.asarray(ref.codes))


def test_full_f32_keeps_tf32_off_and_restores_the_callers_setting():
    """Assignment, encode and OPQ products run under ``full_f32``: cuBLAS
    stays off TF32 while any thread is inside, whatever the caller set,
    and the caller's setting comes back when the last one leaves."""
    import threading

    from repro_torch.core.clustering import full_f32
    flag = torch.backends.cuda.matmul
    saved = flag.allow_tf32
    inside, release = threading.Event(), threading.Event()

    def hold():
        with full_f32:
            inside.set()
            release.wait(30)

    try:
        flag.allow_tf32 = True
        t = threading.Thread(target=hold)
        t.start()
        assert inside.wait(30)
        with full_f32:
            assert flag.allow_tf32 is False
        assert flag.allow_tf32 is False        # the other thread is inside
        release.set()
        t.join(30)
        assert not t.is_alive()
        assert flag.allow_tf32 is True
    finally:
        release.set()
        flag.allow_tf32 = saved
