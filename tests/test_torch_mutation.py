"""Index mutation in the port against the JAX package, on the CPU.

The shared session index (``anns_bundle``) is copied, saved with the JAX
package's ``save_snapshot`` and loaded into the port with
``device="cpu"``; then both packages take the same inserts, deletes and
compactions.  After each step every query path (``query``,
``batch_query``, ``query_batch_fused``, the fused int8 path and filtered
requests) must return the reference's ids and distances (both come from
the numpy re-rank on raw vectors and the exact delta scan, so equality is
exact) and the same ``QueryStats`` counters, and the published tiers —
codes, posting members and primary, tombstones, ``id_of``/``row_of``,
SSD rows and ``page_of``, delta vectors, flags and attributes — must be
array-equal.  ADC-stage distances over the re-published codes agree to
rtol 1e-6.  Snapshots cross both ways.  Where seals cut the delta at
different places (one seal against many, or the background compactor),
ids, distances, codes, posting members and ``id_of`` must not change;
the SSD page layout, and with it the I/O counters, may.
"""

import copy
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pq as rpq
from repro.core.engine import FusionANNSIndex as RefIndex
from repro.core.filters import Eq as RefEq
from repro_torch.core import pq
from repro_torch.core.engine import FusionANNSIndex
from repro_torch.core.filters import Eq
from repro_torch.kernels.pq_adc.ops import pq_adc_batch

COUNTERS = ("candidates_scanned", "candidates_prefilter", "ios",
            "buffer_hits", "rerank_batches")


@pytest.fixture()
def pair(anns_bundle, fresh_index, tmp_path):
    """(bundle, reference index, port index) holding the same tiers."""
    path = str(tmp_path / "base")
    fresh_index.save_snapshot(path)
    return anns_bundle, fresh_index, FusionANNSIndex.load_snapshot(
        path, device="cpu")


def _paths(index, queries, filt):
    """Every query path's results, in a fixed order."""
    out = [[index.query(q) for q in queries], index.batch_query(queries),
           index.query_batch_fused(queries),
           index.submit(queries, fused=True, lut_int8=True).results()]
    if filt is not None:
        out += [index.submit(queries, filter=filt, fused=f,
                             window=5).results() for f in (False, True)]
    return out


def assert_same_answers(ref, port, queries, *, counters=True,
                        attr_value=None):
    filt = (None, None) if attr_value is None else (
        RefEq("cat", attr_value), Eq("cat", attr_value))
    for r_path, p_path in zip(_paths(ref, queries, filt[0]),
                              _paths(port, queries, filt[1]), strict=True):
        assert len(r_path) == len(p_path)
        for r, p in zip(r_path, p_path):
            np.testing.assert_array_equal(p.ids, r.ids)
            np.testing.assert_array_equal(p.dists, r.dists)
            if counters:
                for c in COUNTERS:
                    assert getattr(p.stats, c) == getattr(r.stats, c), c


def assert_same_tiers(ref, port):
    rv, pv = ref.view(), port.view()
    assert (pv.epoch, pv.n_sealed, pv.n_rows, pv.n_total) == \
        (rv.epoch, rv.n_sealed, rv.n_rows, rv.n_total)
    np.testing.assert_array_equal(pv.codes.numpy(), np.asarray(rv.codes))
    assert len(pv.posting.members) == len(rv.posting.members)
    for pm, rm in zip(pv.posting.members, rv.posting.members):
        np.testing.assert_array_equal(pm, rm)
        assert pm.dtype == rm.dtype
    for name in ("primary", "centroids"):
        np.testing.assert_array_equal(getattr(pv.posting, name),
                                      getattr(rv.posting, name))
    for name in ("tombstones", "id_of", "row_of"):
        np.testing.assert_array_equal(getattr(pv, name), getattr(rv, name))
    np.testing.assert_array_equal(port.ssd.vectors[:pv.n_rows],
                                  ref.ssd.vectors[:rv.n_rows])
    np.testing.assert_array_equal(port.ssd.layout.page_of[:pv.n_rows],
                                  ref.ssd.layout.page_of[:rv.n_rows])
    assert port.ssd.layout.n_pages == ref.ssd.layout.n_pages
    assert pv.delta.base == rv.delta.base
    np.testing.assert_array_equal(pv.delta.vectors, rv.delta.vectors)
    np.testing.assert_array_equal(pv.delta.tombstoned, rv.delta.tombstoned)
    for p_attrs, r_attrs in ((pv.attrs, rv.attrs),
                             (pv.delta.attrs, rv.delta.attrs)):
        assert sorted(p_attrs.columns) == sorted(r_attrs.columns)
        for name, col in r_attrs.columns.items():
            np.testing.assert_array_equal(p_attrs.columns[name], col)


def _both(ref, port, op, *args, **kw):
    r = getattr(ref, op)(*args, **kw)
    p = getattr(port, op)(*args, **kw)
    if r is None:
        assert p is None
    else:
        np.testing.assert_array_equal(np.asarray(p), np.asarray(r))
    return p


def _cat(n):
    return {"cat": np.arange(n, dtype=np.int64) % 3}


# Each scenario: a list of steps replayed on both packages.  ``ids`` holds
# the ids the inserts returned, so deletes can name them.
SCENARIOS = {
    # insert with attributes (the filtered path sees them before and
    # after the seal)
    "insert_attrs_compact": [("insert", slice(0, 20), True), ("compact",)],
    # deletes of delta-owned, sealed-built and sealed-inserted ids
    "delete_sealed_and_delta": [
        ("insert", slice(0, 12), False), ("delete", lambda ids: [ids[0], 3]),
        ("compact",), ("delete", lambda ids: [ids[1], 7]),
        ("insert", slice(12, 20), False), ("delete", lambda ids: [ids[13]])],
    # the seal-time purge: rows tombstoned in the delta are never encoded
    "purge_at_seal": [("insert", slice(0, 20), True),
                      ("delete", lambda ids: ids[5:9]), ("compact",),
                      ("insert", slice(0, 4), True), ("compact",)],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_mutation_matches_reference(pair, name):
    b, ref, port = pair
    queries = np.concatenate([b.queries[:8], b.new_vecs[:8]])
    ids = np.zeros(0, np.int64)
    for step in SCENARIOS[name]:
        if step[0] == "insert":
            rows = b.new_vecs[step[1]]
            attrs = _cat(len(rows)) if step[2] else None
            ids = np.concatenate([ids, _both(ref, port, "insert", rows,
                                             attributes=attrs)])
        elif step[0] == "delete":
            _both(ref, port, "delete", np.asarray(step[1](ids)))
        else:
            _both(ref, port, "compact")
        assert_same_tiers(ref, port)
        assert_same_answers(ref, port, queries, attr_value=1)
    if name == "purge_at_seal":
        purged = ids[5:9]
        assert (port.view().row_of[purged] == -1).all()
        member_ids = port.view().id_of[np.concatenate(port.posting.members)]
        assert not set(purged.tolist()) & set(member_ids.tolist())


def test_adc_distances_over_republished_codes(pair):
    b, ref, port = pair
    ids = _both(ref, port, "insert", b.new_vecs)
    _both(ref, port, "delete", ids[:3])
    _both(ref, port, "compact")
    rcb = rpq.PQCodebook(jnp.asarray(np.asarray(ref.codebook.codebooks)))
    luts = pq.adc_lut_batch(port.codebook, torch.from_numpy(b.queries))
    got = pq_adc_batch(port.codes, luts).numpy()
    for i, q in enumerate(b.queries):
        want = np.asarray(rpq.adc_distances_ref(
            rpq.adc_lut(rcb, jnp.asarray(q)), ref.codes))
        np.testing.assert_allclose(got[i], want, rtol=1e-6)


@pytest.mark.parametrize("bad", ["n_total", "negative"])
def test_delete_of_unpublished_id_raises(pair, bad):
    b, ref, port = pair
    _both(ref, port, "insert", b.new_vecs[:4])
    for index in (ref, port):
        victim = index.n_total if bad == "n_total" else -1
        with pytest.raises(ValueError):
            index.delete(np.array([victim]))
    assert_same_tiers(ref, port)


def test_ids_stable_across_compaction(pair):
    b, ref, port = pair
    new_ids = _both(ref, port, "insert", b.new_vecs)
    pre = [port.query(v, k=1).ids[0] for v in b.new_vecs]
    _both(ref, port, "compact")
    post = [port.query(v, k=1).ids[0] for v in b.new_vecs]
    assert pre == post
    assert sum(int(a == n) for a, n in zip(post, new_ids)) >= 18
    assert post == [ref.query(v, k=1).ids[0] for v in b.new_vecs]


def test_concurrent_compact_serializes(pair):
    b, ref, port = pair
    _both(ref, port, "insert", b.new_vecs)
    ref.compact()
    sealed = []
    threads = [threading.Thread(target=lambda: sealed.append(port.compact()))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert sorted(sealed) == [0, 0, 0, len(b.new_vecs)]
    assert port.compact(wait=False) == 0
    assert_same_tiers(ref, port)
    assert_same_answers(ref, port, b.queries)


def test_view_publication_is_atomic_across_tiers(pair):
    """A view pinned at any moment — mid-insert or mid-seal on another
    thread — binds codes, posting lists, id maps and tombstones of one
    sealed prefix (more threads than cores, a short switch interval)."""
    b, ref, port = pair
    stop = threading.Event()
    errors = []

    def mutate(seed):
        try:
            rng = np.random.default_rng(seed)
            while not stop.is_set():
                ids = port.insert(rng.normal(
                    size=(3, b.data.shape[1])).astype(np.float32))
                port.delete(ids[:1])
                port.compact()
        except BaseException as exc:  # noqa: BLE001 — surfaced below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=mutate, args=(s,)) for s in range(12)]
    try:
        for t in threads:
            t.start()
        for _ in range(40):
            view = port.view()
            assert view.codes.shape[0] == view.n_rows
            assert len(view.posting.primary) == view.n_rows
            assert len(view.row_of) == view.n_sealed >= view.n_rows
            for q in b.queries[:2]:
                ids = view.candidate_ids(q, b.cfg.top_m)
                assert not len(ids) or ids.max() < view.n_sealed
            port.query(b.queries[0], k=5)
    finally:
        stop.set()
        sys.setswitchinterval(interval)
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    view = port.view()
    assert (np.diff(view.id_of) > 0).all()
    np.testing.assert_array_equal(view.row_of[view.id_of],
                                  np.arange(view.n_rows))


def test_background_compactor_while_serving(pair):
    """Seals at moments that depend on timing give the reference's
    answers after one seal: ids, distances, codes, members, ``id_of``."""
    b, ref, port = pair
    port.start_compactor(min_delta=6, poll_s=0.005)
    try:
        for s in range(0, len(b.new_vecs), 4):
            rows = b.new_vecs[s:s + 4]
            _both(ref, port, "insert", rows, attributes=_cat(len(rows)))
            port.query(b.queries[0], k=5)          # serve during seals
    finally:
        port.stop_compactor(flush=True)
    ref.compact()
    assert port.delta_size == 0
    assert port.codes.shape[0] == port.view().n_rows == ref.view().n_rows
    _assert_same_sealed_rows(ref, port)
    assert_same_answers(ref, port, np.concatenate([b.queries, b.new_vecs]),
                        counters=False, attr_value=2)


def _assert_same_sealed_rows(a, b):
    """The tiers that must not depend on where seals cut the delta."""
    av, bv = a.view(), b.view()
    np.testing.assert_array_equal(np.asarray(bv.codes), np.asarray(av.codes))
    for x, y in zip(bv.posting.members, av.posting.members, strict=True):
        np.testing.assert_array_equal(x, y)
    for name in ("tombstones", "id_of", "row_of"):
        np.testing.assert_array_equal(getattr(bv, name), getattr(av, name))


def test_compactor_reraises_seal_error(pair):
    b, ref, port = pair

    def broken_seal(view0, d0):
        raise RuntimeError("planted seal fault")

    port._seal = broken_seal
    port.start_compactor(min_delta=1, poll_s=0.005)
    port.insert(b.new_vecs[:2])
    deadline = time.time() + 30
    while port._compactor._thread.is_alive() and time.time() < deadline:
        time.sleep(0.005)
    with pytest.raises(RuntimeError, match="planted seal fault"):
        port.stop_compactor(flush=True)
    assert port.delta_size == 2 and port._compactor is None


def test_deepcopy_gets_fresh_locks_and_no_compactor(pair):
    b, ref, port = pair
    port.start_compactor(min_delta=10 ** 6)
    try:
        clone = copy.deepcopy(port)
    finally:
        port.stop_compactor()
    assert clone._compactor is None and clone._executor is None
    assert clone._mut_lock is not port._mut_lock
    clone.insert(b.new_vecs)
    assert clone.delta_size == len(b.new_vecs) and port.delta_size == 0
    ref_clone = copy.deepcopy(ref)
    ref_clone.insert(b.new_vecs)
    assert_same_answers(ref_clone, clone, b.queries)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_seal_boundaries(pair, seed):
    """One seal against many at random cuts: equal ids and distances.
    Deletes land right after their insert, before any seal can take the
    row, so both purge the same rows."""
    b, ref, port = pair
    many = copy.deepcopy(port)
    rng = np.random.default_rng(seed)
    rows = np.concatenate([b.new_vecs, b.queries[:10] + 0.5])
    s = 0
    while s < len(rows):
        e = min(s + int(rng.integers(1, 6)), len(rows))
        drop = rng.random(e - s) < 0.2
        for index in (port, many):
            ids = index.insert(rows[s:e], attributes=_cat(e - s))
            index.delete(ids[drop])
        if rng.random() < 0.5:
            many.compact()
        s = e
    many.compact()
    port.compact()
    _assert_same_sealed_rows(port, many)
    queries = np.concatenate([b.queries, rows[::3]])
    for r, p in zip(port.submit(queries, window=7).results(),
                    many.submit(queries, window=7).results(), strict=True):
        np.testing.assert_array_equal(p.ids, r.ids)
        np.testing.assert_array_equal(p.dists, r.dists)


def _mutate(index, new_vecs):
    ids = index.insert(new_vecs[:12], attributes=_cat(12))
    index.compact()                                # some sealed inserts
    ids2 = index.insert(new_vecs[12:])             # plus a live delta
    index.delete(np.array([ids[0], ids2[0], 3]))   # both segments + base


def test_snapshot_port_to_reference(pair, tmp_path):
    """A snapshot the port writes loads into the JAX package (and into the
    port) and answers as the donor and as the reference that took the
    same steps."""
    b, ref, port = pair
    _mutate(ref, b.new_vecs)
    _mutate(port, b.new_vecs)
    path = str(tmp_path / "port_snap")
    port.save_snapshot(path)
    ref_loaded = RefIndex.load_snapshot(path)
    port_loaded = FusionANNSIndex.load_snapshot(path, device="cpu")
    queries = np.concatenate([b.queries, b.new_vecs])
    for other in (ref, ref_loaded):
        assert_same_tiers(other, port)
        assert_same_answers(other, port, queries, counters=False,
                            attr_value=1)
    assert_same_tiers(ref_loaded, port_loaded)
    assert_same_answers(ref_loaded, port_loaded, queries, attr_value=1)
    # and the restored copies keep evolving as the reference does
    for index in (ref, port_loaded):
        index.insert(b.new_vecs[:4])
        index.compact()
    assert_same_tiers(ref, port_loaded)
    assert_same_answers(ref, port_loaded, queries, counters=False)
