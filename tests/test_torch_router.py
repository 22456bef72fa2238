"""The port's replica router, serving stack and autoscaler against the
JAX package's.

* Every routing policy over two synchronous replicas: the reference
  router's ids, distances, counters and routing books; over two threaded
  replicas: ``batch_query``'s ids, nothing left pending after ``stop()``.
* ``add_replica`` hydrating from a snapshot onto the donor's device,
  ``remove_replica`` draining under load, and the mutation fan-out
  (``insert``/``delete``/``compact``) replayed on both packages: equal
  answers throughout, no deleted id back.
* ``scaling_signals``, ``measured_demand`` and the autoscaler's model
  bound equal; ``ReplicaAutoscaler.tick`` takes the reference's
  decisions on one scripted signal sequence.
* ``make_serving_stack`` from an index and from a snapshot.
* Every mesh entry point (``attach_mesh``, ``make_executor(mesh)``,
  ``ReplicaRouter(mesh=)``, ``ServingStackConfig(mesh=)``) serves the
  reference's single-device answers on a mesh of logical CPU devices;
  the router carves it into groups, re-carves on every resize (a
  hydrated replica joins its group) and loses no future.
"""

import copy
import dataclasses
import threading

import numpy as np
import pytest

from repro.core import perf_model as ref_pm
from repro.core.engine import FusionANNSIndex as RefIndex
from repro.serve.autoscaler import (AutoscalerConfig as RefAsConfig,
                                    ReplicaAutoscaler as RefAutoscaler)
from repro.serve.client import SearchRequest as RefRequest
from repro.serve.router import ReplicaRouter as RefRouter
from repro.serve.stack import (ServingStackConfig as RefStackConfig,
                               make_serving_stack as ref_stack)
from repro_torch.core import perf_model as port_pm
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.serve.autoscaler import AutoscalerConfig, ReplicaAutoscaler
from repro_torch.serve.client import ANNSClient, SearchRequest
from repro_torch.serve.router import POLICIES, ReplicaRouter
from repro_torch.serve.stack import ServingStackConfig, make_serving_stack

from _torch_serving import (FAR, PER_QUERY, FakeClock,  # noqa: F401
                            assert_same, load_port, pair,
                            port_witness_guard, snapshot)

KS = [1, 3, 5, 7, 10, 2, 4, 6]


def _route_all(router, req_cls, queries):
    futs = [router.submit(req_cls(query=q, k=KS[i % len(KS)],
                                  deadline_s=FAR if i % 2 else None))
            for i, q in enumerate(queries)]
    router.drain()
    return [f.result(timeout=60) for f in futs]


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_parity_with_reference(pair, policy):
    """Two synchronous replicas under each policy: the reference router's
    answers, counters and routing books."""
    b, idx = pair
    kw = dict(n_replicas=2, policy=policy, threaded=False, max_batch=4,
              max_wait_s=0.0)
    ref, port = RefRouter(b.index, **kw), ReplicaRouter(idx, **kw)
    assert_same(_route_all(ref, RefRequest, b.queries),
                _route_all(port, SearchRequest, b.queries))
    rroll, proll = ref.stats_rollup(), port.stats_rollup()
    for key in ("submitted", "rejected", "spills", "deadline_spills",
                "routed", "requests", "batches", "served", "query_stats"):
        assert proll[key] == rroll[key], key
    for r in (ref, port):
        r.stop()


def test_threaded_router_matches_batch_query(pair):
    """Two threaded replicas (pump + ticker each) behind jsq, fed from
    four producer threads: ``batch_query``'s ids and distances, no
    future pending after ``stop()``."""
    b, idx = pair
    qs = np.concatenate([b.queries] * 3)
    want = b.index.batch_query(qs)
    router = ReplicaRouter(idx, n_replicas=2, policy="jsq", threaded=True,
                           max_batch=8, max_wait_s=0.0005)
    futs = [None] * len(qs)

    def produce(lo):
        for i in range(lo, len(qs), 4):
            futs[i] = router.submit(SearchRequest(query=qs[i], tag=i))

    try:
        ts = [threading.Thread(target=produce, args=(j,)) for j in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        got = [f.result(timeout=120) for f in futs]
    finally:
        router.stop()
    assert all(f.done() for f in futs)
    assert_same(want, got, counters=PER_QUERY)
    roll = router.stats_rollup()
    assert roll["served"] == len(qs) == sum(roll["routed"])
    assert router.live_load() == 0


def _hydrate_and_mutate(index, router_cls, req_cls, new_vecs, queries,
                        snap_dir):
    router = router_cls(index, n_replicas=1, policy="round_robin",
                        threaded=False, snapshot_dir=snap_dir, max_batch=4,
                        max_wait_s=0.0)
    slot = router.add_replica()
    out = {"slot": slot, "rounds": []}

    def serve():
        futs = [router.submit(req_cls(query=q)) for q in queries]
        router.drain()
        out["rounds"].append([f.result(timeout=60) for f in futs])

    serve()
    ids = router.insert(new_vecs[:12])
    top1 = [r.ids[0] for r in out["rounds"][0][:4]]
    router.delete(np.concatenate([ids[:3], top1]))
    serve()
    out["sealed"] = router.compact()
    serve()
    out["deleted"] = np.concatenate([ids[:3], top1])
    out["routed"] = list(router.stats["routed"])
    out["removed"] = router.remove_replica(slot)
    serve()
    out["rollup"] = router.stats_rollup()
    out["indexes"] = router.indexes
    router.stop()
    return out


def test_hydration_and_mutation_fanout_match_reference(anns_bundle,
                                                       fresh_index,
                                                       snapshot, tmp_path):
    """``add_replica`` hydrates the newcomer from a fresh snapshot (onto
    the donor's device in the port); inserts, deletes and a compaction
    fan out to both indexes; every round (both replicas, round-robin)
    equals the reference's, and no deleted id comes back."""
    b = anns_bundle
    idx = load_port(snapshot)
    qs = np.concatenate([b.queries, b.new_vecs[:4]])
    want = _hydrate_and_mutate(fresh_index, RefRouter, RefRequest,
                               b.new_vecs, qs, str(tmp_path / "ref"))
    got = _hydrate_and_mutate(idx, ReplicaRouter, SearchRequest,
                              b.new_vecs, qs, str(tmp_path / "port"))
    assert len(got["rounds"]) == 4
    for w, g in zip(want["rounds"], got["rounds"]):
        assert_same(w, g)
    for rnd in got["rounds"][1:]:
        assert not np.intersect1d(np.concatenate([r.ids for r in rnd]),
                                  got["deleted"]).size
    assert got["sealed"] == want["sealed"] == 12
    assert got["slot"] == want["slot"] and got["routed"] == want["routed"]
    assert got["removed"] == want["removed"]
    for key in ("served", "query_stats", "scale_ups", "scale_downs"):
        assert got["rollup"][key] == want["rollup"][key], key
    hydrated = got["indexes"]
    assert len(hydrated) == 1 and hydrated[0] is idx
    assert idx.device.type == "cpu"


def test_hydrated_replica_lands_on_donor_device(pair, tmp_path):
    """The newcomer loads onto the donor index's device, never onto the
    loader's default (the card, which would raise here)."""
    b, idx = pair
    router = ReplicaRouter(idx, n_replicas=1, threaded=False,
                           snapshot_dir=str(tmp_path), max_batch=4,
                           max_wait_s=0.0)
    router.add_replica()
    new = router.indexes[1]
    assert new is not idx and new.device == idx.device
    assert new.codes.device == idx.codes.device
    router.stop()


def test_remove_replica_under_load_loses_no_future(pair):
    b, idx = pair
    router = ReplicaRouter(idx, n_replicas=3, policy="round_robin",
                           threaded=True, max_batch=4, max_wait_s=0.002)
    try:
        futs = [router.submit(SearchRequest(query=q))
                for q in np.concatenate([b.queries] * 2)]
        victim = router.remove_replica()
        futs += [router.submit(SearchRequest(query=q)) for q in b.queries]
        got = [f.result(timeout=120) for f in futs]
    finally:
        router.stop()
    assert victim in (0, 1, 2) and router.n_replicas == 2
    assert all(f.done() and not f.cancelled() for f in futs)
    want = b.index.batch_query(np.concatenate([b.queries] * 3))
    assert_same(want, got, counters=PER_QUERY)
    assert router.stats_rollup()["served"] == len(futs)


def test_signals_demand_and_model_cap_match_reference(pair):
    """After the same synchronous traffic, ``scaling_signals`` (apart
    from wall-clock latencies), ``measured_demand`` and the autoscaler's
    model bound are the reference's."""
    b, idx = pair
    kw = dict(n_replicas=2, policy="jsq", threaded=False, max_batch=4,
              max_wait_s=0.0)
    ref, port = RefRouter(b.index, **kw), ReplicaRouter(idx, **kw)
    _route_all(ref, RefRequest, b.queries)
    _route_all(port, SearchRequest, b.queries)
    rs, ps = ref.scaling_signals(), port.scaling_signals()
    for key in ("p50", "p99"):
        rs.pop(key)
        ps.pop(key)
    assert ps == rs
    assert dataclasses.asdict(port.measured_demand()) == \
        dataclasses.asdict(ref.measured_demand())
    pcap = ReplicaAutoscaler(port, AutoscalerConfig(max_replicas=8))
    rcap = RefAutoscaler(ref, RefAsConfig(max_replicas=8))
    assert pcap._model_cap() == rcap._model_cap()
    assert ReplicaAutoscaler(ReplicaRouter(idx, n_replicas=1,
                                           threaded=False))._model_cap() \
        is None
    for r in (ref, port):
        r.stop()


class _ScriptedRouter:
    """A router whose ``scaling_signals`` replay a script; the actuators
    count replicas.  Its demand comes from the given perf model."""

    def __init__(self, script, pm, served):
        self.script, self.pm, self.served = list(script), pm, served
        self.n = 1
        self.slots = 0

    @property
    def n_replicas(self):
        return self.n

    def scaling_signals(self):
        sig = dict(self.script.pop(0))
        sig["n_replicas"] = self.n
        return sig

    def add_replica(self):
        self.n += 1
        self.slots += 1
        return self.slots

    def remove_replica(self, drain=True):
        self.n -= 1
        return 0

    def stats_rollup(self):
        return {"served": self.served}

    def measured_demand(self):
        return self.pm.QueryDemand(ssd_ios=30.0, ssd_bytes=30 * 4096.0,
                                   h2d_bytes=8000.0, gpu_lookups=64000.0,
                                   cpu_dist_ops=9000.0, graph_hops=128.0)


def _signal(load, spills=0, exhausted=0, rejected=0, p99=0.0, n=1):
    return dict(live_load=load, spills=spills, spill_exhausted=exhausted,
                rejected=rejected, p50=p99 / 2, p99=p99, latency_n=n)


SCRIPT = [_signal(0), _signal(30), _signal(30), _signal(40, spills=2),
          _signal(5, spills=2), _signal(90, p99=0.5), _signal(0),
          _signal(0), _signal(0), _signal(0), _signal(0), _signal(3),
          _signal(0), _signal(0), _signal(0), _signal(200, rejected=4)]


@pytest.mark.parametrize("served", [0, 100], ids=["no_demand", "demand"])
def test_autoscaler_ticks_match_reference(served):
    """One scripted signal sequence (load above and below the marks,
    spill and reject deltas, a p99 past its bound, calm stretches) on a
    fake clock: every tick's decision, the counters and the event log
    equal the reference's."""
    cfg = dict(min_replicas=1, max_replicas=4, high_water=8.0,
               low_water=1.0, p99_bound_s=0.25, scale_up_cooldown_s=1.0,
               scale_down_cooldown_s=2.5, down_ticks=3)
    runs = []
    for pm, as_cls, cfg_cls in ((ref_pm, RefAutoscaler, RefAsConfig),
                                (port_pm, ReplicaAutoscaler,
                                 AutoscalerConfig)):
        clk = FakeClock()
        router = _ScriptedRouter(SCRIPT, pm, served)
        asc = as_cls(router, cfg_cls(**cfg), clock=clk)
        actions = []
        for i in range(len(SCRIPT)):
            clk.t = 0.7 * i
            actions.append((asc.tick(), router.n))
        runs.append((actions, dict(asc.stats), list(asc.events)))
    assert runs[1] == runs[0]
    assert {a for a, _ in runs[1][0]} >= {"scale_up", "scale_down"}


def test_autoscaler_config_validation_matches_reference():
    for bad in (dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
                dict(low_water=8.0, high_water=8.0)):
        with pytest.raises(ValueError) as port_err:
            AutoscalerConfig(**bad)
        with pytest.raises(ValueError) as ref_err:
            RefAsConfig(**bad)
        assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("source", ["index", "snapshot"])
def test_make_serving_stack_matches_reference(pair, snapshot, source):
    """The stack's defaults are the reference's; a threaded two-replica
    stack, from the index or booted from its snapshot on the CPU, answers
    as the reference's stack does."""
    b, idx = pair
    ref_fields = {f.name: f.default for f in
                  dataclasses.fields(RefStackConfig)}
    port_fields = {f.name: f.default for f in
                   dataclasses.fields(ServingStackConfig)}
    assert port_fields.pop("device") is None
    assert port_fields == ref_fields
    reqs = [dict(query=q, k=KS[i % len(KS)]) for i, q in
            enumerate(b.queries)]
    if source == "index":
        port = make_serving_stack(idx)
    else:
        port = make_serving_stack(None, snapshot_dir=snapshot,
                                  device="cpu")
    ref = ref_stack(b.index, threaded=False)
    try:
        got = ANNSClient(port).search_many(
            [SearchRequest(**r) for r in reqs], timeout=120)
    finally:
        port.stop()
    from repro.serve.client import ANNSClient as RefClient
    want = RefClient(ref).search_many([RefRequest(**r) for r in reqs])
    assert_same(want, got, counters=PER_QUERY)
    assert port.n_replicas == 2 and port.stats_rollup()["served"] == len(reqs)
    assert port.index.device.type == "cpu"
    with pytest.raises(ValueError, match="snapshot_dir"):
        make_serving_stack(None)


def test_every_mesh_entry_point_serves_the_reference(pair):
    """``attach_mesh``, ``make_executor(mesh)``, ``ReplicaRouter(mesh=)``
    and ``ServingStackConfig(mesh=)`` each take a mesh of four logical
    CPU devices and serve the JAX single-device reference's ids and
    distances (its own sharded executor raises on this JAX: ROADMAP
    queue 3, fault (a))."""
    b, idx = pair
    want = b.index.batch_query(b.queries)
    mesh = make_test_mesh(4, device="cpu")
    own = copy.deepcopy(idx)
    ex = own.executor.attach_mesh(mesh)
    assert ex is own.executor and ex._n_shards() == 4
    assert_same(want, own.batch_query(b.queries))
    assert_same(b.index.executor.run(b.queries, b.index.plan()),
                idx.make_executor(mesh).run(b.queries, idx.plan()))
    reqs = [SearchRequest(query=q) for q in b.queries]
    router = ReplicaRouter(idx, mesh=mesh, threaded=False, max_batch=4,
                           max_wait_s=0.0)
    assert [r.executor._n_shards() for r in router.replicas] == [2, 2]
    assert_same(want, ANNSClient(router).search_many(reqs),
                counters=PER_QUERY)
    stack = make_serving_stack(idx, ServingStackConfig(mesh=mesh),
                               threaded=False)
    assert stack.parent_mesh is mesh
    assert_same(want, ANNSClient(stack).search_many(reqs),
                counters=PER_QUERY)
    for r in (router, stack):
        r.stop()


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_parity_on_a_mesh(pair, policy):
    """Two synchronous replicas carved from a mesh of four route, answer
    and count as the reference router's two unsharded replicas."""
    b, idx = pair
    kw = dict(n_replicas=2, policy=policy, threaded=False, max_batch=4,
              max_wait_s=0.0)
    ref = RefRouter(b.index, **kw)
    port = ReplicaRouter(idx, mesh=make_test_mesh(4, device="cpu"), **kw)
    assert_same(_route_all(ref, RefRequest, b.queries),
                _route_all(port, SearchRequest, b.queries))
    rroll, proll = ref.stats_rollup(), port.stats_rollup()
    for key in ("submitted", "routed", "requests", "batches", "served",
                "query_stats"):
        assert proll[key] == rroll[key], key
    for r in (ref, port):
        r.stop()


def _groups(router):
    return [m.ids.ravel().tolist() for m in router.meshes]


def test_mesh_router_recarves_on_resize(pair):
    """``ReplicaRouter(mesh=make_test_mesh(4))``: groups [0, 1] and
    [2, 3]; ``add_replica`` re-carves to [0, 1], [2], [3] and re-attaches
    the survivors; ``remove_replica`` under load carves back to two
    groups and loses no future.  Every answer is the reference's."""
    b, idx = pair
    router = ReplicaRouter(idx, n_replicas=2, policy="jsq",
                           mesh=make_test_mesh(4, device="cpu"),
                           threaded=True, max_batch=4, max_wait_s=0.001)
    try:
        assert _groups(router) == [[0, 1], [2, 3]]
        assert [r.executor._n_shards() for r in router.replicas] == [2, 2]
        futs = [router.submit(SearchRequest(query=q)) for q in b.queries]
        router.add_replica()
        assert _groups(router) == [[0, 1], [2], [3]]
        assert [r.executor.ctx.mesh.ids.ravel().tolist()
                for r in router.replicas] == [[0, 1], [2], [3]]
        futs += [router.submit(SearchRequest(query=q))
                 for q in np.concatenate([b.queries] * 2)]
        router.remove_replica()
        assert _groups(router) == [[0, 1], [2, 3]]
        assert [r.executor._n_shards() for r in router.replicas] == [2, 2]
        futs += [router.submit(SearchRequest(query=q)) for q in b.queries]
        got = [f.result(timeout=120) for f in futs]
    finally:
        router.stop()
    assert all(f.done() and not f.cancelled() for f in futs)
    want = b.index.batch_query(np.concatenate([b.queries] * 4))
    assert_same(want, got, counters=PER_QUERY)
    assert router.stats_rollup()["served"] == len(futs)


def test_hydrated_replica_attaches_to_its_group(pair, tmp_path):
    """A replica hydrated from a snapshot joins the carve: its own index,
    the last group of the re-carved mesh, the donor's answers."""
    b, idx = pair
    router = ReplicaRouter(idx, n_replicas=1,
                           mesh=make_test_mesh(2, device="cpu"),
                           threaded=False, snapshot_dir=str(tmp_path),
                           max_batch=4, max_wait_s=0.0)
    router.add_replica()
    new = router.replicas[1]
    assert new.index is not idx and new.index.device.type == "cpu"
    assert new.executor.ctx.mesh.ids.ravel().tolist() == [1]
    assert router.replicas[0].executor.ctx.mesh.ids.ravel().tolist() == [0]
    got = new.executor.run(b.queries, new.index.plan())
    assert_same(b.index.executor.run(b.queries, b.index.plan()), got)
    router.stop()


def test_router_snapshot_loads_in_reference(anns_bundle, snapshot,
                                            tmp_path):
    """The snapshot a port router writes to hydrate a replica loads in
    the JAX package and answers as the index it was taken from."""
    b = anns_bundle
    router = ReplicaRouter(load_port(snapshot), n_replicas=1,
                           threaded=False, snapshot_dir=str(tmp_path))
    router.add_replica()
    back = RefIndex.load_snapshot(str(tmp_path))
    assert_same(b.index.batch_query(b.queries[:5]),
                back.batch_query(b.queries[:5]))
    router.stop()
