"""Port parity, multi-tenant serving: the port's ``WeightedFairScheduler``
against the reference's on the same seeded push/take sequences (the same
entries in the same order), ``ReplicaGroup`` against the reference's
under the same churn (equal counters; every replica byte-identical to a
from-scratch snapshot, in storage of its own, the engine's older
snapshots untouched), and the cases of ``tests/test_multitenant.py`` on
the port: weighted fairness, priority bands, deadlines, streaming
delivery.  Tolerance 0; every wait has a timeout and every threaded
service is closed in a ``finally``.

A replica is a private copy of the snapshot landed on the group's mesh
(``default_line_graph_mesh()`` on the engine's device unless one is
given, as in the reference); the reference's replica cases on that mesh
run here on the default mesh and on a logical 2 x 2 grid."""
import dataclasses
import time
import warnings
from concurrent.futures import Future

import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro.serve.scheduler as ref_sched
import repro_torch.api as port_api
import repro_torch.serve as port_serve
from repro_torch.core.baselines import MSTOracle
from repro_torch.core.hypergraph import random_hypergraph
from repro_torch.core.query import DeviceSnapshot
from repro_torch.serve.scheduler import WeightedFairScheduler, _Entry

from util_torch_port import port_hypergraph, snapshot_arrays

TIMEOUT = 60


def _entry(req, expiry=None, now=0.0):
    return _Entry(req, Future(), now, expiry)


def _oracle_check(h, reqs, futs):
    oracle = MSTOracle(h)
    for r, f in zip(reqs, futs):
        mr = oracle.mr(r.u, r.v)
        want = mr if r.kind == "mr" else mr >= r.s
        got = f.result(timeout=TIMEOUT)
        assert got == want and type(got) is type(want)


def _serve(h, **kw):
    return port_api.serve(h, "hl-index", device="cpu", **kw)


# ---------------------------------------------------------------------------
# the scheduler, side by side with the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_scheduler_decisions_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    weights = {"a": 1.0, "b": 2.5, "c": 4.0}
    quantum = int(rng.integers(1, 10))
    ref = ref_sched.WeightedFairScheduler(
        tuple(ref_sched.TenantSpec(t, w) for t, w in weights.items()),
        default_weight=1.5, quantum=quantum)
    port = WeightedFairScheduler(
        tuple(port_api.TenantSpec(t, w) for t, w in weights.items()),
        default_weight=1.5, quantum=quantum)
    tenants = ["a", "b", "c", "d"]            # "d" takes the default weight
    prios = ["interactive", "standard", "batch"]
    now, serial = 0.0, 0
    for _ in range(30):
        for _ in range(int(rng.integers(0, 60))):
            tenant = tenants[int(rng.integers(len(tenants)))]
            prio = prios[int(rng.integers(len(prios)))]
            expiry = (now + float(rng.uniform(0.0, 3.0))
                      if rng.random() < 0.2 else None)
            ref.push(ref_sched._Entry(
                ref_api.MRRequest(serial, 0, tenant=tenant, priority=prio),
                Future(), now, expiry))
            port.push(_Entry(
                port_api.MRRequest(serial, 0, tenant=tenant, priority=prio),
                Future(), now, expiry))
            serial += 1
        now += float(rng.uniform(0.0, 1.0))
        limit = int(rng.integers(0, 40))
        ref_sel, ref_exp = ref.take(limit, now)
        port_sel, port_exp = port.take(limit, now)
        assert [e.request.u for e in port_sel] == \
            [e.request.u for e in ref_sel]
        assert [e.request.u for e in port_exp] == \
            [e.request.u for e in ref_exp]
        assert len(port) == len(ref)
        assert port.backlog() == ref.backlog()
        assert port._deficit == ref._deficit


def test_scheduler_weighted_shares_exact():
    sched = WeightedFairScheduler((port_api.TenantSpec("a", 1.0),
                                   port_api.TenantSpec("b", 3.0)), quantum=8)
    for _ in range(100):
        sched.push(_entry(port_api.MRRequest(0, 1, tenant="a")))
        sched.push(_entry(port_api.MRRequest(0, 1, tenant="b")))
    selected, expired = sched.take(64, now=0.0)
    assert not expired and len(selected) == 64
    counts = {}
    for e in selected:
        counts[e.request.tenant] = counts.get(e.request.tenant, 0) + 1
    assert counts == {"a": 16, "b": 48}
    assert len(sched) == 136
    assert sched.backlog() == {"a": 84, "b": 52}


def test_scheduler_priority_bands_strict():
    sched = WeightedFairScheduler()
    for prio, tenant, count in (("batch", "g", 50), ("standard", "s", 5),
                                ("interactive", "i", 3)):
        for _ in range(count):
            sched.push(_entry(port_api.MRRequest(0, 1, tenant=tenant,
                                                 priority=prio)))
    selected, _ = sched.take(32, now=0.0)
    prios = [e.request.priority for e in selected]
    assert prios[:3] == ["interactive"] * 3
    assert prios[3:8] == ["standard"] * 5
    assert prios[8:] == ["batch"] * 24


def test_scheduler_expired_swept_without_consuming_share():
    sched = WeightedFairScheduler()
    for _ in range(10):
        sched.push(_entry(port_api.MRRequest(0, 1, tenant="a"), expiry=1.0))
    for _ in range(10):
        sched.push(_entry(port_api.MRRequest(0, 1, tenant="a")))
    selected, expired = sched.take(64, now=2.0)
    assert len(expired) == 10 and len(selected) == 10
    assert all(e.expiry == 1.0 for e in expired)
    assert len(sched) == 0


# ---------------------------------------------------------------------------
# typed config / request surface
# ---------------------------------------------------------------------------

def test_tenant_spec_validation():
    spec = port_api.TenantSpec("analytics", 3)
    assert spec.weight == 3.0 and isinstance(spec.weight, float)
    with pytest.raises(ValueError, match="non-empty"):
        port_api.TenantSpec("")
    with pytest.raises(ValueError, match="weight"):
        port_api.TenantSpec("x", 0.0)
    with pytest.raises(ValueError, match="weight"):
        port_api.TenantSpec("x", -1.0)
    with pytest.raises(dataclasses.FrozenInstanceError):
        spec.weight = 2.0


def test_service_config_validation():
    cfg = port_api.ServiceConfig(max_batch="64", min_bucket=4.0)
    assert cfg.max_batch == 64 and cfg.min_bucket == 4
    with pytest.raises(ValueError, match="min_bucket"):
        port_api.ServiceConfig(min_bucket=64, max_batch=8)
    with pytest.raises(ValueError, match="replicas"):
        port_api.ServiceConfig(replicas=0)
    with pytest.raises(ValueError, match="quantum"):
        port_api.ServiceConfig(quantum=0)
    with pytest.raises(ValueError, match="default_weight"):
        port_api.ServiceConfig(default_weight=0)
    with pytest.raises(TypeError, match="TenantSpec"):
        port_api.ServiceConfig(tenants=("not-a-spec",))
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.max_batch = 128


def test_request_base_defaults():
    r = port_api.MRRequest(4, 8)
    assert (r.u, r.v) == (4, 8)
    assert r.tenant == "default" and r.priority == "standard"
    assert r.deadline_ms is None
    assert r == port_api.MRRequest(4, 8, tenant="default",
                                   priority="standard", deadline_ms=None)
    s = port_api.SReachRequest(4, 8, 2)
    assert (s.u, s.v, s.s) == (4, 8, 2)
    assert isinstance(r, port_api.Request) and isinstance(s, port_api.Request)
    r2 = dataclasses.replace(r, tenant="t", priority="interactive")
    assert (r2.u, r2.v, r2.tenant, r2.priority) == (4, 8, "t", "interactive")
    assert {f.name for f in dataclasses.fields(port_api.Request)} == \
        {f.name for f in dataclasses.fields(ref_api.Request)} == \
        {"tenant", "priority", "deadline_ms"}


def test_submit_validates_metadata():
    h = random_hypergraph(20, 25, seed=0)
    svc = _serve(h, start=False)
    with pytest.raises(ValueError, match="priority"):
        svc.submit(port_api.MRRequest(1, 2, priority="urgent"))
    with pytest.raises(ValueError, match="tenant"):
        svc.submit(port_api.MRRequest(1, 2, tenant=""))
    with pytest.raises(ValueError, match="deadline_ms"):
        svc.submit(port_api.MRRequest(1, 2, deadline_ms=0))
    with pytest.raises(ValueError, match="deadline_ms"):
        svc.submit(port_api.MRRequest(1, 2, deadline_ms=-5.0))
    assert svc.pending() == 0


# ---------------------------------------------------------------------------
# adversarial fairness through the service
# ---------------------------------------------------------------------------

def test_flooding_tenant_cannot_starve_light_tenant():
    h = random_hypergraph(40, 60, seed=1)
    cfg = port_api.ServiceConfig(
        max_batch=64, tenants=(port_api.TenantSpec("greedy", 1.0),
                               port_api.TenantSpec("light", 1.0)))
    svc = _serve(h, config=cfg, start=False)
    rng = np.random.default_rng(0)
    flood = [port_api.MRRequest(int(rng.integers(h.n)),
                                int(rng.integers(h.n)), tenant="greedy")
             for _ in range(2000)]
    greedy_futs = svc.submit_many(flood)
    light = [port_api.MRRequest(int(rng.integers(h.n)),
                                int(rng.integers(h.n)), tenant="light")
             for _ in range(5)]
    light_futs = svc.submit_many(light)
    svc.drain(max_batches=1)
    assert all(f.done() for f in light_futs)
    _oracle_check(h, light, light_futs)
    svc.drain()
    _oracle_check(h, flood, greedy_futs)
    st = svc.stats()
    assert st.tenant_answered == {"greedy": 2000, "light": 5}
    assert st.expired == 0


def test_weighted_shares_shape_every_batch():
    h = random_hypergraph(40, 60, seed=2)
    cfg = port_api.ServiceConfig(
        max_batch=64, quantum=8, tenants=(port_api.TenantSpec("a", 1.0),
                                          port_api.TenantSpec("b", 3.0)))
    svc = _serve(h, config=cfg, start=False)
    rng = np.random.default_rng(1)
    for _ in range(600):
        for tenant in ("a", "b"):
            svc.submit(port_api.MRRequest(int(rng.integers(h.n)),
                                          int(rng.integers(h.n)),
                                          tenant=tenant))
    prev = {"a": 0, "b": 0}
    for _ in range(5):
        svc.drain(max_batches=1)
        st = svc.stats()
        got = {t: st.tenant_answered[t] - prev[t] for t in ("a", "b")}
        assert got == {"a": 16, "b": 48}
        prev = dict(st.tenant_answered)
    svc.drain()
    assert svc.stats().tenant_answered == {"a": 600, "b": 600}


def test_priority_inversion_bounded():
    h = random_hypergraph(40, 60, seed=3)
    svc = _serve(h, config=port_api.ServiceConfig(max_batch=64), start=False)
    rng = np.random.default_rng(2)
    flood = [port_api.MRRequest(int(rng.integers(h.n)),
                                int(rng.integers(h.n)), tenant="greedy",
                                priority="batch") for _ in range(500)]
    svc.submit_many(flood)
    probe = port_api.MRRequest(3, 7, tenant="dash", priority="interactive")
    probe_fut = svc.submit(probe)
    svc.drain(max_batches=1)
    assert probe_fut.done()
    _oracle_check(h, [probe], [probe_fut])
    svc.drain()


# ---------------------------------------------------------------------------
# deadlines and delivery
# ---------------------------------------------------------------------------

def test_deadline_expiry_fails_fast_with_typed_error():
    h = random_hypergraph(30, 40, seed=4)
    svc = _serve(h, start=False)
    doomed = port_api.MRRequest(1, 2, deadline_ms=1.0)
    doomed_fut = svc.submit(doomed)
    live = port_api.MRRequest(3, 4)
    live_fut = svc.submit(live)
    time.sleep(0.02)
    assert svc.drain() == 2
    with pytest.raises(port_api.DeadlineExceeded) as err:
        doomed_fut.result(timeout=0)
    assert err.value.request is doomed
    assert err.value.waited_ms >= 1.0
    _oracle_check(h, [live], [live_fut])
    st = svc.stats()
    assert st.expired == 1 and st.tenant_expired == {"default": 1}
    assert st.tenant_answered == {"default": 1}


def test_generous_deadline_is_met():
    h = random_hypergraph(30, 40, seed=5)
    svc = _serve(h, start=False)
    reqs = [port_api.MRRequest(i, i + 1, deadline_ms=60_000.0)
            for i in range(10)]
    futs = svc.submit_many(reqs)
    svc.drain()
    _oracle_check(h, reqs, futs)
    assert svc.stats().expired == 0


def test_submit_stream_yields_resolved_futures_sync():
    h = random_hypergraph(30, 40, seed=6)
    svc = _serve(h, start=False)
    reqs = [port_api.MRRequest(i, (i * 3) % h.n) if i % 2 else
            port_api.SReachRequest(i, (i * 3) % h.n, 2) for i in range(20)]
    got = list(svc.submit_stream(reqs))
    assert len(got) == 20 and all(f.done() for _, f in got)
    by_req = {id(r): f for r, f in got}
    _oracle_check(h, reqs, [by_req[id(r)] for r in reqs])


def test_submit_stream_threaded_completion_order():
    h = random_hypergraph(30, 40, seed=7)
    svc = _serve(h, config=port_api.ServiceConfig(max_wait_ms=1.0))
    try:
        reqs = [port_api.MRRequest(i, (i * 7) % h.n) for i in range(30)]
        got = list(svc.submit_stream(reqs))
    finally:
        svc.close()
    assert sorted(id(r) for r, _ in got) == sorted(id(r) for r in reqs)
    by_req = {id(r): f for r, f in got}
    _oracle_check(h, reqs, [by_req[id(r)] for r in reqs])


def test_on_result_callback_hook():
    h = random_hypergraph(30, 40, seed=8)
    svc = _serve(h, start=False)
    seen = []
    reqs = [port_api.MRRequest(i, i + 2) for i in range(8)]
    futs = [svc.submit(r, on_result=lambda rq, f: seen.append((rq, f)))
            for r in reqs]
    svc.drain()
    assert len(seen) == 8
    assert {id(r) for r, _ in seen} == {id(r) for r in reqs}
    _oracle_check(h, reqs, futs)
    failed = []
    svc.submit(port_api.MRRequest(0, 1, deadline_ms=1.0),
               on_result=lambda rq, f: failed.append(f))
    time.sleep(0.01)
    svc.drain()
    assert len(failed) == 1 and isinstance(failed[0].exception(timeout=0),
                                           port_api.DeadlineExceeded)


# ---------------------------------------------------------------------------
# replica fan-out
# ---------------------------------------------------------------------------

def _chains_graph(mod):
    edges = [[0, 1, 2], [1, 2, 3],            # chain A
             [10, 11, 12], [11, 12, 13]]      # chain B
    for i in range(10):                        # chain C dominates lmax
        edges.append([20 + 2 * i, 21 + 2 * i, 22 + 2 * i, 23 + 2 * i])
    return mod.from_edge_lists(edges)


def snapshot_arrays_t(snap):
    return snap.ranks, snap.svals, snap.lengths


def _assert_replicas_current(grp):
    """Every replica equals a from-scratch snapshot of the engine's index,
    byte for byte, in storage of its own."""
    eng = grp.engine
    fresh = DeviceSnapshot.from_hlindex(eng.idx, device="cpu")
    cached = eng.snapshot_cache()
    ptrs = set()
    for r in grp.replicas:
        assert r.snap is not None and r.snap.version == eng.version
        for f in ("ranks", "svals", "lengths"):
            t = getattr(r.snap, f)
            assert torch.equal(t, getattr(fresh, f)), f
            assert t.data_ptr() != getattr(cached, f).data_ptr()
            ptrs.add(t.data_ptr())
    assert len(ptrs) == 3 * len(grp.replicas)


def test_replica_group_churn_stays_byte_identical_and_private():
    h = _chains_graph(port_api)
    eng = port_api.build_engine(h, "hl-index", device="cpu")
    grp = port_api.ReplicaGroup(eng, 3,
                                config=port_api.ServiceConfig(max_batch=32),
                                start=False)
    rng = np.random.default_rng(3)
    edits = [[[0, 1, 2, 3]], [[10, 11, 12, 13]], [[0, 2, 3]], [[11, 13]]]
    held = []                # (snapshot, its bytes) as the engine had them
    for ins in edits:
        cur = grp.engine.h
        reqs = [port_api.MRRequest(int(rng.integers(cur.n)),
                                   int(rng.integers(cur.n)))
                for _ in range(80)]
        futs = grp.submit_many(reqs)
        grp.drain()
        _oracle_check(cur, reqs, futs)
        _assert_replicas_current(grp)
        snap = eng.snapshot_cache()
        held.append((snap, [t.clone() for t in snapshot_arrays_t(snap)]))
        grp.update(inserts=ins)
    cur = grp.engine.h
    reqs = [port_api.MRRequest(int(rng.integers(cur.n)),
                               int(rng.integers(cur.n))) for _ in range(80)]
    futs = grp.submit_many(reqs)
    grp.drain()
    _oracle_check(cur, reqs, futs)
    _assert_replicas_current(grp)
    # the engine's snapshots of earlier versions were never written
    for snap, kept in held:
        for a, b in zip(snapshot_arrays_t(snap), kept):
            assert torch.equal(a, b)
    rstats = grp.replica_stats()
    assert all(r["batches"] >= 1 for r in rstats)
    assert all(r["full_relands"] == 1 for r in rstats)
    assert all(r["rows_patched"] > 0 for r in rstats)
    assert grp.stats().mesh_rows_patched == sum(r["rows_patched"]
                                                for r in rstats)


@pytest.mark.parametrize("shape", [None, (2, 2)], ids=["default", "2x2"])
def test_replica_group_churn_on_default_line_graph_mesh(shape):
    """``tests/test_multitenant.py``'s churn case with
    ``mesh=default_line_graph_mesh()`` (and on a 2 x 2 grid): the replicas
    sit on that mesh, equal the engine's fresh snapshot landed there byte
    for byte after every update, in storage of their own, and take the
    updates as row patches after one full landing each."""
    h = _chains_graph(port_api)
    eng = port_api.build_engine(h, "hl-index", device="cpu")
    mesh = (port_api.default_line_graph_mesh(device="cpu") if shape is None
            else port_api.make_mesh(shape, ("data", "model"), device="cpu"))
    grp = port_api.ReplicaGroup(eng, 3, mesh=mesh,
                                config=port_api.ServiceConfig(max_batch=32),
                                start=False)
    if shape is None:
        assert grp.mesh == port_api.ReplicaGroup(
            eng, 2, start=False).mesh == mesh
        assert mesh.shape["data"] == mesh.shape["model"] == 1
    rng = np.random.default_rng(3)
    edits = [[[0, 1, 2, 3]], [[10, 11, 12, 13]], [[0, 2, 3]], [[11, 13]]]
    for ins in edits + [None]:
        cur = grp.engine.h
        reqs = [port_api.MRRequest(int(rng.integers(cur.n)),
                                   int(rng.integers(cur.n)))
                for _ in range(80)]
        futs = grp.submit_many(reqs)
        grp.drain()
        _oracle_check(cur, reqs, futs)
        want = DeviceSnapshot.from_hlindex(eng.idx, device="cpu").to_mesh(mesh)
        ptrs = set()
        for r in grp.replicas:
            assert r.snap.mesh == mesh and r.snap.version == eng.version
            for f in ("ranks", "svals", "lengths"):
                assert torch.equal(getattr(r.snap, f), getattr(want, f)), f
                ptrs.add(getattr(r.snap, f).data_ptr())
        assert len(ptrs) == 3 * len(grp.replicas)
        if ins is not None:
            grp.update(inserts=ins)
    rstats = grp.replica_stats()
    assert all(r["full_relands"] == 1 for r in rstats)
    assert all(r["rows_patched"] > 0 for r in rstats)
    assert grp.stats().mesh_rows_patched == sum(r["rows_patched"]
                                                for r in rstats)


def test_replica_group_counters_equal_the_reference():
    ref_h = _chains_graph(ref_api)
    ref_eng = ref_api.build_engine(ref_h, "hl-index")
    port_eng = port_api.build_engine(port_hypergraph(ref_h), "hl-index",
                                     device="cpu")
    ref_grp = ref_api.ReplicaGroup(ref_eng, 2, start=False,
                                   config=ref_api.ServiceConfig(max_batch=16))
    port_grp = port_api.ReplicaGroup(
        port_eng, 2, start=False,
        config=port_api.ServiceConfig(max_batch=16, use_kernels=True))
    rng = np.random.default_rng(4)
    edits = [([[0, 1, 2, 3]], []), ([], []), ([[10, 11, 12, 13]], [0]),
             ([[20, 40, 41, 42, 43, 44, 45]], []), ([[1, 2]], [])]
    for ins, dels in edits:
        n = port_eng.h.n
        pairs = [(int(rng.integers(n)), int(rng.integers(n)))
                 for _ in range(40)]
        rf = ref_grp.submit_many([ref_api.MRRequest(u, v) for u, v in pairs])
        pf = port_grp.submit_many([port_api.MRRequest(u, v)
                                   for u, v in pairs])
        ref_grp.drain()
        port_grp.drain()
        assert [f.result(timeout=0) for f in pf] == \
            [f.result(timeout=0) for f in rf]
        for rr, pr in zip(ref_grp.replicas, port_grp.replicas):
            for a, b in zip(snapshot_arrays(rr.snap),
                            snapshot_arrays(pr.snap)):
                np.testing.assert_array_equal(a, b)
        ref_grp.update(inserts=ins, deletes=dels)
        port_grp.update(inserts=ins, deletes=dels)
    assert port_grp.replica_stats() == ref_grp.replica_stats()
    ref_stats, port_stats = ref_grp.stats().as_dict(), \
        port_grp.stats().as_dict()
    assert port_stats.pop("kernel_batches") == port_stats["batches"]
    ref_stats.pop("kernel_batches")
    assert port_stats == ref_stats
    rstats = port_grp.replica_stats()
    assert all(r["full_relands"] >= 2 for r in rstats)   # lmax grew once
    assert all(r["rows_patched"] > 0 for r in rstats)


def test_replica_group_kernel_serving_matches_oracle():
    h = random_hypergraph(40, 60, seed=10)
    eng = port_api.build_engine(h, "hl-index", device="cpu")
    grp = port_api.ReplicaGroup(eng, 2, config=port_api.ServiceConfig(
        use_kernels=True, max_batch=32), start=False)
    rng = np.random.default_rng(4)
    reqs = [port_api.SReachRequest(int(rng.integers(h.n)),
                                   int(rng.integers(h.n)),
                                   int(rng.integers(1, 4)))
            for _ in range(64)]
    futs = grp.submit_many(reqs)
    grp.drain()
    _oracle_check(h, reqs, futs)
    assert grp.stats().kernel_batches >= 1


def test_replica_group_with_an_external_snapshot_reader_stays_correct():
    # a direct engine.snapshot() between the group's refreshes resets the
    # engine's dirty set, so the delta no longer describes the copies:
    # the identity guard in snapshot_delta must force a full re-land
    # (the padded geometry stays constant: chain C pins lmax)
    h = _chains_graph(port_api)
    eng = port_api.build_engine(h, "hl-index", device="cpu")
    grp = port_api.ReplicaGroup(eng, 2, start=False)
    f = grp.mr(0, 1)
    grp.drain()
    f.result(timeout=0)
    grp.update(inserts=[[0, 1, 2, 3]])
    eng.snapshot()                             # external consumer
    grp.update(inserts=[[10, 11, 12, 13]])
    oracle = MSTOracle(eng.h)
    futs = [grp.mr(u, 3) for u in range(eng.h.n)]
    grp.drain()
    for u, fut in enumerate(futs):
        assert fut.result(timeout=0) == oracle.mr(u, 3), u
    assert all(r["full_relands"] == 2 for r in grp.replica_stats())
    _assert_replicas_current(grp)


def test_replica_group_threaded():
    h = random_hypergraph(30, 45, seed=12)
    eng = port_api.build_engine(h, "hl-index", device="cpu")
    grp = port_api.ReplicaGroup(eng, 2, config=port_api.ServiceConfig(
        max_wait_ms=1.0, use_kernels=True))
    try:
        reqs = [port_api.MRRequest(i % h.n, (i * 5) % h.n)
                for i in range(60)]
        futs = grp.submit_many(reqs)
        _oracle_check(h, reqs, futs)
    finally:
        grp.close()


def test_replica_group_refuses_snapshotless_backend():
    h = random_hypergraph(25, 35, seed=11)
    eng = port_api.build_engine(h, "mst-oracle", device="cpu")
    with pytest.raises(port_api.SnapshotUnsupported, match="replica"):
        port_api.ReplicaGroup(eng, 2, start=False)


def test_plain_service_refuses_replicated_config():
    h = random_hypergraph(25, 35, seed=12)
    eng = port_api.build_engine(h, "hl-index", device="cpu")
    with pytest.raises(ValueError, match="ReplicaGroup"):
        port_api.ReachabilityService(
            eng, config=port_api.ServiceConfig(replicas=2), start=False)


def test_serve_routes_replicated_config_to_group():
    h = random_hypergraph(30, 45, seed=13)
    svc = _serve(h, config=port_api.ServiceConfig(replicas=2), start=False)
    assert isinstance(svc, port_api.ReplicaGroup) and len(svc.replicas) == 2
    reqs = [port_api.MRRequest(i % h.n, (i * 5) % h.n) for i in range(40)]
    futs = svc.submit_many(reqs)
    svc.drain()
    _oracle_check(h, reqs, futs)


# ---------------------------------------------------------------------------
# facade: deprecation shim + re-exports
# ---------------------------------------------------------------------------

def test_serve_legacy_kwargs_warn_and_still_work():
    h = random_hypergraph(25, 35, seed=14)
    with pytest.warns(DeprecationWarning, match="ServiceConfig"):
        svc = _serve(h, start=False, max_batch=32, min_bucket=4)
    assert svc.max_batch == 32 and svc.min_bucket == 4
    f = svc.mr(1, 2)
    svc.drain()
    assert f.result(timeout=0) == MSTOracle(h).mr(1, 2)
    with pytest.warns(DeprecationWarning):
        svc2 = _serve(h, start=False,
                      config=port_api.ServiceConfig(max_batch=128),
                      max_batch=16)
    assert svc2.max_batch == 16


def test_config_path_does_not_warn():
    h = random_hypergraph(25, 35, seed=15)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        svc = _serve(h, start=False,
                     config=port_api.ServiceConfig(max_batch=32))
    assert svc.max_batch == 32


def test_api_reexports_cover_the_reference_serving_surface():
    serving = ("Request", "MRRequest", "SReachRequest", "WitnessRequest",
               "SReachKRequest", "MRSetRequest", "TopSRequest",
               "SDistanceRequest", "ServiceConfig", "TenantSpec",
               "PRIORITY_CLASSES", "DeadlineExceeded", "ReplicaGroup",
               "ReachabilityService", "serve", "update_capabilities")
    for name in serving:
        assert name in ref_api.__all__
        assert name in port_api.__all__ and getattr(port_api, name) is not None
    assert port_serve.WeightedFairScheduler is WeightedFairScheduler
    assert port_serve.PRIORITY_CLASSES == ref_sched.PRIORITY_CLASSES == {
        "interactive": 0, "standard": 1, "batch": 2}
    # the LM serving drivers are exported too, as in the reference
    assert sorted(port_serve.__all__) == sorted(
        __import__("repro.serve", fromlist=["__all__"]).__all__)
    for name in ("make_serve_step", "make_prefill_step",
                 "prefill_with_decode", "greedy_decode"):
        assert callable(getattr(port_serve, name))
    with pytest.raises(AttributeError):
        port_serve.no_such_export
