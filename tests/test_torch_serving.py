"""Port parity, the request service: ``repro_torch.api.serve`` on
``device="cpu"`` against ``repro.api.serve`` under the same requests and
the same update sequence (the twin-service test: answers equal in value
and type, ``stats()`` equal field by field), and the cases of
``tests/test_serving.py`` on the port, answers pinned to the port's
``MSTOracle``.  Tolerance 0 everywhere: answers are exact integers and
booleans.  Every wait on a future has a timeout, and every service with
an admission thread is closed in a ``finally``.

The reference's mesh cases (mesh-resident snapshots and their row
re-lands, the ``sharded`` backend's own mesh snapshot) run on logical
meshes (``repro_torch.core.mesh``); twin mesh services compare
``stats()`` field by field, ``mesh_rows_patched`` included."""
import dataclasses
import sys
import threading
import time

import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro.serve.reach_service as ref_rs
import repro_torch.api as port_api
import repro_torch.serve.reach_service as port_rs
from repro_torch.core.baselines import MSTOracle
from repro_torch.core.engine import validate_batch
from repro_torch.core.hypergraph import (apply_edge_edits,
                                         planted_chain_hypergraph,
                                         random_hypergraph)
from repro_torch.core.query import DeviceSnapshot, KernelSnapshot
from repro_torch.kernels import build as build_mod
from repro_torch.kernels import label_join as lj

from util_torch_port import port_hypergraph

TIMEOUT = 60


def _serve(h, backend="hl-index", **kw):
    return port_api.serve(h, backend, device="cpu", **kw)


def _mixed_requests(h, rng, count, api=port_api):
    reqs, answer = [], []
    oracle = MSTOracle(h)
    for _ in range(count):
        u, v = int(rng.integers(h.n)), int(rng.integers(h.n))
        mr = oracle.mr(u, v)
        if rng.random() < 0.5:
            reqs.append(api.MRRequest(u, v))
            answer.append(mr)
        else:
            s = int(rng.integers(1, 5))
            reqs.append(api.SReachRequest(u, v, s))
            answer.append(mr >= s)
    return reqs, answer


def _results(futs):
    return [f.result(timeout=TIMEOUT) for f in futs]


def _random_edits(h, rng):
    ins, dels = [], []
    if h.m > 2 and rng.random() < 0.6:
        dels = [int(rng.integers(h.m))]
    if rng.random() < 0.8:
        ins = [[int(x) for x in rng.choice(h.n + 1, size=3, replace=False)]]
    return ins, dels


# ---------------------------------------------------------------------------
# the twin service: the reference and the port, same requests, same updates
# ---------------------------------------------------------------------------

def _twin_requests(n, rng, count):
    """(kind, u, v, s, tenant, priority) specs both packages can build."""
    specs = []
    for _ in range(count):
        u, v = int(rng.integers(n)), int(rng.integers(n))
        tenant = ("a", "b", "c")[int(rng.integers(3))]
        prio = ("interactive", "standard", "batch")[int(rng.integers(3))]
        if rng.random() < 0.5:
            specs.append(("mr", u, v, None, tenant, prio))
        else:
            specs.append(("s_reach", u, v, int(rng.integers(1, 6)), tenant,
                          prio))
    return specs


def _build(api, spec):
    kind, u, v, s, tenant, prio = spec
    if kind == "mr":
        return api.MRRequest(u, v, tenant=tenant, priority=prio)
    return api.SReachRequest(u, v, s, tenant=tenant, priority=prio)


TWINS = [("hl-index", True), ("hl-index", False), ("hl-index-basic", True),
         ("closure", True), ("closure", False), ("sharded", True),
         ("sharded", False)]


@pytest.mark.parametrize("backend,use_kernels", TWINS,
                         ids=[f"{b}-{'kernels' if k else 'ops'}"
                              for b, k in TWINS])
def test_twin_service_answers_and_stats_equal_the_reference(backend,
                                                            use_kernels):
    ref_h = ref_api.random_hypergraph(20, 16, seed=8)
    port_h = port_hypergraph(ref_h)
    tenants = (ref_api.TenantSpec("a", 1.0), ref_api.TenantSpec("b", 2.0))
    port_tenants = tuple(port_api.TenantSpec(t.name, t.weight)
                         for t in tenants)
    ref_cfg = ref_api.ServiceConfig(max_batch=32, tenants=tenants)
    port_cfg = port_api.ServiceConfig(max_batch=32, tenants=port_tenants,
                                      use_kernels=use_kernels)
    if backend == "hl-index":
        # the facade builds the engine, use_kernels reaching both layers
        ref = ref_api.serve(ref_h, start=False, config=ref_cfg)
        port = port_api.serve(port_h, start=False, device="cpu",
                              config=port_cfg)
    else:
        ref = ref_api.serve(ref_api.build_engine(ref_h, backend),
                            start=False, config=ref_cfg)
        port = port_api.serve(
            port_api.build_engine(port_h, backend, device="cpu"),
            start=False, config=port_cfg)
    assert port.engine.name == ref.engine.name == backend
    assert port.use_kernels is use_kernels and ref.use_kernels is False
    rng = np.random.default_rng(11)
    for step in range(4):
        specs = _twin_requests(port.engine.h.n, rng, 90)
        rf = ref.submit_many([_build(ref_api, s) for s in specs])
        pf = port.submit_many([_build(port_api, s) for s in specs])
        # two micro-batches one at a time (their composition is the
        # scheduler's), then the rest
        assert port.drain(max_batches=2) == ref.drain(max_batches=2)
        ref.drain()
        port.drain()
        want, got = _results(rf), _results(pf)
        assert got == want
        assert [type(x) for x in got] == [type(x) for x in want]
        ins, dels = _random_edits(port.engine.h, rng)
        ref.update(inserts=ins, deletes=dels)
        port.update(inserts=ins, deletes=dels)
    ref_stats, port_stats = ref.stats().as_dict(), port.stats().as_dict()
    assert port_stats.pop("kernel_batches") == (port_stats["batches"]
                                                if use_kernels else 0)
    assert ref_stats.pop("kernel_batches") == 0
    assert port_stats == ref_stats
    assert port_stats["snapshot_refreshes"] == 4
    assert port_stats["updates"] == 4


MESH_TWINS = [("hl-index", {}), ("sharded", {}),
              ("sharded", {"build_labels": True})]


@pytest.mark.parametrize("backend,opts", MESH_TWINS,
                         ids=["hl-index", "sharded", "sharded-labels"])
def test_twin_mesh_services_stats_equal_the_reference(backend, opts):
    """Mesh-resident twins: the reference's service on its one-device
    mesh and the port's on a logical 1 x 1 mesh, fed the same requests
    across scoped updates, answer alike and count alike —
    ``mesh_rows_patched`` included (rows re-landed into the hl-index's
    mesh copy; none for ``sharded``, whose snapshot is already on the
    mesh)."""
    from repro.core.distributed import default_line_graph_mesh
    ref_mesh = default_line_graph_mesh()
    mesh = port_api.make_mesh((1, 1), ("data", "model"), device="cpu")
    ref_h = ref_api.planted_chain_hypergraph(4, 8, overlap=2, extra_size=2,
                                             seed=1)
    port_h = port_hypergraph(ref_h)
    ref = ref_api.serve(ref_h, backend, mesh=ref_mesh, start=False,
                        config=ref_api.ServiceConfig(max_batch=32), **opts)
    port = port_api.serve(port_h, backend, mesh=mesh, start=False,
                          config=port_api.ServiceConfig(max_batch=32),
                          **opts)
    rng = np.random.default_rng(17)
    for step in range(4):
        specs = _twin_requests(port.engine.h.n, rng, 60)
        rf = ref.submit_many([_build(ref_api, s) for s in specs])
        pf = port.submit_many([_build(port_api, s) for s in specs])
        ref.drain()
        port.drain()
        assert _results(pf) == _results(rf)
        assert port._snap.mesh == mesh
        v0 = int(port.engine.h.edge(step)[0])
        ins = [[v0, v0 + 1]]
        ref.update(inserts=ins)
        port.update(inserts=ins)
    ref_stats, port_stats = ref.stats().as_dict(), port.stats().as_dict()
    assert port_stats == ref_stats
    if backend == "hl-index":
        assert 0 < port_stats["mesh_rows_patched"]


def test_bucket_size_policy_equals_the_reference():
    for q in list(range(0, 70)) + [1000, 4095, 4096, 4097, 70_000]:
        for lo, hi in ((8, 4096), (1, 64), (16, 16), (8, 2048)):
            assert port_rs._bucket_size(q, lo, hi) == \
                ref_rs._bucket_size(q, lo, hi)
    assert port_rs._bucket_size(4097, 8, 4096) == 4097   # never truncates


def test_request_types_and_stats_fields_equal_the_reference():
    assert set(port_rs.REQUEST_TYPES) == set(ref_rs.REQUEST_TYPES) == {
        "mr", "s_reach", "witness", "s_reach_k", "mr_set", "top_s",
        "s_distance"}
    for kind, cls in port_rs.REQUEST_TYPES.items():
        assert cls.kind == kind
        ref_cls = ref_rs.REQUEST_TYPES[kind]
        assert cls.__name__ == ref_cls.__name__
        assert [f.name for f in dataclasses.fields(cls)] == \
            [f.name for f in dataclasses.fields(ref_cls)]
    for port_cls, ref_cls in ((port_rs.ServiceStats, ref_rs.ServiceStats),
                              (port_rs.ServiceConfig, ref_rs.ServiceConfig)):
        assert [(f.name, f.default) for f in dataclasses.fields(port_cls)] \
            == [(f.name, f.default) for f in dataclasses.fields(ref_cls)]
    req = port_api.MRRequest(1, 2)
    with pytest.raises(dataclasses.FrozenInstanceError):
        req.u = 3


# ---------------------------------------------------------------------------
# service lifecycle
# ---------------------------------------------------------------------------

def test_service_background_thread():
    h = random_hypergraph(25, 35, seed=11)
    rng = np.random.default_rng(0)
    reqs, want = _mixed_requests(h, rng, 120)
    svc = _serve(h, config=port_api.ServiceConfig(max_wait_ms=1.0))
    try:
        got = _results(svc.submit_many(reqs))
    finally:
        svc.close()
    assert got == want
    st = svc.stats()
    assert st.submitted == st.answered == 120
    assert st.batches >= 1


def test_close_answers_everything_submitted():
    h = random_hypergraph(20, 30, seed=5)
    svc = _serve(h, config=port_api.ServiceConfig(max_wait_ms=5.0))
    try:
        futs = [svc.mr(0, i % h.n) for i in range(50)]
    finally:
        svc.close()
    assert all(f.done() for f in futs)
    f = svc.mr(1, 2)                 # after close: the synchronous drain
    svc.drain()
    assert f.done()


def test_bucketing_bounds_dispatch_shapes():
    h = random_hypergraph(30, 45, seed=3)
    svc = _serve(h, start=False,
                 config=port_api.ServiceConfig(min_bucket=8, max_batch=64))
    rng = np.random.default_rng(1)
    oracle = MSTOracle(h)
    futs = []
    for q in (1, 3, 5, 9, 17, 33, 64, 64, 7):
        futs += [svc.mr(int(rng.integers(h.n)), int(rng.integers(h.n)))
                 for _ in range(q)]
        svc.drain()
    st = svc.stats()
    for bucket in st.bucket_histogram:
        assert bucket & (bucket - 1) == 0 and bucket >= 8
    assert len(st.bucket_histogram) <= 4
    assert st.padded_queries > 0
    for f in futs:
        assert isinstance(f.result(timeout=0), int)
    us = [int(rng.integers(h.n)) for _ in range(10)]
    vs = [int(rng.integers(h.n)) for _ in range(10)]
    fs = [svc.mr(u, v) for u, v in zip(us, vs)]
    svc.drain()
    for u, v, f in zip(us, vs, fs):
        assert f.result(timeout=0) == oracle.mr(u, v)


def test_admission_window_coalesces_trickle_arrivals():
    h = random_hypergraph(15, 20, seed=0)
    svc = _serve(h, config=port_api.ServiceConfig(max_wait_ms=400.0,
                                                  max_batch=64))
    try:
        futs = []
        for _ in range(10):
            futs.append(svc.mr(0, 1))
            time.sleep(0.02)
        _results(futs)
    finally:
        svc.close()
    assert svc.stats().batches <= 3


# ---------------------------------------------------------------------------
# snapshot lifecycle under churn
# ---------------------------------------------------------------------------

def test_service_update_churn_matches_oracle():
    rng = np.random.default_rng(9)
    h = random_hypergraph(20, 16, seed=8)
    svc = _serve(h, start=False)
    for _ in range(4):
        ins, dels = _random_edits(h, rng)
        svc.update(inserts=ins, deletes=dels)
        h, _, _ = apply_edge_edits(h, ins, dels)
        reqs, want = _mixed_requests(h, rng, 40)
        futs = svc.submit_many(reqs)
        svc.drain()
        assert [f.result(timeout=0) for f in futs] == want
    assert svc.stats().snapshot_refreshes >= 1


@pytest.mark.parametrize("backend", ["hl-index", "sharded"])
def test_kernel_serving_byte_identical_under_churn(backend):
    rng = np.random.default_rng(11)
    h = random_hypergraph(20, 16, seed=8)
    host = _serve(h, backend, start=False)
    kern = _serve(h, backend, start=False,
                  config=port_api.ServiceConfig(use_kernels=True))
    assert kern.engine.use_kernels and not host.engine.use_kernels
    for _ in range(3):
        ins, dels = _random_edits(h, rng)
        host.update(inserts=ins, deletes=dels)
        kern.update(inserts=ins, deletes=dels)
        h, _, _ = apply_edge_edits(h, ins, dels)
        reqs, want = _mixed_requests(h, rng, 40)
        hf = host.submit_many(reqs)
        kf = kern.submit_many([dataclasses.replace(r) for r in reqs])
        host.drain()
        kern.drain()
        hres = [f.result(timeout=0) for f in hf]
        kres = [f.result(timeout=0) for f in kf]
        assert hres == want
        assert kres == hres
        assert [type(r) for r in kres] == [type(r) for r in hres]
    assert kern.stats().kernel_batches > 0
    assert host.stats().kernel_batches == 0


def _cpu_mesh(shape=(2, 2)):
    return port_api.make_mesh(shape, ("data", "model"), device="cpu")


def test_kernel_serving_mesh_reland_byte_identical():
    # a mesh-resident service re-lands the snapshot after each scoped
    # update, and the kernel view must be rebuilt over the re-landed copy
    # — twin services byte-identical at every step, on a 2 x 2 grid
    mesh = _cpu_mesh()
    h = planted_chain_hypergraph(4, 8, overlap=2, extra_size=2, seed=1)
    host = _serve(h, "hl-index", mesh=mesh, start=False)
    kern = _serve(h, "hl-index", mesh=mesh, start=False,
                  config=port_api.ServiceConfig(use_kernels=True))
    rng = np.random.default_rng(13)
    for step in range(3):
        v0 = int(h.edge(0)[0])
        ins = [[v0, v0 + 1, h.n + step]]
        host.update(inserts=ins)
        kern.update(inserts=ins)
        h, _, _ = apply_edge_edits(h, ins, [])
        reqs, want = _mixed_requests(h, rng, 30)
        hf = host.submit_many(reqs)
        kf = kern.submit_many([dataclasses.replace(r) for r in reqs])
        host.drain()
        kern.drain()
        hres = [f.result(timeout=0) for f in hf]
        kres = [f.result(timeout=0) for f in kf]
        assert hres == want
        assert kres == hres
        assert kern._snap.mesh == mesh
        assert kern._serving_view().base is kern._snap
    assert kern.stats().kernel_batches >= 3


def test_version_propagates_through_to_mesh_under_churn():
    # DeviceSnapshot.version survives to_mesh across interleaved updates;
    # a row re-land equals a full re-land byte for byte and never writes
    # its base unless the base is donated
    mesh = _cpu_mesh()
    h = planted_chain_hypergraph(3, 6, overlap=2, extra_size=2, seed=6)
    eng = port_api.build_engine(h, "hl-index", device="cpu")
    on_mesh = eng.snapshot().to_mesh(mesh)
    assert on_mesh.version == 0 and on_mesh.mesh == mesh
    for step in range(3):
        v0 = int(h.edge(0)[0])
        eng.update(inserts=[[v0, v0 + 1, h.n + step]])
        h, _, _ = apply_edge_edits(h, [[v0, v0 + 1, h.n + step]], [])
        assert on_mesh.version != eng.version      # old copy: stale
        dirty = eng.dirty_rows()
        fresh = eng.snapshot()
        before = [t.clone() for t in (on_mesh.ranks, on_mesh.svals,
                                      on_mesh.lengths)]
        new = fresh.to_mesh(mesh, base=on_mesh if dirty is not None
                            else None, dirty_rows=dirty)
        for t, b in zip((on_mesh.ranks, on_mesh.svals, on_mesh.lengths),
                        before):
            assert torch.equal(t, b)               # base not donated
        assert new.version == eng.version == step + 1
        full = fresh.to_mesh(mesh)
        for f in ("ranks", "svals", "lengths"):
            assert torch.equal(getattr(new, f), getattr(full, f))
        oracle = MSTOracle(h)
        rng = np.random.default_rng(step)
        us, vs = rng.integers(0, h.n, 20), rng.integers(0, h.n, 20)
        want = np.array([oracle.mr(int(u), int(v))
                         for u, v in zip(us, vs)], np.int64)
        np.testing.assert_array_equal(
            new.mr(us, vs).numpy().astype(np.int64), want)
        on_mesh = new


def test_mesh_resident_service_row_patches():
    mesh = _cpu_mesh()
    h = planted_chain_hypergraph(4, 8, overlap=2, extra_size=2, seed=1)
    svc = _serve(h, "hl-index", mesh=mesh, start=False)
    f = svc.mr(0, 1)
    svc.drain()
    f.result(timeout=0)
    landed = svc._snap
    v0 = int(h.edge(0)[0])
    svc.update(inserts=[[v0, v0 + 1]])
    h2, _, _ = apply_edge_edits(h, [[v0, v0 + 1]], [])
    oracle = MSTOracle(h2)
    rng = np.random.default_rng(3)
    us, vs = rng.integers(0, h2.n, 30), rng.integers(0, h2.n, 30)
    futs = [svc.mr(int(u), int(v)) for u, v in zip(us, vs)]
    svc.drain()
    for u, v, fut in zip(us, vs, futs):
        assert fut.result(timeout=0) == oracle.mr(int(u), int(v))
    st = svc.stats()
    assert 0 < st.mesh_rows_patched < h2.n
    # the service donated its own copy: the rows landed in place
    assert svc._snap.ranks.data_ptr() == landed.ranks.data_ptr()


def test_mesh_refresh_with_shared_engine_stays_correct():
    # a direct engine.snapshot() call between the service's refreshes
    # resets the engine's dirty set, so the delta no longer describes the
    # service's landed copy — the service must re-land in full (an
    # untouched long chain C pins lmax, so a naive patch would serve
    # stale rows)
    mesh = _cpu_mesh()
    edges = [[0, 1, 2], [1, 2, 3],            # chain A
             [10, 11, 12], [11, 12, 13]]      # chain B
    for i in range(10):                        # chain C dominates lmax
        edges.append([20 + 2 * i, 21 + 2 * i, 22 + 2 * i, 23 + 2 * i])
    h = port_api.from_edge_lists(edges)
    eng = port_api.build_engine(h, "hl-index", device="cpu")
    svc = port_api.serve(eng, mesh=mesh, start=False)
    f = svc.mr(0, 1)
    svc.drain()
    f.result(timeout=0)                        # mesh copy landed at v0
    ins1, ins2 = [[0, 1, 2, 3]], [[10, 11, 12, 13]]
    svc.update(inserts=ins1)                   # dirty = chain-A rows
    eng.snapshot()                             # external consumer: resets
    svc.update(inserts=ins2)                   # dirty = chain-B rows only
    h2, _, _ = apply_edge_edits(h, ins1, [])
    h3, _, _ = apply_edge_edits(h2, ins2, [])
    oracle = MSTOracle(h3)
    us = list(range(h3.n))
    vs = [3] * h3.n
    futs = [svc.mr(u, v) for u, v in zip(us, vs)]
    svc.drain()
    for u, v, fut in zip(us, vs, futs):
        assert fut.result(timeout=0) == oracle.mr(u, v), (u, v)


def test_mesh_service_on_sharded_backend_reuses_resident_snapshot():
    # the sharded backend's snapshot is already on the mesh; the service
    # serves it directly instead of re-landing a duplicate
    mesh = _cpu_mesh()
    h = random_hypergraph(30, 20, seed=6)
    svc = _serve(h, "sharded", mesh=mesh, start=False)
    f = svc.mr(0, 1)
    svc.drain()
    f.result(timeout=0)
    assert svc._snap is svc.engine.snapshot_cache()
    assert svc._snap.mesh == mesh
    oracle = MSTOracle(h)
    rng = np.random.default_rng(1)
    us, vs = rng.integers(0, h.n, 30), rng.integers(0, h.n, 30)
    futs = [svc.mr(int(u), int(v)) for u, v in zip(us, vs)]
    svc.drain()
    for u, v, fut in zip(us, vs, futs):
        assert fut.result(timeout=0) == oracle.mr(int(u), int(v))
    assert svc.stats().mesh_rows_patched == 0


def test_twin_services_agree_while_lmax_crosses_the_kernel_route():
    """Vertex 0 joins groups of every size 2..41 (n grows by 820), so its
    label row passes 32 labels — where the kernel leaves lane groups for
    a warp per row — and then they dissolve; the kernel service and its
    twin without kernels answer alike, in value and type, throughout."""
    h = random_hypergraph(60, 70, min_size=2, max_size=6, seed=7)
    kern = _serve(h, start=False,
                  config=port_api.ServiceConfig(use_kernels=True))
    twin = _serve(h, start=False)
    rng = np.random.default_rng(21)
    lmaxes = []
    for step in range(5):
        cur = kern.engine.h
        if step in (1, 2):
            sizes = range(2, 22) if step == 1 else range(22, 42)
            ins, nxt = [], cur.n
            for k in sizes:
                ins.append([0] + list(range(nxt, nxt + k - 1)))
                nxt += k - 1
            dels = []
        else:
            ins = [] if step == 4 else [[1, 2, 3]]
            dels = ([e for e in range(cur.m) if cur.edge(e).max() >= 60]
                    if step == 4 else [])
        kern.update(inserts=ins, deletes=dels)
        twin.update(inserts=ins, deletes=dels)
        reqs, _ = _mixed_requests(kern.engine.h, rng, 60)
        kf = kern.submit_many(reqs)
        tf = twin.submit_many([dataclasses.replace(r) for r in reqs])
        kern.drain()
        twin.drain()
        got, want = _results(kf), _results(tf)
        assert got == want and [type(x) for x in got] == \
            [type(x) for x in want]
        lmaxes.append(kern._serving_view().lmax)
    routes = [lj.lanes_per_query(x) for x in lmaxes]
    assert 0 in routes and routes[-1] > 0, lmaxes
    assert kern.engine.h.n == 60 + sum(range(1, 41))


def test_serving_view_is_a_kernel_snapshot_rebuilt_at_every_swap():
    h = planted_chain_hypergraph(3, 5, overlap=2, extra_size=2, seed=2)
    svc = _serve(h, start=False,
                 config=port_api.ServiceConfig(use_kernels=True))
    views = []
    for step in range(3):
        f = svc.mr(0, 1)
        svc.drain()
        f.result(timeout=0)
        view = svc._serving_view()
        assert isinstance(view, KernelSnapshot)
        assert view.base is svc._snap is svc.engine.snapshot_cache()
        assert view.version == svc.engine.version == step
        views.append(view)
        v0 = int(h.edge(0)[0])
        svc.update(inserts=[[v0, v0 + 1, h.n + step]])
        h, _, _ = apply_edge_edits(h, [[v0, v0 + 1, h.n + step]], [])
    assert len({id(v) for v in views}) == 3


def test_scoped_update_rederives_only_touched_rows():
    h = planted_chain_hypergraph(4, 8, overlap=2, extra_size=2, seed=1)
    svc = _serve(h, start=False)
    f = svc.mr(0, 1)
    svc.drain()
    f.result(timeout=0)
    v0 = int(h.edge(0)[0])
    svc.update(inserts=[[v0, v0 + 1]])
    h2, _, _ = apply_edge_edits(h, [[v0, v0 + 1]], [])
    oracle = MSTOracle(h2)
    rng = np.random.default_rng(2)
    us, vs = rng.integers(0, h2.n, 40), rng.integers(0, h2.n, 40)
    futs = [svc.mr(int(u), int(v)) for u, v in zip(us, vs)]
    svc.drain()
    for u, v, fut in zip(us, vs, futs):
        assert fut.result(timeout=0) == oracle.mr(int(u), int(v))
    assert 0 < svc.engine.last_snapshot_refresh_rows < h2.n
    st = svc.stats()
    assert st.rows_rederived < st.rows_full


def test_partial_rederivation_byte_identical_under_churn():
    h = planted_chain_hypergraph(3, 6, overlap=2, extra_size=2, seed=4)
    eng = port_api.build_engine(h, "hl-index", device="cpu")
    eng.snapshot()
    rng = np.random.default_rng(5)
    partial_seen = 0
    for step in range(5):
        if step % 2 == 0:
            v0 = int(rng.integers(h.n))
            ins, dels = [[v0, min(v0 + 1, h.n - 1), h.n]], []
        else:
            ins, dels = [], [int(rng.integers(h.m))]
        eng.update(inserts=ins, deletes=dels)
        h, _, _ = apply_edge_edits(h, ins, dels)
        snap = eng.snapshot()
        assert snap.version == eng.version == step + 1
        if 0 < eng.last_snapshot_refresh_rows < h.n:
            partial_seen += 1
        fresh = DeviceSnapshot.from_hlindex(eng.idx, "hl-index",
                                            version=eng.version,
                                            device="cpu")
        for f in ("ranks", "svals", "lengths"):
            assert torch.equal(getattr(snap, f), getattr(fresh, f))
    assert partial_seen > 0


def test_dirty_rows_contract():
    h = planted_chain_hypergraph(4, 8, overlap=2, extra_size=2, seed=1)
    eng = port_api.build_engine(h, "hl-index", device="cpu")
    assert eng.dirty_rows().size == 0
    eng.snapshot()
    v0 = int(h.edge(0)[0])
    eng.update(inserts=[[v0, v0 + 1]])
    dirty = eng.dirty_rows()
    assert dirty is not None and 0 < dirty.size < eng.h.n
    eng.snapshot()
    assert eng.dirty_rows().size == 0
    ce = port_api.build_engine(h, "closure", device="cpu")
    ce.snapshot()
    ce.update(inserts=[[0, 1]])
    assert ce.dirty_rows() is None
    ce.snapshot()
    assert ce.dirty_rows().size == 0


@pytest.mark.parametrize("backend", ["closure", "sharded"])
def test_rebuild_update_drops_stale_snapshot(backend):
    # the reference's case loops over both backends: on this graph the
    # insert reaches every hyperedge's component, so sharded recomputes
    # whole as closure does
    h = random_hypergraph(16, 12, seed=9)
    eng = port_api.build_engine(h, backend, device="cpu")
    eng.snapshot()
    eng.update(inserts=[[0, 3, 7]])
    assert eng.snapshot_cache() is None
    assert eng.snapshot().version == 1


# ---------------------------------------------------------------------------
# validation, errors, facade
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", port_api.available_backends())
def test_batch_validation_uniform_across_backends(backend):
    h = random_hypergraph(12, 14, seed=0)
    eng = port_api.build_engine(h, backend, device="cpu")
    with pytest.raises(ValueError, match="length mismatch"):
        eng.mr_batch([0, 1], [2])
    with pytest.raises(ValueError, match="integer dtype"):
        eng.mr_batch([0.5, 1.5], [2, 3])
    with pytest.raises(IndexError, match="out of range"):
        eng.mr_batch([0, 1], [2, h.n])
    with pytest.raises(IndexError, match="out of range"):
        eng.s_reach_batch([-1], [2], 2)
    with pytest.raises(ValueError, match="1-D"):
        eng.mr_batch(np.zeros((2, 2), np.int64), np.zeros((2, 2), np.int64))
    assert len(eng.mr_batch([], [])) == 0


def test_validate_batch_helper():
    us, vs = validate_batch([1, 2], np.array([3, 4], np.int32), 5)
    assert us.dtype == vs.dtype == np.int64
    with pytest.raises(IndexError):
        validate_batch([0], [5], 5)
    validate_batch([], [], 0)


def test_submit_validation():
    h = random_hypergraph(10, 12, seed=0)
    svc = _serve(h, start=False)
    with pytest.raises(IndexError, match="out of range"):
        svc.submit(port_api.MRRequest(0, h.n))
    with pytest.raises(ValueError, match="s >= 1"):
        svc.submit(port_api.SReachRequest(0, 1, 0))
    with pytest.raises(ValueError, match="integer dtype"):
        svc.submit(port_api.MRRequest(0.5, 1))
    with pytest.raises(ValueError, match="integer dtype"):
        svc.submit(port_api.SReachRequest(0, 1, 1.5))
    with pytest.raises(TypeError, match="requests"):
        svc.submit((0, 1))
    with pytest.raises(TypeError, match="requests"):
        svc.submit(ref_api.MRRequest(0, 1))     # the reference's type
    assert svc.pending() == 0


def test_workload_requests_are_refused_at_admission():
    ref_h = ref_api.random_hypergraph(10, 12, seed=0)
    h = port_hypergraph(ref_h)
    # refused on a backend that lacks the op, before anything is queued
    svc = _serve(h, "threshold", start=False)
    for call in (lambda: svc.witness(0, 1), lambda: svc.s_reach_k(0, 1, 1, 2),
                 lambda: svc.mr_set([0], [1]), lambda: svc.top_s(0, 3),
                 lambda: svc.s_distance(0, 1, 1)):
        with pytest.raises(port_api.WorkloadUnsupported, match="workload"):
            call()
    assert svc.pending() == 0 and svc.stats().submitted == 0
    # answered on one that has it, equal to the reference's twin service
    port, ref = _serve(h, start=False), ref_api.serve(ref_h, "hl-index",
                                                      start=False)
    calls = (lambda x: x.witness(0, 1), lambda x: x.s_reach_k(0, 1, 1, 2),
             lambda x: x.mr_set([0], [1]), lambda x: x.top_s(0, 3),
             lambda x: x.s_distance(0, 1, 1))
    futs = [(c(port), c(ref)) for c in calls]
    port.drain()
    ref.drain()
    for pf, rf in futs:
        got, want = pf.result(timeout=TIMEOUT), rf.result(timeout=TIMEOUT)
        if hasattr(want, "walk"):            # a Witness of either package
            got, want = dataclasses.astuple(got), dataclasses.astuple(want)
        assert got == want and type(got) is type(want)
    assert port.stats().as_dict() == ref.stats().as_dict()


def test_mesh_store_and_device_are_refused_by_name(tmp_path):
    """Every serving surface takes a logical mesh (A10b; this test once
    held their refusals): ``serve``, ``ReachabilityService``,
    ``ReplicaGroup`` and ``ReachabilityService.restore`` keep the resident
    snapshot on it and answer as the oracle; the store and device rules
    are as before."""
    h = random_hypergraph(10, 12, seed=0)
    mesh = _cpu_mesh()
    eng = port_api.build_engine(h, "hl-index", device="cpu")
    oracle = MSTOracle(h)
    us, vs = [0, 3, 5, 9], [1, 2, 8, 9]
    want = [oracle.mr(u, v) for u, v in zip(us, vs)]
    for svc in (port_api.serve(h, mesh=mesh, start=False),
                port_api.ReachabilityService(eng, mesh=mesh, start=False),
                port_api.ReplicaGroup(eng, 2, mesh=mesh, start=False)):
        futs = [svc.mr(u, v) for u, v in zip(us, vs)]
        svc.drain()
        assert [f.result(timeout=TIMEOUT) for f in futs] == want
        snaps = ([r.snap for r in svc.replicas]
                 if isinstance(svc, port_api.ReplicaGroup) else [svc._snap])
        assert all(sn.mesh == mesh and sn.device.type == "cpu"
                   for sn in snaps if sn is not None)
        svc.close()
    svc = port_api.serve(eng, start=False)
    # the store is ported (tests/test_torch_store.py): checkpoint and
    # restore work, onto a mesh too; a missing artifact fails as in the
    # reference
    store = port_api.IndexStore(tmp_path / "s")
    assert svc.checkpoint(store) == 0
    store.close()
    assert port_api.ReachabilityService.restore(
        tmp_path / "s", device="cpu", start=False).engine.version == 0
    restored = port_api.ReachabilityService.restore(
        tmp_path / "s", mesh=mesh, start=False)
    assert restored.mesh == mesh and restored.engine.device.type == "cpu"
    with pytest.raises(FileNotFoundError):
        port_api.ReachabilityService.restore("somewhere", device="cpu")
    with pytest.raises(FileNotFoundError):
        port_api.ReachabilityService.restore("somewhere", mesh=mesh)
    with pytest.raises(ValueError, match="already-built"):
        port_api.serve(eng, start=False, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_api.serve(h, start=False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_api.make_mesh((2, 2), ("data", "model"))


@pytest.mark.parametrize("route", ["config", "replace", "legacy_kwarg"])
def test_mesh_axes_are_refused_by_name(route):
    # ServiceConfig's ``axes`` (refused until A10b) names the mesh axes
    # the resident snapshot is placed over, by every route: the config,
    # dataclasses.replace, and the deprecated bare keyword
    h = random_hypergraph(10, 12, seed=0)
    eng = port_api.build_engine(h, "hl-index", device="cpu")
    axes = ("rows", "cols")
    mesh = port_api.make_mesh((2, 1), axes, device="cpu")
    if route == "config":
        svc = port_api.serve(eng, mesh=mesh, start=False,
                             config=port_api.ServiceConfig(axes=axes))
    elif route == "replace":
        cfg = dataclasses.replace(port_api.ServiceConfig(replicas=2),
                                  axes=axes)
        svc = port_api.serve(eng, mesh=mesh, start=False, config=cfg)
    else:
        with pytest.warns(DeprecationWarning):
            svc = port_api.serve(eng, mesh=mesh, start=False, axes=axes)
    assert svc.axes == axes
    f = svc.mr(0, 1)
    svc.drain()
    assert f.result(timeout=TIMEOUT) == MSTOracle(h).mr(0, 1)
    snap = (svc.replicas[0].snap if isinstance(svc, port_api.ReplicaGroup)
            else svc._snap)
    assert snap.axes == axes and snap.ranks.shape[0] % 2 == 0
    assert port_api.ServiceConfig(axes=None).axes is None


def test_serve_facade():
    h = random_hypergraph(15, 20, seed=2)
    svc = _serve(h, start=False,
                 config=port_api.ServiceConfig(max_batch=32, min_bucket=4))
    assert svc.max_batch == 32 and svc.min_bucket == 4
    assert svc.engine.name == "hl-index"
    assert svc.engine.device.type == "cpu"
    eng = port_api.build_engine(h, "mst-oracle", device="cpu")
    svc2 = port_api.serve(eng, start=False)
    assert svc2.engine is eng
    with pytest.raises(ValueError, match="already-built"):
        port_api.serve(eng, start=False, minimize_labels=False)
    with pytest.raises(ValueError, match="already-built"):
        port_api.serve(eng, "closure", start=False)
    with pytest.raises(ValueError, match="already-built"):
        port_api.serve(eng, start=False, batch_hint=10_000)
    with pytest.raises(ValueError, match="min_bucket"):
        port_api.ReachabilityService(eng, min_bucket=64, max_batch=8,
                                     start=False)
    small = random_hypergraph(12, 20, seed=4)
    assert port_api.serve(small, batch_hint=1000, device="cpu",
                          start=False).engine.name == "closure"


def test_service_on_snapshotless_backend_never_snapshots():
    h = random_hypergraph(15, 20, seed=2)
    svc = _serve(h, "mst-oracle", start=False)
    oracle = MSTOracle(h)
    futs = [svc.mr(0, i % h.n) for i in range(10)]
    futs.append(svc.s_reach(0, 1, 2))
    futs.append(svc.s_reach(0, 2, 1))
    svc.drain()
    got = [f.result(timeout=0) for f in futs]
    assert got[:10] == [oracle.mr(0, i % h.n) for i in range(10)]
    assert got[10:] == [oracle.mr(0, 1) >= 2, oracle.mr(0, 2) >= 1]
    assert [type(x) for x in got] == [int] * 10 + [bool] * 2
    assert svc.stats().snapshot_refreshes == 0
    with pytest.raises(port_api.SnapshotUnsupported):
        svc.engine.snapshot()


def test_service_stats_shape():
    d = port_rs.ServiceStats().as_dict()
    assert set(d) == set(ref_rs.ServiceStats().as_dict())


def test_a_failing_batch_fails_its_futures_and_serving_goes_on():
    h = random_hypergraph(20, 30, seed=6)
    svc = _serve(h, config=port_api.ServiceConfig(max_wait_ms=1.0,
                                                  use_kernels=True))
    real = svc._snapshot_mr

    def device_fault(snap, us, vs):
        raise RuntimeError("CUDA error: device-side assert triggered")

    try:
        svc._snapshot_mr = device_fault
        futs = [svc.mr(0, i) for i in range(5)]
        for f in futs:
            with pytest.raises(RuntimeError, match="device-side"):
                f.result(timeout=TIMEOUT)
        svc._snapshot_mr = real
        f = svc.mr(0, 1)
        assert f.result(timeout=TIMEOUT) == MSTOracle(h).mr(0, 1)
    finally:
        svc.close()
    assert svc.stats().answered == 1


def test_kernel_library_loads_once_under_concurrent_first_calls(monkeypatch):
    """Many threads reach a kernel's first launch at once (a service's
    admission thread and its caller): the library is built and loaded
    exactly once."""
    built, loaded = [], []

    def fake_build(names, build_dir=None):
        built.append(tuple(names))
        time.sleep(0.01)          # a slow build widens the race window
        return {n: f"/nowhere/{n}.so" for n in names}

    def fake_cdll(path):
        loaded.append(path)
        return object()

    monkeypatch.setattr(build_mod, "build_libraries", fake_build)
    monkeypatch.setattr(build_mod.ctypes, "CDLL", fake_cdll)
    monkeypatch.delitem(build_mod._LOADED, "race_probe", raising=False)
    interval = sys.getswitchinterval()
    results = []
    try:
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(
            target=lambda: results.append(build_mod.load_library(
                "race_probe"))) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        build_mod._LOADED.pop("race_probe", None)
    assert built == [("race_probe",)] and len(loaded) == 1
    assert len(results) == 32 and len({id(r) for r in results}) == 1


@pytest.mark.gpu
def test_kernel_service_on_the_card_launches_once_per_micro_batch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the label_join kernel runs only "
                    "on the card")
    h = random_hypergraph(300, 450, seed=1)
    svc = port_api.serve(h, start=False, config=port_api.ServiceConfig(
        use_kernels=True, max_batch=64))
    plain = port_api.serve(h, start=False, config=port_api.ServiceConfig(
        use_kernels=False, max_batch=64))
    rng = np.random.default_rng(3)
    reqs, _ = _mixed_requests(h, rng, 300)
    before = lj.GATHER_LAUNCHES
    kf = svc.submit_many(reqs)
    svc.drain()
    assert lj.GATHER_LAUNCHES - before == svc.stats().batches
    pf = plain.submit_many([dataclasses.replace(r) for r in reqs])
    plain.drain()
    got, want = _results(kf), _results(pf)
    assert got == want and [type(x) for x in got] == [type(x) for x in want]
