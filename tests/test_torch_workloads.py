"""Port parity, the workload subsystem: ``repro_torch.workloads`` and the
engine / service workload ops on ``device="cpu"`` against
``repro.workloads`` and the reference's engines and service.  The cases
mirror ``tests/test_workloads.py`` one for one, each also held to the
reference: walks equal (not merely valid), the distance oracle's
landmarks and distance table equal byte for byte, answers equal in value
and type, and the service's ``stats()`` equal to a twin reference
service's.  Tolerance 0 everywhere.  Then the id checks in front of the
kernel: an id of ``n`` given to ``mr_set`` / ``mr_from_set`` / ``top_s``
raises (or is refused at admission) before ``label_join_gather`` is
reached, and each valid call reaches it exactly once."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro.core as ref_core
import repro.workloads as ref_wl
from repro.serve.reach_service import REQUEST_TYPES as REF_REQUEST_TYPES
import repro_torch.api as port_api
import repro_torch.core as port_core
from repro_torch.core.baselines import MSTOracle
from repro_torch.device import gpu_probe
from repro_torch.kernels import label_join as lj
from repro_torch.serve.reach_service import REQUEST_TYPES
from repro_torch.workloads import (DistanceOracle, Witness, WORKLOAD_OPS,
                                   bounded_s_distance, cross_pairs,
                                   extract_witness, hop_bounded_s_reach,
                                   normalize_vertex_set, select_top_s,
                                   walk_wod, workload_capabilities)

from util_torch_port import assert_same_array, port_hypergraph

TIMEOUT = 60


def _pair(*args, **kw):
    """The reference's ``random_hypergraph`` and the port's copy of it."""
    ref_h = ref_api.random_hypergraph(*args, **kw)
    return ref_h, port_hypergraph(ref_h)


def _same(got, want, what=""):
    """Equal in value and in type; arrays also in dtype and shape; a
    ``Witness`` of either package field by field."""
    if isinstance(want, np.ndarray):
        assert_same_array(want, got, what)
        return
    if dataclasses.is_dataclass(want):
        got, want = dataclasses.astuple(got), dataclasses.astuple(want)
    assert got == want and type(got) is type(want), (what, got, want)
    if isinstance(want, tuple):
        assert [type(x) for x in got] == [type(x) for x in want], what


# ---------------------------------------------------------------------------
# walk primitives
# ---------------------------------------------------------------------------

def test_walk_wod_and_verify():
    edges = [[0, 1, 2], [1, 2, 3], [3, 4], [5, 6, 7]]
    h = port_api.from_edge_lists(edges, n=8)
    ref_h = ref_api.from_edge_lists(edges, n=8)
    assert walk_wod(h, ()) == 0
    assert walk_wod(h, (0,)) == 3            # singleton walk: |e|
    assert walk_wod(h, (0, 1)) == 2          # overlap {1, 2}
    assert walk_wod(h, (0, 1, 2)) == 1       # min(2, 1)
    assert walk_wod(h, (0, 3)) == 0          # disjoint edges
    for walk in ((), (0,), (0, 1), (0, 1, 2), (0, 3), (3, 3)):
        _same(walk_wod(h, walk), ref_wl.walk_wod(ref_h, walk), walk)
    with pytest.raises(IndexError, match="out of range"):
        walk_wod(h, (0, 99))
    cases = [((0, 3, 2, (0, 1)), True), ((0, 5, 0, ()), True),
             ((0, 3, 2, ()), False), ((0, 3, 3, (0, 1)), False),
             ((5, 3, 2, (0, 1)), False), ((0, 5, 2, (0, 1)), False),
             ((0, 3, -1, ()), False)]
    for fields, want in cases:
        got = port_api.verify_witness(h, Witness(*fields))
        assert got is want is ref_wl.verify_witness(ref_h,
                                                    ref_wl.Witness(*fields))
    with pytest.raises(dataclasses.FrozenInstanceError):
        Witness(0, 3, 2, (0, 1)).s = 1


def test_extract_witness_matches_brute_force_and_the_reference():
    ref_h, h = _pair(25, 40, seed=11)
    oracle = MSTOracle(h)
    rng = np.random.default_rng(2)
    for u, v in rng.integers(0, h.n, (25, 2)):
        u, v = int(u), int(v)
        k = oracle.mr(u, v)
        bk, bwalk = port_core.brute_force_witness(h, u, v)
        _same((bk, bwalk), ref_core.brute_force_witness(ref_h, u, v))
        assert bk == k                       # brute force agrees with oracle
        assert walk_wod(h, bwalk) == k if k else bwalk == ()
        walk = extract_witness(h, u, v, k)
        _same(walk, ref_wl.extract_witness(ref_h, u, v, k), (u, v))
        if k == 0:
            assert walk == ()
            continue
        assert port_api.verify_witness(h, Witness(u, v, k, walk))
        for hub in walk:                     # a named hub on the walk
            _same(extract_witness(h, u, v, k, hub=hub),
                  ref_wl.extract_witness(ref_h, u, v, k, hub=hub))
    # asking for a strength above the true MR is loud, not a bad walk
    with pytest.raises(ValueError, match="is not their MR"):
        extract_witness(h, 0, 1, oracle.mr(0, 1) + 5)


# ---------------------------------------------------------------------------
# standalone structures
# ---------------------------------------------------------------------------

def test_hop_bounded_matches_brute_force_and_the_reference():
    ref_h, h = _pair(25, 40, seed=4)
    rng = np.random.default_rng(5)
    for u, v in rng.integers(0, h.n, (15, 2)):
        u, v = int(u), int(v)
        for s in (1, 2, 3):
            d = bounded_s_distance(h, u, v, s)
            _same(d, ref_wl.bounded_s_distance(ref_h, u, v, s))
            _same(port_core.brute_force_s_distance(h, u, v, s),
                  ref_core.brute_force_s_distance(ref_h, u, v, s))
            assert d == port_core.brute_force_s_distance(h, u, v, s)
            for k in (1, 2, h.m):
                got = hop_bounded_s_reach(h, u, v, s, k)
                _same(got, ref_wl.hop_bounded_s_reach(ref_h, u, v, s, k))
                _same(port_core.brute_force_s_reach_k(h, u, v, s, k),
                      ref_core.brute_force_s_reach_k(ref_h, u, v, s, k))
                assert got == port_core.brute_force_s_reach_k(h, u, v, s, k)
    # the hop budget truncates: distance-d pairs unreachable under d-1
    assert bounded_s_distance(h, 0, 0, 1, max_hyperedges=0) in (0, 1)
    for budget in (0, 1, 2, 3):
        _same(bounded_s_distance(h, 0, 7, 1, max_hyperedges=budget),
              ref_wl.bounded_s_distance(ref_h, 0, 7, 1,
                                        max_hyperedges=budget))


def _same_oracle(port_do, ref_do):
    assert port_do.landmarks == ref_do.landmarks
    assert all(type(x) is int for x in port_do.landmarks)
    assert_same_array(ref_do._dist, port_do._dist, "landmark distances")
    assert port_do.nbytes() == ref_do.nbytes()
    assert port_do.num_landmarks == ref_do.num_landmarks


def test_distance_oracle_certified_bounds():
    ref_h, h = _pair(30, 45, seed=3)
    for s in (1, 2, 3):
        do = DistanceOracle(h, s)
        ref_do = ref_wl.DistanceOracle(ref_h, s)
        _same_oracle(do, ref_do)
        assert do.num_landmarks >= 1 or h.m == 0
        assert do.nbytes() > 0
        rng = np.random.default_rng(s)
        for u, v in rng.integers(0, h.n, (30, 2)):
            bound = do.distance(int(u), int(v))
            _same(bound, ref_do.distance(int(u), int(v)))
            exact = port_core.brute_force_s_distance(h, int(u), int(v), s)
            assert (bound == 0) == (exact == 0)      # never wrong on reach
            assert bound >= exact                    # certified upper bound
    with pytest.raises(ValueError, match="s >= 1"):
        DistanceOracle(h, 0)


def test_distance_oracle_extra_landmarks_tighten():
    ref_h, h = _pair(40, 70, seed=8)
    lean = DistanceOracle(h, 1, extra_landmarks=0)
    rich = DistanceOracle(h, 1, extra_landmarks=8)
    _same_oracle(lean, ref_wl.DistanceOracle(ref_h, 1, extra_landmarks=0))
    _same_oracle(rich, ref_wl.DistanceOracle(ref_h, 1, extra_landmarks=8))
    assert rich.num_landmarks >= lean.num_landmarks
    rng = np.random.default_rng(0)
    pairs = rng.integers(0, h.n, (40, 2))
    for u, v in pairs:
        assert rich.distance(int(u), int(v)) <= lean.distance(int(u), int(v))


def test_set_helpers():
    us = normalize_vertex_set([3, 1, 3, 2], 10, "us")
    assert_same_array(ref_wl.normalize_vertex_set([3, 1, 3, 2], 10, "us"),
                      us, "normalized")
    np.testing.assert_array_equal(us, [1, 2, 3])
    # the reference's messages, word for word
    for bad, exc in (([], ValueError), ([1.5], ValueError),
                     ([10], IndexError), ([-1, 4], IndexError),
                     ([[1, 2]], ValueError)):
        with pytest.raises(exc) as got:
            normalize_vertex_set(bad, 10, "us")
        with pytest.raises(exc) as want:
            ref_wl.normalize_vertex_set(bad, 10, "us")
        assert str(got.value) == str(want.value)
    a, b = cross_pairs(np.array([0, 1]), np.array([5, 6, 7]))
    np.testing.assert_array_equal(a, [0, 0, 0, 1, 1, 1])
    np.testing.assert_array_equal(b, [5, 6, 7, 5, 6, 7])
    for x, y in zip((a, b), ref_wl.cross_pairs(np.array([0, 1]),
                                               np.array([5, 6, 7]))):
        assert_same_array(y, x, "cross_pairs")


def test_select_top_s_with_ties():
    row = np.array([0, 5, 3, 5, 0, 2], np.int64)
    verts, vals = select_top_s(row, u=1, k=3)
    np.testing.assert_array_equal(verts, [3, 2, 5])   # 1 (self) excluded
    np.testing.assert_array_equal(vals, [5, 3, 2])
    verts, vals = select_top_s(row, u=0, k=100)       # k past the nonzeros
    np.testing.assert_array_equal(verts, [1, 3, 2, 5])
    np.testing.assert_array_equal(vals, [5, 5, 3, 2])
    # ties everywhere (values 0..3 over 200 vertices), int32 rows as the
    # kernel returns them: the ranking is the reference's, id order in ties
    rng = np.random.default_rng(12)
    for _ in range(20):
        row = rng.integers(0, 4, 200).astype(np.int32)
        u, k = int(rng.integers(200)), int(rng.integers(1, 250))
        for got, want in zip(select_top_s(row, u, k),
                             ref_wl.select_top_s(row, u, k)):
            assert_same_array(want, got, "select_top_s")


# ---------------------------------------------------------------------------
# engine-level invariants the matrix doesn't pin
# ---------------------------------------------------------------------------

def test_workload_capabilities_registry_shape():
    caps = workload_capabilities()
    assert WORKLOAD_OPS == ref_wl.WORKLOAD_OPS
    assert all(tuple(row) == WORKLOAD_OPS for row in caps.values())
    assert all(caps["hl-index"].values())
    assert not any(caps["mst-oracle"].values())
    ref_caps = ref_wl.workload_capabilities()
    assert caps == ref_caps
    assert port_api.workload_capabilities() == caps


def test_distance_oracle_cache_invalidated_by_update():
    ref_h, h = _pair(20, 25, seed=6)
    eng = port_api.build_engine(h, "hl-index", device="cpu")
    ref = ref_api.build_engine(ref_h, "hl-index")
    do1 = eng.distance_oracle(2)
    assert eng.distance_oracle(2) is do1             # cached per (s, extras)
    assert eng.distance_oracle(2, extra_landmarks=0) is not do1
    for e in (eng, ref):
        e.update(inserts=[[0, 1, 2, 3]])
    assert eng.distance_oracle(2) is not do1         # update invalidates
    _same_oracle(eng.distance_oracle(2), ref.distance_oracle(2))
    for u in range(5):
        bound = eng.s_distance(0, u, 2)
        _same(bound, ref.s_distance(0, u, 2))
        exact = port_core.brute_force_s_distance(eng.h, 0, u, 2)
        assert (bound == 0) == (exact == 0) and bound >= exact


def test_workloads_after_update_match_brute_force_and_the_reference():
    ref_h, h = _pair(20, 25, seed=9)
    eng = port_api.build_engine(h, "hl-index", device="cpu")
    ref = ref_api.build_engine(ref_h, "hl-index")
    for e in (eng, ref):
        e.update(inserts=[[0, 5, 9, 11]], deletes=[1])
    h2 = eng.h
    oracle = MSTOracle(h2)
    for u, v in ((0, 9), (5, 11), (2, 17)):
        w = eng.mr_witness(u, v)
        _same(w, ref.mr_witness(u, v), (u, v))
        assert w.s == oracle.mr(u, v) and port_api.verify_witness(h2, w)
        got = eng.s_reach_k(u, v, 1, 2)
        _same(got, ref.s_reach_k(u, v, 1, 2))
        assert got == port_core.brute_force_s_reach_k(h2, u, v, 1, 2)
    verts, vals = eng.top_s(0, 4)
    for got, want, brute in zip((verts, vals), ref.top_s(0, 4),
                                port_core.brute_force_top_s(h2, 0, 4)):
        assert_same_array(want, got, "top_s")
        assert_same_array(brute, got, "top_s brute")
    got = eng.mr_set([0, 5], [9, 11])
    _same(got, ref.mr_set([0, 5], [9, 11]))
    assert got == port_core.brute_force_mr_set(h2, [0, 5], [9, 11])
    targets = np.arange(h2.n)
    got = eng.mr_from_set([0, 5], targets)
    assert_same_array(np.asarray(ref.mr_from_set([0, 5], targets)), got,
                      "mr_from_set")
    assert_same_array(port_core.brute_force_mr_from_set(h2, [0, 5], targets),
                      got, "mr_from_set brute")


# ---------------------------------------------------------------------------
# serving round trip: every registered request kind through submit()
# ---------------------------------------------------------------------------

# one well-formed instance per registered kind (u/v/s/k in range for the
# 30-vertex fixture below)
_SAMPLE_FIELDS = {
    "mr": dict(u=0, v=1),
    "s_reach": dict(u=0, v=1, s=2),
    "witness": dict(u=0, v=1),
    "s_reach_k": dict(u=0, v=1, s=2, k=3),
    "mr_set": dict(us=(0, 1), vs=(2, 3)),
    "top_s": dict(u=0, k=3),
    "s_distance": dict(u=0, v=1, s=2),
}


def test_request_registry_covered():
    assert set(_SAMPLE_FIELDS) == set(REQUEST_TYPES) == \
        set(REF_REQUEST_TYPES)


@pytest.fixture(scope="module")
def svc():
    _, h = _pair(30, 45, seed=3)
    service = port_api.serve(h, "hl-index", start=False, device="cpu")
    yield service
    service.close()


@pytest.mark.parametrize("kind", sorted(_SAMPLE_FIELDS))
def test_request_metadata_roundtrip(svc, kind):
    """Every public request type takes the shared tenant/priority/
    deadline metadata through the same admission validation: good
    metadata resolves, each bad field raises — for every kind."""
    cls = REQUEST_TYPES[kind]
    fields = _SAMPLE_FIELDS[kind]
    fut = svc.submit(cls(**fields, tenant="t9", priority="interactive",
                         deadline_ms=10_000.0))
    svc.drain()
    assert fut.done() and fut.exception() is None
    req = cls(**fields)
    assert (req.tenant, req.priority, req.deadline_ms) == \
        ("default", "standard", None)        # defaults intact per kind
    with pytest.raises(ValueError):
        svc.submit(cls(**fields, tenant=""))
    with pytest.raises(ValueError):
        svc.submit(cls(**fields, priority="warp-speed"))
    with pytest.raises(ValueError):
        svc.submit(cls(**fields, deadline_ms=0))


def _workload_specs(n, rng, count):
    """Seeded (kind, fields) specs of every kind, both packages' types."""
    kinds = sorted(_SAMPLE_FIELDS)
    specs = []
    for _ in range(count):
        kind = kinds[int(rng.integers(len(kinds)))]
        u, v = int(rng.integers(n)), int(rng.integers(n))
        s, k = int(rng.integers(1, 4)), int(rng.integers(1, 5))
        fields = {"mr": dict(u=u, v=v), "s_reach": dict(u=u, v=v, s=s),
                  "witness": dict(u=u, v=v),
                  "s_reach_k": dict(u=u, v=v, s=s, k=k),
                  "mr_set": dict(us=tuple(int(x) for x in
                                          rng.integers(0, n, 3)),
                                 vs=tuple(int(x) for x in
                                          rng.integers(0, n, 4))),
                  "top_s": dict(u=u, k=k),
                  "s_distance": dict(u=u, v=v, s=s)}[kind]
        tenant = ("a", "b", "c")[int(rng.integers(3))]
        specs.append((kind, dict(fields, tenant=tenant)))
    return specs


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["ops", "kernels"])
def test_twin_service_workload_answers_and_stats(use_kernels):
    """Mixed traffic of all seven kinds through the port's and the
    reference's services: answers equal in value and type, and
    ``stats()`` (``batches``, ``workload_answered``, ``bucket_histogram``)
    equal; only ``kernel_batches`` tells the kernel route apart."""
    ref_h, h = _pair(30, 45, seed=3)
    specs = _workload_specs(h.n, np.random.default_rng(17), 160)
    ref = ref_api.serve(ref_h, "hl-index", start=False,
                        config=ref_api.ServiceConfig(max_batch=32))
    port = port_api.serve(h, "hl-index", start=False, device="cpu",
                          config=port_api.ServiceConfig(
                              max_batch=32, use_kernels=use_kernels))
    futs = [(port.submit(REQUEST_TYPES[k](**f)),
             ref.submit(REF_REQUEST_TYPES[k](**f))) for k, f in specs]
    port.drain()
    ref.drain()
    for (kind, fields), (pf, rf) in zip(specs, futs):
        _same(pf.result(timeout=TIMEOUT), rf.result(timeout=TIMEOUT),
              (kind, fields))
    st, want = port.stats().as_dict(), ref.stats().as_dict()
    padded_groups = sum(st["bucket_histogram"].values())
    assert st.pop("kernel_batches") == (padded_groups if use_kernels else 0)
    want.pop("kernel_batches")
    assert st == want
    counts = {k: sum(kind == k for kind, _ in specs) for k in WORKLOAD_OPS}
    assert st["workload_answered"] == counts
    for svc_ in (port, ref):
        svc_.close()


def test_workload_groups_stay_out_of_the_padded_buckets():
    """One micro-batch of all seven kinds: the mr / s_reach buckets are
    what that traffic alone makes, and each workload kind adds one
    (unpadded) group to ``batches`` and none to ``bucket_histogram``."""
    _, h = _pair(30, 45, seed=3)
    specs = _workload_specs(h.n, np.random.default_rng(19), 160)
    runs = {}
    for name, chosen in (("mixed", specs),
                         ("alone", [x for x in specs
                                    if x[0] in ("mr", "s_reach")])):
        svc_ = port_api.serve(h, "hl-index", start=False, device="cpu",
                              config=port_api.ServiceConfig(max_batch=256))
        svc_.submit_many([REQUEST_TYPES[k](**f) for k, f in chosen])
        svc_.drain()
        runs[name] = svc_.stats()
        svc_.close()
    mixed, alone = runs["mixed"], runs["alone"]
    assert mixed.bucket_histogram == alone.bucket_histogram
    assert mixed.padded_queries == alone.padded_queries
    assert mixed.batches == alone.batches + len(WORKLOAD_OPS)
    assert sum(mixed.workload_answered.values()) == \
        mixed.answered - alone.answered


def test_service_workload_answers_match_brute_force(svc):
    h = svc.engine.h
    oracle = MSTOracle(h)
    f_w = svc.witness(3, 17)
    f_k = svc.s_reach_k(3, 17, 2, 2)
    f_set = svc.mr_set([0, 1, 2], [10, 11, 12])
    f_top = svc.top_s(5, 4)
    f_d = svc.s_distance(3, 17, 2)
    svc.drain()
    w = f_w.result(timeout=0)
    assert isinstance(w, Witness)
    assert w.s == oracle.mr(3, 17) and port_api.verify_witness(h, w)
    assert f_k.result(timeout=0) is \
        port_core.brute_force_s_reach_k(h, 3, 17, 2, 2)
    assert f_set.result(timeout=0) == port_core.brute_force_mr_set(
        h, [0, 1, 2], [10, 11, 12])
    bv, bs = port_core.brute_force_top_s(h, 5, 4)
    assert f_top.result(timeout=0) == tuple(zip(bv.tolist(), bs.tolist()))
    bound = f_d.result(timeout=0)
    exact = port_core.brute_force_s_distance(h, 3, 17, 2)
    assert (bound == 0) == (exact == 0) and bound >= exact
    stats = svc.stats().as_dict()
    assert all(stats["workload_answered"].get(k, 0) >= 1
               for k in WORKLOAD_OPS)


def test_service_refuses_unsupported_workloads_at_admission():
    ref_h, h = _pair(20, 25, seed=1)
    with port_api.serve(h, "online", start=False, device="cpu") as svc_o:
        with pytest.raises(port_api.WorkloadUnsupported):
            svc_o.witness(0, 1)
        with pytest.raises(port_api.WorkloadUnsupported):
            svc_o.top_s(0, 3)
        fut = svc_o.s_reach_k(0, 1, 1, 3)    # traversal ops still served
        svc_o.drain()
        got = fut.result(timeout=0)
        _same(got, ref_api.build_engine(ref_h, "online").s_reach_k(0, 1, 1, 3))
        assert svc_o.stats().expired == 0
        assert svc_o.stats().workload_answered == {"s_reach_k": 1}


@pytest.mark.parametrize("backend", ["threshold", "mst-oracle"])
def test_static_baselines_refuse_every_workload_at_admission(backend):
    _, h = _pair(20, 25, seed=1)
    with port_api.serve(h, backend, start=False, device="cpu") as svc_b:
        for kind in WORKLOAD_OPS:
            with pytest.raises(port_api.WorkloadUnsupported, match=kind):
                svc_b.submit(REQUEST_TYPES[kind](**_SAMPLE_FIELDS[kind]))
        assert svc_b.pending() == 0 and svc_b.stats().submitted == 0


def test_request_types_frozen_and_hashable():
    for kind, fields in _SAMPLE_FIELDS.items():
        req = REQUEST_TYPES[kind](**fields)
        assert hash(req) == hash(REQUEST_TYPES[kind](**fields))
        with pytest.raises(dataclasses.FrozenInstanceError):
            req.tenant = "x"
    # mr_set coerces list inputs to tuples so the instance stays hashable
    req = port_api.MRSetRequest([3, 1], [2])
    assert req.us == (3, 1) and req.vs == (2,)
    assert hash(req) == hash(port_api.MRSetRequest((3, 1), (2,)))


def test_workload_requests_importable_from_api():
    for name in ("WitnessRequest", "SReachKRequest", "MRSetRequest",
                 "TopSRequest", "SDistanceRequest", "Witness",
                 "verify_witness", "DistanceOracle", "WorkloadUnsupported",
                 "WORKLOAD_OPS", "workload_capabilities"):
        assert name in port_api.__all__ and hasattr(port_api, name)
        assert name in ref_api.__all__
    assert {port_api.WitnessRequest, port_api.SReachKRequest,
            port_api.MRSetRequest, port_api.TopSRequest,
            port_api.SDistanceRequest} <= set(REQUEST_TYPES.values())


# ---------------------------------------------------------------------------
# ids in front of the kernel: an id outside the joined snapshot would trap
# label_join.cu and end the CUDA context, so the set and top-k ops hold
# every id to [0, n) before mr_batch
# ---------------------------------------------------------------------------

@pytest.fixture
def gather_calls(monkeypatch):
    """Every call of ``label_join_gather`` (the wrapper a kernel-path
    batch reaches), recorded by its id count; patched before any engine
    is built, as ``KernelSnapshot`` binds the wrapper when made."""
    calls = []
    real = lj.label_join_gather

    def recording(*args):
        calls.append(int(args[2].numel()))
        return real(*args)

    monkeypatch.setattr(lj, "label_join_gather", recording)
    return calls


def _out_of_range_calls(eng, n):
    return (lambda: eng.mr_set([0], [n]), lambda: eng.mr_set([n], [0]),
            lambda: eng.mr_set([0, -1], [1]),
            lambda: eng.mr_from_set([0], [n]),
            lambda: eng.mr_from_set([n], [0]),
            lambda: eng.mr_from_set([0], [-1]),
            lambda: eng.top_s(n, 3), lambda: eng.top_s(-1, 3))


@pytest.mark.parametrize("backend", ["hl-index", "hl-index-basic", "ete"])
def test_set_and_top_ops_hold_ids_to_n_before_any_launch(backend,
                                                         gather_calls):
    _, h = _pair(30, 45, seed=3)
    n = h.n
    eng = port_api.build_engine(h, backend, use_kernels=True, device="cpu")
    launches = lj.GATHER_LAUNCHES
    for call in _out_of_range_calls(eng, n):
        with pytest.raises(IndexError, match="out of range"):
            call()
    assert gather_calls == [] and lj.GATHER_LAUNCHES == launches
    # valid calls: one join each, of |U| x |V|, |U| x |targets| and n ids
    assert isinstance(eng.mr_set([0, 1], [n - 1, 2, 3]), int)
    assert eng.mr_from_set([0, 1], [n - 1, 2]).dtype == np.int64
    verts, vals = eng.top_s(n - 1, 3)
    assert verts.dtype == vals.dtype == np.int64
    assert gather_calls == [6, 4, n]
    assert lj.GATHER_LAUNCHES == launches     # the CPU runs the plain join


def test_set_and_top_requests_are_refused_at_admission(gather_calls):
    _, h = _pair(30, 45, seed=3)
    n = h.n
    svc = port_api.serve(h, "hl-index", start=False, device="cpu",
                         config=port_api.ServiceConfig(use_kernels=True))
    assert svc.engine.use_kernels
    for call in (lambda: svc.mr_set([0], [n]), lambda: svc.mr_set([n], [0]),
                 lambda: svc.top_s(n, 3),
                 lambda: svc.submit(port_api.MRSetRequest((0,), (-1,)))):
        with pytest.raises(IndexError, match="out of range"):
            call()
    assert svc.pending() == 0 and svc.stats().submitted == 0
    assert gather_calls == []
    f_set, f_top = svc.mr_set([0, 1], [n - 1]), svc.top_s(n - 1, 2)
    svc.drain()
    assert isinstance(f_set.result(timeout=TIMEOUT), int)
    assert len(f_top.result(timeout=TIMEOUT)) <= 2
    assert gather_calls == [2, n]             # one join per request
    svc.close()


@pytest.fixture
def card():
    probe = gpu_probe()
    if not probe["cuda"] or probe["nvcc"] is None:
        pytest.skip(f"needs an NVIDIA GPU and nvcc: {probe}")
    return torch.device("cuda")


@pytest.mark.gpu
def test_set_and_top_ops_through_the_kernel_equal_kernels_off(card):
    _, h = _pair(300, 450, seed=5)
    dev = port_api.build_engine(h, "hl-index", use_kernels=True, device=card)
    plain = port_api.build_engine(h, "hl-index", device=card)
    rng = np.random.default_rng(4)
    before = lj.GATHER_LAUNCHES
    U, V = rng.integers(0, h.n, 40), rng.integers(0, h.n, 50)
    _same(dev.mr_set(U, V), plain.mr_set(U, V))
    targets = rng.integers(0, h.n, 200)
    assert_same_array(plain.mr_from_set(U, targets),
                      dev.mr_from_set(U, targets), "mr_from_set")
    for u in rng.integers(0, h.n, 8):
        for got, want in zip(dev.top_s(int(u), 10), plain.top_s(int(u), 10)):
            assert_same_array(want, got, "top_s")
    assert lj.GATHER_LAUNCHES == before + 2 + 8
    with pytest.raises(IndexError, match="out of range"):
        dev.top_s(h.n, 3)
    assert lj.GATHER_LAUNCHES == before + 2 + 8


# ---------------------------------------------------------------------------
# property: witnesses are valid s-walks realizing exactly the MR, and the
# reference's walks
# ---------------------------------------------------------------------------

# guarded import (not a module-level importorskip: that would skip the
# whole file, and the non-property tests above must run regardless)
try:
    from hypothesis import given, settings, strategies as st
    _HAVE_HYPOTHESIS = True
except ImportError:                          # pragma: no cover
    _HAVE_HYPOTHESIS = False

if _HAVE_HYPOTHESIS:
    @st.composite
    def small_edge_lists(draw):
        n = draw(st.integers(4, 12))
        m = draw(st.integers(1, 10))
        edges = [sorted(draw(st.sets(st.integers(0, n - 1), min_size=1,
                                     max_size=min(n, 5))))
                 for _ in range(m)]
        return n, edges

    @settings(max_examples=40, deadline=None)
    @given(graph=small_edge_lists(), data=st.data())
    def test_property_witness_walks_are_valid(graph, data):
        n, edges = graph
        h = port_api.from_edge_lists(edges, n=n)
        ref_h = ref_api.from_edge_lists(edges, n=n)
        u = data.draw(st.integers(0, h.n - 1), label="u")
        v = data.draw(st.integers(0, h.n - 1), label="v")
        oracle = MSTOracle(h)
        k = oracle.mr(u, v)
        if k == 0:
            return
        walk = extract_witness(h, u, v, k)
        _same(walk, ref_wl.extract_witness(ref_h, u, v, k))
        # a genuine s-walk: endpoints covered, every consecutive overlap
        # >= k, and its min overlap is *exactly* the reported MR
        assert walk[0] in h.edges_of(u) and walk[-1] in h.edges_of(v)
        assert walk_wod(h, walk) == k
        assert port_api.verify_witness(h, Witness(u, v, k, walk))
else:                                        # pragma: no cover
    @pytest.mark.skip(reason="hypothesis not installed")
    def test_property_witness_walks_are_valid():
        pass
