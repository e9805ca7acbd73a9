"""Port parity, the slice as a whole: ``repro_torch.api.build_engine`` on
``device="cpu"`` against ``repro.api.build_engine`` on the same graph, for
every backend and op the first slice of the port has — values and dtypes,
tolerance 0 — plus the errors both stacks must raise alike.  The
reference's mesh cases (``tests/test_engine.py``: the ``sharded`` backend
on 1-, 2- and 4-device meshes, unit-axis degradation, the mesh-aware
planner) run in process on logical grids of those block counts."""
import types

import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro_torch.api as port_api
from repro_torch.core import engine as port_engine
from repro_torch.core.query import KernelSnapshot

from util_torch_port import (assert_same_array, assert_same_hypergraph,
                             assert_same_index, port_hypergraph, port_index,
                             snapshot_arrays)

BACKENDS = [
    ("hl-index", {}),
    ("hl-index", {"use_kernels": True}),
    ("hl-index", {"minimize_labels": False}),
    ("hl-index-basic", {}),
    ("hl-index-basic", {"cover_check": False, "use_kernels": True}),
    ("mst-oracle", {}),
    ("sharded", {}),
    ("sharded", {"build_labels": True}),
    ("sharded", {"use_kernels": True, "schedule": "ring"}),
]
IDS = ["hl-index", "hl-index[kernels]", "hl-index[unminimized]",
       "hl-index-basic", "hl-index-basic[kernels,nocover]", "mst-oracle",
       "sharded", "sharded[labels]", "sharded[kernels,ring]"]


def _graph(mod):
    return mod.random_hypergraph(48, 70, min_size=2, max_size=6, seed=21)


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(4)
    return rng.integers(0, 48, 300), rng.integers(0, 48, 300)


@pytest.fixture(scope="module", params=list(zip(BACKENDS, IDS)),
                ids=lambda p: p[1])
def engines(request):
    (backend, opts), _ = request.param
    ref = ref_api.build_engine(_graph(ref_api), backend, **opts)
    port = port_api.build_engine(_graph(port_api), backend, device="cpu",
                                 **opts)
    return ref, port


def _same(got, want):
    want = np.asarray(want)
    assert isinstance(got, np.ndarray)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def test_batch_answers_values_and_dtypes(engines, pairs):
    ref, port = engines
    us, vs = pairs
    assert port.name == ref.name
    assert port.update_capability == ref.update_capability
    _same(port.mr_batch(us, vs), ref.mr_batch(us, vs))
    for s in (1, 2, 3):
        _same(port.s_reach_batch(us, vs, s), ref.s_reach_batch(us, vs, s))
    _same(port.mr_batch([], []), ref.mr_batch([], []))
    _same(port.s_reach_batch([], [], 2), ref.s_reach_batch([], [], 2))


def test_scalar_answers(engines, pairs):
    ref, port = engines
    us, vs = pairs
    batch = port.mr_batch(us[:60], vs[:60])
    for u, v, b in zip(us[:60], vs[:60], batch):
        want = ref.mr(int(u), int(v))
        got = port.mr(int(u), int(v))
        assert type(got) is type(want) and got == want == int(b)
        for s in (1, 3):
            assert port.s_reach(u, v, s) == ref.s_reach(u, v, s) \
                == (want >= s)


def test_snapshot_identical_or_unsupported_alike(engines):
    ref, port = engines
    if ref.name == "mst-oracle":
        with pytest.raises(ref_api.SnapshotUnsupported):
            ref.snapshot()
        with pytest.raises(port_api.SnapshotUnsupported):
            port.snapshot()
        assert port.nbytes() is None and ref.nbytes() is None
        return
    ref_snap, port_snap = ref.snapshot(), port.snapshot()
    for a, b in zip(snapshot_arrays(ref_snap), snapshot_arrays(port_snap)):
        assert_same_array(a, b)
    assert (port_snap.backend, port_snap.version) == \
        (ref_snap.backend, ref_snap.version)
    assert port.snapshot() is port_snap                 # cached while current
    assert port.last_snapshot_refresh_rows == ref.last_snapshot_refresh_rows
    assert port.nbytes() == ref.nbytes()
    if ref.name == "sharded":
        # the mesh backend: its labels (label regime) or W*, freed once
        # the snapshot is derived (closure regime), as in the reference
        assert port.build_labels == ref.build_labels
        if ref.build_labels:
            assert_same_index(ref._idx, port._idx)
        assert port._w_star is None and ref._w_star is None
    else:
        assert_same_index(ref.idx, port.idx)
        assert port.construction == ref.construction == "serial"
    view = port._query_snapshot()
    assert isinstance(view, KernelSnapshot) == port.use_kernels
    assert port._query_snapshot() is view               # one view per snapshot
    snap, dirty = port.snapshot_delta(port_snap)
    assert snap is port_snap and dirty.size == 0
    assert port.snapshot_delta(None)[1] is None


def test_errors_alike(engines):
    ref, port = engines
    n = port.h.n
    for eng in (ref, port):
        for bad in (-1, n):
            with pytest.raises(IndexError, match="out of range"):
                eng.mr(bad, 0)
            with pytest.raises(IndexError, match="out of range"):
                eng.s_reach(0, bad, 1)
            with pytest.raises(IndexError, match="out of\n? ?range|out of"):
                eng.mr_batch([0, bad], [1, 2])
        with pytest.raises(ValueError, match="length mismatch"):
            eng.mr_batch([0, 1], [1])
        with pytest.raises(ValueError, match="integer dtype"):
            eng.s_reach_batch([0.5], [1.0], 1)
        with pytest.raises(ValueError, match="1-D"):
            eng.mr_batch([[0, 1]], [[1, 2]])


VALIDATE_CASES = [
    ([0, 1], [1], ValueError), ([0.5], [1.5], ValueError),
    ([[0]], [[1]], ValueError), ([0, 9], [1, 2], IndexError),
    ([-1], [0], IndexError), ([], [], None), ([3, 4], [5, 6], None),
    (np.array([1, 2], np.int8), np.array([3, 4], np.uint16), None),
]


@pytest.mark.parametrize("us,vs,exc", VALIDATE_CASES)
def test_validate_batch_alike(us, vs, exc):
    if exc is None:
        for a, b in zip(ref_api.validate_batch(us, vs, 9),
                        port_api.validate_batch(us, vs, 9)):
            assert_same_array(a, b)
        return
    with pytest.raises(exc) as ref_err:
        ref_api.validate_batch(us, vs, 9)
    with pytest.raises(exc) as port_err:
        port_api.validate_batch(us, vs, 9)
    assert str(ref_err.value) == str(port_err.value)


def _mesh(devices, axes):
    return types.SimpleNamespace(devices=np.empty(devices, object),
                                 axis_names=axes)


PLAN_CASES = [
    # (n, m, sizes, batch_hint, mesh, device_budget_bytes)
    (48, 70, (2, 6), None, None, None),
    (48, 70, (2, 6), 1000, None, None),          # tiny line graph + batches
    (300, 450, (2, 6), 1000, None, None),
    (300, 450, (2, 6), 0, None, None),
    (0, 0, (2, 3), 10, None, None),              # m == 0
    (400, 600, (2, 6), 64, _mesh((2, 2), ("data", "model")), 1000),
    (400, 600, (2, 6), 64, _mesh((2, 2), ("data", "model")), None),
    (400, 600, (2, 6), 64, _mesh((4,), ("data",)), 1000),
    (400, 600, (2, 6), 64, _mesh((1, 1), ("data", "model")), 1000),
    (60, 3000, (20, 40), 1000, None, None),      # label mass over budget
    (60, 3000, (20, 40), 10, None, None),
]


@pytest.mark.parametrize("n,m,sizes,hint,mesh,budget", PLAN_CASES)
def test_plan_backend_names_the_same_backend(n, m, sizes, hint, mesh, budget):
    kw = dict(min_size=sizes[0], max_size=sizes[1], seed=2)
    ref_h = (ref_api.random_hypergraph(n, m, **kw) if m
             else ref_api.from_edge_lists([], n=0))
    port_h = port_hypergraph(ref_h)
    want = ref_api.plan_backend(ref_h, hint, mesh=mesh,
                                device_budget_bytes=budget)
    assert port_api.plan_backend(port_h, hint, mesh=mesh,
                                 device_budget_bytes=budget) == want


def test_auto_backend_builds_or_names_what_is_missing():
    """``auto`` builds what the planner names, in both packages: hl-index
    and closure under the label budget, and past it (C-1) online for
    trickle queries and frontier for batches; the answers equal the
    reference's ``online`` and ``mst-oracle``, in value and dtype."""
    h = port_api.random_hypergraph(300, 450, seed=1)
    eng = port_api.build_engine(h, "auto", device="cpu")
    assert eng.name == "hl-index" == port_api.plan_backend(h)
    small = _graph(port_api)
    assert port_api.plan_backend(small, 1000) == "closure"
    eng = port_api.build_engine(small, "auto", batch_hint=1000, device="cpu")
    assert eng.name == "closure"
    # planning only: the graph of the test before, and C-1's graph
    for args, kw in (((60, 3000), dict(min_size=20, max_size=40, seed=2)),
                     ((1500, 40000), dict(seed=1))):
        ref_h = ref_api.random_hypergraph(*args, **kw)
        port_h = port_hypergraph(ref_h)
        for hint, want in ((None, "online"), (1024, "frontier")):
            assert port_api.plan_backend(port_h, hint) == want == \
                ref_api.plan_backend(ref_h, hint)
    assert ref_h.nnz == port_h.nnz == 159_929
    # past the budget and built in seconds: both packages build the same
    ref_h = ref_api.random_hypergraph(100, 4000, seed=3)
    port_h = port_hypergraph(ref_h)
    assert port_h.nnz * port_h.vertex_degrees.mean() > 2e6
    ref_online = ref_api.build_engine(ref_h)
    online = port_api.build_engine(port_h, device="cpu")
    assert online.name == ref_online.name == "online"
    frontier = port_api.build_engine(port_h, batch_hint=1024, device="cpu")
    assert frontier.name == ref_api.build_engine(
        ref_h, batch_hint=1024).name == "frontier"
    rng = np.random.default_rng(7)
    us, vs = rng.integers(0, port_h.n, 3), rng.integers(0, port_h.n, 3)
    want = ref_online.mr_batch(us, vs)
    oracle = ref_api.build_engine(ref_h, "mst-oracle")
    assert want.dtype == oracle.mr_batch([], []).dtype == np.int64
    # the reference oracle's forest, walked once per hyperedge of u by the
    # port's ``MSTOracle.rows`` (``mr`` takes a minute a query here)
    forest = port_api.build_engine(port_h, "mst-oracle", device="cpu").oracle
    assert forest.adj == oracle.oracle.adj
    np.testing.assert_array_equal(want, [
        forest.rows(port_h.edges_of(int(u)))[:, port_h.edges_of(int(v))]
        .max(initial=0) for u, v in zip(us, vs)])
    _same(online.mr_batch(us, vs), want)
    _same(frontier.mr_batch(us, vs), want)
    assert port_api.available_backends() == [
        "closure", "ete", "frontier", "hl-index", "hl-index-basic",
        "mst-oracle", "online", "sharded", "threshold"]
    assert port_api.available_backends() == ref_api.available_backends()


def test_not_ported_yet_raises_by_name():
    h = _graph(port_api)
    eng = port_api.build_engine(h, "hl-index", device="cpu")
    eng.update(inserts=[[1, 2, 3]])           # ported: scoped maintenance
    assert eng.version == 1
    with pytest.raises(port_api.UpdateUnsupported):
        port_api.build_engine(h, "mst-oracle", device="cpu").update(
            deletes=[0])
    # the store is ported (tests/test_torch_store.py): a missing file
    # fails as it does in the reference
    for api, opts in ((port_api, {"device": "cpu"}), (ref_api, {})):
        with pytest.raises(FileNotFoundError):
            api.build_engine(restore="somewhere.hlidx", **opts)
    with pytest.raises(ValueError, match="ambiguous"):
        port_api.build_engine(h, restore="somewhere.hlidx")
    with pytest.raises(ValueError, match="needs a hypergraph"):
        port_api.build_engine()
    # sharded construction is ported (tests/test_torch_construction.py),
    # over a logical mesh too: a 2 x 2 grid asks for it under "auto"
    serial = port_api.build_engine(h, "hl-index", device="cpu").idx
    for opts in (dict(construction="sharded"), dict(workers=2),
                 dict(num_shards=3)):
        sharded = port_api.build_engine(h, "hl-index", device="cpu", **opts)
        assert sharded.construction == "sharded"
        for f in ("rank", "perm"):
            assert_same_array(getattr(serial, f), getattr(sharded.idx, f), f)
        for x, y in zip(serial.as_padded(), sharded.idx.as_padded()):
            assert_same_array(x, y, "as_padded")
    on_mesh = port_api.build_engine(
        h, "hl-index", mesh=port_api.make_mesh((2, 2), ("data", "model"),
                                               device="cpu"))
    assert on_mesh.construction == "sharded"
    assert on_mesh.device.type == "cpu"
    for x, y in zip(serial.as_padded(), on_mesh.idx.as_padded()):
        assert_same_array(x, y, "as_padded on a mesh")
    with pytest.raises(ValueError, match="unknown construction"):
        port_api.build_engine(h, "hl-index", device="cpu",
                              construction="magic")
    # the workload ops are ported: a backend that lacks one refuses it by
    # the reference's message, one that has it answers
    oracle = port_api.build_engine(h, "mst-oracle", device="cpu")
    for e in (eng, oracle):
        for call in (lambda: e.mr_witness(0, 1),
                     lambda: e.s_reach_k(0, 1, 1, 2),
                     lambda: e.mr_set([0], [1]),
                     lambda: e.mr_from_set([0], [1]),
                     lambda: e.top_s(0, 3), lambda: e.s_distance(0, 1, 1)):
            if e is oracle:
                with pytest.raises(port_api.WorkloadUnsupported,
                                   match="workload_capabilities"):
                    call()
            else:
                assert call() is not None
    assert isinstance(eng, port_api.ReachabilityEngine)


def test_register_backend_and_prebuilt_index():
    h = _graph(port_api)
    full = port_api.build_engine(h, "hl-index", minimize_labels=False,
                                 device="cpu")
    derived = port_engine.HLIndexEngine.build(h, index=full.idx, device="cpu")
    direct = port_api.build_engine(h, "hl-index", device="cpu")
    for a, b in zip(snapshot_arrays(derived.snapshot()),
                    snapshot_arrays(direct.snapshot())):
        assert_same_array(a, b)

    class Echo(port_engine._EngineBase):
        name = "echo"

        @classmethod
        def build(cls, h, *, device=None):
            return cls(h)

        def mr(self, u, v):
            self._check_vertex_ids(u, v)
            return int(u == v)

    port_api.register_backend("echo-test", Echo)
    try:
        eng = port_api.build_engine(h, "echo-test", device="cpu")
        got = eng.mr_batch([0, 1], [0, 2])
        assert got.dtype == np.int64 and got.tolist() == [1, 0]
        assert eng.s_reach_batch([0, 1], [0, 2], 1).tolist() == [True, False]
    finally:
        del port_engine._REGISTRY["echo-test"]


def test_snapshot_patch_after_graph_change_matches_reference_update():
    """The reference engine absorbs an update; the port's versioning and
    dirty-row snapshot patching, fed the reference's edited graph, index
    and dirty rows (no update of its own), must derive a byte-identical
    snapshot by patching, and leave the old one alone."""
    chains = dict(overlap=2, extra_size=2, seed=0)   # six components
    ref = ref_api.build_engine(
        ref_api.planted_chain_hypergraph(6, 5, **chains), "hl-index")
    port = port_api.build_engine(
        port_api.planted_chain_hypergraph(6, 5, **chains), "hl-index",
        device="cpu")
    old = port.snapshot()
    old_bytes = [t.clone() for t in (old.ranks, old.svals, old.lengths)]
    ref.snapshot()
    ref.update(inserts=[[0, 1, 5, ref.h.n]], deletes=[7])   # grows n by one
    dirty = ref.dirty_rows()
    assert dirty is not None and 0 < dirty.size < ref.h.n
    port_h = port_hypergraph(ref.h)
    port.idx = port_index(ref.idx, port_h)
    port._graph_changed(port_h, dirty_rows=dirty)
    assert port.version == ref.version == 1 and old.version == 0
    assert_same_array(port.dirty_rows(), dirty)
    assert port.snapshot_cache() is old
    ref_snap, port_snap = ref.snapshot(), port.snapshot()
    for a, b in zip(snapshot_arrays(ref_snap), snapshot_arrays(port_snap)):
        assert_same_array(a, b)
    assert port_snap.version == 1 and port_snap is not old
    assert port.last_snapshot_refresh_rows == \
        ref.last_snapshot_refresh_rows == dirty.size
    assert port.dirty_rows().size == 0
    for kept, now in zip(old_bytes, (old.ranks, old.svals, old.lengths)):
        assert torch.equal(kept, now)
    rng = np.random.default_rng(8)
    us, vs = rng.integers(0, ref.h.n, 200), rng.integers(0, ref.h.n, 200)
    _same(port.mr_batch(us, vs), ref.mr_batch(us, vs))
    # a whole-structure change drops the stale snapshot at once
    port._graph_changed(port_h, dirty_rows=None)
    assert port.snapshot_cache() is None and port.dirty_rows() is None
    assert port.snapshot().version == 2
    assert port.last_snapshot_refresh_rows == port_h.n


def test_engine_build_needs_a_device_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is legal here")
    h = _graph(port_api)
    for backend in ("hl-index", "hl-index-basic", "mst-oracle", "closure",
                    "auto"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_api.build_engine(h, backend)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_engine.HLIndexEngine.build(h)
    assert_same_hypergraph(_graph(ref_api), h)


# ---------------------------------------------------------------------------
# the sharded backend on logical meshes (tests/test_engine.py's mesh cases)
# ---------------------------------------------------------------------------

def _cpu_mesh(shape, axes=("data", "model")):
    return port_api.make_mesh(shape, axes, device="cpu")


def _oracle_answers(h, us, vs):
    from repro_torch.core.baselines import MSTOracle
    oracle = MSTOracle(h)
    return np.array([oracle.mr(int(u), int(v)) for u, v in zip(us, vs)],
                    np.int64)


def test_post_update_snapshot_on_device_mesh():
    from repro_torch.core.hypergraph import apply_edge_edits
    h = port_api.random_hypergraph(26, 20, seed=6)
    mesh = _cpu_mesh((2, 2))
    eng = port_api.build_engine(h, "sharded", mesh=mesh)
    snap0 = eng.snapshot()
    eng.update(inserts=[[0, 1, 2]], deletes=[3])
    snap1 = eng.snapshot()
    assert snap1 is not snap0 and snap1.version == 1
    assert snap1.mesh == mesh
    h2, _, _ = apply_edge_edits(h, [[0, 1, 2]], [3])
    rng = np.random.default_rng(2)
    us, vs = rng.integers(0, h2.n, 40), rng.integers(0, h2.n, 40)
    want = _oracle_answers(h2, us, vs)
    np.testing.assert_array_equal(eng.mr_batch(us, vs), want)
    # to_mesh keeps answers and the version, so resharded copies of the
    # fresh snapshot stay comparable against the engine
    hl = port_api.build_engine(h2, "hl-index", device="cpu")
    hl.update(inserts=[[4, 5]])
    sh = hl.snapshot().to_mesh(mesh)
    assert sh.version == hl.version == 1
    h3, _, _ = apply_edge_edits(h2, [[4, 5]], [])
    np.testing.assert_array_equal(sh.mr(us, vs).numpy().astype(np.int64),
                                  _oracle_answers(h3, us, vs))


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (2, 2)],
                         ids=["1x1", "1x2", "2x2"])
def test_sharded_backend_on_host_mesh(shape):
    h = port_api.random_hypergraph(40, 30, seed=5)
    rng = np.random.default_rng(1)
    us, vs = rng.integers(0, h.n, 64), rng.integers(0, h.n, 64)
    want = _oracle_answers(h, us, vs)
    mesh = _cpu_mesh(shape)
    assert mesh.devices.size == int(np.prod(shape))
    for sched in ("allgather", "ring"):
        eng = port_api.build_engine(h, "sharded", mesh=mesh, schedule=sched)
        assert eng.name == "sharded" and eng.device.type == "cpu"
        got = eng.mr_batch(us, vs)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        for s in (1, 2, 3):
            np.testing.assert_array_equal(eng.s_reach_batch(us, vs, s),
                                          want >= s)
        for u, v, w in zip(us[:8], vs[:8], want[:8]):
            assert eng.mr(int(u), int(v)) == int(w)
            assert eng.s_reach(int(u), int(v), 2) == (int(w) >= 2)
        # the snapshot is built once and survives across query batches
        assert eng.snapshot() is eng.snapshot()
        assert eng.nbytes() > 0
    # mesh-aware planner: sharded iff the mesh has more than one block
    # and the closure exceeds the single-device budget
    assert port_api.plan_backend(h) != "sharded"
    picked = port_api.plan_backend(h, mesh=mesh, device_budget_bytes=0)
    assert (picked == "sharded") == (mesh.devices.size > 1), picked
    assert port_api.plan_backend(h, 64, mesh=mesh,
                                 device_budget_bytes=1 << 40) == "closure"
    if mesh.devices.size > 1:
        eng = port_api.build_engine(h, "auto", mesh=mesh,
                                    device_budget_bytes=0)
        assert eng.name == "sharded" and eng.mesh == mesh
        np.testing.assert_array_equal(eng.mr_batch(us, vs), want)
    # generic label snapshots reshard losslessly through to_mesh
    snap = port_api.build_engine(h, "hl-index", device="cpu").snapshot()
    sh = snap.to_mesh(mesh)
    assert torch.equal(sh.mr(us, vs), snap.mr(us, vs))
    assert sh.backend == "hl-index"


def test_sharded_unit_axis_mesh_degrades():
    h = port_api.random_hypergraph(25, 20, seed=9)
    rng = np.random.default_rng(2)
    us, vs = rng.integers(0, h.n, 40), rng.integers(0, h.n, 40)
    want = _oracle_answers(h, us, vs)
    mesh = _cpu_mesh((1, 1))
    for sched in ("allgather", "ring"):
        eng = port_api.build_engine(h, "sharded", mesh=mesh, schedule=sched)
        np.testing.assert_array_equal(eng.mr_batch(us, vs), want)


def test_planner_never_sharded_without_multi_device_mesh():
    h = port_api.random_hypergraph(30, 45, seed=3)
    for hint in (None, 8, 10_000):
        assert port_api.plan_backend(h, hint, device_budget_bytes=0) \
            != "sharded"
    mesh1 = _cpu_mesh((1, 1))
    assert port_api.plan_backend(h, mesh=mesh1, device_budget_bytes=0) \
        != "sharded"


def test_planner_never_sharded_on_one_axis_mesh():
    # sharded needs two mesh axes to block-partition over; auto must not
    # route a 1-D mesh to a backend that cannot be built on it
    h = port_api.random_hypergraph(30, 45, seed=3)
    mesh = _cpu_mesh((4,), ("data",))
    picked = port_api.plan_backend(h, mesh=mesh, device_budget_bytes=0)
    assert picked != "sharded", picked
    eng = port_api.build_engine(h, "auto", mesh=mesh, device_budget_bytes=0)
    assert eng.name == picked
    with pytest.raises(ValueError, match=">= 2 axes"):
        port_api.build_engine(h, "sharded", mesh=mesh)


def test_sharded_empty_hypergraph():
    h = port_api.from_edge_lists([], n=5)
    eng = port_api.build_engine(h, "sharded", device="cpu")
    assert eng.mr(0, 4) == 0
    np.testing.assert_array_equal(eng.mr_batch([0, 1], [2, 3]),
                                  np.zeros(2, np.int64))
    ref = ref_api.build_engine(ref_api.from_edge_lists([], n=5), "sharded")
    np.testing.assert_array_equal(eng.mr_batch([0, 1], [2, 3]),
                                  np.asarray(ref.mr_batch([0, 1], [2, 3])))


def test_sharded_mesh_and_device_must_agree():
    h = port_api.random_hypergraph(12, 10, seed=1)
    mesh = _cpu_mesh((2, 2))
    assert port_api.build_engine(h, "sharded", mesh=mesh,
                                 device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="differs from the mesh"):
        port_engine._REGISTRY["sharded"].build(h, mesh=mesh, device="meta")
