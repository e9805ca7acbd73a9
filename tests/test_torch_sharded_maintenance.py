"""Port parity, scoped maintenance of the ``sharded`` backend: the cases of
``tests/test_sharded_maintenance.py`` and
``tests/test_sharded_maintenance_property.py`` on the port
(``device="cpu"``).  Both regimes must answer, after every edit, exactly as
a fresh port build of the same regime, as the port's ``MSTOracle``, and
as the reference's ``sharded`` engine taken through the same edits — on
one-block meshes and, in process, on logical 2- and 4-block grids (the
reference's multi-device churn runs in subprocesses) — while reporting
true dirty rows so replica serving patches rows instead of re-landing."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.api as ref_api
import repro_torch.api as port_api
from repro_torch.core.baselines import MSTOracle
from repro_torch.core.distributed import ShardedEngine
from repro_torch.core.hypergraph import (apply_edge_edits, from_edge_lists,
                                         planted_chain_hypergraph)

from util_torch_port import port_hypergraph

TIMEOUT = 60


def _mesh(shape=(1, 1)):
    return port_api.make_mesh(shape, ("data", "model"), device="cpu")


def _all_pairs(h):
    us, vs = np.meshgrid(np.arange(h.n), np.arange(h.n))
    return us.ravel(), vs.ravel()


def _assert_matches_fresh(eng, h, *, labels, mesh=None, ref=None):
    """Every pair answered identically to a from-scratch port build of the
    same regime on the same mesh, to the MST oracle, and (given) to the
    reference engine taken through the same edits."""
    mesh = eng.mesh if mesh is None else mesh
    fresh = port_api.build_engine(h, "sharded", build_labels=labels,
                                  mesh=mesh)
    if h.n == 0:
        return
    us, vs = _all_pairs(h)
    got = eng.mr_batch(us, vs)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, fresh.mr_batch(us, vs))
    mst = MSTOracle(h)
    want = np.array([mst.mr(int(u), int(v)) for u, v in zip(us, vs)],
                    np.int64)
    np.testing.assert_array_equal(got, want)
    if ref is not None:
        np.testing.assert_array_equal(
            got, np.asarray(ref.mr_batch(us, vs)).astype(np.int64))


def test_sharded_capability_is_scoped():
    assert port_api.update_capabilities()["sharded"] == "scoped" == \
        ref_api.update_capabilities()["sharded"]
    assert ShardedEngine.update_capability == "scoped"


@pytest.mark.parametrize("labels", [False, True], ids=["closure", "labels"])
def test_deterministic_churn_matches_fresh(labels):
    # insert-only, delete-only, mixed, component-merging, vertex-growing
    ref_h = ref_api.planted_chain_hypergraph(3, 4, overlap=2, extra_size=2,
                                             seed=0)
    h = port_hypergraph(ref_h)
    eng = port_api.build_engine(h, "sharded", build_labels=labels,
                                device="cpu")
    ref = ref_api.build_engine(ref_h, "sharded", build_labels=labels)
    script = [
        ([[0, 1, 2]], []),                     # insert into chain 0
        ([], [0]),                             # delete a chain-0 edge
        ([[0, 5], [2, 3, 4]], [1, 3]),         # mixed batch
        ([[int(h.edge(0)[0]), h.n + 1]], []),  # grow the vertex set
    ]
    for ins, dels in script:
        cur = eng.h
        dels = [d for d in dels if d < cur.m]
        eng.update(inserts=ins, deletes=dels)
        ref.update(inserts=ins, deletes=dels)
        h2, _, _ = apply_edge_edits(cur, ins, dels)
        _assert_matches_fresh(eng, h2, labels=labels, ref=ref)


@pytest.mark.parametrize("labels", [False, True], ids=["closure", "labels"])
def test_update_to_empty_and_back(labels):
    h = from_edge_lists([[0, 1], [1, 2], [3, 4]], n=5)
    eng = port_api.build_engine(h, "sharded", build_labels=labels,
                                device="cpu")
    eng.update(deletes=list(range(h.m)))
    assert eng.h.m == 0
    assert int(eng.mr(0, 2)) == 0 and int(eng.mr(1, 1)) == 0
    eng.update(inserts=[[0, 1, 2], [2, 3]])
    h2 = from_edge_lists([[0, 1, 2], [2, 3]], n=5)
    _assert_matches_fresh(eng, h2, labels=labels)
    # and once more past the original edge count (slot-space growth)
    eng.update(inserts=[[3, 4], [0, 4], [1, 3, 4]])
    h3 = from_edge_lists([[0, 1, 2], [2, 3], [3, 4], [0, 4], [1, 3, 4]],
                         n=5)
    _assert_matches_fresh(eng, h3, labels=labels)


@pytest.mark.parametrize("labels", [False, True], ids=["closure", "labels"])
def test_component_local_edit_reports_dirty_rows(labels):
    h = planted_chain_hypergraph(4, 4, overlap=2, extra_size=2, seed=1)
    eng = port_api.build_engine(h, "sharded", build_labels=labels,
                                device="cpu")
    basis = eng.snapshot()
    v0 = int(h.edge(0)[0])
    eng.update(inserts=[[v0, v0 + 1, v0 + 2]])
    snap, dirty = eng.snapshot_delta(basis)
    assert dirty is not None, "scoped update degraded to a full reland"
    assert 0 < dirty.size < h.n
    assert eng.last_snapshot_refresh_rows == dirty.size
    assert snap.version == eng.version
    # the patched snapshot is a new one: the basis was never written
    assert snap is not basis and basis.version == 0
    assert snap.mesh == basis.mesh == eng.mesh


def test_replica_group_sharded_churn_patches_rows():
    # under sharded churn the replica group fans out row patches, never
    # whole re-lands after the first
    edges = [[0, 1, 2], [1, 2, 3],            # chain A
             [10, 11, 12], [11, 12, 13]]      # chain B
    for i in range(6):                         # chain C pins the geometry
        edges.append([20 + 2 * i, 21 + 2 * i, 22 + 2 * i, 23 + 2 * i])
    h = from_edge_lists(edges)
    rng = np.random.default_rng(7)
    script = [([[0, 1, 3]], [0]),              # swap a chain-A edge
              ([[10, 12, 13]], [1]),           # swap a chain-B edge
              ([[0, 1, 2, 3]], [0])]           # and chain A again
    for labels in (False, True):
        eng = port_api.build_engine(h, "sharded", build_labels=labels,
                                    device="cpu")
        grp = port_api.ReplicaGroup(
            eng, 3, mesh=port_api.default_line_graph_mesh(device="cpu"),
            config=port_api.ServiceConfig(max_batch=32), start=False)
        for ins, dels in script:
            cur = grp.engine.h
            mst = MSTOracle(cur)
            reqs = [port_api.MRRequest(int(rng.integers(cur.n)),
                                       int(rng.integers(cur.n)))
                    for _ in range(40)]
            futs = grp.submit_many(reqs)
            grp.drain()
            for rq, f in zip(reqs, futs):
                assert f.result(timeout=TIMEOUT) == mst.mr(rq.u, rq.v)
            grp.update(inserts=ins, deletes=dels)
        grp.submit(port_api.MRRequest(0, 3))
        grp.drain()
        rstats = grp.replica_stats()
        assert all(r["full_relands"] == 1 for r in rstats), (labels, rstats)
        assert all(r["rows_patched"] > 0 for r in rstats), (labels, rstats)


def test_wal_attached_closure_engine_retains_w_star():
    # with a WAL attached snapshot() keeps the resident W*, the basis of
    # the next scoped update, which patches it in place
    class _Sink:
        def append(self, version, inserts, deletes):
            pass

        def committed(self, engine):
            pass

    h = planted_chain_hypergraph(3, 3, overlap=2, extra_size=2, seed=2)
    eng = port_api.build_engine(h, "sharded", device="cpu")
    eng.attach_wal(_Sink())
    eng.snapshot()
    assert eng._w_star is not None
    w_ptr = eng._w_star.data_ptr()
    basis = eng.snapshot()
    v0 = int(h.edge(0)[0])
    # a swap reuses the freed slot, so the padded slot space keeps its
    # size and _closure_patcher writes W* in place
    eng.update(inserts=[[v0, v0 + 1]], deletes=[0])
    assert eng._w_star.data_ptr() == w_ptr
    _, dirty = eng.snapshot_delta(basis)
    assert dirty is not None and 0 < dirty.size < h.n
    h2, _, _ = apply_edge_edits(h, [[v0, v0 + 1]], [0])
    _assert_matches_fresh(eng, h2, labels=False)
    # the patched W* equals a fresh build's, slot for slot
    fresh = port_api.build_engine(h2, "sharded", device="cpu")
    slots = eng._slot_of
    np.testing.assert_array_equal(
        eng._w_star.numpy()[np.ix_(slots, slots)],
        fresh._w_star.numpy()[:h2.m, :h2.m])


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["2", "4"])
def test_multi_device_scoped_churn(shape):
    """The reference's multi-device churn script on logical 2- and 4-block
    grids: W* slot growth pads to the grid, snapshots stay on the mesh,
    and every step answers as a fresh build, the oracle and the
    reference."""
    mesh = _mesh(shape)
    for labels in (False, True):
        ref_h = ref_api.planted_chain_hypergraph(4, 4, overlap=2,
                                                 extra_size=2, seed=0)
        eng = port_api.build_engine(port_hypergraph(ref_h), "sharded",
                                    build_labels=labels, mesh=mesh)
        ref = ref_api.build_engine(ref_h, "sharded", build_labels=labels)
        script = [([[0, 1, 2]], []), ([], [0]),
                  ([[0, 5], [2, 3, 4]], [1, 3]),
                  ([], list(range(6))), ([[0, 1], [1, 2, 3]], [])]
        lcm = int(np.lcm(*shape))
        for ins, dels in script:
            cur = eng.h
            dels = [d for d in dels if d < cur.m]
            eng.update(inserts=ins, deletes=dels)
            ref.update(inserts=ins, deletes=dels)
            h2, _, _ = apply_edge_edits(cur, ins, dels)
            _assert_matches_fresh(eng, h2, labels=labels, ref=ref)
            snap = eng.snapshot()
            if snap.ranks.numel():
                assert snap.mesh == mesh
            if not labels:
                assert eng._m_padded % lcm == 0
        assert eng.update_capability == "scoped"


@st.composite
def _hypergraphs(draw, max_v=12, max_e=8):
    n = draw(st.integers(3, max_v))
    m = draw(st.integers(1, max_e))
    edges = []
    for _ in range(m):
        size = draw(st.integers(1, min(5, n)))
        edges.append(draw(st.lists(st.integers(0, n - 1), min_size=size,
                                   max_size=size, unique=True)))
    return from_edge_lists(edges, n=n)


@st.composite
def _edit_scripts(draw, steps=3):
    script = []
    for _ in range(draw(st.integers(1, steps))):
        n_ins = draw(st.integers(0, 2))
        inserts = [draw(st.lists(st.integers(0, 13), min_size=2,
                                 max_size=4, unique=True))
                   for _ in range(n_ins)]
        deletes = draw(st.lists(st.floats(0, 1), min_size=0, max_size=2))
        script.append((inserts, deletes))
    return script


@pytest.mark.parametrize("labels", [False, True], ids=["closure", "labels"])
@settings(max_examples=5, deadline=None)
@given(_hypergraphs(), _edit_scripts())
def test_scoped_equals_fresh_rebuild_every_step(labels, h, script):
    eng = port_api.build_engine(h, "sharded", build_labels=labels,
                                device="cpu")
    for inserts, delete_fracs in script:
        deletes = sorted({int(f * (h.m - 1)) for f in delete_fracs
                          if h.m > 0})
        eng.update(inserts=inserts, deletes=deletes)
        h, _, _ = apply_edge_edits(h, inserts, deletes)
        _assert_matches_fresh(eng, h, labels=labels)
