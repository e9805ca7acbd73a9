"""Port parity, scoped index maintenance: ``repro_torch.core.maintenance``
and the engines' ``update`` against ``repro``'s on the same seeded graphs
and update batches — labels byte-identical row by row, equal
``UpdateReport`` fields, patched snapshots equal to a from-scratch
derivation (tolerance 0: everything compared is an exact integer) — and
the cases of ``tests/test_maintenance.py`` on the port, answers pinned
to the dense MR oracle."""
import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro.core as ref_core
import repro_torch.api as port_api
from repro.core import maintenance as ref_mt
from repro_torch.core import maintenance as port_mt
from repro_torch.core.engine import ClosureEngine, HLIndexEngine
from repro_torch.core.hlindex import build_basic, build_fast
from repro_torch.core.hypergraph import (apply_edge_edits, from_edge_lists,
                                         neighbor_csr,
                                         planted_chain_hypergraph,
                                         random_hypergraph)
from repro_torch.core.minimal import minimize
from repro_torch.core.query import DeviceSnapshot, mr_query
from repro_torch.core.semiring import mr_oracle_dense

from util_torch_port import (assert_same_array, assert_same_hypergraph,
                             assert_same_index, port_hypergraph,
                             snapshot_arrays)


def _assert_matches_oracle(idx, h):
    oracle = mr_oracle_dense(h, device="cpu")
    for u in range(h.n):
        for v in range(h.n):
            assert mr_query(idx, u, v) == int(oracle[u, v]), (u, v)


def _edit_script(h_n, h_m, rng, steps):
    """Seeded insert/delete batches, drawn as the reference's
    ``test_batched_update_sequences_match_rebuild`` draws them; the graph
    size is tracked so every batch is legal."""
    script, n, m = [], h_n, h_m
    for _ in range(steps):
        ins, dels = [], []
        if m > 2 and rng.random() < 0.5:
            dels = [int(d) for d in rng.choice(
                m, size=int(rng.integers(1, 3)), replace=False)]
        if rng.random() < 0.8:
            size = int(rng.integers(2, 5))
            ins.append([int(x) for x in rng.choice(
                n + 2, size=min(size, n), replace=False)])
        script.append((ins, dels))
        m = m - len(dels) + len(ins)
        n = max([n] + [max(e) + 1 for e in ins])
    return script


def _assert_same_report(ref_rep, port_rep):
    assert port_rep.scope == ref_rep.scope
    assert port_rep.full_rebuild == ref_rep.full_rebuild
    assert_same_array(ref_rep.refreshed_vertices, port_rep.refreshed_vertices,
                      "refreshed_vertices")


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

GRAPHS = {
    "random-16-12": lambda mod: mod.random_hypergraph(16, 12, seed=7),
    "random-30-24": lambda mod: mod.random_hypergraph(30, 24, seed=3),
    "chains-4x6": lambda mod: mod.planted_chain_hypergraph(
        4, 6, overlap=2, extra_size=2, seed=1),
}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("construction", ["fast", "fast+minimize", "basic"])
def test_apply_updates_labels_byte_identical_to_reference(graph,
                                                          construction):
    builders = {"fast": (ref_core.build_fast, build_fast),
                "fast+minimize": (ref_core.build_fast, build_fast),
                "basic": (ref_core.build_basic, build_basic)}
    ref_builder, port_builder = builders[construction]
    ref_min = ref_core.minimize if construction == "fast+minimize" else None
    port_min = minimize if construction == "fast+minimize" else None
    ref_h = GRAPHS[graph](ref_core)
    port_h = GRAPHS[graph](port_api)
    assert_same_hypergraph(ref_h, port_h)
    ref_idx, port_idx = ref_builder(ref_h), port_builder(port_h)
    if ref_min is not None:
        ref_idx, port_idx = ref_min(ref_idx), port_min(port_idx)
    rng = np.random.default_rng(sorted(GRAPHS).index(graph))
    partial = 0
    for ins, dels in _edit_script(ref_h.n, ref_h.m, rng, steps=6):
        ref_h, ref_idx, ref_rep = ref_core.apply_updates(
            ref_h, ref_idx, inserts=ins, deletes=dels, builder=ref_builder,
            minimizer=ref_min)
        port_h, port_idx, port_rep = port_mt.apply_updates(
            port_h, port_idx, inserts=ins, deletes=dels,
            builder=port_builder, minimizer=port_min)
        assert_same_hypergraph(ref_h, port_h)
        assert_same_index(ref_idx, port_idx)
        _assert_same_report(ref_rep, port_rep)
        partial += not port_rep.full_rebuild
    if graph.startswith("chains"):
        assert partial > 0          # the splice itself was exercised


def test_apply_updates_threads_neighbor_csr_like_the_reference():
    ref_h = ref_core.random_hypergraph(16, 12, seed=5)
    port_h = random_hypergraph(16, 12, seed=5)
    ref_idx, port_idx = ref_core.build_fast(ref_h), build_fast(port_h)
    ref_nbr, port_nbr = ref_core.neighbor_csr(ref_h), neighbor_csr(port_h)
    rng = np.random.default_rng(5)
    for _ in range(3):
        ins = [[int(x) for x in rng.choice(port_h.n, size=3, replace=False)]]
        dels = [int(rng.integers(port_h.m))] if port_h.m > 1 else []
        ref_h, ref_idx, ref_rep = ref_core.apply_updates(
            ref_h, ref_idx, inserts=ins, deletes=dels, neighbors=ref_nbr)
        port_h, port_idx, port_rep = port_mt.apply_updates(
            port_h, port_idx, inserts=ins, deletes=dels, neighbors=port_nbr)
        assert_same_index(ref_idx, port_idx)
        _assert_same_report(ref_rep, port_rep)
        ref_nbr, port_nbr = ref_rep.neighbors, port_rep.neighbors
        for f in ("ptr", "idx", "od"):
            assert_same_array(getattr(ref_nbr, f), getattr(port_nbr, f), f)
        fresh = neighbor_csr(port_h)
        for f in ("ptr", "idx", "od"):
            assert_same_array(getattr(fresh, f), getattr(port_nbr, f), f)


@pytest.mark.parametrize("inserts,deletes", [
    ([[3, 1, 1, 2], [], [7]], [4, 0, 4]),
    ([[0, 1]], []),
    ([], [2]),
    ([[5, -1]], []),
    ([[0, 1]], [99]),
    ([[2, 40, 40]], [-1]),
])
def test_normalize_update_batch_like_the_reference(inserts, deletes):
    ref_h = ref_core.random_hypergraph(12, 10, seed=2)
    port_h = port_hypergraph(ref_h)
    try:
        want = ref_mt.normalize_update_batch(ref_h, inserts, deletes)
    except IndexError as err:
        with pytest.raises(IndexError, match=str(err).split(" ")[0]):
            port_mt.normalize_update_batch(port_h, inserts, deletes)
        return
    got = port_mt.normalize_update_batch(port_h, inserts, deletes)
    assert got == want
    assert all(type(x) is int for e in got[0] for x in e)
    assert all(type(x) is int for x in got[1])


ENGINES = [("hl-index", {}), ("hl-index", {"minimize_labels": False}),
           ("hl-index-basic", {}), ("closure", {"method": "maxmin"}),
           ("closure", {"method": "threshold"})]


@pytest.mark.parametrize("backend,opts", ENGINES,
                         ids=[f"{b}{sorted(o.values())}" for b, o in ENGINES])
def test_engine_update_sequence_matches_reference(backend, opts):
    chains = dict(overlap=2, extra_size=2, seed=4)
    ref = ref_api.build_engine(
        ref_api.planted_chain_hypergraph(3, 5, **chains), backend, **opts)
    port = port_api.build_engine(
        port_api.planted_chain_hypergraph(3, 5, **chains), backend,
        device="cpu", **opts)
    assert port.update_capability == ref.update_capability
    ref.snapshot()
    held = port.snapshot()
    held_bytes = [t.clone() for t in (held.ranks, held.svals, held.lengths)]
    rng = np.random.default_rng(6)
    for step in range(4):
        if step % 2 == 0:
            v0 = int(rng.integers(port.h.n))
            ins, dels = [[v0, min(v0 + 1, port.h.n - 1), port.h.n]], []
        else:
            ins, dels = [], [int(rng.integers(port.h.m))]
        ref.update(inserts=ins, deletes=dels)
        port.update(inserts=ins, deletes=dels)
        assert port.version == ref.version == step + 1
        assert_same_hypergraph(ref.h, port.h)
        ref_dirty, port_dirty = ref.dirty_rows(), port.dirty_rows()
        if ref_dirty is None:
            assert port_dirty is None
        else:
            assert_same_array(ref_dirty, port_dirty, "dirty_rows")
        if backend == "closure":
            assert_same_array(ref.w_star, port.w_star, "W*")
        else:
            assert_same_index(ref.idx, port.idx)
        ref_snap, port_snap = ref.snapshot(), port.snapshot()
        for a, b in zip(snapshot_arrays(ref_snap), snapshot_arrays(port_snap)):
            assert_same_array(a, b)
        assert port.last_snapshot_refresh_rows == \
            ref.last_snapshot_refresh_rows
        if backend != "closure":
            fresh = DeviceSnapshot.from_hlindex(port.idx, device="cpu")
            for a, b in zip(snapshot_arrays(fresh),
                            snapshot_arrays(port_snap)):
                assert_same_array(a, b)
        us = rng.integers(0, port.h.n, 60)
        vs = rng.integers(0, port.h.n, 60)
        got, want = port.mr_batch(us, vs), np.asarray(ref.mr_batch(us, vs))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # the snapshot handed out before the first update never changed
    for kept, now in zip(held_bytes, (held.ranks, held.svals, held.lengths)):
        assert torch.equal(kept, now)
    assert held.version == 0


def test_update_capabilities_as_in_the_reference():
    port_caps = port_api.update_capabilities()
    ref_caps = ref_api.update_capabilities()
    assert port_caps == {"closure": "rebuild", "ete": "unsupported",
                         "frontier": "incremental", "hl-index": "scoped",
                         "hl-index-basic": "scoped",
                         "mst-oracle": "unsupported",
                         "online": "incremental", "sharded": "scoped",
                         "threshold": "unsupported"}
    for name, cap in port_caps.items():
        assert ref_caps[name] == cap


def test_update_journals_through_an_attached_sink_before_applying():
    h = port_api.random_hypergraph(20, 16, seed=3)
    eng = port_api.build_engine(h, "hl-index", device="cpu")
    log = []

    class Sink:
        def append(self, version, inserts, deletes):
            log.append(("append", version, inserts, deletes, eng.version))

        def committed(self, engine):
            log.append(("committed", engine.version))

    sink = Sink()
    eng.attach_wal(sink)
    eng.update(inserts=[[4, 2, 2]], deletes=[3, 1, 3])
    assert log == [("append", 1, [[2, 4]], [1, 3], 0), ("committed", 1)]
    with pytest.raises(IndexError, match="out of range"):
        eng.update(deletes=[eng.h.m])       # rejected: never journaled
    assert len(log) == 2 and eng.version == 1
    assert eng.detach_wal() is sink
    eng.update(inserts=[[0, 1]])
    assert len(log) == 2 and eng.version == 2
    with pytest.raises(port_api.UpdateUnsupported):
        port_api.build_engine(h, "mst-oracle", device="cpu").update(
            inserts=[[0, 1]])


def test_closure_update_rebuilds_on_the_engine_device_and_drops_snapshot():
    h = port_api.random_hypergraph(16, 12, seed=9)
    eng = port_api.build_engine(h, "closure", device="cpu")
    assert isinstance(eng, ClosureEngine)
    eng.snapshot()
    eng.update(inserts=[[0, 3, 7]])
    assert eng.snapshot_cache() is None and eng.dirty_rows() is None
    assert set(eng.build_seconds) == {"line_graph", "closure", "host_copy"}
    h2, _, _ = apply_edge_edits(h, [[0, 3, 7]], [])
    want = port_api.build_engine(h2, "closure", device="cpu")
    assert_same_array(want.w_star, eng.w_star, "W*")
    assert eng.snapshot().version == 1
    assert eng.dirty_rows().size == 0


# ---------------------------------------------------------------------------
# the reference's maintenance cases, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_insert_matches_rebuild(seed):
    rng = np.random.default_rng(seed)
    h = random_hypergraph(20, 16, seed=seed)
    idx = build_fast(h)
    h2, idx2 = port_mt.insert_hyperedge(
        h, idx, rng.choice(20, size=4, replace=False))
    _assert_matches_oracle(idx2, h2)


@pytest.mark.parametrize("seed", range(3))
def test_delete_matches_rebuild(seed):
    rng = np.random.default_rng(seed + 10)
    h = random_hypergraph(20, 16, seed=seed + 10)
    idx = build_fast(h)
    h2, idx2 = port_mt.delete_hyperedge(h, idx, int(rng.integers(h.m)))
    _assert_matches_oracle(idx2, h2)


def test_insert_scope_is_component_local():
    h = planted_chain_hypergraph(2, 10, overlap=2, extra_size=2, seed=0)
    idx = build_fast(h)
    v0 = int(h.edge(0)[0])
    h2, idx2 = port_mt.insert_hyperedge(h, idx, [v0, v0 + 1])
    assert idx2.stats["maintenance_scope"] < h2.m
    oracle = mr_oracle_dense(h2, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(60):
        u, v = int(rng.integers(h2.n)), int(rng.integers(h2.n))
        assert mr_query(idx2, u, v) == int(oracle[u, v])


def test_construction_is_scoped():
    h = planted_chain_hypergraph(4, 8, overlap=2, extra_size=2, seed=1)
    idx = build_fast(h)
    v0 = int(h.edge(0)[0])
    h2, idx2 = port_mt.insert_hyperedge(h, idx, [v0, v0 + 1])
    assert 0 < idx2.stats["maintenance_subgraph_m"] < h2.m
    assert idx2.stats["maintenance_subgraph_m"] == \
        idx2.stats["maintenance_scope"]
    _assert_matches_oracle(idx2, h2)


def test_untouched_label_arrays_are_shared():
    h = planted_chain_hypergraph(2, 6, overlap=2, extra_size=2, seed=2)
    idx = build_fast(h)
    v0 = int(h.edge(0)[0])
    h2, idx2 = port_mt.insert_hyperedge(h, idx, [v0, v0 + 1])
    chain1_edges = set(range(6, h.m))
    shared = 0
    for u in range(h.n):
        eu = set(int(e) for e in h.edges_of(u))
        if eu and eu <= chain1_edges:
            assert idx2.labels_edge[u] is idx.labels_edge[u]
            assert idx2.labels_rank[u] is idx.labels_rank[u]
            assert idx2.labels_s[u] is idx.labels_s[u]
            shared += 1
    assert shared > 0


@pytest.mark.parametrize("use_minimizer", [False, True])
def test_batched_update_sequences_match_rebuild(use_minimizer):
    rng = np.random.default_rng(42 + use_minimizer)
    h = random_hypergraph(16, 12, seed=7)
    idx = build_fast(h)
    minimizer = minimize if use_minimizer else None
    if use_minimizer:
        idx = minimize(idx)
    for ins, dels in _edit_script(h.n, h.m, rng, steps=6):
        h, idx, report = port_mt.apply_updates(h, idx, inserts=ins,
                                               deletes=dels,
                                               minimizer=minimizer)
        assert report.full_rebuild or report.scope <= h.m
        _assert_matches_oracle(idx, h)


def test_delete_isolated_hyperedge_clears_labels():
    h = from_edge_lists([[0, 1], [5, 6], [2, 3]], n=8)
    idx = build_fast(h)
    h2, idx2 = port_mt.delete_hyperedge(h, idx, 1)
    assert idx2.stats["maintenance_scope"] == 0
    assert idx2.labels_s[5].size == 0 and idx2.labels_s[6].size == 0
    _assert_matches_oracle(idx2, h2)


def test_delete_everything():
    h = from_edge_lists([[0, 1], [1, 2]], n=3)
    idx = build_fast(h)
    h2, idx2, _ = port_mt.apply_updates(h, idx, deletes=[0, 1])
    assert h2.m == 0
    assert all(a.size == 0 for a in idx2.labels_s)
    assert mr_query(idx2, 0, 2) == 0


def test_insert_grows_vertex_set():
    h = from_edge_lists([[0, 1, 2]], n=3)
    idx = build_fast(h)
    h2, idx2 = port_mt.insert_hyperedge(h, idx, [2, 7, 9])
    assert h2.n == 10
    _assert_matches_oracle(idx2, h2)


def test_insert_merging_components_invalidates_both():
    h = planted_chain_hypergraph(2, 5, overlap=2, extra_size=2, seed=3)
    idx = build_fast(h)
    u0, u1 = int(h.edge(0)[0]), int(h.edge(5)[0])
    h2, idx2 = port_mt.insert_hyperedge(h, idx, [u0, u1])
    assert idx2.stats["maintenance_scope"] == h2.m
    _assert_matches_oracle(idx2, h2)


def test_component_of_is_the_line_graph_component():
    h = planted_chain_hypergraph(3, 4, overlap=2, extra_size=2, seed=5)
    comps = neighbor_csr(h).components()
    for seed_edge in (0, 5, h.m - 1):
        got = port_mt.component_of(h, [seed_edge])
        want = set(np.nonzero(comps == comps[seed_edge])[0].tolist())
        assert got == want
        assert port_mt.component_of(h, [seed_edge],
                                    neighbors=neighbor_csr(h)) == want
    assert port_mt.component_of(h, []) == set()


def test_hl_index_engines_patch_only_dirty_rows():
    h = planted_chain_hypergraph(4, 8, overlap=2, extra_size=2, seed=1)
    for backend in ("hl-index", "hl-index-basic"):
        eng = port_api.build_engine(h, backend, device="cpu")
        assert isinstance(eng, HLIndexEngine)
        assert eng.dirty_rows().size == 0
        eng.snapshot()
        v0 = int(h.edge(0)[0])
        eng.update(inserts=[[v0, v0 + 1]])
        dirty = eng.dirty_rows()
        assert dirty is not None and 0 < dirty.size < eng.h.n
        eng.snapshot()
        assert eng.last_snapshot_refresh_rows == dirty.size
        assert eng.dirty_rows().size == 0
