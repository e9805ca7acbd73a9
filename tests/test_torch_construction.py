"""Port parity, sharded HL-index construction: the port's
``build_sharded`` (component shards, optionally in a fork pool) against
the port's own serial builders and against the reference's
``build_sharded`` — ``rank``, ``perm``, every label and dual row, stats
and the padded export byte-identical (tolerance 0).  Mirrors
``tests/test_construction.py``; its 1-, 2- and 4-device mesh sweeps run
here in process on logical 1 x 1, 1 x 2 and 2 x 2 grids
(``repro_torch.core.mesh``), whose block counts stand for the device
counts."""
import functools
import types

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.core.hlindex as ref_hl
import repro.core.hypergraph as ref_hg
import repro_torch.api as port_api
import repro_torch.core.hypergraph as port_hg
from repro_torch.core.baselines import MSTOracle
from repro_torch.core.hlindex import (CONSTRUCTION_MODES, auto_device_overlaps,
                                      build_basic, build_fast, build_sharded)
from repro_torch.core.hypergraph import (apply_edge_edits, from_edge_lists,
                                         neighbor_csr,
                                         planted_chain_hypergraph,
                                         random_hypergraph)
from repro_torch.core.maintenance import apply_updates
from repro_torch.core.minimal import minimize
from repro_torch.core.query import mr_query

from util_torch_port import assert_same_index

GRAPHS = {
    "fig1": lambda mod: mod.paper_figure1(),
    "random": lambda mod: mod.random_hypergraph(30, 45, seed=3),
    "dense": lambda mod: mod.random_hypergraph(50, 80, seed=7),
    "chain": lambda mod: mod.planted_chain_hypergraph(4, 8, overlap=2,
                                                      extra_size=2, seed=1),
    "isolated": lambda mod: mod.from_edge_lists([[0, 1, 2], [2, 3],
                                                 [5, 6, 7], [6, 7, 8]], n=12),
    "empty": lambda mod: mod.from_edge_lists([], n=5),
}


def assert_index_identical(a, b, what=""):
    """Byte-for-byte equality of every array field of two HLIndexes."""
    assert np.array_equal(a.rank, b.rank) and a.rank.dtype == b.rank.dtype, what
    assert np.array_equal(a.perm, b.perm), what
    for fa, fb, name in ((a.labels_edge, b.labels_edge, "labels_edge"),
                         (a.labels_rank, b.labels_rank, "labels_rank"),
                         (a.labels_s, b.labels_s, "labels_s"),
                         (a.dual_u, b.dual_u, "dual_u"),
                         (a.dual_s, b.dual_s, "dual_s")):
        assert len(fa) == len(fb), (what, name)
        for i, (x, y) in enumerate(zip(fa, fb)):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), \
                (what, name, i, x, y)


# ---------------------------------------------------------------------------
# the shared neighbor index
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_neighbor_csr_matches_neighbors_od(graph):
    h = GRAPHS[graph](port_hg)
    nbr = neighbor_csr(h)
    assert nbr.m == h.m
    for e in range(h.m):
        nb, od = h.neighbors_od(e)
        nb2, od2 = nbr.row(e)
        np.testing.assert_array_equal(nb, nb2)
        np.testing.assert_array_equal(od, od2)
    ref = ref_hg.neighbor_csr(GRAPHS[graph](ref_hg))
    for f in ("ptr", "idx", "od"):
        a, b = getattr(ref, f), getattr(nbr, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    np.testing.assert_array_equal(ref.components(), nbr.components())


def test_neighbor_csr_induced_requires_closure():
    # the cover-check reconciliation guard: a scope that is not a union
    # of whole line-graph components must be rejected, not merged
    h = planted_chain_hypergraph(2, 4, overlap=2, extra_size=2, seed=0)
    nbr = neighbor_csr(h)
    comp = nbr.components()
    whole = np.nonzero(comp == comp[0])[0]
    sub = nbr.induced(whole)                       # whole component: fine
    assert sub.m == whole.size
    with pytest.raises(ValueError, match="neighbor-closed"):
        nbr.induced(whole[:-1])                    # split component: loud


def test_neighbor_csr_components_deterministic():
    h = from_edge_lists([[0, 1, 2], [2, 3], [5, 6, 7], [6, 7, 8]], n=12)
    comp = neighbor_csr(h).components()
    np.testing.assert_array_equal(comp, [0, 0, 1, 1])


# ---------------------------------------------------------------------------
# byte-identity: to the serial builders, across shard counts that do not
# divide evenly and through the forked worker pool, and to the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("num_shards", [1, 2, 3, 5])
def test_shard_built_byte_identical_to_build_fast(graph, num_shards):
    h = GRAPHS[graph](port_hg)
    serial = build_fast(h)
    sharded = build_sharded(h, num_shards=num_shards)
    assert_index_identical(serial, sharded, (graph, num_shards))
    assert sharded.stats["construction"] == "sharded"
    assert_same_index(ref_hl.build_sharded(GRAPHS[graph](ref_hg),
                                           num_shards=num_shards), sharded)


@pytest.mark.parametrize("graph", ["chain", "isolated"])
def test_shard_built_byte_identical_through_worker_pool(graph):
    h = GRAPHS[graph](port_hg)
    serial = build_fast(h)
    sharded = build_sharded(h, num_shards=2, workers=2)
    assert_index_identical(serial, sharded, graph)
    assert sharded.stats["pool_fallback"] == 0.0
    assert_same_index(ref_hl.build_sharded(GRAPHS[graph](ref_hg),
                                           num_shards=2, workers=2), sharded)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_shard_built_minimized_and_basic_variants(graph):
    h = GRAPHS[graph](port_hg)
    ref_h = GRAPHS[graph](ref_hg)
    # per-shard minimization == global minimization (Algorithm 4's dual
    # sets are component-confined), for both base builders
    fast_min = build_sharded(h, minimizer=minimize, num_shards=3)
    assert_index_identical(minimize(build_fast(h)), fast_min,
                           (graph, "fast-min"))
    basic_min = build_sharded(h, base=build_basic, minimizer=minimize,
                              num_shards=2)
    assert_index_identical(minimize(build_basic(h)), basic_min,
                           (graph, "basic-min"))
    from repro.core.minimal import minimize as ref_minimize
    assert_same_index(ref_hl.build_sharded(ref_h, minimizer=ref_minimize,
                                           num_shards=3), fast_min)
    assert_same_index(ref_hl.build_sharded(ref_h, base=ref_hl.build_basic,
                                           minimizer=ref_minimize,
                                           num_shards=2), basic_min)


def test_precomputed_neighbors_identity():
    h = random_hypergraph(30, 45, seed=3)
    nbr = neighbor_csr(h)
    assert_index_identical(build_fast(h), build_fast(h, neighbors=nbr))
    assert_index_identical(build_basic(h), build_basic(h, neighbors=nbr))
    # a shared CSR handed to build_sharded is sliced, never recomputed
    sharded = build_sharded(h, num_shards=4, neighbors=nbr)
    assert_index_identical(build_fast(h), sharded)
    assert sharded.stats["neighbor_reused"] == 1.0


def test_construction_modes_registry():
    assert set(CONSTRUCTION_MODES) == {"serial", "sharded"}
    assert CONSTRUCTION_MODES["serial"] is build_fast
    assert CONSTRUCTION_MODES["sharded"] is build_sharded
    assert set(CONSTRUCTION_MODES) == set(ref_hl.CONSTRUCTION_MODES)
    h = random_hypergraph(10, 8, seed=0)
    with pytest.raises(ValueError, match="unknown construction"):
        port_api.build_engine(h, "hl-index", construction="no-such-mode",
                              device="cpu")


def test_engine_construction_modes_byte_identical():
    h = random_hypergraph(30, 45, seed=3)
    serial = port_api.build_engine(h, "hl-index", construction="serial",
                                   device="cpu")
    sharded = port_api.build_engine(h, "hl-index", construction="sharded",
                                    num_shards=3, device="cpu")
    assert serial.construction == "serial"
    assert sharded.construction == "sharded"
    assert_index_identical(serial.idx, sharded.idx)
    # same for the unminimized ablation pair
    serial_b = port_api.build_engine(h, "hl-index-basic", device="cpu")
    sharded_b = port_api.build_engine(h, "hl-index-basic",
                                      construction="sharded", num_shards=2,
                                      device="cpu")
    assert_index_identical(serial_b.idx, sharded_b.idx)
    # and the reference's engines of the same mode: the builder partials
    # (which the store reads back) carry the same keywords
    import repro.api as ref_api
    ref_h = ref_hg.random_hypergraph(30, 45, seed=3)
    for port_eng, kind, opts in (
            (sharded, "hl-index", dict(num_shards=3)),
            (sharded_b, "hl-index-basic", dict(num_shards=2))):
        ref_eng = ref_api.build_engine(ref_h, kind, construction="sharded",
                                       **opts)
        assert_same_index(ref_eng.idx, port_eng.idx)
        assert port_eng._builder.keywords.keys() == \
            ref_eng._builder.keywords.keys()


@pytest.mark.parametrize("workers", [None, 2])
def test_engine_auto_construction_with_workers_on_the_cpu(workers):
    # workers / num_shards ask for sharded construction under "auto", as
    # in the reference; build(..., workers=2) runs the fork pool
    h = planted_chain_hypergraph(4, 6, overlap=2, extra_size=2, seed=2)
    opts = dict(num_shards=3) if workers is None else dict(workers=workers)
    eng = port_api.build_engine(h, "hl-index", device="cpu", **opts)
    assert eng.construction == "sharded"
    assert eng._builder.func is build_sharded
    assert_index_identical(minimize(build_fast(h)), eng.idx)
    assert eng.idx.stats["pool_fallback"] == 0.0
    us, vs = np.arange(h.n), np.arange(h.n)[::-1].copy()
    want = port_api.build_engine(h, "hl-index", device="cpu")
    np.testing.assert_array_equal(eng.mr_batch(us, vs), want.mr_batch(us, vs))


# ---------------------------------------------------------------------------
# stats regression: the paper's pruning invariants, pinned for both
# builders so a pruning regression fails loudly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("graph", ["fig1", "random", "dense", "chain"])
def test_stats_invariants_serial(graph):
    h = GRAPHS[graph](port_hg)
    fast = build_fast(h)
    # Lemma 6: N(e) is computed exactly once per hyperedge, ever
    assert 0 < fast.stats["neighbor_inits"] <= h.m
    # Algorithm 3 never runs an online cover check — MCD replaces it
    assert fast.stats["cover_checks"] == 0
    # the neighbor index never holds more than the full adjacency, and
    # eviction (lines 22-24) only shrinks it
    total_adjacency = int(np.diff(neighbor_csr(h).ptr).sum())
    assert fast.stats["m_total_inserts"] <= total_adjacency
    assert fast.stats["m_final_entries"] <= fast.stats["m_peak_entries"] \
        <= fast.stats["m_total_inserts"]
    basic = build_basic(h)
    # Algorithm 2 runs exactly one cover check per non-stale pop
    assert basic.stats["cover_checks"] == basic.stats["pops"]
    # both produce one label per (root, newly-covered vertex): counts agree
    assert fast.num_labels == basic.num_labels


@pytest.mark.parametrize("graph", ["fig1", "random", "dense", "chain"])
def test_stats_invariants_sharded(graph):
    h = GRAPHS[graph](port_hg)
    serial = build_fast(h)
    sharded = build_sharded(h, num_shards=3)
    # per-shard traversal counters sum to exactly the serial values —
    # sharding must not change how much pruned work happens, only where
    for key in ("pops", "pushes", "neighbor_inits", "m_total_inserts",
                "cover_checks", "m_final_entries"):
        assert float(sharded.stats[key]) == float(serial.stats[key]), key
    assert 0 < sharded.stats["neighbor_inits"] <= h.m
    # the sharded peak is per-shard, so it never exceeds the serial peak
    # (which interleaves components in rank order)
    assert sharded.stats["m_peak_entries"] <= serial.stats["m_peak_entries"]
    basic_sharded = build_sharded(h, base=build_basic, num_shards=2)
    basic = build_basic(h)
    assert float(basic_sharded.stats["cover_checks"]) \
        == float(basic.stats["cover_checks"]) == float(basic.stats["pops"])


# ---------------------------------------------------------------------------
# maintenance: the scoped splice composes with shard-built sub-indexes
# ---------------------------------------------------------------------------

def test_splice_accepts_shard_built_indexes():
    h = planted_chain_hypergraph(4, 6, overlap=2, extra_size=2, seed=2)
    idx_serial = build_fast(h)
    idx_sharded = build_sharded(h, num_shards=2)
    ins, dels = [[0, 1, h.n]], [1]
    h_a, idx_a, rep_a = apply_updates(h, idx_serial, ins, dels)
    h_b, idx_b, rep_b = apply_updates(
        h, idx_sharded, ins, dels,
        builder=functools.partial(build_sharded, num_shards=2))
    assert not rep_a.full_rebuild and not rep_b.full_rebuild
    np.testing.assert_array_equal(rep_a.refreshed_vertices,
                                  rep_b.refreshed_vertices)
    assert_index_identical(idx_a, idx_b)
    oracle = MSTOracle(h_a)
    rng = np.random.default_rng(0)
    for _ in range(40):
        u, v = int(rng.integers(h_a.n)), int(rng.integers(h_a.n))
        assert mr_query(idx_b, u, v) == oracle.mr(u, v)


def test_engine_update_sequences_identical_across_constructions():
    rng = np.random.default_rng(5)
    h = planted_chain_hypergraph(3, 5, overlap=2, extra_size=2, seed=3)
    serial = port_api.build_engine(h, "hl-index", construction="serial",
                                   device="cpu")
    sharded = port_api.build_engine(h, "hl-index", construction="sharded",
                                    num_shards=2, device="cpu")
    for step in range(4):
        ins = [list(rng.choice(h.n + 1, size=3, replace=False))]
        dels = [int(rng.integers(h.m))] if (step % 2 and h.m > 1) else []
        serial.update(inserts=ins, deletes=dels)
        sharded.update(inserts=ins, deletes=dels)
        h, _, _ = apply_edge_edits(h, ins, dels)
        assert_index_identical(serial.idx, sharded.idx, step)
        us, vs = rng.integers(0, h.n, 20), rng.integers(0, h.n, 20)
        np.testing.assert_array_equal(
            np.asarray(serial.mr_batch(us, vs)),
            np.asarray(sharded.mr_batch(us, vs)))


# ---------------------------------------------------------------------------
# on a logical mesh, and the refusals and the pool's fallback stat
# ---------------------------------------------------------------------------

def test_device_overlaps_forced_without_devices_raises():
    h = random_hypergraph(10, 8, seed=0)
    with pytest.raises(ValueError, match="multi-device mesh"):
        build_sharded(h, device_overlaps=True)


def test_pool_fallback_stat_recorded():
    h = planted_chain_hypergraph(4, 6, overlap=2, extra_size=2, seed=2)
    sh = build_sharded(h, num_shards=2, workers=2)
    assert sh.stats["pool_fallback"] == 0.0        # healthy pool run
    assert build_sharded(h, num_shards=2).stats["pool_fallback"] == 0.0


def test_pool_failure_is_recorded_and_rerun_inline(monkeypatch):
    # a pool that fails (here: cannot start) shows up as pool_fallback,
    # with a warning, and the inline rerun is still byte-identical
    import repro_torch.core.hlindex as port_hl
    monkeypatch.setattr(port_hl, "_run_shard_pool", lambda *a: None)
    h = planted_chain_hypergraph(4, 6, overlap=2, extra_size=2, seed=2)
    with pytest.warns(RuntimeWarning, match="inline"):
        sh = build_sharded(h, num_shards=2, workers=2)
    assert sh.stats["pool_fallback"] == 1.0
    assert_index_identical(build_fast(h), sh)


def test_mesh_is_refused_naming_a10():
    """A mesh is taken now (A10b; this test once held its refusal): on a
    logical grid of 1 and 4 blocks ``build_sharded`` defaults workers and
    shards from the block count exactly as the reference does for that
    many devices — same labels, same stats (``shards``, ``components``,
    ``pool_fallback``) — and ``build_engine`` picks sharded construction
    on the 4-block grid only."""
    ref_h = ref_hg.random_hypergraph(25, 20, seed=9)
    h = random_hypergraph(25, 20, seed=9)
    for shape in ((1, 1), (2, 2)):
        mesh = port_api.make_mesh(shape, ("data", "model"), device="cpu")
        ref_mesh = types.SimpleNamespace(
            devices=np.empty(shape, object), axis_names=("data", "model"))
        for opts in ({}, {"num_shards": 2}):
            assert_same_index(ref_hl.build_sharded(ref_h, mesh=ref_mesh,
                                                   **opts),
                              build_sharded(h, mesh=mesh, **opts))
        eng = port_api.build_engine(h, "hl-index", mesh=mesh)
        assert eng.construction == ("sharded" if mesh.devices.size > 1
                                    else "serial")
        assert eng.device.type == "cpu"
    assert auto_device_overlaps(h) == ref_hl.auto_device_overlaps(
        ref_h) is False


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (2, 2)],
                         ids=["1x1", "1x2", "2x2"])
def test_sharded_construction_on_host_mesh(shape):
    """``tests/test_construction.py``'s 1/2/4-device sweep on a logical
    grid: the mesh-computed neighbor index (the ``overlap`` kernel's
    plain version on the CPU) equals the host one row for row; shard-built
    labels equal ``build_fast`` for even and uneven shard counts, with
    and without the pool and with the overlap route forced onto the mesh;
    forcing it on a one-block grid raises; ``auto`` construction follows
    the block count; and the HL-index and ``sharded`` label-regime
    engines answer as the MST oracle before and after an update."""
    h = random_hypergraph(40, 30, seed=5)
    mesh = port_api.make_mesh(shape, ("data", "model"), device="cpu")
    nd = int(np.prod(shape))
    assert mesh.devices.size == nd
    host = neighbor_csr(h)
    dev = neighbor_csr(h, mesh=mesh)
    for f in ("ptr", "idx", "od"):
        assert np.array_equal(getattr(host, f), getattr(dev, f))
        assert getattr(host, f).dtype == getattr(dev, f).dtype
    multi = nd > 1
    if not multi:
        with pytest.raises(ValueError, match="multi-device mesh"):
            build_sharded(h, mesh=mesh, device_overlaps=True)
    serial = build_fast(h)
    for num_shards, workers, dev_ov in ((1, None, False),
                                        (3, None, multi or None),
                                        (3, 2, None), (nd, 2, multi or False)):
        assert_index_identical(serial, build_sharded(
            h, mesh=mesh, num_shards=num_shards, workers=workers,
            device_overlaps=dev_ov), (shape, num_shards, workers, dev_ov))
    eng = port_api.build_engine(h, "hl-index", mesh=mesh)
    assert eng.construction == ("sharded" if multi else "serial")
    oracle = MSTOracle(h)
    rng = np.random.default_rng(1)
    us, vs = rng.integers(0, h.n, 50), rng.integers(0, h.n, 50)
    want = np.array([oracle.mr(int(u), int(v)) for u, v in zip(us, vs)],
                    np.int64)
    for eng in (port_api.build_engine(h, "hl-index", mesh=mesh),
                port_api.build_engine(h, "sharded", mesh=mesh,
                                      build_labels=True)):
        got = np.asarray(eng.mr_batch(us, vs)).astype(np.int64)
        assert np.array_equal(got, want)
        eng.update(inserts=[[0, 1, 2]], deletes=[3])
        h2 = eng.h
        o2 = MSTOracle(h2)
        u2, v2 = rng.integers(0, h2.n, 30), rng.integers(0, h2.n, 30)
        assert np.array_equal(
            np.asarray(eng.mr_batch(u2, v2)).astype(np.int64),
            [o2.mr(int(u), int(v)) for u, v in zip(u2, v2)])


def test_label_regime_scalars_validate_vertex_ids():
    # the sharded backend's label regime short-circuits scalars to the
    # host merge-join; it must reject out-of-range ids exactly like the
    # closure regime's batch-validated path
    h = random_hypergraph(20, 15, seed=4)
    eng = port_api.build_engine(h, "sharded", build_labels=True,
                                device="cpu")
    with pytest.raises(IndexError, match="out of range"):
        eng.mr(-1, 3)
    with pytest.raises(IndexError, match="out of range"):
        eng.mr(0, h.n)
    with pytest.raises(IndexError, match="out of range"):
        eng.s_reach(-1, 3, 2)
    assert isinstance(eng.mr(0, 1), int)           # in-range still answers
    closure = port_api.build_engine(h, "sharded", device="cpu")
    with pytest.raises(IndexError, match="out of range"):
        closure.mr(-1, 3)


def test_unit_mesh_neighbor_csr_stays_on_host_path(monkeypatch):
    # a unit mesh must not detour through the mesh overlap product — and
    # either way the CSR is identical
    h = random_hypergraph(25, 20, seed=9)
    mesh = port_api.make_mesh((1, 1), ("data", "model"), device="cpu")
    host = neighbor_csr(h)

    def no_detour(*a, **k):
        raise AssertionError("a unit mesh took the mesh overlap route")
    monkeypatch.setattr(port_hg, "_mesh_overlap_matrix", no_detour)
    via_mesh = neighbor_csr(h, mesh=mesh)
    np.testing.assert_array_equal(host.idx, via_mesh.idx)
    np.testing.assert_array_equal(host.od, via_mesh.od)
    assert_index_identical(build_fast(h),
                           build_sharded(h, mesh=mesh, num_shards=2))


# ---------------------------------------------------------------------------
# hypothesis property: random hypergraphs × uneven shard counts
# ---------------------------------------------------------------------------

@st.composite
def hypergraphs(draw, max_v=16, max_e=12):
    n = draw(st.integers(3, max_v))
    m = draw(st.integers(1, max_e))
    edges = []
    for _ in range(m):
        size = draw(st.integers(1, min(6, n)))
        edge = draw(st.lists(st.integers(0, n - 1), min_size=size,
                             max_size=size, unique=True))
        edges.append(edge)
    return from_edge_lists(edges, n=n)


@settings(max_examples=20, deadline=None)
@given(hypergraphs(), st.integers(1, 7))
def test_property_shard_built_byte_identical(h, num_shards):
    serial = build_fast(h)
    sharded = build_sharded(h, num_shards=num_shards)
    assert_index_identical(serial, sharded)
    assert_index_identical(
        minimize(build_basic(h)),
        build_sharded(h, base=build_basic, minimizer=minimize,
                      num_shards=num_shards))


@settings(max_examples=10, deadline=None)
@given(hypergraphs(max_v=14, max_e=10), st.integers(2, 5))
def test_property_shard_built_queries_match_oracle(h, num_shards):
    idx = build_sharded(h, minimizer=minimize, num_shards=num_shards)
    oracle = MSTOracle(h)
    for u in range(h.n):
        for v in range(h.n):
            assert mr_query(idx, u, v) == oracle.mr(u, v)
