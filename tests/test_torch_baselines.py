"""Port parity, the online search and the Section IV / VII baselines
(``repro_torch/core/online.py``, ``core/baselines.py``) and their engines
(``online``, ``ete``, ``threshold``) against the reference on
``device="cpu"``: the online / ETE / threshold / VTV rows of
``tests/test_online_and_index.py`` (the paper's Figure 1 and Example 5
included), ``build_ete`` labels row by row, ``ETEEngine.snapshot()``
byte for byte, the threshold components, ``NeighborCache.updated`` across
an insert / delete sequence, the ``update`` column of
``tests/test_conformance.py`` for the four new keys, and the service over
these backends.  Equality is exact, dtype and shape included."""
import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro.core as ref_core
import repro.core.engine as ref_engine
import repro_torch.api as port_api
import repro_torch.core as port_core
from repro_torch import convert
from repro_torch.core import engine as port_engine
from repro_torch.core.hypergraph import apply_edge_edits
from repro_torch.core.semiring import mr_oracle_dense
from repro_torch.device import gpu_probe
from repro_torch.kernels import label_join as lj

from util_torch_port import (assert_same_array, port_hypergraph,
                             snapshot_arrays)

NEW_BACKENDS = ("online", "frontier", "ete", "threshold")


def _graph(seed):
    """``tests/test_online_and_index.py``'s random graphs, by seed."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(10, 35))
    m = int(rng.integers(8, 45))
    ref_h = ref_api.random_hypergraph(n, m, seed=seed)
    return ref_h, port_hypergraph(ref_h), rng


def test_paper_examples_online():
    ref_h, port_h = ref_api.paper_figure1(), port_api.paper_figure1()
    for (u, v), want in (((4, 8), 2), ((0, 11), 2)):   # Examples 1 and 4
        got = port_core.mr_online(port_h, u, v)
        assert got == want == ref_core.mr_online(ref_h, u, v)
        assert type(got) is int
    assert port_core.mr_online(port_h, 0, 9) >= 2      # Example 3
    cache = port_core.precompute_neighbors(port_h)
    for u in range(port_h.n):
        for v in range(port_h.n):
            assert port_core.mr_online(port_h, u, v, cache) == \
                ref_core.mr_online(ref_h, u, v)


def test_vtv_overestimates_example5():
    ref_h, port_h = ref_api.paper_figure1(), port_api.paper_figure1()
    oracle = mr_oracle_dense(port_h, device="cpu")
    ref_oracle = ref_core.mr_oracle_dense(ref_h)
    assert_same_array(np.asarray(ref_oracle), oracle, "oracle")
    assert oracle[0, 11] == 2
    got = port_core.vtv_query(oracle, 0, 11)
    assert got == ref_core.vtv_query(ref_oracle, 0, 11) and got >= 3
    hubs = np.array([2, 5, 9])
    assert port_core.vtv_query(oracle, 0, 11, hubs) == \
        ref_core.vtv_query(ref_oracle, 0, 11, hubs)
    assert port_core.vtv_query(oracle, 0, 11, np.empty(0, np.int64)) == 0


@pytest.mark.parametrize("seed", range(6))
def test_all_methods_match_the_reference_and_the_oracle(seed):
    ref_h, port_h, rng = _graph(seed)
    oracle = ref_core.mr_oracle_dense(ref_h)
    nc = port_core.precompute_neighbors(port_h)
    ete = port_core.build_ete(port_h)
    tci = port_core.ThresholdComponentIndex(port_h)
    mst = port_core.MSTOracle(port_h)
    ref_nc = ref_core.precompute_neighbors(ref_h)
    ref_ete = ref_core.build_ete(ref_h)
    ref_tci = ref_core.ThresholdComponentIndex(ref_h)
    for u, v in rng.integers(0, ref_h.n, (30, 2)):
        u, v = int(u), int(v)
        o = int(oracle[u, v])
        assert port_core.mr_online(port_h, u, v, nc) == o == \
            ref_core.mr_online(ref_h, u, v, ref_nc)
        assert port_core.mr_online(port_h, u, v) == o
        assert ete.mr(u, v) == o == ref_ete.mr(u, v)
        assert tci.mr(u, v) == o == ref_tci.mr(u, v)
        assert mst.mr(u, v) == o


@pytest.mark.parametrize("seed", range(6))
def test_build_ete_labels_row_by_row(seed):
    ref_h, port_h, _ = _graph(seed)
    ref_ete, ete = ref_core.build_ete(ref_h), port_core.build_ete(port_h)
    assert_same_array(ref_ete.rank, ete.rank, "rank")
    assert len(ete.labels_rank) == len(ete.labels_s) == port_h.m
    for e in range(port_h.m):
        assert_same_array(ref_ete.labels_rank[e], ete.labels_rank[e],
                          f"labels_rank[{e}]")
        assert_same_array(ref_ete.labels_s[e], ete.labels_s[e],
                          f"labels_s[{e}]")
    assert ete.num_labels == ref_ete.num_labels
    assert ete.nbytes() == ref_ete.nbytes()
    for u in range(port_h.n):
        for a, b in zip(ref_ete._merged(ref_h.edges_of(u)),
                        ete._merged(port_h.edges_of(u))):
            assert_same_array(a, b, f"merged row {u}")
    # carried across as arrays, it answers as built
    carried = convert.ete_index_from_arrays(
        port_h, np.asarray(ref_ete.rank), ref_ete.labels_rank,
        ref_ete.labels_s)
    for u, v in ((0, 1), (2, port_h.n - 1)):
        assert carried.mr(u, v) == ref_ete.mr(u, v)


@pytest.mark.parametrize("cap", [None, 2])
@pytest.mark.parametrize("seed", range(3))
def test_threshold_components_equal_the_reference(seed, cap):
    ref_h, port_h, rng = _graph(seed)
    ref_tci = ref_core.ThresholdComponentIndex(ref_h, cap=cap)
    tci = port_core.ThresholdComponentIndex(port_h, cap=cap)
    assert_same_array(ref_tci.comp, tci.comp, "comp")
    assert_same_array(ref_tci.thresholds, tci.thresholds, "thresholds")
    assert tci.nbytes() == ref_tci.nbytes()
    carried = convert.threshold_index_from_arrays(port_h, ref_tci.comp,
                                                  ref_tci.thresholds)
    for u, v in rng.integers(0, ref_h.n, (20, 2)):
        assert tci.mr(int(u), int(v)) == ref_tci.mr(int(u), int(v)) == \
            carried.mr(int(u), int(v))
    with pytest.raises(ValueError, match="comp has shape"):
        convert.threshold_index_from_arrays(port_h, ref_tci.comp[:, :1],
                                            ref_tci.thresholds)


@pytest.mark.parametrize("seed", range(2))
def test_neighbor_cache_updated_equals_the_reference(seed):
    ref_h = ref_api.random_hypergraph(30, 40, seed=30 + seed)
    port_h = port_hypergraph(ref_h)
    ref_nc = ref_core.NeighborCache(ref_h)
    nc = port_core.NeighborCache(port_h)
    rng = np.random.default_rng(seed)
    for step in range(4):
        dels = sorted({int(x) for x in rng.integers(0, port_h.m, 2)})
        ins = [sorted({int(x) for x in rng.integers(0, port_h.n + 1, 3)})]
        ref_h, r_o2n, r_t = ref_core.apply_edge_edits(ref_h, ins, dels)
        port_h, p_o2n, p_t = apply_edge_edits(port_h, ins, dels)
        ref_nc = ref_nc.updated(ref_h, r_o2n, r_t)
        nc = nc.updated(port_h, p_o2n, p_t)
        fresh = port_core.NeighborCache(port_h)
        assert len(nc.nbrs) == len(ref_nc.nbrs) == port_h.m
        for e in range(port_h.m):
            for got, want, base in ((nc.nbrs[e], ref_nc.nbrs[e],
                                     fresh.nbrs[e]),
                                    (nc.ods[e], ref_nc.ods[e],
                                     fresh.ods[e])):
                assert_same_array(want, got, f"step {step} row {e}")
                assert_same_array(base, got, f"fresh row {e}")
        assert nc.nbytes() == ref_nc.nbytes()
        assert nc(0)[0] is nc.nbrs[0]
        for u, v in rng.integers(0, port_h.n, (10, 2)):
            assert port_core.mr_online(port_h, int(u), int(v), nc) == \
                ref_core.mr_online(ref_h, int(u), int(v), ref_nc)


# -- the engines ---------------------------------------------------------------

@pytest.fixture(scope="module")
def engine_graph():
    return ref_api.random_hypergraph(48, 70, min_size=2, max_size=6, seed=21)


@pytest.mark.parametrize("backend,opts", [
    ("online", {}), ("online", {"precompute": False}), ("ete", {}),
    ("ete", {"use_kernels": True}), ("threshold", {}),
    ("threshold", {"cap": 3})],
    ids=["online", "online[no-cache]", "ete", "ete[kernels]", "threshold",
         "threshold[cap]"])
def test_engine_answers_equal_the_reference(engine_graph, backend, opts):
    ref_opts = {k: v for k, v in opts.items() if k != "use_kernels"}
    ref = ref_api.build_engine(engine_graph, backend, **ref_opts)
    port = port_api.build_engine(port_hypergraph(engine_graph), backend,
                                 device="cpu", **opts)
    assert port.name == ref.name == backend
    assert port.update_capability == ref.update_capability
    assert port.nbytes() == ref.nbytes()
    rng = np.random.default_rng(4)
    us, vs = rng.integers(0, 48, 200), rng.integers(0, 48, 200)
    for got, want in ((port.mr_batch(us, vs), ref.mr_batch(us, vs)),
                      (port.s_reach_batch(us, vs, 3),
                       ref.s_reach_batch(us, vs, 3)),
                      (port.mr_batch([], []), ref.mr_batch([], []))):
        assert_same_array(np.asarray(want), got, backend)
    for u, v in zip(us[:25], vs[:25]):
        got, want = port.mr(int(u), int(v)), ref.mr(int(u), int(v))
        assert type(got) is type(want) and got == want
        assert port.s_reach(int(u), int(v), 2) == ref.s_reach(int(u), int(v),
                                                              2)
    for bad in ((-1, 0), (0, 48)):
        with pytest.raises(IndexError, match="out of range"):
            port.mr(*bad)


def test_ete_snapshot_equals_the_reference_byte_for_byte(engine_graph):
    ref = ref_api.build_engine(engine_graph, "ete")
    port = port_api.build_engine(port_hypergraph(engine_graph), "ete",
                                 device="cpu")
    snap, ref_snap = port.snapshot(), ref.snapshot()
    for got, want, f in zip(snapshot_arrays(snap), snapshot_arrays(ref_snap),
                            ("ranks", "svals", "lengths")):
        assert_same_array(want, got, f)
    assert snap.backend == "ete" and snap.version == 0
    assert snap.device == torch.device("cpu")
    assert port.snapshot() is snap                      # cached
    assert snap.nbytes() == ref_snap.nbytes()


def test_ete_kernel_path_validates_ids_before_any_launch(engine_graph,
                                                         monkeypatch):
    """Ids are held to the snapshot's ``n`` rows on the host, before the
    join by id is reached: on the card an id outside [0, n) would trap."""
    calls = []
    real = lj.label_join_gather

    def recording(ranks, svals, us, vs):
        calls.append((ranks.shape[0], int(us.max()), int(vs.max())))
        return real(ranks, svals, us, vs)

    monkeypatch.setattr(lj, "label_join_gather", recording)
    port = port_api.build_engine(port_hypergraph(engine_graph), "ete",
                                 device="cpu", use_kernels=True)
    n = port.h.n
    assert port.snapshot().ranks.shape[0] == n
    for us, vs in (([n], [0]), ([0], [n]), ([0, 1], [2, -1])):
        with pytest.raises(IndexError, match="out of range"):
            port.mr_batch(us, vs)
        with pytest.raises(IndexError, match="out of range"):
            port.s_reach_batch(us, vs, 2)
    assert calls == []
    got = port.mr_batch([0, n - 1], [n - 1, 0])
    assert calls == [(n, n - 1, n - 1)]
    plain = port_api.build_engine(port_hypergraph(engine_graph), "ete",
                                  device="cpu")
    assert_same_array(plain.mr_batch([0, n - 1], [n - 1, 0]), got, "kernel")


# -- the update column of the conformance matrix, for the four new keys --------

GRAPHS = {
    "random": lambda api: api.random_hypergraph(30, 45, seed=3),
    "chain": lambda api: api.planted_chain_hypergraph(2, 6, overlap=2,
                                                      extra_size=2, seed=0),
    "isolated": lambda api: api.from_edge_lists(
        [[0, 1, 2], [2, 3], [5, 6, 7], [6, 7, 8]], n=12),
}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("backend", NEW_BACKENDS)
def test_update_column(backend, graph):
    ref_h = GRAPHS[graph](ref_api)
    port_h = port_hypergraph(ref_h)
    ref = ref_api.build_engine(ref_h, backend)
    eng = port_api.build_engine(port_h, backend, device="cpu")
    assert eng.version == 0
    assert eng.update_capability == ref.update_capability
    if eng.update_capability == "unsupported":
        with pytest.raises(port_api.UpdateUnsupported):
            eng.update(inserts=[[0, 1]])
        assert eng.version == 0               # refused == untouched
        return
    ins, dels = [[0, 1, port_h.n - 1]], ([2] if port_h.m > 2 else [])
    eng.update(inserts=ins, deletes=dels)
    ref.update(inserts=ins, deletes=dels)
    assert eng.version == 1
    h2, _, _ = ref_core.apply_edge_edits(ref_h, ins, dels)
    oracle = ref_core.MSTOracle(h2)
    rng = np.random.default_rng(1)
    us2 = rng.integers(0, h2.n, 40)
    vs2 = rng.integers(0, h2.n, 40)
    want2 = np.array([oracle.mr(int(u), int(v)) for u, v in zip(us2, vs2)],
                     np.int64)
    got = eng.mr_batch(us2, vs2)
    assert_same_array(np.asarray(ref.mr_batch(us2, vs2)), got, "mr_batch")
    np.testing.assert_array_equal(got, want2)
    for u, v, w in zip(us2[:8], vs2[:8], want2[:8]):
        assert eng.mr(int(u), int(v)) == int(w)
        assert eng.s_reach(int(u), int(v), 2) == (int(w) >= 2)


def test_update_capabilities_cover_every_single_device_backend():
    # every backend of the reference, the mesh backend "sharded" included
    ref_caps = ref_api.update_capabilities()
    port_caps = port_api.update_capabilities()
    assert sorted(port_caps) == sorted(ref_caps)
    assert port_caps == ref_caps
    for name in NEW_BACKENDS:
        cls = port_engine._REGISTRY[name]
        assert cls.workload_capability == \
            ref_engine._REGISTRY[name].workload_capability
    assert port_api.workload_capabilities() == \
        ref_api.workload_capabilities()


# -- the service over these backends ------------------------------------------

@pytest.mark.parametrize("backend", ["online", "frontier", "threshold"])
def test_service_over_a_snapshotless_backend_equals_the_reference(backend):
    ref_h = ref_api.random_hypergraph(20, 16, seed=8)
    ref = ref_api.serve(ref_h, backend, start=False,
                        config=ref_api.ServiceConfig(max_batch=32))
    port = port_api.serve(port_hypergraph(ref_h), backend, start=False,
                          device="cpu",
                          config=port_api.ServiceConfig(max_batch=32))
    assert port.engine.name == ref.engine.name == backend
    rng = np.random.default_rng(2)
    for step in range(2):
        specs = [(int(rng.integers(20)), int(rng.integers(20)),
                  int(rng.integers(0, 5))) for _ in range(50)]

        def reqs(api):
            return [api.MRRequest(u, v) if s == 0 else
                    api.SReachRequest(u, v, s) for u, v, s in specs]

        rf, pf = ref.submit_many(reqs(ref_api)), port.submit_many(
            reqs(port_api))
        ref.drain()
        port.drain()
        want = [f.result(timeout=60) for f in rf]
        got = [f.result(timeout=60) for f in pf]
        assert got == want
        assert [type(x) for x in got] == [type(x) for x in want]
        if port.engine.update_capability != "unsupported":
            ins = [[int(x) for x in rng.choice(21, 3, replace=False)]]
            ref.update(inserts=ins, deletes=[0])
            port.update(inserts=ins, deletes=[0])
    assert port.stats().as_dict() == ref.stats().as_dict()
    assert port.stats().kernel_batches == 0


def test_service_over_ete_joins_through_the_kernel_wrapper(engine_graph,
                                                           monkeypatch):
    launches = []
    real = lj.label_join_gather

    def counting(*args):
        launches.append(args[2].numel())
        return real(*args)

    monkeypatch.setattr(lj, "label_join_gather", counting)
    port_h = port_hypergraph(engine_graph)
    svc = port_api.serve(port_h, "ete", start=False, device="cpu",
                         config=port_api.ServiceConfig(max_batch=64,
                                                       use_kernels=True))
    assert svc.engine.name == "ete" and svc.engine.use_kernels
    rng = np.random.default_rng(6)
    us, vs = rng.integers(0, port_h.n, 150), rng.integers(0, port_h.n, 150)
    futs = [svc.submit(port_api.MRRequest(int(u), int(v)))
            for u, v in zip(us, vs)]
    svc.drain()
    got = np.array([f.result(timeout=60) for f in futs])
    plain = port_api.build_engine(port_h, "ete", device="cpu")
    np.testing.assert_array_equal(got, plain.mr_batch(us, vs))
    st = svc.stats()
    assert st.kernel_batches == st.batches == len(launches) >= 3
    with pytest.raises(port_api.UpdateUnsupported):
        svc.update(inserts=[[0, 1]])


@pytest.fixture
def card():
    probe = gpu_probe()
    if not probe["cuda"] or probe["nvcc"] is None:
        pytest.skip(f"needs an NVIDIA GPU and nvcc: {probe}")
    return torch.device("cuda")


@pytest.mark.gpu
def test_ete_kernel_batches_on_the_card_equal_the_host(engine_graph, card):
    port_h = port_hypergraph(engine_graph)
    host = port_api.build_engine(port_h, "ete", device="cpu")
    dev = port_api.build_engine(port_h, "ete", use_kernels=True, device=card)
    rng = np.random.default_rng(8)
    us, vs = rng.integers(0, port_h.n, 4096), rng.integers(0, port_h.n, 4096)
    before = lj.GATHER_LAUNCHES
    got = dev.mr_batch(us, vs)
    assert lj.GATHER_LAUNCHES == before + 1
    assert_same_array(host.mr_batch(us, vs), got, "ete on the card")
    with pytest.raises(IndexError, match="out of range"):
        dev.mr_batch([port_h.n], [0])
    assert lj.GATHER_LAUNCHES == before + 1
