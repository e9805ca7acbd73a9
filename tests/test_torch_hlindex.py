"""Port parity, index construction: ``build_fast``, ``build_basic``,
``minimize`` and ``exact_minimize`` of ``repro_torch`` against the
reference package — ``rank``, ``perm`` and every per-vertex label row
byte-identical, plus the padded export (tolerance 0)."""
import numpy as np
import pytest

import repro.core.hypergraph as ref_hg
import repro.core.hlindex as ref_hl
import repro.core.minimal as ref_min
from repro.core.query import mr_query as ref_mr_query
import repro_torch.core.hypergraph as port_hg
import repro_torch.core.hlindex as port_hl
import repro_torch.core.minimal as port_min
from repro_torch.core.query import mr_query, mr_query_dicts, s_reach_query

from util_torch_port import assert_same_array, assert_same_index, port_index


def _pipeline_graph(mod):
    # tests/test_system.py::test_end_to_end_pipeline
    return mod.compact(mod.random_hypergraph(60, 90, min_size=2, max_size=7,
                                             seed=42))[0]


def _fuzz_graph(mod, seed):
    # tests/test_online_and_index.py::test_all_methods_match_oracle
    rng = np.random.default_rng(seed)
    n = int(rng.integers(10, 35))
    m = int(rng.integers(8, 45))
    return mod.random_hypergraph(n, m, seed=seed)


GRAPHS = {
    "pipeline": _pipeline_graph,
    "colocation": lambda mod: mod.colocation_hypergraph(
        n_people=80, n_places=6, n_days=12, p_checkin=0.05, seed=7),
    "figure1": lambda mod: mod.paper_figure1(),
    "chain": lambda mod: mod.planted_chain_hypergraph(
        2, 10, overlap=3, extra_size=2, seed=0),
    "necessity": lambda mod: mod.random_hypergraph(20, 30, seed=11),
    "empty": lambda mod: mod.from_edge_lists([], n=4),
}
GRAPHS.update({f"fuzz{seed}": (lambda mod, seed=seed: _fuzz_graph(mod, seed))
               for seed in range(6)})
GRAPHS.update({f"complete{seed}": (lambda mod, seed=seed:
                                   mod.random_hypergraph(18, 28, seed=seed))
               for seed in range(100, 104)})


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graphs(request):
    make = GRAPHS[request.param]
    return make(ref_hg), make(port_hg)


def test_build_fast_identical(graphs):
    ref_h, port_h = graphs
    assert_same_index(ref_hl.build_fast(ref_h), port_hl.build_fast(port_h))


def test_build_fast_with_neighbor_csr_identical(graphs):
    ref_h, port_h = graphs
    got = port_hl.build_fast(port_h, neighbors=port_hg.neighbor_csr(port_h))
    assert_same_index(ref_hl.build_fast(ref_h), got)


def test_build_basic_identical(graphs):
    ref_h, port_h = graphs
    assert_same_index(ref_hl.build_basic(ref_h), port_hl.build_basic(port_h))
    assert_same_index(ref_hl.build_basic(ref_h, cover_check=False),
                      port_hl.build_basic(port_h, cover_check=False))


def test_minimize_identical(graphs):
    ref_h, port_h = graphs
    assert_same_index(ref_min.minimize(ref_hl.build_fast(ref_h)),
                      port_min.minimize(port_hl.build_fast(port_h)))


def test_exact_minimize_identical(graphs):
    ref_h, port_h = graphs
    assert_same_index(ref_min.exact_minimize(ref_hl.build_fast(ref_h)),
                      port_min.exact_minimize(port_hl.build_fast(port_h)))


def test_scalar_queries_identical(graphs):
    ref_h, port_h = graphs
    if port_h.n == 0:
        return
    ref_idx = ref_min.minimize(ref_hl.build_fast(ref_h))
    port_idx = port_min.minimize(port_hl.build_fast(port_h))
    rng = np.random.default_rng(0)
    for u, v in rng.integers(0, port_h.n, (60, 2)):
        u, v = int(u), int(v)
        want = ref_mr_query(ref_idx, u, v)
        assert mr_query(port_idx, u, v) == want
        assert mr_query_dicts(port_idx.label_dict(u), port_idx.label_dict(v),
                              port_idx.rank) == want
        for s in (1, 2, 3):
            assert s_reach_query(port_idx, u, v, s) == (want >= s)


def test_converted_index_is_identical(graphs):
    ref_h, _ = graphs
    ref_idx = ref_min.minimize(ref_hl.build_fast(ref_h))
    assert_same_index(ref_idx, port_index(ref_idx))


def test_pad_label_rows_and_splice_rank_identical():
    rng = np.random.default_rng(3)
    rows_r = [np.sort(rng.choice(50, k, replace=False)).astype(np.int64)
              for k in (0, 3, 7, 1)]
    rows_s = [rng.integers(1, 9, r.size).astype(np.int64) for r in rows_r]
    for pad_to in (None, 9):
        for a, b in zip(ref_hl.pad_label_rows(rows_r, rows_s, pad_to),
                        port_hl.pad_label_rows(rows_r, rows_s, pad_to)):
            assert_same_array(a, b)
    for a, b in zip(ref_hl.pad_label_rows([], []),
                    port_hl.pad_label_rows([], [])):
        assert_same_array(a, b)
    old_rank = np.array([2, 0, 1, 3], np.int64)
    args = (old_rank, np.array([0, -1, 1, -1], np.int64),
            np.array([2, 3], np.int64), np.array([1, 0], np.int64), 4)
    assert_same_array(ref_hl.splice_rank(*args), port_hl.splice_rank(*args))
    with pytest.raises(ValueError):
        port_hl.splice_rank(old_rank, np.array([0, -1, 1, -1], np.int64),
                            np.array([2], np.int64), np.array([0], np.int64),
                            4)


def test_construction_modes_are_a_subset_of_the_reference():
    assert set(port_hl.CONSTRUCTION_MODES) == {"serial", "sharded"}
    assert set(port_hl.CONSTRUCTION_MODES) <= set(ref_hl.CONSTRUCTION_MODES)
    assert port_hl.CONSTRUCTION_MODES["serial"] is port_hl.build_fast
    assert port_hl.CONSTRUCTION_MODES["sharded"] is port_hl.build_sharded
