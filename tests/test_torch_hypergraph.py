"""Port parity, host substrate: ``repro_torch.core.hypergraph`` and the
MST oracle against the reference package — same seeds, identical arrays
(tolerance 0: everything here is an integer)."""
import numpy as np
import pytest

import repro.core.hypergraph as ref_hg
from repro.core.baselines import MSTOracle as RefMSTOracle
from repro.core.baselines import line_graph_edges as ref_line_graph_edges
import repro_torch.core.hypergraph as port_hg
from repro_torch.core.baselines import MSTOracle, line_graph_edges

from util_torch_port import (assert_same_array, assert_same_hypergraph,
                             port_hypergraph)

GENERATORS = [
    ("random_hypergraph", (60, 90), dict(min_size=2, max_size=7, seed=42)),
    ("random_hypergraph", (30, 45), dict(seed=17)),
    ("random_hypergraph", (5, 12), dict(min_size=3, max_size=9, seed=1)),
    ("planted_chain_hypergraph", (2, 10), dict(overlap=3, extra_size=2)),
    ("planted_chain_hypergraph", (3, 4), dict(overlap=1, extra_size=3)),
    ("colocation_hypergraph", (80, 6, 12), dict(p_checkin=0.05, seed=7)),
    ("colocation_hypergraph", (40, 3, 5), dict(p_checkin=0.1, seed=2)),
    ("paper_figure1", (), {}),
]


def _pair(name, args, kw):
    return getattr(ref_hg, name)(*args, **kw), \
        getattr(port_hg, name)(*args, **kw)


@pytest.mark.parametrize("name,args,kw", GENERATORS)
def test_generators_identical_csr(name, args, kw):
    ref_h, port_h = _pair(name, args, kw)
    assert_same_hypergraph(ref_h, port_h)
    assert ref_h.stats() == port_h.stats()
    assert_same_array(ref_h.importance_order(), port_h.importance_order())
    assert_same_array(ref_h.line_graph(), port_h.line_graph())
    assert_same_array(ref_h.to_incidence(), port_h.to_incidence())


EDGE_LISTS = [
    ([[3, 1, 1, 2], [], [0], [5, 4, 4]], None),
    ([[0, 1], [1, 2], [0, 1]], 6),
    ([], None),
    ([[]], 3),
]


@pytest.mark.parametrize("edges,n", EDGE_LISTS)
def test_from_edge_lists_identical(edges, n):
    assert_same_hypergraph(ref_hg.from_edge_lists(edges, n=n),
                           port_hg.from_edge_lists(edges, n=n))


def test_compact_identical():
    edges = [[0, 1, 2], [2, 3], [0, 1, 2], [4, 5], [3, 2], [6]]
    ref_g, ref_rep = ref_hg.compact(ref_hg.from_edge_lists(edges))
    port_g, port_rep = port_hg.compact(port_hg.from_edge_lists(edges))
    assert_same_hypergraph(ref_g, port_g)
    assert_same_array(ref_rep, port_rep)
    # nothing to drop: the same object comes back in both stacks
    h = port_hg.random_hypergraph(20, 10, seed=3)
    assert port_hg.compact(h)[0] is h


@pytest.mark.parametrize("name,args,kw", GENERATORS + [
    # dense: every vertex in about 100 hyperedges, as on email-Eu
    ("random_hypergraph", (40, 600), dict(min_size=2, max_size=12, seed=3))])
def test_neighbor_csr_identical(name, args, kw):
    ref_h, port_h = _pair(name, args, kw)
    ref_c, port_c = ref_hg.neighbor_csr(ref_h), port_hg.neighbor_csr(port_h)
    for f in ("ptr", "idx", "od"):
        assert_same_array(getattr(ref_c, f), getattr(port_c, f), f)
    assert_same_array(ref_c.components(), port_c.components())
    for e in range(port_h.m):
        nb, od = port_h.neighbors_od(e)
        row_nb, row_od = port_c.row(e)
        assert_same_array(nb, row_nb)
        assert_same_array(od, row_od)


def test_neighbor_csr_refuses_a_mesh():
    """The mesh route (A10b; refused until then): on a logical grid of
    more than one block ``neighbor_csr`` forms B·Bᵀ with the ``overlap``
    kernel's wrapper (its plain version on the CPU), once, over the
    incidence padded to a multiple of the block count, and its CSR equals
    the host route's and the reference's byte for byte."""
    from repro_torch.core.mesh import make_mesh
    from repro_torch.kernels import overlap as ov
    for args, kw in ((("paper_figure1", ()), {}),
                     (("random_hypergraph", (40, 30)), dict(seed=5))):
        ref_h, port_h = _pair(args[0], args[1], kw)
        host = port_hg.neighbor_csr(port_h)
        want = ref_hg.neighbor_csr(ref_h)
        for shape in ((1, 2), (2, 2), (2, 3)):
            mesh = make_mesh(shape, ("data", "model"), device="cpu")
            seen = []
            real = ov.overlap

            def spy(b_inc):
                seen.append(tuple(b_inc.shape))
                return real(b_inc)
            ov.overlap = spy
            try:
                got = port_hg.neighbor_csr(port_h, mesh=mesh)
            finally:
                ov.overlap = real
            blocks = int(np.prod(shape))
            assert seen == [(-(-port_h.m // blocks) * blocks, port_h.n)]
            for f in ("ptr", "idx", "od"):
                assert_same_array(getattr(host, f), getattr(got, f), f)
                assert_same_array(getattr(want, f), getattr(got, f), f)


def test_edge_edits_and_induced_identical():
    ref_h, port_h = _pair("random_hypergraph", (40, 50), dict(seed=9))
    ins, dels = [[1, 2, 3], [7, 45]], [0, 4, 17]
    ref_out = ref_hg.apply_edge_edits(ref_h, ins, dels)
    port_out = port_hg.apply_edge_edits(port_h, ins, dels)
    assert_same_hypergraph(ref_out[0], port_out[0])
    assert_same_array(ref_out[1], port_out[1], "old_to_new")
    assert_same_array(ref_out[2], port_out[2], "touched")
    ref_c = ref_hg.neighbor_csr(ref_h).updated(*ref_out)
    port_c = port_hg.neighbor_csr(port_h).updated(*port_out)
    for f in ("ptr", "idx", "od"):
        assert_same_array(getattr(ref_c, f), getattr(port_c, f), f)
    comp = port_hg.neighbor_csr(port_h).components()
    ids = np.nonzero(comp == comp[0])[0]
    ref_sub, ref_verts = ref_hg.induced_subhypergraph(ref_h, ids)
    port_sub, port_verts = port_hg.induced_subhypergraph(port_h, ids)
    assert_same_hypergraph(ref_sub, port_sub)
    assert_same_array(ref_verts, port_verts)
    ref_ind = ref_hg.neighbor_csr(ref_h).induced(ids)
    port_ind = port_hg.neighbor_csr(port_h).induced(ids)
    for f in ("ptr", "idx", "od"):
        assert_same_array(getattr(ref_ind, f), getattr(port_ind, f), f)


def test_convert_hypergraph_round_trip():
    ref_h = ref_hg.random_hypergraph(30, 40, seed=5)
    assert_same_hypergraph(ref_h, port_hypergraph(ref_h))
    with pytest.raises(ValueError):
        from repro_torch.convert import hypergraph_from_arrays
        hypergraph_from_arrays(ref_h.n + 1, ref_h.e_ptr, ref_h.e_idx,
                               ref_h.v_ptr, ref_h.v_idx)


def test_mst_oracle_equal_on_all_pairs():
    ref_h, port_h = _pair("random_hypergraph", (40, 30),
                          dict(min_size=2, max_size=5, seed=8))
    for a, b in zip(ref_line_graph_edges(ref_h), line_graph_edges(port_h)):
        assert_same_array(a, b)
    ref_o, port_o = RefMSTOracle(ref_h), MSTOracle(port_h)
    got = np.array([[port_o.mr(u, v) for v in range(40)] for u in range(40)])
    want = np.array([[ref_o.mr(u, v) for v in range(40)] for u in range(40)])
    np.testing.assert_array_equal(got, want)
    assert np.unique(got).size > 2                 # not a trivial graph
    rows = port_o.rows(range(port_h.m))            # one walk per row
    assert rows.dtype == np.int64 and rows.shape == (port_h.m, port_h.m)
    np.testing.assert_array_equal(rows, [
        [ref_o.edge_mr(a, b) for b in range(ref_h.m)] for a in range(ref_h.m)])
    assert port_o.rows([]).shape == (0, port_h.m)
