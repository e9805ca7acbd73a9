"""Port parity, the frontier sweeps (``repro_torch/core/frontier.py``)
against the reference's (``repro/core/frontier.py``) on ``device="cpu"``:
the cases of ``tests/test_frontier.py`` (three seeds × s in {1, 2, 4}, the
MR bisection, the 12-long chain at 3 and 12 rounds), the line graph's
tensors and host COO, the seeds, the incremental ``updated`` splice across
an insert / delete sequence, and the ``frontier`` engine.  Equality is
exact, dtype and shape included."""
import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro.core as ref_core
import repro.core.frontier as ref_frontier
import repro_torch.api as port_api
from repro_torch import convert
from repro_torch.core import frontier as port_frontier
from repro_torch.core.hypergraph import apply_edge_edits
from repro_torch.device import gpu_probe

from util_torch_port import assert_same_array, port_hypergraph

CPU = torch.device("cpu")


def _pair(ref_h):
    """(reference line graph, port line graph on the CPU) of one graph."""
    return (ref_frontier.SparseLineGraph(ref_h),
            port_frontier.SparseLineGraph(port_hypergraph(ref_h),
                                          device="cpu"))


def _queries(n, seed, q=30):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, q), rng.integers(0, n, q)


def _same_coo(ref_g, port_g):
    for a, b, f in zip(ref_g._coo, port_g._coo, ("src", "dst", "od")):
        assert_same_array(a, b, f"_coo {f}")
    for f in ("src", "dst", "od", "sizes"):
        assert_same_array(np.asarray(getattr(ref_g, f)),
                          getattr(port_g, f).numpy(), f)
    assert_same_array(ref_g.thresholds, port_g.thresholds, "thresholds")


@pytest.mark.parametrize("s", [1, 2, 4])
@pytest.mark.parametrize("seed", range(3))
def test_s_reach_equals_the_reference_and_the_oracle(seed, s):
    ref_h = ref_api.random_hypergraph(25, 35, seed=seed)
    oracle = ref_core.mr_oracle_dense(ref_h)
    ref_g, port_g = _pair(ref_h)
    us, vs = _queries(ref_h.n, seed)
    want = ref_frontier.frontier_batched_s_reach(ref_g, us, vs, s,
                                                 rounds=ref_h.m)
    got = port_frontier.frontier_batched_s_reach(port_g, us, vs, s,
                                                 rounds=ref_h.m)
    assert_same_array(want, got, "s_reach")
    np.testing.assert_array_equal(
        got, [oracle[u, v] >= s for u, v in zip(us, vs)])


@pytest.mark.parametrize("seed", range(3))
def test_mr_bisection_equals_the_reference_and_the_oracle(seed):
    ref_h = ref_api.random_hypergraph(25, 35, seed=100 + seed)
    oracle = ref_core.mr_oracle_dense(ref_h)
    ref_g, port_g = _pair(ref_h)
    us, vs = _queries(ref_h.n, seed)
    want = ref_frontier.frontier_batched_mr(ref_g, us, vs, rounds=ref_h.m)
    log = []
    got = port_frontier.frontier_batched_mr(port_g, us, vs, rounds=ref_h.m,
                                            log=log)
    assert_same_array(want, got, "mr")
    np.testing.assert_array_equal(got, [oracle[u, v] for u, v in zip(us, vs)])
    # one record per sweep: the first at the ladder's bottom, then the mids
    assert log and log[0]["s"] == int(port_g.thresholds[0])
    assert log[0]["queries"] == len(us)
    for rec in log:
        assert all(0 <= r <= rec["rounds_cap"] for r in rec["rounds"])


@pytest.mark.parametrize("rounds,reaches", [(3, False), (12, True)])
def test_chain_diameter_rounds(rounds, reaches):
    """Linear-diameter propagation: a 12-long chain needs ~12 rounds, and
    a bounded sweep stops at its bound even before the fixpoint."""
    ref_h = ref_api.planted_chain_hypergraph(1, 12, overlap=2, extra_size=2,
                                             seed=0)
    ref_g, port_g = _pair(ref_h)
    u = np.array([int(ref_h.edge(0)[0])])
    v = np.array([int(ref_h.edge(11)[-1])])
    want = ref_frontier.frontier_batched_s_reach(ref_g, u, v, 2,
                                                 rounds=rounds)
    log = []
    got = port_frontier.frontier_batched_s_reach(port_g, u, v, 2,
                                                 rounds=rounds, log=log)
    assert_same_array(want, got, "chain")
    assert bool(got[0]) is reaches
    assert log[0]["rounds"] == [rounds]        # no fixpoint before 12


@pytest.mark.parametrize("rounds", [0, 1, 2, 5, 10, 11, None])
def test_bounded_rounds_give_the_reference_bits(rounds):
    ref_h = ref_api.planted_chain_hypergraph(2, 8, overlap=2, extra_size=2,
                                             seed=1)
    ref_g, port_g = _pair(ref_h)
    rng = np.random.default_rng(5)
    us, vs = rng.integers(0, ref_h.n, 40), rng.integers(0, ref_h.n, 40)
    for s in (1, 2):
        want = ref_frontier.frontier_batched_s_reach(ref_g, us, vs, s,
                                                     rounds=rounds)
        got = port_frontier.frontier_batched_s_reach(port_g, us, vs, s,
                                                     rounds=rounds)
        assert_same_array(want, got, f"s={s} rounds={rounds}")


def test_rounds_stop_at_the_fixpoint():
    ref_h = ref_api.random_hypergraph(40, 60, seed=9)
    ref_g, port_g = _pair(ref_h)
    us, vs = _queries(ref_h.n, 9, 50)
    log = []
    got = port_frontier.frontier_batched_s_reach(port_g, us, vs, 1, log=log)
    want = ref_frontier.frontier_batched_s_reach(ref_g, us, vs, 1)
    assert_same_array(want, got, "s_reach")
    (rec,) = log
    assert rec["rounds_cap"] == ref_h.m
    # a random graph's line graph has a small diameter: the sweep ends
    # long before the reference's m rounds
    assert 1 <= rec["rounds"][0] < ref_h.m // 4
    assert rec["alive_edges"] == port_g.src.numel()


def test_dead_edges_are_dropped_before_the_rounds():
    ref_h = ref_api.random_hypergraph(30, 50, min_size=2, max_size=5, seed=2)
    _, port_g = _pair(ref_h)
    for s in (1, 2, 3):
        log = []
        port_frontier.frontier_batched_s_reach(port_g, [0], [1], s, log=log)
        assert log[0]["alive_edges"] == int((port_g.od >= s).sum())


def test_query_chunks_give_the_same_answers(monkeypatch):
    ref_h = ref_api.random_hypergraph(30, 45, seed=4)
    ref_g, port_g = _pair(ref_h)
    us, vs = _queries(ref_h.n, 4, 37)
    want = ref_frontier.frontier_batched_mr(ref_g, us, vs)
    alive = port_g.src.numel()
    # a round budget of 5 queries' gathered rows: 8 chunks at s = 1
    monkeypatch.setattr(port_frontier, "ROUND_BYTES", 5 * alive)
    log = []
    got = port_frontier.frontier_batched_mr(port_g, us, vs, log=log)
    assert_same_array(want, got, "chunked mr")
    assert log[0]["chunk_queries"] == 5 and len(log[0]["rounds"]) == 8


def test_line_graph_tensors_and_coo_equal_the_reference():
    for ref_h in (ref_api.random_hypergraph(25, 35, seed=1),
                  ref_api.paper_figure1(),
                  ref_api.from_edge_lists([[0, 1], [2, 3]], n=5),
                  ref_api.from_edge_lists([], n=3)):
        ref_g, port_g = _pair(ref_h)
        _same_coo(ref_g, port_g)
        for f in ("src", "dst", "od", "sizes"):
            t = getattr(port_g, f)
            assert t.dtype == torch.int32 and t.device == CPU
        # the reference's host half-list carried across as arrays
        carried = convert.line_graph_from_arrays(
            port_g.h, *(np.asarray(a) for a in ref_g._coo), device="cpu")
        _same_coo(ref_g, carried)
    with pytest.raises(ValueError, match="COO arrays disagree"):
        convert.line_graph_from_arrays(port_g.h, [0, 1], [1], [1, 1],
                                       device="cpu")


def test_seed_equals_the_reference_and_refuses_bad_ids():
    ref_h = ref_api.random_hypergraph(25, 35, seed=3)
    ref_g, port_g = _pair(ref_h)
    ids = [0, 24, 3, 3, 17]
    got = port_g.seed(ids)
    assert got.dtype == torch.bool and got.shape == (5, ref_h.m)
    assert_same_array(np.asarray(ref_g.seed(ids)), got.numpy(), "seed")
    assert port_g.seed([]).shape == (0, ref_h.m)
    for bad in ([25], [-1], [0, 25]):
        with pytest.raises(IndexError, match="out of range"):
            port_g.seed(bad)


def _edit_sequence(h0, rng, steps):
    """Insert / delete batches on ``h0``'s vertex range (inserts may grow
    n), every step one delete and one insert, the last a burst."""
    seq = []
    m = h0.m
    for step in range(steps):
        k = 3 if step == steps - 1 else 1
        dels = sorted({int(x) for x in rng.integers(0, m, k)})
        ins = [sorted({int(x) for x in rng.integers(0, h0.n + 1, 3)})
               for _ in range(k)]
        seq.append((ins, dels))
        m = m - len(dels) + len(ins)
    return seq


@pytest.mark.parametrize("seed", range(2))
def test_updated_splice_equals_the_reference(seed):
    ref_h = ref_api.random_hypergraph(30, 40, seed=20 + seed)
    port_h = port_hypergraph(ref_h)
    ref_g = ref_frontier.SparseLineGraph(ref_h)
    port_g = port_frontier.SparseLineGraph(port_h, device="cpu")
    rng = np.random.default_rng(seed)
    for ins, dels in _edit_sequence(ref_h, rng, 4):
        ref_h2, r_o2n, r_t = ref_core.apply_edge_edits(ref_h, ins, dels)
        port_h2, p_o2n, p_t = apply_edge_edits(port_h, ins, dels)
        assert_same_array(r_o2n, p_o2n, "old_to_new")
        assert_same_array(r_t, p_t, "touched")
        ref_g = ref_g.updated(ref_h2, r_o2n, r_t)
        port_g = port_g.updated(port_h2, p_o2n, p_t)
        _same_coo(ref_g, port_g)
        # the splice equals a line graph built from scratch
        fresh = port_frontier.SparseLineGraph(port_h2, device="cpu")
        _same_coo(ref_frontier.SparseLineGraph(ref_h2), fresh)
        assert port_g.device == CPU
        ref_h, port_h = ref_h2, port_h2
        us, vs = _queries(ref_h.n, seed, 25)
        assert_same_array(ref_frontier.frontier_batched_mr(ref_g, us, vs),
                          port_frontier.frontier_batched_mr(port_g, us, vs),
                          "mr after update")


def test_updated_to_an_empty_graph():
    ref_h = ref_api.random_hypergraph(8, 5, seed=1)
    port_h = port_hypergraph(ref_h)
    dels = list(range(ref_h.m))
    ref_h2, r_o2n, r_t = ref_core.apply_edge_edits(ref_h, (), dels)
    port_h2, p_o2n, p_t = apply_edge_edits(port_h, (), dels)
    ref_g = ref_frontier.SparseLineGraph(ref_h).updated(ref_h2, r_o2n, r_t)
    port_g = port_frontier.SparseLineGraph(port_h, device="cpu").updated(
        port_h2, p_o2n, p_t)
    _same_coo(ref_g, port_g)
    got = port_frontier.frontier_batched_mr(port_g, [0, 1], [1, 2])
    assert_same_array(ref_frontier.frontier_batched_mr(ref_g, [0, 1], [1, 2]),
                      got, "mr on an empty graph")


def test_frontier_engine_equals_the_reference_through_updates():
    ref_h = ref_api.random_hypergraph(24, 30, seed=13)
    ref = ref_api.build_engine(ref_h, "frontier")
    port = port_api.build_engine(port_hypergraph(ref_h), "frontier",
                                 device="cpu")
    assert port.name == ref.name == "frontier"
    assert port.update_capability == ref.update_capability == "incremental"
    assert port.device == CPU and port.g.device == CPU
    rng = np.random.default_rng(3)
    for step in range(3):
        us, vs = _queries(port.h.n, step, 40)
        assert_same_array(np.asarray(ref.mr_batch(us, vs)),
                          port.mr_batch(us, vs), "mr_batch")
        assert port.last_sweeps and all(
            rec["alive_edges"] <= port.g.src.numel()
            for rec in port.last_sweeps)
        for s in (1, 3):
            assert_same_array(np.asarray(ref.s_reach_batch(us, vs, s)),
                              port.s_reach_batch(us, vs, s), "s_reach")
        assert len(port.last_sweeps) == 1
        for u, v in zip(us[:4], vs[:4]):
            got, want = port.mr(int(u), int(v)), ref.mr(int(u), int(v))
            assert type(got) is type(want) and got == want
            assert port.s_reach(int(u), int(v), 2) is \
                ref.s_reach(int(u), int(v), 2)
        ins = [[int(x) for x in rng.choice(port.h.n + 1, 3, replace=False)]]
        dels = [int(rng.integers(port.h.m))]
        ref.update(inserts=ins, deletes=dels)
        port.update(inserts=ins, deletes=dels)
        assert port.version == ref.version == step + 1
        _same_coo(ref.g, port.g)
    with pytest.raises(IndexError, match="out of range"):
        port.mr_batch([0], [port.h.n])
    for u, v in zip(*_queries(port.h.n, 9, 8)):
        for s, k in ((1, 1), (1, 2), (2, 3)):
            got = port.s_reach_k(int(u), int(v), s, k)
            assert got is ref.s_reach_k(int(u), int(v), s, k)
    with pytest.raises(port_api.WorkloadUnsupported, match="top_s"):
        port.top_s(0, 3)
    with pytest.raises(port_api.SnapshotUnsupported):
        port.snapshot()


@pytest.fixture
def card():
    probe = gpu_probe()
    if not probe["cuda"]:
        pytest.skip(f"needs an NVIDIA GPU: {probe}")
    return torch.device("cuda")


@pytest.mark.gpu
def test_sweeps_on_the_card_equal_the_host(card):
    ref_h = ref_api.random_hypergraph(60, 90, seed=6)
    port_h = port_hypergraph(ref_h)
    host = port_frontier.SparseLineGraph(port_h, device="cpu")
    dev = port_frontier.SparseLineGraph(port_h, device=card)
    assert dev.src.device.type == "cuda"
    us, vs = _queries(ref_h.n, 6, 300)
    assert_same_array(port_frontier.frontier_batched_mr(host, us, vs),
                      port_frontier.frontier_batched_mr(dev, us, vs), "mr")
    for s in (1, 2, 3):
        assert_same_array(
            port_frontier.frontier_batched_s_reach(host, us, vs, s),
            port_frontier.frontier_batched_s_reach(dev, us, vs, s), "s")
