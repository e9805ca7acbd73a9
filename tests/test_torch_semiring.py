"""Port parity, the dense closure path: ``repro_torch.core.semiring`` and the
``closure`` backend on ``device="cpu"`` against ``repro.core.semiring`` and
``repro``'s ``closure`` backend on the same graphs — values and dtypes,
tolerance 0 — plus the MST oracle on all pairs of a small graph and the
state carried across with ``convert.closure_engine_from_arrays``."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.api as ref_api
import repro.core.semiring as ref_sr
import repro_torch.api as port_api
from repro_torch import convert
from repro_torch.core import semiring as port_sr
from repro_torch.core.engine import ClosureEngine
from repro_torch.kernels import maxmin_matmul as mm
from repro_torch.kernels import overlap as ov
from repro_torch.kernels import threshold_closure as tc

from util_torch_port import assert_same_array, port_hypergraph, snapshot_arrays

GRAPHS = {
    "figure1": lambda api: api.paper_figure1(),
    "random-30-45": lambda api: api.random_hypergraph(30, 45, seed=17),
    "random-25-40": lambda api: api.random_hypergraph(25, 40, seed=23),
}
METHODS = ["maxmin", "threshold"]


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graphs(request):
    ref_h = GRAPHS[request.param](ref_api)
    return ref_h, port_hypergraph(ref_h)


def _same(got, want):
    """Exact equality, dtype and shape included; tensors compared on the
    host."""
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def _w(h):
    w = h.line_graph(np.int32)
    return w, jnp.asarray(w), torch.from_numpy(w)


def test_line_graph_on_the_host_and_through_overlap(graphs):
    ref_h, port_h = graphs
    want = ref_h.line_graph(np.int32)
    _same(port_sr.device_line_graph(port_h, device="cpu"), want)
    # the card's route, run here through the overlap wrapper's plain version
    b_inc = torch.from_numpy(port_h.to_incidence(np.float32))
    _same(ov.overlap(b_inc).to(torch.int32), want)


def test_maxmin_matmul_and_closures(graphs):
    ref_h, _ = graphs
    w, wj, wt = _w(ref_h)
    for block in (512, 7):
        _same(port_sr.maxmin_matmul(wt, wt, block=block),
              ref_sr.maxmin_matmul(wj, wj, block=block))
        _same(port_sr.maxmin_closure(wt, block=block),
              ref_sr.maxmin_closure(wj, block=block))
    for rounds in (1, 2):
        _same(port_sr.maxmin_closure(wt, max_rounds=rounds),
              ref_sr.maxmin_closure(wj, max_rounds=rounds))
    assert port_sr.closure_rounds_to_fixpoint(wt) == \
        ref_sr.closure_rounds_to_fixpoint(wj)
    assert port_sr.closure_rounds_to_fixpoint(wt, max_rounds=1) == \
        ref_sr.closure_rounds_to_fixpoint(wj, max_rounds=1) == 1


def test_boolean_closure(graphs):
    ref_h, _ = graphs
    w = ref_h.line_graph(np.int32)
    adj = np.maximum((w >= 2).astype(np.float32), np.eye(w.shape[0],
                                                          dtype=np.float32))
    for rounds in (None, 1):
        _same(port_sr.boolean_closure(torch.from_numpy(adj), rounds=rounds),
              ref_sr.boolean_closure(jnp.asarray(adj), rounds=rounds))


def test_thresholds_and_threshold_closure(graphs):
    ref_h, _ = graphs
    w, wj, wt = _w(ref_h)
    thr = ref_sr.distinct_thresholds(w)
    _same(port_sr.distinct_thresholds(w), thr)
    _same(port_sr.distinct_thresholds(wt), thr)
    want = ref_sr.threshold_closure_mr(wj)
    got = port_sr.threshold_closure_mr(wt)
    assert got.dtype == torch.float32          # as the reference's
    _same(got, want)
    _same(port_sr.threshold_closure_mr(wt, thr, rounds=2),
          ref_sr.threshold_closure_mr(wj, thr, rounds=2))
    # an empty ladder: zeros of W's dtype, as the reference
    _same(port_sr.threshold_closure_mr(wt, thr[:0]),
          ref_sr.threshold_closure_mr(wj, thr[:0]))


# A line graph whose overlaps exceed 256, the largest integer up to which
# bf16 is exact: the rounds run on bf16 0/1, the read-out must not.
WIDE_W = np.array([[1000, 257, 0, 0, 0, 0],
                   [257, 300, 255, 0, 0, 0],
                   [0, 255, 1000, 300, 0, 0],
                   [0, 0, 300, 1000, 0, 0],
                   [0, 0, 0, 0, 257, 1],
                   [0, 0, 0, 0, 1, 2]], np.int32)


@pytest.mark.parametrize("rounds", [None, 1])
def test_threshold_closure_with_thresholds_above_256(rounds):
    from repro.kernels import ops as ref_ops
    from repro_torch.kernels import ops as port_ops
    wj, wt = jnp.asarray(WIDE_W), torch.from_numpy(WIDE_W)
    got = port_sr.threshold_closure_mr(wt, rounds=rounds)
    _same(got, ref_sr.threshold_closure_mr(wj, rounds=rounds))
    assert {255, 257, 300, 1000} <= set(got.numpy().ravel().tolist())
    if rounds is None:
        assert torch.equal(got.to(torch.int32), port_sr.maxmin_closure(wt))
    thr = ref_sr.distinct_thresholds(WIDE_W)
    _same(port_ops.threshold_mr_kernel(wt, thr, rounds=rounds),
          ref_ops.threshold_mr_kernel(wj, thr, rounds=rounds))


def test_coarse_threshold_ladder_is_a_lower_bound(graphs):
    """tests/test_system.py::test_bucketized_thresholds_lower_bound, on
    both stacks."""
    ref_h, _ = graphs
    w, wj, wt = _w(ref_h)
    thr = port_sr.distinct_thresholds(w)
    exact = port_sr.threshold_closure_mr(wt).numpy()
    coarse = port_sr.threshold_closure_mr(wt, thr[::2]).numpy()
    _same(coarse, ref_sr.threshold_closure_mr(wj, thr[::2]))
    assert (coarse <= exact).all()
    mask = np.isin(exact, thr[::2])
    np.testing.assert_array_equal(coarse[mask], exact[mask])


@pytest.mark.parametrize("seed", range(4))
def test_closure_methods_agree(seed):
    """tests/test_property.py::test_closure_methods_agree, on random
    graphs of every shape class the property draws."""
    rng = np.random.default_rng(seed)
    h = port_api.random_hypergraph(int(rng.integers(2, 20)),
                                   int(rng.integers(1, 30)),
                                   min_size=1, max_size=5, seed=seed)
    w = torch.from_numpy(h.line_graph(np.int32))
    a = port_sr.maxmin_closure(w)
    b = port_sr.threshold_closure_mr(w).to(a.dtype)
    assert torch.equal(a, b)


@pytest.mark.parametrize("method", METHODS)
def test_mr_matrix_and_vertex_queries(graphs, method):
    ref_h, port_h = graphs
    want = ref_sr.mr_matrix(ref_h, method=method)
    got = port_sr.mr_matrix(port_h, method=method, device="cpu")
    assert isinstance(got, np.ndarray)
    _same(got, want)
    rng = np.random.default_rng(3)
    us, vs = rng.integers(0, ref_h.n, 60), rng.integers(0, ref_h.n, 60)
    _same(port_sr.vertex_mr_from_edge_mr(port_h, got, us, vs),
          ref_sr.vertex_mr_from_edge_mr(ref_h, want, us, vs))


def test_mr_oracle_dense(graphs):
    ref_h, port_h = graphs
    _same(port_sr.mr_oracle_dense(port_h, device="cpu"),
          ref_sr.mr_oracle_dense(ref_h))


def test_mr_matrix_edge_cases():
    empty = port_api.from_edge_lists([], n=0)
    ref_empty = ref_api.from_edge_lists([], n=0)
    for method in (*METHODS, "bogus"):      # m == 0 answers before checking
        _same(port_sr.mr_matrix(empty, method=method, device="cpu"),
              ref_sr.mr_matrix(ref_empty, method=method))
    h = port_api.paper_figure1()
    with pytest.raises(ValueError):
        port_sr.mr_matrix(h, method="bogus", device="cpu")
    with pytest.raises(ValueError):
        ref_sr.mr_matrix(ref_api.paper_figure1(), method="bogus")
    with pytest.raises(ValueError):
        port_sr.close_line_graph(torch.zeros((2, 2), dtype=torch.int32),
                                 "bogus")


def test_mr_matrix_without_a_card_needs_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is legal here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_sr.mr_matrix(port_api.paper_figure1())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_api.build_engine(port_api.paper_figure1(), "closure")


# -- the closure backend ---------------------------------------------------------

@pytest.fixture(scope="module", params=[
    (g, m) for g in sorted(GRAPHS) for m in METHODS],
    ids=lambda p: f"{p[0]}-{p[1]}")
def engines(request):
    name, method = request.param
    ref = ref_api.build_engine(GRAPHS[name](ref_api), "closure",
                               method=method)
    port = port_api.build_engine(port_hypergraph(ref.h), "closure",
                                 method=method, device="cpu")
    return ref, port


def _pairs(n, q=200, seed=4):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, q), rng.integers(0, n, q)


def test_closure_engine_answers_as_the_reference(engines):
    ref, port = engines
    assert isinstance(port, ClosureEngine)
    assert (port.name, port.update_capability) == \
        (ref.name, ref.update_capability) == ("closure", "rebuild")
    _same(port.w_star, ref.w_star)
    assert port.nbytes() == ref.nbytes()
    us, vs = _pairs(ref.h.n)
    _same(port.mr_batch(us, vs), ref.mr_batch(us, vs))
    for s in (1, 2, 3):
        _same(port.s_reach_batch(us, vs, s), ref.s_reach_batch(us, vs, s))
    _same(port.mr_batch([], []), ref.mr_batch([], []))
    for u, v in zip(us[:40], vs[:40]):
        want = ref.mr(int(u), int(v))
        got = port.mr(int(u), int(v))
        assert type(got) is type(want) and got == want
        assert port.s_reach(u, v, 2) == ref.s_reach(u, v, 2)
    assert set(port.build_seconds) == {"line_graph", "closure", "host_copy"}


def test_closure_snapshot_is_byte_identical(engines):
    ref, port = engines
    ref_snap, port_snap = ref.snapshot(), port.snapshot()
    for a, b in zip(snapshot_arrays(ref_snap), snapshot_arrays(port_snap)):
        assert_same_array(a, b)
    assert (port_snap.backend, port_snap.version) == \
        (ref_snap.backend, ref_snap.version)
    assert port.snapshot() is port_snap                 # cached while current
    assert port.last_snapshot_refresh_rows == ref.last_snapshot_refresh_rows
    assert port._w_star_device is None                  # released once used


def test_closure_engine_errors_and_what_is_not_ported(engines):
    ref, port = engines
    n = port.h.n
    for bad in (-1, n):
        with pytest.raises(IndexError, match="out of range"):
            port.mr(bad, 0)
        with pytest.raises(IndexError, match="out of range"):
            port.mr_batch([0, bad], [1, 2])
    with pytest.raises(ValueError, match="length mismatch"):
        port.s_reach_batch([0, 1], [1], 1)
    with pytest.raises(IndexError, match="out of range"):
        port.update(deletes=[port.h.m])       # ported: validated first
    assert port.version == 0
    assert port.workload_capability == ref.workload_capability == \
        frozenset(ref_api.WORKLOAD_OPS)
    for call in (lambda: port.top_s(n, 3), lambda: port.mr_set([0], [n]),
                 lambda: port.mr_from_set([0], [n]),
                 lambda: port.mr_witness(0, n)):
        with pytest.raises(IndexError, match="out of range"):
            call()


def test_closure_engines_equal_the_mst_oracle_on_all_pairs():
    h = port_api.random_hypergraph(24, 36, min_size=2, max_size=5, seed=9)
    oracle = port_api.build_engine(h, "mst-oracle", device="cpu")
    us, vs = np.divmod(np.arange(h.n * h.n), h.n)
    want = np.array([oracle.mr(int(u), int(v)) for u, v in zip(us, vs)])
    for method in METHODS:
        eng = port_api.build_engine(h, "closure", method=method, device="cpu")
        np.testing.assert_array_equal(eng.mr_batch(us, vs), want)


def test_closure_engine_on_an_empty_graph():
    h = port_api.from_edge_lists([], n=4)
    ref = ref_api.build_engine(ref_api.from_edge_lists([], n=4), "closure",
                               method="bogus")
    port = port_api.build_engine(h, "closure", method="bogus", device="cpu")
    _same(port.mr_batch([0, 1], [2, 3]), ref.mr_batch([0, 1], [2, 3]))
    for a, b in zip(snapshot_arrays(ref.snapshot()),
                    snapshot_arrays(port.snapshot())):
        assert_same_array(a, b)
    with pytest.raises(ValueError):
        port_api.build_engine(port_api.paper_figure1(), "closure",
                              method="bogus", device="cpu")


def test_auto_builds_closure_for_small_line_graphs_with_batches():
    for m in (70, 256):
        h = port_api.random_hypergraph(48, m, min_size=2, max_size=6, seed=21)
        assert port_api.plan_backend(h, 1000) == "closure"
        eng = port_api.build_engine(h, "auto", batch_hint=1000, device="cpu")
        assert isinstance(eng, ClosureEngine)
    h = port_api.random_hypergraph(48, 257, min_size=2, max_size=6, seed=21)
    assert port_api.build_engine(h, "auto", batch_hint=1000,
                                 device="cpu").name == "hl-index"


def test_closure_engine_carried_across_from_the_reference():
    ref = ref_api.build_engine(ref_api.random_hypergraph(30, 45, seed=17),
                               "closure", method="threshold")
    h = port_hypergraph(ref.h)
    port = convert.closure_engine_from_arrays(h, np.asarray(ref.w_star),
                                              "threshold", device="cpu")
    assert port.w_star is not ref.w_star and port.w_star.dtype == np.int32
    us, vs = _pairs(h.n, seed=6)
    _same(port.mr_batch(us, vs), ref.mr_batch(us, vs))
    assert port.mr(1, 4) == ref.mr(1, 4)
    for a, b in zip(snapshot_arrays(ref.snapshot()),
                    snapshot_arrays(port.snapshot())):
        assert_same_array(a, b)
    with pytest.raises(ValueError, match="shape"):
        convert.closure_engine_from_arrays(h, np.zeros((3, 3), np.int32),
                                           device="cpu")


def test_builds_count_no_launch_on_the_host():
    before = (mm.LAUNCHES, ov.LAUNCHES, tc.LAUNCHES)
    h = port_api.random_hypergraph(30, 45, seed=17)
    for method in METHODS:
        port_api.build_engine(h, "closure", method=method, device="cpu")
    assert (mm.LAUNCHES, ov.LAUNCHES, tc.LAUNCHES) == before
