"""The port's paper tables (``repro_torch.benchmarks.paper_tables``)
against the reference's (``benchmarks/paper_tables.py``) on the CPU:
every suite function gives the reference's row names in the reference's
order (the reference's ``Min-batched-jax`` row mapped to its two routes
here), the same counts and byte sizes, and every ``agrees-with-oracle``
row true.  Both packages read one tiny graph through the HIF route
(``make_dataset`` of a ``.hif.json`` path), so a row name holds that
path in both."""
import pathlib
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import paper_tables as ref_pt  # noqa: E402

from repro_torch.benchmarks import paper_tables as pt  # noqa: E402
from repro_torch.benchmarks import datasets  # noqa: E402
from repro_torch.api import build_engine, random_hypergraph  # noqa: E402
from repro_torch.store import write_hif  # noqa: E402

# the reference's fused-XLA batch row -> the port's rows, by route
ROUTES = {"Min-batched-jax": list(pt.BATCHED_ROUTES)}
EXACT_UNITS = ("bytes", "count", "MR", "bool")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = tmp_path_factory.mktemp("hif") / "tiny.hif.json"
    write_hif(path, random_hypergraph(40, 50, min_size=2, max_size=5,
                                      seed=3))
    return str(path)


def _mapped(rows):
    out = []
    for name, _, unit in rows:
        head, _, tail = name.rpartition(".")
        for t in ROUTES.get(tail, [tail]):
            out.append((f"{head}.{t}", unit))
    return out


def _same_rows(got, want):
    assert [(n, u) for n, _, u in got] == _mapped(want)
    exact = {n: v for n, v, u in want if u in EXACT_UNITS}
    for name, val, unit in got:
        if name in exact:
            assert float(val) == float(exact[name]), name
        assert np.isfinite(float(val)), name


SUITES = {
    "exp1": (lambda ds: pt.exp1_query_time(ds, n_q=16, device="cpu"),
             lambda ds: ref_pt.exp1_query_time(ds, n_q=16)),
    "exp1-no-online": (
        lambda ds: pt.exp1_query_time(ds, n_q=8, include_online=False,
                                      device="cpu"),
        lambda ds: ref_pt.exp1_query_time(ds, n_q=8, include_online=False)),
    "exp2": (lambda ds: pt.exp2_indexing_time(ds),
             lambda ds: ref_pt.exp2_indexing_time(ds)),
    "exp3": (lambda ds: pt.exp3_space(ds), lambda ds: ref_pt.exp3_space(ds)),
    "exp4": (lambda ds: pt.exp4_scalability(ds),
             lambda ds: ref_pt.exp4_scalability(ds)),
    "engine_suite": (lambda ds: pt.engine_suite(ds, n_q=16, device="cpu"),
                     lambda ds: ref_pt.engine_suite(ds, n_q=16)),
    "sharded_suite": (lambda ds: pt.sharded_suite(ds, n_q=16, device="cpu"),
                      lambda ds: ref_pt.sharded_suite(ds, n_q=16)),
}


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_suite_rows_are_the_reference_rows(suite, tiny):
    port, ref = SUITES[suite]
    got, want = port(tiny), ref(tiny)
    _same_rows(got, want)
    agree = [v for n, v, _ in got if n.endswith(".agrees-with-oracle")]
    if suite.endswith("suite"):
        assert agree and all(v == 1.0 for v in agree)


def test_exp5_case_study_equals_the_reference():
    got = pt.exp5_case_study(device="cpu")
    want = ref_pt.exp5_case_study()
    assert [(n, float(v), u) for n, v, u in got] == \
        [(n, float(v), u) for n, v, u in want]


def test_batched_routes_agree_and_are_timed(tiny):
    rows = dict((n, v) for n, v, _ in pt.exp1_query_time(
        tiny, n_q=16, include_online=False, device="cpu"))
    for route in pt.BATCHED_ROUTES:
        assert rows[f"exp1.{tiny}.{route}"] > 0


def test_exp1_on_a_built_engine_gives_its_rows_only(tiny):
    h = datasets.make_dataset(tiny)
    eng = build_engine(h, "hl-index", device="cpu", use_kernels=True)
    rows = pt.exp1_query_time("TINY", n_q=16, engine=eng)
    assert [n for n, _, _ in rows] == [
        "exp1.TINY.Min-reach", "exp1.TINY.Min-batched-torch-ops",
        "exp1.TINY.Min-batched-kernel"]


def test_a_disagreeing_backend_raises(tiny):
    h = datasets.make_dataset(tiny)
    us = np.arange(4)
    want = build_engine(h, "mst-oracle", device="cpu").mr_batch(us, us)
    with pytest.raises(AssertionError, match="disagrees with mst-oracle"):
        pt._bench_backend("engine.x.hl-index",
                          lambda: build_engine(h, "hl-index", device="cpu"),
                          us, us, want.astype(np.int64) + 1)


def test_suites_need_an_explicit_cpu_without_a_card(tiny):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.engine_suite(tiny, n_q=4)
