"""Port parity, the workload rows of the conformance matrix
(``tests/test_conformance.py``): every port backend (and ``hl-index``
with the kernel path) x every workload op, on the reference's suite
graphs, held three ways at tolerance 0 — against the same backend of the
reference (values, types, witness walks), against the port's independent
``brute_force_*`` references, and the port's ``brute_force_*`` against
the reference's.  A cell the capability table leaves out must raise
``WorkloadUnsupported`` in both packages (asserted, never skipped).  The
last rows repeat every served op after an ``update``."""
import dataclasses
import os
import tempfile

import numpy as np
import pytest

import repro.api as ref_api
import repro.core as ref_core
import repro_torch.api as port_api
import repro_torch.core as port_core
from repro_torch.core.baselines import MSTOracle
from repro_torch.workloads import verify_witness

from util_torch_port import assert_same_array, port_hypergraph

BACKENDS = port_api.available_backends()

# the reference's pinned table (tests/test_conformance.py)
_ALL_OPS = {op: True for op in port_api.WORKLOAD_OPS}
_NO_OPS = {op: False for op in port_api.WORKLOAD_OPS}
_LABEL_ONLY = dict(_NO_OPS, witness=True, mr_set=True, top_s=True)
_TRAVERSAL_ONLY = dict(_NO_OPS, s_reach_k=True, s_distance=True)
EXPECTED_WORKLOADS = {
    "hl-index": _ALL_OPS, "hl-index-basic": _ALL_OPS, "closure": _ALL_OPS,
    "sharded": _ALL_OPS, "ete": _LABEL_ONLY,
    "online": _TRAVERSAL_ONLY, "frontier": _TRAVERSAL_ONLY,
    "threshold": _NO_OPS, "mst-oracle": _NO_OPS,
}

# matrix rows: every port backend under default options, plus the kernel
# path (label_join_gather; maxmin_matmul for the sharded closure; their
# plain versions on the CPU), the sharded backend's label regime, and the
# sharded round trip through the store (build -> save_index -> load_index,
# then the full op set: a restored engine meets the same bar); the
# reference side of each row is the same backend under default options
CONFIGS = {name: (name, {}) for name in BACKENDS}
CONFIGS["hl-index[kernels]"] = ("hl-index", dict(use_kernels=True))
CONFIGS["sharded[labels]"] = ("sharded", dict(build_labels=True))
CONFIGS["sharded[restored]"] = ("sharded", dict(_restore=True))
CONFIGS["sharded[kernels]"] = ("sharded", dict(use_kernels=True))
CONFIG_NAMES = sorted(CONFIGS)

# TemporaryDirectory handles for the restored rows: the loaded engines
# hold zero-copy views into the checkpoint mmap, so the files must
# outlive every test that queries them
_RESTORE_DIRS = []


def _build(h, config):
    """The port's engine of one matrix row on the CPU; ``_restore`` rows
    round-trip it through a checkpoint file first."""
    backend, opts = CONFIGS[config]
    opts = dict(opts)
    restore = opts.pop("_restore", False)
    eng = port_api.build_engine(h, backend, device="cpu", **opts)
    if not restore:
        return eng
    d = tempfile.TemporaryDirectory()
    _RESTORE_DIRS.append(d)
    path = os.path.join(d.name, "engine.hlidx")
    port_api.save_index(path, eng)
    return port_api.load_index(path, device="cpu")

GRAPHS = {
    "random": lambda api: api.random_hypergraph(30, 45, seed=3),
    "chain": lambda api: api.planted_chain_hypergraph(2, 6, overlap=2,
                                                      extra_size=2, seed=0),
    "isolated": lambda api: api.from_edge_lists([[0, 1, 2], [2, 3],
                                                 [5, 6, 7], [6, 7, 8]],
                                                n=12),
}


def test_matrix_covers_registry_exactly():
    assert set(EXPECTED_WORKLOADS) == set(BACKENDS)
    assert port_api.workload_capabilities() == EXPECTED_WORKLOADS
    assert port_api.workload_capabilities() == \
        ref_api.workload_capabilities()


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def case(request):
    ref_h = GRAPHS[request.param](ref_api)
    h = port_hypergraph(ref_h)
    rng = np.random.default_rng(7)
    us = rng.integers(0, h.n, 60)
    vs = rng.integers(0, h.n, 60)
    oracle = MSTOracle(h)
    want = np.array([oracle.mr(int(u), int(v)) for u, v in zip(us, vs)],
                    np.int64)
    return request.param, ref_h, h, us, vs, want


_ENGINES = {}
_BRUTE = {}


def _engines(graph_name, ref_h, h, config):
    """One (reference, port) engine pair per (graph, config), shared by
    the read-only ops."""
    key = (graph_name, config)
    if key not in _ENGINES:
        backend, _ = CONFIGS[config]
        _ENGINES[key] = (ref_api.build_engine(ref_h, backend),
                         _build(h, config))
    return _ENGINES[key]


def _brute(graph_name, ref_h, h, name, *args):
    """The port's ``brute_force_<name>`` on ``h``, held equal (values and
    types) to the reference's once per graph and arguments."""
    key = (graph_name, name, tuple(
        tuple(int(x) for x in a) if isinstance(a, (list, np.ndarray))
        else a for a in args))
    if key not in _BRUTE:
        got = getattr(port_core, f"brute_force_{name}")(h, *args)
        want = getattr(ref_core, f"brute_force_{name}")(ref_h, *args)
        _same(got, want, key)
        _BRUTE[key] = got
    return _BRUTE[key]


def _same(got, want, what=""):
    """Equal in value and type; arrays in dtype and shape; a ``Witness`` of
    either package field by field; tuples element by element."""
    if isinstance(want, np.ndarray):
        assert_same_array(want, got, str(what))
        return
    if dataclasses.is_dataclass(want):
        got, want = dataclasses.astuple(got), dataclasses.astuple(want)
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), what
        for x, y in zip(got, want):
            _same(x, y, what)
        return
    assert got == want and type(got) is type(want), (what, got, want)


def _supported(config, op):
    return EXPECTED_WORKLOADS[CONFIGS[config][0]][op]


def _refused(call_ref, call_port):
    for call in (call_ref, call_port):
        with pytest.raises(NotImplementedError, match="workload"):
            call()
    with pytest.raises(port_api.WorkloadUnsupported):
        call_port()


@pytest.mark.parametrize("config", CONFIG_NAMES)
def test_op_witness(case, config):
    name, ref_h, h, us, vs, want = case
    ref, eng = _engines(name, ref_h, h, config)
    if not _supported(config, "witness"):
        _refused(lambda: ref.mr_witness(int(us[0]), int(vs[0])),
                 lambda: eng.mr_witness(int(us[0]), int(vs[0])))
        return
    for u, v, w in zip(us[:10], vs[:10], want[:10]):
        u, v = int(u), int(v)
        wit = eng.mr_witness(u, v)
        _same(wit, ref.mr_witness(u, v), (u, v))
        assert (wit.u, wit.v, wit.s) == (u, v, int(w))   # strength == MR
        assert verify_witness(h, wit)         # walk is a valid s-walk
        assert wit.s == _brute(name, ref_h, h, "witness", u, v)[0]
    with pytest.raises(IndexError):
        eng.mr_witness(-1, 0)


@pytest.mark.parametrize("config", CONFIG_NAMES)
def test_op_s_reach_k(case, config):
    name, ref_h, h, us, vs, want = case
    ref, eng = _engines(name, ref_h, h, config)
    if not _supported(config, "s_reach_k"):
        _refused(lambda: ref.s_reach_k(int(us[0]), int(vs[0]), 1, 1),
                 lambda: eng.s_reach_k(int(us[0]), int(vs[0]), 1, 1))
        return
    for s in (1, 2):
        for k in (1, 2, h.m):
            for u, v in zip(us[:8], vs[:8]):
                u, v = int(u), int(v)
                got = eng.s_reach_k(u, v, s, k)
                _same(got, ref.s_reach_k(u, v, s, k), (u, v, s, k))
                assert got is _brute(name, ref_h, h, "s_reach_k", u, v, s, k)
    with pytest.raises(ValueError):
        eng.s_reach_k(int(us[0]), int(vs[0]), 0, 1)
    with pytest.raises(ValueError):
        eng.s_reach_k(int(us[0]), int(vs[0]), 1, 0)


@pytest.mark.parametrize("config", CONFIG_NAMES)
def test_op_mr_set(case, config):
    name, ref_h, h, us, vs, want = case
    ref, eng = _engines(name, ref_h, h, config)
    if not _supported(config, "mr_set"):
        _refused(lambda: ref.mr_set(us[:3], vs[:3]),
                 lambda: eng.mr_set(us[:3], vs[:3]))
        _refused(lambda: ref.mr_from_set(us[:3], vs[:3]),
                 lambda: eng.mr_from_set(us[:3], vs[:3]))
        return
    for a, b in ((6, 6), (1, 12), (12, 1)):
        U, V = us[:a], vs[:b]
        got = eng.mr_set(U, V)
        _same(got, ref.mr_set(U, V), (a, b))
        assert got == _brute(name, ref_h, h, "mr_set", U, V)
    targets = np.arange(h.n)
    got = eng.mr_from_set(us[:5], targets)
    _same(got, np.asarray(ref.mr_from_set(us[:5], targets)))
    _same(got, _brute(name, ref_h, h, "mr_from_set", us[:5], targets))
    with pytest.raises(ValueError):
        eng.mr_set(np.array([], np.int64), vs[:3])


@pytest.mark.parametrize("config", CONFIG_NAMES)
def test_op_top_s(case, config):
    name, ref_h, h, us, vs, want = case
    ref, eng = _engines(name, ref_h, h, config)
    if not _supported(config, "top_s"):
        _refused(lambda: ref.top_s(int(us[0]), 3),
                 lambda: eng.top_s(int(us[0]), 3))
        return
    for u in sorted({int(x) for x in us[:6]}):
        for k in (1, 4, h.n):
            got = eng.top_s(u, k)
            _same(got, tuple(np.asarray(x) for x in ref.top_s(u, k)), (u, k))
            _same(got, _brute(name, ref_h, h, "top_s", u, k), (u, k))
    with pytest.raises(ValueError):
        eng.top_s(int(us[0]), 0)


@pytest.mark.parametrize("config", CONFIG_NAMES)
def test_op_s_distance(case, config):
    name, ref_h, h, us, vs, want = case
    ref, eng = _engines(name, ref_h, h, config)
    if not _supported(config, "s_distance"):
        _refused(lambda: ref.s_distance(int(us[0]), int(vs[0]), 1),
                 lambda: eng.s_distance(int(us[0]), int(vs[0]), 1))
        return
    for s in (1, 2):
        for u, v in zip(us[:12], vs[:12]):
            u, v = int(u), int(v)
            bound = eng.s_distance(u, v, s)
            _same(bound, ref.s_distance(u, v, s), (u, v, s))
            exact = _brute(name, ref_h, h, "s_distance", u, v, s)
            # certified: reachability is never wrong, bounds are walks
            assert (bound == 0) == (exact == 0), (u, v, s)
            assert bound >= exact
    with pytest.raises(ValueError):
        eng.s_distance(int(us[0]), int(vs[0]), 0)


@pytest.mark.parametrize("config", CONFIG_NAMES)
def test_ops_after_update(config):
    """Every op the backend serves, after one update applied to both
    packages (or refused by both, where the backend cannot take one),
    against the reference and the port's brute force on the new graph."""
    backend, _ = CONFIGS[config]
    ref_h = GRAPHS["random"](ref_api)
    ref = ref_api.build_engine(ref_h, backend)
    eng = _build(port_hypergraph(ref_h), config)
    ins, dels = [[0, 1, ref_h.n - 1], [3, 4, 5, 6]], [2, 7]
    if eng.update_capability == "unsupported":
        for e in (ref, eng):
            with pytest.raises(NotImplementedError):
                e.update(inserts=ins, deletes=dels)
    else:
        for e in (ref, eng):
            e.update(inserts=ins, deletes=dels)
        assert eng.version == ref.version == 1
    h = eng.h
    served = eng.workload_capability
    assert served == ref.workload_capability
    rng = np.random.default_rng(5)
    us, vs = rng.integers(0, h.n, 6), rng.integers(0, h.n, 6)
    if "witness" in served:
        for u, v in zip(us, vs):
            wit = eng.mr_witness(int(u), int(v))
            _same(wit, ref.mr_witness(int(u), int(v)))
            assert verify_witness(h, wit)
            assert wit.s == port_core.brute_force_witness(h, int(u),
                                                           int(v))[0]
    if "s_reach_k" in served:
        for u, v in zip(us, vs):
            for s, k in ((1, 1), (1, 2), (2, 3)):
                got = eng.s_reach_k(int(u), int(v), s, k)
                _same(got, ref.s_reach_k(int(u), int(v), s, k))
                assert got is port_core.brute_force_s_reach_k(
                    h, int(u), int(v), s, k)
    if "mr_set" in served:
        got = eng.mr_set(us, vs)
        _same(got, ref.mr_set(us, vs))
        assert got == port_core.brute_force_mr_set(h, us, vs)
        got = eng.mr_from_set(us[:3], vs)
        _same(got, np.asarray(ref.mr_from_set(us[:3], vs)))
        _same(got, port_core.brute_force_mr_from_set(h, us[:3], vs))
    if "top_s" in served:
        for u in us[:3]:
            got = eng.top_s(int(u), 5)
            _same(got, tuple(np.asarray(x) for x in ref.top_s(int(u), 5)))
            _same(got, port_core.brute_force_top_s(h, int(u), 5))
    if "s_distance" in served:
        for u, v in zip(us, vs):
            got = eng.s_distance(int(u), int(v), 2)
            _same(got, ref.s_distance(int(u), int(v), 2))
            exact = port_core.brute_force_s_distance(h, int(u), int(v), 2)
            assert (got == 0) == (exact == 0) and got >= exact
    if not served:
        _refused(lambda: ref.top_s(0, 3), lambda: eng.top_s(0, 3))
