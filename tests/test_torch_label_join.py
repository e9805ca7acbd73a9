"""Port parity, the ``label_join`` kernel module: the port's plain PyTorch
versions (``label_join`` on [Q, L] rows, ``label_join_gather`` on a
snapshot and vertex ids) against the reference's jnp oracle and against
the Pallas kernel in interpret mode, on the reference harness's
adversarial corpus; the wrappers' operand checks; the kernel's route
choice; the registry.  Exact equality throughout (the join is integer
work).  The CUDA kernel itself runs only on a GPU: its tests carry the
``gpu`` marker and skip elsewhere."""
import pathlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import KERNEL_REGISTRY as REF_REGISTRY
from repro.kernels import interpret_available, ref as ref_oracles
from repro.kernels.label_join import MAX_RANK as REF_MAX_RANK
from repro.kernels.label_join import label_join_pallas
from repro.kernels.label_join import validate_ranks as ref_validate_ranks
from repro_torch.device import gpu_probe
from repro_torch.kernels import KERNEL_REGISTRY, label_join as lj
from repro_torch.kernels import ref as port_oracles

_PAD = np.iinfo(np.int32).max

# (q, l, bq, bl, seed) — tests/test_kernels_diff.py::LABEL_JOIN_CORPUS
LABEL_JOIN_CORPUS = [
    (5, 7, 32, 4, 0),
    (130, 33, 32, 8, 1),
    (1, 1, 128, 256, 2),
    (64, 300, 16, 64, 3),
    (31, 129, 8, 32, 4),
    (0, 5, 32, 8, 5),            # Q = 0
    (3, 0, 32, 8, 6),            # L = 0
]


def _label_rows(rng, q, l, high):
    """Random padded label rows as the reference harness makes them."""
    ranks = np.full((q, l), _PAD, np.int32)
    svals = np.zeros((q, l), np.int32)
    for i in range(q):
        li = int(rng.integers(0, l + 1))
        r = np.unique(rng.integers(0, max(high, 1), li)).astype(np.int64)
        ranks[i, :r.size] = np.minimum(r, REF_MAX_RANK)
        svals[i, :r.size] = rng.integers(1, 9, r.size)
    return ranks, svals


def _operands(q, l, seed, high=200):
    rng = np.random.default_rng(seed)
    ru, su = _label_rows(rng, q, l, high)
    rv, sv = _label_rows(rng, q, l, high)
    return ru, su, rv, sv


def _torch(ops):
    return tuple(torch.from_numpy(a) for a in ops)


def _jnp(ops):
    return tuple(jnp.asarray(a) for a in ops)


def _assert_int32_equal(got: torch.Tensor, want):
    want = np.asarray(want)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("q,l,bq,bl,seed", LABEL_JOIN_CORPUS)
def test_plain_version_equals_reference_oracle(q, l, bq, bl, seed):
    ops = _operands(q, l, seed)
    want = ref_oracles.label_join_ref(*_jnp(ops))
    _assert_int32_equal(lj.label_join_ref(*_torch(ops)), want)
    _assert_int32_equal(port_oracles.label_join_ref(*_torch(ops)), want)
    # on CPU tensors the wrapper runs the plain version and counts nothing
    before = lj.LAUNCHES
    _assert_int32_equal(lj.label_join(*_torch(ops)), want)
    assert lj.LAUNCHES == before


@pytest.mark.parametrize("q,l,bq,bl,seed", LABEL_JOIN_CORPUS)
def test_plain_version_equals_pallas_interpret(q, l, bq, bl, seed):
    if not interpret_available():
        pytest.skip("pallas interpret mode unavailable")
    ops = _operands(q, l, seed)
    want = label_join_pallas(*_jnp(ops), bq=bq, bl=bl, interpret=True)
    _assert_int32_equal(lj.label_join_ref(*_torch(ops)), want)


@pytest.mark.parametrize("high", [8, 200])
@pytest.mark.parametrize("seed", range(4))
def test_plain_version_equals_reference_oracle_fuzz(seed, high):
    rng = np.random.default_rng(1000 + seed)
    q, l = int(rng.integers(0, 40)), int(rng.integers(0, 40))
    ops = _operands(q, l, seed, high=high)
    _assert_int32_equal(lj.label_join_ref(*_torch(ops)),
                        ref_oracles.label_join_ref(*_jnp(ops)))


def test_rank_at_sentinel_bound():
    # MAX_RANK itself is a legal real rank and must join; one above it
    # aliases the reference's padded-query-row sentinel and is rejected
    assert lj.MAX_RANK == REF_MAX_RANK == _PAD - 2
    ops = (np.array([[0, REF_MAX_RANK]], np.int32),
           np.array([[3, 5]], np.int32),
           np.array([[REF_MAX_RANK, _PAD]], np.int32),
           np.array([[4, 0]], np.int32))
    lj.validate_ranks(torch.from_numpy(ops[0]))
    assert lj.label_join(*_torch(ops)).tolist() == [4]
    assert np.asarray(ref_oracles.label_join_ref(*_jnp(ops))).tolist() == [4]


def test_pad_rows_never_match():
    ru = np.full((3, 4), _PAD, np.int32)
    su = np.zeros((3, 4), np.int32)
    ops = (ru, su, ru, su)
    _assert_int32_equal(lj.label_join(*_torch(ops)), np.zeros(3, np.int32))
    _assert_int32_equal(lj.label_join_ref(*_torch(ops)),
                        ref_oracles.label_join_ref(*_jnp(ops)))


@pytest.mark.parametrize("ranks,ok", [
    ([[REF_MAX_RANK]], True),
    ([[REF_MAX_RANK + 1]], False),      # the padded-query-row sentinel
    ([[REF_MAX_RANK + 2]], True),       # INT32_MAX: the padding itself
    ([[0, 5, _PAD], [_PAD, _PAD, _PAD]], True),
    (np.zeros((0, 3), np.int32), True),
    (np.zeros((4, 0), np.int32), True),
])
def test_validate_ranks_refuses_the_same_inputs(ranks, ok):
    ranks = np.asarray(ranks, np.int32)
    if ok:
        ref_validate_ranks(jnp.asarray(ranks))
        lj.validate_ranks(torch.from_numpy(ranks))
        lj.validate_ranks(ranks)                       # array-likes too
    else:
        with pytest.raises(ValueError, match="sentinel"):
            ref_validate_ranks(jnp.asarray(ranks))
        with pytest.raises(ValueError, match="sentinel"):
            lj.validate_ranks(torch.from_numpy(ranks))


def _good():
    return list(_torch(_operands(6, 5, 0)))


@pytest.mark.parametrize("case,exc", [
    ("dtype", TypeError), ("numpy", TypeError), ("rank", ValueError),
    ("shape", ValueError), ("noncontiguous", ValueError),
])
def test_wrapper_raises_on_bad_operands(case, exc):
    ops = _good()
    if case == "dtype":
        ops[1] = ops[1].to(torch.int64)
    elif case == "numpy":
        ops[2] = ops[2].numpy()
    elif case == "rank":
        ops = [t.reshape(-1) for t in ops]
    elif case == "shape":
        ops[3] = ops[3][:, :4].contiguous()
    elif case == "noncontiguous":
        ops[0] = torch.cat([ops[0], ops[0]], dim=1)[:, ::2]
        assert ops[0].shape == ops[1].shape and not ops[0].is_contiguous()
    with pytest.raises(exc, match="label_join"):
        lj.label_join(*ops)


def test_registry_is_a_subset_of_the_reference_and_perf_md_names_the_rest():
    # every kernel of the reference is ported now: the two registries match
    assert set(KERNEL_REGISTRY) == set(REF_REGISTRY) == {
        "label_join", "maxmin_matmul", "overlap", "threshold_step"}
    spec = KERNEL_REGISTRY["label_join"]
    assert spec.kernel is lj.label_join
    assert spec.reference is lj.label_join_ref
    root = pathlib.Path(__file__).resolve().parents[1]
    for name, spec in KERNEL_REGISTRY.items():
        assert spec.unit == ("tensor cores" if name in (
            "overlap", "threshold_step") else "CUDA cores"), name
        assert getattr(port_oracles, spec.reference.__name__) is \
            spec.reference
        assert spec.kernel.__name__ == name
        assert (root / "src" / "repro_torch" / spec.source).is_file()
    perf = (root / "PERF.md").read_text()
    for name in REF_REGISTRY:
        rows = [ln for ln in perf.splitlines()
                if ln.startswith(f"| `{REF_REGISTRY[name].kernel.__name__}`")]
        assert len(rows) == 1, f"PERF.md needs one table row for {name}"
        assert "ported in PR" in rows[0], (name, rows[0])


@pytest.mark.gpu
def test_cuda_kernel_equals_plain_version_on_the_card():
    probe = gpu_probe()
    if not probe["cuda"] or probe["nvcc"] is None:
        pytest.skip(f"needs an NVIDIA GPU and nvcc: {probe}")
    for q, l, _, _, seed in LABEL_JOIN_CORPUS + [(1024, 15, 0, 0, 7),
                                                 (257, 600, 0, 0, 8)]:
        ops = tuple(t.cuda() for t in _torch(_operands(q, l, seed)))
        before = lj.LAUNCHES
        got = lj.label_join(*ops)
        torch.cuda.synchronize()
        assert lj.LAUNCHES == before + (1 if q and l else 0)
        assert torch.equal(got, lj.label_join_ref(*ops))


# -- the gather entry point: rows read from a snapshot by vertex id --------

def _snapshot_and_ids(q, l, seed, high=200):
    """A snapshot-like [n, L] pair (n = q + 2 rows) and q id pairs into it
    that repeat ids and reach rows 0 and n - 1."""
    rng = np.random.default_rng(seed)
    n = q + 2
    ranks, svals = _label_rows(rng, n, l, high)
    us = rng.integers(0, n, q)
    vs = rng.integers(0, n, q)
    ends = np.array([0, n - 1, 0, n - 1])
    k = min(q, ends.size)
    us[:k], vs[:k] = ends[:k], ends[::-1][:k]
    return ranks, svals, us.astype(np.int64), vs.astype(np.int64)


def _gathered(ranks, svals, us, vs):
    return ranks[us], svals[us], ranks[vs], svals[vs]


@pytest.mark.parametrize("q,l,bq,bl,seed", LABEL_JOIN_CORPUS)
def test_gather_plain_version_equals_reference_oracle(q, l, bq, bl, seed):
    snap = _snapshot_and_ids(q, l, seed)
    want = ref_oracles.label_join_ref(*_jnp(_gathered(*snap)))
    _assert_int32_equal(lj.label_join_gather_ref(*_torch(snap)), want)
    # on CPU tensors the wrapper runs the plain version and counts nothing
    before = (lj.LAUNCHES, lj.GATHER_LAUNCHES)
    _assert_int32_equal(lj.label_join_gather(*_torch(snap)), want)
    assert (lj.LAUNCHES, lj.GATHER_LAUNCHES) == before


@pytest.mark.parametrize("q,l,bq,bl,seed", LABEL_JOIN_CORPUS)
def test_gather_plain_version_equals_pallas_interpret(q, l, bq, bl, seed):
    if not interpret_available():
        pytest.skip("pallas interpret mode unavailable")
    snap = _snapshot_and_ids(q, l, seed)
    want = label_join_pallas(*_jnp(_gathered(*snap)), bq=bq, bl=bl,
                             interpret=True)
    _assert_int32_equal(lj.label_join_gather(*_torch(snap)), want)


@pytest.mark.parametrize("l", [1, 15, 33])
def test_gather_repeated_ids_and_empty_batch(l):
    ranks, svals, _, _ = _snapshot_and_ids(6, l, 20)
    us = np.array([7, 7, 0, 3, 0, 7], np.int64)
    vs = np.array([0, 0, 7, 3, 3, 0], np.int64)
    got = lj.label_join_gather(*_torch((ranks, svals, us, vs)))
    _assert_int32_equal(got, ref_oracles.label_join_ref(
        *_jnp(_gathered(ranks, svals, us, vs))))
    assert got[0] == got[1] == got[5] and got[2] == got[0]
    empty = torch.zeros(0, dtype=torch.int64)
    out = lj.label_join_gather(torch.from_numpy(ranks),
                               torch.from_numpy(svals), empty, empty)
    assert out.dtype == torch.int32 and out.shape == (0,)


def test_gather_duplicate_ranks_join_all_pairs():
    # a malformed row with a repeated rank whose s rises: the answer is the
    # all-pairs one, as label_join_ref gives it
    ranks = np.array([[2, 5, 5, 5, _PAD], [5, 9, _PAD, _PAD, _PAD]], np.int32)
    svals = np.array([[4, 1, 3, 7, 0], [6, 2, 0, 0, 0]], np.int32)
    us, vs = np.array([1, 0], np.int64), np.array([0, 1], np.int64)
    got = lj.label_join_gather(*_torch((ranks, svals, us, vs)))
    assert got.tolist() == [6, 6]
    _assert_int32_equal(got, ref_oracles.label_join_ref(
        *_jnp(_gathered(ranks, svals, us, vs))))


@pytest.mark.parametrize("bad", [-1, 8])
def test_gather_plain_version_refuses_out_of_range_ids(bad):
    ranks, svals, us, vs = _torch(_snapshot_and_ids(6, 5, 0))
    vs = vs.clone()
    vs[2] = bad
    with pytest.raises(IndexError, match=r"\[0, 8\)"):
        lj.label_join_gather(ranks, svals, us, vs)


def _good_gather():
    return list(_torch(_snapshot_and_ids(6, 5, 0)))


@pytest.mark.parametrize("case,exc", [
    ("ids int32", TypeError), ("ids float", TypeError),
    ("ids 2-D", ValueError), ("ids unequal length", ValueError),
    ("ids on another device", ValueError), ("ids numpy", TypeError),
    ("ids noncontiguous", ValueError), ("svals int64", TypeError),
    ("ranks 1-D", ValueError), ("svals shape", ValueError),
])
def test_gather_wrapper_raises_on_bad_operands(case, exc):
    ranks, svals, us, vs = _good_gather()
    if case == "ids int32":
        us = us.to(torch.int32)
    elif case == "ids float":
        vs = vs.to(torch.float32)
    elif case == "ids 2-D":
        us, vs = us.reshape(2, 3), vs.reshape(2, 3)
    elif case == "ids unequal length":
        vs = vs[:5].contiguous()
    elif case == "ids on another device":
        us = torch.empty(us.shape, dtype=torch.int64, device="meta")
    elif case == "ids numpy":
        vs = vs.numpy()
    elif case == "ids noncontiguous":
        us = torch.stack([us, us], dim=1)[:, 0]
        assert not us.is_contiguous()
    elif case == "svals int64":
        svals = svals.to(torch.int64)
    elif case == "ranks 1-D":
        ranks = ranks.reshape(-1)
    elif case == "svals shape":
        svals = svals[:, :4].contiguous()
    with pytest.raises(exc, match="label_join_gather"):
        lj.label_join_gather(ranks, svals, us, vs)


@pytest.mark.parametrize("l,lanes", [
    (-3, -1), (0, -1), (1, 1), (2, 2), (3, 4), (4, 4), (5, 8), (8, 8),
    (9, 16), (15, 16), (16, 16), (17, 32), (31, 32), (32, 32), (33, 0),
    (52, 0), (121, 0), (256, 0), (12_704, 0),
])
def test_route_is_chosen_from_the_row_length(l, lanes):
    # L <= 32: a power-of-two group of lanes per query, 32 / lanes queries
    # to a warp; longer rows: one warp per query row (0); empty rows: none
    assert lj.lanes_per_query(l) == lanes
    if 1 <= l <= 32:
        assert lanes >= l and lanes // 2 < l and 32 % lanes == 0


@pytest.mark.gpu
def test_cuda_gather_kernel_equals_plain_version_on_the_card():
    probe = gpu_probe()
    if not probe["cuda"] or probe["nvcc"] is None:
        pytest.skip(f"needs an NVIDIA GPU and nvcc: {probe}")
    cases = [c[:2] + c[4:] for c in LABEL_JOIN_CORPUS]
    for q, l, seed in cases + [(1024, 15, 7), (4096, 33, 8), (257, 600, 9)]:
        ops = tuple(t.cuda() for t in _torch(_snapshot_and_ids(q, l, seed)))
        before = (lj.LAUNCHES, lj.GATHER_LAUNCHES)
        got = lj.label_join_gather(*ops)
        torch.cuda.synchronize()
        launched = 1 if q and l else 0
        assert (lj.LAUNCHES, lj.GATHER_LAUNCHES) == (before[0] + launched,
                                                     before[1] + launched)
        assert torch.equal(got, lj.label_join_gather_ref(*ops))
        assert torch.equal(got, lj.label_join(*(t.contiguous() for t in
                                                _gathered(*ops))))
