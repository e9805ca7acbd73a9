"""Port parity, the three dense kernel modules (``maxmin_matmul``,
``overlap``, ``threshold_closure``) and the ``ops`` drivers: each plain
PyTorch version against the reference's jnp oracle and against the Pallas
kernel in interpret mode, on the reference harness's adversarial corpora;
the wrappers' operand checks and empty shapes; the closure drivers against
the reference's.  Exact equality, dtype included (the answers are
integers).  The CUDA kernels run only on a GPU: their test carries the
``gpu`` marker and skips elsewhere."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import interpret_available
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro.kernels.maxmin_matmul import maxmin_matmul_pallas
from repro.kernels.overlap import overlap_pallas
from repro.kernels.threshold_closure import threshold_step_pallas
from repro_torch.device import gpu_probe
from repro_torch.kernels import build
from repro_torch.kernels import maxmin_matmul as mm
from repro_torch.kernels import ops
from repro_torch.kernels import overlap as ov
from repro_torch.kernels import ref as port_oracles
from repro_torch.kernels import threshold_closure as tc

# tests/test_kernels_diff.py::MAXMIN_CORPUS — (m, k, n, bm, bn, bk, k_chunk, seed)
MAXMIN_CORPUS = [
    (33, 32, 17, 32, 32, 32, 5, 0),   # bk % k_chunk != 0: the tail case
    (1, 1, 1, 128, 128, 128, 8, 1),
    (8, 37, 9, 16, 16, 16, 7, 2),
    (0, 4, 4, 32, 32, 32, 8, 3),      # empty m
    (4, 0, 4, 32, 32, 32, 8, 4),      # empty k
    (4, 4, 0, 32, 32, 32, 8, 5),      # empty n
    (64, 64, 64, 32, 32, 32, 1, 6),
]
# (m, n, bm, bn, bk, seed)
OVERLAP_CORPUS = [
    (10, 17, 32, 32, 32, 0), (1, 1, 16, 16, 16, 1),
    (0, 5, 32, 32, 32, 2), (5, 0, 32, 32, 32, 3), (130, 40, 32, 32, 32, 4),
]
# (s, m, bm, bn, bk, seed)
THRESHOLD_CORPUS = [
    (1, 16, 32, 32, 32, 0), (3, 33, 16, 16, 16, 1), (0, 8, 16, 16, 16, 2),
    (2, 0, 16, 16, 16, 3),
]
DTYPES = [(np.int32, torch.int32, jnp.int32),
          (np.float32, torch.float32, jnp.float32)]


def _same(got: torch.Tensor, want):
    """Exact equality, dtype and shape included."""
    want = np.asarray(want)
    assert isinstance(got, torch.Tensor)
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def _maxmin_operands(m, k, n, seed, np_dtype):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 12, (m, k)).astype(np_dtype),
            rng.integers(0, 12, (k, n)).astype(np_dtype))


def _incidence(m, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((m, n)) < 0.3).astype(np.float32)


def _reach(s, m, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((s, m, m)) < 0.2).astype(np.float32)


# -- maxmin_matmul -------------------------------------------------------------

@pytest.mark.parametrize("dtypes", DTYPES, ids=["int32", "float32"])
@pytest.mark.parametrize("m,k,n,bm,bn,bk,kc,seed", MAXMIN_CORPUS)
def test_maxmin_plain_equals_reference_oracle(m, k, n, bm, bn, bk, kc, seed,
                                              dtypes):
    np_dtype, _, _ = dtypes
    a, b = _maxmin_operands(m, k, n, seed, np_dtype)
    want = ref_oracles.maxmin_matmul_ref(jnp.asarray(a), jnp.asarray(b))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _same(mm.maxmin_matmul_ref(ta, tb), want)
    _same(port_oracles.maxmin_matmul_ref(ta, tb), want)
    _same(mm.maxmin_matmul_ref(ta, tb, block=3), want)    # ragged k blocks
    before = mm.LAUNCHES
    _same(mm.maxmin_matmul(ta, tb), want)
    _same(ops.maxmin_matmul(ta, tb, block=5), want)
    assert mm.LAUNCHES == before          # CPU tensors: the plain version


@pytest.mark.parametrize("dtypes", DTYPES, ids=["int32", "float32"])
@pytest.mark.parametrize("m,k,n,bm,bn,bk,kc,seed", MAXMIN_CORPUS)
def test_maxmin_plain_equals_pallas_interpret(m, k, n, bm, bn, bk, kc, seed,
                                              dtypes):
    if not interpret_available():
        pytest.skip("pallas interpret mode unavailable")
    np_dtype, _, _ = dtypes
    a, b = _maxmin_operands(m, k, n, seed, np_dtype)
    want = maxmin_matmul_pallas(jnp.asarray(a), jnp.asarray(b), bm=bm, bn=bn,
                                bk=bk, k_chunk=kc, interpret=True)
    _same(mm.maxmin_matmul_ref(torch.from_numpy(a), torch.from_numpy(b),
                               block=bk), want)


# -- overlap -------------------------------------------------------------------

@pytest.mark.parametrize("m,n,bm,bn,bk,seed", OVERLAP_CORPUS)
def test_overlap_plain_equals_reference_oracle(m, n, bm, bn, bk, seed):
    b_inc = _incidence(m, n, seed)
    want = ref_oracles.overlap_ref(jnp.asarray(b_inc))
    tb = torch.from_numpy(b_inc)
    _same(ov.overlap_ref(tb), want)
    _same(port_oracles.overlap_ref(tb), want)
    before = ov.LAUNCHES
    _same(ov.overlap(tb), want)
    # bfloat16 0/1 input: float32 W, the same counts
    _same(ov.overlap(tb.to(torch.bfloat16)), want)
    assert ov.LAUNCHES == before
    sizes = np.arange(m, dtype=np.int32) + 7
    _same(ov.overlap_ref(tb, torch.from_numpy(sizes)),
          ref_oracles.overlap_ref(jnp.asarray(b_inc), jnp.asarray(sizes)))


@pytest.mark.parametrize("m,n,bm,bn,bk,seed", OVERLAP_CORPUS)
def test_overlap_plain_equals_pallas_interpret(m, n, bm, bn, bk, seed):
    if not interpret_available():
        pytest.skip("pallas interpret mode unavailable")
    b_inc = _incidence(m, n, seed)
    want = overlap_pallas(jnp.asarray(b_inc), bm=bm, bn=bn, bk=bk,
                          interpret=True)
    _same(ops.overlap(torch.from_numpy(b_inc)), want)


# (ma, row offset): row blocks of B, the last one ragged, one of one row, and
# an empty block
OVERLAP_ROW_BLOCKS = [(3, 0), (1, 4), (4, 6), (0, 2)]


@pytest.mark.parametrize("m,n,bm,bn,bk,seed", OVERLAP_CORPUS)
@pytest.mark.parametrize("ma,first", OVERLAP_ROW_BLOCKS)
def test_overlap_rows_plain_equals_slices_of_overlap_ref(m, n, bm, bn, bk,
                                                          seed, ma, first):
    """``overlap_rows(B[rows], B)`` is the ``rows`` slice of
    ``overlap_ref(B)``, float32, exact; against an empty B too; in bf16
    as in float32; and no launch on the CPU."""
    b_inc = torch.from_numpy(_incidence(m, n, seed))
    lo, hi = min(first, m), min(first + ma, m)
    a = b_inc[lo:hi].contiguous()
    want = ov.overlap_ref(b_inc)[lo:hi]
    before = ov.ROWS_LAUNCHES
    for pa, pb in ((a, b_inc), (a.to(torch.bfloat16),
                                b_inc.to(torch.bfloat16))):
        got = ov.overlap_rows(pa, pb)
        assert got.dtype == torch.float32 and got.shape == (hi - lo, m)
        assert torch.equal(got, want)
    assert torch.equal(ov.overlap_rows_ref(a, b_inc), want)
    empty = ov.overlap_rows(a, b_inc[:0])
    assert empty.shape == (hi - lo, 0) and empty.dtype == torch.float32
    assert ov.ROWS_LAUNCHES == before
    np.testing.assert_array_equal(
        ov.overlap_rows(a, b_inc).numpy(),
        np.asarray(ref_oracles.overlap_ref(jnp.asarray(b_inc.numpy())))[lo:hi])


@pytest.mark.parametrize("a,b,exc", [
    (torch.zeros((2, 4)), torch.zeros((3, 5)), ValueError),
    (torch.zeros((2, 4), dtype=torch.float64), torch.zeros((3, 4)),
     TypeError),
    (torch.zeros((2, 4)), np.zeros((3, 4), np.float32), TypeError),
    (torch.zeros((4, 2)).T, torch.zeros((3, 4)), ValueError),
    (torch.zeros((2, 4)), torch.zeros((3, 4, 1)), ValueError)])
def test_overlap_rows_wrapper_raises_on_bad_operands(a, b, exc):
    with pytest.raises(exc, match="overlap_rows"):
        ov.overlap_rows(a, b)


# -- threshold_step ------------------------------------------------------------

@pytest.mark.parametrize("s,m,bm,bn,bk,seed", THRESHOLD_CORPUS)
def test_threshold_step_plain_equals_reference_oracle(s, m, bm, bn, bk, seed):
    r = _reach(s, m, seed)
    want = ref_oracles.threshold_step_ref(jnp.asarray(r))
    tr = torch.from_numpy(r)
    _same(tc.threshold_step_ref(tr), want)
    _same(port_oracles.threshold_step_ref(tr), want)
    before = tc.LAUNCHES
    got = tc.threshold_step(tr)
    _same(got, want)
    assert tc.LAUNCHES == before
    if s == 0 or m == 0:
        assert got is tr                  # returned as is, as the reference


@pytest.mark.parametrize("s,m,bm,bn,bk,seed", THRESHOLD_CORPUS)
def test_threshold_step_bf16_plain_equals_reference_oracle(s, m, bm, bn, bk,
                                                           seed):
    """The closure path's dtype: a bf16 0/1 batch gives the reference's
    answer on the same values, in bf16."""
    r = _reach(s, m, seed)
    want = np.asarray(ref_oracles.threshold_step_ref(jnp.asarray(r)))
    tr = torch.from_numpy(r).to(torch.bfloat16)
    before = tc.LAUNCHES
    for got in (tc.threshold_step_ref(tr), tc.threshold_step(tr)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        _same(got.to(torch.float32), want)
    assert tc.LAUNCHES == before


@pytest.mark.parametrize("s,m,bm,bn,bk,seed", THRESHOLD_CORPUS)
def test_threshold_step_plain_equals_pallas_interpret(s, m, bm, bn, bk, seed):
    if not interpret_available():
        pytest.skip("pallas interpret mode unavailable")
    r = _reach(s, m, seed)
    want = threshold_step_pallas(jnp.asarray(r), bm=bm, bn=bn, bk=bk,
                                 interpret=True)
    _same(ops.threshold_step(torch.from_numpy(r)), want)


# -- the closure drivers ---------------------------------------------------------

def _line_graph(seed):
    from repro.api import random_hypergraph
    return random_hypergraph(20, 33, min_size=2, max_size=5,
                             seed=seed).line_graph(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("rounds", [None, 1, 2])
def test_maxmin_closure_kernel_equals_reference_driver(seed, rounds):
    w = _line_graph(seed)
    want = ref_ops.maxmin_closure_kernel(jnp.asarray(w), rounds=rounds)
    _same(ops.maxmin_closure_kernel(torch.from_numpy(w), rounds=rounds), want)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("rounds", [None, 1])
def test_threshold_mr_kernel_equals_reference_driver(seed, rounds):
    w = _line_graph(seed)
    thr = np.unique(w)[1:]
    for ladder in (thr, thr[::2]):
        want = ref_ops.threshold_mr_kernel(jnp.asarray(w), ladder,
                                           rounds=rounds)
        _same(ops.threshold_mr_kernel(torch.from_numpy(w), ladder,
                                      rounds=rounds), want)


def test_default_rounds_is_the_references_ladder():
    for m in (0, 1, 2, 3, 4, 5, 256, 257, 12_704):
        assert ops.default_rounds(m) == max(1, int(np.ceil(np.log2(max(m, 2)))))
    assert ops.default_rounds(12_704) == 14


# -- operand checks ------------------------------------------------------------

def _bad_maxmin(case):
    a = torch.zeros((3, 4), dtype=torch.int32)
    b = torch.zeros((4, 5), dtype=torch.int32)
    if case == "dtype":
        return a.to(torch.int64), b.to(torch.int64)
    if case == "mixed":
        return a, b.to(torch.float32)
    if case == "numpy":
        return a.numpy(), b
    if case == "rank":
        return a.reshape(-1), b
    if case == "contract":
        return a, b[:3].contiguous()
    if case == "noncontiguous":
        return a, torch.zeros((5, 4), dtype=torch.int32).T
    raise AssertionError(case)


@pytest.mark.parametrize("case,exc", [
    ("dtype", TypeError), ("mixed", TypeError), ("numpy", TypeError),
    ("rank", ValueError), ("contract", ValueError),
    ("noncontiguous", ValueError)])
def test_maxmin_wrapper_raises_on_bad_operands(case, exc):
    with pytest.raises(exc, match="maxmin_matmul"):
        mm.maxmin_matmul(*_bad_maxmin(case))


@pytest.mark.parametrize("bad,exc", [
    (torch.zeros((3, 4), dtype=torch.float64), TypeError),
    (torch.zeros((3, 4), dtype=torch.int32), TypeError),
    (np.zeros((3, 4), np.float32), TypeError),
    (torch.zeros((2, 3, 4)), ValueError),
    (torch.zeros((4, 3)).T, ValueError)])
def test_overlap_wrapper_raises_on_bad_operands(bad, exc):
    with pytest.raises(exc, match="overlap"):
        ov.overlap(bad)


@pytest.mark.parametrize("bad,exc", [
    (torch.zeros((2, 3, 3), dtype=torch.float64), TypeError),
    (torch.zeros((2, 3, 3), dtype=torch.float16), TypeError),
    ([[[0.0]]], TypeError),
    (torch.zeros((3, 3)), ValueError),
    (torch.zeros((2, 3, 4)), ValueError),
    (torch.zeros((2, 3, 3)).transpose(1, 2), ValueError)])
def test_threshold_step_wrapper_raises_on_bad_operands(bad, exc):
    with pytest.raises(exc, match="threshold_step"):
        tc.threshold_step(bad)


@pytest.mark.parametrize("m", [1, 7, 8, 9, 33, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_threshold_pad_and_crop_helpers(m, dtype):
    """TMA's 16-byte rows: m padded to a multiple of 8 with zero rows and
    columns (no new paths), the answer cropped back; the padded round
    equals the unpadded one."""
    mp = tc.padded_extent(m)
    assert mp % 8 == 0 and m <= mp < m + 8
    r = torch.from_numpy(_reach(2, m, m)).to(dtype)
    padded = tc.pad_batch(r)
    assert padded.dtype == torch.bfloat16 and padded.shape == (2, mp, mp)
    assert torch.equal(padded[:, :m, :m].to(dtype), r)
    assert not padded[:, m:, :].any() and not padded[:, :, m:].any()
    if mp == m and dtype == torch.bfloat16:
        assert padded is r                # nothing to pad, nothing copied
    out = tc.crop_batch(tc.threshold_step_ref(padded).to(dtype), m)
    assert out.shape == r.shape and out.is_contiguous()
    assert torch.equal(out, tc.threshold_step_ref(r))


@pytest.mark.parametrize("n", [1, 5, 8, 17, 242, 248])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_overlap_pad_columns_helper(n, dtype):
    """Zero columns to a multiple of 8 leave B·Bᵀ unchanged."""
    b_inc = torch.from_numpy(_incidence(13, n, n)).to(dtype)
    padded = ov.pad_columns(b_inc)
    n_pad = -(-n // 8) * 8
    assert padded.dtype == torch.bfloat16 and padded.shape == (13, n_pad)
    assert torch.equal(padded[:, :n].to(dtype), b_inc)
    assert not padded[:, n:].any()
    if n_pad == n and dtype == torch.bfloat16:
        assert padded is b_inc
    assert torch.equal(ov.overlap_ref(padded.to(torch.float32)),
                       ov.overlap_ref(b_inc.to(torch.float32)))


@pytest.mark.parametrize("offset", [0, 1, 3, 8])
@pytest.mark.parametrize("dims", [1, 2])
def test_tma_operand_pads_casts_and_aligns(offset, dims):
    """The tensor-core operand both wrappers share: bf16, the last ``dims``
    sides rounded up to 8 with zeros, a 16-byte aligned base even for a
    view that starts mid-allocation (``offset`` bf16 values in)."""
    flat = torch.from_numpy(_incidence(1, 8 * 8 + 8, offset)[0]).to(
        torch.bfloat16)
    x = flat[offset:offset + 64].view(8, 8)
    out = build.tma_operand(x, dims=dims)
    assert out.dtype == torch.bfloat16 and out.shape == (8, 8)
    assert out.data_ptr() % 16 == 0 and torch.equal(out, x)
    assert (out is x) == (x.data_ptr() % 16 == 0)
    y = torch.ones((3, 5, 13))
    out = build.tma_operand(y, dims=dims)
    want = (3, 8, 16) if dims == 2 else (3, 5, 16)
    assert out.shape == want and out.data_ptr() % 16 == 0
    assert float(out.float().sum()) == y.numel()
    assert build.tma_extent(13) == 16 and build.tma_extent(16) == 16


def test_threshold_adjacency_has_self_loops_and_thresholds():
    w = torch.tensor([[3, 1, 0], [1, 2, 2], [0, 2, 4]], dtype=torch.int32)
    adj = tc.threshold_adjacency(w, torch.tensor([1, 2, 3], dtype=torch.int32))
    assert adj.dtype == torch.float32 and adj.shape == (3, 3, 3)
    assert torch.equal(adj[0], torch.tensor([[1., 1, 0], [1, 1, 1],
                                             [0, 1, 1]]))
    assert torch.equal(adj[2], torch.eye(3))
    bf = tc.threshold_adjacency(w, torch.tensor([1, 2, 3]),
                                dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16 and torch.equal(bf.float(), adj)


# -- on the card -----------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_kernels_equal_plain_versions_on_the_card():
    probe = gpu_probe()
    if not probe["cuda"] or probe["nvcc"] is None:
        pytest.skip(f"needs an NVIDIA GPU and nvcc: {probe}")
    dev = torch.device("cuda")
    for m, k, n, *_, seed in MAXMIN_CORPUS + [(300, 257, 129, 0, 0, 0, 0, 9)]:
        for np_dtype, _, _ in DTYPES:
            a, b = (torch.from_numpy(t).to(dev)
                    for t in _maxmin_operands(m, k, n, seed, np_dtype))
            before = mm.LAUNCHES
            got = mm.maxmin_matmul(a, b)
            torch.cuda.synchronize()
            assert mm.LAUNCHES == before + (1 if m and k and n else 0)
            assert torch.equal(got, mm.maxmin_matmul_ref(a, b))
    # overlap: n % 8 != 0 (column pad) and n % 8 == 0, both input dtypes
    for m, n, *_, seed in OVERLAP_CORPUS + [(300, 129, 0, 0, 0, 9),
                                            (301, 256, 0, 0, 0, 10)]:
        b_inc = torch.from_numpy(_incidence(m, n, seed)).to(dev)
        for operand in (b_inc, b_inc.to(torch.bfloat16)):
            before = (ov.LAUNCHES, ov.PADDED)
            assert torch.equal(ov.overlap(operand), ov.overlap_ref(b_inc))
            launched = 1 if m and n else 0
            assert (ov.LAUNCHES, ov.PADDED) == (
                before[0] + launched, before[1] + launched * (n % 8 != 0))
    # overlap_rows: row blocks of B against B, padded n and not
    for m, n, *_, seed in OVERLAP_CORPUS + [(300, 129, 0, 0, 0, 9),
                                            (301, 256, 0, 0, 0, 10)]:
        b_inc = torch.from_numpy(_incidence(m, n, seed)).to(dev)
        for ma, first in OVERLAP_ROW_BLOCKS + [(77, 200)]:
            a = b_inc[min(first, m):min(first + ma, m)].contiguous()
            for pa, pb in ((a, b_inc), (a.to(torch.bfloat16), b_inc)):
                before = ov.ROWS_LAUNCHES
                got = ov.overlap_rows(pa, pb)
                torch.cuda.synchronize()
                assert torch.equal(got, ov.overlap_rows_ref(a, b_inc))
                launched = 1 if a.shape[0] and m and n else 0
                assert ov.ROWS_LAUNCHES == before + launched
    # threshold_step: float32 and bf16, padded (m % 8 != 0) and not
    for s, m, *_, seed in THRESHOLD_CORPUS + [(2, 300, 0, 0, 0, 9),
                                              (2, 299, 0, 0, 0, 10)]:
        r = torch.from_numpy(_reach(s, m, seed)).to(dev)
        for operand in (r, r.to(torch.bfloat16)):
            before = (tc.LAUNCHES, tc.PADDED)
            got = tc.threshold_step(operand)
            assert got.dtype == operand.dtype
            assert torch.equal(got, tc.threshold_step_ref(operand))
            launched = 1 if s and m else 0
            assert (tc.LAUNCHES, tc.PADDED) == (
                before[0] + launched, before[1] + launched * (m % 8 != 0))
