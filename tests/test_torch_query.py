"""Port parity, query layer: ``batched_mr``, ``DeviceSnapshot`` and
``KernelSnapshot`` of ``repro_torch`` on ``device="cpu"`` against the
reference package and the MST oracle — values and dtypes, tolerance 0.
Also the places where the two stacks differ in kind: snapshot
immutability under ``patch_rows``, integer widths, and empty shapes."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.api as ref_api
import repro.core.query as ref_q
from repro.core.baselines import MSTOracle as RefMSTOracle
from repro.core.hlindex import build_fast as ref_build_fast
from repro.core.hlindex import pad_label_rows as ref_pad_label_rows
from repro.core.minimal import minimize as ref_minimize
import repro_torch.core.query as port_q
from repro_torch.convert import snapshot_from_arrays
from repro_torch.core.hlindex import build_fast, pad_label_rows
from repro_torch.core.hypergraph import from_edge_lists, random_hypergraph
from repro_torch.core.minimal import minimize

from util_torch_port import (assert_same_array, port_hypergraph, port_index,
                             snapshot_arrays)

_PAD = np.iinfo(np.int32).max


@pytest.fixture(scope="module")
def world():
    ref_h = ref_api.compact(ref_api.random_hypergraph(
        60, 90, min_size=2, max_size=7, seed=42))[0]
    ref_idx = ref_minimize(ref_build_fast(ref_h))
    port_h = port_hypergraph(ref_h)
    port_idx = minimize(build_fast(port_h))
    rng = np.random.default_rng(0)
    us, vs = rng.integers(0, ref_h.n, 500), rng.integers(0, ref_h.n, 500)
    oracle = RefMSTOracle(ref_h)
    want = np.array([oracle.mr(int(u), int(v)) for u, v in zip(us, vs)],
                    np.int32)
    return dict(ref_h=ref_h, ref_idx=ref_idx, port_h=port_h,
                port_idx=port_idx, us=us, vs=vs, want=want,
                ref_snap=ref_q.DeviceSnapshot.from_hlindex(ref_idx),
                port_snap=port_q.DeviceSnapshot.from_hlindex(port_idx,
                                                             device="cpu"))


def _same_answers(got: torch.Tensor, ref, dtype):
    ref = np.asarray(ref)
    assert got.device.type == "cpu"
    assert got.numpy().dtype == ref.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), ref)


def test_snapshot_tensors_identical(world):
    for a, b in zip(snapshot_arrays(world["ref_snap"]),
                    snapshot_arrays(world["port_snap"])):
        assert_same_array(a, b)
    assert world["port_snap"].lmax == world["ref_snap"].lmax
    assert world["port_snap"].nbytes() == world["ref_snap"].nbytes()
    assert world["port_snap"].backend == world["ref_snap"].backend
    assert all(t.is_contiguous() and t.dtype == torch.int32
               for t in (world["port_snap"].ranks, world["port_snap"].svals,
                         world["port_snap"].lengths))


def test_device_snapshot_mr_and_s_reach(world):
    us, vs = world["us"], world["vs"]
    got = world["port_snap"].mr(us, vs)
    _same_answers(got, world["ref_snap"].mr(us, vs), np.int32)
    np.testing.assert_array_equal(got.numpy(), world["want"])
    for s in (1, 2, 4):
        _same_answers(world["port_snap"].s_reach(us, vs, s),
                      world["ref_snap"].s_reach(us, vs, s), np.bool_)


def test_batched_mr_function(world):
    snap = world["port_snap"]
    us = torch.from_numpy(world["us"])            # int64, as torch indexes
    vs = torch.from_numpy(world["vs"])
    got = port_q.batched_mr(snap.ranks, snap.svals, us, vs)
    ref = ref_q.batched_mr(world["ref_snap"].ranks, world["ref_snap"].svals,
                           jnp.asarray(world["us"]), jnp.asarray(world["vs"]))
    _same_answers(got, ref, np.int32)
    rows = port_q._gather_rows(snap.ranks, snap.svals, us, vs)
    assert torch.equal(port_q.searchsorted_join(*rows), got)
    # ids of any integer width, or plain lists, answer the same
    assert torch.equal(snap.mr(world["us"].astype(np.int32).tolist(),
                               world["vs"].astype(np.int16)), got)


def test_kernel_snapshot_equals_reference_kernel_path(world):
    us, vs = world["us"], world["vs"]
    view = port_q.KernelSnapshot(world["port_snap"])
    got = view.mr(us, vs)
    np.testing.assert_array_equal(got.numpy(), world["want"])
    ref_view = ref_q.KernelSnapshot(world["ref_snap"], interpret=True)
    _same_answers(got, ref_view.mr(us, vs), np.int32)
    _same_answers(view.s_reach(us, vs, 2), ref_view.s_reach(us, vs, 2),
                  np.bool_)
    assert (view.backend, view.version, view.lmax, view.nbytes()) == \
        (ref_view.backend, ref_view.version, ref_view.lmax, ref_view.nbytes())
    # the join gets the snapshot's own tensors and exactly Q id pairs: no
    # gathered rows, no bucket, no repeated first pair
    seen = []
    view._join = lambda *ops: seen.append(ops) or \
        torch.zeros(ops[2].shape[0], dtype=torch.int32)
    view.mr(us[:37], vs[:37])
    (ranks, svals, got_us, got_vs), = seen
    assert ranks is world["port_snap"].ranks
    assert svals is world["port_snap"].svals
    assert got_us.dtype == got_vs.dtype == torch.int64
    assert got_us.tolist() == us[:37].tolist()
    assert got_vs.tolist() == vs[:37].tolist()


def test_kernel_snapshot_repeated_ids_in_one_batch(world):
    # ids repeat within the batch (and every pair appears twice): the view
    # reads the same snapshot rows for each copy and answers as the
    # reference's kernel path and batched_mr do
    us = np.concatenate([world["us"][:40], world["us"][:40][::-1],
                         np.full(5, world["us"][3])])
    vs = np.concatenate([world["vs"][:40], world["vs"][:40][::-1],
                         np.full(5, world["vs"][3])])
    got = port_q.KernelSnapshot(world["port_snap"]).mr(us, vs)
    ref_view = ref_q.KernelSnapshot(world["ref_snap"], interpret=True)
    _same_answers(got, ref_view.mr(us, vs), np.int32)
    _same_answers(got, world["ref_snap"].mr(us, vs), np.int32)
    assert torch.equal(got, port_q.batched_mr(
        world["port_snap"].ranks, world["port_snap"].svals,
        torch.from_numpy(us), torch.from_numpy(vs)))
    assert got[:40].tolist() == got[40:80].flip(0).tolist()
    assert len(set(got[80:].tolist())) == 1


def test_kernel_snapshot_validates_ranks_once(world):
    snap = world["port_snap"]
    bad = port_q.DeviceSnapshot(
        ranks=torch.full_like(snap.ranks, _PAD - 1), svals=snap.svals,
        lengths=snap.lengths)
    with pytest.raises(ValueError, match="sentinel"):
        port_q.KernelSnapshot(bad)


def test_snapshot_from_reference_arrays_answers_equally(world):
    carried = snapshot_from_arrays(*snapshot_arrays(world["ref_snap"]),
                                   backend=world["ref_snap"].backend,
                                   version=7, device="cpu")
    assert carried.version == 7 and carried.backend == "hl-index"
    us, vs = world["us"], world["vs"]
    _same_answers(carried.mr(us, vs), world["ref_snap"].mr(us, vs), np.int32)
    _same_answers(port_q.KernelSnapshot(carried).mr(us, vs),
                  world["ref_snap"].mr(us, vs), np.int32)
    with pytest.raises(ValueError):
        snapshot_from_arrays(np.zeros((3, 2)), np.zeros((3, 3)),
                             np.zeros(3), device="cpu")


def test_padded_index_back_compat(world):
    pidx = port_q.PaddedIndex(world["port_idx"], device="cpu")
    ref_pidx = ref_q.PaddedIndex(world["ref_idx"])
    _same_answers(pidx.mr(world["us"], world["vs"]),
                  ref_pidx.mr(world["us"], world["vs"]), np.int32)


def test_snapshot_of_converted_index_identical(world):
    snap = port_q.DeviceSnapshot.from_hlindex(
        port_index(world["ref_idx"]), device="cpu")
    for a, b in zip(snapshot_arrays(world["ref_snap"]),
                    snapshot_arrays(snap)):
        assert_same_array(a, b)


PATCH_CASES = [
    # (rows, new lmax delta, new n delta)
    ([3, 17, 40], 0, 0),
    ([0, 5], 3, 0),          # wider rows
    ([1, 2, 58], -2, 0),     # narrower: columns sliced off
    ([4, 59, 60, 62], 2, 3),  # grown vertex set and width
    ([], 1, 2),              # resize only
]


@pytest.mark.parametrize("rows,dl,dn", PATCH_CASES)
def test_patch_rows_identical_and_old_snapshot_unchanged(world, rows, dl, dn):
    ref_snap, port_snap = world["ref_snap"], world["port_snap"]
    n, lmax = ref_snap.ranks.shape
    new_n, new_l = n + dn, lmax + dl
    rng = np.random.default_rng(5)
    row_r = [np.sort(rng.choice(1000, int(rng.integers(0, new_l + 1)),
                                replace=False)).astype(np.int64)
             for _ in rows]
    row_s = [rng.integers(1, 9, r.size).astype(np.int64) for r in row_r]
    if dl < 0:
        # a narrower snapshot is legal only if the clean rows fit: blank
        # them first in both stacks through the same primitive
        wide = np.nonzero(np.asarray(ref_snap.lengths) > new_l)[0]
        blank = pad_label_rows([np.empty(0, np.int64)] * wide.size,
                               [np.empty(0, np.int64)] * wide.size,
                               pad_to=lmax)
        ref_snap = ref_snap.patch_rows(wide, *blank)
        port_snap = port_snap.patch_rows(wide, *blank)
    before = [t.clone() for t in (port_snap.ranks, port_snap.svals,
                                  port_snap.lengths)]
    padded = pad_label_rows(row_r, row_s, pad_to=new_l)
    for a, b in zip(padded, ref_pad_label_rows(row_r, row_s, pad_to=new_l)):
        assert_same_array(a, b)
    ref_new = ref_snap.patch_rows(rows, *padded, n=new_n, lmax=new_l,
                                  version=3, backend="x")
    port_new = port_snap.patch_rows(rows, *padded, n=new_n, lmax=new_l,
                                    version=3, backend="x")
    for a, b in zip(snapshot_arrays(ref_new), snapshot_arrays(port_new)):
        assert_same_array(a, b)
    assert (port_new.version, port_new.backend) == (3, "x")
    assert all(t.is_contiguous() for t in (port_new.ranks, port_new.svals))
    # immutability: the patched-from snapshot still holds its old bytes
    for old, now in zip(before, (port_snap.ranks, port_snap.svals,
                                 port_snap.lengths)):
        assert torch.equal(old, now)
    assert port_new.ranks.data_ptr() != port_snap.ranks.data_ptr() \
        or port_new.ranks.numel() == 0


def test_empty_batch_and_empty_snapshots(world):
    empty = np.empty(0, np.int64)
    for view in (world["port_snap"], port_q.KernelSnapshot(world["port_snap"])):
        got = view.mr(empty, empty)
        assert got.shape == (0,) and got.dtype == torch.int32
        assert view.s_reach(empty, empty, 1).dtype == torch.bool
    # L = 0: vertices but no labels anywhere
    h = from_edge_lists([], n=4)
    assert h.m == 0
    idx = build_fast(h)
    snap = port_q.DeviceSnapshot.from_hlindex(idx, device="cpu")
    assert snap.lmax == 0 and tuple(snap.ranks.shape) == (4, 0)
    ref_snap = ref_q.DeviceSnapshot.from_hlindex(
        ref_build_fast(ref_api.from_edge_lists([], n=4)))
    us, vs = np.array([0, 3, 1]), np.array([2, 3, 0])
    for view in (snap, port_q.KernelSnapshot(snap)):
        _same_answers(view.mr(us, vs), ref_snap.mr(us, vs), np.int32)
        _same_answers(view.s_reach(us, vs, 1), ref_snap.s_reach(us, vs, 1),
                      np.bool_)
    z = torch.zeros((0, 5), dtype=torch.int32)
    assert port_q.searchsorted_join(z, z, z, z).shape == (0,)
    z = torch.zeros((3, 0), dtype=torch.int32)
    assert port_q.searchsorted_join(z, z, z, z).tolist() == [0, 0, 0]


def test_from_padded_copies_host_arrays_and_needs_a_device():
    h = random_hypergraph(12, 15, seed=1)
    ranks, svals, lengths = build_fast(h).as_padded()
    snap = port_q.DeviceSnapshot.from_padded(ranks, svals, lengths, "hl-index",
                                             device="cpu")
    kept = snap.ranks.clone()
    ranks[:] = 0                      # the caller's buffer is its own
    assert torch.equal(snap.ranks, kept)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_q.DeviceSnapshot.from_padded(ranks, svals, lengths, "hl-index")
