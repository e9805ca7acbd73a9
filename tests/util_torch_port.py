"""Helpers shared by the ``test_torch_*`` parity tests: carry reference
(``repro``) objects across to the port (``repro_torch``) as plain numpy
arrays and compare the two stacks field by field, exactly."""
import numpy as np

from repro_torch import convert

CSR_FIELDS = ("e_ptr", "e_idx", "v_ptr", "v_idx")
LABEL_FIELDS = ("labels_edge", "labels_rank", "labels_s", "dual_u", "dual_s")


def assert_same_array(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} != {b.dtype}"
    assert a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}"
    assert a.tobytes() == b.tobytes(), f"{what}: bytes differ"


def assert_same_hypergraph(ref_h, port_h):
    assert (ref_h.n, ref_h.m) == (port_h.n, port_h.m)
    for f in CSR_FIELDS:
        assert_same_array(getattr(ref_h, f), getattr(port_h, f), f)


def assert_same_index(ref_idx, port_idx):
    assert_same_array(ref_idx.rank, port_idx.rank, "rank")
    assert_same_array(ref_idx.perm, port_idx.perm, "perm")
    for f in LABEL_FIELDS:
        ra, pa = getattr(ref_idx, f), getattr(port_idx, f)
        assert len(ra) == len(pa), f
        for i, (x, y) in enumerate(zip(ra, pa)):
            assert_same_array(x, y, f"{f}[{i}]")
    assert dict(ref_idx.stats) == dict(port_idx.stats)
    for x, y, f in zip(ref_idx.as_padded(), port_idx.as_padded(),
                       ("ranks", "svals", "lengths")):
        assert_same_array(x, y, f"as_padded {f}")


def port_hypergraph(ref_h):
    """The port's ``Hypergraph`` carrying a reference graph's arrays."""
    return convert.hypergraph_from_arrays(
        ref_h.n, *(np.asarray(getattr(ref_h, f)) for f in CSR_FIELDS))


def port_index(ref_idx, port_h=None):
    """The port's ``HLIndex`` carrying a reference index's arrays."""
    port_h = port_hypergraph(ref_idx.h) if port_h is None else port_h
    return convert.hlindex_from_arrays(
        port_h, np.asarray(ref_idx.rank), np.asarray(ref_idx.perm),
        *([np.asarray(a) for a in getattr(ref_idx, f)]
          for f in LABEL_FIELDS), stats=dict(ref_idx.stats))


def snapshot_arrays(snap):
    """(ranks, svals, lengths) of either stack's snapshot as numpy."""
    return tuple(np.asarray(getattr(snap, f))
                 for f in ("ranks", "svals", "lengths"))
