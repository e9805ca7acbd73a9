"""Port parity, the durable index store (``repro_torch.store``): every test
of ``tests/test_store.py`` mirrored against the port on ``device="cpu"``,
with the same parametrisations, plus what ties the two packages together:
a file or store directory written by either one loads in the other with
byte-equal arrays and equal answers, both write byte-identical files for
the same engine history, loaded arrays keep the reference's dtypes, and a
loaded engine serving and updating on the CPU never writes into its
checkpoint's pages.  The crash-under-fire path (SIGKILL mid-stream) lives
in tests/test_torch_crash_recovery.py."""
import json
import os
import zlib

import numpy as np
import pytest
import torch

import repro.api as ref_api
import repro.store as ref_store
import repro_torch.api as port_api
from repro_torch.api import build_engine, random_hypergraph, serve
from repro_torch.core.hypergraph import neighbor_csr
from repro_torch.serve.reach_service import ReachabilityService
from repro_torch.store import (FORMAT_REGISTRY, FORMAT_VERSION, CorruptStore,
                               IndexStore, StoreError, StoreUnsupported,
                               WriteAheadLog, load_index, load_segments,
                               read_hif, read_manifest, save_index, scan_wal,
                               write_hif)

from util_torch_port import (CSR_FIELDS, assert_same_array,
                             assert_same_hypergraph, assert_same_index)

CPU = {"device": "cpu"}


def _graph():
    return random_hypergraph(36, 48, seed=5)


def _queries(h, q=64, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, h.n, q), rng.integers(0, h.n, q)


def _memmap_backed(a: np.ndarray) -> bool:
    while a is not None:
        if isinstance(a, np.memmap):
            return True
        a = a.base
    return False


# ---------------------------------------------------------------------------
# format: save/load round trips
# ---------------------------------------------------------------------------

def test_format_registry_names_current_version():
    assert FORMAT_VERSION in FORMAT_REGISTRY
    assert FORMAT_REGISTRY == ref_store.FORMAT_REGISTRY
    assert FORMAT_VERSION == ref_store.FORMAT_VERSION


@pytest.mark.parametrize("backend,opts", [
    ("hl-index", {}),
    ("hl-index", {"minimize_labels": False}),
    ("hl-index", {"construction": "sharded", "workers": 2}),
    ("hl-index-basic", {}),
    ("hl-index-basic", {"cover_check": False}),
    ("closure", {}),
])
def test_round_trip_byte_identical(tmp_path, backend, opts):
    h = _graph()
    eng = build_engine(h, backend, **CPU, **opts)
    p = tmp_path / "x.hlidx"
    save_index(p, eng)
    eng2 = load_index(p, **CPU)
    assert eng2.name == backend
    assert eng2.version == eng.version == 0
    assert eng2.device.type == "cpu"
    # graph arrays
    for f in ("e_ptr", "e_idx", "v_ptr", "v_idx"):
        a, b = getattr(eng.h, f), getattr(eng2.h, f)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if backend == "closure":
        assert np.array_equal(eng.w_star, eng2.w_star)
    else:
        # the tentpole claim: loaded labels byte-identical to built ones
        assert np.array_equal(eng.idx.rank, eng2.idx.rank)
        assert np.array_equal(eng.idx.perm, eng2.idx.perm)
        for u in range(h.n):
            for attr in ("labels_edge", "labels_rank", "labels_s"):
                a = getattr(eng.idx, attr)[u]
                b = getattr(eng2.idx, attr)[u]
                assert a.dtype == b.dtype and np.array_equal(a, b)
        # zero-copy: label arrays are views into the file mmap, so the
        # restart path is page-in + one snapshot landing, not a rebuild
        assert _memmap_backed(eng2.idx.rank)
        assert _memmap_backed(eng2.idx.labels_s[0])
    us, vs = _queries(h)
    assert np.array_equal(eng.mr_batch(us, vs), eng2.mr_batch(us, vs))


def test_restored_update_path_keeps_builder(tmp_path):
    """A restored engine continues scoped maintenance with the same
    builder/minimizer options it was built with."""
    h = _graph()
    eng = build_engine(h, "hl-index", construction="sharded", workers=2,
                       **CPU)
    save_index(tmp_path / "x.hlidx", eng)
    eng2 = load_index(tmp_path / "x.hlidx", **CPU)
    assert eng2.construction == "sharded"
    assert eng2._builder.keywords == {"workers": 2, "num_shards": None}
    for e in (eng, eng2):
        e.update(inserts=[[1, 2, 3]], deletes=[0])
    assert eng2.version == 1
    us, vs = _queries(eng.h)
    assert np.array_equal(eng.mr_batch(us, vs), eng2.mr_batch(us, vs))


def test_sharded_round_trip_all_payloads(tmp_path):
    """``tests/test_store.py``'s round trip of the ``sharded`` backend's
    three payloads (closure resident, snapshot after W* was freed,
    labels), on a logical 2 x 2 grid: each loaded engine answers as the
    live one, and the label regime's keeps updating alike."""
    h = _graph()
    us, vs = _queries(h)
    mesh = port_api.make_mesh((2, 2), ("data", "model"), device="cpu")
    # closure-resident regime
    eng = build_engine(h, "sharded", mesh=mesh)
    save_index(tmp_path / "c.hlidx", eng)
    assert read_manifest(tmp_path / "c.hlidx")["payload"] == "closure"
    r1 = load_index(tmp_path / "c.hlidx", mesh=mesh)
    assert r1.mesh == mesh and r1.device.type == "cpu"
    assert np.array_equal(eng.mr_batch(us, vs), r1.mr_batch(us, vs))
    # snapshot regime (snapshot() frees the closure)
    eng.snapshot()
    assert eng._w_star is None
    save_index(tmp_path / "s.hlidx", eng)
    assert read_manifest(tmp_path / "s.hlidx")["payload"] == "snapshot"
    r2 = load_index(tmp_path / "s.hlidx", mesh=mesh)
    assert np.array_equal(eng.mr_batch(us, vs), r2.mr_batch(us, vs))
    assert r2.snapshot().mesh == mesh
    # label regime
    eng = build_engine(h, "sharded", build_labels=True, mesh=mesh)
    save_index(tmp_path / "l.hlidx", eng)
    assert read_manifest(tmp_path / "l.hlidx")["payload"] == "labels"
    r3 = load_index(tmp_path / "l.hlidx", mesh=mesh)
    assert np.array_equal(eng.mr_batch(us, vs), r3.mr_batch(us, vs))
    r3.update(inserts=[[4, 5, 6]])
    eng.update(inserts=[[4, 5, 6]])
    assert np.array_equal(eng.mr_batch(us, vs), r3.mr_batch(us, vs))
    # a non-auto backend still asserts what the file holds first
    for name in ("c", "s", "l"):
        with pytest.raises(StoreError, match="sharded"):
            load_index(tmp_path / f"{name}.hlidx",
                       expect_backend="hl-index", **CPU)


def _sharded_twins(payload, updates):
    """The same ``sharded`` engine history in both packages on a one-block
    mesh (the reference's, in process, has one host device), brought to
    the state whose checkpoint holds ``payload``."""
    labels = payload == "labels"
    ref = ref_api.build_engine(ref_api.random_hypergraph(36, 48, seed=5),
                               "sharded", build_labels=labels)
    port = build_engine(_graph(), "sharded", build_labels=labels, **CPU)
    for ins, dels in UPDATES[:updates]:
        ref.update(inserts=ins, deletes=dels)
        port.update(inserts=ins, deletes=dels)
    if payload == "snapshot":
        ref.snapshot()
        port.snapshot()
    return ref, port


@pytest.mark.parametrize("updates", [0, 2])
@pytest.mark.parametrize("payload", ["closure", "snapshot", "labels"])
def test_sharded_files_byte_identical_across_packages(tmp_path, payload,
                                                      updates):
    """Both packages write the same bytes for the same ``sharded`` history
    (one-block mesh, in process), and each loads the other's file to the
    same answers."""
    ref, port = _sharded_twins(payload, updates)
    m_ref = ref_store.save_index(tmp_path / "ref.hlidx", ref)
    m_port = save_index(tmp_path / "port.hlidx", port)
    assert m_ref["payload"] == m_port["payload"] == payload
    assert m_ref == m_port
    assert (tmp_path / "ref.hlidx").read_bytes() == \
        (tmp_path / "port.hlidx").read_bytes()
    from_ref = load_index(tmp_path / "ref.hlidx", **CPU)
    from_port = ref_store.load_index(tmp_path / "port.hlidx")
    want = _answers(ref).astype(np.int64)
    for eng in (port, from_ref, from_port):
        assert np.array_equal(np.asarray(_answers(eng), np.int64), want)


_SHARDED_2X2_CODE = """
import sys
import numpy as np
from repro.api import build_engine, random_hypergraph
from repro.launch.mesh import make_test_mesh
from repro.store import save_index

out = sys.argv[1]
mesh = make_test_mesh((2, 2), ("data", "model"))
h = random_hypergraph(36, 48, seed=5)
eng = build_engine(h, "sharded", mesh=mesh)
eng.update(inserts=[[1, 2, 3]], deletes=[0])
save_index(out + "/closure.hlidx", eng)
eng.snapshot()
save_index(out + "/snapshot.hlidx", eng)
eng = build_engine(h, "sharded", mesh=mesh, build_labels=True)
eng.update(inserts=[[1, 2, 3]], deletes=[0])
save_index(out + "/labels.hlidx", eng)
print("WROTE")
"""


def test_sharded_files_byte_identical_on_a_2x2_grid(tmp_path):
    """The reference on four host devices (a subprocess) and the port on a
    logical 2 x 2 grid write byte-identical files for all three payloads
    after one scoped update — the manifest's ``shards`` / ``components``
    stats and the padded snapshot geometry included."""
    import subprocess
    import sys
    from util_subproc import SRC
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    out = subprocess.run([sys.executable, "-c", _SHARDED_2X2_CODE,
                          str(ref_dir)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and "WROTE" in out.stdout, out.stderr
    mesh = port_api.make_mesh((2, 2), ("data", "model"), device="cpu")
    h = _graph()
    eng = build_engine(h, "sharded", mesh=mesh)
    eng.update(inserts=[[1, 2, 3]], deletes=[0])
    save_index(tmp_path / "closure.hlidx", eng)
    eng.snapshot()
    save_index(tmp_path / "snapshot.hlidx", eng)
    eng = build_engine(h, "sharded", mesh=mesh, build_labels=True)
    eng.update(inserts=[[1, 2, 3]], deletes=[0])
    save_index(tmp_path / "labels.hlidx", eng)
    for payload in ("closure", "snapshot", "labels"):
        mine = (tmp_path / f"{payload}.hlidx").read_bytes()
        theirs = (ref_dir / f"{payload}.hlidx").read_bytes()
        assert read_manifest(tmp_path / f"{payload}.hlidx") == \
            read_manifest(ref_dir / f"{payload}.hlidx"), payload
        assert mine == theirs, payload
        loaded = load_index(ref_dir / f"{payload}.hlidx", mesh=mesh)
        assert np.array_equal(_answers(loaded), _answers(eng))


def test_neighbor_csr_block_round_trip(tmp_path):
    h = _graph()
    eng = build_engine(h, "hl-index", **CPU)
    nbr = neighbor_csr(h)
    save_index(tmp_path / "x.hlidx", eng, neighbors=nbr)
    _, seg = load_segments(tmp_path / "x.hlidx")
    assert np.array_equal(seg["nbr.ptr"], nbr.ptr)
    assert np.array_equal(seg["nbr.idx"], nbr.idx)
    assert np.array_equal(seg["nbr.od"], nbr.od)


@pytest.mark.parametrize("backend", ["online", "frontier", "mst-oracle"])
def test_index_free_backends_unsupported(tmp_path, backend):
    eng = build_engine(_graph(), backend, **CPU)
    with pytest.raises(StoreUnsupported):
        save_index(tmp_path / "x.hlidx", eng)


# ---------------------------------------------------------------------------
# format: corruption detection
# ---------------------------------------------------------------------------

def _flip_byte(path, offset):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def test_bad_magic_rejected(tmp_path):
    p = tmp_path / "x.hlidx"
    save_index(p, build_engine(_graph(), "hl-index", **CPU))
    _flip_byte(p, 0)
    with pytest.raises(CorruptStore, match="magic"):
        load_index(p, **CPU)


def test_unknown_format_version_rejected(tmp_path):
    p = tmp_path / "x.hlidx"
    save_index(p, build_engine(_graph(), "hl-index", **CPU))
    _flip_byte(p, 8)                      # the u32 format version field
    with pytest.raises(CorruptStore, match="format version"):
        load_index(p, **CPU)


def test_truncated_file_fails_manifest_crc(tmp_path):
    p = tmp_path / "x.hlidx"
    save_index(p, build_engine(_graph(), "hl-index", **CPU))
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) - 7)
    with pytest.raises(CorruptStore):
        load_index(p, **CPU)


def test_corrupt_segment_detected_by_checksum(tmp_path):
    p = tmp_path / "x.hlidx"
    manifest = save_index(p, build_engine(_graph(), "hl-index", **CPU))
    seg = next(s for s in manifest["segments"] if s["name"] == "labels.s")
    _flip_byte(p, seg["offset"])
    with pytest.raises(CorruptStore, match="labels.s"):
        load_index(p, verify=True, **CPU)
    load_index(p, verify=False, **CPU)    # lazy mode defers integrity


def test_expect_backend_mismatch(tmp_path):
    p = tmp_path / "x.hlidx"
    save_index(p, build_engine(_graph(), "closure", **CPU))
    with pytest.raises(StoreError, match="closure"):
        load_index(p, expect_backend="hl-index", **CPU)


# ---------------------------------------------------------------------------
# build_engine(restore=...)
# ---------------------------------------------------------------------------

def test_build_engine_restore_from_file(tmp_path):
    h = _graph()
    eng = build_engine(h, "hl-index", **CPU)
    p = tmp_path / "x.hlidx"
    save_index(p, eng)
    eng2 = build_engine(restore=p, **CPU)
    us, vs = _queries(h)
    assert np.array_equal(eng.mr_batch(us, vs), eng2.mr_batch(us, vs))
    # non-auto backend asserts what the checkpoint must hold
    with pytest.raises(StoreError):
        build_engine(backend="sharded", restore=p, **CPU)


def test_build_engine_argument_validation(tmp_path):
    h = _graph()
    with pytest.raises(ValueError, match="ambiguous"):
        build_engine(h, restore=tmp_path / "x.hlidx")
    with pytest.raises(ValueError, match="hypergraph"):
        build_engine()


# ---------------------------------------------------------------------------
# write-ahead log
# ---------------------------------------------------------------------------

def test_wal_append_scan_round_trip(tmp_path):
    p = tmp_path / "w.log"
    with WriteAheadLog(p) as wal:
        wal.append(1, [[1, 2, 3]], [])
        wal.append(2, [], [0, 4])
        wal.append(3, [[5, 6], [7, 8]], [2])
    records, _, status = scan_wal(p)
    assert status == "ok"
    assert records == [(1, [[1, 2, 3]], []), (2, [], [0, 4]),
                       (3, [[5, 6], [7, 8]], [2])]
    # the record layout is the reference's: each package reads the other's
    assert ref_store.scan_wal(p) == scan_wal(p)
    q = tmp_path / "ref.log"
    with ref_store.WriteAheadLog(q) as wal:
        for version, ins, dels in records:
            wal.append(version, ins, dels)
    assert q.read_bytes() == p.read_bytes()


def test_wal_monotonic_versions_enforced(tmp_path):
    with WriteAheadLog(tmp_path / "w.log", base_version=5) as wal:
        with pytest.raises(StoreError, match="monotonic"):
            wal.append(5, [], [0])
        with pytest.raises(StoreError, match="monotonic"):
            wal.append(7, [], [0])
        wal.append(6, [], [0])
        assert wal.last_version == 6


@pytest.mark.parametrize("mutilate,expect", [
    (lambda data: data[:-3], "torn-payload"),
    (lambda data: data + b"\x01\x02\x03", "torn-header"),
    (lambda data: data + b"\x00" * 40, "bad-magic"),
])
def test_wal_torn_tail_dropped_not_fatal(tmp_path, mutilate, expect):
    p = tmp_path / "w.log"
    with WriteAheadLog(p) as wal:
        wal.append(1, [[1, 2]], [])
        wal.append(2, [[3, 4]], [])
    data = p.read_bytes()
    p.write_bytes(mutilate(data))
    records, valid, status = scan_wal(p)
    assert status == expect
    assert (records, valid, status) == ref_store.scan_wal(p)
    assert [r[0] for r in records] == ([1] if expect == "torn-payload"
                                       else [1, 2])
    # reopening truncates the tail for good and resumes the lineage
    with WriteAheadLog(p) as wal:
        assert os.path.getsize(p) == valid
        assert wal.last_version == records[-1][0]
        wal.append(records[-1][0] + 1, [[9]], [])
    assert scan_wal(p)[2] == "ok"


def test_wal_flipped_payload_byte_is_bad_checksum(tmp_path):
    p = tmp_path / "w.log"
    with WriteAheadLog(p) as wal:
        wal.append(1, [[1, 2]], [])
    data = bytearray(p.read_bytes())
    data[-1] ^= 0xFF
    p.write_bytes(bytes(data))
    records, _, status = scan_wal(p)
    assert status == "bad-checksum" and records == []


# ---------------------------------------------------------------------------
# engine WAL hook ordering
# ---------------------------------------------------------------------------

def test_rejected_update_is_never_journaled(tmp_path):
    h = _graph()
    eng = build_engine(h, "hl-index", **CPU)
    store = IndexStore(tmp_path / "s")
    store.attach(eng)
    wal_path = store.path / "wal-000000000000.log"
    with pytest.raises(IndexError):
        eng.update(deletes=[h.m + 3])     # validated before journaling
    assert eng.version == 0
    assert scan_wal(wal_path)[0] == []
    eng.update(inserts=[[0, 1, 2]])
    assert [r[0] for r in scan_wal(wal_path)[0]] == [1]


def test_unsupported_backend_gates_before_journal(tmp_path):
    eng = build_engine(_graph(), "mst-oracle", **CPU)
    with pytest.raises(port_api.UpdateUnsupported):
        eng.update(inserts=[[1, 2]])
    assert eng.version == 0


# ---------------------------------------------------------------------------
# IndexStore: checkpoint / replay / compaction
# ---------------------------------------------------------------------------

def _stream(eng, k, seed=11):
    rng = np.random.default_rng(seed)
    for i in range(k):
        ins = [sorted(int(x) for x in rng.choice(eng.h.n, 3, replace=False))]
        dels = [int(rng.integers(0, eng.h.m))] if i % 3 == 2 else []
        eng.update(inserts=ins, deletes=dels)


def test_store_checkpoint_replay_matches_live(tmp_path):
    h = _graph()
    eng = build_engine(h, "hl-index", **CPU)
    store = IndexStore(tmp_path / "s")
    store.attach(eng)                     # seeds checkpoint-0
    _stream(eng, 6)
    assert eng.version == 6
    eng2 = IndexStore(tmp_path / "s").restore(**CPU)
    assert eng2.version == 6
    us, vs = _queries(eng.h)
    assert np.array_equal(eng.mr_batch(us, vs), eng2.mr_batch(us, vs))
    # the restored engine resumes the lineage: next update journals
    eng2.update(inserts=[[0, 1]])
    assert eng2.version == 7


def test_store_compaction_truncates_log(tmp_path):
    h = _graph()
    eng = build_engine(h, "hl-index", **CPU)
    store = IndexStore(tmp_path / "s", checkpoint_every=3)
    store.attach(eng)
    _stream(eng, 7)
    assert store.checkpoint_version == 6  # compacted at 3 and 6
    files = sorted(os.listdir(store.path))
    assert sum(f.startswith("checkpoint-") for f in files) == 1
    assert sum(f.startswith("wal-") for f in files) == 1
    assert store.records_since_checkpoint == 1
    eng2 = IndexStore(tmp_path / "s").restore(**CPU)
    assert eng2.version == 7
    us, vs = _queries(eng.h)
    assert np.array_equal(eng.mr_batch(us, vs), eng2.mr_batch(us, vs))


def test_store_lineage_mismatch_rejected(tmp_path):
    h = _graph()
    eng = build_engine(h, "hl-index", **CPU)
    store = IndexStore(tmp_path / "s")
    store.attach(eng)
    eng.update(inserts=[[0, 1, 2]])
    store.close()
    stranger = build_engine(h, "hl-index", **CPU)   # version 0, store at 1
    with pytest.raises(StoreError, match="lineage"):
        IndexStore(tmp_path / "s").attach(stranger)


def test_store_restore_empty_dir_is_error(tmp_path):
    with pytest.raises(StoreError, match="nothing to restore"):
        IndexStore(tmp_path / "empty").restore(**CPU)


def test_store_restore_detects_lineage_gap(tmp_path):
    h = _graph()
    eng = build_engine(h, "hl-index", **CPU)
    store = IndexStore(tmp_path / "s")
    store.attach(eng)
    eng.update(inserts=[[0, 1]])
    eng.update(inserts=[[2, 3]])
    store.close()
    # forge a gap: rewrite the log with only record 2
    wal_path = store.path / "wal-000000000000.log"
    records = scan_wal(wal_path)[0]
    wal_path.unlink()
    with WriteAheadLog(wal_path, base_version=1) as w:
        v, ins, dels = records[1]
        w.append(v, ins, dels)
    with pytest.raises(CorruptStore, match="lineage gap"):
        IndexStore(tmp_path / "s").restore(**CPU)


def test_replay_runs_with_the_log_detached(tmp_path):
    """Restart order: the suffix replays with no WAL sink attached (an
    update during replay must not journal a second time), then the store
    re-attaches and the next live update journals once."""
    h = _graph()
    eng = build_engine(h, "hl-index", **CPU)
    store = IndexStore(tmp_path / "s")
    store.attach(eng)
    _stream(eng, 4)
    store.close()
    wal_path = tmp_path / "s" / "wal-000000000000.log"
    before = wal_path.read_bytes()
    seen = []
    store2 = IndexStore(tmp_path / "s")
    orig_append = store2.append

    def spy(version, ins, dels):
        seen.append(version)
        orig_append(version, ins, dels)

    store2.append = spy
    eng2 = store2.restore(**CPU)
    assert eng2.version == 4 and seen == []
    assert wal_path.read_bytes() == before
    assert eng2._wal is store2
    eng2.update(inserts=[[5, 6]])
    assert seen == [5]
    assert [r[0] for r in scan_wal(wal_path)[0]] == [1, 2, 3, 4, 5]
    store2.close()


# ---------------------------------------------------------------------------
# service checkpoint / restore
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [False, True])
def test_service_checkpoint_restore_round_trip(tmp_path, use_kernels):
    h = _graph()
    svc = serve(h, "hl-index", start=False, **CPU)
    store = IndexStore(tmp_path / "s")
    assert svc.checkpoint(store) == 0
    svc.update(inserts=[[1, 2, 3]])
    svc.update(deletes=[0])
    store.close()
    svc2 = ReachabilityService.restore(tmp_path / "s", start=False,
                                       use_kernels=use_kernels, **CPU)
    assert svc2.engine.version == 2
    assert svc2.use_kernels is use_kernels
    us, vs = _queries(svc.engine.h, q=32)
    futs_a = [svc.mr(int(u), int(v)) for u, v in zip(us, vs)]
    futs_b = [svc2.mr(int(u), int(v)) for u, v in zip(us, vs)]
    svc.drain(), svc2.drain()
    assert [f.result(timeout=30) for f in futs_a] == \
        [f.result(timeout=30) for f in futs_b]
    svc.close(), svc2.close()


# ---------------------------------------------------------------------------
# HIF import/export
# ---------------------------------------------------------------------------

def _hif_doc():
    return {
        "network-type": "undirected",
        "metadata": {"name": "fixture"},
        # "iso" never appears in an incidence: isolated vertex
        "nodes": [{"node": "a"}, {"node": "b"}, {"node": "iso"},
                  {"node": "c"}],
        # e1 and e2 have identical member sets (duplicate-member
        # hyperedges — both must survive); "hollow" has no incidences
        "edges": [{"edge": "e1"}, {"edge": "e2"}, {"edge": "e3"},
                  {"edge": "hollow"}],
        "incidences": [
            {"edge": "e1", "node": "a"}, {"edge": "e1", "node": "b"},
            {"edge": "e2", "node": "a"}, {"edge": "e2", "node": "b"},
            {"edge": "e3", "node": "b"}, {"edge": "e3", "node": "c"},
            {"edge": "e3", "node": "b"},   # within-edge duplicate incidence
        ],
    }


def test_hif_import(tmp_path):
    p = tmp_path / "t.hif.json"
    p.write_text(json.dumps(_hif_doc()))
    h = read_hif(p)
    assert h.n == 4                       # incl. the isolated vertex
    assert h.m == 3                       # the memberless edge is dropped
    sets = [set(h.e_idx[h.e_ptr[e]:h.e_ptr[e + 1]].tolist())
            for e in range(h.m)]
    assert sets[0] == sets[1] == {0, 1}   # duplicate-member pair survives
    assert sets[2] == {1, 3}              # within-edge duplicate collapsed
    assert_same_hypergraph(ref_store.read_hif(p), h)


def test_hif_round_trip_identity(tmp_path):
    p = tmp_path / "t.hif.json"
    p.write_text(json.dumps(_hif_doc()))
    h1 = read_hif(p)
    write_hif(tmp_path / "out.hif.json", h1, metadata={"pass": 1})
    h2 = read_hif(tmp_path / "out.hif.json")
    write_hif(tmp_path / "out2.hif.json", h2)
    h3 = read_hif(tmp_path / "out2.hif.json")
    for a, b in ((h1, h2), (h2, h3)):
        assert a.n == b.n and a.m == b.m
        for f in ("e_ptr", "e_idx", "v_ptr", "v_idx"):
            assert np.array_equal(getattr(a, f), getattr(b, f))
    # the reference writes the same file for the same graph
    ref_store.write_hif(tmp_path / "ref.hif.json",
                        ref_store.read_hif(tmp_path / "out.hif.json"))
    assert (tmp_path / "ref.hif.json").read_bytes() == \
        (tmp_path / "out2.hif.json").read_bytes()


def test_hif_rejects_directed_and_garbage(tmp_path):
    p = tmp_path / "d.hif.json"
    p.write_text(json.dumps({"network-type": "directed", "incidences": []}))
    with pytest.raises(ValueError, match="directed"):
        read_hif(p)
    p2 = tmp_path / "g.hif.json"
    p2.write_text(json.dumps({"nodes": []}))
    with pytest.raises(ValueError, match="incidences"):
        read_hif(p2)


def test_hif_through_make_dataset(tmp_path):
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "benchmarks"))
    try:
        from datasets import make_dataset
    finally:
        sys.path.pop(0)
    h = random_hypergraph(20, 25, seed=9)
    p = tmp_path / "ds.hif.json"
    write_hif(p, h)
    h2 = make_dataset(str(p))             # the reference's dataset loader
    assert h2.n == h.n and h2.m == h.m
    for f in ("e_ptr", "e_idx", "v_ptr", "v_idx"):
        assert np.array_equal(getattr(h, f), getattr(h2, f))
    with pytest.raises(FileNotFoundError):
        make_dataset(str(tmp_path / "missing.hif.json"))
    # an engine built from the imported graph answers like the original
    a = build_engine(h, "hl-index", **CPU)
    b = build_engine(read_hif(p), "hl-index", **CPU)
    us, vs = _queries(h, q=32)
    assert np.array_equal(a.mr_batch(us, vs), b.mr_batch(us, vs))


def test_hif_through_the_ports_make_dataset(tmp_path):
    from repro_torch.benchmarks.datasets import make_dataset
    h = random_hypergraph(20, 25, seed=9)
    p = tmp_path / "ds.hif.json"
    write_hif(p, h)
    h2 = make_dataset(str(p))             # the port's dataset loader
    assert h2.n == h.n and h2.m == h.m
    for f in ("e_ptr", "e_idx", "v_ptr", "v_idx"):
        assert np.array_equal(getattr(h, f), getattr(h2, f))
    with pytest.raises(FileNotFoundError):
        make_dataset(str(tmp_path / "missing.hif.json"))
    a = build_engine(h, "hl-index", **CPU)
    b = build_engine(h2, "hl-index", **CPU)
    us, vs = _queries(h, q=32)
    assert np.array_equal(a.mr_batch(us, vs), b.mr_batch(us, vs))


# ---------------------------------------------------------------------------
# across the two packages: files, bytes, store directories, dtypes
# ---------------------------------------------------------------------------

CROSS = [
    ("hl-index", {}),
    ("hl-index", {"minimize_labels": False}),
    ("hl-index", {"construction": "sharded", "workers": 2}),
    ("hl-index-basic", {}),
    ("hl-index-basic", {"cover_check": False}),
    ("closure", {"method": "maxmin"}),
    ("closure", {"method": "threshold"}),
]
CROSS_IDS = ["hl-index", "hl-index[unminimized]", "hl-index[sharded]",
             "hl-index-basic", "hl-index-basic[nocover]", "closure[maxmin]",
             "closure[threshold]"]
UPDATES = [([[1, 2, 3]], [0]), ([[4, 5], [6, 7, 8]], [])]


def _twins(backend, opts, updates=0):
    """The same engine history in both packages: built on the same graph
    with the same options, then the first ``updates`` batches applied."""
    ref = ref_api.build_engine(ref_api.random_hypergraph(36, 48, seed=5),
                               backend, **opts)
    port = build_engine(_graph(), backend, **CPU, **opts)
    for ins, dels in UPDATES[:updates]:
        ref.update(inserts=ins, deletes=dels)
        port.update(inserts=ins, deletes=dels)
    return ref, port


def _answers(eng):
    us, vs = _queries(eng.h, q=200, seed=3)
    return np.asarray(eng.mr_batch(us, vs))


def assert_same_engine(ref, port):
    """``port`` (a port engine) holds what ``ref`` (a reference engine)
    holds: graph, labels or W*, version, construction, and answers."""
    assert ref.name == port.name and ref.version == port.version
    assert_same_hypergraph(ref.h, port.h)
    if ref.name == "closure":
        assert_same_array(np.asarray(ref.w_star), port.w_star, "w_star")
        assert ref._method == port._method
    else:
        assert_same_index(ref.idx, port.idx)
        assert ref.construction == port.construction
        assert (ref._minimizer is None) == (port._minimizer is None)
    assert_same_array(_answers(ref), _answers(port), "mr_batch")


@pytest.mark.parametrize("backend,opts", CROSS, ids=CROSS_IDS)
def test_reference_file_loads_in_the_port(tmp_path, backend, opts):
    ref, port = _twins(backend, opts, updates=2)
    p = tmp_path / "ref.hlidx"
    ref_store.save_index(p, ref)
    loaded = load_index(p, **CPU)
    assert_same_engine(ref, loaded)
    assert_same_engine(ref, port)
    if backend != "closure":
        # the manifest's engine_opts round-trip: the loaded builder reads
        # back as the live one's does
        from repro_torch.store.format import _hlindex_opts
        assert _hlindex_opts(loaded) == _hlindex_opts(port)


@pytest.mark.parametrize("backend,opts", CROSS, ids=CROSS_IDS)
def test_port_file_loads_in_the_reference(tmp_path, backend, opts):
    ref, port = _twins(backend, opts, updates=2)
    p = tmp_path / "port.hlidx"
    save_index(p, port)
    loaded = ref_store.load_index(p)
    assert_same_engine(loaded, port)
    # and both continue the lineage alike
    for e in (loaded, port):
        e.update(inserts=[[9, 10, 11]])
    assert_same_engine(loaded, port)


@pytest.mark.parametrize("updates", [0, 2])
@pytest.mark.parametrize("backend,opts", CROSS, ids=CROSS_IDS)
def test_both_packages_write_byte_identical_files(tmp_path, backend, opts,
                                                  updates):
    ref, port = _twins(backend, opts, updates=updates)
    m_ref = ref_store.save_index(tmp_path / "ref.hlidx", ref)
    m_port = save_index(tmp_path / "port.hlidx", port)
    assert m_ref == m_port
    assert (tmp_path / "ref.hlidx").read_bytes() == \
        (tmp_path / "port.hlidx").read_bytes()


def _tear_last_record(store_dir):
    wal = next(p for p in sorted(os.listdir(store_dir))
               if p.startswith("wal-"))
    path = os.path.join(store_dir, wal)
    records, valid, _ = scan_wal(path)
    with open(path, "r+b") as f:
        f.truncate(valid - 3)
    return len(records) - 1


@pytest.mark.parametrize("backend", ["hl-index", "closure"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_store_directory_restores_across_packages(tmp_path, writer, backend):
    """A checkpoint plus a WAL with a torn tail, written by either
    package, restores in the other to the same version and answers."""
    ref, port = _twins(backend, {}, updates=0)
    live = ref if writer == "reference" else port
    store = (ref_store.IndexStore if writer == "reference"
             else IndexStore)(tmp_path / "s")
    store.attach(live)
    _stream(live, 3)
    store.close()
    kept = _tear_last_record(tmp_path / "s")
    assert kept == 2
    if writer == "reference":
        restored = IndexStore(tmp_path / "s").restore(attach=False, **CPU)
    else:
        restored = ref_store.IndexStore(tmp_path / "s").restore(attach=False)
    assert restored.version == kept
    # both packages' live engines with the durable prefix applied
    ref2, port2 = _twins(backend, {}, updates=0)
    _stream(ref2, kept)
    _stream(port2, kept)
    if writer == "reference":
        assert_same_engine(ref2, restored)
        assert_same_engine(ref2, port2)
    else:
        assert_same_engine(restored, port2)
        assert_same_engine(ref2, port2)


def _crc_file(path) -> int:
    return zlib.crc32(open(path, "rb").read()) & 0xFFFFFFFF


@pytest.mark.parametrize("backend", ["hl-index", "closure"])
def test_loaded_engine_never_writes_its_checkpoint(tmp_path, backend):
    """C-watch-1: on ``device="cpu"`` the loaded arrays are read-only views
    into the file's pages; serving through a ``ReplicaGroup`` (snapshots
    derived, cloned, patched) and updating the engine must leave the file
    exactly as written, and torch must not warn about a non-writable
    array on the way."""
    eng = build_engine(_graph(), backend, **CPU)
    p = tmp_path / "x.hlidx"
    save_index(p, eng)
    crc = _crc_file(p)
    loaded = load_index(p, **CPU)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        group = port_api.ReplicaGroup(loaded, 2, start=False)
        us, vs = _queries(loaded.h, q=48)
        futs = [group.mr(int(u), int(v)) for u, v in zip(us, vs)]
        group.drain()
        first = [f.result(timeout=30) for f in futs]
        # a device structure built over the loaded graph lands its CSR
        # without sharing the file's pages either
        front = build_engine(loaded.h, "frontier", **CPU).mr_batch(us, vs)
        group.update(inserts=[[1, 2, 3]], deletes=[0])
        futs = [group.mr(int(u), int(v)) for u, v in zip(us, vs)]
        group.drain()
        second = [f.result(timeout=30) for f in futs]
        group.close()
    want = build_engine(_graph(), backend, **CPU)
    assert first == [int(x) for x in want.mr_batch(us, vs)]
    assert front.tolist() == first
    want.update(inserts=[[1, 2, 3]], deletes=[0])
    assert second == [int(x) for x in want.mr_batch(us, vs)]
    assert _crc_file(p) == crc


@pytest.mark.parametrize("backend,opts", CROSS, ids=CROSS_IDS)
def test_loaded_dtypes_equal_the_reference(tmp_path, backend, opts):
    """C-watch-3: CSR, rank, perm, labels and duals are int64 and W* is
    int32, loaded in either package from either package's file; answers
    are int32 arrays, and ``int`` / ``bool`` from the service."""
    ref, port = _twins(backend, opts)
    ref_store.save_index(tmp_path / "ref.hlidx", ref)
    a = load_index(tmp_path / "ref.hlidx", **CPU)
    b = ref_store.load_index(tmp_path / "ref.hlidx")
    for f in CSR_FIELDS:
        assert getattr(a.h, f).dtype == getattr(b.h, f).dtype == np.int64
    if backend == "closure":
        assert a.w_star.dtype == np.asarray(b.w_star).dtype == np.int32
    else:
        for f in ("rank", "perm"):
            assert getattr(a.idx, f).dtype == getattr(b.idx, f).dtype \
                == np.int64
        for f in ("labels_edge", "labels_rank", "labels_s", "dual_u",
                  "dual_s"):
            assert {x.dtype for x in getattr(a.idx, f)} <= {np.dtype(np.int64)}
    us, vs = _queries(a.h)
    got, want = a.mr_batch(us, vs), np.asarray(b.mr_batch(us, vs))
    assert got.dtype == want.dtype == np.int32
    assert a.s_reach_batch(us, vs, 2).dtype == np.bool_
    svc = ReachabilityService(a, start=False)
    f, g = svc.mr(int(us[0]), int(vs[0])), svc.s_reach(int(us[0]),
                                                        int(vs[0]), 1)
    svc.drain()
    assert type(f.result(timeout=30)) is int
    assert type(g.result(timeout=30)) is bool
    svc.close()


def test_mesh_is_refused_naming_a10(tmp_path):
    """Every restoring call takes a logical mesh (A10b, which this test
    once held to its refusal): an ``hl-index`` checkpoint loads through
    ``load_index`` / ``build_engine(restore=)`` / ``IndexStore.restore``
    onto the mesh's device, and ``ReachabilityService.restore`` keeps the
    resident snapshot on the mesh — all answering as the live engine."""
    live = build_engine(_graph(), "hl-index", **CPU)
    p = tmp_path / "x.hlidx"
    save_index(p, live)
    mesh = port_api.make_mesh((2, 2), ("data", "model"), device="cpu")
    us, vs = _queries(live.h)
    want = live.mr_batch(us, vs)
    for eng in (load_index(p, mesh=mesh), build_engine(restore=p, mesh=mesh)):
        assert eng.device.type == "cpu"
        assert np.array_equal(eng.mr_batch(us, vs), want)
    svc = ReachabilityService.restore(p, mesh=mesh, start=False)
    futs = [svc.mr(int(u), int(v)) for u, v in zip(us, vs)]
    svc.drain()
    assert [f.result(timeout=30) for f in futs] == [int(x) for x in want]
    assert svc._snap.mesh == mesh and svc._snap.ranks.shape[0] % 2 == 0
    svc.close()
    store = IndexStore(tmp_path / "s")
    store.checkpoint(build_engine(_graph(), "hl-index", **CPU))
    eng = store.restore(mesh=mesh)
    assert np.array_equal(eng.mr_batch(us, vs), want)
    store.close()


def test_sharded_engine_is_unsupported_by_name(tmp_path):
    """``sharded`` is storable now (it was refused by name until A10b);
    an engine outside the storable list is still refused by name, and the
    list the error gives names ``sharded``."""
    save_index(tmp_path / "x.hlidx", build_engine(_graph(), "sharded", **CPU))
    assert read_manifest(tmp_path / "x.hlidx")["backend"] == "sharded"

    class Elsewhere:                        # no serializable structure
        name = "elsewhere"
    with pytest.raises(StoreUnsupported, match="'sharded'"):
        save_index(tmp_path / "y.hlidx", Elsewhere())


def test_load_without_a_device_needs_cuda_or_an_explicit_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is legal here")
    p = tmp_path / "x.hlidx"
    save_index(p, build_engine(_graph(), "hl-index", **CPU))
    store = IndexStore(tmp_path / "s")
    store.checkpoint(build_engine(_graph(), "closure", **CPU))
    for call in (lambda: load_index(p), lambda: build_engine(restore=p),
                 lambda: store.restore(),
                 lambda: ReachabilityService.restore(tmp_path / "s",
                                                     start=False)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.gpu
def test_restored_service_serves_through_the_gather_kernel(tmp_path):
    from repro_torch.device import gpu_probe
    from repro_torch.kernels import label_join as lj
    probe = gpu_probe()
    if not probe["cuda"] or probe["nvcc"] is None:
        pytest.skip(f"needs an NVIDIA GPU and nvcc: {probe}")
    h = _graph()
    svc = serve(h, "hl-index", start=False)
    svc.checkpoint(IndexStore(tmp_path / "s"))
    svc.update(inserts=[[1, 2, 3]])
    svc2 = ReachabilityService.restore(tmp_path / "s", start=False,
                                       use_kernels=True)
    assert svc2.engine.device.type == "cuda"
    us, vs = _queries(svc.engine.h, q=64)
    before = lj.GATHER_LAUNCHES
    futs = [svc2.mr(int(u), int(v)) for u, v in zip(us, vs)]
    svc2.drain()
    torch.cuda.synchronize()
    assert lj.GATHER_LAUNCHES > before
    want = svc.engine.mr_batch(us, vs)
    assert [f.result(timeout=30) for f in futs] == [int(x) for x in want]
    svc.close(), svc2.close()
