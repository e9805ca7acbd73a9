"""Port parity, crash recovery under fire: mirrors
``tests/test_crash_recovery.py`` with a child process that serves the
port (``device="cpu"``) and is SIGKILLed mid-update-stream.  The store it
leaves behind is then restored by the port *and* by the reference, and
both must answer byte-identically to an uninterrupted oracle of their
own package — the store's files are one format for both.

The child serves a deterministic update stream (batches are computed by
the parent and passed as JSON, so the oracle replays exactly the same
edits).  A torn final WAL record — the state a kill mid-append
legitimately leaves — must be detected by checksum and dropped, never
crash the replay.
"""
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

import repro.api as ref_api
import repro.store as ref_store
import repro_torch.api as port_api
from repro_torch.serve.reach_service import ReachabilityService
from repro_torch.store import IndexStore, scan_wal

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

N, M, SEED = 36, 48, 5
KILL_AFTER = 5          # acknowledged updates before the SIGKILL lands
PACKAGES = {"port": port_api, "reference": ref_api}

_CHILD = """
import json, sys
from repro_torch.api import random_hypergraph, serve
from repro_torch.store import IndexStore

store_dir = sys.argv[1]
batches = json.loads(sys.argv[2])
h = random_hypergraph({n}, {m}, seed={seed})
svc = serve(h, "hl-index", start=False, device="cpu")
store = IndexStore(store_dir)
svc.checkpoint(store)
print("READY", flush=True)
for k, (ins, dels) in enumerate(batches):
    svc.update(inserts=ins, deletes=dels)
    print("APPLIED", k + 1, flush=True)
sys.exit(3)   # the stream must be long enough that we never get here
""".format(n=N, m=M, seed=SEED)


def _make_batches(count, seed=11):
    """Deterministic update stream; batch k becomes engine version k+1.
    Deletes track the evolving edge count so every batch is valid
    whenever it is (re)applied in sequence."""
    rng = np.random.default_rng(seed)
    m = M
    batches = []
    for k in range(count):
        ins = [sorted(int(x) for x in rng.choice(N, 3, replace=False))]
        dels = [int(rng.integers(0, m))] if k % 3 == 2 else []
        m += len(ins) - len(dels)
        batches.append((ins, dels))
    return batches


def _oracle(batches, upto, package="port"):
    """The uninterrupted reference: fresh build + the first ``upto``
    batches applied live, in ``package``."""
    api = PACKAGES[package]
    opts = {"device": "cpu"} if package == "port" else {}
    eng = api.build_engine(api.random_hypergraph(N, M, seed=SEED),
                           "hl-index", **opts)
    for ins, dels in batches[:upto]:
        eng.update(inserts=ins, deletes=dels)
    return eng


def _restore(package, store_dir, **opts):
    if package == "port":
        return port_api.build_engine(restore=store_dir, device="cpu", **opts)
    return ref_api.build_engine(restore=store_dir, **opts)


def _queries(n, q=64, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, q), rng.integers(0, n, q)


def _answers(eng, seed=0):
    us, vs = _queries(eng.h.n, seed=seed)
    return np.asarray(eng.mr_batch(us, vs))


@pytest.fixture(scope="module")
def killed_store(tmp_path_factory):
    """Run the serving child and SIGKILL it mid-stream; returns the
    store directory and the batch list it was streaming."""
    store_dir = str(tmp_path_factory.mktemp("crash") / "store")
    batches = _make_batches(400)     # far more than ever get applied
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-c", _CHILD, store_dir, json.dumps(batches)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        applied = 0
        for line in proc.stdout:
            if line.startswith("APPLIED"):
                applied = int(line.split()[1])
                if applied >= KILL_AFTER:
                    proc.kill()          # SIGKILL: no atexit, no flush
                    break
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    assert proc.returncode == -signal.SIGKILL, (
        f"child exited {proc.returncode} (stream too short?): "
        f"{proc.stderr.read()}")
    assert applied >= KILL_AFTER
    return store_dir, batches, applied


@pytest.mark.parametrize("package", ["port", "reference"])
def test_restart_matches_uninterrupted_oracle(killed_store, package):
    store_dir, batches, applied = killed_store
    # attach=False: the resumed updates below are an in-memory
    # comparison against the oracle, not a continuation of the journal
    # (other tests re-read this store)
    eng = _restore(package, store_dir, attach=False)
    # every acknowledged update was fsynced before it applied, so the
    # durable lineage is at least the acknowledged prefix; at most one
    # journaled-but-unacknowledged record may follow it
    assert applied <= eng.version <= applied + 1
    for oracle_pkg in PACKAGES:
        oracle = _oracle(batches, eng.version, oracle_pkg)
        assert np.array_equal(_answers(eng), _answers(oracle))
    oracle = _oracle(batches, eng.version, package)
    # resume the stream on both: byte-identical answers continue
    for ins, dels in batches[eng.version:eng.version + 3]:
        eng.update(inserts=ins, deletes=dels)
        oracle.update(inserts=ins, deletes=dels)
    assert np.array_equal(_answers(eng, seed=1), _answers(oracle, seed=1))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_restart_through_service_layer(killed_store, use_kernels):
    store_dir, batches, _ = killed_store
    svc = ReachabilityService.restore(store_dir, start=False, device="cpu",
                                      use_kernels=use_kernels)
    oracle = _oracle(batches, svc.engine.version, "reference")
    us, vs = _queries(svc.engine.h.n)
    futs = [svc.mr(int(u), int(v)) for u, v in zip(us, vs)]
    svc.drain()
    assert [f.result(timeout=30) for f in futs] == \
        [int(x) for x in oracle.mr_batch(us, vs)]
    svc.close()


def test_torn_final_record_dropped_not_fatal(killed_store):
    store_dir, batches, _ = killed_store
    wal_path = next(p for p in sorted(os.listdir(store_dir))
                    if p.startswith("wal-"))
    wal_path = os.path.join(store_dir, wal_path)
    records, valid, _ = scan_wal(wal_path)
    assert records, "kill landed before any update was journaled?"
    # tear the final record the way a crash mid-append does
    with open(wal_path, "r+b") as f:
        f.truncate(valid - 3)
    recs2, _, status = scan_wal(wal_path)
    assert status != "ok" and len(recs2) == len(records) - 1
    # the reference replays the torn log first (attach=False leaves the
    # torn bytes for the port's restore to drop for good)
    ref_eng = ref_store.IndexStore(store_dir).restore(attach=False)
    eng = port_api.build_engine(restore=store_dir, device="cpu")
    assert eng.version == ref_eng.version == len(recs2)
    assert scan_wal(wal_path)[2] == "ok"      # the torn tail is gone
    for package in PACKAGES:
        oracle = _oracle(batches, eng.version, package)
        assert np.array_equal(_answers(eng), _answers(oracle))
        assert np.array_equal(_answers(ref_eng), _answers(oracle))


def test_empty_wal_restore_is_pure_load(killed_store):
    """With no journaled suffix the restart is exactly checkpoint
    page-in: the restored labels are views into the file mmap — the
    'no full rebuild' claim in its purest form."""
    store_dir, batches, _ = killed_store
    wal_path = next(p for p in sorted(os.listdir(store_dir))
                    if p.startswith("wal-"))
    with open(os.path.join(store_dir, wal_path), "r+b") as f:
        f.truncate(0)
    eng = IndexStore(store_dir).restore(attach=False, device="cpu")
    assert eng.version == 0

    def memmap_backed(a):
        while a is not None:
            if isinstance(a, np.memmap):
                return True
            a = a.base
        return False

    assert memmap_backed(eng.idx.rank)
    assert all(memmap_backed(eng.idx.labels_s[u]) for u in range(eng.h.n))
    for package in PACKAGES:
        assert np.array_equal(_answers(eng),
                              _answers(_oracle(batches, 0, package)))
