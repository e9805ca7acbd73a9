"""Port parity on real ranks (``repro_torch.core.mesh.ProcessMesh``): four
gloo processes on the CPU, each holding one block, against the reference
on four host devices.

One world of four ranks (``tests/util_process_mesh.py``, ``file://`` init
under ``tmp_path``) runs every case of this module once and writes one
``.npz`` / ``.json`` a rank; the reference runs the same cases in a
subprocess with ``--xla_force_host_platform_device_count=4``.  The tests
then hold each rank's results to the reference's: the padded W* of
``sharded_maxmin_closure`` byte for byte on 1 x 4, 4 x 1 and 2 x 2 grids,
both schedules, full and one-round ladders, float32 and int32 (m = 25,
a multiple of no grid here); the threshold closure MR; the ``sharded``
engine's answers and reported sizes; ``compressed_allreduce`` at the
reference test's tolerance, its int8 codes equal.  The routes of A10d
items 1-3: ``build_sharded`` (labels, duals, stats), ``neighbor_csr(mesh=)``,
each rank's ``to_mesh`` block against the reference's shard on that
device, and the label- and closure-regime ``sharded`` engines and
``hl-index`` / ``hl-index-basic`` through a script of updates (answers,
labels, snapshots, W* blocks, dirty rows, refreshed rows), the guard
against ranks that pass different edits, ``regrid_block`` against the
block of the grown whole, and a rank whose share of a build fails making
every rank raise.  Tolerance 0 wherever the answers are integers."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch.core.distributed as dist
from repro_torch.api import random_hypergraph
from repro_torch.core import collectives as coll
from repro_torch.core.mesh import (LogicalMesh, ProcessMesh, make_mesh,
                                   make_process_mesh)

import util_process_mesh as u
from util_subproc import SRC

TESTS = os.path.dirname(os.path.abspath(__file__))
WORLD = 4
RANK_TIMEOUT_S = 240
REFERENCE_TIMEOUT_S = 300


def _start(args, out_dir, name, env):
    log = open(os.path.join(out_dir, f"{name}.log"), "w")
    proc = subprocess.Popen([sys.executable, *args], env=env, stdout=log,
                            stderr=subprocess.STDOUT, cwd=TESTS)
    return proc, log


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The reference and one world of four ranks, run side by side; each
    subprocess under its own time limit."""
    out = str(tmp_path_factory.mktemp("process_mesh"))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [SRC, TESTS, os.environ.get("PYTHONPATH", "")]))
    procs = {"reference": _start(
        ["-c", "import sys, util_process_mesh as u; "
               "u.run_reference(sys.argv[1])", out], out, "reference",
        dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4"))}
    for rank in range(WORLD):
        procs[f"rank{rank}"] = _start(
            [os.path.join(TESTS, "util_process_mesh.py"), str(rank),
             str(WORLD), os.path.join(out, "init"), out], out, f"rank{rank}",
            env)
    failed = {}
    try:
        for name, (proc, log) in procs.items():
            limit = (REFERENCE_TIMEOUT_S if name == "reference"
                     else RANK_TIMEOUT_S)
            try:
                rc = proc.wait(timeout=limit)
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                failed[name] = rc
    finally:
        for proc, log in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
            log.close()
    if failed:
        logs = {n: open(os.path.join(out, f"{n}.log")).read()[-3000:]
                for n in failed}
        pytest.fail(f"subprocesses failed: {failed}\n{logs}")

    def load(name):
        with open(os.path.join(out, f"{name}.json")) as f:
            return np.load(os.path.join(out, f"{name}.npz")), json.load(f)
    return {"reference": load("reference"),
            "ranks": [load(f"rank{r}") for r in range(WORLD)]}


def _block(whole, shape, coords):
    r, c = shape
    br, bc = whole.shape[-2] // r, whole.shape[-1] // c
    i, j = coords
    return whole[..., i * br:(i + 1) * br, j * bc:(j + 1) * bc]


def _coords(rank, shape):
    return tuple(int(x) for x in np.unravel_index(rank, shape))


def test_process_mesh_answers_what_a_logical_mesh_answers(worlds):
    for rank, (_, s) in enumerate(worlds["ranks"]):
        m = s["mesh"]
        assert m["rank"] == rank and m["coords"] == list(_coords(rank,
                                                                 (2, 2)))
        assert m["backend"] == "gloo" and m["device"] == "cpu"
        assert m["shape"] == {"data": 2, "model": 2}
        assert m["axis_names"] == ["data", "model"]
        assert m["devices"] == ["cpu"] * 4 and m["devices_shape"] == [2, 2]
        i, j = m["coords"]
        assert m["axis_ranks"] == {"data": [j, 2 + j],
                                   "model": [2 * i, 2 * i + 1]}
        assert m["equal_again"] and m["shape_is_read_only"]
        assert not m["equal_logical"] and not m["hash_logical"]
        assert not m["equal_other_shape"]


@pytest.mark.parametrize("case", u.CLOSURE_CASES,
                         ids=[u.closure_key(*c) for c in u.CLOSURE_CASES])
def test_closure_blocks_equal_the_reference(worlds, case):
    """Every rank's block is its block of the reference's padded W*, and
    ``gather_blocks`` assembles the whole of it on every rank."""
    shape, _, _, dtype = case
    key = u.closure_key(*case)
    ref_arrays, _ = worlds["reference"]
    want = ref_arrays[f"closure/{key}"]
    lcm = int(np.lcm(*shape))
    assert want.shape == (-(-25 // lcm) * lcm,) * 2
    assert want.dtype == np.dtype(dtype)
    for rank, (arrays, scalars) in enumerate(worlds["ranks"]):
        whole = arrays[f"closure/{key}/whole"]
        block = arrays[f"closure/{key}/block"]
        assert whole.dtype == want.dtype and whole.shape == want.shape
        assert whole.tobytes() == want.tobytes(), (key, rank)
        expect = _block(want, shape, _coords(rank, shape))
        assert block.shape == expect.shape
        assert block.tobytes() == np.ascontiguousarray(expect).tobytes()
        assert all(scalars["closure_input_kept"])


@pytest.mark.parametrize("schedule", ["allgather", "ring"])
def test_round_reads_its_panels_and_contracts_them(worlds, schedule):
    """One round on 2 x 2 ranks: the row panel gathered (and, under
    ``allgather``, the column panel), or the ring's two panels, each
    contraction on contiguous operands, and the result the logical
    round's block."""
    h = random_hypergraph(**u.CLOSURE_GRAPH)
    w = u.line_graph(h, "float32")
    logical = make_mesh((2, 2), u.AXES, device="cpu")
    want = dist.sharded_maxmin_round(logical, schedule=schedule)(
        dist.pad_for_mesh(torch.from_numpy(w), logical)).numpy()
    mp, b = want.shape[0], want.shape[0] // 2
    for rank, (arrays, scalars) in enumerate(worlds["ranks"]):
        got = scalars["round_reads"][schedule]
        if schedule == "allgather":
            assert got["reads"] == [["all-gather", [b, mp]],
                                    ["all-gather", [mp, b]]]
            assert got["calls"] == [[[b, mp], [mp, b], True]]
        else:
            assert got["reads"] == [["all-gather", [b, mp]]] + [
                ["collective-permute", [b, b]]] * 2
            assert got["calls"] == [[[b, b], [b, b], True]] * 2
        expect = _block(want, (2, 2), _coords(rank, (2, 2)))
        assert arrays[f"round/{schedule}"].tobytes() == \
            np.ascontiguousarray(expect).tobytes()


@pytest.mark.parametrize("case", u.THRESHOLD_CASES,
                         ids=[u.threshold_key(*c) for c in u.THRESHOLD_CASES])
def test_threshold_mr_equals_the_reference(worlds, case):
    grid, _, _ = case
    key = u.threshold_key(*case)
    ref_arrays, _ = worlds["reference"]
    want = ref_arrays[f"threshold/{key}"]
    counts = dict(zip([u.threshold_key(*c) for c in u.THRESHOLD_CASES],
                      ref_arrays["threshold_counts"]))
    if grid[0] == 2:
        assert counts[key] % 2 == 1      # the pod axis pads the batch
    m = want.shape[0]
    for rank, (arrays, _) in enumerate(worlds["ranks"]):
        whole = arrays[f"threshold/{key}/whole"]
        assert whole.dtype == np.float32
        assert whole[:m, :m].tobytes() == want.tobytes(), (key, rank)
        assert not whole[m:].any() and not whole[:, m:].any()
        coords = _coords(rank, grid)[1:]
        expect = _block(whole, grid[1:], coords)
        assert arrays[f"threshold/{key}/block"].tobytes() == \
            np.ascontiguousarray(expect).tobytes()


@pytest.mark.parametrize("case", u.ENGINE_CASES,
                         ids=[u.engine_key(*c) for c in u.ENGINE_CASES])
def test_engine_on_ranks_answers_as_the_reference(worlds, case):
    """``build_engine(h, "sharded", mesh=pm, use_kernels=True)``: every
    rank answers every pair, equal to the reference's ``sharded`` engine
    on four host devices."""
    key = u.engine_key(*case)
    ref_arrays, ref = worlds["reference"]
    for rank, (arrays, scalars) in enumerate(worlds["ranks"]):
        got = arrays[f"engine/{key}/mr_batch"]
        want = ref_arrays[f"engine/{key}/mr_batch"]
        assert got.dtype == want.dtype == np.int64
        assert np.array_equal(got, want), (key, rank)
        for s in u.S_VALUES:
            g = arrays[f"engine/{key}/s_reach_batch/{s}"]
            w = ref_arrays[f"engine/{key}/s_reach_batch/{s}"]
            assert g.dtype == w.dtype and np.array_equal(g, w)
        info, want_info = scalars["engines"][key], ref["engines"][key]
        assert info["mr"] == want_info["mr"]
        assert info["s_reach"] == want_info["s_reach"]


@pytest.mark.parametrize("case", u.ENGINE_CASES,
                         ids=[u.engine_key(*c) for c in u.ENGINE_CASES])
def test_engine_on_ranks_reports_what_the_reference_reports(worlds, case):
    """Neither package's engine has a ``stats()``; what both report —
    the planner's choice, the padded size, ``nbytes()`` built and served
    (W* counted whole), the snapshot's geometry, bytes and label rows,
    the refreshed rows, W* freed once served — is equal."""
    key = u.engine_key(*case)
    ref_arrays, ref = worlds["reference"]
    want = ref["engines"][key]
    fields = ("name", "plan", "m_padded", "nbytes_built", "version",
              "snapshot_shape", "snapshot_nbytes", "refresh_rows",
              "w_star_freed", "nbytes_served", "mr_dtype")
    for rank, (arrays, scalars) in enumerate(worlds["ranks"]):
        info = scalars["engines"][key]
        assert {f: info[f] for f in fields} == {f: want[f] for f in fields}
        assert info["plan"] == "sharded"
        svals = arrays[f"engine/{key}/svals"]
        ref_svals = ref_arrays[f"engine/{key}/svals"]
        assert svals.dtype == ref_svals.dtype
        assert svals.tobytes() == ref_svals.tobytes()
        assert info["snapshot_on"].startswith("ProcessMesh(")


@pytest.mark.parametrize("case", u.ENGINE_CASES,
                         ids=[u.engine_key(*c) for c in u.ENGINE_CASES])
def test_each_rank_holds_only_its_block(worlds, case):
    """The resident W* of a rank is its [mp/r, mp/c] block of the padded
    closure (mp²/(r·c) float32 entries), equal to that block of a
    logical build; ``rank_nbytes`` counts it, ``nbytes`` the whole."""
    shape, schedule = case
    key = u.engine_key(*case)
    h = random_hypergraph(**u.ENGINE_GRAPH)
    logical = dist.ShardedEngine.build(
        h, mesh=make_mesh(shape, u.AXES, device="cpu"), schedule=schedule)
    whole = logical._w_star.numpy()
    mp = whole.shape[0]
    r, c = shape
    for rank, (arrays, scalars) in enumerate(worlds["ranks"]):
        info = scalars["engines"][key]
        assert info["m_padded"] == mp
        assert info["block_shape"] == [mp // r, mp // c]
        assert info["block_numel"] == mp * mp // (r * c)
        assert info["rank_nbytes_built"] == 4 * mp * mp // (r * c)
        assert info["nbytes_built"] == 4 * mp * mp
        assert info["rank_nbytes_served"] == info["snapshot_nbytes"]
        block = arrays[f"engine/{key}/block"]
        expect = _block(whole, shape, _coords(rank, shape))
        assert block.dtype == np.float32
        assert block.tobytes() == np.ascontiguousarray(expect).tobytes()


@pytest.mark.parametrize("leaf", ["a", "b"])
def test_compressed_allreduce_on_ranks_equals_the_reference(worlds, leaf):
    """Each rank's gradient is its slice of the reference test's tree:
    every rank gets the same mean, within the reference test's int8
    bound of the plain mean and at 1e-6 of the reference's shard_map
    output, bit-equal to the one-process port on the stacked slices;
    the int8 codes and scales on the wire equal the reference's."""
    tree = u.compression_tree()
    ref_arrays, _ = worlds["reference"]
    x = tree[leaf]
    mean = np.mean(x, axis=0)
    ref_out = ref_arrays[f"compression/{leaf}"]
    for rank, (arrays, _) in enumerate(worlds["ranks"]):
        got = arrays[f"compression/{leaf}"]
        assert got.shape == mean.shape and got.dtype == np.float32
        assert np.abs(got - mean).max() < np.abs(x).max() / 127 + 1e-6
        np.testing.assert_allclose(got, ref_out, rtol=1e-6, atol=1e-6)
        assert got.tobytes() == \
            arrays[f"compression/{leaf}/one_process"].tobytes()
        codes = arrays[f"compression/{leaf}/codes"]
        assert codes.dtype == np.int8
        assert np.array_equal(codes, ref_arrays[f"compression/{leaf}/codes"])
        np.testing.assert_array_equal(
            arrays[f"compression/{leaf}/scales"],
            ref_arrays[f"compression/{leaf}/scales"])


_VALUE_ERRORS = {"world_size": "6 blocks", "trim": "trim=False"}


@pytest.mark.parametrize("name", u.ERROR_NAMES)
def test_routes_not_on_ranks_raise(worlds, name):
    """The routes that do not run on ranks yet (serving, replicas, the
    store, a write-ahead log or ``IndexStore`` attached to an engine on
    ranks) raise ``NotImplementedError`` naming ROADMAP A10d (nothing
    stands in for them); a wrong world size and ``trim=True`` raise
    ``ValueError``.  The refused calls leave the engine and the store
    as they were."""
    for _, scalars in worlds["ranks"]:
        kind, message = scalars["errors"][name]
        if name in _VALUE_ERRORS:
            assert kind == "ValueError" and _VALUE_ERRORS[name] in message
        else:
            assert kind == "NotImplementedError", (name, kind, message)
            assert "A10d" in message
        assert scalars["update_left_engine"] == {
            "version": 0, "m": u.ENGINE_GRAPH["m"]}
        assert scalars["store_left_nothing"]


def _same_index(arrays, want, prefix):
    """Every array of ``index_arrays`` equal, dtype and bytes."""
    keys = sorted(k for k in want.files if k.startswith(prefix + "/"))
    assert keys
    for k in keys:
        got, exp = arrays[k], want[k]
        assert got.dtype == exp.dtype and got.shape == exp.shape, k
        assert got.tobytes() == exp.tobytes(), k


@pytest.mark.parametrize("case", u.BUILD_CASES,
                         ids=[u.build_key(*c) for c in u.BUILD_CASES])
def test_build_sharded_on_ranks_equals_the_reference(worlds, case):
    """``build_sharded(h, mesh=pm)`` across four ranks: every rank holds
    the reference's labels, duals, ranks and stats (``shards``,
    ``components``, ``pool_fallback`` included), row by row and dtype by
    dtype, with 1, 3 and 8 shards, with and without the minimiser, on a
    graph of one component and on one with no hyperedge."""
    key = u.build_key(*case)
    ref_arrays, ref = worlds["reference"]
    want = ref["builds"][key]
    for rank, (arrays, scalars) in enumerate(worlds["ranks"]):
        _same_index(arrays, ref_arrays, f"build/{key}")
        assert scalars["builds"][key] == want, (key, rank)
    if case[3] == "parts":
        # several shards, so several ranks built and exchanged shards
        assert want["components"] == 6.0
        assert want["shards"] == min(case[1] or 4, 6)
    if case[3] == "chain":
        assert want["components"] == 1.0
    if case[3] == "empty":
        assert want["shards"] == 0.0


@pytest.mark.parametrize("case", u.NBR_CASES,
                         ids=[f"{s[0]}x{s[1]}-{g}" for s, g in u.NBR_CASES])
def test_neighbor_csr_on_ranks_equals_the_reference(worlds, case):
    """The rank overlap route (a row block of W a rank, one ragged
    all-gather): ``ptr`` / ``idx`` / ``od`` equal to the reference's mesh
    route and to the host pass, with m a multiple of no world size and
    with m smaller than the world."""
    from repro_torch.core.hypergraph import neighbor_csr
    shape, g = case
    key = f"nbr/{shape[0]}x{shape[1]}-{g}"
    ref_arrays, _ = worlds["reference"]
    host = neighbor_csr(random_hypergraph(**u.NBR_GRAPHS[g]))
    for arrays, _ in worlds["ranks"]:
        for f in ("ptr", "idx", "od"):
            got, want = arrays[f"{key}/{f}"], ref_arrays[f"{key}/{f}"]
            assert got.dtype == want.dtype == np.int64
            assert got.tobytes() == want.tobytes(), (key, f)
            assert got.tobytes() == getattr(host, f).tobytes()


@pytest.mark.parametrize("shape", u.MESH_SHAPES,
                         ids=[f"{r}x{c}" for r, c in u.MESH_SHAPES])
@pytest.mark.parametrize("tag", ["full", "dirty"])
def test_to_mesh_block_is_the_reference_shard(worlds, shape, tag):
    """Each rank's ``to_mesh`` block is the reference's addressable
    shard on the device at the same mesh coordinates, whole and after
    the incremental re-land of the dirty rows; the incremental block
    equals a whole re-land, its base is left as it was unless donated,
    and ``nbytes`` counts the whole as the reference's does."""
    key = f"{shape[0]}x{shape[1]}"
    ref_arrays, ref = worlds["reference"]
    for rank, (arrays, scalars) in enumerate(worlds["ranks"]):
        at = "_".join(map(str, _coords(rank, shape)))
        for f in ("ranks", "svals", "lengths"):
            got = arrays[f"to_mesh/{key}/{tag}/{f}"]
            want = ref_arrays[f"to_mesh/{key}/{tag}/{f}/{at}"]
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes(), (key, tag, f, rank)
        info = scalars["to_mesh"][key]
        assert info["whole_shape"] == ref["to_mesh"][key]["shape"]
        assert info["nbytes"] == ref["to_mesh"][key]["nbytes"]
        assert info["block"] and info["on"].startswith("ProcessMesh(")
        assert info["geometry_kept"] and info["base_kept"]
        assert info["dirty_equals_whole"] and info["donated_equals_whole"]
        assert info["donated_in_place"]
        block = arrays[f"to_mesh/{key}/{tag}/ranks"]
        assert info["rank_nbytes"] == 8 * block.size + 4 * block.shape[0]


def _padded_block(whole, shape, coords, fill):
    """The block of ``whole`` padded with ``fill`` up to the grid."""
    r, c = shape
    n, l = whole.shape
    padded = np.full((-(-n // r) * r, -(-l // c) * c), fill, whole.dtype)
    padded[:n, :l] = whole
    return np.ascontiguousarray(_block(padded, shape, coords))


@pytest.mark.parametrize("case", u.ENGINE_SCRIPT_CASES,
                         ids=[u.script_key(*c)
                              for c in u.ENGINE_SCRIPT_CASES])
def test_engine_updates_on_ranks_equal_the_reference(worlds, case):
    """The update script (insert, delete, n growing, slot padding
    growing, a whole-graph scope, delete everything, insert again) on
    every rank: after each step the version, graph, dirty rows, answers
    (batch, scalar, s-reach; int64 / bool), refreshed rows, ``nbytes``,
    labels, duals and index stats, and the snapshot (a label block: the
    block of the reference's snapshot; otherwise the whole) equal the
    reference's; a resident closure's W* block is its block of the
    reference's padded W*, with the same padded size and slot map."""
    kind, shape, _ = case
    key = u.script_key(*case)
    ref_arrays, ref = worlds["reference"]
    want_steps = ref["scripts"][key]["steps"]
    sentinel = np.iinfo(np.int32).max
    for rank, (arrays, scalars) in enumerate(worlds["ranks"]):
        coords = _coords(rank, shape)
        got = scalars["scripts"][key]
        assert got["rank_mesh"].startswith("ProcessMesh(")
        for i, (step, want) in enumerate(zip(got["steps"], want_steps)):
            tag = f"script/{key}/{i}"
            common = ("name", "version", "n", "m", "dirty")
            assert {f: step[f] for f in common} == \
                {f: want[f] for f in common}, (key, i, rank)
            if kind == "resident":
                whole = ref_arrays[f"{tag}/whole"]
                assert step["m_padded"] == want["m_padded"]
                assert step["slot_of"] == want["slot_of"]
                assert arrays[f"{tag}/whole"].tobytes() == whole.tobytes()
                assert arrays[f"{tag}/block"].dtype == np.float32
                assert arrays[f"{tag}/block"].tobytes() == \
                    np.ascontiguousarray(_block(whole, shape,
                                                coords)).tobytes()
                continue
            for f in ("mr", "s2"):
                g, w = arrays[f"{tag}/{f}"], ref_arrays[f"{tag}/{f}"]
                assert g.dtype == w.dtype and np.array_equal(g, w), (key, i)
            for f in ("refresh", "nbytes", "snapshot_shape", "mr",
                      "s_reach"):
                assert step[f] == want[f], (key, i, f, rank)
            assert step["block"] == (kind == "labels"
                                     and step["snapshot_shape"][1] > 0)
            for f, fill in (("ranks", sentinel), ("svals", 0)):
                g, w = arrays[f"{tag}/snap/{f}"], ref_arrays[f"{tag}/snap/{f}"]
                if step["block"]:
                    w = _padded_block(w, shape, coords, fill)
                assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), \
                    (key, i, f, rank)
            if "stats" in want:
                assert step["stats"] == want["stats"]
                _same_index(arrays, ref_arrays, f"{tag}/idx")
        if kind == "resident":
            g = arrays[f"script/{key}/final_mr"]
            w = ref_arrays[f"script/{key}/final_mr"]
            assert g.dtype == w.dtype and np.array_equal(g, w)
    if kind == "resident":
        # the slot padding grew while W* was resident: the blocks were
        # gathered and re-split
        assert any(s["regrid_bytes"] for s in
                   worlds["ranks"][0][1]["scripts"][key]["steps"])


@pytest.mark.parametrize("kind", ["labels", "closure", "hl-index"])
def test_ranks_that_pass_different_edits_all_raise(worlds, kind):
    """Rank 0 passes other edits than the rest: every rank raises
    ``ValueError`` before anything changes (version, graph, dirty rows),
    and the next update that all agree on applies everywhere alike.  An
    id out of range raises ``IndexError`` on every rank, through the
    engine and through its snapshot (a label block too), before any
    collective (C-watch-7), and the ranks go on."""
    answers = []
    for _, scalars in worlds["ranks"]:
        g = scalars["guard"][kind]
        assert g["out_of_range"] == ["IndexError", "IndexError"]
        assert g["error"][0] == "ValueError"
        assert "different edits" in g["error"][1]
        assert g["left"] == {"version": 0, "m": u.UPDATE_GRAPH["m"],
                             "dirty": []}
        assert g["agreed"] == {"version": 1, "m": u.UPDATE_GRAPH["m"] + 1}
        answers.append(g["mr"])
    assert all(a == answers[0] for a in answers)


def _span(lo_a, hi_a, lo_b, hi_b):
    return max(0, min(hi_a, hi_b) - max(lo_a, lo_b))


@pytest.mark.parametrize("case", u.REGRID_CASES,
                         ids=[u.regrid_key(*c) for c in u.REGRID_CASES])
def test_regrid_block_is_the_block_of_the_grown_whole(worlds, case):
    """``regrid_block`` grows W*'s slot padding by one step of the lcm
    and to sizes whose new blocks span several old ones: each rank's new
    block equals its block of the zero-padded whole, and it received
    exactly the part of its new block that lies inside the old padded
    W* and outside its own old block."""
    shape, mp = case
    key = u.regrid_key(shape, mp)
    whole = u.regrid_whole(mp)
    r, c = shape
    lcm = int(np.lcm(r, c))
    omp = -(-u.REGRID_M // lcm) * lcm
    obr, obc, nbr, nbc = omp // r, omp // c, mp // r, mp // c
    for rank, (arrays, scalars) in enumerate(worlds["ranks"]):
        i, j = _coords(rank, shape)
        got = arrays[f"regrid/{key}"]
        want = np.ascontiguousarray(_block(whole, shape, (i, j)))
        assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
        inside = (_span(i * nbr, (i + 1) * nbr, 0, omp)
                  * _span(j * nbc, (j + 1) * nbc, 0, omp))
        own = (_span(i * nbr, (i + 1) * nbr, i * obr, (i + 1) * obr)
               * _span(j * nbc, (j + 1) * nbc, j * obc, (j + 1) * obc))
        assert scalars["regrid_bytes"][key] == 4 * (inside - own), rank


@pytest.mark.parametrize("route", ["build_sharded", "neighbor_csr"])
def test_a_rank_that_fails_makes_every_rank_raise(worlds, route):
    """One rank's share fails (a shard's builder raises; the overlap rows
    run out of memory): it still joins the exchange, every rank raises
    ``RuntimeError`` naming that rank and its error, none is left
    waiting, and the ranks then build together again, alike."""
    from repro_torch import api
    from repro_torch.core.hlindex import build_fast
    want = [a.tolist()
            for a in build_fast(u._port_graph(api, "parts")).labels_edge]
    cause = {"build_sharded": "ValueError: planted shard failure",
             "neighbor_csr": "MemoryError: planted"}[route]
    for _, scalars in worlds["ranks"]:
        kind, msg = scalars["failures"]["errors"][route]
        assert kind == "RuntimeError"
        assert msg.startswith(f"{route} on ranks: rank {u.FAILING_RANK} "
                              f"failed ({cause}")
        assert msg.count("failed") == 1
        assert scalars["failures"]["after"] == want


def test_a_process_mesh_needs_an_initialised_group():
    """No default process group: both constructors raise, and neither
    starts one."""
    import torch.distributed as tdist
    assert not tdist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_process_mesh((1, 1), u.AXES, device="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_process_mesh((1, 1), u.AXES)
    with pytest.raises(RuntimeError, match="init_process_group"):
        ProcessMesh((1, 1), u.AXES, torch.device("cpu"))
    assert not tdist.is_initialized()


def test_an_axis_of_size_one_is_the_identity():
    """On an axis of size 1 each collective hands its input back and
    calls nothing (no process group exists here)."""
    mesh = make_mesh((1, 2), u.AXES, device="cpu")
    assert isinstance(mesh, LogicalMesh)
    t = torch.arange(6.0).reshape(2, 3)
    assert coll.all_gather_panel(t, mesh, "data", 0) is t
    assert coll.ring_shift(t, mesh, "data") is t
    assert coll.all_reduce_max(t, mesh, "data") is t
