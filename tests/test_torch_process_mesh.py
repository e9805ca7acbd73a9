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
every rank raise.  Items 2 and 4 (serving and the store on ranks): rank 0
leads and ranks 1-3 ``follow()`` a service over the label- and
closure-regime ``sharded`` engines, ``hl-index`` built on ranks (with and
without ``mesh=pm``) and a one-process engine given ``mesh=pm``, through
every request kind and scoped updates, answers and ``stats()`` equal to
the reference's mesh service and the followers' dispatch-side counts
equal to the leader's; ``ReplicaGroup`` copies; a threaded leader idling
across keep-alives; a batch failing on one rank, follower requests and
ids past ``n`` refused; ``save_index`` of every payload written by rank 0
alone, byte-equal to the reference's file, and loaded on the ranks block
for block; the ``IndexStore`` and its log, a failed append, and a
service's checkpoint and restore.  The stream's header and payload
codecs are tested without a spawn.  Tolerance 0 wherever the answers are
integers."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch.core.distributed as dist
import repro_torch.serve.rank_stream as rs
from repro_torch import api as port_api
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
    return {"reference": load("reference"), "out": out,
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
    """The mesh's limits: a wrong world size and ``trim=True`` raise
    ``ValueError`` on every rank, and leave the engine as it was.  Every
    other route runs on ranks."""
    for _, scalars in worlds["ranks"]:
        kind, message = scalars["errors"][name]
        assert kind == "ValueError" and _VALUE_ERRORS[name] in message
        assert scalars["update_left_engine"] == {
            "version": 0, "m": u.ENGINE_GRAPH["m"]}


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


# ---------------------------------------------------------------------------
# serving on ranks (A10d item 2)
# ---------------------------------------------------------------------------

_SERVE_IDS = [u.serve_key(*c) for c in u.SERVE_CASES]
_ADMISSION_FIELDS = ("submitted", "expired", "tenant_submitted",
                     "tenant_answered", "tenant_expired")


def _without_kernel_batches(stats, kernels=True):
    """``stats`` less ``kernel_batches``, checked first: the port's
    kernel route answers every padded mr / s_reach batch, the reference
    serves without kernels."""
    stats = dict(stats)
    kernel = stats.pop("kernel_batches")
    assert kernel == (sum(stats["bucket_histogram"].values()) if kernels
                      else 0)
    return stats


@pytest.mark.parametrize("case", u.SERVE_CASES, ids=_SERVE_IDS)
def test_rank_service_answers_and_stats_equal_the_reference(worlds, case):
    """The leader (rank 0) of a service on ranks, fed every request kind
    over two tenants across three updates sent through it: its answers
    (value and type), its first drains' counts and ``stats()`` field by
    field equal the reference's mesh service on four host devices; a
    label block (or the closure snapshot) already on the mesh is served
    as it is, a whole snapshot is landed as blocks where ``mesh=pm``."""
    kind, _, with_mesh = case
    key = u.serve_key(*case)
    _, ref = worlds["reference"]
    want = ref["serving"][key]
    got = worlds["ranks"][0][1]["serving"][key]
    assert got["leader"] and got["result"] == want["result"]
    assert _without_kernel_batches(got["stats"]) == \
        _without_kernel_batches(want["stats"], False)
    assert got["stats"]["updates"] == 3 and got["failed_events"] == 0
    on_ranks = with_mesh or kind in ("labels", "closure")
    assert got["on_mesh"].startswith("ProcessMesh(") == on_ranks
    assert got["block"] == (with_mesh and kind != "closure")
    if kind in ("labels", "closure"):
        assert got["stats"]["mesh_rows_patched"] == 0
    elif with_mesh:
        assert got["stats"]["mesh_rows_patched"] > 0


@pytest.mark.parametrize("case", u.SERVE_CASES, ids=_SERVE_IDS)
def test_followers_count_what_the_leader_counts(worlds, case):
    """Every follower served the leader's stream to its close: the same
    events, every dispatch-side field of ``stats()`` equal to the
    leader's, the admission-side ones zero and empty, no answers kept."""
    key = u.serve_key(*case)
    lead = worlds["ranks"][0][1]["serving"][key]
    for rank, (_, scalars) in enumerate(worlds["ranks"][1:], start=1):
        got = scalars["serving"][key]
        assert not got["leader"] and got["result"] is None
        assert got["events"] == lead["events"] and got["seq"] == lead["seq"]
        assert got["events"]["close"] == 1 and got["failed_events"] == 0
        for f in u.DISPATCH_FIELDS:
            assert got["stats"][f] == lead["stats"][f], (key, rank, f)
        for f in _ADMISSION_FIELDS:
            assert not got["stats"][f], (key, rank, f)
        assert lead["stats"]["submitted"] == lead["stats"]["answered"]


def _cut(whole, field, shape, coords, fill):
    """The block at ``coords`` of ``whole`` padded to the grid (a
    ``lengths`` vector by rows only)."""
    if whole.ndim == 1:
        r = shape[0]
        padded = np.zeros(-(-whole.size // r) * r, whole.dtype)
        padded[:whole.size] = whole
        br = padded.size // r
        return padded[coords[0] * br:(coords[0] + 1) * br]
    return _padded_block(whole, shape, coords, fill)


_FILLS = {"ranks": np.iinfo(np.int32).max, "svals": 0, "lengths": 0}


@pytest.mark.parametrize("kind", u.REPLICA_CASES)
def test_replica_group_on_ranks_equals_the_reference(worlds, kind):
    """Three replicas on 2 x 2 through the serving churn: answers,
    ``replica_stats()`` and ``stats()`` (``mesh_rows_patched`` included)
    equal the reference's on every rank; each rank's replica blocks are
    byte-equal to each other and to the reference's replica shard on
    that device, and none aliases the engine's snapshot or another
    replica (C-watch-1)."""
    ref_arrays, ref = worlds["reference"]
    want = ref["replicas"][kind]
    lead = worlds["ranks"][0][1]["replicas"][kind]
    assert lead["result"] == want["result"]
    assert _without_kernel_batches(lead["stats"]) == \
        _without_kernel_batches(want["stats"], False)
    assert lead["stats"]["mesh_rows_patched"] > 0
    for rank, (arrays, scalars) in enumerate(worlds["ranks"]):
        got = scalars["replicas"][kind]
        assert got["replica_stats"] == want["replica_stats"], rank
        assert got["private"] and got["mesh"].startswith("ProcessMesh(")
        coords = _coords(rank, (2, 2))
        for f, fill in _FILLS.items():
            first = arrays[f"replicas/{kind}/0/{f}"]
            for i in range(u.REPLICAS):
                block = arrays[f"replicas/{kind}/{i}/{f}"]
                assert block.tobytes() == first.tobytes(), (rank, i, f)
                expect = _cut(ref_arrays[f"replicas/{kind}/{i}/{f}"], f,
                              (2, 2), coords, fill)
                assert block.dtype == expect.dtype
                assert block.tobytes() == expect.tobytes(), (rank, i, f)


def test_threaded_leader_answers_as_the_synchronous_run(worlds):
    """A threaded leader (``start=True``) over the labels 2 x 2 engine
    answers the synchronous run's requests alike across the same
    updates; idle for several keep-alive intervals it sends keep-alives
    that every follower receives (none times out), then answers again."""
    lead = worlds["ranks"][0][1]["threaded"]
    sync = worlds["ranks"][0][1]["serving"][u.serve_key("labels", (2, 2),
                                                        True)]
    got = lead["result"]
    assert got["rounds"] == [r["answers"] for r in sync["result"]]
    assert got["after_idle"] == got["host_mr"]
    assert got["keepalives_while_idle"] >= 3
    for _, scalars in worlds["ranks"][1:]:
        assert scalars["threaded"]["events"] == lead["events"]
        assert scalars["threaded"]["failed_events"] == 0


def test_the_keepalive_interval_is_a_quarter_of_the_group_timeout(worlds):
    """Every rank's service read the world's process-group timeout
    (``WORLD_TIMEOUT_S``, given to ``init_process_group``) from the
    group and keeps alive at a quarter of it."""
    for _, scalars in worlds["ranks"]:
        assert scalars["threaded"]["keepalive_read"] == \
            u.WORLD_TIMEOUT_S / 4


def test_a_closed_leader_refuses_and_sends_nothing(worlds):
    """A request that lands while ``close()`` drains, and requests and
    updates after it, raise ``RuntimeError`` instead of queueing for a
    batch no follower would receive; a batch dispatched after the close
    fails its future instead of sending, and nothing crosses after the
    close event."""
    lead = worlds["ranks"][0][1]["threaded"]
    after = lead["after_close"]
    assert len(after["while_closing"]) == 1
    for kind, msg in after["while_closing"] + [after["submit"],
                                               after["update"]]:
        assert kind == "RuntimeError" and "after close()" in msg
    kind, msg = after["dispatch"]
    assert kind == "RuntimeError" and "after close" in msg
    assert after["drain"] == 0
    assert after["seq"] == lead["seq"] and lead["events"]["close"] == 1


def test_a_batch_that_fails_on_one_rank_fails_on_every_rank(worlds):
    """A batch failing on ``FAILING_RANK`` after its join fails that
    batch's futures on the leader with ``RuntimeError`` naming the rank
    and its error; every follower counts the failed event, and the next
    batch is answered on every rank alike."""
    lead = worlds["ranks"][0][1]["failures_serving"]
    host = worlds["ranks"][0][1]["threaded"]["result"]["host_mr"]
    got = lead["result"]
    for kind, msg in got["failed"]:
        assert kind == "RuntimeError"
        assert msg == (f"mr group on ranks: rank {u.FAILING_RANK} failed "
                       f"(MemoryError: planted after the join)")
    assert got["next"] == host[:2] and got["last"] == host[2]
    for _, scalars in worlds["ranks"][1:]:
        rec = scalars["failures_serving"]
        assert rec["failed_events"] == 2 and rec["events"] == lead["events"]
        assert rec["stats"]["answered"] == lead["stats"]["answered"] == 3


def test_a_follower_takes_no_requests(worlds):
    """On a follower ``submit``, ``update`` and ``checkpoint`` raise
    ``RuntimeError``: a request is never dropped quietly."""
    for _, scalars in worlds["ranks"][1:]:
        errors = scalars["failures_serving"]["follower_errors"]
        assert [e[0] for e in errors] == ["RuntimeError"] * 3
        assert all("follower" in e[1] for e in errors)


def test_an_id_past_n_is_refused_before_any_rank_joins(worlds):
    """An id past ``n`` is refused at admission (nothing crosses to the
    followers); a batch past ``n`` that bypassed admission is refused by
    every rank before its first collective (C-watch-7): no rank joins
    rows for it, and its future fails naming every rank."""
    got = worlds["ranks"][0][1]["failures_serving"]["result"]
    assert got["admission"][0] == "IndexError"
    assert got["admission_sent"] == 0
    kind, msg = got["forged"]
    assert kind == "RuntimeError"
    assert msg.startswith("micro-batch on ranks:")
    assert msg.count("IndexError") == WORLD
    # three batches joined rows (the failed one, the next, the last)
    for _, scalars in worlds["ranks"]:
        assert scalars["failures_serving"]["joins"] == 3


# ---------------------------------------------------------------------------
# the store on ranks (A10d item 4)
# ---------------------------------------------------------------------------

_STORE_KINDS = [k for k, _ in u.STORE_CASES]


@pytest.mark.parametrize("kind", _STORE_KINDS)
def test_save_index_on_ranks_writes_the_reference_file(worlds, kind):
    """Every rank called ``save_index`` with one path: rank 0 wrote the
    file, ranks 1-3 wrote nothing, every rank returned the same manifest
    (the file's own), and the file is byte-equal to the reference's of
    its mesh engine after the same edits (a closure's W* assembled from
    the ranks' blocks in slot order)."""
    from repro_torch.store import read_manifest
    out = worlds["out"]
    path = os.path.join(out, f"store-{kind}.hlidx")
    with open(path, "rb") as f, open(os.path.join(
            out, f"reference-store-{kind}.hlidx"), "rb") as g:
        assert f.read() == g.read()
    manifest = read_manifest(path)
    payload = {"hl-index": "labels", "hl-index-basic": "labels"}.get(kind,
                                                                     kind)
    assert manifest["payload"] == payload
    for rank, (_, scalars) in enumerate(worlds["ranks"]):
        info = scalars["store"][kind]
        assert info["written"] == (1 if rank == 0 else 0)
        assert info["manifest"] == manifest


@pytest.mark.parametrize("kind", _STORE_KINDS)
def test_load_index_on_ranks_lands_the_reference_blocks(worlds, kind):
    """``load_index(mesh=pm)`` of the file: a closure's W* lands only this
    rank's block of the padded whole, a label snapshot as this rank's
    block, the rest whole on every rank, each equal to the reference's
    loaded engine there; its answers, ``build_engine(restore=, mesh=pm)``'s
    and those after one more update on the ranks equal the reference's."""
    ref_arrays, _ = worlds["reference"]
    tag = f"store/{kind}"
    for rank, (arrays, scalars) in enumerate(worlds["ranks"]):
        info = scalars["store"][kind]
        coords = _coords(rank, (2, 2))
        assert info["rank_mesh"].startswith("ProcessMesh(")
        assert info["restored_equal"]
        assert info["block"] == (kind == "labels")
        if kind == "closure":
            whole = ref_arrays[f"{tag}/w_star"]
            block = arrays[f"{tag}/block"]
            assert block.shape == (whole.shape[0] // 2, whole.shape[1] // 2)
            assert block.tobytes() == np.ascontiguousarray(
                _block(whole, (2, 2), coords)).tobytes()
        for snap in ("snap", "more_snap"):
            for f, fill in _FILLS.items():
                got = arrays[f"{tag}/{snap}/{f}"]
                want = ref_arrays[f"{tag}/{snap}/{f}"]
                if info["block"]:
                    want = _cut(want, f, (2, 2), coords, fill)
                assert got.dtype == want.dtype and got.shape == want.shape
                assert got.tobytes() == want.tobytes(), (kind, snap, f, rank)
        for f in ("mr", "more_mr"):
            got, want = arrays[f"{tag}/{f}"], ref_arrays[f"{tag}/{f}"]
            assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("kind", _STORE_KINDS)
def test_the_reference_loads_a_file_written_on_ranks(worlds, kind):
    """The other direction: the reference's ``load_index`` of the file
    rank 0 wrote, on this process's one CPU device, answers every pair
    as the reference's engine loaded on four devices does."""
    import repro.api as ref_api
    ref_arrays, _ = worlds["reference"]
    eng = ref_api.load_index(os.path.join(worlds["out"],
                                          f"store-{kind}.hlidx"))
    got = np.asarray(eng.mr_batch(*u.all_pairs(eng.h.n)))
    want = ref_arrays[f"store/{kind}/mr"]
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_index_store_on_ranks_writes_the_reference_files(worlds):
    """``IndexStore`` on ranks: ``checkpoint``, ``attach`` (every rank
    checks the lineage), two journaled updates, then
    ``restore(mesh=pm)``: rank 0 wrote the checkpoint and both records
    (ranks 1-3 nothing), the directory's files are the reference's byte
    for byte, and the restored engine equals the live one on every
    rank."""
    out = worlds["out"]
    mine, ref = (os.path.join(out, d) for d in ("store-ranks",
                                                "reference-store-ranks"))
    assert sorted(os.listdir(mine)) == sorted(os.listdir(ref))
    assert any(f.startswith("wal-") for f in os.listdir(mine))
    for name in os.listdir(mine):
        with open(os.path.join(mine, name), "rb") as f, \
                open(os.path.join(ref, name), "rb") as g:
            assert f.read() == g.read(), name
    for rank, (_, scalars) in enumerate(worlds["ranks"]):
        j = scalars["index_store"]
        assert (j["written"], j["appended"]) == ((1, 2) if rank == 0
                                                 else (0, 0))
        assert j["version"] == j["restored_version"] == 2
        assert j["records"] == 2
        assert j["answers_equal"] and j["snapshot_equal"]


def test_a_failed_append_raises_on_every_rank(worlds):
    """An append that fails on rank 0 raises ``RuntimeError`` naming it
    on every rank before any state changes: no rank's version, graph or
    log lineage moves."""
    for _, scalars in worlds["ranks"]:
        j = scalars["index_store"]
        kind, msg = j["failed_append"]
        assert kind == "RuntimeError"
        assert msg == ("journal append on ranks: rank 0 failed (OSError: "
                       "planted: the disk is full)")
        assert j["after_failure"] == {"version": 2,
                                      "m": u.UPDATE_GRAPH["m"] + 1,
                                      "records": 2}


def test_service_checkpoint_and_restore_on_ranks(worlds):
    """``svc.checkpoint(IndexStore(dir))`` is one event of the stream
    (rank 0 writes), an update journals, and
    ``ReachabilityService.restore(dir, mesh=pm)`` on every rank restarts
    serving on the ranks: its first answers equal the live service's."""
    for rank, (_, scalars) in enumerate(worlds["ranks"]):
        got = scalars["service_store"]
        assert got["version"] == 1
        assert got["rank_mesh"].startswith("ProcessMesh(")
        assert (got["written"] > 0) == (rank == 0)
        if rank == 0:
            assert got["live"] and got["restored"] == got["live"]
        # both services answered the same requests, each on every rank
        assert got["restored_stats"]["answered"] == u.SERVE_REQUESTS
        assert got["live_stats"]["updates"] == 1


def test_rank_store_writes_come_from_rank_zero_alone(worlds):
    """Across every store case, ranks 1-3 wrote no checkpoint file and
    appended no log record."""
    for rank, (_, scalars) in enumerate(worlds["ranks"]):
        w = scalars["store_writes"]
        if rank:
            assert w == {"files": 0, "appends": 0}
        else:
            assert w["files"] > 0 and w["appends"] > 0


# ---------------------------------------------------------------------------
# the stream's codecs (no process group)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", range(len(rs.EVENT_NAMES)),
                         ids=list(rs.EVENT_NAMES))
def test_stream_header_round_trips(kind):
    """A header carries its event kind, payload length, the leader's
    engine version, the payload's CRC-32, the sequence number and the
    group count, in ``HEADER_WORDS`` int64 words."""
    payload = np.arange(kind * 3, dtype=np.int64)
    words = rs.encode_header(kind, payload, version=7, seq=41, groups=2)
    assert words.dtype == np.int64 and words.shape == (rs.HEADER_WORDS,)
    head = rs.decode_header(words)
    assert head == rs.Header(kind, payload.size, 7, rs.digest(payload), 41,
                             2)


def test_stream_payloads_round_trip():
    """A micro-batch of every request kind, an update's edits and a
    checkpoint's spec decode to what was encoded."""
    from repro_torch.serve.reach_service import REQUEST_TYPES
    rng = np.random.default_rng(5)
    groups = {}
    for spec in u.serve_requests(40, rng, 60):
        req = u.build_request(port_api, spec)
        groups.setdefault(req.kind, []).append(req)
    assert len(groups) == len(REQUEST_TYPES)
    back = rs.decode_batch(rs.encode_batch(list(groups.items())),
                           REQUEST_TYPES)
    assert [k for k, _ in back] == list(groups)
    for (_, got), want in zip(back, groups.values()):
        assert [_query_fields(r) for r in got] == \
            [_query_fields(r) for r in want]
        # the tenant metadata stays on the leader
        assert all(r.tenant == "default" for r in got)
    edits = ([[0, 1, 2], [5, 9]], [3, 0])
    assert rs.decode_edits(rs.encode_edits(*edits)) == (edits[0], edits[1])
    assert rs.decode_edits(rs.encode_edits([], [])) == ([], [])
    spec = {"path": "/x/y", "checkpoint_every": None, "verify": True}
    assert coll.decode_json(coll.encode_json(spec)) == spec


def _query_fields(r):
    import dataclasses
    return (type(r),) + tuple(getattr(r, f.name) for f in
                              dataclasses.fields(r) if not f.kw_only)


def test_stream_refuses_what_it_cannot_read():
    """A header without the magic word, of an unknown kind or a negative
    length is refused; edits that are not integers are refused before
    anything is sent."""
    payload = np.zeros(2, np.int64)
    good = rs.encode_header(rs.BATCH, payload, 0, 0)
    for bad in (np.zeros(rs.HEADER_WORDS, np.int64), good[:-1]):
        with pytest.raises(ValueError, match="not a service stream header"):
            rs.decode_header(bad)
    for word, value in ((1, 9), (2, -1)):
        bad = good.copy()
        bad[word] = value
        with pytest.raises(ValueError, match="bad service stream header"):
            rs.decode_header(bad)
    with pytest.raises(ValueError):
        rs.encode_header(9, payload, 0, 0)
    with pytest.raises(TypeError):
        rs.encode_edits([[0, 1.5]], [])
