"""Port parity on real ranks (``repro_torch.core.mesh.ProcessMesh``): four
gloo processes on the CPU, each holding one block, against the reference
on four host devices.

One world of four ranks (``tests/util_process_mesh.py``, ``file://`` init
under ``tmp_path``) runs every case of this module once and writes one
``.npz`` / ``.json`` a rank; the reference runs the same cases in a
subprocess with ``--xla_force_host_platform_device_count=4``, but for
the LM cases' unsharded runs, which the rank processes share out once
their world has closed.  The tests
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
from repro_torch import configs as port_configs
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


class _Arrays(dict):
    """Arrays by name, with ``np.load``'s ``files``."""

    @property
    def files(self):
        return list(self)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The reference and one world of four ranks, run side by side; each
    subprocess under its own time limit."""
    out = str(tmp_path_factory.mktemp("process_mesh"))
    # the reference's LM weights, which the ranks carry across
    u.write_lm_params(out)
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
    arrays, scalars = load("reference")
    # the LM cases' reference runs, shared out over the rank processes
    reference = _Arrays(arrays)
    for r in range(WORLD):
        reference.update(np.load(os.path.join(out,
                                              f"reference-lm{r}.npz")))
    return {"reference": (reference, scalars), "out": out,
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
    assert coll.all_reduce_min(t, mesh, "data") is t
    assert coll.all_reduce_sum(t, mesh, "data") is t
    assert coll.all_to_all_over(t, mesh, "data", [2], [2]) is t
    with pytest.raises(ValueError, match="planted"):
        coll.all_to_all_over(t, mesh, "data", [2], [2],
                             error=ValueError("planted"))


def test_a_tally_counts_by_kind_in_result_bytes():
    """``Tally`` keeps the closed form's record layout; its digests of
    equal tensors are equal and a one-byte change moves them."""
    tally = coll.Tally()
    tally.reset(digests=True)
    a = torch.arange(12.0, dtype=torch.bfloat16).reshape(3, 4)
    tally.add("all-reduce", a, 0.5)
    tally.add("all-gather", torch.zeros(5, dtype=torch.int64), 0.25)
    rec = tally.record()
    assert list(rec) == ["bytes", "counts", "total_bytes", "seconds"]
    assert list(rec["bytes"]) == list(coll.KINDS)
    assert rec["bytes"]["all-reduce"] == 24 and rec["bytes"]["all-gather"] == 40
    assert rec["counts"] == {"all-gather": 1, "all-reduce": 1,
                             "reduce-scatter": 0, "all-to-all": 0,
                             "collective-permute": 0}
    assert rec["total_bytes"] == 64 and rec["seconds"] == 0.75
    assert tally.digests == [coll.digest(a)]          # all-reduces only
    b = a.clone()
    b.view(-1).view(torch.uint8)[5] ^= 1
    assert coll.digest(a.clone()) == coll.digest(a) != coll.digest(b)
    tally.reset()
    assert tally.digests is None and tally.record()["total_bytes"] == 0


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
# tensor-parallel serving of the transformer LMs: the dense cases (keys
# 2x2, 1x4) and the MoE and VLM families (u.FAMILY_CASES)
# ---------------------------------------------------------------------------

_LM_KEYS = [key for key, _, _, _ in u.LM_ALL]
_MOE_KEYS = [key for key, arch, _, _ in u.FAMILY_CASES
             if port_configs.get_smoke_config(arch).family == "moe"]
# the Mamba, hybrid and Whisper cases, and the transformer ones
_NEW_KEYS = [key for key, _, _, _ in u.NON_TRANSFORMER_CASES]
_TRANSFORMER_KEYS = [key for key in _LM_KEYS if key not in _NEW_KEYS]
_LM_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),   # tests/test_models.py:165
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}  # test_torch_models._BF16_TOL
_LM_STEPS = ["prefill"] + [f"decode{i}" for i in range(len(u.LM_DECODE_POS))]


def _grid(key):
    return u.lm_case(key)[1]


def _lm_block(whole, grid, coords, seq_dim):
    """The block of ``whole`` a rank at ``coords`` holds: rows (dim 1 of
    a cache, 0 of logits) over data, ``seq_dim`` over model."""
    rows_dim = 1 if seq_dim is not None else 0
    n = whole.shape[rows_dim] // grid[0]
    out = np.take(whole, range(coords[0] * n, (coords[0] + 1) * n),
                  axis=rows_dim)
    if seq_dim is not None:
        m = whole.shape[seq_dim] // grid[1]
        out = np.take(out, range(coords[1] * m, (coords[1] + 1) * m),
                      axis=seq_dim)
    return out


def _routes(arrays, tag, step):
    """A run's chosen experts of ``step``, a layer each, ``[t, top_k]``
    sorted along the slots."""
    out, layer = [], 0
    while f"{tag}/route/{step}/{layer}" in arrays:
        out.append(np.sort(arrays[f"{tag}/route/{step}/{layer}"], axis=-1))
        layer += 1
    return out


def _rows_routed_as_the_reference(worlds, key, dtype, step):
    """The batch rows whose every token took the reference's experts in
    every MoE layer of ``step`` and of the decode steps before it (the
    cache carries their K/V): each rank routes its own data rows (the
    tokens of a row are consecutive)."""
    ref, _ = worlds["reference"]
    tag = f"lm/{key}/{dtype}"
    steps = [step] if step == "prefill" else \
        [f"decode{i}" for i in range(int(step[len("decode"):]) + 1)]
    clean = np.ones(u.LM_BATCH, bool)
    grid = _grid(key)
    per = u.LM_BATCH // grid[0]
    for rank, (arrays, _) in enumerate(worlds["ranks"]):
        i, j = _coords(rank, grid)
        if j:
            continue
        rows = slice(i * per, (i + 1) * per)
        for st in steps:
            want = _routes(ref, tag, st)
            got = _routes(arrays, tag, st)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                w = w.reshape(u.LM_BATCH, -1, w.shape[-1])[rows]
                flips = (g.reshape(w.shape) != w).any(axis=(1, 2))
                clean[rows] &= ~flips
    return clean


@pytest.mark.parametrize("dtype", u.LM_DTYPES)
@pytest.mark.parametrize("grid", _LM_KEYS, ids=_LM_KEYS)
def test_tensor_parallel_logits_equal_the_unsharded_reference(worlds, grid,
                                                              dtype):
    """Every rank's gathered logits of the prefill step and of each
    decode step against the reference's unsharded model (``grid`` names
    the case of ``u.LM_ALL``).  A MoE model in bf16 is held row by row
    where the row took the reference's experts everywhere: the two
    packages round bf16 apart, near-tied router choices then flip (on
    ranks as in one process: ``test_torch_models``), and a flipped
    expert moves a logit by far more than a rounding; every row past
    ``_BF16_TOL`` must be such a row."""
    ref, _ = worlds["reference"]
    tag = f"lm/{grid}/{dtype}"
    routed = grid in _MOE_KEYS and dtype == "bfloat16"
    for step in _LM_STEPS:
        clean = (_rows_routed_as_the_reference(worlds, grid, dtype, step)
                 if routed else np.ones(u.LM_BATCH, bool))
        assert routed or clean.all()
        for rank, (arrays, _) in enumerate(worlds["ranks"]):
            got = arrays[f"{tag}/{step}"].reshape(u.LM_BATCH, -1)
            want = ref[f"{tag}/{step}"].reshape(u.LM_BATCH, -1)
            np.testing.assert_allclose(got[clean], want[clean],
                                       err_msg=f"rank {rank} {step}",
                                       **_LM_TOL[dtype])


@pytest.mark.parametrize("dtype", u.LM_DTYPES)
def test_moe_rows_take_the_reference_experts_on_these_inputs(worlds,
                                                             dtype):
    """Every row of every MoE case, in the prefill and each decode step,
    took the reference's experts in every layer: the ranks' partial sums
    cross in float32 and are rounded once (``layers.sum_partials``), as
    one process rounds its products.  (Summed in bf16 instead, two rows
    of the 1 x 4 cases' bf16 prefill took other experts, and three rows
    routed as the reference's passed ``_BF16_TOL``.)"""
    for key in _MOE_KEYS:
        for step in _LM_STEPS:
            assert _rows_routed_as_the_reference(worlds, key, dtype,
                                                 step).all(), (key, step)


@pytest.mark.parametrize("dtype", u.LM_DTYPES)
@pytest.mark.parametrize("grid", _LM_KEYS, ids=_LM_KEYS)
def test_every_rank_gathers_the_same_logit_bytes(worlds, grid, dtype):
    """The gathered logits are byte-equal on every rank, and a rank's own
    prefill block (its rows over data, its vocab over model where the
    head splits it) is their cut."""
    tag = f"lm/{grid}/{dtype}"
    shape = _grid(grid)
    first = worlds["ranks"][0][0]
    for rank, (arrays, _) in enumerate(worlds["ranks"]):
        for step in _LM_STEPS:
            assert np.array_equal(arrays[f"{tag}/{step}"],
                                  first[f"{tag}/{step}"]), (rank, step)
        whole = arrays[f"{tag}/prefill"]
        i, j = _coords(rank, shape)
        # Whisper's head sums whole logits over model: a rank's block is
        # its rows of every column
        split = u.case_config(port_configs, grid, dtype).family != "encdec"
        rows = whole.shape[0] // shape[0]
        cols = whole.shape[1] // (shape[1] if split else 1)
        j = j if split else 0
        assert np.array_equal(arrays[f"{tag}/prefill_block"],
                              whole[i * rows:(i + 1) * rows,
                                    j * cols:(j + 1) * cols])


@pytest.mark.parametrize("dtype", u.LM_DTYPES)
@pytest.mark.parametrize("grid", _TRANSFORMER_KEYS, ids=_TRANSFORMER_KEYS)
def test_each_rank_cache_block_is_the_reference_block(worlds, grid, dtype):
    """After the three decode steps a rank's cache is its block of the
    reference's new cache (rows over data, slots over model): the seeded
    slots byte for byte; the written ones, bf16 K/V of the step's
    projections, within one bf16 rounding (float32 compute) or
    ``_BF16_TOL`` (a MoE model's bf16 rows where they took the
    reference's experts in every step)."""
    ref, _ = worlds["reference"]
    tag = f"lm/{grid}/{dtype}"
    shape = _grid(grid)
    tol = (dict(rtol=2.0 ** -7, atol=1e-6) if dtype == "float32"
           else _LM_TOL[dtype])
    clean = (_rows_routed_as_the_reference(
        worlds, grid, dtype, _LM_STEPS[-1])
        if grid in _MOE_KEYS and dtype == "bfloat16"
        else np.ones(u.LM_BATCH, bool))
    for rank, (arrays, _) in enumerate(worlds["ranks"]):
        coords = _coords(rank, shape)
        slots = u.LM_SEQ // shape[1]
        per = u.LM_BATCH // shape[0]
        held = clean[coords[0] * per:(coords[0] + 1) * per]
        mine = [p - coords[1] * slots for p in u.LM_DECODE_POS
                if coords[1] * slots <= p < (coords[1] + 1) * slots]
        for k in ("k", "v"):
            got = arrays[f"{tag}/cache_{k}"]
            want = _lm_block(ref[f"{tag}/cache_{k}"], shape, coords, 2)
            assert got.shape == want.shape
            kept = np.setdiff1d(np.arange(slots), mine)
            assert np.array_equal(got[:, :, kept], want[:, :, kept]), \
                (rank, k)
            np.testing.assert_allclose(got[:, held][:, :, mine],
                                       want[:, held][:, :, mine],
                                       err_msg=f"rank {rank} {k}", **tol)


@pytest.mark.parametrize("dtype", u.LM_DTYPES)
@pytest.mark.parametrize("key", _MOE_KEYS)
def test_moe_routing_is_the_same_along_each_model_line(worlds, key, dtype):
    """Every MoE layer of every step chose the same experts on every rank
    of a ``model`` line (the router reads the all-reduced residual)."""
    tag = f"lm/{key}/{dtype}"
    grid = _grid(key)
    ranks = worlds["ranks"]
    for rank, (arrays, _) in enumerate(ranks):
        i, _ = _coords(rank, grid)
        head = ranks[i * grid[1]][0]
        for step in _LM_STEPS:
            got, want = _routes(arrays, tag, step), _routes(head, tag, step)
            assert len(got) == 2 and len(got) == len(want)
            assert all(np.array_equal(g, w) for g, w in zip(got, want)), \
                (rank, step)


_RUN_COUNTS = {
    # (all-reduces, all-gathers, all-to-alls) a layer and once more: the
    # embedding's all-reduce, and llava's projector in prefill
    "dense": {"prefill": ((2, 0, 0), (1, 0)), "decode": ((5, 1, 0), (1, 0))},
    "ffn": {"prefill": ((3, 0, 0), (1, 0)), "decode": ((6, 1, 0), (1, 0))},
    "ep": {"prefill": ((2, 1, 2), (1, 0)), "decode": ((5, 2, 2), (1, 0))},
    "vlm": {"prefill": ((2, 0, 0), (2, 0)), "decode": ((5, 1, 0), (1, 0))},
}


def _run_kind(key):
    """The ``_RUN_COUNTS`` row of the case ``key``."""
    cfg = u.case_config(port_configs, key, "bfloat16")
    if cfg.family == "moe":
        return "ffn" if cfg.expert_sharding == "ffn" else "ep"
    return cfg.family


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("grid", _TRANSFORMER_KEYS, ids=_TRANSFORMER_KEYS)
def test_rank_runs_count_the_closed_forms_collectives(worlds, grid, kind):
    """``lower_cell(..., run=True, ranks=pm)``: every rank's tally of one
    timed pass equals the closed form's ``collective_executed`` (every
    layer), kind by kind and byte for byte, the expert-parallel
    all-to-all's bytes over each model line
    (``dryrun.closed_form_mismatch``); prefill moves 2 L + 1 all-reduces
    on the dense model, decode 5 L + 1 and L all-gathers, the MoE and VLM
    models their layers' own (``_RUN_COUNTS``)."""
    from repro_torch.launch import dryrun
    layers = 2
    shape = _grid(grid)
    (ar, ag, a2a), (ar0, ag0) = _RUN_COUNTS[_run_kind(grid)][kind]
    for rank, (_, scalars) in enumerate(worlds["ranks"]):
        run = scalars["lm_runs"][f"{grid}/{kind}"]
        assert run["run_reason"] is None
        assert run["run_batch"] == 2 * u.LM_BATCH // shape[0]
        want = run["collective_executed"]
        assert len(run["run_collective"]) == WORLD
        assert dryrun.closed_form_mismatch(run["run_collective"], want,
                                           shape) is None, rank
        if not a2a:
            assert all(c == want for c in run["run_collective"]), rank
        counts = want["counts"]
        assert (counts["all-reduce"], counts["all-gather"],
                counts["all-to-all"]) == (layers * ar + ar0,
                                          layers * ag + ag0, layers * a2a)
        assert [r["coords"] for r in run["run_ranks"]] == [
            list(_coords(k, shape)) for k in range(WORLD)]
        # nothing on the CPU is a device measurement
        assert run["run_s"] is None and run["run_exchange_s"] is None
        checks = run["run_checks"]
        assert f"{counts['all-reduce']} all-reduced tensors equal on every " \
            f"rank of a model line" in checks
        assert "gathered logits equal on every rank" in checks
        if grid in _MOE_KEYS:
            assert f"{layers} routings (experts, gates) equal on every " \
                f"rank of a model line" in checks
        if kind == "decode":
            assert {"k/v written at pos 15 only",
                    "the other ranks' caches unchanged"} <= set(checks)


def test_expert_parallel_all_to_all_bytes_follow_the_routing(worlds):
    """An expert-parallel run's ranks receive uneven all-to-all bytes (the
    routing decides), which sum over each model line to the closed
    form's line total; a decode's one token a data row is owned by one
    rank of its line."""
    for key in ("arctic-model+data-1x4", "arctic-model-2x2"):
        grid = _grid(key)
        for kind in ("prefill", "decode"):
            run = worlds["ranks"][0][1]["lm_runs"][f"{key}/{kind}"]
            got = [c["bytes"]["all-to-all"] for c in run["run_collective"]]
            want = run["collective_executed"]["bytes"]["all-to-all"]
            for lo in range(0, WORLD, grid[1]):
                assert sum(got[lo:lo + grid[1]]) == grid[1] * want
            if kind == "prefill":
                assert len(set(got)) > 1, (key, got)


def test_a_rank_whose_run_check_fails_makes_every_rank_raise(worlds):
    """A decode that writes away from ``pos`` on one rank: that rank's
    check fails, and every rank raises naming it."""
    for rank, (_, scalars) in enumerate(worlds["ranks"]):
        kind, msg = scalars["lm_failure"]
        assert kind == "RuntimeError", (rank, msg)
        assert f"rank {u.LM_FAILING_RANK} failed" in msg
        assert "changed away from pos" in msg


@pytest.mark.parametrize("t", u.MOE_LAYER_TOKENS)
@pytest.mark.parametrize("dtype", u.LM_DTYPES)
@pytest.mark.parametrize("key", _MOE_KEYS)
def test_moe_layer_on_ranks_equals_the_reference(worlds, key, dtype, t):
    """The first block's MoE layer alone on ranks, on one seeded input of
    ``t`` tokens (13: split unevenly over the line; 1: owned by one rank
    of it, the others send and get nothing), against the reference's
    ``moe_apply`` on the whole layer: output and aux loss at 1e-4 in
    float32 and ``_BF16_TOL`` in bf16 (both routers read the same
    input)."""
    import jax
    import jax.numpy as jnp
    from repro import configs as ref_configs
    from repro.models import layers as ref_layers
    from repro_torch.convert import nest_layers
    cfg = u.case_config(ref_configs, key, dtype)
    params = nest_layers(dict(np.load(os.path.join(
        worlds["out"], f"lm-params-{key}.npz"))))
    moe = jax.tree.map(lambda a: jnp.asarray(a[0]),
                       params["blocks"]["moe"])          # the first block
    x = jnp.asarray(u.moe_layer_input(cfg, t), getattr(jnp, dtype))
    want, want_aux = ref_layers.moe_apply(moe, cfg, x)
    for rank, (arrays, _) in enumerate(worlds["ranks"]):
        got = arrays[f"moe_layer/{key}/{dtype}/{t}"]
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   err_msg=f"rank {rank}", **_LM_TOL[dtype])
        np.testing.assert_allclose(arrays[f"moe_layer/{key}/{dtype}/{t}/aux"],
                                   np.asarray(want_aux, np.float32),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("key", ["arctic-model-2x2",
                                 "arctic-model+data-1x4"])
def test_a_rank_whose_expert_step_fails_makes_every_rank_raise(worlds, key):
    """A planted failure in rank 1's expert step: it still joins the
    return all-to-all's count exchange, and every rank (the other
    ``model`` line's too) raises naming it."""
    for rank, (_, scalars) in enumerate(worlds["ranks"]):
        kind, msg = scalars["moe_failure"][key]
        assert kind == "RuntimeError", (rank, msg)
        assert "the expert step on ranks" in msg
        assert f"rank {u.LM_FAILING_RANK} failed (RuntimeError: the " \
            f"planted expert failure)" in msg


@pytest.mark.parametrize("name,why", [
    ("model+data", "the ranks' data axis 2 > 1"),
    ("moe_capacity", "capacity dispatch (moe_capacity)"),
    ("hybrid_heads", "model axis 4 does not divide n_heads 10"),
    ("long_context", "a long-context decode")])
def test_a_layout_the_ranks_do_not_split_records_why(worlds, name, why):
    """``"model+data"`` experts on ranks whose data axis is 2, capacity
    dispatch, recurrentgemma-2b's published 10 heads on a model axis of
    4 and a long-context decode record their ``run_reason`` and run
    nothing."""
    for rank, (_, scalars) in enumerate(worlds["ranks"]):
        rec = scalars["lm_refused"][name]
        assert why in rec["run_reason"] and not rec["ran"], rank


class _At:
    """The ``ProcessMesh`` fields ``block_slices`` reads, at ``coords``
    of a (data, model) ``grid``, without a process group."""

    def __init__(self, grid, coords):
        self.axis_names = u.AXES
        self.shape = dict(zip(u.AXES, grid))
        self.coords = tuple(coords)

    def axis_index(self, axis):
        return self.coords[self.axis_names.index(axis)]


# bf16 compute: a family cache's root-mean-square departure from the
# reference's, relative to its root-mean-square, at most this (the
# size of _BF16_TOL).  Elementwise the two packages' bf16 recurrences
# part by more: the hybrid's states by up to 0.15 in one process as on
# ranks (0.148 and 0.127 on these inputs, 3.0 % and 3.3 % of the RMS)
_BF16_RMS = 5e-2


def _close_to_the_reference(got, want, dtype, stored, what):
    """Float32 compute: a float32 leaf at 1e-4, a bf16 one within one
    bf16 rounding; bf16 compute: the relative RMS departure under
    ``_BF16_RMS``."""
    if dtype == "bfloat16":
        if not got.size:              # a rank whose slots hold no step
            return
        rms = np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))
        assert rms <= _BF16_RMS, (what, rms)
        return
    tol = (_LM_TOL[dtype] if stored == "float32"
           else dict(rtol=2.0 ** -7, atol=1e-6))
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


@pytest.mark.parametrize("dtype", u.LM_DTYPES)
@pytest.mark.parametrize("key", _NEW_KEYS)
def test_each_rank_family_cache_block_is_the_reference_block(worlds, key,
                                                            dtype):
    """After the three decode steps each cache leaf of a rank is its block
    (``cache_specs``) of the reference's: Mamba's ``conv`` / ``ssm`` and
    RG-LRU's ``conv*`` / ``h*`` in the rank's channels, every value
    advanced; the hybrid's window whole on every rank, written at ``pos
    % 8`` (slots 2, 1, 7) and the other slots byte for byte; Whisper's
    self-attention slots as the dense model's and its cross cache byte
    for byte the seeded one.  What was written is held in float32
    compute entry by entry, in bf16 by its RMS (``_BF16_RMS``)."""
    from repro_torch.distributed_lm.sharding import leaf_block
    from repro_torch.models import build_model
    ref, _ = worlds["reference"]
    tag = f"lm/{key}/{dtype}"
    grid = _grid(key)
    cfg = u.case_config(port_configs, key, dtype)
    specs = build_model(cfg, device="meta").cache_specs()
    stored = u.cache_dtypes(cfg)
    for rank, (arrays, _) in enumerate(worlds["ranks"]):
        at = _At(grid, _coords(rank, grid))
        for k, dt in stored.items():
            got = arrays[f"{tag}/cache_{k}"]
            want = leaf_block(ref[f"{tag}/cache_{k}"], specs[k], at)
            assert got.shape == want.shape, (rank, k)
            if k.startswith("cross_"):
                assert np.array_equal(got, want), (rank, k)
                continue
            if k in ("k", "v"):
                slots = got.shape[2]
                lo = (at.axis_index("model") * slots
                      if cfg.family == "encdec" else 0)
                mine = sorted({(p - lo) % slots for p in u.LM_DECODE_POS
                               if cfg.family != "encdec"
                               or lo <= p < lo + slots})
                kept = np.setdiff1d(np.arange(slots), mine)
                assert np.array_equal(got[:, :, kept], want[:, :, kept]), \
                    (rank, k)
                got, want = got[:, :, mine], want[:, :, mine]
            _close_to_the_reference(got, want, dtype, dt, f"rank {rank} {k}")


@pytest.mark.parametrize("dtype", u.LM_DTYPES)
@pytest.mark.parametrize("key", [k for k in _NEW_KEYS if "whisper" in k])
def test_prefill_cross_on_ranks_fills_the_reference_cross_cache(worlds, key,
                                                                dtype):
    """``prefill_cross`` on ranks (each layer's new cross K/V gathered over
    ``model``) writes the whole cross cache of the rank's rows, the
    reference's rows of its unsharded ``prefill_cross`` (a float32
    cache)."""
    ref, _ = worlds["reference"]
    tag = f"lm/{key}/{dtype}"
    grid = _grid(key)
    per = u.LM_BATCH // grid[0]
    for rank, (arrays, _) in enumerate(worlds["ranks"]):
        i, _ = _coords(rank, grid)
        for k in ("cross_k", "cross_v"):
            np.testing.assert_allclose(
                arrays[f"{tag}/prefill_{k}"],
                ref[f"{tag}/prefill_{k}"][:, i * per:(i + 1) * per],
                err_msg=f"rank {rank} {k}", **_LM_TOL[dtype])


def _family_counts(key, kind):
    """(all-reduces, all-gathers) of one pass of a new family's cell on
    smoke widths (2 x LM_BATCH rows of LM_RUN_SEQ tokens): Mamba 2 x
    (``x_proj``, ``out_proj``) + the embedding; the hybrid's two groups
    (two rec blocks' ``out`` and three MLPs' ``down`` and ``wo``) and two
    tail blocks (``out``, ``down``) + the embedding, and a gather of the
    conv output a rec block (six) and of the new k / v an attention layer
    (two); Whisper's encoder (``wo``, ``fc2``) and decoder (``wo`` twice,
    ``fc2``, and in decode the sequence-split attention's three) two
    layers each, its head in ``u.WHISPER_HEAD_CHUNK``-token pieces, the
    embedding's all-gather and in decode the q / k / v gather a
    layer."""
    cfg = u.case_config(port_configs, key, "bfloat16")
    if cfg.family == "ssm":
        return 5, 0
    if cfg.family == "hybrid":
        return 17, 8
    rows = 2 * u.LM_BATCH // _grid(key)[0]
    if kind == "prefill":
        return 2 * 2 + 2 * 3 + -(-rows * u.LM_RUN_SEQ
                                 // u.WHISPER_HEAD_CHUNK), 1
    return 2 * 6 + 1, 1 + 2


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("key", _NEW_KEYS)
def test_family_rank_runs_count_the_closed_forms_collectives(worlds, key,
                                                            kind):
    """``lower_cell(..., run=True, ranks=pm)`` of the Mamba, hybrid and
    Whisper cells: every rank's tally of one timed pass equals the
    closed form's ``collective_executed``, kind by kind and byte for
    byte, RG-LRU's conv-output gathers and the hybrid's k / v gathers
    and Whisper's head pieces included (``_family_counts``); the decode
    checks name the states advanced, the window equal along the line,
    the cross cache unchanged."""
    from repro_torch.launch import dryrun
    shape = _grid(key)
    family = u.case_config(port_configs, key, "bfloat16").family
    for rank, (_, scalars) in enumerate(worlds["ranks"]):
        run = scalars["lm_runs"][f"{key}/{kind}"]
        assert run["run_reason"] is None
        assert run["run_batch"] == 2 * u.LM_BATCH // shape[0]
        want = run["collective_executed"]
        assert dryrun.closed_form_mismatch(run["run_collective"], want,
                                           shape) is None, rank
        assert all(c == want for c in run["run_collective"]), rank
        counts = want["counts"]
        assert (counts["all-reduce"], counts["all-gather"]) == \
            _family_counts(key, kind), rank
        assert counts["all-to-all"] == counts["reduce-scatter"] == 0
        assert run["run_s"] is None and run["run_exchange_s"] is None
        checks = run["run_checks"]
        assert f"{counts['all-reduce']} all-reduced tensors equal on every " \
            f"rank of a model line" in checks
        assert "gathered logits equal on every rank" in checks
        if kind == "prefill":
            width = 256 // (1 if family == "encdec" else shape[1])
            assert f"logits [{run['run_batch']}, {width}]" in checks
            continue
        if family == "ssm":
            assert "conv/ssm advanced in every channel of the rank" in checks
        elif family == "hybrid":
            assert {"k/v written at pos 15 only",
                    "conv1/h1/conv2/h2/tail_conv/tail_h advanced in every "
                    "channel of the rank",
                    "the window equal on every rank of a model line"} <= \
                set(checks)
        else:
            assert {"k/v written at pos 15 only",
                    "the other ranks' caches unchanged",
                    "cross K/V unchanged"} <= set(checks)


@pytest.mark.parametrize("name,why", [
    ("mamba", "state ssm did not advance in every channel"),
    ("griffin", "the window cache differs between the ranks of a model "
                "line")])
def test_a_new_family_rank_whose_check_fails_makes_every_rank_raise(
        worlds, name, why):
    """A Mamba decode that holds back one state channel on one rank (its
    own check fails), and a hybrid decode that writes its window apart
    from its line's on one rank (every rank of the line sees the
    digests differ): every rank raises, naming the failure."""
    for rank, (_, scalars) in enumerate(worlds["ranks"]):
        kind, msg = scalars["lm_family_failure"][name]
        assert kind == "RuntimeError", (rank, msg)
        assert why in msg, (rank, msg)
        if name == "mamba":
            assert f"rank {u.LM_FAILING_RANK} failed" in msg


@pytest.mark.parametrize("coords", [(0, 0), (0, 1), (1, 1)])
def test_a_rank_mamba_in_proj_block_is_its_block_of_each_half(coords):
    """Mamba's ``in_proj`` spec splits its fused ``[xs | z]`` columns over
    ``model``; a rank on a (data, model) = (2, 2) grid holds its
    channels' columns of each half (``layers.Fused``), not a contiguous
    block: ``block_slices``, the block ``init`` draws and
    ``lm_rank_state_dict_from_params`` cut agree, and the rank's
    ``chunk(2)`` of its product is its channels of ``xs`` and of ``z``."""
    from repro_torch.convert import (lm_params_from_state_dict,
                                     lm_rank_state_dict_from_params)
    from repro_torch.distributed_lm.sharding import block_slices, leaf_spec
    from repro_torch.models import build_model
    cfg = port_configs.get_smoke_config("falcon-mamba-7b")
    di, c = cfg.d_inner, coords[1]
    at = _At((2, 2), coords)
    whole = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    specs = whole.param_specs()
    spec = leaf_spec(specs, "blocks.1.in_proj.w")
    assert tuple(spec) == (None, "model")
    cols = np.r_[c * di // 2:(c + 1) * di // 2,
                 di + c * di // 2:di + (c + 1) * di // 2]
    got = block_slices((cfg.d_model, 2 * di), spec, at)
    assert got[0] == slice(0, cfg.d_model)
    assert np.array_equal(got[1], cols)
    mine = build_model(cfg, device="cpu", ranks=at).init(
        torch.Generator().manual_seed(0))
    w = whole.blocks[1].in_proj.w.detach()
    assert torch.equal(mine.blocks[1].in_proj.w.detach(), w[:, cols])
    carried = lm_rank_state_dict_from_params(
        lm_params_from_state_dict(whole.state_dict()), specs, at)
    assert torch.equal(carried["blocks.1.in_proj.w"], w[:, cols])
    x = torch.randn((3, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    xs, z = (x @ mine.blocks[1].in_proj.w).chunk(2, dim=-1)
    full_xs, full_z = (x @ w).chunk(2, dim=-1)
    lo, hi = c * di // 2, (c + 1) * di // 2
    assert torch.allclose(xs, full_xs[:, lo:hi], rtol=1e-5, atol=1e-6)
    assert torch.allclose(z, full_z[:, lo:hi], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# training the dense LM on ranks: u.LM_TRAIN_KEY's SMOKE model on 1 x 4
# ---------------------------------------------------------------------------

_TRAIN_TAG = "lm_train/{}"


def _train_keys(ref, tag, what):
    head = f"{tag}/{what}/"
    keys = [k[len(head):] for k in ref.files if k.startswith(head)]
    assert keys, head
    return keys


def _train_specs():
    from repro_torch.models import build_model
    return build_model(u.lm_train_config(port_configs, "float32"),
                       device="meta").param_specs()


def test_rank_gradients_equal_the_unsharded_reference(worlds):
    """Each rank's gradient blocks from one ``loss.backward()`` (float32,
    the reference's weights) against ``jax.grad`` of the reference's
    ``model.loss`` cut to the rank's block, at 1e-4: the backward's
    all-reduces at each column-split group's input, the vocab-split loss
    and the remat recompute on ranks.  The qk norms, whole on every rank
    but applied to the rank's own heads, hold a partial gradient on a
    rank (``layers.partial_grad``): their sum over the ``model`` line is
    the reference's.  The loss is the reference's on every rank."""
    from repro_torch.distributed_lm.sharding import leaf_block, leaf_spec
    from repro_torch.models import layers
    ref, _ = worlds["reference"]
    tag = _TRAIN_TAG.format("float32")
    grid = _grid(u.LM_TRAIN_KEY)
    specs = _train_specs()
    tol = _LM_TOL["float32"]
    ranks = worlds["ranks"]
    keys = _train_keys(ref, tag, "grad")
    assert any(layers.partial_grad(k) for k in keys)
    for k in keys:
        want = ref[f"{tag}/grad/{k}"]
        if layers.partial_grad(k):
            got = sum(arrays[f"{tag}/grad/{k}"] for arrays, _ in ranks)
            np.testing.assert_allclose(got, want, err_msg=k, **tol)
            continue
        for rank, (arrays, _) in enumerate(ranks):
            at = _At(grid, _coords(rank, grid))
            np.testing.assert_allclose(
                arrays[f"{tag}/grad/{k}"],
                leaf_block(want, leaf_spec(specs, k), at),
                err_msg=f"rank {rank} {k}", **tol)
    for rank, (arrays, _) in enumerate(ranks):
        np.testing.assert_allclose(arrays[f"{tag}/loss"], ref[f"{tag}/loss"],
                                   err_msg=f"rank {rank}", **tol)


@pytest.mark.parametrize("dtype", u.LM_DTYPES)
def test_a_rank_train_step_equals_the_unsharded_reference(worlds, dtype):
    """One microbatched step from zero moments on ranks against the
    reference's ``make_train_step``: the loss, the gradient norm (the
    ``model`` line's all-reduce of the ranks' sums of squares) and the
    count on every rank, and each rank's blocks of the new parameters,
    ``m`` and ``v`` (the reference's state cut by
    ``convert.lm_rank_adam_state_from_params``), at 1e-4 in float32 and
    ``_BF16_TOL`` in bf16."""
    from repro_torch.convert import (lm_rank_adam_state_from_params,
                                     lm_rank_state_dict_from_params,
                                     nest_layers)
    ref, _ = worlds["reference"]
    tag = _TRAIN_TAG.format(dtype) + "/step"
    grid = _grid(u.LM_TRAIN_KEY)
    specs = _train_specs()
    tol = _LM_TOL[dtype]

    def tree(name):
        return nest_layers({k: ref[f"{tag}/{name}/{k}"]
                            for k in _train_keys(ref, tag, name)})
    ref_params = tree("params")
    ref_state = {"m": tree("m"), "v": tree("v"),
                 "count": ref[f"{tag}/count"]}
    for rank, (arrays, _) in enumerate(worlds["ranks"]):
        at = _At(grid, _coords(rank, grid))
        want = lm_rank_state_dict_from_params(ref_params, specs, at)
        state = lm_rank_adam_state_from_params(ref_state, specs, at)
        assert int(arrays[f"{tag}/count"]) == int(state["count"]) == 1
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(arrays[f"{tag}/{k}"], ref[f"{tag}/{k}"],
                                       err_msg=f"rank {rank} {k}", **tol)
        assert sorted(want) == sorted(_train_keys(arrays, tag, "params"))
        for k, w in want.items():
            np.testing.assert_allclose(arrays[f"{tag}/params/{k}"], w.numpy(),
                                       err_msg=f"rank {rank} {k}", **tol)
            for mom in ("m", "v"):
                np.testing.assert_allclose(
                    arrays[f"{tag}/{mom}/{k}"], state[mom][k].numpy(),
                    err_msg=f"rank {rank} {mom} {k}", **tol)


def test_a_rank_train_run_counts_the_closed_forms_collectives(worlds):
    """``lower_cell(..., run=True, ranks=pm)`` of a train cell on 1 x 4:
    no ``run_reason``; every rank's tally of one timed step equals the
    closed form's ``collective_executed``, byte for byte: a layer's
    ``wo`` and ``down`` sums in the forward and the remat recompute and
    their backward sums at the column-split inputs (each with its status
    word), the embedding's sum, the loss's three float32 statistics, the
    head's input gradient, the qk norms' partial gradients (one
    all-reduce of them all) and the global norm's one value; and the
    run's checks, on every rank."""
    from repro_torch.launch import dryrun
    cfg = port_configs.get_smoke_config(u.LM_ARCH)
    grid = _grid(u.LM_TRAIN_KEY)
    layers_, d, hd = cfg.n_layers, cfg.d_model, cfg.hd
    t = u.LM_BATCH * u.LM_RUN_SEQ
    want_bytes = (layers_ * 2 * (2 * t * d * 4 + (t * d + 1) * 4)
                  + t * d * 2 + 3 * t * 4 + (t * d + 1) * 4
                  + layers_ * 2 * hd * 4 + 4)
    for rank, (_, scalars) in enumerate(worlds["ranks"]):
        run = scalars["lm_train_run"]
        assert run["run_reason"] is None
        assert run["run_batch"] == u.LM_BATCH
        want = run["collective_executed"]
        assert dryrun.closed_form_mismatch(run["run_collective"], want,
                                           grid) is None
        assert all(c == want for c in run["run_collective"])
        assert want["counts"] == dict(dict.fromkeys(dryrun.COLLECTIVE_KINDS,
                                                    0),
                                      **{"all-reduce": 6 * layers_ + 7})
        assert want["bytes"]["all-reduce"] == want_bytes
        # one microbatch a step: the flat count is the layer stack's body
        # once, the rest as executed
        assert run["collective"]["counts"]["all-reduce"] == 6 + 7
        assert run["run_s"] is None
        n = len(_train_keys(worlds["ranks"][rank][0],
                            _TRAIN_TAG.format("float32"), "grad"))
        assert run["run_checks"] == [
            "losses finite", "parameters finite",
            f"all {n} gradients non-zero before the update",
            f"all {n} parameters changed",
            f"{4 * layers_ + 1} replicated parameters equal on every rank "
            f"of a model line",
            "loss and grad_norm equal on every rank",
            f"{6 * layers_ + 7} all-reduced tensors equal on every rank of "
            f"a model line",
            "collectives equal to the closed form's"]


def test_a_rank_whose_share_of_a_backward_sum_fails_makes_every_rank_raise(
        worlds):
    """Rank 1's share of the first backward sum fails: it still joins
    that all-reduce with its status word set, and every rank raises
    naming it, none left waiting in a collective."""
    for rank, (_, scalars) in enumerate(worlds["ranks"]):
        kind, msg = scalars["lm_train_failure"]
        assert kind == "RuntimeError", (rank, msg)
        assert "the backward on ranks" in msg
        assert f"rank {u.LM_FAILING_RANK} failed (RuntimeError: the " \
            f"planted backward failure)" in msg


def test_a_cut_backward_fails_the_gradient_check_on_every_rank(worlds):
    """Row-split sums whose backward passes zeros cut the gradient of
    every parameter upstream of them in a block (the parameters still
    change: weight decay moves them); the run's check that every gradient
    is non-zero before the update fails on every rank, and every rank
    raises."""
    for rank, (_, scalars) in enumerate(worlds["ranks"]):
        kind, msg = scalars["lm_train_cut"]
        assert kind == "RuntimeError", (rank, msg)
        assert "run_cell checks on ranks" in msg
        for r in range(WORLD):
            assert f"rank {r} failed (AssertionError: run: the gradient " \
                f"of " in msg, (rank, r)
        for k in ("blocks.0.attn.wo.w", "blocks.1.mlp.gate.w",
                  "blocks.0.attn.q_norm.scale", "blocks.1.ln1.scale"):
            assert k in msg
        assert "zero everywhere before the update" in msg


# ---------------------------------------------------------------------------
# training with the batch split over data: ZeRO-1 on u.LM_ZERO1_KEY's 2 x 2
# ---------------------------------------------------------------------------

_ZERO1_IDS = [f"{d}-{'zero1' if z else 'whole'}" for d, z in u.LM_ZERO1_CASES]
_ZERO1_GRID = (2, 2)


def _zero1_model():
    from repro_torch.models import build_model
    return build_model(u.lm_zero1_config(port_configs, "float32"),
                       device="meta")


def _shard_of(whole, block):
    """``whole``'s entries at ``block`` (``[lo, hi)`` a dimension)."""
    return whole[tuple(slice(lo, hi) for lo, hi in block)]


def _data_partner(rank):
    """The other rank of ``rank``'s data line on the 2 x 2 grid."""
    d, m = _coords(rank, _ZERO1_GRID)
    return (1 - d) * _ZERO1_GRID[1] + m


@pytest.mark.parametrize("axis", u.AXES)
@pytest.mark.parametrize("dim", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduce_scatter_sums_in_float32_and_keeps_the_rank_block(
        worlds, axis, dim, dtype):
    """``reduce_scatter_sum`` over each axis of the 2 x 2 grid along each
    dimension: the float32 sum of the line's inputs (bf16 inputs summed
    in float32), of which each rank keeps the block at its coordinate;
    counted as one ``reduce-scatter`` of the result's bytes, nothing
    else."""
    tag = f"rs/{axis}/{dim}/{dtype}"
    k = u.AXES.index(axis)
    for rank, (arrays, scalars) in enumerate(worlds["ranks"]):
        coords = _coords(rank, _ZERO1_GRID)
        line = [r for r in range(WORLD) if all(
            c == o for i, (c, o) in enumerate(zip(_coords(r, _ZERO1_GRID),
                                                  coords)) if i != k)]
        total = sum(u.rs_input(r).astype(np.float64) for r in line)
        size = u.RS_SHAPE[dim] // 2
        want = np.take(total, range(coords[k] * size,
                                    (coords[k] + 1) * size), axis=dim)
        got = arrays[tag]
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want.astype(np.float32))
        rec = scalars[tag]
        assert rec["dtype"] == "torch.float32"
        assert rec["counts"] == dict(dict.fromkeys(coll.KINDS, 0),
                                     **{"reduce-scatter": 1})
        assert rec["bytes"]["reduce-scatter"] == got.nbytes
        assert rec["total_bytes"] == got.nbytes


def test_reduce_scatter_limits_and_the_whole_grid_sum(worlds):
    """On an axis of size 1 ``reduce_scatter_sum`` is the float32 input
    itself; a dimension the line does not divide raises before any
    exchange; ``all_reduce_sum(t, mesh, None)`` sums over all four ranks
    as one counted all-reduce."""
    total = sum(u.rs_input(r) for r in range(WORLD))
    for rank, (arrays, scalars) in enumerate(worlds["ranks"]):
        assert scalars["rs/size1"] is True
        kind, msg = scalars["rs/indivisible"]
        assert kind == "ValueError" and "does not split into 2" in msg
        np.testing.assert_array_equal(arrays["rs/world_sum"], total)
        assert scalars["rs/world_sum"]["counts"]["all-reduce"] == 1
        assert scalars["rs/world_sum"]["total_bytes"] == total.nbytes


@pytest.mark.parametrize("dtype,zero1", u.LM_ZERO1_CASES, ids=_ZERO1_IDS)
def test_zero1_gradient_shards_equal_the_unsharded_reference(worlds, dtype,
                                                             zero1):
    """Each rank's gradients as the step hands them to ``adam_update``
    (reduced over ``data`` to the global batch's mean: with ZeRO-1 the
    reduce-scattered shard of its moments, else the all-reduced block)
    against ``jax.grad`` of the reference's unsharded ``model.loss`` over
    the whole batch, cut to the same block of the whole leaf, at 1e-4 in
    float32 and ``_BF16_TOL`` in bf16."""
    ref, _ = worlds["reference"]
    want_tag, tag = u.zero1_tag(dtype, True), u.zero1_tag(dtype, zero1)
    tol = _LM_TOL[dtype]
    for rank, (arrays, scalars) in enumerate(worlds["ranks"]):
        blocks = scalars[f"{tag}/blocks"]
        assert blocks
        for k, block in blocks.items():
            np.testing.assert_allclose(
                arrays[f"{tag}/grad/{k}"],
                _shard_of(ref[f"{want_tag}/grad/{k}"], block),
                err_msg=f"rank {rank} {k}", **tol)


@pytest.mark.parametrize("dtype,zero1", u.LM_ZERO1_CASES, ids=_ZERO1_IDS)
def test_a_zero1_train_step_equals_the_unsharded_reference(worlds, dtype,
                                                           zero1):
    """One microbatched step from zero moments on the 2 x 2 grid against
    the reference's ``make_train_step`` on the whole batch: the loss and
    the gradient norm on every rank, the count, each rank's blocks of
    the new parameters and its shards of ``m`` and ``v`` (the reference's
    whole moments cut to the shard's block), at 1e-4 in float32 and
    ``_BF16_TOL`` in bf16; the parameter blocks byte-equal along each
    ``data`` line."""
    from repro_torch.convert import lm_rank_state_dict_from_params, \
        nest_layers
    ref, _ = worlds["reference"]
    want_tag, tag = u.zero1_tag(dtype, True), u.zero1_tag(dtype, zero1)
    specs = _zero1_model().param_specs()
    tol = _LM_TOL[dtype]
    ref_params = nest_layers({k: ref[f"{want_tag}/params/{k}"] for k in
                              _train_keys(ref, want_tag, "params")})
    ranks = worlds["ranks"]
    for rank, (arrays, scalars) in enumerate(ranks):
        assert int(arrays[f"{tag}/count"]) == int(ref[f"{want_tag}/count"]) \
            == 1
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(arrays[f"{tag}/{k}"],
                                       ref[f"{want_tag}/{k}"],
                                       err_msg=f"rank {rank} {k}", **tol)
        want = lm_rank_state_dict_from_params(
            ref_params, specs, _At(_ZERO1_GRID, _coords(rank, _ZERO1_GRID)))
        assert sorted(want) == sorted(_train_keys(arrays, tag, "params"))
        partner = ranks[_data_partner(rank)][0]
        for k, w in want.items():
            got = arrays[f"{tag}/params/{k}"]
            np.testing.assert_allclose(got, w.numpy(),
                                       err_msg=f"rank {rank} {k}", **tol)
            assert np.array_equal(got, partner[f"{tag}/params/{k}"]), \
                (rank, k)
        for k, block in scalars[f"{tag}/blocks"].items():
            for mom in ("m", "v"):
                np.testing.assert_allclose(
                    arrays[f"{tag}/{mom}/{k}"],
                    _shard_of(ref[f"{want_tag}/{mom}/{k}"], block),
                    err_msg=f"rank {rank} {mom} {k}", **tol)


@pytest.mark.parametrize("zero1", [True, False], ids=["zero1", "whole"])
def test_a_rank_holds_its_zero1_shard_of_the_moments_and_nothing_else(
        worlds, zero1):
    """With ZeRO-1 on 2 x 2 every leaf's moments split over ``data`` on
    its layer axis (stacked layers) or another free dimension: a rank
    holds the moments of its data coordinate's layer and the shards of
    the embedding, the final norm and the head, and its moment bytes are
    the closed form's shard (``dryrun.step_arguments``' Adam records),
    half its parameter block's; with ``zero1`` off, its whole block."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapeCell
    cfg = u.lm_zero1_config(port_configs, "float32", zero1)
    model = _zero1_model()
    args = dryrun.step_arguments(
        cfg, ShapeCell("train_4k", u.LM_RUN_SEQ, u.LM_BATCH, "train"),
        dryrun.make_mesh(_ZERO1_GRID, u.AXES, device="cpu"), model)
    shard_bytes = dryrun._tree_bytes(args["opt_state"]["m"])
    tag = u.zero1_tag("float32", zero1)
    for rank, (arrays, scalars) in enumerate(worlds["ranks"]):
        held = sorted(scalars[f"{tag}/blocks"])
        param_bytes = sum(arrays[f"{tag}/params/{k}"].nbytes
                          for k in _train_keys(arrays, tag, "params"))
        m_bytes = sum(arrays[f"{tag}/m/{k}"].nbytes for k in held)
        if not zero1:
            assert held == sorted(_train_keys(arrays, tag, "params"))
            assert m_bytes == param_bytes
            continue
        layer = _coords(rank, _ZERO1_GRID)[0]
        assert {k.split(".")[1] for k in held
                if k.startswith("blocks.")} == {str(layer)}
        assert {k for k in held if not k.startswith("blocks.")} == {
            "embed", "ln_f.scale", "lm_head.w"}
        assert m_bytes == shard_bytes == param_bytes // 2


@pytest.mark.parametrize("zero1", [True, False], ids=["zero1", "whole"])
def test_a_2x2_train_run_counts_the_closed_forms_collectives(worlds, zero1):
    """``lower_cell(..., run=True, ranks=pm)`` of a train cell on the 2 x
    2 grid: no ``run_reason``, two rows a data coordinate, every rank's
    tally of one timed step equal to the closed form's
    ``collective_executed``: each microbatch's all-reduces over
    ``model`` (as on 1 x 4, for a data coordinate's rows), the qk norms'
    gradients, the loss over ``data`` and the norm; with ZeRO-1 one
    reduce-scatter and one all-gather a leaf of the reference's tree
    (14), else one all-reduce a leaf; and the run's checks, on every
    rank."""
    from repro_torch.launch import dryrun
    cfg = port_configs.get_smoke_config(u.LM_ARCH)
    layers_, nm = cfg.n_layers, u.LM_TRAIN_MICROBATCH
    leaves = 14
    name = "lm_zero1_run" if zero1 else "lm_zero1_run_whole"
    per_mb = 6 * layers_ + 5
    for rank, (arrays, scalars) in enumerate(worlds["ranks"]):
        run = scalars[name]
        assert run["run_reason"] is None
        assert run["run_batch"] == u.LM_BATCH // 2
        want = run["collective_executed"]
        assert dryrun.closed_form_mismatch(run["run_collective"], want,
                                           _ZERO1_GRID) is None
        assert all(c == want for c in run["run_collective"])
        split = leaves if zero1 else 0
        assert want["counts"] == dict(
            dict.fromkeys(dryrun.COLLECTIVE_KINDS, 0),
            **{"all-reduce": nm * per_mb + 3 + (leaves - split),
               "reduce-scatter": split, "all-gather": split})
        n = len(_train_keys(arrays, u.zero1_tag("float32", zero1),
                            "params"))
        model_sums = nm * per_mb + 1 + (0 if zero1 else 1)
        assert run["run_checks"] == ([
            "losses finite", "parameters finite",
            f"all {n} gradients non-zero before the update",
            f"all {n} parameters changed",
            f"{4 * layers_ + 1} replicated parameters equal on every rank "
            f"of a model line",
            f"all {n} parameter blocks equal on every rank of a data line",
            "loss and grad_norm equal on every rank",
            f"{model_sums} all-reduced tensors equal on every rank of a "
            f"model line",
            f"{1 + (0 if zero1 else leaves)} all-reduced tensors equal on "
            f"every rank of a data line"]
            + (["1 all-reduced tensors equal on every rank"] if zero1
               else [])
            + ["collectives equal to the closed form's"])


@pytest.mark.parametrize("where", ["shard update", "backward"])
def test_a_rank_that_fails_in_a_zero1_step_makes_every_rank_raise(worlds,
                                                                  where):
    """Rank 1 fails in its shard update (after the norm, before the
    all-gather over ``data``) or in its share of a backward sum (its
    ``model`` line raises there, the other line after its backward):
    every rank raises naming it, none left waiting in a collective."""
    key = ("lm_zero1_failure" if where == "shard update"
           else "lm_zero1_backward_failure")
    what = ("the ZeRO-1 shard update" if where == "shard update"
            else "the backward")
    planted = ("the planted shard failure" if where == "shard update"
               else "the planted backward failure")
    for rank, (_, scalars) in enumerate(worlds["ranks"]):
        kind, msg = scalars[key]
        assert kind == "RuntimeError", (rank, msg)
        assert f"{what} on ranks" in msg
        assert f"rank {u.LM_FAILING_RANK} failed (RuntimeError: " in msg
        assert planted in msg


# ---------------------------------------------------------------------------
# training the MoE and VLM families on ranks: u.FAMILY_TRAIN_CASES
# ---------------------------------------------------------------------------

_FAMILY_TRAIN = [case for case, _, _ in u.FAMILY_TRAIN_CASES]


def _family_specs(case):
    from repro_torch.models import build_model
    return build_model(u.family_train_config(port_configs, case, "float32"),
                       device="meta").param_specs()


@pytest.mark.parametrize("dtype", u.LM_DTYPES)
@pytest.mark.parametrize("case", _FAMILY_TRAIN)
def test_a_family_train_step_equals_the_unsharded_reference(worlds, case,
                                                            dtype):
    """One microbatched step from zero moments on ranks against the
    reference's unsharded ``make_train_step`` on the same weights and
    batch: the loss, the gradient norm and the count on every rank, each
    rank's blocks of the new parameters (the experts FFN-split or whole
    a rank, the router, LLaVA's projector: the reference's tree cut by
    ``convert.lm_rank_state_dict_from_params``) and of ``m`` and ``v``
    (``lm_rank_adam_state_from_params``; on 2 x 2 the ZeRO-1 shards, the
    stacked experts' moments split on their layer axis), at 1e-4 in
    float32 and ``_BF16_TOL`` in bf16; on 2 x 2 the parameter blocks
    byte-equal along each ``data`` line."""
    from repro_torch.convert import (lm_rank_adam_state_from_params,
                                     lm_rank_state_dict_from_params,
                                     nest_layers)
    ref, _ = worlds["reference"]
    _, arch, grid, _ = u.family_train_case(case)
    want_tag = u.family_train_tag(arch, dtype)
    tag = f"lm_family_train/{case}/{dtype}"
    specs = _family_specs(case)
    tol = _LM_TOL[dtype]

    def tree(name):
        return nest_layers({k: ref[f"{want_tag}/{name}/{k}"]
                            for k in _train_keys(ref, want_tag, name)})
    ref_params = tree("params")
    ref_state = {"m": tree("m"), "v": tree("v"),
                 "count": ref[f"{want_tag}/count"]}
    ranks = worlds["ranks"]
    zero1 = grid[0] > 1
    for rank, (arrays, scalars) in enumerate(ranks):
        at = _At(grid, _coords(rank, grid))
        assert int(arrays[f"{tag}/count"]) == int(ref_state["count"]) == 1
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(arrays[f"{tag}/{k}"],
                                       ref[f"{want_tag}/{k}"],
                                       err_msg=f"rank {rank} {k}", **tol)
        want = lm_rank_state_dict_from_params(ref_params, specs, at)
        assert sorted(want) == sorted(_train_keys(arrays, tag, "params"))
        for k, w in want.items():
            got = arrays[f"{tag}/params/{k}"]
            np.testing.assert_allclose(got, w.numpy(),
                                       err_msg=f"rank {rank} {k}", **tol)
            if zero1:
                partner = ranks[_data_partner(rank)][0]
                assert np.array_equal(got, partner[f"{tag}/params/{k}"]), \
                    (rank, k)
        if not zero1:
            state = lm_rank_adam_state_from_params(ref_state, specs, at)
            for k in want:
                for mom in ("m", "v"):
                    np.testing.assert_allclose(
                        arrays[f"{tag}/{mom}/{k}"], state[mom][k].numpy(),
                        err_msg=f"rank {rank} {mom} {k}", **tol)
            continue
        blocks = scalars[f"{tag}/blocks"]
        layer = _coords(rank, grid)[0]
        assert {k.split(".")[1] for k in blocks if ".moe." in k} == \
            {str(layer)}
        for k, block in blocks.items():
            for mom in ("m", "v"):
                np.testing.assert_allclose(
                    arrays[f"{tag}/{mom}/{k}"],
                    _shard_of(ref[f"{want_tag}/{mom}/{k}"], block),
                    err_msg=f"rank {rank} {mom} {k}", **tol)


# one train cell's calls a rank, counted by hand on the 2-layer smoke
# models with 2 microbatches: a MoE layer's all-reduces are its ``wo``,
# its shared experts' ``down`` and (FFN-split) the experts' gated sum, each
# in the forward and the remat recompute and once in the backward (where
# the gradient enters); expert-parallel layers move the rows by two
# all-to-alls a pass and all-gather the slices, both again in the
# backward (the reverse exchanges; the tokens' and gates' entry); a
# microbatch adds the embedding's sum, the loss's three statistics and
# the head's input gradient (and LLaVA's projector); on 2 x 2 each MoE
# layer's expert density crosses ``data`` in each forward pass; a step
# adds the norm (and on 2 x 2 the loss over ``data`` and a reduce-scatter
# and an all-gather for each of qwen2-moe's 16 leaves)
_FAMILY_RUN_COUNTS = {
    "moe-ffn-1x4": {"all-reduce": 2 * (9 * 2 + 5) + 1},
    "moe-ep-1x4": {"all-reduce": 2 * (6 * 2 + 5) + 1,
                   "all-gather": 2 * 3 * 2, "all-to-all": 2 * 6 * 2},
    "vlm-1x4": {"all-reduce": 2 * (6 * 2 + 5 + 1) + 1},
    "moe-ffn-2x2": {"all-reduce": 2 * (9 * 2 + 5 + 2 * 2) + 2,
                    "reduce-scatter": 16, "all-gather": 16}}


@pytest.mark.parametrize("case", _FAMILY_TRAIN)
def test_a_family_train_run_counts_the_closed_forms_collectives(worlds,
                                                                case):
    """``lower_cell(..., run=True, ranks=pm)`` of each family case's train
    cell: no ``run_reason``; every rank's tally of one timed step equals
    the closed form's ``collective_executed`` (``closed_form_mismatch``:
    calls and bytes rank by rank, the all-to-all's bytes over each
    ``model`` line), and its calls the hand count; the run's checks (the
    routings along each line for the MoE cases) on every rank."""
    from repro_torch.launch import dryrun
    _, _, grid, _ = u.family_train_case(case)
    for rank, (_, scalars) in enumerate(worlds["ranks"]):
        run = scalars[f"lm_family_train_run/{case}"]
        assert run["run_reason"] is None
        assert run["run_batch"] == u.LM_BATCH // grid[0]
        want = run["collective_executed"]
        assert dryrun.closed_form_mismatch(run["run_collective"], want,
                                           grid) is None
        assert want["counts"] == dict(dict.fromkeys(dryrun.COLLECTIVE_KINDS,
                                                    0),
                                      **_FAMILY_RUN_COUNTS[case])
        checks = run["run_checks"]
        assert checks[-1] == "collectives equal to the closed form's"
        assert any(c.endswith("gradients non-zero before the update")
                   for c in checks)
        assert any("routings" in c for c in checks) == case.startswith("moe")
        assert run["run_s"] is None


class _Ranked:
    """A stand-in for a model built with ``ranks`` on a (data, model)
    grid: what ``make_train_step`` reads before it refuses."""

    def __init__(self, grid):
        self.ranks = _At(grid, (0, 0))
        self.ranks.dims = tuple(grid)


@pytest.mark.parametrize("arch,over,grid,why", [
    ("qwen2-moe-a2.7b", {}, (1, 4), None),
    ("qwen2-moe-a2.7b", {"expert_sharding": "model+data"}, (1, 4), None),
    ("llava-next-mistral-7b", {}, (2, 2), None),
    ("qwen2-moe-a2.7b", {"moe_capacity": True}, (1, 4), "A10d-5c-3"),
    ("qwen2-moe-a2.7b", {"expert_sharding": "model+data"}, (2, 2),
     "A10d-5c-2"),
    ("arctic-480b", {}, (1, 4), "A10d-5b-3c"),
    ("falcon-mamba-7b", {}, (1, 4), "A10d-5b-3b"),
    ("recurrentgemma-2b", {}, (2, 2), "A10d-5b-3b"),
    ("whisper-large-v3", {}, (1, 4), "A10d-5b-3b")],
    ids=["moe-ffn", "moe-expert-parallel", "vlm", "capacity",
         "model+data-on-data-2", "8bit", "ssm", "hybrid", "encdec"])
def test_make_train_step_on_ranks_admits_moe_and_vlm_only(arch, over, grid,
                                                          why):
    """The rank step's refusals, before any collective: the MoE (both
    expert layouts) and VLM families train on ranks; 8-bit moments
    (arctic's config), capacity dispatch, ``"model+data"`` experts over
    a ``data`` axis above 1 and the Mamba, hybrid and Whisper families
    raise, each naming its ROADMAP item."""
    import dataclasses
    from repro_torch.train import train_step
    from repro_torch.train.optimizer import AdamConfig
    cfg = dataclasses.replace(port_configs.get_smoke_config(arch), **over)
    model = _Ranked(grid)
    opt = AdamConfig(use_8bit=cfg.opt_8bit)
    if why is None:
        assert train_step._rank_split(model, cfg, opt) is model.ranks
        return
    with pytest.raises(NotImplementedError, match=why):
        train_step.make_train_step(model, cfg, opt)


def test_a_rank_whose_expert_backward_fails_makes_every_rank_raise(worlds):
    """Rank 1's expert rows' vector-Jacobian product fails in the
    expert-parallel case's backward: it still joins the reverse
    exchange with its error, and every rank raises naming it, none left
    waiting in a collective until the group's timeout."""
    for rank, (_, scalars) in enumerate(worlds["ranks"]):
        kind, msg = scalars["lm_family_train_failure"]
        assert kind == "RuntimeError", (rank, msg)
        assert "the expert backward on ranks" in msg
        assert f"rank {u.LM_FAILING_RANK} failed (RuntimeError: the " \
            f"planted expert backward failure)" in msg


@pytest.mark.parametrize("route", ["all_gather_panel", "all_to_all_over",
                                   "decode"])
def test_a_collective_with_no_backward_refuses_autograd(route):
    """The collectives with no backward on ranks raise where autograd
    records their input, rather than return a tensor cut from the graph;
    outside autograd they run (on a stand-in mesh the refusal comes
    before any exchange)."""
    from repro_torch.models import build_model, layers
    at = _At((1, 4), (0, 1))
    x = torch.ones((2, 8), requires_grad=True) * 1.0
    if route == "all_gather_panel":
        def call():
            return coll.all_gather_panel(x, at, "model", dim=0)
    elif route == "all_to_all_over":
        def call():
            return coll.all_to_all_over(x, at, "model", [2, 0, 0, 0],
                                        [2, 0, 0, 0])
    else:
        cfg = port_configs.get_smoke_config(u.LM_ARCH)
        attn = build_model(cfg, device="cpu").blocks[0].attn
        h = torch.ones((1, 1, cfg.d_model), requires_grad=True) * 1.0
        cache = torch.zeros((1, 4, cfg.n_kv_heads, cfg.hd))

        def call():
            return layers._decode_on_ranks(attn, cfg, h, cache, cache.clone(),
                                           0, at)
    with pytest.raises(NotImplementedError, match="A10d-5b-3b"):
        call()


_A2A_CASES = [((1, 4), "model"), ((2, 2), "model"), ((2, 2), "data")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grid,axis", _A2A_CASES,
                         ids=[f"{g[0]}x{g[1]}-{a}" for g, a in _A2A_CASES])
def test_all_to_all_over_moves_uneven_rows(worlds, grid, axis, dtype):
    """``all_to_all_over`` along each line: coordinate i sends j
    ``(i + 2 j) % 3`` rows (none a normal case), and each rank gets its
    rows from every coordinate in coordinate order, counted as its
    result bytes."""
    n = dict(zip(u.AXES, grid))[axis]
    k = u.AXES.index(axis)
    lines = np.moveaxis(np.arange(WORLD).reshape(grid), k, -1).reshape(-1, n)
    size = 4 if dtype == "float32" else 2
    tag = f"a2a/{u.lm_key(grid)}/{axis}/{dtype}"
    for line in lines:
        for me, rank in enumerate(line):
            arrays, scalars = worlds["ranks"][rank]
            want = np.concatenate([u.a2a_rows(line[j], rank,
                                              u.a2a_count(j, me))
                                   for j in range(n)])
            assert np.array_equal(arrays[tag], want), (rank, tag)
            assert scalars["a2a_tally"][tag] == want.size * size


def test_an_all_to_all_whose_rank_fails_or_miscounts_raises_everywhere(
        worlds):
    """On 2 x 2 along ``model``: rank 1 passing an error, or expecting a
    row more than its peer sends, makes every rank of the world raise,
    the other line's too, before any row moves."""
    for rank, (_, scalars) in enumerate(worlds["ranks"]):
        kind, msg = scalars["a2a_failure"]
        assert kind == "RuntimeError"
        assert f"rank {u.LM_FAILING_RANK} failed (ValueError: a planted " \
            f"failure)" in msg, (rank, msg)
        kind, msg = scalars["a2a_unpaired"]
        assert kind == "RuntimeError" and "do not pair up" in msg, \
            (rank, msg)


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
