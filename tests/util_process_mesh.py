"""Both sides of ``tests/test_torch_process_mesh.py``, each run in its own
subprocesses.

* ``python tests/util_process_mesh.py RANK WORLD INIT_FILE OUT_DIR`` is
  one rank of a gloo world on the CPU (``file://`` init): it runs every
  case of the test module on ``repro_torch`` process meshes and writes
  ``rank<RANK>.npz`` (arrays) and ``rank<RANK>.json`` (scalars, error
  types and messages) into ``OUT_DIR``.
* ``run_reference(OUT_DIR)`` runs the same cases on the reference, in a
  process started with four forced host devices, and writes
  ``reference.npz`` / ``reference.json``.

The case lists below are shared by both and by the tests.
"""
import json
import operator
import os
import sys

import numpy as np

AXES = ("data", "model")
THRESHOLD_AXES = ("pod", "data", "model")
# m = 25: pads to 26 on 2 x 2 and to 28 on 1 x 4 / 4 x 1
CLOSURE_GRAPH = dict(n=30, m=25, seed=3)
CLOSURE_CASES = [(shape, schedule, rounds, "float32")
                 for shape in ((1, 4), (4, 1), (2, 2))
                 for schedule in ("allgather", "ring")
                 for rounds in (None, 1)] + [
    ((2, 2), "allgather", None, "int32"), ((2, 2), "ring", None, "int32"),
    ((1, 4), "ring", 1, "int32")]
# (grid, rounds, thresholds kept): an odd threshold count on pod = 2
THRESHOLD_CASES = [((1, 2, 2), None, None), ((2, 1, 2), None, 5),
                   ((2, 1, 2), 1, 3)]
ENGINE_GRAPH = dict(n=40, m=30, seed=5)
ENGINE_CASES = [((2, 2), "allgather"), ((2, 2), "ring"), ((1, 4), "ring"),
                ((4, 1), "allgather")]
S_VALUES = (1, 2, 3)
SCALAR_PAIRS = [(0, 1), (3, 7), (5, 5), (12, 39)]
# the block of tests/test_distributed.py::test_compressed_allreduce
COMPRESSION_BLOCK = 16
ERROR_NAMES = ("world_size", "trim", "service_mesh", "service_engine",
               "replicas", "save_index", "load_index", "restore",
               "index_store", "wal", "service_hl_index")
MESH_SHAPES = ((2, 2), (1, 4), (4, 1))
# six line-graph components of six hyperedges; one random component; a
# chain of one; no hyperedge at all
LABEL_GRAPHS = {"parts": None, "label": dict(n=50, m=36, seed=8),
                "chain": None, "empty": None}
# (shape, num_shards, minimize, graph): 8 shards clamp to the 6 components
BUILD_CASES = [(shape, None, True, "parts") for shape in MESH_SHAPES] + [
    ((2, 2), k, mini, "parts") for k in (1, 3, 8) for mini in (True, False)
] + [((2, 2), None, True, "label"), ((2, 2), None, True, "chain"),
     ((2, 2), 3, False, "chain"), ((2, 2), None, True, "empty")]
# neighbor_csr(mesh=): m = 37 (a multiple of no world size here), m = 3 < 4
NBR_GRAPHS = {"m37": dict(n=45, m=37, seed=4), "m3": dict(n=9, m=3, seed=2)}
NBR_CASES = [(shape, g) for shape in MESH_SHAPES for g in NBR_GRAPHS]
# its insert of [0, 1] re-derives 52 rows and keeps the padded geometry
TO_MESH_GRAPH = dict(n=60, m=30, seed=4)
# the update script every engine runs on ``update_graph()`` (8 clusters
# of 5 vertices and 4 hyperedges, so an edit has a scope of a few
# components): insert, delete, n growing, slot padding growing, a
# whole-graph scope, delete everything, insert again
UPDATE_GRAPH = dict(n=40, m=32)
# (kind, shape, schedule); "resident" closure engines are never queried
# until the script ends, so their W* blocks are patched (a queried one
# frees W* at its first snapshot and patches the snapshot only)
ENGINE_SCRIPT_CASES = (
    [("labels", shape, None) for shape in MESH_SHAPES]
    + [("closure", (2, 2), "allgather"), ("closure", (1, 4), "ring"),
       ("closure", (4, 1), "allgather"), ("resident", (2, 2), "ring"),
       ("resident", (1, 4), "allgather"), ("resident", (4, 1), "ring"),
       ("hl-index", (2, 2), None), ("hl-index-basic", (2, 2), None)])
SCRIPT_PAIRS = [(0, 1), (3, 7), (5, 5), (12, 39)]
# a W* of REGRID_M slots regridded to each padded size: one step of the
# lcm, and sizes whose new blocks span several old ones
REGRID_M = 10
REGRID_SIZES = (12, 24, 40)
REGRID_CASES = [(shape, mp) for shape in MESH_SHAPES for mp in REGRID_SIZES]
# the rank whose share of a build fails in the failure cases
FAILING_RANK = 1


def label_graph(name):
    """The graphs of ``BUILD_CASES`` (numpy only: both packages read
    them through their own ``from_edge_lists``)."""
    if name == "parts":
        rng = np.random.default_rng(8)
        edges = []
        for base in range(0, 60, 10):
            for _ in range(6):
                k = int(rng.integers(2, 5))
                edges.append(sorted(
                    (base + rng.choice(10, k, replace=False)).tolist()))
        return edges, 60
    if name == "chain":
        return [[i, i + 1, i + 2] for i in range(0, 40, 2)], 43
    if name == "empty":
        return [], 6
    return None


def update_graph():
    """``(edges, n)`` of the update script's graph."""
    edges = []
    for v in range(0, UPDATE_GRAPH["n"], 5):
        edges += [[v, v + 1, v + 2], [v + 1, v + 3], [v + 2, v + 3, v + 4],
                  [v, v + 4]]
    return edges, UPDATE_GRAPH["n"]


def update_script(n, m):
    """``(name, inserts, deletes)``; ``deletes`` ``"all"`` is every
    hyperedge at that step."""
    return [("insert", [[0, 1, 2]], []),
            ("delete", [], [0]),
            ("n_grows", [[3, n, n + 1]], []),
            ("padding", [[4, 5], [6, 7], [8, 9], [10, 11, 12]], [2]),
            ("whole", [list(range(n + 2))], []),
            ("delete_all", [], "all"),
            ("insert_again", [[1, 2], [2, 3]], [])]


def build_key(shape, num_shards, mini, graph):
    return f"{shape[0]}x{shape[1]}-{num_shards}-{mini}-{graph}"


def script_key(kind, shape, schedule):
    return f"{kind}-{shape[0]}x{shape[1]}-{schedule}"


def index_arrays(idx, prefix):
    """An ``HLIndex``'s arrays, ragged rows as (values, row lengths)."""
    out = {f"{prefix}/rank": np.asarray(idx.rank),
           f"{prefix}/perm": np.asarray(idx.perm)}
    for f in ("labels_edge", "labels_rank", "labels_s", "dual_u", "dual_s"):
        rows = getattr(idx, f)
        out[f"{prefix}/{f}/len"] = np.array([a.size for a in rows], np.int64)
        out[f"{prefix}/{f}"] = (np.concatenate(rows) if rows
                                else np.empty(0, np.int64))
        out[f"{prefix}/{f}/dtypes"] = np.array(
            sorted({str(a.dtype) for a in rows}))
    return out


def stats_of(stats):
    return {k: (float(v) if isinstance(v, (int, float, np.number))
                else v) for k, v in stats.items()}


def closure_key(shape, schedule, rounds, dtype):
    return f"{shape[0]}x{shape[1]}-{schedule}-{rounds}-{dtype}"


def threshold_key(grid, rounds, kept):
    return f"{'x'.join(map(str, grid))}-{rounds}-{kept}"


def engine_key(shape, schedule):
    return f"{shape[0]}x{shape[1]}-{schedule}"


def compression_tree():
    """The reference test's tree: four per-device slices per leaf."""
    rng = np.random.default_rng(0)
    return {"a": rng.normal(size=(4, 33)).astype(np.float32),
            "b": rng.normal(size=(4, 8, 9)).astype(np.float32)}


def line_graph(h, dtype):
    return h.line_graph(np.int32).astype(dtype)


def thresholds_of(w, kept):
    from repro_torch.core.semiring import distinct_thresholds
    thr = distinct_thresholds(w)
    return thr if kept is None else thr[:kept]


def all_pairs(n):
    us, vs = np.divmod(np.arange(n * n), n)
    return us.astype(np.int64), vs.astype(np.int64)


def _error(fn):
    """(type name, message) of what ``fn()`` raises, or ("none", "")."""
    try:
        fn()
    except Exception as exc:          # the test asserts the type
        return [type(exc).__name__, str(exc)]
    return ["none", ""]


def run_rank(rank: int, world: int, init_file: str, out_dir: str) -> None:
    import torch
    import torch.distributed as tdist

    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{init_file}",
                             rank=rank, world_size=world)
    try:
        arrays, scalars = _rank_cases(rank, out_dir)
    finally:
        tdist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(scalars, f)


def _rank_cases(rank: int, out_dir: str):
    import torch
    from repro_torch import api
    from repro_torch.core import distributed as dist
    from repro_torch.core.hlindex import build_sharded
    from repro_torch.core.hypergraph import neighbor_csr
    from repro_torch.distributed_lm import compressed_allreduce
    from repro_torch.kernels import maxmin_matmul as mm
    from repro_torch.train.optimizer import quantize_blockwise

    arrays, scalars = {}, {"rank": rank}
    meshes = {}

    def mesh(shape, axes=AXES):
        key = (tuple(shape), tuple(axes))
        if key not in meshes:
            meshes[key] = api.make_process_mesh(shape, axes, device="cpu")
        return meshes[key]

    # -- the mesh itself
    pm = mesh((2, 2))
    again = api.make_process_mesh((2, 2), AXES, device="cpu")
    logical = api.make_mesh((2, 2), AXES, device="cpu")
    scalars["mesh"] = {
        "coords": list(pm.coords), "rank": pm.rank, "backend": pm.backend,
        "shape": dict(pm.shape), "axis_names": list(pm.axis_names),
        "devices": [str(d) for d in pm.devices.flat],
        "devices_shape": list(pm.devices.shape),
        "device": str(pm.device),
        "axis_ranks": {a: list(pm.axis_ranks(a)) for a in AXES},
        "equal_again": pm == again and hash(pm) == hash(again),
        "equal_logical": pm == logical or logical == pm,
        "hash_logical": hash(pm) == hash(logical),
        "equal_other_shape": pm == mesh((1, 4)),
        "shape_is_read_only": _error(lambda: operator.setitem(
            pm.shape, "data", 3))[0] == "TypeError",
    }

    # -- closures, every case
    h = api.random_hypergraph(**CLOSURE_GRAPH)
    for shape, schedule, rounds, dtype in CLOSURE_CASES:
        key = closure_key(shape, schedule, rounds, dtype)
        w = line_graph(h, dtype)
        before = w.copy()
        blk = dist.sharded_maxmin_closure(w, mesh(shape), rounds=rounds,
                                          schedule=schedule, trim=False,
                                          use_kernels=True)
        arrays[f"closure/{key}/block"] = blk.numpy()
        arrays[f"closure/{key}/whole"] = dist.gather_blocks(
            blk, mesh(shape)).numpy()
        scalars.setdefault("closure_input_kept", []).append(
            bool(np.array_equal(w, before)))

    # one round's panels and contractions on each 2 x 2 schedule
    w = line_graph(h, "float32")
    reads = {}
    for schedule in ("allgather", "ring"):
        seen, calls = [], []

        def contract(a, b):
            calls.append([list(a.shape), list(b.shape),
                          a.is_contiguous() and b.is_contiguous()])
            return mm.maxmin_matmul(a, b)
        round_fn = dist.sharded_maxmin_round(
            pm, schedule=schedule, contract=contract,
            on_read=lambda kind, p: seen.append([kind, list(p.shape)]))
        blk = dist.block_of(w, pm, AXES)
        out = round_fn(blk)
        arrays[f"round/{schedule}"] = out.numpy()
        reads[schedule] = {"reads": seen, "calls": calls}
    scalars["round_reads"] = reads

    # -- the threshold closure MR
    for grid, rounds, kept in THRESHOLD_CASES:
        key = threshold_key(grid, rounds, kept)
        tm = mesh(grid, THRESHOLD_AXES)
        blk = dist.sharded_threshold_closure_mr(
            w, thresholds_of(w, kept), tm, rounds=rounds)
        arrays[f"threshold/{key}/block"] = blk.numpy()
        arrays[f"threshold/{key}/whole"] = dist.gather_blocks(
            blk, tm, THRESHOLD_AXES[1:]).numpy()

    # -- the sharded engine's closure regime through api.build
    he = api.random_hypergraph(**ENGINE_GRAPH)
    us, vs = all_pairs(he.n)
    engines = {}
    for shape, schedule in ENGINE_CASES:
        key = engine_key(shape, schedule)
        em = mesh(shape)
        eng = api.build_engine(he, "sharded", mesh=em, schedule=schedule,
                               use_kernels=True)
        info = {"name": eng.name, "device": str(eng.device),
                "plan": api.plan_backend(he, mesh=em,
                                         device_budget_bytes=0),
                "block_shape": list(eng._w_star.shape),
                "block_numel": int(eng._w_star.numel()),
                "m_padded": eng._m_padded,
                "nbytes_built": eng.nbytes(),
                "rank_nbytes_built": eng.rank_nbytes()}
        arrays[f"engine/{key}/block"] = eng._w_star.numpy()
        got = eng.mr_batch(us, vs)
        snap = eng.snapshot()
        info.update(
            version=eng.version, snapshot_shape=list(snap.ranks.shape),
            snapshot_nbytes=snap.nbytes(), snapshot_on=repr(snap.mesh),
            refresh_rows=eng.last_snapshot_refresh_rows,
            w_star_freed=eng._w_star is None, nbytes_served=eng.nbytes(),
            rank_nbytes_served=eng.rank_nbytes(), mr_dtype=str(got.dtype),
            mr=[eng.mr(u, v) for u, v in SCALAR_PAIRS],
            s_reach=[bool(eng.s_reach(u, v, 2)) for u, v in SCALAR_PAIRS])
        arrays[f"engine/{key}/mr_batch"] = got
        arrays[f"engine/{key}/svals"] = snap.svals.numpy()
        for s in S_VALUES:
            arrays[f"engine/{key}/s_reach_batch/{s}"] = \
                eng.s_reach_batch(us, vs, s)
        engines[key] = info
    scalars["engines"] = engines

    # -- compression: this rank's slice of every leaf
    cm = mesh((4,), ("data",))
    tree = compression_tree()
    out = compressed_allreduce(
        {k: torch.from_numpy(v[rank:rank + 1].copy())
         for k, v in tree.items()}, cm, "data", block=COMPRESSION_BLOCK)
    one_process = compressed_allreduce(
        {k: torch.from_numpy(v) for k, v in tree.items()},
        api.make_mesh((4,), ("data",), device="cpu"), "data",
        block=COMPRESSION_BLOCK)
    for k, v in tree.items():
        arrays[f"compression/{k}"] = out[k].numpy()
        arrays[f"compression/{k}/one_process"] = one_process[k].numpy()
        codes, scale = quantize_blockwise(
            torch.from_numpy(v[rank]), COMPRESSION_BLOCK)
        arrays[f"compression/{k}/codes"] = api_gather(codes, cm)
        arrays[f"compression/{k}/scales"] = api_gather(scale, cm)

    _a10d_rank_cases(api, mesh, rank, arrays, scalars)

    # -- what does not run on ranks, and the mesh's limits
    from repro_torch.store.wal import WriteAheadLog
    eng = api.build_engine(he, "sharded", mesh=pm, use_kernels=True)
    hl_eng = api.build_engine(he, "hl-index", mesh=pm)
    host_eng = api.build_engine(he, "sharded", mesh=logical)
    saved = os.path.join(out_dir, f"logical-{rank}.hlidx")
    api.save_index(saved, host_eng)
    errors = {
        "world_size": lambda: api.make_process_mesh((2, 3), AXES,
                                                    device="cpu"),
        "trim": lambda: dist.sharded_maxmin_closure(w, pm),
        "service_mesh": lambda: api.ReachabilityService(
            host_eng, mesh=pm, start=False),
        "service_engine": lambda: api.ReachabilityService(eng, start=False),
        "replicas": lambda: api.ReplicaGroup(eng, 2, start=False),
        "save_index": lambda: api.save_index(
            os.path.join(out_dir, f"rank-{rank}.hlidx"), eng),
        "load_index": lambda: api.load_index(saved, mesh=pm),
        "restore": lambda: api.build_engine(restore=saved, mesh=pm),
        "index_store": lambda: api.IndexStore(
            os.path.join(out_dir, f"store-{rank}")).attach(eng),
        "wal": lambda: hl_eng.attach_wal(WriteAheadLog(
            os.path.join(out_dir, f"wal-{rank}.log"))),
        "service_hl_index": lambda: api.ReachabilityService(
            hl_eng, start=False),
    }
    assert tuple(errors) == ERROR_NAMES
    scalars["errors"] = {k: _error(fn) for k, fn in errors.items()}
    scalars["update_left_engine"] = {"version": eng.version,
                                     "m": eng.h.m}
    scalars["store_left_nothing"] = not os.path.exists(
        os.path.join(out_dir, f"store-{rank}", "CURRENT"))
    return arrays, scalars


def _port_graph(api, name):
    edges = label_graph(name)
    if edges is None:
        return api.random_hypergraph(**LABEL_GRAPHS[name])
    return api.from_edge_lists(*edges)


def _port_engine(api, h, kind, mesh, schedule):
    if kind in ("hl-index", "hl-index-basic"):
        return api.build_engine(h, kind, mesh=mesh, use_kernels=True)
    if kind == "labels":
        return api.build_engine(h, "sharded", mesh=mesh, build_labels=True,
                                use_kernels=True)
    return api.build_engine(h, "sharded", mesh=mesh, schedule=schedule,
                            use_kernels=True)


def regrid_key(shape, mp):
    return f"{shape[0]}x{shape[1]}-{mp}"


def regrid_whole(mp):
    """The seeded [REGRID_M, REGRID_M] W* zero-padded to ``mp`` slots."""
    w = np.zeros((mp, mp), np.float32)
    w[:REGRID_M, :REGRID_M] = np.random.default_rng(11).integers(
        0, 5, (REGRID_M, REGRID_M))
    return w


def _failing_base(h, **kwargs):
    """``build_fast``, except on ``FAILING_RANK``, where the shard fails."""
    import torch.distributed as tdist
    from repro_torch.core.hlindex import build_fast
    if tdist.get_rank() == FAILING_RANK:
        raise ValueError(f"planted shard failure, {h.m} hyperedges")
    return build_fast(h, **kwargs)


def _failure_cases(api, mesh, rank, scalars):
    """A shard, and a rank's overlap rows, that fail on ``FAILING_RANK``:
    every rank raises, and the ranks then build together again."""
    from repro_torch.core.hlindex import build_sharded
    from repro_torch.core.hypergraph import neighbor_csr
    from repro_torch.kernels import overlap as ov

    h = _port_graph(api, "parts")
    pm = mesh((2, 2))

    def failing_rows(a, b):
        raise MemoryError("planted: no room for the overlap rows")
    plain_rows = ov.overlap_rows
    if rank == FAILING_RANK:
        ov.overlap_rows = failing_rows
    try:
        failures = {
            "build_sharded": _error(lambda: build_sharded(
                h, mesh=pm, num_shards=4, base=_failing_base)),
            "neighbor_csr": _error(lambda: neighbor_csr(h, mesh=pm))}
    finally:
        ov.overlap_rows = plain_rows
    after = build_sharded(h, mesh=pm, num_shards=4)
    scalars["failures"] = {
        "errors": failures,
        "after": [a.tolist() for a in after.labels_edge]}


def _a10d_rank_cases(api, mesh, rank, arrays, scalars):
    """The routes of A10d items 1-3 on ranks: ``build_sharded``,
    ``neighbor_csr(mesh=)``, ``to_mesh`` and every engine through the
    update script, and the divergent-edit guard."""
    import torch
    from repro_torch.core import distributed as dist
    from repro_torch.core.hlindex import build_sharded
    from repro_torch.core.hypergraph import neighbor_csr
    from repro_torch.core.minimal import minimize

    builds = {}
    for shape, k, mini, g in BUILD_CASES:
        key = build_key(shape, k, mini, g)
        idx = build_sharded(_port_graph(api, g), mesh=mesh(shape),
                            num_shards=k,
                            minimizer=minimize if mini else None)
        arrays.update(index_arrays(idx, f"build/{key}"))
        builds[key] = stats_of(idx.stats)
    scalars["builds"] = builds

    for shape, g in NBR_CASES:
        nbr = neighbor_csr(api.random_hypergraph(**NBR_GRAPHS[g]),
                           mesh=mesh(shape))
        for f in ("ptr", "idx", "od"):
            arrays[f"nbr/{shape[0]}x{shape[1]}-{g}/{f}"] = getattr(nbr, f)

    ht = api.random_hypergraph(**TO_MESH_GRAPH)
    flat = api.build_engine(ht, "hl-index", device="cpu")
    snap1 = flat.snapshot()
    flat.update(inserts=[[0, 1]])
    dirty = flat.dirty_rows()
    snap2 = flat.snapshot()
    to_mesh = {}
    for shape in MESH_SHAPES:
        key = f"{shape[0]}x{shape[1]}"
        pm = mesh(shape)
        b1 = snap1.to_mesh(pm)
        for f in ("ranks", "svals", "lengths"):
            arrays[f"to_mesh/{key}/full/{f}"] = getattr(b1, f).numpy().copy()
        kept = [t.clone() for t in (b1.ranks, b1.svals, b1.lengths)]
        b2 = snap2.to_mesh(pm, base=b1, dirty_rows=dirty)
        b1_kept = all(torch.equal(a, b) for a, b in zip(
            kept, (b1.ranks, b1.svals, b1.lengths)))
        whole = snap2.to_mesh(pm)
        donated = snap2.to_mesh(pm, base=b1, dirty_rows=dirty,
                                donate_base=True)
        for f in ("ranks", "svals", "lengths"):
            arrays[f"to_mesh/{key}/dirty/{f}"] = getattr(b2, f).numpy()
        to_mesh[key] = {
            "whole_shape": list(b2.whole_shape),
            "padded_shape": list(b2.padded_shape),
            "geometry_kept": b1.padded_shape == whole.padded_shape,
            "base_kept": b1_kept,
            "dirty_equals_whole": all(torch.equal(getattr(b2, f),
                                                  getattr(whole, f))
                                      for f in ("ranks", "svals",
                                                "lengths")),
            "donated_equals_whole": all(torch.equal(getattr(donated, f),
                                                    getattr(whole, f))
                                        for f in ("ranks", "svals",
                                                  "lengths")),
            "donated_in_place": donated.ranks is b1.ranks,
            "nbytes": b2.nbytes(), "rank_nbytes": b2.rank_nbytes(),
            "on": repr(b2.mesh), "block": b2.block}
    scalars["to_mesh"] = to_mesh

    hu = api.from_edge_lists(*update_graph())
    scripts = {}
    for kind, shape, schedule in ENGINE_SCRIPT_CASES:
        key = script_key(kind, shape, schedule)
        pm = mesh(shape)
        eng = _port_engine(api, hu, kind, pm, schedule)
        if kind != "resident":
            eng.mr_batch(*all_pairs(eng.h.n))     # a snapshot to patch
        steps = []
        for i, (name, ins, dels) in enumerate(update_script(hu.n, hu.m)):
            if dels == "all":
                dels = list(range(eng.h.m))
            eng.update(inserts=ins, deletes=dels)
            dirty = eng.dirty_rows()
            step = {"name": name, "version": eng.version, "n": eng.h.n,
                    "m": eng.h.m,
                    "dirty": None if dirty is None else dirty.tolist()}
            tag = f"script/{key}/{i}"
            if kind == "resident":
                step.update(m_padded=eng._m_padded,
                            slot_of=eng._slot_of.tolist(),
                            block_shape=list(eng._w_star.shape),
                            regrid_bytes=eng.last_regrid_bytes)
                arrays[f"{tag}/block"] = eng._w_star.numpy().copy()
                arrays[f"{tag}/whole"] = dist.gather_blocks(
                    eng._w_star, pm).numpy()
            else:
                us, vs = all_pairs(eng.h.n)
                arrays[f"{tag}/mr"] = eng.mr_batch(us, vs)
                arrays[f"{tag}/s2"] = eng.s_reach_batch(us, vs, 2)
                snap = eng.snapshot()
                step.update(refresh=eng.last_snapshot_refresh_rows,
                            nbytes=eng.nbytes(),
                            snapshot_shape=list(snap.global_shape),
                            block=snap.block,
                            mr=[eng.mr(u, v) for u, v in SCRIPT_PAIRS],
                            s_reach=[bool(eng.s_reach(u, v, 2))
                                     for u, v in SCRIPT_PAIRS])
                for f in ("ranks", "svals", "lengths"):
                    arrays[f"{tag}/snap/{f}"] = getattr(snap, f).numpy()
                idx = getattr(eng, "idx", None) or getattr(eng, "_idx",
                                                            None)
                if idx is not None:
                    arrays.update(index_arrays(idx, f"{tag}/idx"))
                    step["stats"] = stats_of(idx.stats)
            steps.append(step)
        if kind == "resident":
            arrays[f"script/{key}/final_mr"] = eng.mr_batch(
                *all_pairs(eng.h.n))
        scripts[key] = {"steps": steps, "rank_mesh": repr(eng.rank_mesh)}
    scalars["scripts"] = scripts

    # the divergent-edit guard: rank 0 passes other edits
    guard = {}
    for kind in ("labels", "closure", "hl-index"):
        eng = _port_engine(api, hu, kind, mesh((2, 2)), "allgather")
        eng.mr_batch([0], [1])
        # ids held to n on every rank before any collective or launch
        out_of_range = [_error(lambda: eng.mr_batch([0], [eng.h.n])),
                        _error(lambda: eng.snapshot().mr([0], [10**6]))]
        mine = [[0, 2]] if rank == 0 else [[0, 1]]
        error = _error(lambda: eng.update(inserts=mine))
        left = {"version": eng.version, "m": eng.h.m,
                "dirty": eng.dirty_rows().tolist()}
        eng.update(inserts=[[0, 1]])
        guard[kind] = {"error": error, "left": left,
                       "out_of_range": [e[0] for e in out_of_range],
                       "agreed": {"version": eng.version, "m": eng.h.m},
                       "mr": eng.mr_batch([0, 1], [1, 0]).tolist()}
    scalars["guard"] = guard

    regrid = {}
    for shape, mp in REGRID_CASES:
        pm = mesh(shape)
        block = dist.block_of(regrid_whole(REGRID_M), pm)
        grown, received = dist.regrid_block(block, pm, mp)
        arrays[f"regrid/{regrid_key(shape, mp)}"] = grown.numpy()
        regrid[regrid_key(shape, mp)] = received
    scalars["regrid_bytes"] = regrid
    _failure_cases(api, mesh, rank, scalars)


def api_gather(t, mesh):
    """Every rank's ``t`` stacked in rank order along a new first axis."""
    from repro_torch.core.collectives import all_gather_panel
    return all_gather_panel(t[None], mesh, "data", dim=0).numpy()


def run_reference(out_dir: str) -> None:
    """The same cases on the reference over four host devices (the
    process must start with ``--xla_force_host_platform_device_count=4``)."""
    import jax
    import jax.numpy as jnp
    from repro.api import build_engine, plan_backend
    from repro.core import random_hypergraph
    from repro.core.distributed import (sharded_maxmin_closure,
                                        sharded_threshold_closure_mr)
    from repro.core.semiring import distinct_thresholds
    from repro.distributed_lm import compressed_allreduce
    from repro.launch.mesh import make_test_mesh
    from repro.train.optimizer import quantize_blockwise

    assert jax.device_count() == 4, jax.devices()
    arrays, scalars = {}, {}
    h = random_hypergraph(**CLOSURE_GRAPH)
    for shape, schedule, rounds, dtype in CLOSURE_CASES:
        w = line_graph(h, dtype)
        arrays[f"closure/{closure_key(shape, schedule, rounds, dtype)}"] = \
            np.asarray(sharded_maxmin_closure(
                w, make_test_mesh(shape, AXES), schedule=schedule,
                rounds=rounds, trim=False))
    w = line_graph(h, "float32")
    for grid, rounds, kept in THRESHOLD_CASES:
        thr = distinct_thresholds(w)
        thr = thr if kept is None else thr[:kept]
        arrays[f"threshold/{threshold_key(grid, rounds, kept)}"] = \
            np.asarray(sharded_threshold_closure_mr(
                w, thr, make_test_mesh(grid, THRESHOLD_AXES),
                rounds=rounds))
    arrays["threshold_counts"] = np.array(
        [(distinct_thresholds(w) if kept is None
          else distinct_thresholds(w)[:kept]).size
         for _, _, kept in THRESHOLD_CASES])
    he = random_hypergraph(**ENGINE_GRAPH)
    us, vs = all_pairs(he.n)
    engines = {}
    for shape, schedule in ENGINE_CASES:
        key = engine_key(shape, schedule)
        mesh = make_test_mesh(shape, AXES)
        eng = build_engine(he, "sharded", mesh=mesh, schedule=schedule)
        info = {"name": eng.name,
                "plan": plan_backend(he, mesh=mesh, device_budget_bytes=0),
                "m_padded": eng._m_padded, "nbytes_built": eng.nbytes()}
        got = eng.mr_batch(us, vs)
        snap = eng.snapshot()
        info.update(
            version=eng.version, snapshot_shape=list(snap.ranks.shape),
            snapshot_nbytes=snap.nbytes(),
            refresh_rows=eng.last_snapshot_refresh_rows,
            w_star_freed=eng._w_star is None, nbytes_served=eng.nbytes(),
            mr_dtype=str(got.dtype),
            mr=[eng.mr(u, v) for u, v in SCALAR_PAIRS],
            s_reach=[bool(eng.s_reach(u, v, 2)) for u, v in SCALAR_PAIRS])
        arrays[f"engine/{key}/mr_batch"] = got
        arrays[f"engine/{key}/svals"] = np.asarray(snap.svals)
        for s in S_VALUES:
            arrays[f"engine/{key}/s_reach_batch/{s}"] = np.asarray(
                eng.s_reach_batch(us, vs, s))
        engines[key] = info
    scalars["engines"] = engines
    tree = compression_tree()
    out = compressed_allreduce({k: jnp.asarray(v) for k, v in tree.items()},
                               make_test_mesh((4,), ("data",)), "data",
                               block=COMPRESSION_BLOCK)
    for k, v in tree.items():
        arrays[f"compression/{k}"] = np.asarray(out[k])
        pairs = [quantize_blockwise(jnp.asarray(v[i]), COMPRESSION_BLOCK)
                 for i in range(v.shape[0])]
        arrays[f"compression/{k}/codes"] = np.stack(
            [np.asarray(c) for c, _ in pairs])
        arrays[f"compression/{k}/scales"] = np.stack(
            [np.asarray(s) for _, s in pairs])
    _a10d_reference_cases(arrays, scalars)
    np.savez(os.path.join(out_dir, "reference.npz"), **arrays)
    with open(os.path.join(out_dir, "reference.json"), "w") as f:
        json.dump(scalars, f)


def _reference_shards(arr, mesh):
    """{"i_j": the shard on the device at mesh coordinates (i, j)}."""
    where = {d.id: np.unravel_index(k, mesh.devices.shape)
             for k, d in enumerate(mesh.devices.flat)}
    return {"_".join(map(str, where[sh.device.id])): np.asarray(sh.data)
            for sh in arr.addressable_shards}


def _a10d_reference_cases(arrays, scalars):
    """``_a10d_rank_cases`` on the reference over four host devices."""
    from repro.api import build_engine
    from repro.core import from_edge_lists, random_hypergraph
    from repro.core.distributed import ShardedEngine
    from repro.core.hlindex import build_sharded
    from repro.core.hypergraph import neighbor_csr
    from repro.core.minimal import minimize
    from repro.launch.mesh import make_test_mesh

    def graph(name):
        edges = label_graph(name)
        if edges is None:
            return random_hypergraph(**LABEL_GRAPHS[name])
        return from_edge_lists(*edges)

    builds = {}
    for shape, k, mini, g in BUILD_CASES:
        key = build_key(shape, k, mini, g)
        idx = build_sharded(graph(g), mesh=make_test_mesh(shape, AXES),
                            num_shards=k,
                            minimizer=minimize if mini else None)
        arrays.update(index_arrays(idx, f"build/{key}"))
        builds[key] = stats_of(idx.stats)
    scalars["builds"] = builds

    for shape, g in NBR_CASES:
        nbr = neighbor_csr(random_hypergraph(**NBR_GRAPHS[g]),
                           mesh=make_test_mesh(shape, AXES))
        for f in ("ptr", "idx", "od"):
            arrays[f"nbr/{shape[0]}x{shape[1]}-{g}/{f}"] = np.asarray(
                getattr(nbr, f))

    flat = build_engine(random_hypergraph(**TO_MESH_GRAPH), "hl-index")
    snap1 = flat.snapshot()
    flat.update(inserts=[[0, 1]])
    dirty = flat.dirty_rows()
    snap2 = flat.snapshot()
    to_mesh = {}
    for shape in MESH_SHAPES:
        key = f"{shape[0]}x{shape[1]}"
        mesh = make_test_mesh(shape, AXES)
        b1 = snap1.to_mesh(mesh)
        b2 = snap2.to_mesh(mesh, base=b1, dirty_rows=dirty)
        for tag, snap in (("full", b1), ("dirty", b2)):
            for f in ("ranks", "svals", "lengths"):
                for at, block in _reference_shards(getattr(snap, f),
                                                   mesh).items():
                    arrays[f"to_mesh/{key}/{tag}/{f}/{at}"] = block
        to_mesh[key] = {"shape": list(b2.ranks.shape),
                        "nbytes": int(b2.nbytes())}
    scalars["to_mesh"] = to_mesh

    hu = from_edge_lists(*update_graph())
    scripts = {}
    for kind, shape, schedule in ENGINE_SCRIPT_CASES:
        key = script_key(kind, shape, schedule)
        mesh = make_test_mesh(shape, AXES)
        if kind in ("hl-index", "hl-index-basic"):
            eng = build_engine(hu, kind, mesh=mesh, use_kernels=True)
        elif kind == "labels":
            eng = ShardedEngine.build(hu, mesh=mesh, build_labels=True)
        else:
            eng = ShardedEngine.build(hu, mesh=mesh, schedule=schedule)
        if kind != "resident":
            eng.mr_batch(*all_pairs(eng.h.n))
        steps = []
        for i, (name, ins, dels) in enumerate(update_script(hu.n, hu.m)):
            if dels == "all":
                dels = list(range(eng.h.m))
            eng.update(inserts=ins, deletes=dels)
            dirty = eng.dirty_rows()
            step = {"name": name, "version": eng.version, "n": eng.h.n,
                    "m": eng.h.m,
                    "dirty": None if dirty is None else
                    np.asarray(dirty).tolist()}
            tag = f"script/{key}/{i}"
            if kind == "resident":
                step.update(m_padded=eng._m_padded,
                            slot_of=np.asarray(eng._slot_of).tolist())
                arrays[f"{tag}/whole"] = np.asarray(eng._w_star)
            else:
                us, vs = all_pairs(eng.h.n)
                arrays[f"{tag}/mr"] = np.asarray(eng.mr_batch(us, vs))
                arrays[f"{tag}/s2"] = np.asarray(
                    eng.s_reach_batch(us, vs, 2))
                snap = eng.snapshot()
                step.update(refresh=eng.last_snapshot_refresh_rows,
                            nbytes=int(eng.nbytes()),
                            snapshot_shape=list(snap.ranks.shape),
                            mr=[int(eng.mr(u, v)) for u, v in SCRIPT_PAIRS],
                            s_reach=[bool(eng.s_reach(u, v, 2))
                                     for u, v in SCRIPT_PAIRS])
                for f in ("ranks", "svals", "lengths"):
                    arrays[f"{tag}/snap/{f}"] = np.asarray(getattr(snap, f))
                idx = getattr(eng, "idx", None) or getattr(eng, "_idx",
                                                            None)
                if idx is not None:
                    arrays.update(index_arrays(idx, f"{tag}/idx"))
                    step["stats"] = stats_of(idx.stats)
            steps.append(step)
        if kind == "resident":
            arrays[f"script/{key}/final_mr"] = np.asarray(
                eng.mr_batch(*all_pairs(eng.h.n)))
        scripts[key] = {"steps": steps}
    scalars["scripts"] = scripts


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "src"))
    run_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
