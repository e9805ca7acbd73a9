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
ERROR_NAMES = ("world_size", "trim")
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
# serving on ranks (A10d item 2): (engine, grid, service mesh) over
# ``update_graph()``; rank 0 leads, the others follow
SERVE_CASES = [("labels", (2, 2), True), ("labels", (1, 4), True),
               ("labels", (4, 1), True), ("closure", (2, 2), True),
               ("hl-index", (2, 2), True), ("hl-index", (2, 2), False),
               ("single", (2, 2), True)]
SERVE_TENANTS = (("a", 1.0), ("b", 2.0))
SERVE_MAX_BATCH = 32
SERVE_REQUESTS = 24
SERVE_SEED = 29
# three replicas over an engine whose snapshot is whole on every rank,
# and over one whose snapshot is already blocks of the mesh
REPLICA_CASES = ("hl-index", "labels")
REPLICAS = 3
# the world's process-group timeout (a service's keep-alive interval is
# a quarter of it); the threaded leader's keep-alive interval, set small,
# and how long it idles
WORLD_TIMEOUT_S = 400
KEEPALIVE_S = 0.05
IDLE_S = 0.4
# the store on ranks (A10d item 4), each after the update script's first
# STORE_STEPS steps on 2 x 2: (payload or backend, update_script kind)
STORE_CASES = [("labels", "labels"), ("closure", "resident"),
               ("snapshot", "closure"), ("hl-index", "hl-index"),
               ("hl-index-basic", "hl-index-basic")]
STORE_STEPS = 4
STORE_MORE = [[5, 6, 7]]
# the journaled updates of the IndexStore case
JOURNAL_EDITS = [([[7, 8, 9]], []), ([[1, 11]], [3])]


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


def serve_edits(n):
    """The updates sent through a service between its request rounds:
    an insert, a delete, and an insert that grows ``n``."""
    return [([[0, 1, 2]], []), ([], [0]), ([[3, n, n + 1]], [])]


def serve_requests(n, rng, count):
    """``(kind, fields, tenant, priority)`` specs of every request kind
    over two tenants, which both packages build alike (the twin-service
    request mix of ``tests/test_torch_serving.py``, with the five
    workload kinds)."""
    specs = []
    for _ in range(count):
        u, v = int(rng.integers(n)), int(rng.integers(n))
        tenant = SERVE_TENANTS[int(rng.integers(2))][0]
        prio = ("interactive", "standard", "batch")[int(rng.integers(3))]
        x = rng.random()
        if x < 0.4:
            kind, fields = "mr", (u, v)
        elif x < 0.7:
            kind, fields = "s_reach", (u, v, int(rng.integers(1, 6)))
        elif x < 0.76:
            kind, fields = "witness", (u, v)
        elif x < 0.82:
            kind, fields = "s_reach_k", (u, v, int(rng.integers(1, 4)),
                                         int(rng.integers(1, 5)))
        elif x < 0.88:
            kind, fields = "mr_set", (
                tuple(int(a) for a in rng.choice(n, 3, replace=False)),
                tuple(int(a) for a in rng.choice(n, 2, replace=False)))
        elif x < 0.94:
            kind, fields = "top_s", (u, int(rng.integers(1, 6)))
        else:
            kind, fields = "s_distance", (u, v, int(rng.integers(1, 4)))
        specs.append((kind, fields, tenant, prio))
    return specs


_REQUEST_CLASSES = {"mr": "MRRequest", "s_reach": "SReachRequest",
                    "witness": "WitnessRequest",
                    "s_reach_k": "SReachKRequest", "mr_set": "MRSetRequest",
                    "top_s": "TopSRequest", "s_distance": "SDistanceRequest"}


def build_request(api, spec):
    kind, fields, tenant, prio = spec
    return getattr(api, _REQUEST_CLASSES[kind])(*fields, tenant=tenant,
                                                priority=prio)


def answer_json(x):
    """An answer as JSON: a witness as ``[u, v, s, walk]``, a top-s
    ranking as pairs."""
    if hasattr(x, "walk"):
        return [int(x.u), int(x.v), int(x.s), [int(e) for e in x.walk]]
    if isinstance(x, tuple):
        return [answer_json(y) for y in x]
    if isinstance(x, (bool, np.bool_)):
        return bool(x)
    return int(x)


def serve_key(kind, shape, with_mesh):
    return f"{kind}-{shape[0]}x{shape[1]}-{'mesh' if with_mesh else 'nomesh'}"


def serve_script(api, svc, n0):
    """The leader's side of a serving case: rounds of requests (two
    micro-batches one at a time, then the rest), each followed by an
    update through the service.  Returns the answers per round."""
    rng = np.random.default_rng(SERVE_SEED)
    rounds = []
    for ins, dels in serve_edits(n0):
        specs = serve_requests(svc.engine.h.n, rng, SERVE_REQUESTS)
        futs = svc.submit_many([build_request(api, s) for s in specs])
        first = svc.drain(max_batches=2)
        svc.drain()
        rounds.append({"first": first, "answers": [
            answer_json(f.result(timeout=60)) for f in futs]})
        svc.update(inserts=ins, deletes=dels)
    return rounds


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
    import datetime

    import torch
    import torch.distributed as tdist

    torch.set_num_threads(1)
    tdist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S))
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
    _serving_rank_cases(api, mesh, rank, arrays, scalars)
    _store_rank_cases(api, mesh, rank, out_dir, arrays, scalars)

    # -- the mesh's limits
    eng = api.build_engine(he, "sharded", mesh=pm, use_kernels=True)
    errors = {
        "world_size": lambda: api.make_process_mesh((2, 3), AXES,
                                                    device="cpu"),
        "trim": lambda: dist.sharded_maxmin_closure(w, pm),
    }
    assert tuple(errors) == ERROR_NAMES
    scalars["errors"] = {k: _error(fn) for k, fn in errors.items()}
    scalars["update_left_engine"] = {"version": eng.version,
                                     "m": eng.h.m}
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


# the dispatch-side fields of ``ServiceStats``: what a follower counts
DISPATCH_FIELDS = ("answered", "batches", "padded_queries",
                   "bucket_histogram", "snapshot_refreshes", "rows_rederived",
                   "rows_full", "mesh_rows_patched", "kernel_batches",
                   "workload_answered", "updates")


def _serving_engine(api, h, kind, pm):
    """The engine of a serving case on ranks (``single``: one process's
    engine on the CPU, taken over by the ranks of the service)."""
    if kind == "labels":
        return api.build_engine(h, "sharded", mesh=pm, build_labels=True,
                                use_kernels=True)
    if kind == "closure":
        return api.build_engine(h, "sharded", mesh=pm, use_kernels=True)
    if kind == "single":
        return api.build_engine(h, "hl-index", device="cpu",
                                use_kernels=True)
    return api.build_engine(h, kind, mesh=pm, use_kernels=True)


def _port_config(api, **kw):
    return api.ServiceConfig(
        max_batch=SERVE_MAX_BATCH, use_kernels=True,
        tenants=tuple(api.TenantSpec(t, w) for t, w in SERVE_TENANTS), **kw)


def _lead_or_follow(svc, lead):
    """Rank 0 runs ``lead(svc)`` and closes the service (also when
    ``lead`` raises, so no follower is left waiting); the others follow
    until it closes.  Returns ``lead``'s result, or ``None``."""
    if not svc.leader:
        svc.follow()
        return None
    try:
        return lead(svc)
    finally:
        svc.close()


def _service_record(svc, result):
    return {"result": result, "stats": svc.stats().as_dict(),
            "events": dict(svc._stream.by_kind), "seq": svc._stream.seq,
            "failed_events": svc.failed_events, "leader": svc.leader}


class _Count:
    """Calls of ``owner.name`` (wrapped in place) while in ``with``."""

    def __init__(self, owner, name):
        self.owner, self.name, self.calls = owner, name, 0

    def __enter__(self):
        self.plain = getattr(self.owner, self.name)

        def counted(*args, **kw):
            self.calls += 1
            return self.plain(*args, **kw)
        setattr(self.owner, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.plain)


def _serving_rank_cases(api, mesh, rank, arrays, scalars):
    """A10d item 2 on ranks: services over every engine of
    ``SERVE_CASES``, ``ReplicaGroup`` copies, a threaded leader idling
    across keep-alives, and the failures."""
    import time
    from concurrent.futures import Future
    from repro_torch.core.query import DeviceSnapshot
    from repro_torch.serve.scheduler import _Entry

    hu = api.from_edge_lists(*update_graph())
    serving = {}
    for kind, shape, with_mesh in SERVE_CASES:
        pm = mesh(shape)
        eng = _serving_engine(api, hu, kind, pm)
        svc = api.serve(eng, mesh=pm if with_mesh else None,
                        config=_port_config(api), start=False)
        rounds = _lead_or_follow(svc, lambda s: serve_script(api, s, hu.n))
        serving[serve_key(kind, shape, with_mesh)] = dict(
            _service_record(svc, rounds),
            on_mesh=repr(getattr(svc._snap, "mesh", None)),
            block=bool(getattr(svc._snap, "block", False)))
    scalars["serving"] = serving

    pm = mesh((2, 2))
    replicas = {}
    for kind in REPLICA_CASES:
        eng = _serving_engine(api, hu, kind, pm)
        grp = api.serve(eng, config=_port_config(api, replicas=REPLICAS),
                        start=False)
        rounds = _lead_or_follow(grp, lambda s: serve_script(api, s, hu.n))
        own = eng.snapshot_cache()
        ptrs = [r.snap.ranks.data_ptr() for r in grp.replicas]
        replicas[kind] = dict(
            _service_record(grp, rounds), replica_stats=grp.replica_stats(),
            mesh=repr(grp.mesh),
            private=len(set(ptrs)) == len(ptrs)
            and own.ranks.data_ptr() not in ptrs
            and own.svals.data_ptr() not in
            [r.snap.svals.data_ptr() for r in grp.replicas])
        for i, r in enumerate(grp.replicas):
            for f in ("ranks", "svals", "lengths"):
                arrays[f"replicas/{kind}/{i}/{f}"] = \
                    getattr(r.snap, f).numpy().copy()
    scalars["replicas"] = replicas

    # the threaded leader: the synchronous labels-2x2 run's requests and
    # updates, then an idle spell of several keep-alive intervals; then
    # a request that lands while close() drains, and requests after it
    eng = _serving_engine(api, hu, "labels", pm)
    svc = api.serve(eng, config=_port_config(api), start=False)
    keepalive_read = svc.keepalive_s
    svc.keepalive_s = KEEPALIVE_S
    closing = []

    def threaded(s):
        s.start()
        rng = np.random.default_rng(SERVE_SEED)
        rounds = []
        for ins, dels in serve_edits(hu.n):
            specs = serve_requests(s.engine.h.n, rng, SERVE_REQUESTS)
            futs = s.submit_many([build_request(api, x) for x in specs])
            rounds.append([answer_json(f.result(timeout=60)) for f in futs])
            s.update(inserts=ins, deletes=dels)
        sent = s._stream.by_kind["keepalive"]
        time.sleep(IDLE_S)
        futs = [s.mr(u, v) for u, v in SCRIPT_PAIRS]

        def drain_then_submit(*args, **kwargs):
            closing.append(_error(lambda: s.submit(api.MRRequest(0, 1))))
            return type(s).drain(s, *args, **kwargs)
        s.drain = drain_then_submit           # close()'s last drain
        return {"rounds": rounds,
                "after_idle": [f.result(timeout=60) for f in futs],
                "host_mr": [eng.mr(u, v) for u, v in SCRIPT_PAIRS],
                "keepalives_while_idle":
                    s._stream.by_kind["keepalive"] - sent}
    scalars["threaded"] = _service_record(svc, _lead_or_follow(svc,
                                                               threaded))
    scalars["threaded"]["keepalive_read"] = keepalive_read
    if svc.leader:
        del svc.drain                         # the class's drain again
        late = Future()
        svc._dispatch([_Entry(api.MRRequest(0, 1), late, time.monotonic(),
                              None)])
        scalars["threaded"]["after_close"] = {
            "while_closing": closing,
            "submit": _error(lambda: svc.submit(api.MRRequest(0, 1))),
            "update": _error(lambda: svc.update(inserts=[[0, 1]])),
            "dispatch": _error(lambda: late.result(timeout=60)),
            "drain": svc.drain(),
            "seq": svc._stream.seq}

    # failures: a batch failing on FAILING_RANK after its join, a request
    # past n at admission, a batch past n that bypassed admission
    eng = _serving_engine(api, hu, "labels", pm)
    svc = api.serve(eng, config=_port_config(api), start=False)
    if rank == FAILING_RANK:
        plain = svc._snapshot_mr
        calls = []

        def failing(snap, us, vs):
            out = plain(snap, us, vs)
            calls.append(1)
            if len(calls) == 1:
                raise MemoryError("planted after the join")
            return out
        svc._snapshot_mr = failing
    follower_errors = None
    if not svc.leader:
        follower_errors = [
            _error(lambda: svc.submit(api.MRRequest(0, 1))),
            _error(lambda: svc.update(inserts=[[0, 1]])),
            _error(lambda: svc.checkpoint(None))]

    def failures(s):
        out = {}
        futs = [s.mr(0, 1), s.mr(3, 7)]
        s.drain()
        out["failed"] = [_error(lambda f=f: f.result(timeout=60))
                         for f in futs]
        futs = [s.mr(0, 1), s.mr(3, 7)]
        s.drain()
        out["next"] = [f.result(timeout=60) for f in futs]
        seq = s._stream.seq
        out["admission"] = _error(lambda: s.submit(
            api.MRRequest(0, eng.h.n)))
        out["admission_sent"] = s._stream.seq - seq
        forged = Future()
        s._dispatch([_Entry(api.MRRequest(0, eng.h.n + 5), forged,
                            time.monotonic(), None)])
        out["forged"] = _error(lambda: forged.result(timeout=60))
        out["last"] = s.mr(5, 5)
        s.drain()
        out["last"] = out["last"].result(timeout=60)
        return out
    with _Count(DeviceSnapshot, "gather_query_rows") as joins:
        result = _lead_or_follow(svc, failures)
    scalars["failures_serving"] = dict(
        _service_record(svc, result), joins=joins.calls,
        follower_errors=follower_errors)


def _store_engine(api, h, kind, pm):
    """An engine of ``STORE_CASES`` after the update script's first
    ``STORE_STEPS`` steps (``closure``: queried first, so its W* is
    freed and the snapshot payload is written)."""
    eng = _port_engine(api, h, kind, pm, "allgather")
    if kind == "closure":
        eng.mr_batch(*all_pairs(h.n))
    for _, ins, dels in update_script(h.n, h.m)[:STORE_STEPS]:
        eng.update(inserts=ins, deletes=dels)
    return eng


def _snapshot_arrays(arrays, prefix, snap):
    for f in ("ranks", "svals", "lengths"):
        arrays[f"{prefix}/{f}"] = getattr(snap, f).numpy().copy()


def _store_rank_cases(api, mesh, rank, out_dir, arrays, scalars):
    """A10d item 4 on ranks: ``save_index`` / ``load_index(mesh=pm)`` /
    ``build_engine(restore=, mesh=pm)`` of every payload, the
    ``IndexStore`` with its log, a failed append, and a service's
    checkpoint and restore.  Every rank names the same files; counts what
    this rank wrote."""
    from repro_torch.store import format as fmt
    from repro_torch.store import wal as walmod

    pm = mesh((2, 2))
    hu = api.from_edge_lists(*update_graph())
    files = _Count(fmt, "_write_store_file")
    appends = _Count(walmod.WriteAheadLog, "append")
    store = {}
    with files, appends:
        for kind, script_kind in STORE_CASES:
            eng = _store_engine(api, hu, script_kind, pm)
            path = os.path.join(out_dir, f"store-{kind}.hlidx")
            written = files.calls
            manifest = api.save_index(path, eng)
            info = {"manifest": manifest, "written": files.calls - written}
            loaded = api.load_index(path, mesh=pm)
            restored = api.build_engine(restore=path, mesh=pm)
            tag = f"store/{kind}"
            if loaded.name == "sharded" and loaded._w_star is not None:
                arrays[f"{tag}/block"] = loaded._w_star.numpy().copy()
            us, vs = all_pairs(loaded.h.n)
            arrays[f"{tag}/mr"] = loaded.mr_batch(us, vs)
            info["restored_equal"] = bool(np.array_equal(
                restored.mr_batch(us, vs), arrays[f"{tag}/mr"]))
            snap = loaded.snapshot()
            info.update(block=snap.block, on=repr(snap.mesh),
                        rank_mesh=repr(loaded.rank_mesh),
                        version=loaded.version)
            _snapshot_arrays(arrays, f"{tag}/snap", snap)
            loaded.update(inserts=STORE_MORE)
            us, vs = all_pairs(loaded.h.n)
            arrays[f"{tag}/more_mr"] = loaded.mr_batch(us, vs)
            _snapshot_arrays(arrays, f"{tag}/more_snap", loaded.snapshot())
            store[kind] = info

        # the IndexStore with its log, then a failed append on rank 0
        eng = _port_engine(api, hu, "labels", pm, None)
        eng.mr_batch(*all_pairs(hu.n))
        root = os.path.join(out_dir, "store-ranks")
        index_store = api.IndexStore(root)
        written, appended = files.calls, appends.calls
        index_store.checkpoint(eng)
        index_store.attach(eng)
        for ins, dels in JOURNAL_EDITS:
            eng.update(inserts=ins, deletes=dels)
        restored = api.IndexStore(root).restore(mesh=pm, attach=False)
        us, vs = all_pairs(eng.h.n)
        journal = {
            "written": files.calls - written,
            "appended": appends.calls - appended,
            "version": eng.version, "restored_version": restored.version,
            "records": index_store.records_since_checkpoint,
            "answers_equal": bool(np.array_equal(
                restored.mr_batch(us, vs), eng.mr_batch(us, vs))),
            "snapshot_equal": all(
                torch_equal(getattr(restored.snapshot(), f),
                            getattr(eng.snapshot(), f))
                for f in ("ranks", "svals", "lengths"))}
        if rank == 0:
            def failing(*args):
                raise OSError("planted: the disk is full")
            index_store._wal.append = failing
        journal["failed_append"] = _error(
            lambda: eng.update(inserts=[[2, 9]]))
        journal["after_failure"] = {"version": eng.version, "m": eng.h.m,
                                    "records": index_store.
                                    records_since_checkpoint}
        scalars["index_store"] = journal

        # a service's checkpoint and restore through the stream
        eng = _serving_engine(api, hu, "labels", pm)
        svc = api.serve(eng, config=_port_config(api), start=False)
        root = os.path.join(out_dir, "store-service")
        specs = serve_requests(hu.n + 1, np.random.default_rng(31),
                               SERVE_REQUESTS)

        def answers(s):
            futs = s.submit_many([build_request(api, x) for x in specs])
            s.drain()
            return [answer_json(f.result(timeout=60)) for f in futs]

        def live(s):
            s.checkpoint(api.IndexStore(root))
            s.update(inserts=[[2, 5, hu.n]])
            return answers(s)
        written = files.calls
        live_answers = _lead_or_follow(svc, live)
        back = api.ReachabilityService.restore(
            root, mesh=pm, config=_port_config(api), start=False)
        scalars["service_store"] = {
            "live": live_answers, "restored": _lead_or_follow(back, answers),
            "version": back.engine.version,
            "rank_mesh": repr(back.engine.rank_mesh),
            "written": files.calls - written,
            "live_stats": svc.stats().as_dict(),
            "restored_stats": back.stats().as_dict()}
    scalars["store"] = store
    scalars["store_writes"] = {"files": files.calls,
                               "appends": appends.calls}


def torch_equal(a, b):
    import torch
    return torch.equal(a, b)


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
    _serving_reference_cases(out_dir, arrays, scalars)
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


def _reference_engine(kind, shape):
    """The reference's engine of a serving or store case on
    ``update_graph()`` over ``make_test_mesh(shape)``."""
    from repro.api import build_engine
    from repro.core import from_edge_lists
    from repro.core.distributed import ShardedEngine
    from repro.launch.mesh import make_test_mesh

    hu = from_edge_lists(*update_graph())
    mesh = make_test_mesh(shape, AXES)
    if kind == "labels":
        return ShardedEngine.build(hu, mesh=mesh, build_labels=True)
    if kind in ("closure", "resident"):
        return ShardedEngine.build(hu, mesh=mesh, schedule="allgather")
    if kind == "single":
        return build_engine(hu, "hl-index")
    return build_engine(hu, kind, mesh=mesh)


def _serving_reference_cases(out_dir, arrays, scalars):
    """The serving and store cases on the reference over four host
    devices: its mesh services, replica groups and files."""
    import dataclasses
    import repro.api as ref_api
    from repro.launch.mesh import make_test_mesh

    n0 = UPDATE_GRAPH["n"]
    cfg = ref_api.ServiceConfig(
        max_batch=SERVE_MAX_BATCH, use_kernels=False,
        tenants=tuple(ref_api.TenantSpec(t, w) for t, w in SERVE_TENANTS))
    serving = {}
    for kind, shape, with_mesh in SERVE_CASES:
        svc = ref_api.serve(_reference_engine(kind, shape),
                            mesh=make_test_mesh(shape, AXES) if with_mesh
                            else None, config=cfg, start=False)
        rounds = serve_script(ref_api, svc, n0)
        serving[serve_key(kind, shape, with_mesh)] = {
            "result": rounds, "stats": svc.stats().as_dict()}
        svc.close()
    scalars["serving"] = serving
    replicas = {}
    mesh = make_test_mesh((2, 2), AXES)
    for kind in REPLICA_CASES:
        grp = ref_api.serve(_reference_engine(kind, (2, 2)), mesh=mesh,
                            config=dataclasses.replace(cfg,
                                                       replicas=REPLICAS),
                            start=False)
        rounds = serve_script(ref_api, grp, n0)
        replicas[kind] = {"result": rounds, "stats": grp.stats().as_dict(),
                          "replica_stats": grp.replica_stats()}
        for i, r in enumerate(grp.replicas):
            for f in ("ranks", "svals", "lengths"):
                arrays[f"replicas/{kind}/{i}/{f}"] = np.asarray(
                    getattr(r.snap, f))
        grp.close()
    scalars["replicas"] = replicas

    hu_n = UPDATE_GRAPH["n"]
    for kind, script_kind in STORE_CASES:
        eng = _reference_engine(script_kind, (2, 2))
        if script_kind == "closure":
            eng.mr_batch(*all_pairs(hu_n))
        for _, ins, dels in update_script(hu_n, 0)[:STORE_STEPS]:
            eng.update(inserts=ins, deletes=dels)
        path = os.path.join(out_dir, f"reference-store-{kind}.hlidx")
        ref_api.save_index(path, eng)
        loaded = ref_api.load_index(path, mesh=mesh)
        tag = f"store/{kind}"
        if loaded.name == "sharded" and loaded._w_star is not None:
            arrays[f"{tag}/w_star"] = np.asarray(loaded._w_star)
        arrays[f"{tag}/mr"] = np.asarray(loaded.mr_batch(
            *all_pairs(loaded.h.n)))
        for f in ("ranks", "svals", "lengths"):
            arrays[f"{tag}/snap/{f}"] = np.asarray(
                getattr(loaded.snapshot(), f))
        loaded.update(inserts=STORE_MORE)
        arrays[f"{tag}/more_mr"] = np.asarray(loaded.mr_batch(
            *all_pairs(loaded.h.n)))
        for f in ("ranks", "svals", "lengths"):
            arrays[f"{tag}/more_snap/{f}"] = np.asarray(
                getattr(loaded.snapshot(), f))

    eng = _reference_engine("labels", (2, 2))
    eng.mr_batch(*all_pairs(hu_n))
    store = ref_api.IndexStore(os.path.join(out_dir, "reference-store-ranks"))
    store.checkpoint(eng)
    store.attach(eng)
    for ins, dels in JOURNAL_EDITS:
        eng.update(inserts=ins, deletes=dels)
    store.close()


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "src"))
    run_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
