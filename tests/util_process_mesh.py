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
ERROR_NAMES = ("world_size", "trim", "labels", "update", "to_mesh",
               "neighbor_csr", "build_sharded", "hl_index", "service_mesh",
               "service_engine", "replicas", "save_index", "load_index",
               "restore")


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

    # -- what does not run on ranks, and the mesh's limits
    eng = api.build_engine(he, "sharded", mesh=pm, use_kernels=True)
    host_eng = api.build_engine(he, "sharded", mesh=logical)
    saved = os.path.join(out_dir, f"logical-{rank}.hlidx")
    api.save_index(saved, host_eng)
    flat = api.build_engine(he, "hl-index", device="cpu")
    errors = {
        "world_size": lambda: api.make_process_mesh((2, 3), AXES,
                                                    device="cpu"),
        "trim": lambda: dist.sharded_maxmin_closure(w, pm),
        "labels": lambda: api.build_engine(he, "sharded", mesh=pm,
                                           build_labels=True),
        "update": lambda: eng.update(inserts=[[0, 1]]),
        "to_mesh": lambda: flat.snapshot().to_mesh(pm),
        "neighbor_csr": lambda: neighbor_csr(he, mesh=pm),
        "build_sharded": lambda: build_sharded(he, mesh=pm),
        "hl_index": lambda: api.build_engine(he, "hl-index", mesh=pm),
        "service_mesh": lambda: api.ReachabilityService(
            host_eng, mesh=pm, start=False),
        "service_engine": lambda: api.ReachabilityService(eng, start=False),
        "replicas": lambda: api.ReplicaGroup(eng, 2, start=False),
        "save_index": lambda: api.save_index(
            os.path.join(out_dir, f"rank-{rank}.hlidx"), eng),
        "load_index": lambda: api.load_index(saved, mesh=pm),
        "restore": lambda: api.build_engine(restore=saved, mesh=pm),
    }
    assert tuple(errors) == ERROR_NAMES
    scalars["errors"] = {k: _error(fn) for k, fn in errors.items()}
    scalars["update_left_engine"] = {"version": eng.version,
                                     "m": eng.h.m}
    return arrays, scalars


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
    np.savez(os.path.join(out_dir, "reference.npz"), **arrays)
    with open(os.path.join(out_dir, "reference.json"), "w") as f:
        json.dump(scalars, f)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "..", "src"))
    run_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
