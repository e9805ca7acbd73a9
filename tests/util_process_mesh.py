"""Both sides of ``tests/test_torch_process_mesh.py``, each run in its own
subprocesses.

* ``python tests/util_process_mesh.py RANK WORLD INIT_FILE OUT_DIR`` is
  one rank of a gloo world on the CPU (``file://`` init): it runs every
  case of the test module on ``repro_torch`` process meshes and writes
  ``rank<RANK>.npz`` (arrays) and ``rank<RANK>.json`` (scalars, error
  types and messages) into ``OUT_DIR``.
* ``run_reference(OUT_DIR)`` runs the same cases on the reference, in a
  process started with four forced host devices, and writes
  ``reference.npz`` / ``reference.json``; the LM cases' unsharded
  reference runs, which need one device, are shared out over the rank
  processes once their world has closed (``lm_reference_share``), each
  writing ``reference-lm<RANK>.npz``.

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
# tensor-parallel serving of the dense LM on ranks: qwen3-1.7b's SMOKE
# config (2 layers, d 64, 4 heads of 16, 2 KV heads, d_ff 128, vocab
# 256) on a (data, model) grid, with the replacements both packages take
LM_ARCH = "qwen3-1.7b"
LM_CASES = [((2, 2), {}), ((1, 4), {"n_kv_heads": 4})]
LM_DTYPES = ("float32", "bfloat16")
# a batch of 4 prompts of 16 tokens; a seeded cache of 16 slots (8 a rank
# on 2 x 2, 4 on 1 x 4); three teacher-forced decode steps, the first at
# a position of rank 0's slots (the later ranks all masked)
LM_BATCH, LM_SEQ, LM_SEED = 4, 16, 23
LM_DECODE_POS = (2, 9, 15)
# the cells lower_cell runs on ranks (reduced shape cells at smoke
# widths, the cell mesh equal to the ranks' grid) and the rank whose
# decode check is made to fail
LM_RUN_SEQ = 16
LM_FAILING_RANK = 1
# the MoE and VLM transformer families on ranks, each served as the
# dense cases are: (case, arch, grid, the replacements both packages
# take); qwen2-moe's SMOKE config (8 experts of 64, top 2, 1 shared) in
# its published FFN-split layout, arctic's SMOKE config (8 experts of
# 96, top 2, a dense residual) in its published "model+data" layout (a
# rank holds 2 whole experts; the ranks' data axis is 1) and in "model",
# llava's (a projector from 16 to 64, 4 patches of the 16 positions)
FAMILY_CASES = [
    ("qwen2-moe-2x2", "qwen2-moe-a2.7b", (2, 2), {}),
    ("qwen2-moe-1x4", "qwen2-moe-a2.7b", (1, 4), {}),
    ("arctic-model+data-1x4", "arctic-480b", (1, 4),
     {"expert_sharding": "model+data", "n_kv_heads": 4}),
    ("arctic-model-2x2", "arctic-480b", (2, 2), {"expert_sharding": "model"}),
    ("llava-2x2", "llava-next-mistral-7b", (2, 2), {}),
    ("llava-1x4", "llava-next-mistral-7b", (1, 4), {"n_kv_heads": 4})]
# the Mamba, RG-LRU hybrid and Whisper families on ranks, each served as
# the dense cases are, with seeded family caches: falcon-mamba's SMOKE
# config (2 layers, d_inner 128, state 4), recurrentgemma's on 8 layers
# (two (rec, rec, attn) groups and the two-rec tail; 4 heads of 16, one
# KV head, a window of 8 that LM_DECODE_POS wraps), whisper's (2 + 2
# layers, 8 frames)
NON_TRANSFORMER_CASES = [
    ("mamba-2x2", "falcon-mamba-7b", (2, 2), {}),
    ("mamba-1x4", "falcon-mamba-7b", (1, 4), {}),
    ("griffin-2x2", "recurrentgemma-2b", (2, 2), {"n_layers": 8}),
    ("griffin-1x4", "recurrentgemma-2b", (1, 4), {"n_layers": 8}),
    ("whisper-2x2", "whisper-large-v3", (2, 2), {}),
    ("whisper-1x4", "whisper-large-v3", (1, 4), {})]
# training the dense LM on ranks (1 x 4): the LM_CASES case LM_TRAIN_KEY
# (its weights) with LM_TRAIN_MICROBATCH microbatches, a seeded batch of
# LM_BATCH rows of LM_SEQ tokens and their next tokens, one step from
# zero moments with tests/test_torch_train.py's AdamConfig; the rank
# processes' gradients and step against the reference's unsharded
# jax.grad and make_train_step, then lower_cell on a train cell of
# LM_RUN_SEQ tokens, a rank whose share of a backward sum fails, and a
# backward cut at the row-split sums
LM_TRAIN_KEY = "1x4"
LM_TRAIN_MICROBATCH = 2
LM_TRAIN_SEED = 41
LM_TRAIN_OPT = dict(lr=3e-3, total_steps=10, warmup_steps=2)
# the rank processes whose share of the reference's runs takes the
# unsharded training runs
LM_TRAIN_REFERENCE_RANK = 3
# training the dense LM with the batch split over data (ZeRO-1 on a 2 x
# 2 grid): the LM_CASES case LM_ZERO1_KEY (its weights), LM_BATCH rows in
# LM_TRAIN_MICROBATCH microbatches, so one row a data coordinate a
# microbatch; each rank's reduce-scattered gradient shard and one step
# in both compute dtypes with ZeRO-1 (and in float32 with zero1 off,
# whole moments and the gradient all-reduced over data) against the
# reference's unsharded jax.grad and make_train_step, whose runs the
# rank process LM_ZERO1_REFERENCE_RANK takes; then lower_cell on a 2 x 2
# train cell of LM_RUN_SEQ tokens (both routes), a rank whose shard
# update fails and one whose share of a backward sum fails
LM_ZERO1_KEY = "2x2"
LM_ZERO1_CASES = (("float32", True), ("bfloat16", True), ("float32", False))
LM_ZERO1_REFERENCE_RANK = 2
# training the MoE and VLM transformers on ranks: (case, the LM_ALL case
# whose weights and grid it takes, the replacements both packages take
# beside LM_TRAIN_MICROBATCH microbatches): qwen2-moe's SMOKE config
# FFN-split on 1 x 4, on the same weights in the "model+data"
# expert-parallel layout (2 of its 8 experts a rank; the ranks' data axis
# is 1), llava's (its KV heads widened to 4) on 1 x 4, and qwen2-moe
# FFN-split with ZeRO-1 on 2 x 2 (one row a data coordinate a
# microbatch); each one step from zero moments in both compute dtypes
# against the reference's unsharded make_train_step on LM_BATCH rows of
# LM_SEQ positions, whose runs the rank processes of
# LM_FAMILY_REFERENCE_RANKS take (one a config: the expert layout and
# the grid split nothing there); then lower_cell on a train cell of each
# and one whose rank 1 fails in its expert backward
FAMILY_TRAIN_CASES = [
    ("moe-ffn-1x4", "qwen2-moe-1x4", {}),
    ("moe-ep-1x4", "qwen2-moe-1x4", {"expert_sharding": "model+data"}),
    ("vlm-1x4", "llava-1x4", {}),
    ("moe-ffn-2x2", "qwen2-moe-2x2", {})]
LM_FAMILY_REFERENCE_RANKS = {"qwen2-moe-a2.7b": 1,
                             "llava-next-mistral-7b": 0}
# reduce_scatter_sum on ranks: rank r's input of RS_SHAPE is
# rs_input(r) (scattered over each axis of the 2 x 2 grid along each
# dimension, in float32 and bf16)
RS_SHAPE = (4, 6)
# the tokens a chunk of Whisper's head on ranks sums at a time in the rank
# processes (models.whisper.HEAD_CHUNK_TOKENS): a prefill's 64 or 128
# tokens a rank then cross in three or six pieces, the last shorter
WHISPER_HEAD_CHUNK = 24
# every LM case on ranks: (key, arch, grid, replacements)
LM_ALL = [(f"{g[0]}x{g[1]}", LM_ARCH, g, over) for g, over in LM_CASES] \
    + FAMILY_CASES + NON_TRANSFORMER_CASES
# one MoE layer alone on ranks, on a seeded input of each token count (t
# split over 4 or 2 ranks unevenly; one token, which three ranks of a
# line do not own), against the reference's moe_apply
MOE_LAYER_TOKENS = (13, 1)
MOE_LAYER_SEED = 31
# all_to_all_over: what coordinate i of a line sends coordinate j, rows
# of width A2A_WIDTH (zero rows a normal case)
A2A_WIDTH = 3


def a2a_count(i, j):
    return (i + 2 * j) % 3


def a2a_rows(src, dst, n):
    """The rows global rank ``src`` sends global rank ``dst``: each names
    its source, destination and place."""
    return np.array([[src, dst, r] for r in range(n)],
                    np.float32).reshape(n, A2A_WIDTH)


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


def lm_key(grid):
    return f"{grid[0]}x{grid[1]}"


def lm_case(key):
    """``LM_ALL``'s (arch, grid, replacements) of ``key``."""
    return {k: (arch, grid, over) for k, arch, grid, over in LM_ALL}[key]


def case_config(module, key, dtype):
    """``module``'s (either package's ``configs``) SMOKE config of the LM
    case ``key`` in ``dtype`` compute."""
    import dataclasses
    arch, _, over = lm_case(key)
    return dataclasses.replace(module.get_smoke_config(arch),
                               compute_dtype=dtype, **over)


def case_overrides(key, dtype="bfloat16"):
    """``case_config``'s fields, as ``lower_cell``'s ``overrides``."""
    import dataclasses
    from repro_torch import configs
    cfg = case_config(configs, key, dtype)
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def cache_dtypes(cfg):
    """Each cache key of ``cfg``'s model and its dtype name, in the
    order of ``init_cache`` (the bf16 default; states float32)."""
    from repro_torch.models import build_model
    cache = build_model(cfg, device="meta").init_cache(LM_BATCH, LM_SEQ)
    return {k: str(v.dtype).split(".")[-1] for k, v in cache.items()}


def lm_inputs(cfg):
    """The prompts ``[B, S]``, the decode steps' tokens ``[3, B, 1]`` and
    the seeded cache ``k`` / ``v`` ``[L, B, S, kv, hd]`` (float32, which
    both packages round to bf16 alike); for a VLM the prompts are the
    last ``S - num_patches`` tokens after ``patches`` ``[B, num_patches,
    vision_dim]``, drawn last.  The Mamba, hybrid and Whisper families
    draw every key of their cache instead (``cache_dtypes``' order and
    shapes, each cast to its dtype by both packages), and Whisper's
    ``frames`` ``[B, enc_frames, d_model]`` last."""
    rng = np.random.default_rng(LM_SEED)
    out = {"tokens": rng.integers(0, cfg.vocab, (LM_BATCH, LM_SEQ)),
           "steps": rng.integers(0, cfg.vocab,
                                 (len(LM_DECODE_POS), LM_BATCH, 1))}
    if cfg.family in ("ssm", "hybrid", "encdec"):
        from repro_torch.models import build_model
        cache = build_model(cfg, device="meta").init_cache(LM_BATCH, LM_SEQ)
        for k, v in cache.items():
            out[k] = rng.normal(size=tuple(v.shape)).astype(np.float32)
        if cfg.family == "encdec":
            out["frames"] = rng.normal(size=(
                LM_BATCH, cfg.enc_frames, cfg.d_model)).astype(np.float32)
        return out
    shape = (cfg.n_layers, LM_BATCH, LM_SEQ, cfg.n_kv_heads, cfg.hd)
    out.update(k=rng.normal(size=shape).astype(np.float32),
               v=rng.normal(size=shape).astype(np.float32))
    if cfg.vision_dim:
        out["tokens"] = out["tokens"][:, :LM_SEQ - cfg.num_patches]
        out["patches"] = rng.normal(size=(
            LM_BATCH, cfg.num_patches, cfg.vision_dim)).astype(np.float32)
    return out


def lm_train_config(module, dtype):
    """``module``'s (either package's ``configs``) config of the training
    case in ``dtype`` compute."""
    import dataclasses
    return dataclasses.replace(case_config(module, LM_TRAIN_KEY, dtype),
                               microbatch=LM_TRAIN_MICROBATCH)


def lm_zero1_config(module, dtype, zero1=True):
    """``module``'s (either package's ``configs``) config of the ZeRO-1
    training case in ``dtype`` compute."""
    import dataclasses
    return dataclasses.replace(case_config(module, LM_ZERO1_KEY, dtype),
                               microbatch=LM_TRAIN_MICROBATCH, zero1=zero1)


def zero1_tag(dtype, zero1):
    return f"lm_zero1/{dtype}" + ("" if zero1 else "/whole")


def family_train_case(case):
    """``FAMILY_TRAIN_CASES``' (weights key, arch, grid, replacements) of
    ``case``."""
    key, over = {c: (k, o) for c, k, o in FAMILY_TRAIN_CASES}[case]
    arch, grid, _ = lm_case(key)
    return key, arch, grid, over


def family_train_config(module, case, dtype):
    """``module``'s (either package's ``configs``) config of the family
    training case ``case`` in ``dtype`` compute."""
    import dataclasses
    key, _, _, over = family_train_case(case)
    return dataclasses.replace(case_config(module, key, dtype),
                               microbatch=LM_TRAIN_MICROBATCH, **over)


def family_train_tag(arch, dtype):
    """Where the reference's unsharded step of ``arch``'s family case
    lies."""
    return f"lm_family_train/{arch}/{dtype}"


def rs_input(rank):
    """Rank ``rank``'s seeded float32 input of the reduce-scatter case
    (bf16-exact values, so both dtypes sum the same numbers)."""
    rng = np.random.default_rng(100 + rank)
    return rng.integers(-64, 64, RS_SHAPE).astype(np.float32) / 8


def lm_train_batch(cfg):
    """The training case's seeded ``{"tokens", "labels"}`` (int32
    ``[LM_BATCH, LM_SEQ]``, labels the next tokens); for a VLM the last
    ``LM_SEQ - num_patches`` positions, after ``patch_embeds`` ``[LM_BATCH,
    num_patches, vision_dim]`` (float32), drawn last."""
    rng = np.random.default_rng(LM_TRAIN_SEED)
    text = LM_SEQ - (cfg.num_patches if cfg.vision_dim else 0)
    seq = rng.integers(0, cfg.vocab, (LM_BATCH, text + 1)).astype(np.int32)
    out = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    if cfg.vision_dim:
        out["patch_embeds"] = rng.normal(size=(
            LM_BATCH, cfg.num_patches, cfg.vision_dim)).astype(np.float32)
    return out


def moe_layer_input(cfg, t):
    """The seeded ``[1, t, d]`` input of the MoE layer case (float32,
    which both packages round to bf16 alike)."""
    rng = np.random.default_rng(MOE_LAYER_SEED + t)
    return rng.normal(size=(1, t, cfg.d_model)).astype(np.float32)


def write_lm_params(out_dir):
    """The reference's ``init(PRNGKey(0))`` of each case's config, flat
    (``convert.lm_layers_from_params`` keys), into ``OUT_DIR``: the
    ranks carry them across before the world starts."""
    import jax
    from repro import configs as ref_configs
    from repro.models import build_model
    from repro_torch.convert import lm_layers_from_params
    done = {}            # cases of one config (two grids) drawn once
    for key, arch, _, over in LM_ALL:
        same = (arch, tuple(sorted(over.items())))
        if same not in done:
            cfg = case_config(ref_configs, key, "float32")
            done[same] = lm_layers_from_params(jax.tree.map(
                np.asarray, build_model(cfg).init(jax.random.PRNGKey(0))))
        np.savez(os.path.join(out_dir, f"lm-params-{key}.npz"), **done[same])


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
    # this process's share of the reference's unsharded LM runs
    reference = {}
    _lm_reference_cases(reference, lm_reference_share(rank, world))
    if rank == LM_TRAIN_REFERENCE_RANK:
        _lm_train_reference(reference)
    if rank == LM_ZERO1_REFERENCE_RANK:
        _lm_zero1_reference(reference)
    _lm_family_train_reference(reference, [
        arch for arch, r in LM_FAMILY_REFERENCE_RANKS.items() if r == rank])
    np.savez(os.path.join(out_dir, f"reference-lm{rank}.npz"), **reference)


def lm_reference_share(rank: int, world: int):
    """The ``LM_ALL`` cases whose reference runs rank ``rank``'s process
    makes: every ``world``-th distinct config (a case's arch and
    replacements; the two grids of one config share its runs)."""
    configs = []
    for _, arch, _, over in LM_ALL:
        if (arch, sorted(over.items())) not in configs:
            configs.append((arch, sorted(over.items())))
    mine = configs[rank::world]
    return [case for case in LM_ALL
            if (case[1], sorted(case[3].items())) in mine]


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
    _lm_rank_cases(mesh, rank, out_dir, arrays, scalars)
    _lm_train_rank_cases(mesh, rank, out_dir, arrays, scalars)
    _lm_zero1_rank_cases(mesh, rank, out_dir, arrays, scalars)
    _lm_family_train_rank_cases(mesh, rank, out_dir, arrays, scalars)

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


def _lm_rank_cases(mesh, rank, out_dir, arrays, scalars):
    """Tensor-parallel serving of the LMs on each case of ``LM_ALL``: the
    reference's weights carried across to the rank's blocks, the prefill
    step and three decode steps in both compute dtypes (the gathered
    logits, the rank's cache block and every MoE layer's routing;
    Whisper's cross cache filled by ``prefill_cross``), then
    ``lower_cell`` on ranks for a prefill and a decode cell, decode cells
    whose check fails on one rank, the MoE cases' layer alone, the cells
    the run rule refuses, and the all-to-all."""
    import torch
    from repro_torch import configs
    from repro_torch.convert import lm_rank_state_dict_from_params, \
        nest_layers
    from repro_torch.core import collectives
    from repro_torch.distributed_lm.sharding import batch_block, cache_block
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapeCell
    from repro_torch.models import build_model
    from repro_torch.models import layers
    from repro_torch.serve import make_prefill_step, make_serve_step
    from repro_torch.serve.serve_step import whole_logits

    from repro_torch.models import whisper
    whisper.HEAD_CHUNK_TOKENS = WHISPER_HEAD_CHUNK
    runs, models = {}, {}
    for key, arch, grid, _ in LM_ALL:
        pm = mesh(grid)
        params = nest_layers(dict(np.load(os.path.join(
            out_dir, f"lm-params-{key}.npz"))))
        for dtype in LM_DTYPES:
            cfg = case_config(configs, key, dtype)
            model = build_model(cfg, device="cpu", ranks=pm)
            model.load_state_dict(lm_rank_state_dict_from_params(
                params, model.param_specs(), pm))
            models[(key, dtype)] = (model, cfg)
            inputs = lm_inputs(cfg)
            tag = f"lm/{key}/{dtype}"
            routes = []
            pm.tally.route = lambda idx, gates: routes.append(
                idx.numpy().copy())

            def rows(a, name="tokens"):
                return batch_block({name: torch.from_numpy(a)}, cfg,
                                   pm)[name]
            batch = {"tokens": rows(inputs["tokens"])}
            if cfg.vision_dim:
                batch["patch_embeds"] = rows(inputs["patches"],
                                             "patch_embeds")
            if cfg.family == "encdec":
                batch["frames"] = rows(inputs["frames"], "frames")
            try:
                out = make_prefill_step(model, cfg)(batch)
                arrays[f"{tag}/prefill"] = whole_logits(
                    out, pm, model).float().numpy()
                arrays[f"{tag}/prefill_block"] = out.float().numpy()
                for layer, idx in enumerate(routes):
                    arrays[f"{tag}/route/prefill/{layer}"] = idx
                cache = cache_block({k: torch.from_numpy(inputs[k]).to(
                    getattr(torch, dt)) for k, dt in
                    cache_dtypes(cfg).items()}, model, pm)
                step = make_serve_step(model, cfg)
                for i, pos in enumerate(LM_DECODE_POS):
                    routes.clear()
                    out, cache = step(cache, rows(inputs["steps"][i]), pos)
                    arrays[f"{tag}/decode{i}"] = whole_logits(
                        out, pm, model).float().numpy()
                    for layer, idx in enumerate(routes):
                        arrays[f"{tag}/route/decode{i}/{layer}"] = idx
                if cfg.family == "encdec":
                    # the cross cache of the frames, whole on every rank
                    filled = model.prefill_cross(cache_block(
                        model.init_cache(LM_BATCH, LM_SEQ, torch.float32),
                        model, pm), batch["frames"])
                    for k in ("cross_k", "cross_v"):
                        arrays[f"{tag}/prefill_{k}"] = filled[k].numpy()
            finally:
                del pm.tally.route
            for k in cache:
                arrays[f"{tag}/cache_{k}"] = cache[k].float().numpy()
        for kind in ("prefill", "decode"):
            cell = ShapeCell(f"{kind}_32k", LM_RUN_SEQ, 2 * LM_BATCH, kind)
            rec = dryrun.lower_cell(arch, cell, mesh_shape=grid,
                                    overrides=case_overrides(key),
                                    device="cpu", run=True, ranks=pm,
                                    run_reps=1)
            runs[f"{key}/{kind}"] = {
                k: rec.get(k) for k in (
                    "run_reason", "run_batch", "run_checks",
                    "run_collective", "collective_executed", "run_ranks",
                    "run_s", "run_exchange_s", "run_bound_s")}
    scalars["lm_runs"] = runs

    # a decode check that fails on one rank makes every rank raise
    make = dryrun.make_serve_step

    def stray(model, cfg):
        step = make(model, cfg)

        def serve_step(cache, tokens, pos):
            logits, cache = step(cache, tokens, pos)
            cache["k"][:, :, 0] += 1          # a write away from pos
            return logits, cache
        return serve_step
    if rank == LM_FAILING_RANK:
        dryrun.make_serve_step = stray
    try:
        scalars["lm_failure"] = _error(lambda: dryrun.lower_cell(
            LM_ARCH, ShapeCell("decode_32k", LM_RUN_SEQ, 2 * LM_BATCH,
                               "decode"), mesh_shape=(2, 2),
            overrides=case_overrides("2x2"), device="cpu", run=True,
            ranks=mesh((2, 2)), run_reps=1))
    finally:
        dryrun.make_serve_step = make

    # the new families' decode checks failing on one rank: a Mamba state
    # channel held back, a hybrid window written apart from the line's
    def held(model, cfg):
        step = make(model, cfg)

        def serve_step(cache, tokens, pos):
            kept = cache["ssm"][:, :, 0].clone()
            logits, cache = step(cache, tokens, pos)
            cache["ssm"][:, :, 0] = kept       # channel 0 never advances
            return logits, cache
        return serve_step

    def apart(model, cfg):
        step = make(model, cfg)

        def serve_step(cache, tokens, pos):
            logits, cache = step(cache, tokens, pos)
            cache["k"][:, :, pos % cache["k"].shape[2]] += 1
            return logits, cache
        return serve_step
    for name, key, planted in (("mamba", "mamba-2x2", held),
                               ("griffin", "griffin-1x4", apart)):
        arch, grid, _ = lm_case(key)
        if rank == LM_FAILING_RANK:
            dryrun.make_serve_step = planted
        try:
            scalars.setdefault("lm_family_failure", {})[name] = _error(
                lambda: dryrun.lower_cell(
                    arch, ShapeCell("decode_32k", LM_RUN_SEQ, 2 * LM_BATCH,
                                    "decode"), mesh_shape=grid,
                    overrides=case_overrides(key), device="cpu", run=True,
                    ranks=mesh(grid), run_reps=1))
        finally:
            dryrun.make_serve_step = make

    # one MoE layer alone: the first block's, on a seeded input
    for key, _, grid, _ in FAMILY_CASES:
        for dtype in LM_DTYPES:
            model, cfg = models[(key, dtype)]
            if cfg.family != "moe":
                continue
            for t in MOE_LAYER_TOKENS:
                x = torch.from_numpy(moe_layer_input(cfg, t)).to(
                    getattr(torch, dtype))
                with torch.no_grad(), layers.sharding_mesh(mesh(grid)):
                    out, aux = layers.moe_apply(model.blocks[0].moe, cfg, x)
                arrays[f"moe_layer/{key}/{dtype}/{t}"] = out.float().numpy()
                arrays[f"moe_layer/{key}/{dtype}/{t}/aux"] = \
                    aux.float().numpy()

    # a rank whose expert step fails: every rank raises
    def broken(p, rows, experts):
        raise RuntimeError("the planted expert failure")
    for key in ("arctic-model-2x2", "arctic-model+data-1x4"):
        model, cfg = models[(key, "float32")]
        expert_rows = layers._expert_rows
        if rank == LM_FAILING_RANK:
            layers._expert_rows = broken
        try:
            # outside autograd: the all-to-all has no backward on ranks
            with torch.no_grad():
                scalars.setdefault("moe_failure", {})[key] = _error(
                    lambda: model.apply(torch.zeros((1, 6),
                                                    dtype=torch.int64)))
        finally:
            layers._expert_rows = expert_rows

    # the cells the run rule refuses on ranks: nothing runs
    refused = {}
    for name, key, over in (
            ("model+data", "arctic-model-2x2",
             {"expert_sharding": "model+data"}),
            ("moe_capacity", "qwen2-moe-2x2", {"moe_capacity": True})):
        arch, grid, _ = lm_case(key)
        rec = dryrun.lower_cell(
            arch, ShapeCell("decode_32k", LM_RUN_SEQ, 2 * LM_BATCH,
                            "decode"), mesh_shape=grid,
            overrides=dict(case_overrides(key), **over), device="cpu",
            run=True, ranks=mesh(grid), run_reps=1)
        refused[name] = {"run_reason": rec.get("run_reason"),
                         "ran": "run_s" in rec}
    # recurrentgemma-2b's published 10 heads on a model axis of 4, and a
    # long-context decode of the state families
    for name, arch, cell, grid, over in (
            ("hybrid_heads", "recurrentgemma-2b", "decode_32k", (128, 4),
             None),
            ("long_context", "falcon-mamba-7b",
             ShapeCell("long_500k", LM_RUN_SEQ, 1, "decode"), (1, 4),
             case_overrides("mamba-1x4"))):
        rec = dryrun.lower_cell(arch, cell, mesh_shape=grid, overrides=over,
                                device="cpu", run=True, ranks=mesh((1, 4)),
                                run_reps=1)
        refused[name] = {"run_reason": rec.get("run_reason"),
                         "ran": "run_s" in rec}
    scalars["lm_refused"] = refused

    # all_to_all_over along every line of 1 x 4 and 2 x 2, uneven counts
    for grid, axis in (((1, 4), "model"), ((2, 2), "model"),
                       ((2, 2), "data")):
        pm = mesh(grid)
        line, me = pm.axis_ranks(axis), pm.axis_index(axis)
        n = len(line)
        for dtype in ("float32", "bfloat16"):
            send = [a2a_count(me, j) for j in range(n)]
            recv = [a2a_count(j, me) for j in range(n)]
            rows = np.concatenate([a2a_rows(rank, line[j], send[j])
                                   for j in range(n)])
            pm.tally.reset()
            got = collectives.all_to_all_over(torch.from_numpy(rows).to(
                getattr(torch, dtype)), pm, axis, send, recv)
            tag = f"a2a/{lm_key(grid)}/{axis}/{dtype}"
            arrays[tag] = got.float().numpy()
            scalars.setdefault("a2a_tally", {})[tag] = \
                pm.tally.record()["bytes"]["all-to-all"]
    pm = mesh((2, 2))
    n = pm.shape["model"]
    me = pm.axis_index("model")
    send = [a2a_count(me, j) for j in range(n)]
    recv = [a2a_count(j, me) for j in range(n)]
    rows = torch.zeros((sum(send), A2A_WIDTH))
    failed = ValueError("a planted failure") if rank == LM_FAILING_RANK \
        else None
    scalars["a2a_failure"] = _error(lambda: collectives.all_to_all_over(
        rows, pm, "model", send, recv, error=failed))
    skew = [c + (1 if rank == LM_FAILING_RANK and j == 0 else 0)
            for j, c in enumerate(recv)]
    scalars["a2a_unpaired"] = _error(lambda: collectives.all_to_all_over(
        rows, pm, "model", send, skew))


def _lm_train_rank_cases(mesh, rank, out_dir, arrays, scalars):
    """The dense LM's training on ranks (``LM_TRAIN_KEY`` on its 1 x 4
    grid): each rank's gradient blocks from one ``loss.backward()``
    (float32) and one step from zero moments in both compute dtypes (its
    blocks of the new parameters, ``m`` and ``v``; the loss, the norm and
    the count), the reference's weights carried across; then
    ``lower_cell`` on a train cell, one whose rank 1 fails in its share
    of a backward sum, and one whose row-split sums pass back zeros."""
    import torch
    from repro_torch import configs
    from repro_torch.convert import lm_rank_state_dict_from_params, \
        nest_layers
    from repro_torch.core import collectives
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapeCell
    from repro_torch.models import build_model
    from repro_torch.models import layers
    from repro_torch.train.optimizer import AdamConfig, adam_init
    from repro_torch.train.train_step import make_train_step, model_params

    arch, grid, _ = lm_case(LM_TRAIN_KEY)
    pm = mesh(grid)
    params = nest_layers(dict(np.load(os.path.join(
        out_dir, f"lm-params-{LM_TRAIN_KEY}.npz"))))
    for dtype in LM_DTYPES:
        cfg = lm_train_config(configs, dtype)
        batch = {k: torch.from_numpy(v)
                 for k, v in lm_train_batch(cfg).items()}

        def carried():
            model = build_model(cfg, device="cpu", ranks=pm)
            model.load_state_dict(lm_rank_state_dict_from_params(
                params, model.param_specs(), pm))
            return model
        tag = f"lm_train/{dtype}"
        if dtype == "float32":
            model = carried()
            loss = model.loss(batch)
            loss.backward()
            arrays[f"{tag}/loss"] = loss.detach().numpy()
            for k, p in model.named_parameters():
                arrays[f"{tag}/grad/{k}"] = p.grad.numpy()
        model = carried()
        opt = AdamConfig(**LM_TRAIN_OPT)
        mine = model_params(model)
        got, state, metrics = make_train_step(model, cfg, opt)(
            mine, adam_init(mine, opt), batch)
        for k in ("loss", "grad_norm"):
            arrays[f"{tag}/step/{k}"] = metrics[k].numpy()
        arrays[f"{tag}/step/count"] = state["count"].numpy()
        for k, p in got.items():
            arrays[f"{tag}/step/params/{k}"] = p.detach().numpy()
            for mom in ("m", "v"):
                arrays[f"{tag}/step/{mom}/{k}"] = state[mom][k].numpy()

    def run():
        return dryrun.lower_cell(
            arch, ShapeCell("train_4k", LM_RUN_SEQ, LM_BATCH, "train"),
            mesh_shape=grid, overrides=case_overrides(LM_TRAIN_KEY),
            device="cpu", run=True, ranks=pm, run_reps=1)
    rec = run()
    scalars["lm_train_run"] = {k: rec.get(k) for k in (
        "run_reason", "run_batch", "run_checks", "run_collective",
        "collective_executed", "collective", "run_ranks", "run_s")}

    # rank 1's share of a backward sum fails: every rank raises
    part = layers._rank_part

    def failing(g):
        raise RuntimeError("the planted backward failure")
    if rank == LM_FAILING_RANK:
        layers._rank_part = failing
    try:
        scalars["lm_train_failure"] = _error(run)
    finally:
        layers._rank_part = part

    # the row-split sums pass back zeros: the gradients upstream of them
    # are cut, and every rank's gradient check fails
    class Cut(torch.autograd.Function):
        @staticmethod
        def forward(ctx, y, mesh_, axis):
            return collectives.all_reduce_sum(y.float(), mesh_, axis).to(
                y.dtype)

        @staticmethod
        def backward(ctx, g):
            return torch.zeros_like(g), None, None
    sums = layers.sum_partials
    layers.sum_partials = Cut.apply
    try:
        scalars["lm_train_cut"] = _error(run)
    finally:
        layers.sum_partials = sums


def _lm_zero1_rank_cases(mesh, rank, out_dir, arrays, scalars):
    """``reduce_scatter_sum`` over each axis of the 2 x 2 grid, and the
    dense LM's training with the batch split over ``data`` (ZeRO-1 on
    ``LM_ZERO1_KEY``'s 2 x 2 grid): each rank's gradient shard (the
    gradients the step hands ``adam_update``) and one step from zero
    moments for each of ``LM_ZERO1_CASES`` (its blocks of the new
    parameters, its shards of ``m`` and ``v`` with their blocks of the
    whole leaf, the loss, the norm and the count), the reference's
    weights carried across; then ``lower_cell`` on a 2 x 2 train cell
    with ZeRO-1 on and off, one whose rank 1 fails in its shard update
    and one whose rank 1 fails in its share of a backward sum."""
    import torch
    from repro_torch import configs
    from repro_torch.convert import lm_rank_state_dict_from_params, \
        nest_layers
    from repro_torch.core import collectives
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapeCell
    from repro_torch.models import build_model
    from repro_torch.models import layers
    from repro_torch.train import optimizer
    from repro_torch.train import train_step as train_step_mod
    from repro_torch.train.optimizer import AdamConfig, adam_init, \
        zero1_layout
    from repro_torch.train.train_step import make_train_step, model_params

    pm = mesh((2, 2))
    # -- reduce_scatter_sum and the whole grid's all_reduce_sum
    for axis in AXES:
        for dim in (0, 1):
            for dtype in ("float32", "bfloat16"):
                t = torch.from_numpy(rs_input(rank)).to(
                    getattr(torch, dtype))
                pm.tally.reset()
                out = collectives.reduce_scatter_sum(t, pm, axis, dim)
                tag = f"rs/{axis}/{dim}/{dtype}"
                arrays[tag] = out.numpy()
                scalars[tag] = {"dtype": str(out.dtype),
                                **pm.tally.record()}
    one = mesh((4, 1))
    t = torch.from_numpy(rs_input(rank))
    out = collectives.reduce_scatter_sum(t, one, "model", 0)
    scalars["rs/size1"] = bool(out is t)
    scalars["rs/indivisible"] = _error(lambda: collectives.reduce_scatter_sum(
        torch.zeros((3, 2)), pm, "data", 0))
    pm.tally.reset()
    arrays["rs/world_sum"] = collectives.all_reduce_sum(
        torch.from_numpy(rs_input(rank)), pm, None).numpy()
    scalars["rs/world_sum"] = pm.tally.record()

    # -- the ZeRO-1 step against the reference's
    arch = lm_case(LM_ZERO1_KEY)[0]
    params = nest_layers(dict(np.load(os.path.join(
        out_dir, f"lm-params-{LM_ZERO1_KEY}.npz"))))
    opt = AdamConfig(**LM_TRAIN_OPT)
    update = train_step_mod.adam_update
    for dtype, zero1 in LM_ZERO1_CASES:
        cfg = lm_zero1_config(configs, dtype, zero1)
        batch = {k: torch.from_numpy(v)
                 for k, v in lm_train_batch(cfg).items()}
        model = build_model(cfg, device="cpu", ranks=pm)
        model.load_state_dict(lm_rank_state_dict_from_params(
            params, model.param_specs(), pm))
        mine = model_params(model)
        layout = zero1_layout(model, opt, zero1)
        seen = {}

        def recording(p, grads, *args, **kwargs):
            seen.update({k: g.clone() for k, g in grads.items()})
            return update(p, grads, *args, **kwargs)
        train_step_mod.adam_update = recording
        try:
            got, state, metrics = make_train_step(model, cfg, opt)(
                mine, adam_init(mine, opt, layout), batch)
        finally:
            train_step_mod.adam_update = update
        tag = zero1_tag(dtype, zero1)
        for k in ("loss", "grad_norm"):
            arrays[f"{tag}/{k}"] = metrics[k].numpy()
        arrays[f"{tag}/count"] = state["count"].numpy()
        for k, p in got.items():
            arrays[f"{tag}/params/{k}"] = p.detach().numpy()
        blocks = {}
        for k, g in seen.items():
            arrays[f"{tag}/grad/{k}"] = g.numpy()
            for mom in ("m", "v"):
                arrays[f"{tag}/{mom}/{k}"] = state[mom][k].numpy()
            blocks[k] = [[s.start, s.stop] for s in
                         layout.block(k, mine[k])]
        scalars[f"{tag}/blocks"] = blocks

    cell = ShapeCell("train_4k", LM_RUN_SEQ, LM_BATCH, "train")

    def run(zero1=True):
        return dryrun.lower_cell(
            arch, cell, mesh_shape=(2, 2),
            overrides=dict(case_overrides(LM_ZERO1_KEY),
                           microbatch=LM_TRAIN_MICROBATCH, zero1=zero1),
            device="cpu", run=True, ranks=pm, run_reps=1)
    for name, zero1 in (("lm_zero1_run", True),
                        ("lm_zero1_run_whole", False)):
        rec = run(zero1)
        scalars[name] = {k: rec.get(k) for k in (
            "run_reason", "run_batch", "run_checks", "run_collective",
            "collective_executed", "collective", "run_s")}

    # rank 1's shard update fails: every rank raises before the gather
    leaf = optimizer._update_leaf

    def failing_update(*args):
        raise RuntimeError("the planted shard failure")
    if rank == LM_FAILING_RANK:
        optimizer._update_leaf = failing_update
    try:
        scalars["lm_zero1_failure"] = _error(run)
    finally:
        optimizer._update_leaf = leaf

    # rank 1's share of a backward sum fails: its model line raises
    # there, and the other line with it before the reduction over data
    part = layers._rank_part

    def failing_part(g):
        raise RuntimeError("the planted backward failure")
    if rank == LM_FAILING_RANK:
        layers._rank_part = failing_part
    try:
        scalars["lm_zero1_backward_failure"] = _error(run)
    finally:
        layers._rank_part = part


def _lm_family_train_rank_cases(mesh, rank, out_dir, arrays, scalars):
    """The MoE and VLM families' training on ranks (``FAMILY_TRAIN_CASES``):
    one step from zero moments in both compute dtypes, the reference's
    weights carried across (each rank's blocks of the new parameters, its
    blocks or ZeRO-1 shards of ``m`` and ``v`` with their blocks of the
    whole leaf, the loss, the norm and the count); then ``lower_cell`` on
    a train cell of each case, and one of the expert-parallel case whose
    rank 1 fails in its expert backward."""
    import torch
    from repro_torch import configs
    from repro_torch.convert import lm_rank_state_dict_from_params, \
        nest_layers
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import ShapeCell
    from repro_torch.models import build_model
    from repro_torch.models import layers
    from repro_torch.train.optimizer import AdamConfig, adam_init, \
        zero1_layout
    from repro_torch.train.train_step import make_train_step, model_params

    opt = AdamConfig(**LM_TRAIN_OPT)
    for case, _, _ in FAMILY_TRAIN_CASES:
        key, arch, grid, _ = family_train_case(case)
        pm = mesh(grid)
        params = nest_layers(dict(np.load(os.path.join(
            out_dir, f"lm-params-{key}.npz"))))
        for dtype in LM_DTYPES:
            cfg = family_train_config(configs, case, dtype)
            model = build_model(cfg, device="cpu", ranks=pm)
            model.load_state_dict(lm_rank_state_dict_from_params(
                params, model.param_specs(), pm))
            mine = model_params(model)
            layout = zero1_layout(model, opt, cfg.zero1)
            batch = {k: torch.from_numpy(v)
                     for k, v in lm_train_batch(cfg).items()}
            got, state, metrics = make_train_step(model, cfg, opt)(
                mine, adam_init(mine, opt, layout), batch)
            tag = f"lm_family_train/{case}/{dtype}"
            for k in ("loss", "grad_norm"):
                arrays[f"{tag}/{k}"] = metrics[k].numpy()
            arrays[f"{tag}/count"] = state["count"].numpy()
            for k, p in got.items():
                arrays[f"{tag}/params/{k}"] = p.detach().numpy()
            for k in state["m"]:
                for mom in ("m", "v"):
                    arrays[f"{tag}/{mom}/{k}"] = state[mom][k].numpy()
            if layout is not None:
                scalars[f"{tag}/blocks"] = {
                    k: [[s.start, s.stop] for s in layout.block(k, mine[k])]
                    for k in state["m"]}

    def run(case):
        key, arch, grid, over = family_train_case(case)
        return dryrun.lower_cell(
            arch, ShapeCell("train_4k", LM_RUN_SEQ, LM_BATCH, "train"),
            mesh_shape=grid,
            overrides=dict(case_overrides(key), microbatch=LM_TRAIN_MICROBATCH,
                           **over),
            device="cpu", run=True, ranks=mesh(grid), run_reps=1)
    for case, _, _ in FAMILY_TRAIN_CASES:
        rec = run(case)
        scalars[f"lm_family_train_run/{case}"] = {k: rec.get(k) for k in (
            "run_reason", "run_batch", "run_checks", "run_collective",
            "collective_executed", "collective", "run_s")}

    # rank 1's expert backward fails: every rank raises
    vjp = layers._expert_rows_vjp

    def failing(*args):
        raise RuntimeError("the planted expert backward failure")
    if rank == LM_FAILING_RANK:
        layers._expert_rows_vjp = failing
    try:
        scalars["lm_family_train_failure"] = _error(
            lambda: run("moe-ep-1x4"))
    finally:
        layers._expert_rows_vjp = vjp


def _lm_family_train_reference(arrays, archs):
    """``_lm_family_train_rank_cases``' steps on the reference's unsharded
    model of each of ``archs`` (its first case's config: the expert
    layout and the grid change no value of an unsharded step): one
    ``make_train_step`` from ``adam_init`` in both compute dtypes, every
    leaf flat by ``convert.lm_layers_from_params``' keys."""
    import jax
    import jax.numpy as jnp
    from repro import configs as ref_configs
    from repro.models import build_model
    from repro.train import optimizer as ref_opt
    from repro.train.train_step import make_train_step
    from repro_torch.convert import lm_layers_from_params

    def flat(tree):
        return lm_layers_from_params(jax.tree.map(np.asarray, tree))
    for arch in archs:
        case = next(c for c, _, _ in FAMILY_TRAIN_CASES
                    if family_train_case(c)[1] == arch)
        for dtype in LM_DTYPES:
            cfg = family_train_config(ref_configs, case, dtype)
            model = build_model(cfg)
            params = model.init(jax.random.PRNGKey(0))
            batch = {k: jnp.asarray(v)
                     for k, v in lm_train_batch(cfg).items()}
            opt = ref_opt.AdamConfig(**LM_TRAIN_OPT)
            new, state, metrics = jax.jit(make_train_step(model, cfg, opt))(
                params, ref_opt.adam_init(params, opt), batch)
            tag = family_train_tag(arch, dtype)
            for k in ("loss", "grad_norm"):
                arrays[f"{tag}/{k}"] = np.asarray(metrics[k])
            arrays[f"{tag}/count"] = np.asarray(state["count"])
            for name, tree in (("params", new), ("m", state["m"]),
                               ("v", state["v"])):
                for k, v in flat(tree).items():
                    arrays[f"{tag}/{name}/{k}"] = v


def _lm_zero1_reference(arrays):
    """``_lm_zero1_rank_cases``' runs on the reference's unsharded model
    (``LM_ZERO1_KEY``'s config; ``zero1`` changes no value of an
    unsharded step): ``jax.value_and_grad`` of ``model.loss`` and one
    ``make_train_step`` from ``adam_init`` in both compute dtypes, every
    leaf flat by ``convert.lm_layers_from_params``' keys."""
    import jax
    import jax.numpy as jnp
    from repro import configs as ref_configs
    from repro.models import build_model
    from repro.train import optimizer as ref_opt
    from repro.train.train_step import make_train_step
    from repro_torch.convert import lm_layers_from_params

    def flat(tree):
        return lm_layers_from_params(jax.tree.map(np.asarray, tree))
    for dtype in LM_DTYPES:
        cfg = lm_zero1_config(ref_configs, dtype)
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        batch = {k: jnp.asarray(v) for k, v in lm_train_batch(cfg).items()}
        tag = zero1_tag(dtype, True)
        _, grads = jax.jit(jax.value_and_grad(model.loss))(params, batch)
        for k, v in flat(grads).items():
            arrays[f"{tag}/grad/{k}"] = v
        opt = ref_opt.AdamConfig(**LM_TRAIN_OPT)
        new, state, metrics = jax.jit(make_train_step(model, cfg, opt))(
            params, ref_opt.adam_init(params, opt), batch)
        for k in ("loss", "grad_norm"):
            arrays[f"{tag}/{k}"] = np.asarray(metrics[k])
        arrays[f"{tag}/count"] = np.asarray(state["count"])
        for name, tree in (("params", new), ("m", state["m"]),
                           ("v", state["v"])):
            for k, v in flat(tree).items():
                arrays[f"{tag}/{name}/{k}"] = v


def _lm_train_reference(arrays):
    """``_lm_train_rank_cases``' runs on the reference's unsharded model:
    ``jax.value_and_grad`` of ``model.loss`` (float32) and one
    ``make_train_step`` from ``adam_init`` in both compute dtypes (the new
    parameters, ``m``, ``v``, the count and the metrics), every leaf flat
    by ``convert.lm_layers_from_params``' keys."""
    import jax
    import jax.numpy as jnp
    from repro import configs as ref_configs
    from repro.models import build_model
    from repro.train import optimizer as ref_opt
    from repro.train.train_step import make_train_step
    from repro_torch.convert import lm_layers_from_params

    def flat(tree):
        return lm_layers_from_params(jax.tree.map(np.asarray, tree))
    for dtype in LM_DTYPES:
        cfg = lm_train_config(ref_configs, dtype)
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        batch = {k: jnp.asarray(v) for k, v in lm_train_batch(cfg).items()}
        tag = f"lm_train/{dtype}"
        if dtype == "float32":
            loss, grads = jax.jit(jax.value_and_grad(model.loss))(params,
                                                                  batch)
            arrays[f"{tag}/loss"] = np.asarray(loss)
            for k, v in flat(grads).items():
                arrays[f"{tag}/grad/{k}"] = v
        opt = ref_opt.AdamConfig(**LM_TRAIN_OPT)
        new, state, metrics = jax.jit(make_train_step(model, cfg, opt))(
            params, ref_opt.adam_init(params, opt), batch)
        for k in ("loss", "grad_norm"):
            arrays[f"{tag}/step/{k}"] = np.asarray(metrics[k])
        arrays[f"{tag}/step/count"] = np.asarray(state["count"])
        for name, tree in (("params", new), ("m", state["m"]),
                           ("v", state["v"])):
            for k, v in flat(tree).items():
                arrays[f"{tag}/step/{name}/{k}"] = v


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


def _lm_reference_cases(arrays, cases=None):
    """``_lm_rank_cases``' inputs (``cases``, every case of ``LM_ALL`` by
    default) through the reference's unsharded model:
    the prefill step's logits, each teacher-forced decode step's, the
    cache after the three, Whisper's cross cache from ``prefill_cross``,
    and every MoE layer's chosen experts (its ``jax.lax.top_k``, read by
    an ordered debug callback)."""
    import jax
    import jax.numpy as jnp
    from repro import configs as ref_configs
    from repro.models import build_model

    routes = []
    top_k = jax.lax.top_k

    def recorded(x, k):
        vals, idx = top_k(x, k)
        jax.debug.callback(lambda i: routes.append(np.asarray(i)), idx,
                           ordered=True)
        return vals, idx
    jax.lax.top_k = recorded
    done = {}            # cases of one config (two grids) run once
    try:
        for key, arch, _, over in LM_ALL if cases is None else cases:
            for dtype in LM_DTYPES:
                tag = f"lm/{key}/{dtype}"
                same = (arch, tuple(sorted(over.items())), dtype)
                if same in done:
                    for k in [k for k in arrays if k.startswith(
                            done[same] + "/")]:
                        arrays[tag + k[len(done[same]):]] = arrays[k]
                    continue
                done[same] = tag
                cfg = case_config(ref_configs, key, dtype)
                model = build_model(cfg)
                params = model.init(jax.random.PRNGKey(0))
                inputs = lm_inputs(cfg)
                extra = (jnp.asarray(inputs["patches"]),) \
                    if cfg.vision_dim else ()
                if cfg.family == "encdec":
                    extra = (jnp.asarray(inputs["frames"]),)
                routes.clear()
                logits, _ = jax.jit(model.apply)(
                    params, jnp.asarray(inputs["tokens"]), *extra)
                arrays[f"{tag}/prefill"] = np.asarray(logits[:, -1],
                                                      np.float32)
                jax.effects_barrier()
                for layer, idx in enumerate(routes):
                    arrays[f"{tag}/route/prefill/{layer}"] = idx
                cache = {k: jnp.asarray(inputs[k], getattr(jnp, dt))
                         for k, dt in cache_dtypes(cfg).items()}
                step = jax.jit(model.decode_step)
                for i, pos in enumerate(LM_DECODE_POS):
                    routes.clear()
                    logits, cache = step(params, cache,
                                         jnp.asarray(inputs["steps"][i]),
                                         jnp.int32(pos))
                    arrays[f"{tag}/decode{i}"] = np.asarray(logits,
                                                            np.float32)
                    jax.effects_barrier()
                    for layer, idx in enumerate(routes):
                        arrays[f"{tag}/route/decode{i}/{layer}"] = idx
                for k in cache:
                    arrays[f"{tag}/cache_{k}"] = np.asarray(cache[k],
                                                            np.float32)
                if cfg.family == "encdec":
                    filled = jax.jit(model.prefill_cross)(
                        params, model.init_cache(LM_BATCH, LM_SEQ,
                                                 jnp.float32),
                        jnp.asarray(inputs["frames"]))
                    for k in ("cross_k", "cross_v"):
                        arrays[f"{tag}/prefill_{k}"] = np.asarray(filled[k])
    finally:
        jax.lax.top_k = top_k


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
