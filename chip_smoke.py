#!/usr/bin/env python3
"""GPU smoke run of the PyTorch / CUDA port: `python3 chip_smoke.py`.

Needs one NVIDIA GPU (built for Hopper, sm_90a) and `nvcc`; takes no
arguments.  It builds every hand-written kernel from the sources in this
checkout, holds each against its plain PyTorch version on the card, and
drives the port's two paths at full size through `repro_torch.api`:

* batched max-reachability through `build_engine(h, "hl-index",
  use_kernels=True)` (the `label_join` kernel, through its gather entry
  point `label_join_gather`, which reads the label rows by vertex id);
* the request service over that engine (`api.serve`, `ReplicaGroup`):
  seeded multi-tenant traffic in micro-batches of one `label_join_gather`
  launch each, one scoped update on the full graph and the snapshot
  swapped in, two replicas patched row-wise, and 20 update batches on a
  small graph (with the `closure` backend's rebuilds counted);
* the dense closure through `build_engine(h, "closure", method=...)` at
  the published size of primary-school (242 vertices, 12,704 hyperedges):
  the `overlap` kernel forms the line graph, 14 launches of
  `maxmin_matmul` or of `threshold_step` close it;
* the index-free and baseline backends on email-Eu at its published size
  (998 vertices, 25,800 hyperedges), past the label budget: `auto` builds
  `online` and `frontier` (sparse line-graph sweeps on the card, tensor
  ops), `ete` joins its snapshot through `label_join_gather`, `threshold`
  and the MST oracle answer beside them, one update on `online` and
  `frontier`; then `frontier` on the main path's graph beside `hl-index`;
* the five workload families (`repro_torch.workloads`): on the main
  path's engine after the service's updates, `top_s` / `mr_set` /
  `mr_from_set` through one `label_join_gather` launch each, witnesses,
  `s_reach_k` (held to `frontier`'s bounded sweep on the card) and
  `s_distance` on the host, then all seven request kinds mixed through
  `api.serve`; on email-Eu `frontier.s_reach_k` against Base* and
  `ete`'s label ops; on the closure engine witnesses and `top_s`;
* the durable store (`repro_torch.store`) on the main path's engine after
  those phases: a checkpoint through the service, loads with and without
  CRCs, a restart of the service on the card (`label_join_gather`, held
  to the plain join of the restored snapshot), a write-ahead log of 8
  records replayed and its torn tail dropped; a primary-school `closure`
  checkpoint (645 MB of W*) restored and one insert replayed through
  `overlap` + `threshold_step` (W* held to a plain closure); loads and
  restarts timed from the page cache and with the files evicted from
  it; and `build_sharded` through its fork pool with CUDA live;
* the `sharded` backend on a logical block grid (`api.make_mesh`), right
  after the closure: on primary-school the closure regime built three
  times (1 x 1 allgather, 2 x 2 allgather, 2 x 2 ring: 14, 56 and 112
  float32 `maxmin_matmul` launches), W* held to a plain closure on the
  card and to the `closure` backend's, every pair of its snapshot through
  `label_join_gather`; the threshold closure on a (1, 2, 2) grid (14
  `threshold_step` launches); the mesh overlap route (one `overlap`
  launch, CSR equal to the host pass); the label regime on the main
  path's graph (labels equal to `main_path`'s, 2^20 pairs through
  `label_join_gather`); scoped churn in both regimes, a `ReplicaGroup`
  and the three store payloads on 4 x ENG-s;
* the `sharded` closure on real ranks (`api.make_process_mesh`), right
  after: four spawned gloo ranks share the card, one block of a 2 x 2
  `ProcessMesh` each, over primary-school's W; each builds the closure
  through `build_engine` (`allgather`: 14 float32 `maxmin_matmul`
  launches a rank) and through `sharded_maxmin_closure` (`ring`: 28),
  its block held to the logical 2 x 2 W*, answers 4,096 seeded pairs
  through `label_join_gather` off the replicated snapshot (equal on
  every rank, held to the plain join), runs the threshold closure on
  1 x 2 x 2 (2 rounds, held to the logical route) and
  `compressed_allreduce` of a `qwen3-1.7b` layer's MLP gradient
  (bit-equal to the one-process version); then one rank runs the
  closure and a batch in a one-rank NCCL group;
* the label regime, the overlap route and updates on real ranks, right
  after: the same four gloo ranks on a 2 x 2 `ProcessMesh` build the
  walmart-trips labels through `build_sharded` across the ranks (each
  rank its shards, labels exchanged by one ragged all-gather; held to
  the main path's by digest), keep a `to_mesh` block of the snapshot
  each, answer 2^16 seeded pairs by gathering the query rows across the
  ranks and joining them through `label_join` (held to the plain join
  on a whole snapshot), take an update over fresh vertices and answer
  again; then serve on the ranks (rank 0 leads, ranks 1-3 follow its
  stream): a threaded service answers 16,384 MR and 4,096 s-reach
  requests of two tenants (one `label_join` launch a padded batch a
  rank, every answer held to the engine's), takes an update through its
  stream and answers on the new vertices; a `ReplicaGroup` of 2 (copies
  byte-equal and private); a checkpoint into an `IndexStore`, one
  journaled update, and `ReachabilityService.restore` on the ranks to
  the live service's answers; form primary-school's neighbor index by
  the rank overlap route (one `overlap_rows` launch a rank, its rows of
  W, equal to the host pass); and churn ENG-s's closure regime through
  scoped updates that grow the slot padding, each W* block held to a
  logical engine's, then save it on the ranks (W* blocks to rank 0, the
  file equal to the logical engine's) and load it a block a rank;
  `overlap_rows` is held to its plain version and timed alone first;
* the benchmark suite and the examples (`repro_torch.benchmarks`,
  `repro_torch.examples`), last: every script through its `main` at its
  `--quick` sizes (its JSON into `build/bench_torch/`), the four examples,
  the docs check, then exp1, `kernels_bench` and `bench_serving` at the
  published sizes on the engines `main_path` and `closure_path` built;
* the closure dry-run at a quarter of the paper's production size, m =
  16,384 (`repro_torch.launch.closure_dryrun.main`, in process; at 65,536
  its rounds alone took some 115 s, at 32,768 some 17 s): eight records
  under `build/dryrun_core` (each cell priced at H100 rates, with the
  collective bytes a round's blocks read), and each distinct round run
  once on the card on W of a walmart-trips-shaped graph (one `overlap`,
  256 float32 `maxmin_matmul` launches of `[1,024, 16,384] x [16,384,
  1,024]` for the allgather round, 4,096 of `[1,024]^3` for the ring
  round, 32 + 6 `threshold_step` slices of `[1, 16,384, 16,384]`), 64 x 64 sampled
  entries of each held to the plain version; then each of these kernels
  at the production shapes (m = 65,536) beside its bound and library
  call;
* LM serving through `repro_torch.launch.serve`, every model at its
  published widths with its depth cut: `qwen3-1.7b` on 4 of its 28
  layers, `qwen2-moe-a2.7b` on 2 of 24 (60 experts, top-4),
  `falcon-mamba-7b` on 8 of its 64 Mamba blocks, `recurrentgemma-2b` on
  one (rec, rec, attn) group + 2 rec of its 8 groups (window 2,048) and
  `whisper-large-v3` on 4 + 4 of its 32 + 32 layers (seeded frames `[4,
  1,500, 1,280]` encoded into the cross K/V first);
  random seeded weights on the card, 4 prompts of 16 tokens prefilled
  through the cache and 8 greedy tokens, each held to its own forward
  by the reference's teacher-forced decode check;
* LM training through `repro_torch.launch.train.run_training`:
  `qwen3-1.7b` at its published widths on 4 of its 28 layers (batch 8,
  sequence 256, the config's 4 microbatches, `SyntheticStream` seed 0,
  10 AdamW steps with a checkpoint at the end), the loss held to fall;
  then the restart check at the same widths on 2 layers under
  deterministic algorithms: 10 steps with a checkpoint at 5, a fresh
  model resumed from it, the parameters held to the uninterrupted run's
  at rtol 1e-5, atol 1e-6;
* the LM dry-run (`repro_torch.launch.dryrun.main`, in process): all 80
  (arch x shape x mesh) records under `build/dryrun_lm` (64 priced, 16
  skipped), the roofline of both meshes at H100 rates, then one card's
  share of three `qwen3-1.7b` cells at its published widths on 4 of its
  28 layers run through the port's own steps: `train_4k` on a 64 x 1
  mesh (4 x 2,048 tokens, 4 microbatches), `prefill_32k` on 32 x 1 cut
  to 1 x 2,048 tokens and `decode_32k` on 128 x 1 (one token over a
  32,768-deep cache), each timed once after a warm-up beside its bound
  and checked; then the
  serving cells with the `model` axis split, on four spawned gloo ranks
  sharing the card as a (data, model) = (1, 4) `ProcessMesh`, or (2, 2)
  for a cell whose model axis is 2 (`lower_cell(..., ranks=pm)`: each
  rank its block of every parameter, of the cache and of the batch, the
  collectives over `model`): `decode_32k` on 128 x 4 and a prefill on 32
  x 4 cut to 2,048 tokens, for `qwen3-1.7b` on 4 layers, for
  `qwen2-moe-a2.7b`'s widths on 2 layers with FFN-split experts and with
  expert-parallel ones (an all-to-all each way over `model`), for
  `falcon-mamba-7b` on 4
  of its 64 layers and `whisper-large-v3` on 4 + 4 of its 32 + 32, for
  `recurrentgemma-2b` on one (rec, rec, attn) group and the two-rec
  tail on 128 x 2 and 32 x 2, and `llava-next-mistral-7b`'s prefill on 4
  of its 32 layers; each rank's gathered logits byte-equal to the
  others' and held to the one-process run of the cell's data rows
  (float32 compute and bf16) by the bf16 departure gate, each rank's
  peak under 2 / (d x k) of the one-process run's (d x k the ranks'
  grid: the run covers their d data rows, k the model axis), each
  rank's counted collectives equal to the closed form's, every MoE
  layer's routing and the hybrid's window equal along the line, the
  recurrent states advanced in every channel of the rank; then
  `qwen3-1.7b`'s training step on (1, 4) ranks (`train_4k`, 4 rows of
  2,048 tokens, 2 of its 28 layers, in float32 and bf16): each rank's
  step held to the one-process float32 step (loss, gradient norm, a
  strided sample of the new parameters and of the first moments) and,
  in bf16, by the departure gate over that sample; every gradient
  non-zero before the update, the replicated parameters and the metrics
  equal along the line, the collectives the closed form's; and the same
  step on (2, 2) ranks (8 rows, 4 a data coordinate): the gradient
  reduce-scattered over `data` to each rank's ZeRO-1 shard of the
  moments, the new parameters all-gathered, held as above and with every
  parameter block equal along its data line and the ranks' first-moment
  shards covering the one-process sample; then the MoE and VLM
  families' training step on (1, 4) ranks (`train_4k`, 4 rows of 2,048
  tokens, one a microbatch, 2 layers, in float32 and bf16):
  `qwen2-moe-a2.7b`'s widths with FFN-split experts (their tokens' and
  gates' gradients summed where they enter) and with expert-parallel
  ones (the all-to-alls run in reverse in the backward), and
  `llava-next-mistral-7b`'s, each held as the dense step is (the two
  expert layouts to one one-process step).

The host-only references (the MST oracle of walmart-trips,
primary-school and email-Eu; email-Eu's ETE and threshold-component
indexes) are built in two spawned worker processes, without CUDA, while
the card's phases before their use run; each phase waits for its own and
holds its graph to the one it drives.

and checks the answers.  Any failed phase raises: the script then exits
non-zero and prints no result line.  Without a CUDA device it exits
non-zero at once.

Output: one `ptxas <kernel>: ...` line per library (registers, shared
memory, spills, warnings), then one JSON object per line: `env` (with the
SASS's HGMMA / HMMA / UTMALDG counts), `kernel_checks` (one per kernel),
`main_path`, `service_path`, `workloads_path`, `store_path`, `wide_labels`,
`closure_path`, `closure_path_kernels`, `sharded_path`, `rank_path`,
`rank_label_path`, `closure_small`,
`backends_path`, `bench_path`, `dryrun_path` (after one line per cell
from the dry-run itself), `lm_serve_path`, `lm_train_path`,
`lm_dryrun_path` (after one line per cell from the LM dry-run, one per
one-process run and one per rank cell)
(`closure_path` and `backends_path` each with a `workloads` part), then
`{"kernels": [...]}` (per kernel: launches on its path, error against the
plain version, times and the roofline bound;
`label_join_gather` is the gather entry point of `label_join`), the
card's name and power limit as `nvidia-smi` prints them, and last
`{"ok": true, "device": {...}}`.  Each phase line carries its own
`seconds`.

The two tensor-core kernels (`overlap`, `threshold_step`) run on bf16 0/1
operands: they are held against their plain versions in float32 and in
bf16, on shapes that need the wrappers' zero pad and shapes that do not,
and timed at the path's dtype (bf16), with the library call in bf16
(`library_ms`) and in float32 (`library_f32_ms`).

Times: a kernel's time is CUDA events around a run of launches back to
back on resident operands, over their count, the median of three runs
after warm-up (operands up to a few tens of MB stay in the 50 MB L2
between launches; the larger shapes do not).  A kernel shorter than its
wrapper's host cost (some 40 us) is then timed as that cost.  The
`label_join` gather entry point is also timed "cold": each launch alone,
after a 256 MB scratch tensor is written, so that nothing of its operands
is left in L2 (the card is busy with the write while the host enqueues
the launch, so this time is the kernel's own).  A batch's time is the host
clock around `mr_batch`, host<->device copies included; `main_path` also
reports the rise in peak device memory of a 2^20 batch.  `service_path`
times each run of the traffic on the host clock (submission to the last
answer) and splits a second, instrumented run of it by micro-batch step;
the device's idle share there is 1 - the kernels' own time (queued back
to back behind a spin of the card, at each batch's bucket) over the run's
time.
float32 products run in full float32: TF32 is switched off and checked.
"""
from __future__ import annotations

import contextlib
import ctypes
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

# the LM restart check runs under torch.use_deterministic_algorithms, which
# needs cuBLAS's workspace configuration fixed before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import torch  # noqa: E402

# the repo's own modules (torch and numpy only); the H100's rates, each
# kernel's bound and the published-size graphs come from them
sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.benchmarks.datasets import dataset_params  # noqa: E402
from repro_torch.benchmarks.roofline import (  # noqa: E402
    BF16_TENSOR_OPS_PER_S, HBM_BYTES_PER_S, INT8_TENSOR_OPS_PER_S, RATES,
    bf16_ceiling_ms, fill_rates, label_join_bound, label_join_gather_bound,
    maxmin_bound, overlap_bound, overlap_rows_bound, sweep_bound_bytes,
    threshold_bound)

LABEL_JOIN_CORPUS = [          # (q, l, seed): the reference's adversarial shapes
    (5, 7, 0), (130, 33, 1), (1, 1, 2), (64, 300, 3), (31, 129, 4),
    (0, 5, 5), (3, 0, 6),
]
MAIN_PATH_SHAPES = [(1024, 15), (4096, 121), (2**20, 15), (65536, 256)]
# malformed rows (repeated ranks whose s rises) on both kernel routes
DUPLICATE_SHAPES = [(4096, 15, 31), (1024, 121, 32)]
# bytes written between cold launches: five times the H100's 50 MB L2
L2_FLUSH_BYTES = 256 * 2**20
# a 2^20 mr_batch may raise the device's peak allocation by less than this
BATCH_PEAK_LIMIT = 64 * 2**20
INT32_MAX = int(np.iinfo(np.int32).max)

# the reference harness's corpora (tests/test_kernels_diff.py)
MAXMIN_CORPUS = [(33, 32, 17, 0), (1, 1, 1, 1), (8, 37, 9, 2), (0, 4, 4, 3),
                 (4, 0, 4, 4), (4, 4, 0, 5), (64, 64, 64, 6)]
OVERLAP_CORPUS = [(10, 17, 0), (1, 1, 1), (0, 5, 2), (5, 0, 3), (130, 40, 4)]
THRESHOLD_CORPUS = [(1, 16, 0), (3, 33, 1), (0, 8, 2), (2, 0, 3)]
# beyond the corpora: m and n that need the kernels' zero pad (not a
# multiple of 8) and ones that do not, across several tiles
THRESHOLD_EXTRA = [(2, 299, 9), (2, 300, 10), (1, 257, 11)]
OVERLAP_EXTRA = [(300, 129, 9), (301, 256, 10), (12_704, 242, 11)]
# primary-school at its published size (242 vertices, 12,704 hyperedges,
# edge sizes 2-5, seed 4)
CLOSURE_GRAPH = dataset_params("PS")
# ENG-s, the repo's small engine graph: every pair is checked
SMALL_GRAPH = dataset_params("ENG-s")
# walmart-trips at its published size (89,000 / 70,000, sizes 2-8, seed 6)
MAIN_GRAPH = dataset_params("WA")
DENSE_KERNELS = ("maxmin_matmul", "overlap", "threshold_step")
TENSOR_CORE_KERNELS = ("overlap", "threshold_step")
# one medium timed shape per dense kernel: [M]^3 maxmin, B [m, n], R [S, m, m]
MEDIUM_MAXMIN = 2048
MEDIUM_OVERLAP = (2048, 512)
MEDIUM_THRESHOLD = (5, 2048)
# the request service's traffic on the main path: MR and s-reach requests
# (s in 1..8), three tenants of weights 1 / 2 / 4, mixed priorities;
# admission at ServiceConfig()'s max_batch, then a 16x larger one (the
# traffic halved from 65,536 + 16,384 since the MoE and VLM train rank
# cells came, for the script's time: the larger admits it in one batch)
SERVICE_MR_REQUESTS = 32_768
SERVICE_SREACH_REQUESTS = 8_192
SERVICE_TENANTS = (("t1", 1.0), ("t2", 2.0), ("t4", 4.0))
SERVICE_BATCHES = (4096, 65_536)
TRICKLE_REQUESTS = 1000
# requests submitted while the full-graph update runs, one per gap
STALL_REQUESTS = 8
STALL_GAP_S = 1.0
# email-Eu at its published size (998 vertices, 25,800 hyperedges, edge
# sizes 2-6, seed 5): past the label budget, so `auto` plans `online`
# (trickle) and `frontier` (batch)
EMAIL_EU = dataset_params("EE")
FRONTIER_PAIRS = 1024
ETE_PAIRS = 2**16
# Base* (online) costs seconds per query at email-Eu's degree; the pairs
# are chosen so that frontier's answers on them span its distinct values
# (its lowest and highest: cut from 4 to 2 pairs to keep the script in its
# time; each pair costs two Base* queries of about 3 s and an ete witness
# of up to 13 s)
ONLINE_PAIRS = 2
# the workload families on the main path's engine (workloads_path): top_s
# of 64 seeded sources (k = 10); 8 mr_set of |U| = |V| = 256 (65,536
# pairs); 8 mr_from_set of |U| = 64 to 4,096 targets; 8 witnesses on
# pairs of distinct MR; s_reach_k on 128 pairs at s = their MR, k = 1..4;
# s_distance on 64 pairs at s = 2 (mr_set, mr_from_set and s_reach_k
# halved from 16, 16 and 256 since the MoE and VLM train rank cells
# came, for the script's time; top_s and s_distance feed the service's
# mixed traffic, WORKLOAD_TRAFFIC, whole)
TOP_S_SOURCES, TOP_S_K = 64, 10
MR_SET_CALLS, MR_SET_SIZE = 8, 256
FROM_SET_CALLS, FROM_SET_SOURCES, FROM_SET_TARGETS = 8, 64, 4096
WITNESS_PAIRS = 8
S_REACH_K_PAIRS, S_REACH_K_MAX = 128, 4
S_DISTANCE_PAIRS, S_DISTANCE_S = 64, 2
# the service's mixed traffic (kinds -> requests; mr_set sets of 64)
WORKLOAD_TRAFFIC = {"mr": 4096, "s_reach": 4096, "top_s": 64, "mr_set": 64,
                    "s_reach_k": 64, "witness": 8, "s_distance": 64}
SERVICE_MR_SET_SIZE = 64
# email-Eu (backends_path engines): frontier's bounded sweep against Base*
# on 64 pairs; ete's label ops on a few sources, sets and pairs
EMAIL_EU_S_REACH_K = dict(pairs=64, s=(1, 2), k=(1, 2, 3))
EMAIL_EU_TOP_S, EMAIL_EU_SETS, EMAIL_EU_SET_SIZE = 4, 4, 16
# the closure engine of closure_path (primary-school); its W* rows held to
# the MST oracle's forest for the first pairs' vertices (cut from 8 to 4
# pairs to keep the script in its time: a pair is a long host walk of the
# forest)
CLOSURE_ORACLE_PAIRS = 4
# (witnesses cut from 4 to 2 for the same reason: each is a long host BFS
# on this dense graph; the first ones cover each distinct MR)
CLOSURE_WITNESSES, CLOSURE_TOP_S = 2, 8
# the store (store_path): 2^20 pairs through the restored engine; 8,192
# MR / s-reach requests through the restored service; a WAL of 7 inserts
# over degree-0 vertices (sizes 2-4) and 1 delete of one of them; the
# closure's W* of primary-school (645,561,856 B) with 1 replayed insert;
# build_sharded on 4 disjoint copies of ENG-s, 2 workers, 4 shards
STORE_PAIRS, STORE_REQUESTS = 2**20, 8192
STORE_INSERT_SIZES = (2, 3, 4, 2, 3, 4, 2)
STORE_DISK_BYTES = 700 * 2**20
SHARDED_COPIES, SHARDED_WORKERS = 4, 2
# sharded_path: the plain label join on the closure snapshot (L = 12,704)
# makes a [Q, L, L] cube, so it is timed on this many pairs only
PLAIN_PAIRS = 64
# rank_path: four gloo ranks on one card, a 2 x 2 ProcessMesh over
# primary-school's W; the seeded pairs every rank answers; the threshold
# closure's ladder capped for the script's time; a rank's gradient is one
# LM_ARCH layer's three MLP weights; every rank done within the limit
RANK_WORLD, RANK_GRID = 4, (2, 2)
RANK_PAIRS = 4096
RANK_THRESHOLD_ROUNDS = 2
RANK_TIMEOUT_S = 300
# rank_label_path: the same four ranks and grid; 2^16 seeded pairs on
# 89k/70k through the label blocks; the churn on ENG-s inserts over fresh
# vertices (each a component of its own: a scoped update), two of them
# past the free slots, then deletes one and reuses its slot
RANK_LABEL_PAIRS = 2**16
RANK_LABEL_TIMEOUT_S = 300
# rank_label_path's services on the same ranks: rank 0 leads, ranks 1-3
# follow; MR and s-reach requests (s in 1..8) on the pairs already
# answered, two tenants, max_batch 4,096; a ReplicaGroup of 2 copies on
# RANK_REPLICA_REQUESTS of them
RANK_SERVE_MR, RANK_SERVE_SREACH = 16_384, 4_096
RANK_SERVE_BATCH = 4096
RANK_SERVE_TENANTS = (("t1", 1.0), ("t2", 2.0))
RANK_REPLICAS, RANK_REPLICA_REQUESTS = 2, 8192

# bench_path: the four examples, then at the published sizes exp1's Min-*
# rows on 4,096 pairs and a 2^20 label_join_gather batch on 89k/70k, and
# the service against per-call queries on 10,000 mixed requests there and
# 4,096 on primary-school's closure engine
# dryrun_path: the closure dry-run's cells at a quarter of the paper's
# production size (its rounds took 110-120 s of the script's time limit
# at m = 65,536, some 17 s at 32,768), then each kernel at the
# production shapes
DRYRUN_M = 65_536
DRYRUN_RUN_M = 16_384
DRYRUN_S = 32
DRYRUN_OUT = Path(__file__).resolve().parent / "build" / "dryrun_core"
# lm_serve_path: the serving launcher at published LM widths
LM_ARCH = "qwen3-1.7b"                 # published widths, depth cut
LM_MOE_ARCH = "qwen2-moe-a2.7b"        # published widths, depth cut
LM_MOE_LAYERS = 2
# the other families at their published widths
LM_FAMILY_ARCHS = ("falcon-mamba-7b", "recurrentgemma-2b",
                   "whisper-large-v3")
# lm_serve_path's depth a model (decoder and encoder alike), cut from
# the published depths (28, 64, 26, 32 + 32) for the script's time since
# the MoE and VLM train rank cells came: qwen3-1.7b, falcon-mamba-7b,
# recurrentgemma-2b (one (rec, rec, attn) group and the two-rec tail)
# and whisper-large-v3
LM_SERVE_LAYERS = {"qwen3-1.7b": 4, "falcon-mamba-7b": 8,
                   "recurrentgemma-2b": 5, "whisper-large-v3": 4}
# lm_train_path: run_training at LM_ARCH's widths on LM_TRAIN_RUN_LAYERS
# of its 28 layers (all 28 until the MoE and VLM train rank cells came),
# then the restart check at its widths on LM_RESTART_LAYERS layers
# (10 steps since the train rank cells came, 12 before: the check's first
# and last five losses stay apart)
LM_TRAIN_STEPS, LM_TRAIN_BATCH, LM_TRAIN_SEQ = 10, 8, 256
LM_TRAIN_RUN_LAYERS = 4
LM_RESTART_LAYERS, LM_RESTART_STEPS, LM_RESTART_AT = 2, 10, 5
RESTART_TOL = dict(rtol=1e-5, atol=1e-6)  # tests/test_train_infra.py:122
# 8 greedy tokens since PR 30 (16 before; a cut for the script's time)
LM_BATCH, LM_PROMPT, LM_GEN = 4, 16, 8
# lm_dryrun_path: the LM dry-run over every (arch x shape x mesh) cell,
# then one card's share of three LM_ARCH cells at the full published
# config (data-parallel meshes: model axis 1)
LM_DRYRUN_OUT = Path(__file__).resolve().parent / "build" / "dryrun_lm"
# (cell, its seq_len, mesh); the prefill cut from 32,768 to
# LM_PREFILL_SEQ tokens for the script's time (4,096 until the train rank
# cells came): the cell LM_RANK_CELLS runs on ranks, whose one-process
# bf16 run this is; train_4k cut from 4,096 to LM_PREFILL_SEQ tokens
# since the MoE and VLM train rank cells came
LM_PREFILL_SEQ = 2_048
# LM_ARCH's widths on LM_DRYRUN_LAYERS of its 28 layers in these three
# cells and in the dense rank cells (all 28 until the MoE and VLM train
# rank cells came; cut for the script's time)
LM_DRYRUN_LAYERS = 4
LM_DRYRUN_DEPTH = {"n_layers": LM_DRYRUN_LAYERS}
LM_DRYRUN_RUNS = (("train_4k", LM_PREFILL_SEQ, (64, 1)),
                  ("prefill_32k", LM_PREFILL_SEQ, (32, 1)),
                  ("decode_32k", 32_768, (128, 1)))
LM_DRYRUN_CELLS = {"ok": 64, "skipped": 16}
LM_DRYRUN_RUN_REPS = 1                 # timed passes after the warm-up
# then RANK_WORLD gloo ranks share the card as a (data, model)
# ProcessMesh, (1, 4) unless a cell's model axis is 2 ((2, 2):
# lm_rank_grid), and run serving cells with the model axis split: (label,
# arch, config replacements, cell, its seq_len, the cell's mesh, what was
# cut to size): LM_ARCH's decode_32k whole on (128, 4), and its prefill
# on (32, 4) cut to LM_PREFILL_SEQ tokens (a prefill pass all-reduces 57
# [tokens, 2,048] partial sums through host memory, some 30 s a pass at
# 32,768 tokens); the same two cells of LM_MOE_ARCH's published widths on
# LM_MOE_LAYERS layers in its published FFN-split layout, and in
# arctic-480b's "model+data" expert-parallel layout (15 of the 60
# experts a rank; arctic's own experts, 53.5 GB a layer in float32, do
# not fit beside the one-process reference on one card); LM_VLM_ARCH's
# prefill at its published widths on LM_VLM_LAYERS of its 32 layers, 576
# patches of the LM_PREFILL_SEQ positions (at all 32 layers the cell took 21.5 s
# and its one-process runs some 6 s more, and the script 1,123 s of its
# 1,200 on a slow host; 8 layers until PR 30's cells came); and the
# three families that are not
# transformers, at published widths with their depth cut: falcon-mamba-7b
# on LM_MAMBA_LAYERS of its 64 layers (the decode's state O(1) in the
# cache length), recurrentgemma-2b on one (rec, rec, attn) group and
# the two-rec tail (its 10 heads do not divide 4: (2, 2) ranks, the cells
# on (128, 2) and (32, 2)), whisper-large-v3 on LM_WHISPER_LAYERS of its
# 32 encoder and 32 decoder layers (1,500 frames).  Each held to the
# one-process run of its cell at model axis 1 over the ranks' data rows
# (float32 compute and bf16; the two expert layouts share theirs: at
# model axis 1 the layout splits nothing) by the departure gate
LM_VLM_ARCH = "llava-next-mistral-7b"  # published widths, depth cut
LM_VLM_LAYERS = 4
LM_MAMBA_ARCH = "falcon-mamba-7b"      # published widths, depth cut
LM_MAMBA_LAYERS = 4
LM_HYBRID_ARCH = "recurrentgemma-2b"   # published widths, depth cut
LM_HYBRID_LAYERS = 5
LM_WHISPER_ARCH = "whisper-large-v3"   # published widths, depth cut
LM_WHISPER_LAYERS = 4
# the dense LM's training step on ranks: LM_ARCH's published widths on
# LM_TRAIN_LAYERS of its 28 layers (the backward still crosses a layer
# boundary), LM_RANK_TRAIN_BATCH rows a data coordinate (what one
# device of a (64, 4) mesh trains: one row a microbatch), on the cell
# mesh (1, 4) (the model axis split, no gradient reduction over data)
# and on (2, 2) (8 rows; the gradient reduce-scattered over data to the
# ZeRO-1 shards of the moments, the new parameters all-gathered), both
# cut to LM_PREFILL_SEQ tokens for the script's time (a (2, 2) step
# moves 4.05 GB a rank at 4,096 tokens, 10.9 s in float32; its
# reduce-scatters and all-gathers, 2.17 GB, do not shrink with the
# tokens); in float32 compute (held to the one-process float32 step)
# and the published bf16 (held by the departure gate)
LM_TRAIN_LAYERS = 2
LM_RANK_TRAIN_BATCH = 4
LM_RANK_TRAIN = {"n_layers": LM_TRAIN_LAYERS}
LM_CUT_TRAIN = (f"n_layers: 28 cut to {LM_TRAIN_LAYERS}",
                "mesh: train_4k's (64, 4) device share, 4 rows, on "
                "(1, 4): no data axis to reduce the gradient over",
                f"seq_len: 4,096 cut to {LM_PREFILL_SEQ:,}")
LM_CUT_ZERO1 = (f"n_layers: 28 cut to {LM_TRAIN_LAYERS}",
                "mesh: (64, 4) cut to (2, 2)",
                f"seq_len: 4,096 cut to {LM_PREFILL_SEQ:,}")
# the one-process float32 step against the ranks' float32 step: the loss
# and gradient norm of each pass and a strided sample of each rank's new
# parameters, elementwise; the same sample of the first moments (the
# gradients' trace) by its root-mean-square departure relative to its
# root-mean-square
TRAIN_TOL = dict(rtol=1e-4, atol=1e-4)
TRAIN_MOMENT_RMS = 1e-4
# the float32 MoE train cells' one-process step takes the ranks' experts
# (rank 0's top-k of each MoE layer call, recorded in the cell's run,
# replayed in place of its own: RoutingTape): the ranks' float32 sums part
# from one process's by rounding, which can flip a near-tied top-k choice
# of a token, and one flipped token moves a step's moments far past
# TRAIN_MOMENT_RMS; the tokens one process would have routed otherwise
# are counted and reported (routing_flips).  Each expert layout has its
# own such step, and the cells' bf16 runs are held against it
ROUTED_TRAIN_LABELS = ("moe ffn train", "moe expert-parallel train")
# the MoE and VLM families' training step on ranks: LM_MOE_ARCH's
# widths FFN-split and in LM_CUT_EP's expert-parallel layout, and
# LM_VLM_ARCH's, each on LM_TRAIN_LAYERS layers, the cell mesh (1, 4),
# LM_RANK_TRAIN_BATCH rows at LM_PREFILL_SEQ tokens, one row a
# microbatch (their published 16 and 8 microbatches do not split 4
# rows), in float32 compute (held to the one-process float32 step, which
# the two expert layouts share) and the published bf16
LM_RANK_FAMILY_TRAIN = {"n_layers": LM_TRAIN_LAYERS,
                        "microbatch": LM_RANK_TRAIN_BATCH}
LM_RANK_EP_TRAIN = dict(LM_RANK_FAMILY_TRAIN, expert_sharding="model+data")
LM_CUT_FAMILY_TRAIN = (
    "mesh: train_4k's (64, 4) device share, 4 rows, on (1, 4): no data "
    "axis to reduce the gradient over",
    f"seq_len: 4,096 cut to {LM_PREFILL_SEQ:,}")
LM_CUT_MOE_TRAIN = (
    f"n_layers: 24 cut to {LM_TRAIN_LAYERS}",
    f"microbatch: 16 cut to {LM_RANK_TRAIN_BATCH}") + LM_CUT_FAMILY_TRAIN
LM_CUT_VLM_TRAIN = (
    f"n_layers: 32 cut to {LM_TRAIN_LAYERS}",
    f"microbatch: 8 cut to {LM_RANK_TRAIN_BATCH}") + LM_CUT_FAMILY_TRAIN
LM_RANK_MOE = {"n_layers": LM_MOE_LAYERS}
LM_RANK_EP = dict(LM_RANK_MOE, expert_sharding="model+data")
LM_CUT_SEQ = f"seq_len: 32,768 cut to {LM_PREFILL_SEQ:,}"
LM_CUT_DENSE = f"n_layers: 28 cut to {LM_DRYRUN_LAYERS}"
LM_CUT_MOE = f"n_layers: 24 cut to {LM_MOE_LAYERS}"
LM_CUT_EP = ("expert_sharding: arctic-480b's 'model+data' on "
             "qwen2-moe-a2.7b's widths (arctic's experts, 53.5 GB a layer "
             "in float32, do not fit beside the one-process reference)")
LM_RANK_CELLS = (
    ("dense", LM_ARCH, LM_DRYRUN_DEPTH, "decode_32k", 32_768, (128, 4),
     (LM_CUT_DENSE,)),
    ("dense", LM_ARCH, LM_DRYRUN_DEPTH, "prefill_32k", LM_PREFILL_SEQ,
     (32, 4), (LM_CUT_DENSE, LM_CUT_SEQ)),
    ("moe ffn", LM_MOE_ARCH, LM_RANK_MOE, "decode_32k", 32_768, (128, 4),
     (LM_CUT_MOE,)),
    ("moe ffn", LM_MOE_ARCH, LM_RANK_MOE, "prefill_32k", LM_PREFILL_SEQ,
     (32, 4), (LM_CUT_MOE, LM_CUT_SEQ)),
    ("moe expert-parallel", LM_MOE_ARCH, LM_RANK_EP, "decode_32k", 32_768,
     (128, 4), (LM_CUT_MOE, LM_CUT_EP)),
    ("moe expert-parallel", LM_MOE_ARCH, LM_RANK_EP, "prefill_32k",
     LM_PREFILL_SEQ, (32, 4), (LM_CUT_MOE, LM_CUT_EP, LM_CUT_SEQ)),
    ("vlm", LM_VLM_ARCH, {"n_layers": LM_VLM_LAYERS}, "prefill_32k",
     LM_PREFILL_SEQ, (32, 4),
     (f"n_layers: 32 cut to {LM_VLM_LAYERS}", LM_CUT_SEQ)),
    ("ssm", LM_MAMBA_ARCH, {"n_layers": LM_MAMBA_LAYERS}, "decode_32k",
     32_768, (128, 4), (f"n_layers: 64 cut to {LM_MAMBA_LAYERS}",)),
    ("ssm", LM_MAMBA_ARCH, {"n_layers": LM_MAMBA_LAYERS}, "prefill_32k",
     LM_PREFILL_SEQ, (32, 4), (f"n_layers: 64 cut to {LM_MAMBA_LAYERS}",
                               LM_CUT_SEQ)),
    ("hybrid", LM_HYBRID_ARCH, {"n_layers": LM_HYBRID_LAYERS}, "decode_32k",
     32_768, (128, 2), (f"n_layers: 26 cut to {LM_HYBRID_LAYERS} (one "
                        f"group and the two-rec tail)",)),
    ("hybrid", LM_HYBRID_ARCH, {"n_layers": LM_HYBRID_LAYERS},
     "prefill_32k", LM_PREFILL_SEQ, (32, 2),
     (f"n_layers: 26 cut to {LM_HYBRID_LAYERS} (one group and the "
      f"two-rec tail)", LM_CUT_SEQ)),
    ("encdec", LM_WHISPER_ARCH, {"n_layers": LM_WHISPER_LAYERS,
                                 "enc_layers": LM_WHISPER_LAYERS},
     "decode_32k", 32_768, (128, 4),
     (f"n_layers, enc_layers: 32 cut to {LM_WHISPER_LAYERS}",)),
    ("encdec", LM_WHISPER_ARCH, {"n_layers": LM_WHISPER_LAYERS,
                                 "enc_layers": LM_WHISPER_LAYERS},
     "prefill_32k", LM_PREFILL_SEQ, (32, 4),
     (f"n_layers, enc_layers: 32 cut to {LM_WHISPER_LAYERS}",
      LM_CUT_SEQ)),
    ("dense train", LM_ARCH, dict(LM_RANK_TRAIN, compute_dtype="float32"),
     "train_4k", LM_PREFILL_SEQ, (1, 4), LM_CUT_TRAIN),
    ("dense train", LM_ARCH, LM_RANK_TRAIN, "train_4k", LM_PREFILL_SEQ,
     (1, 4), LM_CUT_TRAIN),
    ("dense train zero1", LM_ARCH, dict(LM_RANK_TRAIN,
                                        compute_dtype="float32"),
     "train_4k", LM_PREFILL_SEQ, (2, 2), LM_CUT_ZERO1),
    ("dense train zero1", LM_ARCH, LM_RANK_TRAIN, "train_4k",
     LM_PREFILL_SEQ, (2, 2), LM_CUT_ZERO1),
    ("moe ffn train", LM_MOE_ARCH, dict(LM_RANK_FAMILY_TRAIN,
                                        compute_dtype="float32"),
     "train_4k", LM_PREFILL_SEQ, (1, 4), LM_CUT_MOE_TRAIN),
    ("moe ffn train", LM_MOE_ARCH, LM_RANK_FAMILY_TRAIN, "train_4k",
     LM_PREFILL_SEQ, (1, 4), LM_CUT_MOE_TRAIN),
    ("moe expert-parallel train", LM_MOE_ARCH,
     dict(LM_RANK_EP_TRAIN, compute_dtype="float32"), "train_4k",
     LM_PREFILL_SEQ, (1, 4), LM_CUT_MOE_TRAIN + (LM_CUT_EP,)),
    ("moe expert-parallel train", LM_MOE_ARCH, LM_RANK_EP_TRAIN, "train_4k",
     LM_PREFILL_SEQ, (1, 4), LM_CUT_MOE_TRAIN + (LM_CUT_EP,)),
    ("vlm train", LM_VLM_ARCH, dict(LM_RANK_FAMILY_TRAIN,
                                    compute_dtype="float32"),
     "train_4k", LM_PREFILL_SEQ, (1, 4), LM_CUT_VLM_TRAIN),
    ("vlm train", LM_VLM_ARCH, LM_RANK_FAMILY_TRAIN, "train_4k",
     LM_PREFILL_SEQ, (1, 4), LM_CUT_VLM_TRAIN))
LM_RANK_TIMEOUT_S = 600
DECODE_TOL = dict(rtol=2e-2, atol=2e-2)   # the reference's _DECODE_TOL
# bf16 serving: the root-mean-square departure of the decode logits (bf16
# compute, the served bf16 cache) from the float32 forward may be at most
# this many times the bf16 forward's own departure from it
BF16_DEPARTURE_RATIO = 2.0
BENCH_EXAMPLES = ("quickstart", "serving_quickstart", "epidemic_case_study",
                  "distributed_reachability")
BENCH_EXP1_PAIRS, BENCH_JOIN_PAIRS = 4096, 2**20
BENCH_WA_REQUESTS, BENCH_PS_REQUESTS = 10_000, 4096
# the host-only references (numpy, no CUDA): the MST oracle of
# walmart-trips, primary-school and email-Eu, and email-Eu's ETE and
# threshold-component indexes, some 2.5 min of one core in all; a pool of
# spawned processes builds them, in this order, while the card's phases
# before their use run, and a phase waits for its own at most this long
HOST_REFERENCES = (("main", "mst-oracle"), ("email_eu", "ete"),
                   ("closure", "mst-oracle"), ("email_eu", "threshold"),
                   ("email_eu", "mst-oracle"))
HOST_REFERENCE_WORKERS = 2
HOST_REFERENCE_TIMEOUT_S = 900


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str, *fmt: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}",
         "--format=" + ",".join(("csv", "noheader") + fmt)],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def nvidia_smi_line() -> str:
    return nvidia_smi("name,power.limit")


class Phase:
    """Times one phase on the host clock (device work synchronised)."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def seconds(self) -> float:
        torch.cuda.synchronize()
        return round(time.perf_counter() - self.t0, 3)


def host_reference(params, kind):
    """One host-only reference over the seeded graph of ``params``: the
    MST oracle, the ETE index or the threshold-component index (numpy
    only; a worker of ``HostReferences`` runs it).  Returns (the
    structure, its build seconds)."""
    from repro_torch.core import baselines
    from repro_torch.core.hypergraph import random_hypergraph
    build = {"mst-oracle": baselines.MSTOracle, "ete": baselines.build_ete,
             "threshold": baselines.ThresholdComponentIndex}[kind]
    h = random_hypergraph(**params)
    t0 = time.perf_counter()
    ref = build(h)
    return ref, time.perf_counter() - t0


class HostReferences:
    """``HOST_REFERENCES`` built in a pool of ``HOST_REFERENCE_WORKERS``
    spawned processes (the parent has CUDA live; the workers never touch
    it), started when this is made.  ``take(graph, kind, h)`` waits for
    one, holds its graph to ``h`` and returns (the structure, {its build
    seconds in the worker, the parent's wait}); the pool is closed when
    the last is taken, or by ``close()``.  Without a pool (``workers=0``,
    as a rehearsal on the CPU may ask) ``take`` builds in process."""

    open_pools: list = []

    def __init__(self, workers=HOST_REFERENCE_WORKERS):
        self.params = {"main": MAIN_GRAPH, "closure": CLOSURE_GRAPH,
                       "email_eu": EMAIL_EU}
        self._pool, self._jobs = None, {}
        if workers:
            import multiprocessing
            self._pool = multiprocessing.get_context("spawn").Pool(workers)
            HostReferences.open_pools.append(self._pool)
            self._jobs = {job: self._pool.apply_async(
                host_reference, (self.params[job[0]], job[1]))
                for job in HOST_REFERENCES}

    def take(self, graph, kind, h):
        t0 = time.perf_counter()
        job = self._jobs.pop((graph, kind), None)
        ref, build_s = (host_reference(self.params[graph], kind)
                        if job is None else
                        job.get(timeout=HOST_REFERENCE_TIMEOUT_S))
        wait_s = time.perf_counter() - t0
        if not same_graph(ref.h, h):
            raise AssertionError(f"host reference {graph} {kind}: built on "
                                 f"another graph")
        if not self._jobs:
            self.close()
        return ref, {"build_seconds": round(build_s, 3),
                     "wait_seconds": round(wait_s, 3)}

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            HostReferences.open_pools.remove(self._pool)
            self._pool = None

    @classmethod
    def close_all(cls):
        for pool in list(cls.open_pools):
            pool.terminate()
            pool.join()
        cls.open_pools.clear()


def cuda_ms(fn, reps: int, warmup: int = 3, runs: int = 3) -> float:
    """Milliseconds of one call of ``fn`` on the card: CUDA events around
    ``reps`` calls back to back, over ``reps``; the median of ``runs`` such
    runs.  Back to back, the card does not wait for the host between calls
    of a kernel that runs longer than its wrapper's host cost."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def cuda_ms_single(fn, reps: int, warmup: int = 3) -> float:
    """Median milliseconds of one call of ``fn`` with the card idle before
    it (CUDA events around each call alone): the kernel's time plus
    whatever of its wrapper's host cost the card waits for."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_ms_queued(fn, reps: int, warmup: int = 3) -> float:
    """Milliseconds of one call of ``fn`` on the card with its launches
    queued ahead: the card first spins for about 25 ms
    (``torch.cuda._sleep``) while the host enqueues the ``reps`` calls
    behind the start event, so the events time the kernels back to back
    and not the wrapper's host cost, which a short kernel is shorter
    than."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_cold(fn, scratch, reps: int) -> float:
    """Median milliseconds of one call of ``fn`` on the card (CUDA events),
    each call after ``scratch`` (larger than L2) is written, so the call
    finds none of its operands in L2."""
    fn()
    times = []
    for i in range(reps):
        scratch.fill_(i)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` on the host clock; ``fn`` must end with
    its result on the host (so the device work is inside the window)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# -- operands -----------------------------------------------------------------

def corpus_rows(rng, q, l, high, max_rank):
    """Random padded label rows as the reference's differential harness makes
    them: ragged true lengths (all-pad rows included), ascending int32
    ranks, s values in [1, 9)."""
    ranks = np.full((q, l), INT32_MAX, np.int32)
    svals = np.zeros((q, l), np.int32)
    for i in range(q):
        li = int(rng.integers(0, l + 1))
        r = np.unique(rng.integers(0, max(high, 1), li)).astype(np.int64)
        ranks[i, :r.size] = np.minimum(r, max_rank)
        svals[i, :r.size] = rng.integers(1, 9, r.size)
    return ranks, svals


def random_rows(gen, q, l, high, device):
    """[q, l] padded label rows made on the card from a seeded generator:
    strictly ascending ranks below ``high + l``, ragged lengths in [0, l],
    s values in [1, 9), sentinel padding."""
    r = torch.randint(0, high, (q, l), generator=gen, device=device,
                      dtype=torch.int32)
    r = torch.sort(r, dim=1).values + torch.arange(l, device=device,
                                                   dtype=torch.int32)
    s = torch.randint(1, 9, (q, l), generator=gen, device=device,
                      dtype=torch.int32)
    length = torch.randint(0, l + 1, (q, 1), generator=gen, device=device)
    pad = torch.arange(l, device=device)[None, :] >= length
    return (r.masked_fill(pad, INT32_MAX).contiguous(),
            s.masked_fill(pad, 0).contiguous())


def duplicate_rows(rng, q, l, high):
    """Malformed padded label rows: ascending ranks that repeat (few
    distinct values), s values in [1, 9) in any order, sentinel padding."""
    ranks = np.full((q, l), INT32_MAX, np.int32)
    svals = np.zeros((q, l), np.int32)
    for i in range(q):
        li = int(rng.integers(1, l + 1))
        ranks[i, :li] = np.sort(rng.integers(0, high, li))
        svals[i, :li] = rng.integers(1, 9, li)
    return ranks, svals


def snapshot_ids(gen, q, n, device):
    """q random row ids into an [n, L] snapshot, after three that reach its
    first and last rows and repeat: [0, n - 1, 0] on the u side, [n - 1, 0,
    n - 1] on the v side; none at all when n == 0."""
    if n == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=device)
        return empty, empty
    ends = torch.tensor([0, n - 1, 0], dtype=torch.int64, device=device)
    rand = torch.randint(0, n, (2, q), generator=gen, device=device)
    return (torch.cat([ends, rand[0]]).contiguous(),
            torch.cat([ends.flip(0), rand[1]]).contiguous())


def plain_chunked(ref, ru, su, rv, sv):
    """The plain version in row chunks, so its [Q, L, L] cube fits."""
    q, l = ru.shape
    if q == 0 or l == 0:
        return ref(ru, su, rv, sv)
    step = max(1, 2**25 // (l * l))
    return torch.cat([ref(ru[i:i + step], su[i:i + step], rv[i:i + step],
                          sv[i:i + step]) for i in range(0, q, step)])


def plain_gather_chunked(ref, ranks, svals, us, vs):
    """The gather entry point's plain version in id chunks, so its
    [Q, L, L] cube fits."""
    l = ranks.shape[1]
    if us.numel() == 0 or l == 0:
        return ref(ranks, svals, us, vs)
    step = max(1, 2**25 // (l * l))
    return torch.cat([ref(ranks, svals, us[i:i + step], vs[i:i + step])
                      for i in range(0, us.numel(), step)])


# -- phases -------------------------------------------------------------------

def ptxas_lines(log):
    """What ``nvcc -Xptxas -v`` said that matters: each entry function,
    its registers, shared memory and spills, and any warning (ptxas names
    wgmma serialisation there)."""
    keep = ("Compiling entry", "registers", "spill", "warning", "error")
    return [ln.strip() for ln in log.splitlines()
            if any(k in ln for k in keep)]


def sass_counts(nvcc, path):
    """Tensor-core and TMA instructions in a library's SASS
    (``cuobjdump -sass``), or None where the toolkit lacks cuobjdump."""
    tool = Path(nvcc).parent / "cuobjdump" if nvcc else None
    if tool is None or not tool.is_file():
        return None
    sass = subprocess.run([str(tool), "-sass", str(path)], check=True,
                          capture_output=True, text=True, timeout=120).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in ("HGMMA", "HMMA", "UTMALDG")}


def phase_env(build_mod, nvcc):
    """Builds all four libraries at once (one nvcc each, in parallel),
    reads each one's ptxas report and SASS, and reads the card's rates."""
    clock = Phase()
    names = ["label_join", *DENSE_KERNELS]
    t0 = time.perf_counter()
    paths = build_mod.build_libraries(names)
    seconds = time.perf_counter() - t0
    ptxas = {name: ptxas_lines(build_mod.BUILD_LOG.get(name, ""))
             for name in names}
    for name in names:
        print(f"ptxas {name}: " + " | ".join(ptxas[name]), flush=True)
    sass = {name: sass_counts(nvcc, paths[name]) for name in names}
    for name in TENSOR_CORE_KERNELS:
        if sass[name] is not None and sass[name]["HGMMA"] == 0:
            raise AssertionError(f"{name}: no HGMMA in its SASS {sass[name]}")
    # a float32 product must not be TF32-rounded anywhere in this run
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_mhz = float(nvidia_smi("clocks.max.sm", "nounits"))
    fill_rates(sms, max_mhz)
    env = {"phase": "env", "python": sys.version.split()[0],
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "card": nvidia_smi_line(), "sms": sms, "max_sm_clock_mhz": max_mhz,
           "int32_minmax_ops_per_s": RATES["int32_minmax"],
           "int8_tensor_ops_per_s": INT8_TENSOR_OPS_PER_S,
           "bf16_tensor_ops_per_s": BF16_TENSOR_OPS_PER_S,
           "tf32": torch.backends.cuda.matmul.allow_tf32,
           "kernel_build_seconds": round(seconds, 3), "ptxas": ptxas,
           "sass": sass}
    env["seconds"] = clock.seconds()
    emit(env)
    return env


def check_equal(name, got, want):
    """Exact equality (tolerance 0: integers), returns max |got - want|."""
    torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel and plain version differ "
                             f"(max abs err {err})")
    return err


def time_shape(lj, join_ops, ru, su, rv, sv):
    """Kernel / plain / tensor-op times and the bound for one operand set."""
    q, l = ru.shape
    big = q * l * l > 2**28
    bound_ms, bound_by = label_join_bound(su, q, l)
    return {
        "ms": cuda_ms(lambda: lj.label_join(ru, su, rv, sv), reps=30),
        "plain_ms": cuda_ms(lambda: plain_chunked(lj.label_join_ref, ru, su,
                                                  rv, sv),
                            reps=3 if big else 10, warmup=1),
        "torch_ops_ms": cuda_ms(lambda: join_ops(ru, su, rv, sv), reps=20),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def check_route(build_mod, lj):
    """The kernel library's own route choice (``label_join_lanes_per_query``)
    equals the wrapper module's mirror for every row length up to 1024."""
    fn = build_mod.load_library("label_join").label_join_lanes_per_query
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    lengths = range(-2, 1025)
    for l in lengths:
        if fn(l) != lj.lanes_per_query(l):
            raise AssertionError(f"route for L={l}: kernel {fn(l)}, wrapper "
                                 f"{lj.lanes_per_query(l)}")
    return [lengths[0], lengths[-1]]


def phase_kernel_checks(lj, join_ops, build_mod, device):
    """label_join on the card against its plain version, both entry points:
    the reference's corpus, its two sentinel cases, malformed rows with
    repeated ranks, and the main path's shapes (timed).  The gather entry
    point reads the same rows from a snapshot-like [2Q, L] pair, in place
    and through ids that repeat and reach rows 0 and n - 1, and Q = 0."""
    clock = Phase()
    max_err = gather_err = 0
    rows = []
    route = check_route(build_mod, lj)
    gen_ids = torch.Generator(device=device)
    gen_ids.manual_seed(5)
    zeros = torch.zeros(0, dtype=torch.int32, device=device)
    no_ids = torch.zeros(0, dtype=torch.int64, device=device)

    def compare(tag, ru, su, rv, sv):
        nonlocal max_err
        ru, su, rv, sv = (torch.as_tensor(t, dtype=torch.int32).to(device)
                          .contiguous() for t in (ru, su, rv, sv))
        got = lj.label_join(ru, su, rv, sv)
        want = plain_chunked(lj.label_join_ref, ru, su, rv, sv)
        max_err = max(max_err, check_equal(tag, got, want))
        if not torch.equal(got, join_ops(ru, su, rv, sv)):
            raise AssertionError(f"{tag}: kernel and searchsorted join differ")
        return ru, su, rv, sv, got

    def compare_gather(tag, ru, su, rv, sv, got):
        """The gather entry point on the rows of ``compare``, placed in a
        snapshot: u row i at i, v row i at Q + i.  Returns the snapshot
        and the random ids."""
        nonlocal gather_err
        q = ru.shape[0]
        ranks = torch.cat([ru, rv]).contiguous()
        svals = torch.cat([su, sv]).contiguous()
        ids = torch.arange(q, device=device)
        gather_err = max(gather_err, check_equal(
            f"{tag} gather in place",
            lj.label_join_gather(ranks, svals, ids, ids + q), got))
        us, vs = snapshot_ids(gen_ids, q, ranks.shape[0], device)
        fused = lj.label_join_gather(ranks, svals, us, vs)
        gather_err = max(gather_err, check_equal(
            f"{tag} gather", fused,
            plain_gather_chunked(lj.label_join_gather_ref, ranks, svals,
                                 us, vs)))
        gather_err = max(gather_err, check_equal(
            f"{tag} gather vs unfused", fused,
            lj.label_join(ranks[us], svals[us], ranks[vs], svals[vs])))
        expect_no_launch(lj, f"{tag} gather Q=0",
                         lambda: lj.label_join_gather(ranks, svals, no_ids,
                                                      no_ids), zeros)
        return ranks, svals, us, vs

    for q, l, seed in LABEL_JOIN_CORPUS:
        rng = np.random.default_rng(seed)
        u = corpus_rows(rng, q, l, 200, lj.MAX_RANK)
        v = corpus_rows(rng, q, l, 200, lj.MAX_RANK)
        *ops, got = compare(f"corpus[{q},{l}]", u[0], u[1], v[0], v[1])
        compare_gather(f"corpus[{q},{l}]", *ops, got)
        rows.append({"shape": [q, l], "case": "corpus", "equal": True,
                     "gather_equal": True})

    # MAX_RANK itself is a legal rank and must join
    *ops, got = compare("sentinel-bound", [[0, lj.MAX_RANK]], [[3, 5]],
                        [[lj.MAX_RANK, INT32_MAX]], [[4, 0]])
    if got.tolist() != [4]:
        raise AssertionError(f"sentinel-bound case answered {got.tolist()}")
    compare_gather("sentinel-bound", *ops, got)
    rows.append({"shape": [1, 2], "case": "sentinel-bound", "equal": True,
                 "gather_equal": True})
    # all-pad rows never match
    pad_r = np.full((3, 4), INT32_MAX, np.int32)
    pad_s = np.zeros((3, 4), np.int32)
    *ops, got = compare("all-pad", pad_r, pad_s, pad_r, pad_s)
    if got.tolist() != [0, 0, 0]:
        raise AssertionError(f"all-pad case answered {got.tolist()}")
    compare_gather("all-pad", *ops, got)
    rows.append({"shape": [3, 4], "case": "all-pad", "equal": True,
                 "gather_equal": True})

    # repeated ranks whose s rises: a first-copy lookup (the searchsorted
    # join) answers some rows wrongly, the kernel must give all pairs
    for q, l, seed in DUPLICATE_SHAPES:
        rng = np.random.default_rng(seed)
        high = 8 if l <= 32 else 40
        u, v = duplicate_rows(rng, q, l, high), duplicate_rows(rng, q, l, high)
        ru, su, rv, sv = (torch.from_numpy(t).to(device)
                          for t in (u[0], u[1], v[0], v[1]))
        want = plain_chunked(lj.label_join_ref, ru, su, rv, sv)
        first_copy_wrong = int((join_ops(ru, su, rv, sv) != want).sum())
        if first_copy_wrong == 0:
            raise AssertionError(f"duplicates[{q},{l}]: the case does not "
                                 f"tell a first-copy lookup from all pairs")
        got = lj.label_join(ru, su, rv, sv)
        max_err = max(max_err, check_equal(f"duplicates[{q},{l}]", got, want))
        compare_gather(f"duplicates[{q},{l}]", ru, su, rv, sv, got)
        rows.append({"shape": [q, l], "case": "repeated ranks",
                     "route_lanes": lj.lanes_per_query(l),
                     "first_copy_wrong_rows": first_copy_wrong,
                     "equal": True, "gather_equal": True})

    gen = torch.Generator(device=device)
    scratch = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                          device=device)
    for q, l in MAIN_PATH_SHAPES:
        gen.manual_seed(q * 1000 + l)
        ru, su = random_rows(gen, q, l, 4 * l, device)
        rv, sv = random_rows(gen, q, l, 4 * l, device)
        ru, su, rv, sv, got = compare(f"main[{q},{l}]", ru, su, rv, sv)
        ranks, svals, us, vs = compare_gather(f"main[{q},{l}]", ru, su, rv,
                                              sv, got)
        row = {"shape": [q, l], "case": "main-path shape", "equal": True,
               "gather_equal": True, "route_lanes": lj.lanes_per_query(l),
               "share_nonzero": float((got > 0).float().mean())}
        row.update(time_shape(lj, join_ops, ru, su, rv, sv))
        # the same join on rows reached by id: gather + join in two steps,
        # and the gather entry point (warm, cold), on the snapshot [2Q, L]
        gathered = (ranks[us], svals[us], ranks[vs], svals[vs])
        bound_ms, bound_by, counts = label_join_gather_bound(svals, us, vs)
        row["by_id"] = {
            "queries": us.numel(), "snapshot_rows": ranks.shape[0],
            "gather_ms": cuda_ms(lambda: (ranks[us], svals[us], ranks[vs],
                                          svals[vs]), reps=20),
            "label_join_ms": cuda_ms(lambda: lj.label_join(*gathered),
                                     reps=30),
            "fused_ms": cuda_ms(lambda: lj.label_join_gather(ranks, svals,
                                                             us, vs), reps=30),
            "fused_cold_ms": cuda_ms_cold(
                lambda: lj.label_join_gather(ranks, svals, us, vs), scratch,
                reps=10),
            "fused_bound_ms": bound_ms, "fused_bound_by": bound_by, **counts}
        del gathered
        rows.append(row)
    del scratch
    emit({"phase": "kernel_checks", "kernel": "label_join",
          "tolerance": 0, "max_abs_err": max_err,
          "gather_max_abs_err": gather_err, "route_checked_for_l": route,
          "cases": rows, "seconds": clock.seconds()})
    return max_err, gather_err


def drive_batches(eng, batches, s):
    """One ``mr_batch`` and one ``s_reach_batch`` per batch."""
    return [(eng.mr_batch(us, vs), eng.s_reach_batch(us, vs, s))
            for us, vs in batches]


def check_answers(tag, answers, plain_answers, s):
    for (mr, sr), (mr0, sr0) in zip(answers, plain_answers):
        if mr.dtype != np.int32 or sr.dtype != np.bool_:
            raise AssertionError(f"{tag}: dtypes {mr.dtype}, {sr.dtype}")
        if mr.shape != mr0.shape or not np.array_equal(mr, mr0):
            raise AssertionError(f"{tag}: kernel path and batched_mr differ")
        if not np.array_equal(sr, sr0) or not np.array_equal(sr, mr >= s):
            raise AssertionError(f"{tag}: s_reach answers differ")
        if not np.isfinite(mr).all() or (mr < 0).any():
            raise AssertionError(f"{tag}: answers out of range")


def peak_rise(fn):
    """How far one call of ``fn`` raises the device's peak allocation
    over what was allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def phase_main_path(api, engine_mod, lj, join_ops, device, refs):
    """The full-size main path: 89,000 vertices, 70,000 hyperedges; the
    MST oracle comes from ``refs`` (built beside the card's work)."""
    clock = Phase()
    s = 2
    t0 = time.perf_counter()
    h = api.random_hypergraph(**MAIN_GRAPH)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = api.build_engine(h, "hl-index", use_kernels=True)
    build_s = time.perf_counter() - t0
    snap = eng.snapshot()
    if snap.ranks.device.type != "cuda":
        raise AssertionError("snapshot did not land on the card")
    plain_eng = engine_mod.HLIndexEngine(h, eng.idx, device=device)

    rng = np.random.default_rng(11)
    sizes = [1000, 4096, 2**20]
    batches = [(rng.integers(0, h.n, q), rng.integers(0, h.n, q))
               for q in sizes]

    # the counted run: every count to 0, drive, read
    lj.LAUNCHES = lj.GATHER_LAUNCHES = 0
    answers = drive_batches(eng, batches, s)
    torch.cuda.synchronize()
    launches, gather_launches = lj.LAUNCHES, lj.GATHER_LAUNCHES
    if launches != 2 * len(batches) or gather_launches != launches:
        raise AssertionError(f"expected one label_join_gather launch per "
                             f"batch ({2 * len(batches)}), counted "
                             f"{gather_launches} of {launches} launches")

    lj.LAUNCHES = 0
    plain_answers = drive_batches(plain_eng, batches, s)
    if lj.LAUNCHES != 0:
        raise AssertionError("use_kernels=False went through the kernel")
    check_answers("main_path", answers, plain_answers, s)

    us, vs = batches[0]
    mr1000 = answers[0][0]
    scalar = np.array([eng.mr(int(u), int(v)) for u, v in zip(us, vs)])
    if not np.array_equal(scalar, mr1000):
        raise AssertionError("main_path: batch differs from host merge-join")
    # the MST oracle's forest, swept once per hyperedge of u (forest_mr)
    t0 = time.perf_counter()
    oracle, oracle_build = refs.take("main", "mst-oracle", h)
    want = forest_mr(oracle, us[:32], vs[:32]).tolist()
    oracle_s = time.perf_counter() - t0
    del oracle
    if want != mr1000[:32].tolist():
        raise AssertionError("main_path: batch differs from the MST oracle")

    # the kernel on the rows this path gave it (largest batch), vs plain:
    # by id (the path's own entry point) and on the gathered rows
    hus, hvs = batches[-1]
    bu = torch.from_numpy(hus).to(device)
    bv = torch.from_numpy(hvs).to(device)
    fused = lj.label_join_gather(snap.ranks, snap.svals, bu, bv)
    gather_err = check_equal("main_path by id", fused, plain_gather_chunked(
        lj.label_join_gather_ref, snap.ranks, snap.svals, bu, bv))
    ru, su, rv, sv = snap.ranks[bu], snap.svals[bu], snap.ranks[bv], snap.svals[bv]
    got = lj.label_join(ru, su, rv, sv)
    err = check_equal("main_path rows", got,
                      plain_chunked(lj.label_join_ref, ru, su, rv, sv))
    gather_err = max(gather_err, check_equal("main_path by id vs rows",
                                             fused, got))
    if not np.array_equal(fused.cpu().numpy(), answers[-1][0]):
        raise AssertionError("main_path: engine answer differs from wrapper")
    kernel_times = time_shape(lj, join_ops, ru, su, rv, sv)
    kernel_times["shape"] = list(ru.shape)
    scratch = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                          device=device)
    bound_ms, bound_by, counts = label_join_gather_bound(snap.svals, bu, bv)
    gather_times = {
        "ms": cuda_ms(lambda: lj.label_join_gather(snap.ranks, snap.svals,
                                                   bu, bv), reps=30),
        "cold_ms": cuda_ms_cold(
            lambda: lj.label_join_gather(snap.ranks, snap.svals, bu, bv),
            scratch, reps=10),
        "plain_ms": cuda_ms(lambda: plain_gather_chunked(
            lj.label_join_gather_ref, snap.ranks, snap.svals, bu, bv),
            reps=3, warmup=1),
        "torch_ops_ms": cuda_ms(lambda: snap.mr(bu, bv), reps=20),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "shape": [sizes[-1], snap.lmax], **counts}
    del scratch

    # the device memory one 2^20 batch adds: through the engine (ids and
    # answers), and the same batch gathered first (the two-step route)
    def two_step_batch():
        pairs = torch.from_numpy(np.stack(engine_mod.validate_batch(
            hus, hvs, h.n))).to(device)
        rows = (snap.ranks[pairs[0]], snap.svals[pairs[0]],
                snap.ranks[pairs[1]], snap.svals[pairs[1]])
        return lj.label_join(*rows).cpu().numpy()

    memory = {"queries": sizes[-1],
              "mr_batch_peak_rise_bytes": peak_rise(
                  lambda: eng.mr_batch(hus, hvs)),
              "two_step_peak_rise_bytes": peak_rise(two_step_batch),
              "limit_bytes": BATCH_PEAK_LIMIT}
    if memory["mr_batch_peak_rise_bytes"] >= BATCH_PEAK_LIMIT:
        raise AssertionError(f"main_path: a 2^20 mr_batch raised the peak "
                             f"device memory by {memory}")

    # where one batch's time goes, step by step, for the largest batch
    checked = engine_mod.validate_batch(hus, hvs, h.n)
    stacked = torch.from_numpy(np.stack(checked))
    breakdown = {
        "queries": sizes[-1],
        "host_validate_ms": host_ms(
            lambda: np.stack(engine_mod.validate_batch(hus, hvs, h.n)), 5),
        "ids_to_device_ms": host_ms(
            lambda: (stacked.to(device), torch.cuda.synchronize()), 5),
        "gather_ms": cuda_ms(
            lambda: (snap.ranks[bu], snap.svals[bu], snap.ranks[bv],
                     snap.svals[bv]), reps=20),
        "label_join_ms": kernel_times["ms"],
        "fused_join_ms": gather_times["ms"],
        "fused_join_cold_ms": gather_times["cold_ms"],
        # one launch with the card idle before it (the older way of timing
        # kernels here): the wrapper's host cost shows in these two
        "label_join_single_launch_ms": cuda_ms_single(
            lambda: lj.label_join(ru, su, rv, sv), reps=30),
        "fused_join_single_launch_ms": cuda_ms_single(
            lambda: lj.label_join_gather(snap.ranks, snap.svals, bu, bv),
            reps=30),
        "answers_to_host_ms": host_ms(lambda: fused.cpu().numpy(), 5),
    }

    rates = []
    for (bus, bvs), q in zip(batches, sizes):
        reps = 5 if q > 100_000 else 20
        k_ms = host_ms(lambda: eng.mr_batch(bus, bvs), reps)
        p_ms = host_ms(lambda: plain_eng.mr_batch(bus, bvs), reps)
        rates.append({"queries": q, "kernel_batch_ms": k_ms,
                      "kernel_queries_per_s": q / k_ms * 1e3,
                      "batched_mr_batch_ms": p_ms,
                      "batched_mr_queries_per_s": q / p_ms * 1e3})
    emit({"phase": "main_path", "n": h.n, "m": h.m, "nnz": h.nnz,
          "labels": eng.idx.num_labels, "lmax": snap.lmax,
          "snapshot_bytes": snap.nbytes(),
          "generate_seconds": round(gen_s, 3),
          "build_seconds": round(build_s, 3),
          "oracle_pairs": 32, "oracle_seconds": round(oracle_s, 3),
          "oracle_build": oracle_build,
          "merge_join_pairs": 1000, "s": s,
          "label_join_launches": launches,
          "label_join_gather_launches": gather_launches,
          "share_nonzero": [float((a[0] > 0).mean()) for a in answers],
          "batch_times_include": "host->device ids, join by id, "
                                 "device->host answers",
          "batches": rates, "largest_batch_breakdown": breakdown,
          "batch_memory": memory, "seconds": clock.seconds()})
    return launches, gather_launches, err, gather_err, kernel_times, \
        gather_times, eng, build_s


def phase_wide_labels(api, engine_mod, lj, device):
    """Wide label rows (Lmax about 52) through the same path and checks."""
    clock = Phase()
    s = 3
    h = api.random_hypergraph(400, 4000, min_size=2, max_size=6, seed=5)
    t0 = time.perf_counter()
    eng = api.build_engine(h, "hl-index", use_kernels=True)
    build_s = time.perf_counter() - t0
    plain_eng = engine_mod.HLIndexEngine(h, eng.idx, device=device)
    rng = np.random.default_rng(12)
    batches = [(rng.integers(0, h.n, q), rng.integers(0, h.n, q))
               for q in (200, 4096)]
    before = lj.LAUNCHES
    answers = drive_batches(eng, batches, s)
    launches = lj.LAUNCHES - before
    if launches != 2 * len(batches):
        raise AssertionError(f"wide_labels: {launches} launches for "
                             f"{2 * len(batches)} batches")
    check_answers("wide_labels", answers,
                  drive_batches(plain_eng, batches, s), s)
    us, vs = batches[0]
    mr200 = answers[0][0]
    scalar = np.array([eng.mr(int(u), int(v)) for u, v in zip(us, vs)])
    if not np.array_equal(scalar, mr200):
        raise AssertionError("wide_labels: batch differs from host merge-join")
    # the MST oracle's forest, swept once per hyperedge of u (forest_mr:
    # its mr() walks it once per hyperedge pair, seconds a query at this
    # density), on the first pairs
    n_oracle = 16
    t0 = time.perf_counter()
    oracle = api.build_engine(h, "mst-oracle").oracle
    want = forest_mr(oracle, us[:n_oracle], vs[:n_oracle]).tolist()
    oracle_s = time.perf_counter() - t0
    if want != mr200[:n_oracle].tolist():
        raise AssertionError("wide_labels: batch differs from the MST oracle")
    emit({"phase": "wide_labels", "n": h.n, "m": h.m, "nnz": h.nnz,
          "labels": eng.idx.num_labels, "lmax": eng.snapshot().lmax,
          "build_seconds": round(build_s, 3), "merge_join_pairs": 200,
          "oracle_pairs": n_oracle, "oracle_seconds": round(oracle_s, 3),
          "s": s, "label_join_launches": launches,
          "answer_histogram": np.bincount(answers[1][0]).tolist(),
          "seconds": clock.seconds()})


# -- the request service ------------------------------------------------------

class _TimedView:
    """Stands in for the serving view inside the service's own
    ``_snapshot_mr``: it synchronises on entry (so the ids' copy, which
    came before, is finished), records CUDA events around the real
    ``mr`` and the host time of its launch.  It has only the attributes
    ``_snapshot_mr`` uses today, so a change there fails loudly."""

    def __init__(self, view, cur):
        self._view, self._cur = view, cur
        self.device = view.device

    def mr(self, us, vs):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self._view.mr(us, vs)
        end.record()
        self._cur.update(ids_landed=t1, launched=time.perf_counter(),
                         events=(start, end))
        return out


def timed_service_class(base):
    """A subclass of the service ``base`` that times its own steps, for the
    per-micro-batch split: the scheduler's ``take`` (host clock), then per
    dispatched group the id assembly and bucket pad, and around the
    service's own ``_snapshot_mr`` (through ``_TimedView``) the ids' copy
    to the card, the join's launch (host clock; CUDA events around it)
    and the answers' copy back (which waits for the join); the futures'
    resolution is the rest of the group."""

    class TimedService(base):
        def __init__(self, *args, start=True, **kwargs):
            super().__init__(*args, start=False, **kwargs)
            self.take_ms, self.groups = [], []
            take = self._queue.take

            def timed_take(limit, now):
                t0 = time.perf_counter()
                out = take(limit, now)
                self.take_ms.append((time.perf_counter() - t0) * 1e3)
                return out

            self._queue.take = timed_take
            if start:
                self.start()

        def _dispatch_group(self, kind, group, snap, deliver):
            self._cur = {"kind": kind, "queries": len(group)}
            t0 = time.perf_counter()
            super()._dispatch_group(kind, group, snap, deliver)
            cur = self._cur
            cur["group_ms"] = (time.perf_counter() - t0) * 1e3
            cur["resolve_ms"] = cur["group_ms"] - sum(
                cur[k] for k in ("assemble_ms", "h2d_ms", "launch_ms",
                                 "d2h_ms"))
            self.groups.append(cur)

        def _batch_ids(self, group):
            t0 = time.perf_counter()
            us, vs = super()._batch_ids(group)
            self._cur["assemble_ms"] = (time.perf_counter() - t0) * 1e3
            self._cur["bucket"] = int(us.size)
            return us, vs

        def _snapshot_mr(self, snap, us, vs):
            cur = self._cur
            t0 = time.perf_counter()
            host = super()._snapshot_mr(_TimedView(snap, cur), us, vs)
            t3 = time.perf_counter()
            start, end = cur.pop("events")
            t1, t2 = cur.pop("ids_landed"), cur.pop("launched")
            cur.update(h2d_ms=(t1 - t0) * 1e3, launch_ms=(t2 - t1) * 1e3,
                       d2h_ms=(t3 - t2) * 1e3,
                       join_events_ms=start.elapsed_time(end))
            return host

    return TimedService


def service_requests(serve_mod, rng, n, n_mr, n_sreach):
    """Seeded traffic: ``n_mr`` MR and ``n_sreach`` s-reach requests (s in
    1..8) in one shuffled stream, three tenants, mixed priorities.  Returns
    the requests and their ids, s (0 for MR) as arrays."""
    q = n_mr + n_sreach
    us, vs = rng.integers(0, n, q), rng.integers(0, n, q)
    s = np.concatenate([np.zeros(n_mr, np.int64),
                        rng.integers(1, 9, n_sreach)])
    rng.shuffle(s)
    tenants = [t for t, _ in SERVICE_TENANTS]
    tenant = rng.integers(0, len(tenants), q)
    prio = rng.choice(3, q, p=[0.1, 0.6, 0.3])
    names = ("interactive", "standard", "batch")
    reqs = [serve_mod.MRRequest(int(u), int(v), tenant=tenants[t],
                                priority=names[p]) if not k else
            serve_mod.SReachRequest(int(u), int(v), int(k),
                                    tenant=tenants[t], priority=names[p])
            for u, v, k, t, p in zip(us, vs, s, tenant, prio)]
    return reqs, us, vs, s


def expected_answers(mr, s):
    """What the service must resolve: ``int`` MR where s == 0, else the
    ``bool`` s-reach answer."""
    return [bool(m >= k) if k else int(m) for m, k in zip(mr.tolist(),
                                                          s.tolist())]


def check_service_answers(tag, futs, want, timeout=120):
    got = [f.result(timeout=timeout) for f in futs]
    if got != want:
        bad = sum(g != w for g, w in zip(got, want))
        raise AssertionError(f"{tag}: {bad} of {len(want)} answers differ")
    if [type(g) for g in got] != [type(w) for w in want]:
        raise AssertionError(f"{tag}: answer types differ")


def step_split(svc, wall_ms, kernel_ms_by_bucket):
    """Per micro-batch split of one timed run, summed over its groups, and
    the device's idle share: 1 - the kernels' own time (``cuda_ms_queued``
    at each group's bucket) over the run's wall time."""
    groups = svc.groups
    keys = ("assemble_ms", "h2d_ms", "launch_ms", "d2h_ms", "resolve_ms",
            "join_events_ms", "group_ms")
    total = {k: sum(g[k] for g in groups) for k in keys}
    total["take_ms"] = sum(svc.take_ms)
    kernel = sum(kernel_ms_by_bucket[g["bucket"]] for g in groups)
    dispatch_ms = total["group_ms"] + total["take_ms"]
    n = len(groups)
    return {"groups": n, "takes": len(svc.take_ms), "wall_ms": wall_ms,
            "dispatch_ms": dispatch_ms, "sum_ms": total,
            "mean_ms_per_group": {k: v / n for k, v in total.items()},
            "kernel_ms": kernel, "device_idle_share": 1 - kernel / wall_ms,
            "device_idle_share_of_dispatch": 1 - kernel / dispatch_ms,
            "buckets": sorted({g["bucket"] for g in groups})}


def serve_run(api, eng, cfg, reqs, want, threaded, counters, timed=None):
    """One run of the traffic through a service over ``eng`` (``api.serve``
    or, with ``timed``, the timing subclass), every count set to 0 just
    before and read just after.  Returns the service, the seconds of
    submission and of the whole run, and the launch counts."""
    reset_counts(counters)
    lj = counters["label_join"]
    lj.GATHER_LAUNCHES = 0
    svc = (api.serve(eng, config=cfg, start=threaded) if timed is None
           else timed(eng, config=cfg, start=threaded))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        futs = svc.submit_many(reqs)
        t1 = time.perf_counter()
        if not threaded:
            svc.drain()
        for f in futs:
            f.result(timeout=300)
        t2 = time.perf_counter()
    finally:
        svc.close()
    counts = read_counts(counters)
    counts["label_join_gather"] = lj.GATHER_LAUNCHES
    check_service_answers("service_path", futs, want)
    st = svc.stats()
    want_counts = {name: 0 for name in counters}
    want_counts.update(label_join=st.batches, label_join_gather=st.batches)
    if counts != want_counts or st.kernel_batches != st.batches:
        raise AssertionError(f"service_path: launches {counts} for "
                             f"{st.batches} micro-batches "
                             f"({st.kernel_batches} through the kernel)")
    if st.answered != len(reqs) or st.expired:
        raise AssertionError(f"service_path: stats {st.as_dict()}")
    return svc, t1 - t0, t2 - t0, counts


def traced_run(api, eng, cfg, reqs, want, counters):
    """One ``drain()`` run of the traffic under ``torch.profiler`` with
    CUDA activity only: the device's busy time is the union of the
    trace's device intervals (kernels, copies, sets), its idle share 1 -
    busy / the run's wall time (which the tracing lengthens).  The
    trace's kernel count is held to the run's launches, so a trace that
    missed some launches shows as a failure, not as a larger idle share;
    one that holds no device event at all is reported as not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        svc, _, run_s, counts = serve_run(api, eng, cfg, reqs, want, False,
                                          counters)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end_us = 0.0, -math.inf
    for t0, t1, _ in spans:
        if t1 > end_us:
            busy_us += t1 - max(t0, end_us)
            end_us = t1
    if not spans:
        return {"device_idle_share": None,
                "note": "not measured: the trace held no device event"}
    joins = sum("join_short" in name or "join_long" in name
                for _, _, name in spans)    # label_join.cu's two kernels
    if joins != counts["label_join"]:
        raise AssertionError(f"traced run: {joins} label_join kernels in "
                             f"the trace for {counts['label_join']} "
                             f"launches")
    return {"max_batch": cfg.max_batch, "mode": "drain",
            "wall_ms": run_s * 1e3, "device_busy_ms": busy_us / 1e3,
            "device_events": len(spans), "label_join_kernels": joins,
            "device_idle_share": 1 - busy_us / 1e3 / (run_s * 1e3)}


def fan_churn_script(rng, n0, version, h):
    """The small graph's 20 seeded update batches: random groups among
    the first ``n0`` vertices; at versions 4 and 5 vertex 0 joins groups
    of every size from 2 to 41 (new vertices: n grows, and its label row
    passes 32 labels, the kernel's route change); at versions 12 and 13
    those groups dissolve again."""
    if version in (4, 5):
        sizes = range(2, 22) if version == 4 else range(22, 42)
        ins, nxt = [], h.n
        for k in sizes:
            ins.append([0] + list(range(nxt, nxt + k - 1)))
            nxt += k - 1
        return ins, []
    if version in (12, 13):
        fan = [e for e in range(h.m) if int(h.edge(e).max()) >= n0]
        return [], fan[: len(fan) // 2] if version == 12 else fan
    ins = [[int(x) for x in rng.choice(n0, size=int(rng.integers(2, 9)),
                                       replace=False)]
           for _ in range(int(rng.integers(1, 4)))]
    dels = [int(d) for d in rng.choice(h.m, size=int(rng.integers(0, 3)),
                                       replace=False)]
    return ins, dels


def snapshots_equal(a, b):
    return all(x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
               for x, y in ((a.ranks, b.ranks), (a.svals, b.svals),
                            (a.lengths, b.lengths)))


def phase_service_path(api, engine_mod, serve_mod, query_mod, ops, counters,
                       eng, device):
    """The request service on the main path's 89k/70k engine (kernels on),
    then one update on the full graph, two replicas, and churn on ENG-s."""
    clock = Phase()
    lj = counters["label_join"]
    h = eng.h
    steps = {}
    t_step = time.perf_counter()

    def lap(name):
        nonlocal t_step
        torch.cuda.synchronize()
        now = time.perf_counter()
        steps[name] = round(now - t_step, 3)
        t_step = now

    rng = np.random.default_rng(17)
    reqs, us, vs, s = service_requests(serve_mod, rng, h.n,
                                       SERVICE_MR_REQUESTS,
                                       SERVICE_SREACH_REQUESTS)
    # what the service must answer: the kernel batch and batched_mr agree
    plain_eng = engine_mod.HLIndexEngine(h, eng.idx, device=device)
    mr_kernel = eng.mr_batch(us, vs)
    mr_plain = plain_eng.mr_batch(us, vs)
    if not np.array_equal(mr_kernel, mr_plain):
        raise AssertionError("service_path: mr_batch and batched_mr differ")
    want = expected_answers(mr_kernel, s)
    lap("requests")

    tenants = tuple(serve_mod.TenantSpec(t, w) for t, w in SERVICE_TENANTS)
    timed_cls = timed_service_class(serve_mod.ReachabilityService)
    runs, splits = [], {}
    snap = eng.snapshot()
    bucket_ms = {}
    for max_batch in SERVICE_BATCHES:
        cfg = serve_mod.ServiceConfig(max_batch=max_batch, tenants=tenants,
                                      use_kernels=True)
        for threaded in (False, True):
            svc, submit_s, run_s, counts = serve_run(
                api, eng, cfg, reqs, want, threaded, counters)
            if svc._snap is not eng.snapshot_cache():
                raise AssertionError("service_path: the service copied the "
                                     "engine's snapshot")
            st = svc.stats()
            runs.append({"max_batch": max_batch,
                         "mode": "thread" if threaded else "drain",
                         "requests": len(reqs),
                         "submit_seconds": submit_s, "seconds": run_s,
                         "submit_us_per_request": submit_s / len(reqs) * 1e6,
                         "requests_per_s": len(reqs) / run_s,
                         "micro_batches": st.batches,
                         "label_join_gather_launches":
                             counts["label_join_gather"],
                         "padded_queries": st.padded_queries,
                         "bucket_histogram": st.bucket_histogram})
            # the same run again, its steps timed one by one
            tsvc, _, trun_s, _ = serve_run(api, eng, cfg, reqs, want,
                                           threaded, counters,
                                           timed=timed_cls)
            for g in tsvc.groups:
                b = g["bucket"]
                if b not in bucket_ms:
                    # the first b pairs of the traffic: the bucket sizes a
                    # threaded run meets vary, so no seeded stream is drawn
                    ids = torch.from_numpy(np.stack([us[:b], vs[:b]])).to(
                        device)
                    bucket_ms[b] = cuda_ms_queued(lambda: lj.label_join_gather(
                        snap.ranks, snap.svals, ids[0], ids[1]), reps=20)
            splits[f"{max_batch}-{'thread' if threaded else 'drain'}"] = \
                step_split(tsvc, trun_s * 1e3, bucket_ms)
    lap("traffic")
    service_launches = sum(r["label_join_gather_launches"] for r in runs)
    trace = traced_run(api, eng, serve_mod.ServiceConfig(
        tenants=tenants, use_kernels=True), reqs, want, counters)
    lap("traced_run")

    # latency: single requests trickled 1 ms apart, the thread running
    cfg = serve_mod.ServiceConfig(use_kernels=True)
    reset_counts(counters)
    lat = [None] * TRICKLE_REQUESTS
    svc = api.serve(eng, config=cfg)
    try:
        futs = []
        for i in range(TRICKLE_REQUESTS):
            r = reqs[i]
            t0 = time.perf_counter()
            futs.append(svc.submit(r, on_result=lambda _r, _f, i=i, t0=t0:
                                   lat.__setitem__(
                                       i, time.perf_counter() - t0)))
            time.sleep(0.001)
        for f in futs:
            f.result(timeout=60)
    finally:
        svc.close()
    check_service_answers("service_path trickle", futs,
                          want[:TRICKLE_REQUESTS])
    trickle_launches = read_counts(counters)["label_join"]
    if trickle_launches != svc.stats().batches:
        raise AssertionError("service_path trickle: launches != batches")
    service_launches += trickle_launches
    lat_ms = np.array(lat) * 1e3
    latency = {"requests": TRICKLE_REQUESTS, "gap_ms": 1.0,
               "max_wait_ms": cfg.max_wait_ms,
               "p50_ms": float(np.percentile(lat_ms, 50)),
               "p99_ms": float(np.percentile(lat_ms, 99)),
               "max_ms": float(lat_ms.max()),
               "micro_batches": svc.stats().batches}
    lap("trickle")

    # one update on the full graph, through the service with its admission
    # thread running; requests submitted while it runs time the stall
    svc = api.serve(eng, config=cfg)
    patch_s = []
    snapshot = eng.snapshot

    def timed_snapshot():
        dirty = eng.dirty_rows()     # None: a full rebuild, no patch basis
        t0 = time.perf_counter()
        out = snapshot()
        torch.cuda.synchronize()
        patch_s.append((time.perf_counter() - t0, dirty))
        return out

    try:
        reset_counts(counters)
        futs = svc.submit_many(reqs[:4096])
        check_service_answers("service_path before update", futs,
                              want[:4096])
        lmax_before = svc._snap.lmax
        inserts = [[int(x) for x in rng.choice(h.n, 4, replace=False)]
                   for _ in range(2)]
        deletes = [int(x) for x in rng.choice(h.m, 2, replace=False)]
        stall_reqs, stall_us, stall_vs, stall_s = service_requests(
            serve_mod, np.random.default_rng(18), h.n, STALL_REQUESTS - 2, 2)
        eng.snapshot = timed_snapshot    # times the patch at the swap
        began, ran = threading.Event(), {}

        def run_update():
            began.set()
            t0 = time.perf_counter()
            try:
                svc.update(inserts=inserts, deletes=deletes)
            except BaseException as exc:             # noqa: BLE001
                ran["error"] = exc
            ran["span"] = (t0, time.perf_counter())

        updater = threading.Thread(target=run_update, name="update")
        updater.start()
        began.wait()
        time.sleep(0.1)
        stall = []
        stall_futs = []
        for r in stall_reqs:
            rec = {"submitted": time.perf_counter()}
            stall.append(rec)
            stall_futs.append(svc.submit(
                r, on_result=lambda _r, _f, rec=rec: rec.__setitem__(
                    "answered", time.perf_counter())))
            time.sleep(STALL_GAP_S)
        updater.join(timeout=600)
        if updater.is_alive() or "error" in ran:
            raise AssertionError(f"service_path: the update failed: "
                                 f"{ran.get('error', 'still running')}")
        for f in stall_futs:
            f.result(timeout=120)
        u0, u1 = ran["span"]
        update_s = u1 - u0
        h2 = eng.h
        rng2 = np.random.default_rng(19)
        reqs2, us2, vs2, s2 = service_requests(serve_mod, rng2, h2.n, 3072,
                                               1024)
        t0 = time.perf_counter()
        futs = svc.submit_many(reqs2)
        for f in futs:
            f.result(timeout=120)
        after_s = time.perf_counter() - t0
    finally:
        eng.__dict__.pop("snapshot", None)
        svc.close()
    if len(patch_s) != 1:
        raise AssertionError(f"service_path: {len(patch_s)} snapshot "
                             f"derivations after the update, expected 1")
    patch_seconds, dirty = patch_s[0]
    update = {"inserts": inserts, "deletes": deletes,
              "seconds": update_s,
              "scope": int(eng.idx.stats["maintenance_scope"]),
              "m": eng.h.m, "n": eng.h.n,
              "full_rebuild": dirty is None,
              "dirty_rows": eng.h.n if dirty is None else int(dirty.size),
              "rows_rederived": eng.last_snapshot_refresh_rows,
              "patch_seconds": patch_seconds,
              "after_update_traffic_seconds": after_s}
    # each request sent during the update: when, after the update began,
    # it was submitted, and how long it waited for its answer
    update["stall"] = {
        "requests": len(stall), "gap_s": STALL_GAP_S,
        "submitted_during_update": sum(r["submitted"] < u1 for r in stall),
        "submitted_s_after_update_began": [r["submitted"] - u0
                                           for r in stall],
        "latency_s": [r["answered"] - r["submitted"] for r in stall],
        "answered_s_after_update_ended": [r["answered"] - u1
                                          for r in stall]}
    launches = read_counts(counters)["label_join"]
    st = svc.stats()
    if launches != st.batches or st.snapshot_refreshes != 2:
        raise AssertionError(f"service_path after update: {launches} "
                             f"launches, stats {st.as_dict()}")
    service_launches += st.batches
    t0 = time.perf_counter()
    fresh = engine_mod.DeviceSnapshot.from_hlindex(eng.idx, device=device)
    update["from_scratch_snapshot_seconds"] = time.perf_counter() - t0
    if svc._snap.version != eng.version or not snapshots_equal(svc._snap,
                                                               fresh):
        raise AssertionError("service_path: the swapped-in snapshot differs "
                             "from a from-scratch derivation")

    def fresh_answers(us_, vs_, s_):
        d = torch.from_numpy(np.stack([us_, vs_])).to(device)
        return expected_answers(query_mod.batched_mr(
            fresh.ranks, fresh.svals, d[0], d[1]).cpu().numpy(), s_)

    check_service_answers("service_path during update", stall_futs,
                          fresh_answers(stall_us, stall_vs, stall_s))
    want2 = fresh_answers(us2, vs2, s2)
    check_service_answers("service_path after update", futs, want2)
    update.update(lmax_before=lmax_before, lmax_after=svc._snap.lmax,
                  route_before=lj.lanes_per_query(lmax_before),
                  route_after=lj.lanes_per_query(svc._snap.lmax))
    del fresh
    lap("full_graph_update")

    # two replicas over the same engine (the plain service is closed)
    before = eng.snapshot()
    kept = [t.clone() for t in (before.ranks, before.svals, before.lengths)]
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    grp = serve_mod.ReplicaGroup(eng, 2, config=cfg, start=False)
    reset_counts(counters)
    futs = grp.submit_many(reqs2)
    grp.drain()
    check_service_answers("replicas", futs, want2)
    torch.cuda.synchronize()
    replica_bytes = torch.cuda.memory_allocated() - mem0
    # an update that touches two small components: an insert on four
    # vertices of no hyperedge, and the delete of a hyperedge whose
    # vertices have no other (the path of dirty rows written in place)
    h3 = eng.h
    deg = h3.vertex_degrees
    lonely = np.nonzero(deg == 0)[0]
    alone = np.nonzero(np.maximum.reduceat(deg[h3.e_idx], h3.e_ptr[:-1])
                       == 1)[0]
    r_ins = [[int(x) for x in rng.choice(lonely, 4, replace=False)]]
    r_del = [int(rng.choice(alone))]
    t0 = time.perf_counter()
    grp.update(inserts=r_ins, deletes=r_del)
    replica_update_s = time.perf_counter() - t0
    r_dirty = eng.dirty_rows()
    reqs3, us3, vs3, s3 = service_requests(serve_mod, rng2, eng.h.n, 3072,
                                           1024)
    futs = grp.submit_many(reqs3)
    grp.drain()
    counts = read_counts(counters)
    gst = grp.stats()
    if counts["label_join"] != gst.batches:
        raise AssertionError(f"replicas: {counts} for {gst.batches} batches")
    service_launches += gst.batches
    fresh = engine_mod.DeviceSnapshot.from_hlindex(eng.idx, device=device)
    d = torch.from_numpy(np.stack([us3, vs3])).to(device)
    want3 = expected_answers(query_mod.batched_mr(
        fresh.ranks, fresh.svals, d[0], d[1]).cpu().numpy(), s3)
    check_service_answers("replicas after update", futs, want3)
    cached = eng.snapshot_cache()
    ptrs = set()
    for rep in grp.replicas:
        if rep.snap.version != eng.version or not snapshots_equal(rep.snap,
                                                                  fresh):
            raise AssertionError(f"replica {rep.index} differs from a "
                                 f"from-scratch snapshot")
        for f in ("ranks", "svals", "lengths"):
            p = getattr(rep.snap, f).data_ptr()
            if p in (getattr(cached, f).data_ptr(),
                     getattr(before, f).data_ptr()):
                raise AssertionError(f"replica {rep.index} aliases the "
                                     f"engine's {f}")
            ptrs.add(p)
    if len(ptrs) != 3 * len(grp.replicas):
        raise AssertionError("replicas share storage")
    if not all(torch.equal(a, b) for a, b in zip(
            kept, (before.ranks, before.svals, before.lengths))):
        raise AssertionError("the engine's snapshot from before the update "
                             "changed")
    rstats = grp.replica_stats()
    n_dirty = 0 if r_dirty is None else int(r_dirty.size)
    if any(r["full_relands"] != 1 or r["rows_patched"] != n_dirty
           for r in rstats):
        raise AssertionError(f"replicas: {rstats}, {n_dirty} dirty rows")
    replicas = {"replicas": len(grp.replicas),
                "added_device_bytes": replica_bytes,
                "snapshot_bytes": before.nbytes(),
                "update": {"inserts": r_ins, "deletes": r_del,
                           "seconds": replica_update_s,
                           "scope": int(eng.idx.stats["maintenance_scope"]),
                           "dirty_rows": n_dirty},
                "replica_stats": rstats,
                "rows_patched": gst.mesh_rows_patched}
    grp.close()
    del fresh, kept, before
    lap("replicas")

    churn = small_graph_churn(api, serve_mod, ops, counters)
    service_launches += churn.pop("label_join_launches")
    closure_launches = churn.pop("dense_launches")
    lap("small_graph_churn")

    emit({"phase": "service_path", "n": h.n, "m": h.m,
          "requests": {"mr": SERVICE_MR_REQUESTS,
                       "s_reach": SERVICE_SREACH_REQUESTS,
                       "tenants": dict(SERVICE_TENANTS)},
          "runs": runs, "split": splits, "kernel_ms_by_bucket": bucket_ms,
          "trace": trace,
          "latency": latency, "update": update, "replicas": replicas,
          "churn": churn, "label_join_launches": service_launches,
          "step_seconds": steps, "seconds": clock.seconds()})
    return service_launches, closure_launches


def small_graph_churn(api, serve_mod, ops, counters):
    """ENG-s through 20 seeded update batches: a kernel service and its
    twin without kernels answer alike at every version; then the closure
    backend behind a service through two updates, both methods, each
    rebuild's launches counted, answers held to the hl-index service."""
    lj = counters["label_join"]
    g = SMALL_GRAPH
    h = api.random_hypergraph(g["n"], g["m"], min_size=g["min_size"],
                              max_size=g["max_size"], seed=g["seed"])
    kern = api.serve(h, "hl-index", start=False,
                     config=serve_mod.ServiceConfig(use_kernels=True))
    twin = api.serve(h, "hl-index", start=False,
                     config=serve_mod.ServiceConfig(use_kernels=False))
    rng = np.random.default_rng(21)
    versions = []
    reset_counts(counters)
    for version in range(20):
        ins, dels = fan_churn_script(rng, g["n"], version, kern.engine.h)
        kern.update(inserts=ins, deletes=dels)
        twin.update(inserts=ins, deletes=dels)
        reqs, _, _, _ = service_requests(serve_mod, rng, kern.engine.h.n,
                                         384, 128)
        kf = kern.submit_many(reqs)
        tf = twin.submit_many(reqs)
        kern.drain()
        twin.drain()
        check_service_answers(f"churn v{version + 1}", kf,
                              [f.result(timeout=60) for f in tf])
        lmax = kern._snap.lmax
        versions.append({"version": version + 1, "n": kern.engine.h.n,
                         "m": kern.engine.h.m, "lmax": lmax,
                         "lanes_per_query": lj.lanes_per_query(lmax)})
    launches = read_counts(counters)["label_join"]
    if launches != kern.stats().batches or twin.stats().kernel_batches:
        raise AssertionError(f"churn: {launches} launches for "
                             f"{kern.stats().batches} kernel batches")
    routes = {v["lanes_per_query"] for v in versions}
    if 0 not in routes or not routes - {0}:
        raise AssertionError(f"churn: the routes taken were {routes}")

    closure = {}
    dense = {name: 0 for name in DENSE_KERNELS}
    label_join_launches = launches
    for method in ("maxmin", "threshold"):
        kernel = {"maxmin": "maxmin_matmul",
                  "threshold": "threshold_step"}[method]
        reset_counts(counters)
        ceng = api.build_engine(h, "closure", method=method)
        build = read_counts(counters)
        csvc = api.serve(ceng, start=False,
                         config=serve_mod.ServiceConfig(use_kernels=True))
        hsvc = api.serve(h, "hl-index", start=False,
                         config=serve_mod.ServiceConfig(use_kernels=True))
        rebuilds = [{"m": h.m, "launches": {k: v for k, v in build.items()
                                            if v}}]
        crng = np.random.default_rng(23)
        for step in range(3):
            if step:
                ins = [[int(x) for x in crng.choice(ceng.h.n, 5,
                                                    replace=False)]
                       for _ in range(step)]
                dels = [int(crng.integers(ceng.h.m))]
                reset_counts(counters)
                csvc.update(inserts=ins, deletes=dels)
                counts = read_counts(counters)
                padded = read_padded(counters)
                hsvc.update(inserts=ins, deletes=dels)
                rebuilds.append({"m": ceng.h.m, "seconds":
                                 ceng.build_seconds,
                                 "launches": {k: v for k, v in counts.items()
                                              if v},
                                 "padded_launches": padded})
                build = counts
            want = {name: 0 for name in counters}
            want.update({"overlap": 1, kernel: ops.default_rounds(ceng.h.m)})
            if build != want:
                raise AssertionError(f"closure {method} service, rebuild "
                                     f"{step}: launches {build}, expected "
                                     f"{want}")
            for name in DENSE_KERNELS:
                dense[name] += build[name]
            reqs, _, _, _ = service_requests(serve_mod, crng, ceng.h.n, 768,
                                             256)
            cf = csvc.submit_many(reqs)
            hf = hsvc.submit_many(reqs)
            for tag, svc in (("closure", csvc), ("hl-index", hsvc)):
                # each service's launches, held to its own micro-batches
                before = svc.stats()
                reset_counts(counters)
                svc.drain()
                joins = read_counts(counters)["label_join"]
                after = svc.stats()
                batches = after.batches - before.batches
                if joins != batches or (after.kernel_batches
                                        - before.kernel_batches) != batches:
                    raise AssertionError(
                        f"closure {method} v{step}: the {tag} service made "
                        f"{joins} launches for {batches} micro-batches")
                label_join_launches += joins
            check_service_answers(f"closure {method} v{step}", cf,
                                  [f.result(timeout=60) for f in hf])
        cst = csvc.stats()
        closure[method] = {"rebuilds": rebuilds,
                           "lmax": csvc._snap.lmax,
                           "kernel_batches": cst.kernel_batches}
    return {"graph": g, "versions": versions, "closure": closure,
            "label_join_launches": label_join_launches,
            "dense_launches": dense}


# -- the dense closure kernels ----------------------------------------------

def cuda_once(fn):
    """(milliseconds, result) of one call of ``fn`` on the card."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def expect_no_launch(mod, tag, fn, want):
    """An empty shape: ``fn`` answers ``want`` and launches nothing."""
    before = mod.LAUNCHES
    got = fn()
    torch.cuda.synchronize()
    if mod.LAUNCHES != before:
        raise AssertionError(f"{tag}: an empty shape launched the kernel")
    check_equal(tag, got, want)


def dense_times(kernel, plain, library, bound_ms_by, reps, plain_reps,
                library_f32=None):
    """Kernel / plain / library ms (CUDA events, median) and the bound;
    ``library_f32``: the same library call on float32 operands."""
    out = {"ms": cuda_ms(kernel, reps=reps, warmup=1),
           "plain_ms": cuda_ms(plain, reps=plain_reps, warmup=1),
           "library_ms": (cuda_ms(library, reps=reps, warmup=1)
                          if library is not None else None)}
    if library_f32 is not None:
        out["library_f32_ms"] = cuda_ms(library_f32, reps=reps, warmup=1)
    out["bound_ms"], out["bound_by"] = bound_ms_by
    return out


def counted(mod, tag, fn, launches, padded):
    """``fn()`` on the card with ``mod``'s counts read around it: it must
    launch ``launches`` times, ``padded`` of them through the zero pad."""
    before = (mod.LAUNCHES, mod.PADDED)
    out = fn()
    torch.cuda.synchronize()
    got = (mod.LAUNCHES - before[0], mod.PADDED - before[1])
    if got != (launches, padded):
        raise AssertionError(f"{tag}: (launches, padded) {got}, expected "
                             f"{(launches, padded)}")
    return out


def phase_dense_kernel_checks(mm, ov, tc, device):
    """maxmin_matmul, overlap and threshold_step on the card against their
    plain versions, tolerance 0: the reference harness's corpora, the empty
    shapes (no launch), and one medium shape each (timed).  Returns
    {kernel: max abs err}."""
    errs = {}
    gen = torch.Generator(device=device)

    # maxmin_matmul, int32 and float32
    clock, err, cases = Phase(), 0, []
    for m, k, n, seed in MAXMIN_CORPUS:
        for np_dtype in (np.int32, np.float32):
            rng = np.random.default_rng(seed)
            a = torch.from_numpy(rng.integers(0, 12, (m, k))
                                 .astype(np_dtype)).to(device)
            b = torch.from_numpy(rng.integers(0, 12, (k, n))
                                 .astype(np_dtype)).to(device)
            tag = f"maxmin corpus[{m},{k},{n}] {a.dtype}"
            want = mm.maxmin_matmul_ref(a, b)
            if m and k and n:
                err = max(err, check_equal(tag, mm.maxmin_matmul(a, b), want))
            else:
                expect_no_launch(mm, tag, lambda: mm.maxmin_matmul(a, b), want)
            cases.append({"shape": [m, k, n], "dtype": str(a.dtype),
                          "case": "corpus", "equal": True})
    size = MEDIUM_MAXMIN
    for dtype in (torch.int32, torch.float32):
        gen.manual_seed(21)
        a = torch.randint(0, 12, (size, size), generator=gen, device=device,
                          dtype=torch.int32).to(dtype)
        b = torch.randint(0, 12, (size, size), generator=gen, device=device,
                          dtype=torch.int32).to(dtype)
        err = max(err, check_equal(f"maxmin medium {dtype}",
                                   mm.maxmin_matmul(a, b),
                                   mm.maxmin_matmul_ref(a, b, block=16)))
        row = {"shape": [size] * 3, "dtype": str(dtype), "case": "medium",
               "equal": True}
        row.update(dense_times(lambda: mm.maxmin_matmul(a, b),
                               lambda: mm.maxmin_matmul_ref(a, b, block=16),
                               None, maxmin_bound(size, size, size), 10, 3))
        cases.append(row)
    errs["maxmin_matmul"] = err
    emit({"phase": "kernel_checks", "kernel": "maxmin_matmul",
          "tolerance": 0, "max_abs_err": err, "cases": cases,
          "seconds": clock.seconds()})

    # overlap, float32 and bfloat16 0/1 input, float32 W; n % 8 != 0 goes
    # through the wrapper's zero columns
    clock, err, cases = Phase(), 0, []
    for m, n, seed in OVERLAP_CORPUS + OVERLAP_EXTRA:
        rng = np.random.default_rng(seed)
        b_inc = torch.from_numpy((rng.random((m, n)) < 0.3)
                                 .astype(np.float32)).to(device)
        want = ov.overlap_ref(b_inc)
        for operand in (b_inc, b_inc.to(torch.bfloat16)):
            tag = f"overlap [{m},{n}] {operand.dtype}"
            if m and n:
                got = counted(ov, tag, lambda: ov.overlap(operand), 1,
                              int(n % 8 != 0))
                err = max(err, check_equal(tag, got, want))
            else:
                expect_no_launch(ov, tag, lambda: ov.overlap(operand), want)
        cases.append({"shape": [m, n], "padded": bool(n % 8),
                      "case": "corpus" if seed < 9 else "extra",
                      "dtypes": ["float32", "bfloat16"], "equal": True})
    gen.manual_seed(22)
    m, n = MEDIUM_OVERLAP
    b_inc = (torch.rand((m, n), generator=gen, device=device) < 0.3).float()
    b16 = b_inc.to(torch.bfloat16)
    want = ov.overlap_ref(b_inc)
    for operand in (b_inc, b16):
        err = max(err, check_equal(f"overlap medium {operand.dtype}",
                                   ov.overlap(operand), want))
    row = {"shape": [m, n], "dtype": "bfloat16", "case": "medium",
           "equal": True}
    row.update(dense_times(lambda: ov.overlap(b16),
                           lambda: ov.overlap_ref(b_inc),
                           lambda: torch.matmul(b16, b16.T),
                           overlap_bound(m, n, 2), 20, 20,
                           library_f32=lambda: torch.matmul(b_inc, b_inc.T)))
    cases.append(row)
    errs["overlap"] = err
    emit({"phase": "kernel_checks", "kernel": "overlap", "tolerance": 0,
          "max_abs_err": err, "cases": cases, "seconds": clock.seconds()})

    # threshold_step, float32 and bfloat16; m % 8 != 0 goes through the
    # wrapper's zero pad
    clock, err, cases = Phase(), 0, []
    for s, m, seed in THRESHOLD_CORPUS + THRESHOLD_EXTRA:
        rng = np.random.default_rng(seed)
        r32 = torch.from_numpy((rng.random((s, m, m)) < 0.2)
                               .astype(np.float32)).to(device)
        for r in (r32, r32.to(torch.bfloat16)):
            tag = f"threshold [{s},{m}] {r.dtype}"
            want = tc.threshold_step_ref(r)
            if s and m:
                got = counted(tc, tag, lambda: tc.threshold_step(r), 1,
                              int(m % 8 != 0))
                err = max(err, check_equal(tag, got, want))
                if not torch.equal(got.float(), tc.threshold_step_ref(r32)):
                    raise AssertionError(f"{tag}: the dtypes disagree")
            else:
                expect_no_launch(tc, tag, lambda: tc.threshold_step(r), want)
                if tc.threshold_step(r) is not r:
                    raise AssertionError(f"{tag}: an empty batch must come "
                                         f"back as is")
        cases.append({"shape": [s, m, m], "padded": bool(m % 8),
                      "case": "corpus" if seed < 9 else "extra",
                      "dtypes": ["float32", "bfloat16"], "equal": True})
    gen.manual_seed(23)
    s, m = MEDIUM_THRESHOLD
    # about one in five entries of a squared row set: a mixed 0/1 answer
    r32 = (torch.rand((s, m, m), generator=gen, device=device) < 0.01).float()
    r = r32.to(torch.bfloat16)
    got = tc.threshold_step(r)
    err = max(err, check_equal("threshold medium bf16", got,
                               tc.threshold_step_ref(r)))
    err = max(err, check_equal("threshold medium float32",
                               tc.threshold_step(r32),
                               tc.threshold_step_ref(r32)))
    row = {"shape": [s, m, m], "dtype": "bfloat16", "case": "medium",
           "equal": True, "share_ones": float(got.float().mean())}
    row.update(dense_times(lambda: tc.threshold_step(r),
                           lambda: tc.threshold_step_ref(r),
                           lambda: torch.bmm(r, r),
                           threshold_bound(s, m, 2), 10, 10,
                           library_f32=lambda: torch.bmm(r32, r32)))
    cases.append(row)
    errs["threshold_step"] = err
    emit({"phase": "kernel_checks", "kernel": "threshold_step",
          "tolerance": 0, "max_abs_err": err, "cases": cases,
          "seconds": clock.seconds()})
    return errs


def reset_counts(counters):
    for mod in counters.values():
        mod.LAUNCHES = 0
        if hasattr(mod, "PADDED"):
            mod.PADDED = 0


def read_counts(counters):
    torch.cuda.synchronize()
    return {name: mod.LAUNCHES for name, mod in counters.items()}


def read_padded(counters):
    """Launches that went through a wrapper's zero pad, per kernel."""
    return {name: mod.PADDED for name, mod in counters.items()
            if hasattr(mod, "PADDED")}


def counted_closure_build(api, h, method, counters, rounds, device):
    """One ``build_engine(h, "closure", method=...)`` on the card with every
    count set to 0 just before and read just after: it must launch
    ``overlap`` once and its closure kernel ``rounds`` times, nothing else,
    and ``threshold_step`` never through its zero pad.  Returns the engine,
    the launch counts, the padded counts and the seconds."""
    kernel = {"maxmin": "maxmin_matmul", "threshold": "threshold_step"}[method]
    reset_counts(counters)
    t0 = time.perf_counter()
    eng = api.build_engine(h, "closure", method=method)
    counts = read_counts(counters)
    seconds = time.perf_counter() - t0
    padded = read_padded(counters)
    want = {name: 0 for name in counters}
    want.update({"overlap": 1, kernel: rounds})
    if counts != want:
        raise AssertionError(f"closure {method} build at m={h.m}: launches "
                             f"{counts}, expected {want}")
    if padded["threshold_step"] != 0:
        raise AssertionError(f"closure {method} build at m={h.m}: "
                             f"threshold_step padded {padded}")
    if eng.name != "closure" or eng.device.type != device.type:
        raise AssertionError(f"built {eng.name} on {eng.device}")
    return eng, counts, padded, seconds


def phase_closure_path(api, semiring, ops, counters, wl, device, refs):
    """The dense closure at the published size of primary-school: both
    methods built through the facade on the card (counted), W* held across
    the two, the overlap W against the host line graph, batches against
    the host and the MST oracle's forest; then each kernel at the path's
    own operands against its plain version, timed."""
    clock = Phase()
    mm, ov, tc = (counters[k] for k in DENSE_KERNELS)
    g = CLOSURE_GRAPH
    t0 = time.perf_counter()
    h = api.random_hypergraph(g["n"], g["m"], min_size=g["min_size"],
                              max_size=g["max_size"], seed=g["seed"])
    gen_s = time.perf_counter() - t0
    rounds = ops.default_rounds(h.m)
    engines, builds, launches, pads = {}, {}, {}, {}
    for method in ("maxmin", "threshold"):
        eng, counts, padded, build_s = counted_closure_build(
            api, h, method, counters, rounds, device)
        t0 = time.perf_counter()
        snap = eng.snapshot()
        torch.cuda.synchronize()
        snap_s = time.perf_counter() - t0
        if snap.svals.device.type != device.type or snap.lmax != h.m:
            raise AssertionError("closure snapshot is not [n, m] on the card")
        engines[method] = eng
        launches[method] = {k: v for k, v in counts.items() if v}
        pads[method] = padded
        builds[method] = {"build_seconds": round(build_s, 3),
                          **{k: round(v, 3)
                             for k, v in eng.build_seconds.items()},
                          "snapshot": round(snap_s, 3)}
    w_star = engines["maxmin"].w_star
    if w_star.dtype != np.int32 or w_star.shape != (h.m, h.m):
        raise AssertionError(f"W* is {w_star.dtype}{w_star.shape}")
    if not np.array_equal(w_star, engines["threshold"].w_star):
        raise AssertionError("closure_path: W* (maxmin) != W* (threshold)")

    # the overlap kernel's W (one launch outside the counted runs)
    b_inc = torch.from_numpy(h.to_incidence(np.float32)).to(device)
    w = semiring.device_line_graph(h)
    host_w = h.line_graph(np.int32)
    if not np.array_equal(w.cpu().numpy(), host_w):
        raise AssertionError("closure_path: overlap W != host line graph")
    thresholds = semiring.distinct_thresholds(host_w)
    del host_w

    # batches, both engines, against the host W* and each other
    s = 3
    rng = np.random.default_rng(13)
    sizes = [1000, 4096]
    batches = [(rng.integers(0, h.n, q), rng.integers(0, h.n, q))
               for q in sizes]
    answers = {meth: drive_batches(eng, batches, s)
               for meth, eng in engines.items()}
    check_answers("closure_path", answers["maxmin"], answers["threshold"], s)
    us, vs = batches[0]
    if not np.array_equal(answers["maxmin"][0][0],
                          semiring.vertex_mr_from_edge_mr(h, w_star, us, vs)):
        raise AssertionError("closure_path: batch != host W* segment max")
    batch_ms = [{"queries": q,
                 "mr_batch_ms": host_ms(lambda: engines["maxmin"]
                                        .mr_batch(bu, bv), 10),
                 "s_reach_batch_ms": host_ms(lambda: engines["maxmin"]
                                             .s_reach_batch(bu, bv, s), 10)}
                for (bu, bv), q in zip(batches, sizes)]

    # the MST oracle: its forest swept once per incident hyperedge of u
    # gives W* rows and MR(u, v) (its own mr() walks the forest once per
    # hyperedge pair, some 34,000 walks per pair at this density)
    oracle, oracle_build = refs.take("closure", "mst-oracle", h)
    t0 = time.perf_counter()
    checked = 0
    for u, v in zip(us[:CLOSURE_ORACLE_PAIRS], vs[:CLOSURE_ORACLE_PAIRS]):
        eu = h.edges_of(int(u))
        rows = oracle.rows(eu)
        if not np.array_equal(rows, w_star[eu]):
            raise AssertionError(f"closure_path: W* rows of vertex {u} "
                                 f"differ from the MST oracle's forest")
        want = int(rows[:, h.edges_of(int(v))].max()) \
            if eu.size and h.degree(int(v)) else 0
        if want != int(answers["maxmin"][0][0][checked]):
            raise AssertionError(f"closure_path: MR({u}, {v}) differs from "
                                 f"the MST oracle")
        checked += 1
    for ei, ej in rng.integers(0, h.m, (4, 2)):
        if oracle.edge_mr(int(ei), int(ej)) != int(w_star[ei, ej]):
            raise AssertionError(f"closure_path: W*[{ei}, {ej}] differs from "
                                 f"MSTOracle.edge_mr")
    oracle_s = time.perf_counter() - t0
    del oracle
    workloads = closure_workloads(wl, semiring, engines["maxmin"],
                                  answers["maxmin"][0][0], us, vs)

    emit({"phase": "closure_path", "n": h.n, "m": h.m, "nnz": h.nnz,
          "generate_seconds": round(gen_s, 3), "rounds": rounds,
          "S": int(thresholds.size), "thresholds": thresholds.tolist(),
          "launches": launches, "padded_launches": pads, "builds": builds,
          "snapshot_bytes": engines["maxmin"].snapshot().nbytes(),
          "w_star_bytes": engines["maxmin"].nbytes(),
          "w_star_histogram": np.bincount(w_star.ravel()).tolist(),
          "s": s, "batches": batch_ms,
          "host_segment_max_pairs": sizes[0],
          "oracle_pairs": checked, "oracle_w_star_rows": int(sum(
              h.degree(int(u)) for u in us[:checked])),
          "oracle_build": oracle_build,
          "oracle_seconds": round(oracle_s, 3),
          "workloads": workloads,
          "seconds": clock.seconds()})
    # the threshold engine serves bench_path's primary-school requests
    bench_engine = engines["threshold"]
    del engines, answers
    torch.cuda.empty_cache()

    # each kernel at this path's own operands, against its plain version
    clock = Phase()
    rows = {}
    # overlap at the path's dtype: the bf16 incidence device_line_graph
    # hands it (n = 242: the wrapper pads 6 zero columns)
    b16 = b_inc.to(torch.bfloat16)
    got = ov.overlap(b16)
    err = check_equal("overlap path bf16", got, ov.overlap_ref(b_inc))
    err = max(err, check_equal("overlap path float32", ov.overlap(b_inc),
                               got))
    # device_line_graph step by step: copy, bf16 cast, the wrapper's column
    # pad (also inside the wrapper's time below), int32 cast of W
    host_inc = h.to_incidence(np.float32)
    line_graph_steps = {
        "incidence_to_device_ms": host_ms(
            lambda: (torch.from_numpy(host_inc).to(device),
                     torch.cuda.synchronize()), 10),
        "bf16_cast_ms": cuda_ms(lambda: b_inc.to(torch.bfloat16), reps=20),
        "pad_columns_ms": cuda_ms(lambda: ov.pad_columns(b16), reps=20),
        "int32_cast_ms": cuda_ms(lambda: got.to(torch.int32), reps=20),
        "device_line_graph_ms": host_ms(
            lambda: (semiring.device_line_graph(h),
                     torch.cuda.synchronize()), 10),
    }
    del got, host_inc
    rows["overlap"] = dict(
        shape=list(b16.shape), dtype="bfloat16", max_abs_err=err,
        bf16_ceiling_ms=bf16_ceiling_ms(2 * h.m * h.m * h.n),
        **dense_times(lambda: ov.overlap(b16),
                      lambda: ov.overlap_ref(b_inc),
                      lambda: torch.matmul(b16, b16.T),
                      overlap_bound(h.m, h.n, 2), 10, 10,
                      library_f32=lambda: torch.matmul(b_inc, b_inc.T)))
    rows["overlap"]["kernel_ms_includes"] = "pad_columns, kernel"
    # the library call on the kernel's own operand (242 -> 248 columns)
    padded = ov.pad_columns(b16)
    rows["overlap"]["library_padded_ms"] = cuda_ms(
        lambda: torch.matmul(padded, padded.T), reps=10, warmup=1)
    del b16, padded
    # maxmin: the first squaring round of W, whole; the plain version walks
    # k 16 columns at a time (an [m, 16, m] int32 broadcast each)
    got = mm.maxmin_matmul(w, w)
    plain_ms, want = cuda_once(lambda: mm.maxmin_matmul_ref(w, w, block=16))
    err = check_equal("maxmin path", got, want)
    del got, want
    bound_ms, bound_by = maxmin_bound(h.m, h.m, h.m)
    rows["maxmin_matmul"] = dict(
        shape=[h.m] * 3, max_abs_err=err, plain_ms=plain_ms,
        plain_reps=1, ms=cuda_ms(lambda: mm.maxmin_matmul(w, w), reps=3,
                                 warmup=1),
        library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
    # threshold_step: the first round of the threshold batch, in the path's
    # bf16 and in float32 (a float32 operand launches the same kernel)
    r = tc.threshold_adjacency(w, torch.as_tensor(thresholds),
                               dtype=torch.bfloat16)
    r32 = r.float()
    del w
    got = tc.threshold_step(r)
    err = check_equal("threshold path bf16", got, tc.threshold_step_ref(r))
    share_ones = float(got.float().mean())
    got32 = tc.threshold_step(r32)
    err = max(err, check_equal("threshold path float32", got32,
                               tc.threshold_step_ref(r32)))
    if not torch.equal(got32, got.float()):
        raise AssertionError("threshold path: float32 and bf16 rounds differ")
    del got, got32
    torch.cuda.empty_cache()
    ops_count = 2 * r.shape[0] * h.m ** 3
    rows["threshold_step"] = dict(
        shape=list(r.shape), dtype="bfloat16", max_abs_err=err,
        share_ones=share_ones, bf16_ceiling_ms=bf16_ceiling_ms(ops_count),
        **dense_times(lambda: tc.threshold_step(r),
                      lambda: tc.threshold_step_ref(r),
                      lambda: torch.bmm(r, r),
                      threshold_bound(r.shape[0], h.m, 2), 5, 3,
                      library_f32=lambda: torch.bmm(r32, r32)))
    rows["threshold_step"]["float32_ms"] = cuda_ms(
        lambda: tc.threshold_step(r32), reps=3, warmup=1)
    rows["threshold_step"]["tflops"] = (ops_count / 1e9
                                        / rows["threshold_step"]["ms"])
    del r, r32
    torch.cuda.empty_cache()
    emit({"phase": "closure_path_kernels", "tolerance": 0,
          "peak_bytes": torch.cuda.max_memory_allocated(),
          "line_graph_steps": line_graph_steps,
          "kernels": rows, "seconds": clock.seconds()})
    total = {name: sum(c.get(name, 0) for c in launches.values())
             for name in DENSE_KERNELS}
    padded = {name: sum(p[name] for p in pads.values())
              for name in TENSOR_CORE_KERNELS}
    return total, padded, rows, w_star, bench_engine


def phase_closure_small(api, ops, counters, device):
    """ENG-s, where everything is cheap: both closure methods on the card
    answer every pair as the hl-index engine (label_join kernel) and as the
    MST oracle's forest, and W* equals the forest's every row."""
    clock = Phase()
    g = SMALL_GRAPH
    h = api.random_hypergraph(g["n"], g["m"], min_size=g["min_size"],
                              max_size=g["max_size"], seed=g["seed"])
    us, vs = np.divmod(np.arange(h.n * h.n), h.n)
    rounds = ops.default_rounds(h.m)
    oracle = api.build_engine(h, "mst-oracle").oracle
    forest = oracle.rows(range(h.m))
    hl = api.build_engine(h, "hl-index", use_kernels=True)
    want = hl.mr_batch(us, vs)
    # the forest's vertex-level answers: max over incident hyperedge pairs
    mr_forest = np.zeros(h.n * h.n, np.int64)
    for u in range(h.n):
        eu = h.edges_of(u)
        if eu.size:
            best = forest[eu].max(axis=0)
            for v in range(h.n):
                ev = h.edges_of(v)
                if ev.size:
                    mr_forest[u * h.n + v] = best[ev].max()
    if not np.array_equal(want, mr_forest):
        raise AssertionError("closure_small: hl-index != MST oracle forest")
    direct = [oracle.mr(int(u), int(v)) for u, v in zip(us[:400:3], vs[:400:3])]
    if direct != mr_forest[:400:3].tolist():
        raise AssertionError("closure_small: MSTOracle.mr != its forest rows")
    out = {}
    for method in ("maxmin", "threshold"):
        eng, counts, _, build_s = counted_closure_build(api, h, method,
                                                        counters, rounds,
                                                        device)
        if not np.array_equal(eng.w_star, forest):
            raise AssertionError(f"closure_small {method}: W* != forest")
        got = eng.mr_batch(us, vs)
        if got.dtype != np.int32 or not np.array_equal(got, want):
            raise AssertionError(f"closure_small {method}: answers differ")
        for s in (2, 4):
            if not np.array_equal(eng.s_reach_batch(us, vs, s), want >= s):
                raise AssertionError(f"closure_small {method}: s_reach")
        out[method] = {"build_seconds": round(build_s, 3),
                       "launches": {k: v for k, v in counts.items() if v}}
    emit({"phase": "closure_small", "n": h.n, "m": h.m, "pairs": h.n * h.n,
          "rounds": rounds, "oracle_direct_pairs": len(direct),
          "answer_histogram": np.bincount(want).tolist(), "builds": out,
          "seconds": clock.seconds()})


# -- the sharded backend on a logical mesh -----------------------------------

def inside_pairs(rng, h, q):
    """``q`` query pairs, every other one two members of one hyperedge
    (random pairs on the main path's graph almost all answer 0 or 1), the
    rest random."""
    us, vs = rng.integers(0, h.n, q), rng.integers(0, h.n, q)
    sizes = h.edge_sizes
    inside = rng.choice(np.flatnonzero(sizes >= 2), (q + 1) // 2)
    size = sizes[inside]
    i = (rng.random(inside.size) * size).astype(np.int64)
    j = (i + 1 + (rng.random(inside.size) * (size - 1)).astype(np.int64)) \
        % size
    us[0::2] = h.e_idx[h.e_ptr[inside] + i]
    vs[0::2] = h.e_idx[h.e_ptr[inside] + j]
    return us, vs


def counted_run(counters, fn):
    """``fn()`` with every count set to 0 just before and read just after:
    (result, launches per kernel, ``label_join_gather`` apart)."""
    reset_counts(counters)
    counters["label_join"].GATHER_LAUNCHES = 0
    out = fn()
    return out, counts_now(counters)


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def expect_counts(tag, counts, want):
    got = {k: v for k, v in counts.items() if v}
    if got != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"{tag}: launches {got}, expected {want}")


def plain_maxmin_closure(mm, w):
    """The bottleneck closure of ``w`` in plain rounds on the card:
    ``max(R, maxmin_matmul_ref(R, R))`` (16 columns of the contraction at a
    time) until a round changes nothing, which is W* (the kernel builds
    run the whole ⌈log2 m⌉ ladder to the same fixpoint).  Returns (W*,
    rounds run, the first round's product R∘R and its ms)."""
    r, rounds, first = w, 0, None
    while True:
        ms, prod = cuda_once(lambda: mm.maxmin_matmul_ref(r, r, block=16))
        if first is None:
            first = (prod, ms)
        nxt = torch.maximum(r, prod)
        rounds += 1
        if torch.equal(nxt, r):
            return r, rounds, first
        r = nxt


def maxmin_f32_rows(mm, w, first):
    """The float32 ``maxmin_matmul`` at the sharded closure's operands (the
    line graph of the first round): the whole [m]^3 product of the 1 x 1
    grid (held to the plain closure's first product ``first``, and timed
    beside that product's ms) and the two block shapes of a 2 x 2 grid —
    allgather's row panel x column panel [m/2, m] x [m, m/2] and ring's
    [m/2]^3 segment — each against its plain version, timed, with its
    bound at the int32 min/max rate (float min/max is not priced apart)."""
    m = w.shape[0]
    half = m // 2
    rows = {}
    for tag, a, b in ((f"[{m}]^3", w, w),
                      (f"[{half}, {m}] x [{m}, {half}]", w[:half].contiguous(),
                       w[:, :half].contiguous()),
                      (f"[{half}]^3", w[:half, :half].contiguous(),
                       w[:half, :half].contiguous())):
        if a is w:
            plain_ms, want = first[1], first[0]
        else:
            plain_ms, want = cuda_once(
                lambda: mm.maxmin_matmul_ref(a, b, block=16))
        err = check_equal(f"maxmin float32 {tag}", mm.maxmin_matmul(a, b),
                          want)
        del want
        bound_ms, bound_by = maxmin_bound(a.shape[0], a.shape[1],
                                          b.shape[1])
        rows[tag] = {"shape": [a.shape[0], a.shape[1], b.shape[1]],
                     "dtype": "float32", "max_abs_err": err,
                     "ms": cuda_ms(lambda: mm.maxmin_matmul(a, b),
                                   reps=3 if a is w else 5, warmup=1),
                     "plain_ms": plain_ms, "plain_reps": 1,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None}
    return rows


def eng_s_copies(api, copies):
    """``copies`` disjoint copies of ENG-s (one line-graph component each)."""
    g = SMALL_GRAPH
    hs = api.random_hypergraph(g["n"], g["m"], min_size=g["min_size"],
                               max_size=g["max_size"], seed=g["seed"])
    return api.from_edge_lists(
        [hs.edge(e) + k * hs.n for k in range(copies) for e in range(hs.m)],
        n=copies * hs.n)


def closure_all_pairs(h, w_star):
    """MR of every ordered pair (u, v), row-major, from the ``closure``
    engine's host W* as its scalar path answers it: the max over
    e_u ∋ u and e_v ∋ v of W*[e_u, e_v] (0 where either has none)."""
    out = np.zeros((h.n, h.n), np.int64)
    for u in range(h.n):
        eu = h.edges_of(u)
        if eu.size:
            best = w_star[eu].max(axis=0)
            for v in range(h.n):
                ev = h.edges_of(v)
                if ev.size:
                    out[u, v] = best[ev].max()
    return out.ravel()


def held_to_plain(tag, eng, us, vs, answers):
    """The engine's kernel answers against the plain join (``batched_mr``,
    in chunks of 4,096 pairs) of its own snapshot on the same pairs;
    returns the max abs error (0)."""
    snap = eng.snapshot()
    bu = torch.from_numpy(np.asarray(us, np.int64)).to(snap.device)
    bv = torch.from_numpy(np.asarray(vs, np.int64)).to(snap.device)
    want = torch.cat([snap.mr(bu[i:i + 4096], bv[i:i + 4096])
                      for i in range(0, bu.numel(), 4096)])
    return check_equal(tag, torch.from_numpy(
        np.asarray(answers).astype(np.int32)).to(snap.device), want)


def phase_sharded_path(api, dist, counters, closure_w, main, device):
    """The ``sharded`` backend on a logical mesh: the closure regime on
    primary-school (1 x 1 allgather, 2 x 2 allgather and ring, float32
    ``maxmin_matmul`` block contractions, W* held to a plain closure on the
    card and to ``closure_path``'s host W* ``closure_w``), its snapshot's
    every pair through
    ``label_join_gather``; the threshold closure on a (1, 2, 2) grid
    through ``threshold_step``; the mesh overlap route through ``overlap``;
    the label regime on the main path's graph (labels byte-equal to
    ``main_path``'s, 2^20 pairs through ``label_join_gather``); scoped
    churn, a ``ReplicaGroup`` and the three store payloads on 4 x ENG-s.
    Returns (launches per kernel, max abs err per kernel, kernel rows,
    ``rank_path``'s inputs: the graph, its host W, the padded 2 x 2 W*
    and every pair's answer)."""
    clock = Phase()
    mm, ov, tc, lj = (counters[k] for k in ("maxmin_matmul", "overlap",
                                            "threshold_step", "label_join"))
    from repro_torch.core import hlindex as hl_mod
    from repro_torch.core.hypergraph import (apply_edge_edits,
                                             neighbor_csr)
    from repro_torch.kernels.ops import default_rounds
    out = {"phase": "sharded_path"}
    total, errs, rows = {}, {k: 0 for k in (
        "maxmin_matmul", "overlap", "threshold_step",
        "label_join_gather")}, {}
    axes = ("data", "model")
    mesh11 = api.make_mesh((1, 1), axes)
    mesh22 = api.make_mesh((2, 2), axes)

    # 1. the closure regime on primary-school
    g = CLOSURE_GRAPH
    h = api.random_hypergraph(g["n"], g["m"], min_size=g["min_size"],
                              max_size=g["max_size"], seed=g["seed"])
    rounds = default_rounds(h.m)
    plan = api.plan_backend(h, mesh=mesh22)
    if plan != "sharded":
        raise AssertionError(f"sharded_path: the planner named {plan}")
    w_host = h.line_graph(np.int32).astype(np.float32)
    w = torch.from_numpy(w_host).to(device)
    (plain_w, plain_rounds, first), plain_s = timed_s(
        lambda: plain_maxmin_closure(mm, w))
    closure_dev = torch.from_numpy(closure_w).to(device)
    if not torch.equal(plain_w.to(torch.int32), closure_dev):
        raise AssertionError("sharded_path: the plain closure != "
                             "closure_path's W*")
    builds = {}
    keep = None
    for shape, schedule in (((1, 1), "allgather"), ((2, 2), "allgather"),
                            ((2, 2), "ring")):
        mesh = mesh11 if shape == (1, 1) else mesh22
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (eng, build_s), counts = counted_run(counters, lambda: timed_s(
            lambda: api.build_engine(h, "sharded", mesh=mesh,
                                     schedule=schedule, use_kernels=True)))
        peak = torch.cuda.max_memory_allocated() - base
        r, c = shape
        launches = rounds * r * c * (r if schedule == "ring" else 1)
        tag = f"{r}x{c} {schedule}"
        expect_counts(f"sharded_path {tag} build", counts,
                      {"maxmin_matmul": launches})
        add_counts(total, counts)
        mp = -(-h.m // math.lcm(r, c)) * math.lcm(r, c)
        if (eng._w_star.dtype != torch.float32
                or eng._w_star.device.type != device.type
                or tuple(eng._w_star.shape) != (mp, mp)):
            raise AssertionError(
                f"sharded_path {tag}: W* is {eng._w_star.dtype}"
                f"{tuple(eng._w_star.shape)} on {eng._w_star.device}")
        w_star = eng._w_star[:h.m, :h.m]
        errs["maxmin_matmul"] = max(errs["maxmin_matmul"], check_equal(
            f"sharded_path {tag} W* vs the plain closure", w_star, plain_w))
        if not torch.equal(w_star.to(torch.int32), closure_dev):
            raise AssertionError(f"sharded_path {tag}: W* != closure_path's")
        builds[tag] = {"build_seconds": build_s,
                       "maxmin_matmul_float32_launches":
                           counts["maxmin_matmul"],
                       "peak_rise_bytes": peak}
        if tag == "2x2 allgather":
            w_star22 = eng._w_star.cpu().numpy()     # for rank_path
        if keep is None:
            keep = eng
        else:
            del eng
        torch.cuda.empty_cache()
    del closure_dev

    # the snapshot of the 1 x 1 build (W* freed after it), every pair
    # through label_join_gather, held to the plain join and to closure's
    snap, snap_s = timed_s(keep.snapshot)
    if keep._w_star is not None or tuple(snap.svals.shape) != (h.n, h.m):
        raise AssertionError(f"sharded_path: snapshot "
                             f"{tuple(snap.svals.shape)}, W* kept")
    us, vs = np.divmod(np.arange(h.n * h.n), h.n)
    (got, pairs_s), counts = counted_run(counters, lambda: timed_s(
        lambda: keep.mr_batch(us, vs)))
    expect_counts("sharded_path all pairs", counts,
                  {"label_join": 1, "label_join_gather": 1})
    add_counts(total, counts)
    errs["label_join_gather"] = max(errs["label_join_gather"], held_to_plain(
        "sharded_path all pairs", keep, us, vs, got))
    if not np.array_equal(got, closure_all_pairs(h, closure_w)):
        raise AssertionError("sharded_path: all pairs != the closure engine")
    closure_pairs = got
    bu = torch.from_numpy(us).to(device)
    bv = torch.from_numpy(vs).to(device)
    bound_ms, bound_by, bcounts = label_join_gather_bound(snap.svals, bu, bv)
    # the plain version's [Q, L, L] cube is 645 MB a pair at this L: it
    # is timed on the first PLAIN_PAIRS pairs only, the kernel on all
    pu, pv = bu[:PLAIN_PAIRS], bv[:PLAIN_PAIRS]
    plain = plain_gather_chunked(lj.label_join_gather_ref, snap.ranks,
                                 snap.svals, pu, pv)
    errs["label_join_gather"] = max(errs["label_join_gather"], check_equal(
        "sharded_path closure snapshot, plain version", lj.label_join_gather(
            snap.ranks, snap.svals, pu, pv), plain))
    rows["label_join_gather closure snapshot"] = {
        "shape": [h.n * h.n, h.n, h.m], "route": "warp per row",
        "ms": cuda_ms(lambda: lj.label_join_gather(snap.ranks, snap.svals,
                                                   bu, bv), reps=10),
        "plain_ms": cuda_ms(lambda: plain_gather_chunked(
            lj.label_join_gather_ref, snap.ranks, snap.svals, pu, pv),
            reps=1, warmup=1),
        "plain_pairs": int(pu.numel()),
        "torch_ops_ms": cuda_ms(lambda: torch.cat([
            snap.mr(bu[i:i + 4096], bv[i:i + 4096])
            for i in range(0, bu.numel(), 4096)]), reps=3, warmup=1),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        **bcounts}
    del plain, pu, pv
    out["closure_regime"] = {
        "n": h.n, "m": h.m, "rounds": rounds, "plan_2x2": plan,
        "working_set_bytes": 12 * h.m * h.m,
        "plain_closure_rounds_to_fixpoint": plain_rounds,
        "plain_closure_seconds": plain_s, "builds": builds,
        "snapshot_seconds": snap_s, "snapshot_bytes": snap.nbytes(),
        "pairs": int(us.size), "all_pairs_seconds": pairs_s,
        "answer_histogram": np.bincount(got).tolist()}
    del keep, snap, bu, bv
    torch.cuda.empty_cache()
    rows.update(maxmin_f32_rows(mm, w, first))
    del first, plain_w
    errs["maxmin_matmul"] = max(errs["maxmin_matmul"],
                                *(r["max_abs_err"] for k, r in rows.items()
                                  if k.startswith("[")))
    torch.cuda.empty_cache()

    # 2. the threshold closure on a (1, 2, 2) grid
    mesh3 = api.make_mesh((1, 2, 2), ("pod", "data", "model"))
    from repro_torch.core.semiring import distinct_thresholds
    thr = distinct_thresholds(w)
    (mr3, thr_s), counts = counted_run(counters, lambda: timed_s(
        lambda: dist.sharded_threshold_closure_mr(w, thr, mesh3)))
    expect_counts("sharded_path threshold", counts,
                  {"threshold_step": rounds})
    add_counts(total, counts)
    closure_dev = torch.from_numpy(closure_w).to(device)
    if not torch.equal(mr3.to(torch.int32), closure_dev):
        raise AssertionError("sharded_path: the threshold closure != "
                             "closure_path's W*")
    out["threshold_closure"] = {"grid": [1, 2, 2], "S": int(thr.size),
                                "seconds": thr_s,
                                "threshold_step_launches":
                                    counts["threshold_step"]}
    del mr3, closure_dev, w
    torch.cuda.empty_cache()

    # 3. the mesh overlap route
    (mesh_nbr, nbr_s), counts = counted_run(counters, lambda: timed_s(
        lambda: neighbor_csr(h, mesh=mesh22)))
    expect_counts("sharded_path neighbor_csr", counts, {"overlap": 1})
    add_counts(total, counts)
    host_nbr, host_s = timed_s(lambda: neighbor_csr(h))
    for f in ("ptr", "idx", "od"):
        a, b = getattr(mesh_nbr, f), getattr(host_nbr, f)
        if a.dtype != b.dtype or a.tobytes() != b.tobytes():
            raise AssertionError(f"sharded_path: mesh neighbor_csr.{f} != "
                                 f"the host route's")
    out["mesh_overlaps"] = {"mesh_seconds": nbr_s, "host_seconds": host_s,
                            "entries": int(mesh_nbr.idx.size),
                            "dense_host_bytes": 8 * h.m * h.m}
    del mesh_nbr, host_nbr

    # 4. the label regime on the main path's graph
    mh = main["h"]
    plan = api.plan_backend(mh, mesh=mesh22)
    if plan != "sharded":
        raise AssertionError(f"sharded_path: 89k/70k planned {plan}")
    (eng, build_s), counts = counted_run(counters, lambda: timed_s(
        lambda: api.build_engine(mh, "sharded", mesh=mesh22,
                                 build_labels=True, use_kernels=True)))
    expect_counts("sharded_path label build", counts, {})
    stats = eng._idx.stats
    if not same_index_rows(eng._idx, main["idx"]):
        raise AssertionError("sharded_path: label regime labels != "
                             "main_path's build_fast + minimize")
    if stats["pool_fallback"] != 0:
        raise AssertionError(f"sharded_path: pool_fallback {stats}")
    nbr_entries = int(eng._nbr.idx.size)
    workers = (min(4, os.cpu_count() or 1)
               if nbr_entries >= hl_mod._POOL_MIN_NEIGHBOR_ENTRIES else 0)
    snap, snap_s = timed_s(eng.snapshot)
    if snap.mesh != mesh22 or snap.ranks.shape[1] % 2:
        raise AssertionError(f"sharded_path: label snapshot "
                             f"{tuple(snap.ranks.shape)} on {snap.mesh}")
    mus, mvs = main["pairs"]
    (got, batch_s), counts = counted_run(counters, lambda: timed_s(
        lambda: eng.mr_batch(mus, mvs)))
    expect_counts("sharded_path 2^20 pairs", counts,
                  {"label_join": 1, "label_join_gather": 1})
    add_counts(total, counts)
    errs["label_join_gather"] = max(errs["label_join_gather"], held_to_plain(
        "sharded_path 2^20 pairs", eng, mus, mvs, got))
    if not np.array_equal(got, main["answers"]):
        raise AssertionError("sharded_path: 2^20 answers != main_path's")
    bu = torch.from_numpy(mus).to(device)
    bv = torch.from_numpy(mvs).to(device)
    bound_ms, bound_by, bcounts = label_join_gather_bound(snap.svals, bu, bv)
    rows["label_join_gather label snapshot"] = {
        "shape": [int(mus.size)] + list(snap.ranks.shape),
        "route": "lane groups",
        "ms": cuda_ms(lambda: lj.label_join_gather(snap.ranks, snap.svals,
                                                   bu, bv), reps=30),
        "plain_ms": cuda_ms(lambda: plain_gather_chunked(
            lj.label_join_gather_ref, snap.ranks, snap.svals, bu, bv),
            reps=3, warmup=1),
        "torch_ops_ms": cuda_ms(lambda: snap.mr(bu, bv), reps=10),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        **bcounts}
    out["label_regime"] = {
        "n": mh.n, "m": mh.m, "plan_2x2": plan, "build_seconds": build_s,
        "main_path_build_seconds": main["build_seconds"],
        "shards": stats["shards"], "components": stats["components"],
        "pool_fallback": stats["pool_fallback"], "workers": workers,
        "neighbor_entries": nbr_entries,
        "snapshot_shape": list(snap.ranks.shape), "snapshot_seconds": snap_s,
        "pairs": int(mus.size), "mr_batch_seconds": batch_s,
        "share_nonzero": float((got > 0).mean()),
        "share_two_or_more": float((got >= 2).mean())}
    del eng, snap, bu, bv, got
    torch.cuda.empty_cache()

    # 5. scoped churn, replicas and the store on 4 x ENG-s
    h4 = eng_s_copies(api, SHARDED_COPIES)
    q4 = np.divmod(np.arange(h4.n * h4.n), h4.n)
    churn = {}
    script = [([[0, 1, 2]], []), ([], [0]), ([[0, 5], [2, 3, 4]], [1, 3]),
              ([], list(range(6))), ([[0, 1], [1, 2, 3]], [])]
    for labels in (False, True):
        regime = "labels" if labels else "closure"
        (eng, build_s), counts = counted_run(counters, lambda: timed_s(
            lambda: api.build_engine(h4, "sharded", mesh=mesh22,
                                     build_labels=labels, use_kernels=True)))
        add_counts(total, counts)
        eng.snapshot()
        steps = []
        for ins, dels in script:
            cur = eng.h
            dels = [d for d in dels if d < cur.m]
            (_, upd_s), c1 = counted_run(counters, lambda: timed_s(
                lambda: eng.update(inserts=ins, deletes=dels)))
            dirty = eng.dirty_rows()
            (got, _), c2 = counted_run(counters, lambda: timed_s(
                lambda: eng.mr_batch(*q4)))
            expect_counts(f"sharded_path churn {regime}", c2,
                          {"label_join": 1, "label_join_gather": 1})
            add_counts(total, c1)
            add_counts(total, c2)
            if dirty is None or not 0 < dirty.size < cur.n:
                raise AssertionError(f"sharded_path churn {regime}: dirty "
                                     f"rows {dirty}")
            h2, _, _ = apply_edge_edits(cur, ins, dels)
            fresh = api.build_engine(h2, "sharded", mesh=mesh22,
                                     build_labels=labels, use_kernels=True)
            if not np.array_equal(got, fresh.mr_batch(*q4)):
                raise AssertionError(f"sharded_path churn {regime}: != a "
                                     f"fresh build")
            errs["label_join_gather"] = max(
                errs["label_join_gather"],
                held_to_plain(f"sharded_path churn {regime}", eng,
                              *q4, got))
            steps.append({"update_seconds": upd_s,
                          "dirty_rows": int(dirty.size),
                          "refresh_rows": eng.last_snapshot_refresh_rows,
                          "maxmin_matmul_launches": c1["maxmin_matmul"]})
        churn[regime] = {"build_seconds": build_s, "steps": steps}

        # a ReplicaGroup of 2 through 3 swap batches (delete a hyperedge
        # of copy 0, insert its vertex set again): row patches only
        base_eng = api.build_engine(h4, "sharded", mesh=mesh22,
                                    build_labels=labels, use_kernels=True)
        grp = api.ReplicaGroup(base_eng, 2, mesh=mesh22, start=False,
                               config=api.ServiceConfig(max_batch=4096))
        rng = np.random.default_rng(53)
        for step in range(4):
            cur = grp.engine.h
            pu, pv = inside_pairs(rng, cur, 2048)
            reqs = [api.MRRequest(int(u), int(v)) for u, v in zip(pu, pv)]
            (futs, _), c = counted_run(counters, lambda: (grp.submit_many(reqs),
                                                      grp.drain()))
            add_counts(total, c)
            got = np.array([f.result(timeout=120) for f in futs], np.int64)
            errs["label_join_gather"] = max(
                errs["label_join_gather"],
                held_to_plain(f"sharded_path replicas {regime}",
                              grp.engine, pu, pv, got))
            if step < 3:
                # an edge of copy 0: each swap moves one of its edges to
                # the end of the id space, so ids below m0 - step stay in it
                e = int(rng.integers(0, h4.m // SHARDED_COPIES - step))
                verts = [int(x) for x in cur.edge(e)]
                grp.update(inserts=[verts], deletes=[e])
        rstats = grp.replica_stats()
        if not all(r["full_relands"] == 1 and r["rows_patched"] > 0
                   for r in rstats):
            raise AssertionError(f"sharded_path replicas {regime}: {rstats}")
        reps_out = {"replica_stats": rstats,
                    "mesh_rows_patched": grp.stats().mesh_rows_patched}
        grp.close()
        churn[regime]["replicas"] = reps_out
        del eng, base_eng, grp

    # the three store payloads through IndexStore, restored on the mesh
    root = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
    stored = {}
    try:
        for payload in ("closure", "snapshot", "labels"):
            eng = api.build_engine(h4, "sharded", mesh=mesh22,
                                   build_labels=payload == "labels",
                                   use_kernels=True)
            if payload == "snapshot":
                eng.snapshot()
            store = api.IndexStore(os.path.join(root, payload))
            store.checkpoint(eng)
            manifest = store.manifest()
            ckpt_bytes = os.path.getsize(store.current_checkpoint())
            store.close()
            if manifest["payload"] != payload:
                raise AssertionError(f"sharded_path store: {manifest}")
            store = api.IndexStore(os.path.join(root, payload))
            (restored, restore_s), c = counted_run(counters, lambda: timed_s(
                lambda: store.restore(mesh=mesh22)))
            restored.use_kernels = True
            (got, _), c2 = counted_run(counters, lambda: timed_s(
                lambda: restored.mr_batch(*q4)))
            add_counts(total, c)
            add_counts(total, c2)
            expect_counts(f"sharded_path store {payload}", c2,
                          {"label_join": 1, "label_join_gather": 1})
            errs["label_join_gather"] = max(
                errs["label_join_gather"],
                held_to_plain(f"sharded_path store {payload}", restored,
                              *q4, got))
            if not np.array_equal(got, eng.mr_batch(*q4)):
                raise AssertionError(f"sharded_path store {payload}: "
                                     f"restored != live")
            store.close()
            stored[payload] = {"restore_seconds": restore_s,
                               "checkpoint_bytes": ckpt_bytes}
            del eng, restored
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["eng_s_copies"] = {"n": h4.n, "m": h4.m, "churn": churn,
                           "store": stored}

    out["launches"] = {k: v for k, v in total.items() if v}
    out["max_abs_err"] = errs
    out["kernels"] = rows
    out["seconds"] = clock.seconds()
    emit(out)
    return total, errs, rows, {"h": h, "w": w_host, "w_star": w_star22,
                               "all_pairs": closure_pairs}


# -- the sharded closure on ranks ---------------------------------------------


class ExchangeClock:
    """Host seconds, calls and bytes received of the collectives a rank
    runs (``core/collectives.py``'s transfers, wrapped in place): the card
    is synchronised before each, so a transfer's time is its own (the
    gloo route stages through the host and waits for the card anyway)."""

    def __init__(self, coll, on_card):
        self.on_card = on_card
        self.reset()
        for name, received in (("gather_over", self._gathered),
                               ("shift_over", self._whole),
                               ("max_over", self._whole),
                               ("min_over", self._whole)):
            setattr(coll, name, self._timed(getattr(coll, name), received))

    def reset(self):
        self.seconds, self.calls, self.bytes = 0.0, 0, 0

    @staticmethod
    def _gathered(args, out):
        n = args[2]
        return out.numel() * out.element_size() * (n - 1) // n

    @staticmethod
    def _whole(args, out):
        return out.numel() * out.element_size()

    def _timed(self, fn, received):
        def timed(*args, **kw):
            if self.on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if self.on_card:
                torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            self.bytes += received(args, out)
            return out
        return timed


def rank_measured(fn, clock, mm, device, rounds=None):
    """(``fn()``, its seconds, exchange seconds / calls / bytes, bytes a
    round, ``maxmin_matmul`` launches and peak device memory above the
    start) on one rank."""
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    clock.reset()
    before = mm.LAUNCHES
    t0 = time.perf_counter()
    out = fn()
    if on_card:
        torch.cuda.synchronize()
    part = {"seconds": time.perf_counter() - t0,
            "exchange_seconds": clock.seconds,
            "exchange_calls": clock.calls,
            "exchange_bytes": clock.bytes,
            "maxmin_matmul_launches": mm.LAUNCHES - before,
            "peak_rise_bytes": (torch.cuda.max_memory_allocated() - base
                                if on_card else None)}
    if rounds:
        part["rounds"] = rounds
        part["exchange_bytes_a_round"] = clock.bytes // rounds
    return out, part


def rank_gradients(rank, cfg, device):
    """Rank ``rank``'s seeded gradient of one ``cfg`` layer's MLP: the
    gate, up and down weights' shapes, float32."""
    gen = torch.Generator(device=device).manual_seed(1000 + rank)
    shapes = {"gate": (cfg.d_model, cfg.d_ff), "up": (cfg.d_model, cfg.d_ff),
              "down": (cfg.d_ff, cfg.d_model)}
    return {k: torch.randn(s, generator=gen, device=device) * 1e-3
            for k, s in shapes.items()}


def rank_nccl_check(api, coll, mm, lj, h, pairs, work, device):
    """One rank in a one-rank NCCL group: the three transfers of
    ``core/collectives.py`` on the group itself (each the identity on one
    rank), then the closure and one ``mr_batch`` on a 1 x 1 mesh."""
    import torch.distributed as tdist
    tdist.init_process_group("nccl", init_method="file://" + os.path.join(
        work, "init-nccl"), rank=0, world_size=1)
    try:
        pm = api.make_process_mesh((1, 1), ("data", "model"))
        t = torch.arange(24.0, device=device).reshape(4, 6)
        moved = {"all_gather": coll.gather_over(t, None, 1, dim=1),
                 "ring": coll.shift_over(t, None, 0, 0),
                 "all_reduce_max": coll.max_over(t, None)}
        for name, got in moved.items():
            if not torch.equal(got, t):
                raise AssertionError(f"rank_path nccl {name}: not the "
                                     f"identity on one rank")
        before, gathers = mm.LAUNCHES, lj.GATHER_LAUNCHES
        eng, build_s = timed_s(lambda: api.build_engine(
            h, "sharded", mesh=pm, use_kernels=True))
        got = eng.mr_batch(pairs["us"], pairs["vs"])
        if not np.array_equal(got, pairs["want"]):
            raise AssertionError("rank_path nccl: answers != the closure's")
        return {"backend": pm.backend, "device": str(pm.device),
                "transfers": sorted(moved), "build_seconds": build_s,
                "maxmin_matmul_launches": mm.LAUNCHES - before,
                "label_join_gather_launches": lj.GATHER_LAUNCHES - gathers}
    finally:
        tdist.destroy_process_group()


def rank_worker(rank, world, work, spec):
    """One rank of ``rank_path`` (a spawned process; the kernels are built
    already and only loaded): the closure on a 2 x 2 ``ProcessMesh`` under
    both schedules (``allgather`` through ``build_engine``, which then
    answers the seeded pairs through ``label_join_gather``; ``ring``
    through ``sharded_maxmin_closure``), each block held to the logical
    W*; the threshold closure on 1 x 2 x 2 against the logical route under
    the same cap; ``compressed_allreduce`` of its gradient against the
    one-process version; rank 0 then the one-rank NCCL check.  Writes
    ``rank<r>.json`` (and its answers) into ``work``."""
    import datetime
    import torch.distributed as tdist
    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.core import collectives as coll
    from repro_torch.core import distributed as dist
    from repro_torch.distributed_lm import compressed_allreduce
    from repro_torch.kernels import label_join as lj
    from repro_torch.kernels import maxmin_matmul as mm

    device = torch.device(spec["device"])
    on_card = device.type == "cuda"
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clock = ExchangeClock(coll, on_card)
    g = spec["graph"]
    h = api.random_hypergraph(g["n"], g["m"], min_size=g["min_size"],
                              max_size=g["max_size"], seed=g["seed"])
    w = np.load(os.path.join(work, "w.npy"), mmap_mode="r")
    w_star = np.load(os.path.join(work, "w_star.npy"), mmap_mode="r")
    pairs = dict(np.load(os.path.join(work, "pairs.npz")))
    axes = ("data", "model")
    out = {"rank": rank}
    tdist.init_process_group(
        "gloo", init_method="file://" + os.path.join(work, "init"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=spec["timeout"]))
    try:
        # device=None: cuda:0 under gloo (every rank on the one card)
        pm = api.make_process_mesh(RANK_GRID, axes,
                                   device=None if on_card else "cpu")
        out.update(coords=list(pm.coords), device=str(pm.device),
                   backend=pm.backend)
        rounds = rank_rounds(h.m)

        # allgather, built through build_engine: the resident block
        eng, part = rank_measured(lambda: api.build_engine(
            h, "sharded", mesh=pm, schedule="allgather", use_kernels=True),
            clock, mm, device, rounds)
        want = dist.block_of(w_star, pm, axes)
        part.update(
            block_shape=list(eng._w_star.shape),
            resident_block_bytes=eng._w_star.numel()
            * eng._w_star.element_size(),
            rank_nbytes=eng.rank_nbytes(), nbytes=eng.nbytes(),
            max_abs_err=check_equal(f"rank {rank} allgather block",
                                    eng._w_star, want))
        out["allgather"] = part

        # the replicated snapshot, and the seeded pairs through it
        snap, part = rank_measured(eng.snapshot, clock, mm, device)
        part["shape"] = list(snap.svals.shape)
        out["snapshot"] = part
        gathers, joins = lj.GATHER_LAUNCHES, lj.LAUNCHES
        got, join_s = timed_s(lambda: eng.mr_batch(pairs["us"], pairs["vs"]))
        out["join"] = {
            "pairs": int(got.size), "seconds": join_s,
            "label_join_gather_launches": lj.GATHER_LAUNCHES - gathers,
            "label_join_launches": lj.LAUNCHES - joins,
            "max_abs_err": held_to_plain(f"rank {rank} join", eng,
                                         pairs["us"], pairs["vs"], got),
            "equal_to_the_closure": bool(np.array_equal(got,
                                                        pairs["want"]))}
        np.save(os.path.join(work, f"answers{rank}.npy"), got)
        del eng, snap

        # ring, through sharded_maxmin_closure on the host W
        blk, part = rank_measured(lambda: dist.sharded_maxmin_closure(
            w, pm, schedule="ring", trim=False, use_kernels=True),
            clock, mm, device, rounds)
        part["max_abs_err"] = check_equal(f"rank {rank} ring block", blk,
                                          want)
        out["ring"] = part
        del blk, want

        # the threshold closure on 1 x 2 x 2, capped as the logical run
        taxes = ("pod", "data", "model")
        pm3 = api.make_process_mesh((1,) + RANK_GRID, taxes,
                                    device=None if on_card else "cpu")
        thr = np.load(os.path.join(work, "thr.npy"))
        blk, part = rank_measured(lambda: dist.sharded_threshold_closure_mr(
            w, thr, pm3, rounds=spec["threshold_rounds"]), clock, mm, device,
            spec["threshold_rounds"])
        logical = np.load(os.path.join(work, "thr_mr.npy"), mmap_mode="r")
        part.update(S=int(thr.size), max_abs_err=check_equal(
            f"rank {rank} threshold block", blk,
            dist.block_of(logical, pm3, taxes[1:])))
        out["threshold"] = part
        del blk

        # compressed_allreduce of this rank's gradient over data = 4
        pmd = api.make_process_mesh((RANK_WORLD, 1), axes,
                                    device=None if on_card else "cpu")
        cfg = get_config(LM_ARCH)
        mine = rank_gradients(rank, cfg, device)
        mean, part = rank_measured(lambda: compressed_allreduce(
            {k: v[None] for k, v in mine.items()}, pmd, "data"),
            clock, mm, device)
        stacked = {k: torch.stack([rank_gradients(r, cfg, device)[k]
                                   for r in range(world)])
                   for k in mine}
        one = compressed_allreduce(stacked, api.make_mesh(
            (RANK_WORLD, 1), axes, device=device), "data")
        part.update(
            elements=sum(v.numel() for v in mine.values()),
            bit_equal=all(torch.equal(mean[k], one[k]) for k in mine))
        out["compression"] = part
        del stacked, one, mean, mine
    finally:
        tdist.destroy_process_group()
    if rank == 0 and spec["nccl"]:
        out["nccl"] = rank_nccl_check(api, coll, mm, lj, h, pairs, work,
                                      device)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def rank_rounds(m):
    """The closure ladder's length over ``m`` padded for ``RANK_GRID``."""
    from repro_torch.kernels.ops import default_rounds
    lcm = math.lcm(*RANK_GRID)
    return default_rounds(-(-m // lcm) * lcm)


def run_ranks(work, spec, worker=None):
    """``RANK_WORLD`` spawned ranks of ``worker`` (``rank_worker`` by
    default); fails as soon as one exits with an error, or when the limit
    passes, and kills the others either way.  Returns their reports."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    target = worker or rank_worker
    procs = [ctx.Process(target=target, name=f"rank{r}",
                         args=(r, RANK_WORLD, work, spec))
             for r in range(RANK_WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + spec["timeout"]
    try:
        while True:
            codes = [p.exitcode for p in procs]
            if any(c not in (None, 0) for c in codes):
                raise AssertionError(f"{target.__name__}: a rank failed, "
                                     f"exit codes {codes}")
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"{target.__name__}: ranks not done in "
                                     f"{spec['timeout']} s ({codes})")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    reports = []
    for r in range(RANK_WORLD):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def phase_rank_path(api, dist, counters, inputs, device):
    """The ``sharded`` closure on real ranks: ``RANK_WORLD`` gloo processes
    share the card, one block each of a 2 x 2 ``ProcessMesh`` over
    ``sharded_path``'s primary-school W.  Each rank builds the closure
    (``allgather`` through ``build_engine``: 14 ``maxmin_matmul``
    launches; ``ring``: 28), its block held to the logical 2 x 2 W*;
    answers ``RANK_PAIRS`` seeded pairs through ``label_join_gather`` off
    the replicated snapshot (held to the plain join and to the closure's
    answers, equal on every rank); runs the threshold closure on 1 x 2 x 2
    (held to the logical route under the same cap) and
    ``compressed_allreduce`` of an ``LM_ARCH`` layer's MLP gradient
    (bit-equal to the one-process version); then rank 0 runs the closure
    in a one-rank NCCL group.  Returns (launches per kernel, max abs err
    per kernel)."""
    from repro_torch.core.semiring import distinct_thresholds
    clock = Phase()
    h, w = inputs["h"], inputs["w"]
    g = CLOSURE_GRAPH
    out = {"phase": "rank_path", "world": RANK_WORLD, "backend": "gloo",
           "grid": list(RANK_GRID), "n": h.n, "m": h.m,
           "nccl_between_cards": "not run: one card"}
    total = {}
    work = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    try:
        np.save(os.path.join(work, "w.npy"), w)
        np.save(os.path.join(work, "w_star.npy"), inputs["w_star"])
        rng = np.random.default_rng(67)
        us = rng.integers(0, h.n, RANK_PAIRS)
        vs = rng.integers(0, h.n, RANK_PAIRS)
        np.savez(os.path.join(work, "pairs.npz"), us=us, vs=vs,
                 want=inputs["all_pairs"][us * h.n + vs])
        # the logical route under the ranks' cap, on the card
        thr = distinct_thresholds(w)
        mesh3 = api.make_mesh((1,) + RANK_GRID, ("pod", "data", "model"))
        w_dev = torch.from_numpy(w).to(device)
        (mr3, thr_s), counts = counted_run(counters, lambda: timed_s(
            lambda: dist.sharded_threshold_closure_mr(
                w_dev, thr, mesh3, rounds=RANK_THRESHOLD_ROUNDS)))
        expect_counts("rank_path logical threshold", counts,
                      {"threshold_step": RANK_THRESHOLD_ROUNDS})
        add_counts(total, counts)
        np.save(os.path.join(work, "thr.npy"), thr)
        np.save(os.path.join(work, "thr_mr.npy"), dist.pad_for_mesh(
            mr3.cpu().numpy(), mesh3, ("data", "model")))
        del w_dev, mr3
        torch.cuda.empty_cache()
        spec = {"device": device.type, "graph": g, "timeout": RANK_TIMEOUT_S,
                "threshold_rounds": RANK_THRESHOLD_ROUNDS,
                "nccl": device.type == "cuda"}
        reports, ranks_s = timed_s(lambda: run_ranks(work, spec))
        answers = [np.load(os.path.join(work, f"answers{r}.npy"))
                   for r in range(RANK_WORLD)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rounds = rank_rounds(h.m)
    errs = {"maxmin_matmul": 0, "label_join_gather": 0,
            "threshold_closure_on_ranks": 0}
    for rep in reports:
        r = rep["rank"]
        expect_counts(f"rank_path rank {r} allgather",
                      {"maxmin_matmul": rep["allgather"][
                          "maxmin_matmul_launches"]},
                      {"maxmin_matmul": rounds})
        expect_counts(f"rank_path rank {r} ring",
                      {"maxmin_matmul": rep["ring"]["maxmin_matmul_launches"]},
                      {"maxmin_matmul": rounds * RANK_GRID[0]})
        join = rep["join"]
        expect_counts(f"rank_path rank {r} join",
                      {"label_join": join["label_join_launches"],
                       "label_join_gather": join[
                           "label_join_gather_launches"]},
                      {"label_join": 1, "label_join_gather": 1})
        if not (join["equal_to_the_closure"]
                and np.array_equal(answers[r], answers[0])):
            raise AssertionError(f"rank_path rank {r}: answers differ")
        if not rep["compression"]["bit_equal"]:
            raise AssertionError(f"rank_path rank {r}: compressed_allreduce"
                                 f" != the one-process version")
        mp = -(-h.m // math.lcm(*RANK_GRID)) * math.lcm(*RANK_GRID)
        if rep["allgather"]["resident_block_bytes"] != 4 * mp * mp // 4:
            raise AssertionError(f"rank_path rank {r}: block "
                                 f"{rep['allgather']['block_shape']}")
        add_counts(total, {"maxmin_matmul": rep["allgather"][
            "maxmin_matmul_launches"] + rep["ring"]["maxmin_matmul_launches"],
            "label_join": join["label_join_launches"],
            "label_join_gather": join["label_join_gather_launches"]})
        errs["maxmin_matmul"] = max(errs["maxmin_matmul"],
                                    rep["allgather"]["max_abs_err"],
                                    rep["ring"]["max_abs_err"])
        errs["label_join_gather"] = max(errs["label_join_gather"],
                                        join["max_abs_err"])
        errs["threshold_closure_on_ranks"] = max(
            errs["threshold_closure_on_ranks"],
            rep["threshold"]["max_abs_err"])
    nccl = reports[0].get("nccl")
    if spec["nccl"]:
        if nccl is None or nccl["backend"] != "nccl":
            raise AssertionError(f"rank_path: the NCCL check did not run: "
                                 f"{nccl}")
        expect_counts("rank_path nccl", {
            "maxmin_matmul": nccl["maxmin_matmul_launches"],
            "label_join_gather": nccl["label_join_gather_launches"]},
            {"maxmin_matmul": rounds, "label_join_gather": 1})
        add_counts(total, {"maxmin_matmul": nccl["maxmin_matmul_launches"],
                           "label_join": nccl["label_join_gather_launches"],
                           "label_join_gather": nccl[
                               "label_join_gather_launches"]})
    out.update(rounds=rounds, logical_threshold_seconds=thr_s,
               ranks_seconds=ranks_s, ranks=reports, launches=total,
               max_abs_err=errs, answers_equal_across_ranks=True)
    out["seconds"] = clock.seconds()
    emit(out)
    return total, errs


# -- the label regime, the overlap route and updates on ranks ----------------


def index_digest(idx):
    """SHA-256 of an ``HLIndex``: rank, perm, and every label and dual
    field as its row lengths and the concatenation of its rows."""
    import hashlib
    d = hashlib.sha256()
    d.update(np.ascontiguousarray(idx.rank).tobytes())
    d.update(np.ascontiguousarray(idx.perm).tobytes())
    for f in ("labels_edge", "labels_rank", "labels_s", "dual_u", "dual_s"):
        rows = getattr(idx, f)
        d.update(np.fromiter((x.size for x in rows), np.int64,
                             len(rows)).tobytes())
        flat = np.concatenate(rows) if len(rows) else np.empty(0, np.int64)
        d.update(str(flat.dtype).encode() + flat.tobytes())
    return d.hexdigest()


class CallClock:
    """Host seconds of every call of ``module.name`` (wrapped in place)."""

    def __init__(self, module, name):
        self.seconds, self.calls = 0.0, 0
        fn = getattr(module, name)

        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.seconds += time.perf_counter() - t0
                self.calls += 1
        setattr(module, name, timed)


def full_snapshot_join(api, idx, us, vs, device):
    """The plain join (``batched_mr``, 4,096 pairs a call) on the whole
    label snapshot of ``idx`` on ``device``: what every rank's block
    answers must equal."""
    full = api.DeviceSnapshot.from_hlindex(idx, "sharded", device=device)
    bu = torch.from_numpy(np.asarray(us, np.int64)).to(device)
    bv = torch.from_numpy(np.asarray(vs, np.int64)).to(device)
    return torch.cat([full.mr(bu[i:i + 4096], bv[i:i + 4096])
                      for i in range(0, bu.numel(), 4096)])


def rank_label_batch(tag, eng, api, lj, clock, us, vs, device):
    """One ``mr_batch`` on the label blocks: its seconds, the row
    assembly's exchange, the launches, held to the plain join on the
    rank's whole snapshot."""
    clock.reset()
    joins, gathers = lj.LAUNCHES, lj.GATHER_LAUNCHES
    got, seconds = timed_s(lambda: eng.mr_batch(us, vs))
    part = {"pairs": int(got.size), "seconds": seconds,
            "exchange_seconds": clock.seconds,
            "exchange_calls": clock.calls, "exchange_bytes": clock.bytes,
            "label_join_launches": (lj.LAUNCHES - joins)
            - (lj.GATHER_LAUNCHES - gathers),
            "label_join_gather_launches": lj.GATHER_LAUNCHES - gathers,
            "share_nonzero": float((got > 0).mean())}
    part["max_abs_err"] = check_equal(tag, torch.from_numpy(
        got.astype(np.int32)).to(device),
        full_snapshot_join(api, eng._idx, us, vs, device))
    return got, part


def rank_churn_script(h):
    """ENG-s's churn: inserts over fresh vertices (one component each,
    so each update re-closes a scope of one or two hyperedges), the first
    two past the free slots, then a delete and an insert into its slot."""
    n, m = h.n, h.m
    return [("insert", [[n, n + 1, n + 2]], []),
            ("insert two", [[n + 3, n + 4], [n + 5, n + 6, n + 7]], []),
            ("delete", [], [m]),
            ("insert into the freed slot", [[n + 8, n + 9]], [])]


def rank_label_worker(rank, world, work, spec):
    """One rank of ``rank_label_path`` (a spawned process).  On a 2 x 2
    ``ProcessMesh``: the label regime of ``sharded`` on 89k/70k
    (``build_sharded`` across the ranks, labels held to ``main_path``'s
    by digest; the block snapshot; ``RANK_LABEL_PAIRS`` pairs through the
    row assembly and ``label_join``; one update over fresh vertices, then
    the pairs again); ``neighbor_csr`` on primary-school by the rank
    overlap route (one ``overlap_rows`` launch a rank), equal to the host
    pass; a closure-regime churn on ENG-s, each W* block held to a logical
    engine's after the same edits.  Writes ``rank<r>.json``; rank 0 also
    the first batch's gathered rows.  Then, on the label engine, rank 0
    leads and ranks 1-3 follow a threaded service, a ``ReplicaGroup``, a
    checkpoint with a journaled update and a restore
    (``rank_serve_steps``); and the churned ENG-s closure is saved and
    loaded on the ranks (``rank_closure_store``)."""
    import datetime
    import torch.distributed as tdist
    from repro_torch import api
    from repro_torch.core import collectives as coll
    from repro_torch.core import distributed as dist
    from repro_torch.core import hlindex as hl
    from repro_torch.core.hypergraph import neighbor_csr
    from repro_torch.kernels import label_join as lj
    from repro_torch.kernels import maxmin_matmul as mm
    from repro_torch.kernels import overlap as ov

    device = torch.device(spec["device"])
    on_card = device.type == "cuda"
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clock = ExchangeClock(coll, on_card)
    shards = CallClock(hl, "_shard_worker")
    neighbors = CallClock(dist, "neighbor_csr")
    axes = ("data", "model")
    out = {"rank": rank}
    tdist.init_process_group(
        "gloo", init_method="file://" + os.path.join(work, "init"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=spec["timeout"]))
    try:
        pm = api.make_process_mesh(RANK_GRID, axes,
                                   device=None if on_card else "cpu")
        out.update(coords=list(pm.coords), device=str(pm.device))

        # 1. the label regime on 89k/70k
        g = spec["main_graph"]
        h, graph_s = timed_s(lambda: api.random_hypergraph(
            g["n"], g["m"], min_size=g["min_size"], max_size=g["max_size"],
            seed=g["seed"]))
        clock.reset()
        eng, build_s = timed_s(lambda: api.build_engine(
            h, "sharded", mesh=pm, build_labels=True, use_kernels=True))
        stats = eng._idx.stats
        out["build"] = {
            "graph_seconds": graph_s, "seconds": build_s,
            "neighbor_seconds": neighbors.seconds,
            "shard_seconds": shards.seconds, "shards_run": shards.calls,
            "exchange_seconds": clock.seconds,
            "exchange_calls": clock.calls, "exchange_bytes": clock.bytes,
            # the importance order, shard plan, subgraphs and the merge
            "rest_seconds": build_s - neighbors.seconds - shards.seconds
            - clock.seconds,
            "shards": stats["shards"], "components": stats["components"],
            "pool_fallback": stats["pool_fallback"],
            "labels_equal_main_path":
                index_digest(eng._idx) == spec["main_digest"]}
        clock.reset()
        snap, snap_s = timed_s(eng.snapshot)
        out["snapshot"] = {
            "seconds": snap_s, "block_shape": list(snap.ranks.shape),
            "whole_shape": list(snap.whole_shape),
            "rank_bytes": snap.rank_nbytes(), "whole_bytes": snap.nbytes(),
            "exchange_calls": clock.calls}
        rng = np.random.default_rng(71)
        us, vs = inside_pairs(rng, h, RANK_LABEL_PAIRS)
        got, out["batch"] = rank_label_batch(f"rank {rank} label batch",
                                             eng, api, lj, clock, us, vs,
                                             device)
        np.save(os.path.join(work, f"answers{rank}.npy"), got)
        # the rows the batch joined, and the rows entry against its plain
        # version on them (all ranks take part in the row assembly)
        bu = torch.from_numpy(us).to(device)
        bv = torch.from_numpy(vs).to(device)
        rows = snap.gather_query_rows(bu, bv)
        out["batch"]["rows_max_abs_err"] = check_equal(
            f"rank {rank} label_join rows", lj.label_join(*rows),
            lj.label_join_ref(*rows))
        if rank == 0:
            np.savez(os.path.join(work, "rows.npz"),
                     **{k: t.cpu().numpy() for k, t in zip(
                         ("ru", "su", "rv", "sv"), rows)})
        del rows, bu, bv, snap

        # one update over fresh vertices, then the pairs again (two of
        # them on the new hyperedge)
        fresh = [h.n, h.n + 1, h.n + 2]
        clock.reset()
        _, update_s = timed_s(lambda: eng.update(inserts=[fresh]))
        dirty = eng.dirty_rows()
        snap, snap_s = timed_s(eng.snapshot)
        us2 = np.concatenate([us, [fresh[0], fresh[1]]])
        vs2 = np.concatenate([vs, [fresh[2], 0]])
        got2, batch = rank_label_batch(f"rank {rank} label batch after the "
                                       f"update", eng, api, lj, clock,
                                       us2, vs2, device)
        if got2[-2] != len(fresh) or not np.array_equal(got2[:-2], got):
            raise AssertionError(f"rank {rank}: answers after the update "
                                 f"{got2[-2:]}")
        out["update"] = {
            "seconds": update_s, "exchange_calls_update": clock.calls,
            "dirty_rows": None if dirty is None else int(dirty.size),
            "refresh_rows": eng.last_snapshot_refresh_rows,
            "snapshot_seconds": snap_s,
            "whole_shape": list(snap.whole_shape),
            "block_shape": list(snap.ranks.shape), "batch": batch}
        del snap
        # serving and the store on the ranks over this engine
        out["serve"] = rank_serve_steps(api, lj, clock, eng, pm, work,
                                        us2, vs2, got2)
        del eng

        # 2. the rank overlap route on primary-school
        c = spec["closure_graph"]
        hp = api.random_hypergraph(c["n"], c["m"], min_size=c["min_size"],
                                   max_size=c["max_size"], seed=c["seed"])
        before = ov.ROWS_LAUNCHES
        clock.reset()
        nbr, nbr_s = timed_s(lambda: neighbor_csr(hp, mesh=pm))
        host, host_s = timed_s(lambda: neighbor_csr(hp))
        equal = all(getattr(nbr, f).dtype == getattr(host, f).dtype
                    and getattr(nbr, f).tobytes() == getattr(host, f).tobytes()
                    for f in ("ptr", "idx", "od"))
        if not equal:
            raise AssertionError(f"rank {rank}: neighbor_csr on ranks != "
                                 f"the host pass")
        out["overlap_route"] = {
            "seconds": nbr_s, "host_seconds": host_s,
            "overlap_rows_launches": ov.ROWS_LAUNCHES - before,
            "exchange_seconds": clock.seconds,
            "exchange_bytes": clock.bytes, "entries": int(nbr.idx.size),
            "rows": -(-hp.m // world), "equal_to_host": equal}
        del nbr, host

        # 3. closure-regime churn on ENG-s, blocks held to a logical engine
        e = spec["small_graph"]
        hs = api.random_hypergraph(e["n"], e["m"], min_size=e["min_size"],
                                   max_size=e["max_size"], seed=e["seed"])
        before = mm.LAUNCHES
        eng = api.build_engine(hs, "sharded", mesh=pm, use_kernels=True)
        build_launches = mm.LAUNCHES - before
        m_padded_built = eng._m_padded
        logical = api.build_engine(hs, "sharded", mesh=api.make_mesh(
            RANK_GRID, axes, device=device), use_kernels=True)
        steps = []
        for name, ins, dels in rank_churn_script(hs):
            clock.reset()
            before = mm.LAUNCHES
            _, upd_s = timed_s(lambda: eng.update(inserts=ins,
                                                  deletes=dels))
            launches = mm.LAUNCHES - before
            step = {"name": name, "seconds": upd_s, "m": eng.h.m,
                    "m_padded": eng._m_padded,
                    "block_shape": list(eng._w_star.shape),
                    "regrid_bytes": eng.last_regrid_bytes,
                    "exchange_bytes": clock.bytes,
                    "maxmin_matmul_launches": launches}
            logical.update(inserts=ins, deletes=dels)
            step["max_abs_err"] = check_equal(
                f"rank {rank} churn {name}", eng._w_star,
                dist.block_of(logical._w_star, pm, axes))
            steps.append(step)
        # the resident closure saved and loaded on the ranks
        store, loaded = rank_closure_store(api, dist, coll, eng, logical,
                                           pm, work, rank)
        us3, vs3 = np.divmod(np.arange(eng.h.n ** 2), eng.h.n)
        joins = lj.GATHER_LAUNCHES
        got3 = eng.mr_batch(us3, vs3)
        joins = lj.GATHER_LAUNCHES - joins
        if not np.array_equal(got3, logical.mr_batch(us3, vs3)):
            raise AssertionError(f"rank {rank}: churned answers != the "
                                 f"logical engine's")
        if not np.array_equal(loaded.mr_batch(us3, vs3), got3):
            raise AssertionError(f"rank {rank}: the loaded closure's "
                                 f"answers != the saved engine's")
        out["churn"] = {"build_maxmin_matmul_launches": build_launches,
                        "m_padded_built": m_padded_built, "steps": steps,
                        "pairs": int(got3.size),
                        "label_join_gather_launches": joins,
                        "store": store}
    finally:
        tdist.destroy_process_group()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def rank_serve_config(api, **kw):
    return api.ServiceConfig(
        max_batch=RANK_SERVE_BATCH, use_kernels=True,
        tenants=tuple(api.TenantSpec(t, w) for t, w in RANK_SERVE_TENANTS),
        **kw)


def rank_serve_requests(api, rng, us, vs, got):
    """``RANK_SERVE_MR`` MR and ``RANK_SERVE_SREACH`` s-reach requests on
    pairs already answered (``got``), alternating tenants, shuffled; with
    the answers they must get."""
    tenants = [t for t, _ in RANK_SERVE_TENANTS]
    reqs, want = [], []
    for k, i in enumerate(rng.choice(len(us), RANK_SERVE_MR, replace=False)):
        reqs.append(api.MRRequest(int(us[i]), int(vs[i]),
                                  tenant=tenants[k % 2]))
        want.append(int(got[i]))
    pick = rng.choice(len(us), RANK_SERVE_SREACH, replace=False)
    for k, (i, s) in enumerate(zip(pick, rng.integers(1, 9, pick.size))):
        reqs.append(api.SReachRequest(int(us[i]), int(vs[i]), int(s),
                                      tenant=tenants[k % 2]))
        want.append(bool(got[i] >= s))
    order = rng.permutation(len(reqs))
    return [reqs[i] for i in order], [want[i] for i in order]


def lead_or_follow(svc, lead):
    """Rank 0 runs ``lead(svc)`` and closes the service (also when it
    raises, so no follower waits); the others follow to the close."""
    if not svc.leader:
        svc.follow()
        return {}
    try:
        return lead(svc)
    finally:
        svc.close()


def served(svc, reqs, want, tag):
    """Submit ``reqs`` to a threaded leader, each stamped at submit and at
    its answer; fails unless the answers are ``want``.  Returns seconds,
    requests/s, p50 / p99 ms per request."""
    n = len(reqs)
    sent, done = np.zeros(n), np.zeros(n)

    def stamp(i):
        return lambda req, fut: done.__setitem__(i, time.perf_counter())
    t0 = time.perf_counter()
    futs = []
    for i, r in enumerate(reqs):
        sent[i] = time.perf_counter()
        futs.append(svc.submit(r, on_result=stamp(i)))
    got = [f.result(timeout=RANK_LABEL_TIMEOUT_S) for f in futs]
    seconds = time.perf_counter() - t0
    while not done.all():                # the callbacks run just after
        time.sleep(1e-3)
    if got != want:
        bad = sum(a != b for a, b in zip(got, want))
        raise AssertionError(f"{tag}: {bad} of {n} answers differ")
    lat = (done - sent) * 1e3
    return {"requests": n, "seconds": seconds, "requests_per_s": n / seconds,
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99))}


def service_counts(svc, lj, clock, joins, gathers):
    """What a rank counted of one service: its stats, the stream's events,
    seconds and bytes, the row assembly's exchange, and its launches."""
    st = svc.stats().as_dict()
    return {"stats": st, "events": dict(svc._stream.by_kind),
            "stream_seconds": svc._stream.seconds,
            "stream_bytes": svc._stream.bytes,
            "exchange_seconds": clock.seconds, "exchange_calls": clock.calls,
            "exchange_bytes": clock.bytes,
            "label_join_launches": (lj.LAUNCHES - joins)
            - (lj.GATHER_LAUNCHES - gathers),
            "label_join_gather_launches": lj.GATHER_LAUNCHES - gathers,
            "failed_events": svc.failed_events}


def rank_serve_steps(api, lj, clock, eng, pm, work, us, vs, got):
    """Serving on the ranks over the label-regime engine (rank 0 leads):
    a threaded service (requests, one update through the stream, requests
    on its vertices), a ``ReplicaGroup`` of ``RANK_REPLICAS``, a
    checkpoint with one journaled update, and a restore to its first
    answers.  Every answer is held to ``got`` (the engine's own batch
    answers) or to the fresh vertices' MR; returns what this rank
    measured."""
    from repro_torch.store import format as fmt
    from repro_torch.store import wal as walmod

    rng = np.random.default_rng(73)
    reqs, want = rank_serve_requests(api, rng, us, vs, got)
    out = {}

    def fresh_requests(a):
        return [api.MRRequest(a, a + 1), api.MRRequest(a + 2, 0)], [3, 0]

    # 1. the threaded service
    clock.reset()
    joins, gathers = lj.LAUNCHES, lj.GATHER_LAUNCHES
    svc = api.serve(eng, config=rank_serve_config(api), start=True)

    def lead(s):
        part = {"load": served(s, reqs, want, "rank service")}
        a = eng.h.n
        t0 = time.perf_counter()
        s.update(inserts=[[a, a + 1, a + 2]])
        update_s = time.perf_counter() - t0
        q, w = fresh_requests(a)
        futs = [s.submit(r) for r in q]
        first = futs[0].result(timeout=RANK_LABEL_TIMEOUT_S)
        part["update"] = {"seconds": update_s,
                          "to_first_answer_s": time.perf_counter() - t0}
        if [first, futs[1].result(timeout=60)] != w:
            raise AssertionError("rank service: the fresh vertices' MR")
        return part
    out["service"] = dict(lead_or_follow(svc, lead),
                          **service_counts(svc, lj, clock, joins, gathers),
                          keepalive_s=svc.keepalive_s)

    # 2. a ReplicaGroup: a batch, one update over the first fresh
    # vertices (n unchanged: rows patched in place), a batch
    clock.reset()
    joins, gathers = lj.LAUNCHES, lj.GATHER_LAUNCHES
    grp = api.serve(eng, config=rank_serve_config(api,
                                                  replicas=RANK_REPLICAS),
                    start=False)
    a = int(us[-2])                     # the first update's fresh vertex

    def replicated(g):
        k = RANK_REPLICA_REQUESTS
        futs = g.submit_many([api.MRRequest(int(x), int(y))
                              for x, y in zip(us[:k], vs[:k])])
        g.drain()
        g.update(inserts=[[a, a + 1]])
        futs += g.submit_many([api.MRRequest(a, a + 1)])
        g.drain()
        if [f.result(timeout=60) for f in futs] != list(got[:k]) + [3]:
            raise AssertionError("replica group: answers differ")
        return {}
    lead_or_follow(grp, replicated)
    copies = grp.replicas
    out["replicas"] = dict(
        service_counts(grp, lj, clock, joins, gathers),
        replica_stats=grp.replica_stats(),
        copies_equal=all(torch.equal(getattr(r.snap, f),
                                     getattr(copies[0].snap, f))
                         for r in copies for f in ("ranks", "svals",
                                                   "lengths")),
        private=len({r.snap.ranks.data_ptr() for r in copies}
                    | {eng.snapshot_cache().ranks.data_ptr()})
        == len(copies) + 1)
    del grp, copies

    # 3. a checkpoint through the stream, one journaled update, then a
    # restore on every rank to its first answers
    root = os.path.join(work, "store")
    writes = CallClock(fmt, "_write_store_file")
    appends = CallClock(walmod.WriteAheadLog, "append")
    k = RANK_SERVE_BATCH
    check = [api.MRRequest(int(x), int(y)) for x, y in zip(us[:k], vs[:k])]
    clock.reset()
    joins, gathers = lj.LAUNCHES, lj.GATHER_LAUNCHES
    svc = api.serve(eng, config=rank_serve_config(api), start=True)

    def durable(s):
        t0 = time.perf_counter()
        s.checkpoint(api.IndexStore(root))
        part = {"checkpoint_s": time.perf_counter() - t0}
        b = eng.h.n
        t0 = time.perf_counter()
        s.update(inserts=[[b, b + 1, b + 2]])
        part["journaled_update_s"] = time.perf_counter() - t0
        q, w = fresh_requests(b)
        futs = [s.submit(r) for r in check + q]
        part["answers"] = [f.result(timeout=60) for f in futs]
        if part["answers"] != list(got[:k]) + w:
            raise AssertionError("rank service after the checkpoint")
        part["fresh"] = b
        return part
    part = lead_or_follow(svc, durable)
    part["live"] = service_counts(svc, lj, clock, joins, gathers)
    store = api.IndexStore(root)
    ckpt = store.current_checkpoint()
    part.update(checkpoint_bytes=os.path.getsize(ckpt),
                wal_bytes=os.path.getsize(os.path.join(
                    root, f"wal-{store.checkpoint_version:012d}.log")),
                write_seconds=writes.seconds, writes=writes.calls,
                append_seconds=appends.seconds, appends=appends.calls)
    clock.reset()
    joins, gathers = lj.LAUNCHES, lj.GATHER_LAUNCHES
    t0 = time.perf_counter()
    back = api.ReachabilityService.restore(root, mesh=pm,
                                           config=rank_serve_config(api),
                                           start=True)
    part["restore_s"] = time.perf_counter() - t0
    answers = part.pop("answers", None)
    fresh = part.pop("fresh", None)

    def first_answers(s):
        q, _ = fresh_requests(fresh)
        futs = [s.submit(r) for r in check + q]
        first = futs[0].result(timeout=60)
        to_first = time.perf_counter() - t0
        got_back = [first] + [f.result(timeout=60) for f in futs[1:]]
        if got_back != answers:
            raise AssertionError("restored service: answers differ from "
                                 "the live service's")
        return {"restore_to_first_answer_s": to_first}
    part.update(lead_or_follow(back, first_answers))
    part["restored"] = service_counts(back, lj, clock, joins, gathers)
    part["restored_version"] = back.engine.version
    out["store"] = part
    del back
    return out


def rank_closure_store(api, dist, coll, eng, logical, pm, work, rank):
    """``save_index`` of the resident ENG-s closure on the ranks (payload
    ``closure``: the W* blocks cross to rank 0 one at a time) and
    ``load_index(mesh=pm)``: the file equals the logical engine's after
    the same edits, and each loaded block is its block of that W* in
    edge order.  Returns seconds and the bytes this rank received."""
    path = os.path.join(work, "engs.hlidx")
    received = []
    plain = coll.exchange_pieces

    def counted(*args, **kw):
        got = plain(*args, **kw)
        received.append(sum(t.numel() * t.element_size()
                            for t in got.values()))
        return got
    coll.exchange_pieces = counted
    try:
        manifest, save_s = timed_s(lambda: api.save_index(path, eng))
    finally:
        coll.exchange_pieces = plain
    part = {"seconds": save_s, "received_bytes": sum(received),
            "payload": manifest["payload"], "file_bytes":
            os.path.getsize(path)}
    if rank == 0:
        mine = os.path.join(work, "engs-logical.hlidx")
        api.save_index(mine, logical)
        with open(path, "rb") as f, open(mine, "rb") as g:
            if f.read() != g.read():
                raise AssertionError("ENG-s closure file on ranks != the "
                                     "logical engine's")
        part["file_equal_logical"] = True
    loaded, part["load_seconds"] = timed_s(lambda: api.load_index(
        path, mesh=pm))
    slots = torch.from_numpy(logical._slot_of).to(logical._w_star.device)
    whole = logical._w_star.index_select(0, slots).index_select(1, slots)
    part["max_abs_err"] = check_equal(
        f"rank {rank} loaded W* block", loaded._w_star,
        dist.block_of(whole, pm, ("data", "model")))
    part["block_shape"] = list(loaded._w_star.shape)
    return part, loaded


def overlap_rows_checks(ov, api, device):
    """``overlap_rows`` against its plain version (tolerance 0): row
    blocks of the closure corpus' incidences and a rank's rows of
    primary-school's, ``[3,176, 242] x [12,704, 242]`` in bf16, timed
    there beside its bound and ``torch.matmul``.  Returns (max abs err,
    the kernel row)."""
    err, cases = 0, []
    for m, n, seed in OVERLAP_CORPUS + OVERLAP_EXTRA[:2]:
        rng = np.random.default_rng(seed)
        b = torch.from_numpy((rng.random((m, n)) < 0.3).astype(
            np.float32)).to(device)
        for lo, hi in ((0, m), (m // 3, m // 3 + 1), (m // 2, m)):
            a = b[lo:hi].contiguous()
            want = ov.overlap_rows_ref(a, b)
            for pa, pb in ((a, b), (a.to(torch.bfloat16),
                                    b.to(torch.bfloat16))):
                before = ov.ROWS_LAUNCHES
                got = ov.overlap_rows(pa, pb)
                launched = ov.ROWS_LAUNCHES - before
                if launched != (1 if a.numel() and b.numel() else 0):
                    raise AssertionError(f"overlap_rows [{hi - lo}, {n}] x "
                                         f"[{m}, {n}]: {launched} launches")
                err = max(err, check_equal(
                    f"overlap_rows [{hi - lo},{n}]x[{m},{n}] {pa.dtype}",
                    got, want))
        cases.append([m, n])
    c = CLOSURE_GRAPH
    h = api.random_hypergraph(c["n"], c["m"], min_size=c["min_size"],
                              max_size=c["max_size"], seed=c["seed"])
    rows = -(-h.m // RANK_WORLD)
    b_inc = torch.from_numpy(h.to_incidence(np.float32)).to(device)
    b16 = b_inc.to(torch.bfloat16)
    a16, a32 = b16[:rows].contiguous(), b_inc[:rows].contiguous()
    err = max(err, check_equal("overlap_rows at a rank's rows",
                               ov.overlap_rows(a16, b16),
                               ov.overlap_rows_ref(a32, b_inc)))
    row = {"shape": [rows, h.m, h.n], "dtype": "bfloat16",
           "corpus": cases, "max_abs_err": err,
           **dense_times(lambda: ov.overlap_rows(a16, b16),
                         lambda: ov.overlap_rows_ref(a32, b_inc),
                         lambda: torch.matmul(a16, b16.T),
                         overlap_rows_bound(rows, h.m, h.n, 2), 20, 20,
                         library_f32=lambda: torch.matmul(a32, b_inc.T))}
    row["kernel_ms_includes"] = "pad_columns of both operands, kernel"
    return err, row


# the dispatch-side fields of the service's stats, equal on every rank
RANK_DISPATCH_FIELDS = ("answered", "batches", "padded_queries",
                        "bucket_histogram", "snapshot_refreshes",
                        "rows_rederived", "rows_full", "mesh_rows_patched",
                        "kernel_batches", "workload_answered", "updates")


def rank_services(rep, lead):
    """(name, this rank's counts, the leader's) of each service of
    ``rank_serve_steps``."""
    for name, get in (("service", lambda x: x["serve"]["service"]),
                      ("replicas", lambda x: x["serve"]["replicas"]),
                      ("checkpointed", lambda x: x["serve"]["store"]["live"]),
                      ("restored", lambda x: x["serve"]["store"]["restored"])):
        yield name, get(rep), get(lead)


def phase_rank_label_path(api, counters, main_digest, device):
    """The label regime, the rank overlap route and updates on real ranks:
    ``RANK_WORLD`` gloo processes share the card on a 2 x 2
    ``ProcessMesh`` (``rank_label_worker``).  First ``overlap_rows`` is
    held to its plain version and timed here, alone on the card; then
    the ranks run; then ``label_join`` is timed on the rows the first
    batch gathered.  ``main_digest`` is ``main_path``'s labels' digest:
    every rank's sharded build must reach it.  Returns (launches per
    kernel, max abs err per kernel, kernel rows)."""
    lj, ov = counters["label_join"], counters["overlap"]
    clock = Phase()
    out = {"phase": "rank_label_path", "world": RANK_WORLD,
           "backend": "gloo", "grid": list(RANK_GRID)}
    rows_err, rows_row = overlap_rows_checks(ov, api, device)
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_rank_labels_")
    try:
        spec = {"device": device.type, "timeout": RANK_LABEL_TIMEOUT_S,
                "main_graph": MAIN_GRAPH, "closure_graph": CLOSURE_GRAPH,
                "small_graph": SMALL_GRAPH, "main_digest": main_digest}
        reports, ranks_s = timed_s(lambda: run_ranks(work, spec,
                                                     rank_label_worker))
        answers = [np.load(os.path.join(work, f"answers{r}.npy"))
                   for r in range(RANK_WORLD)]
        rows = {k: torch.from_numpy(v).to(device) for k, v in
                np.load(os.path.join(work, "rows.npz")).items()}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    total = {"label_join": 0, "label_join_gather": 0, "overlap_rows": 0,
             "maxmin_matmul": 0}
    errs = {"label_join": 0, "label_join_gather": 0, "overlap_rows":
            rows_err, "maxmin_matmul": 0}
    for rep in reports:
        r = rep["rank"]
        if not rep["build"]["labels_equal_main_path"]:
            raise AssertionError(f"rank_label_path rank {r}: labels != "
                                 f"main_path's")
        if rep["build"]["pool_fallback"] != 0:
            raise AssertionError(f"rank_label_path rank {r}: pool_fallback")
        if not np.array_equal(answers[r], answers[0]):
            raise AssertionError(f"rank_label_path rank {r}: answers differ")
        for part in (rep["batch"], rep["update"]["batch"]):
            expect_counts(f"rank_label_path rank {r} batch",
                          {"label_join": part["label_join_launches"],
                           "label_join_gather":
                               part["label_join_gather_launches"]},
                          {"label_join": 1})
            total["label_join"] += part["label_join_launches"]
            errs["label_join"] = max(errs["label_join"],
                                     part["max_abs_err"])
        errs["label_join"] = max(errs["label_join"],
                                 rep["batch"]["rows_max_abs_err"])
        route = rep["overlap_route"]
        expect_counts(f"rank_label_path rank {r} overlap route",
                      {"overlap_rows": route["overlap_rows_launches"]},
                      {"overlap_rows": 1})
        total["overlap_rows"] += route["overlap_rows_launches"]
        churn = rep["churn"]
        total["maxmin_matmul"] += churn["build_maxmin_matmul_launches"] + \
            sum(s["maxmin_matmul_launches"] for s in churn["steps"])
        total["label_join"] += churn["label_join_gather_launches"]
        total["label_join_gather"] += churn["label_join_gather_launches"]
        if churn["label_join_gather_launches"] != 1:
            raise AssertionError(f"rank_label_path rank {r}: churn batch "
                                 f"{churn}")
        if churn["steps"][-1]["m_padded"] <= churn["m_padded_built"]:
            raise AssertionError(f"rank_label_path rank {r}: the slot "
                                 f"padding never grew")
        errs["maxmin_matmul"] = max(errs["maxmin_matmul"], *(
            s["max_abs_err"] for s in churn["steps"]))
        if r == 0 and not churn["store"].get("file_equal_logical"):
            raise AssertionError("rank_label_path: the ENG-s closure file")
        for name, part, lead in rank_services(rep, reports[0]):
            kernel = part["stats"]["kernel_batches"]
            expect_counts(f"rank_label_path rank {r} {name}",
                          {"label_join": part["label_join_launches"],
                           "label_join_gather":
                               part["label_join_gather_launches"]},
                          {"label_join": kernel})
            if not kernel or part["failed_events"]:
                raise AssertionError(f"rank_label_path rank {r} {name}: "
                                     f"{kernel} batches")
            if any(part["stats"][f] != lead["stats"][f]
                   for f in RANK_DISPATCH_FIELDS):
                raise AssertionError(f"rank_label_path rank {r} {name}: "
                                     f"stats differ from the leader's")
            total["label_join"] += part["label_join_launches"]
        rep_ = rep["serve"]["replicas"]
        if not (rep_["copies_equal"] and rep_["private"]) or \
                rep_["replica_stats"] != \
                reports[0]["serve"]["replicas"]["replica_stats"]:
            raise AssertionError(f"rank_label_path rank {r}: replicas")
        # the keep-alive interval, read from the group's timeout
        keepalive_s = rep["serve"]["service"]["keepalive_s"]
        if keepalive_s != RANK_LABEL_TIMEOUT_S / 4:
            raise AssertionError(f"rank_label_path rank {r}: keep-alive "
                                 f"every {keepalive_s} s, not a quarter of "
                                 f"the group's {RANK_LABEL_TIMEOUT_S} s")
    q, l = rows["ru"].shape
    bound_ms, bound_by = label_join_bound(rows["su"], q, l)
    join = (rows["ru"], rows["su"], rows["rv"], rows["sv"])
    errs["label_join"] = max(errs["label_join"], check_equal(
        "rank_label_path label_join rows", lj.label_join(*join),
        lj.label_join_ref(*join)))
    join_row = {"shape": [q, l], "route": "lane groups",
                "ms": cuda_ms_queued(lambda: lj.label_join(*join), reps=50),
                "plain_ms": cuda_ms(lambda: lj.label_join_ref(*join),
                                    reps=5, warmup=1),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None}
    del rows, join
    out.update(ranks_seconds=ranks_s, ranks=reports, launches=total,
               max_abs_err=errs,
               kernels={"overlap_rows": rows_row,
                        "label_join rank rows": join_row},
               answers_equal_across_ranks=True)
    out["seconds"] = clock.seconds()
    emit(out)
    return total, errs, {"overlap_rows": rows_row,
                         "label_join": join_row}


# -- the index-free and baseline backends ------------------------------------


def sweep_summary(sweeps, m):
    """What a frontier batch's sweep log says: per sweep (in order) its
    threshold, rounds run per query chunk against the cap, alive edges,
    host ms and byte bound (at the memory rate); and the batch's bound."""
    per_sweep = [{"s": rec["s"], "queries": rec["queries"],
                  "rounds": rec["rounds"], "alive_edges": rec["alive_edges"],
                  "chunk_queries": rec["chunk_queries"], "ms": rec["ms"],
                  "bound_ms": sweep_bound_bytes(rec, m) / HBM_BYTES_PER_S
                  * 1e3} for rec in sweeps]
    nbytes = sum(sweep_bound_bytes(rec, m) for rec in sweeps)
    return {"sweeps": len(sweeps), "per_sweep": per_sweep,
            "rounds_cap": sweeps[0]["rounds_cap"] if sweeps else None,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_bytes": nbytes, "bound_by": "bytes"}


def timed_frontier_batch(eng, us, vs, s=None):
    """One frontier batch on the card (``mr_batch``, or ``s_reach_batch``
    at ``s``): answers, host-clock ms (synchronised), its sweep log, and
    the peak device memory during it (absolute, and over what was
    allocated before)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = eng.mr_batch(us, vs) if s is None else eng.s_reach_batch(us, vs, s)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    row = {"queries": len(us), "batch_ms": ms, "peak_bytes": peak,
           "peak_rise_bytes": peak - base, **sweep_summary(eng.last_sweeps,
                                                          eng.h.m)}
    return out, row


def edit_batch(rng, h):
    """Two inserted hyperedges on existing vertices and two deletes."""
    ins = [sorted(int(x) for x in rng.choice(h.n, k, replace=False))
           for k in (4, 3)]
    dels = sorted(int(x) for x in rng.choice(h.m, 2, replace=False))
    return ins, dels


def canonical_coo(coo):
    """A line graph's host half-list as [E, 3] (low id, high id, od) rows
    in order: the splice keeps a touched pair as (touched, other), either
    way round."""
    src, dst, od = coo
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    order = np.lexsort((hi, lo))
    return np.stack([lo[order], hi[order], od[order]], axis=1)


def spread_pairs(answers, k):
    """Indices of k pairs whose answers span the distinct values present
    (the lowest, the highest and evenly between; the first pair of each),
    so that a backend which collapses its answers fails a check on them."""
    values = np.unique(answers)
    if values.size < 2:
        raise AssertionError(f"every pair answers {values.tolist()}: the "
                             f"few-pair check would witness nothing")
    picks = values[np.unique(np.linspace(0, values.size - 1, k).round()
                             .astype(np.int64))]
    idx = [int(np.flatnonzero(answers == x)[0]) for x in picks]
    idx += [i for i in range(answers.size) if i not in idx][:k - len(idx)]
    return np.array(idx, np.int64)


def forest_mr(oracle, us, vs):
    """MR of each pair off the MST oracle's spanning forest (one forest
    walk per hyperedge of u: ``MSTOracle.mr`` pair by pair would take
    minutes a query at email-Eu's degree)."""
    h = oracle.h
    return np.array([oracle.rows(h.edges_of(int(u)))[
        :, h.edges_of(int(v))].max(initial=0) for u, v in zip(us, vs)],
        np.int64)


def phase_backends_path(api, engine_mod, lj, counters, wl, main_h,
                        main_pairs, main_mr, device, refs):
    """The index-free and baseline backends on email-Eu (past the label
    budget): `auto` builds `online` and `frontier`, `ete` joins through
    `label_join_gather`, `threshold` and `online` answer a few pairs, one
    update on `online` and `frontier` against engines rebuilt from scratch;
    then `frontier` on the main path's graph against `hl-index`.  The
    host-only structures of `ete`, `threshold` and the MST oracle come
    from ``refs`` (built beside the card's work) and are wrapped in their
    engines here."""
    clock = Phase()
    g = EMAIL_EU
    seconds = {}
    t_step = time.perf_counter()

    def lap(name):
        nonlocal t_step
        torch.cuda.synchronize()
        now = time.perf_counter()
        seconds[name] = round(now - t_step, 3)
        t_step = now

    h = api.random_hypergraph(g["n"], g["m"], min_size=g["min_size"],
                              max_size=g["max_size"], seed=g["seed"])
    proxy = h.nnz * float(h.vertex_degrees.mean())
    plans = {"trickle": api.plan_backend(h),
             "batch_1024": api.plan_backend(h, FRONTIER_PAIRS)}
    if plans != {"trickle": "online", "batch_1024": "frontier"}:
        raise AssertionError(f"backends_path: plan {plans} on email-Eu")
    lap("generate")
    online = api.build_engine(h)
    lap("online_build")                      # the neighbor cache
    cache_bytes = online.nbytes()
    frontier = api.build_engine(h, batch_hint=FRONTIER_PAIRS)
    lap("frontier_build")                    # line graph, landed on the card
    if (online.name, frontier.name) != ("online", "frontier"):
        raise AssertionError(f"auto built {online.name} / {frontier.name}")
    if frontier.g.src.device.type != device.type:
        raise AssertionError("frontier's line graph is not on the card")
    line_graph_edges = int(frontier.g.src.numel())
    ete_index, ref_builds = refs.take("email_eu", "ete", h)
    ete = engine_mod.ETEEngine(h, ete_index, device=device)
    ete.use_kernels = True
    lap("ete_build")
    snap = ete.snapshot()
    lap("ete_snapshot")
    tci, ref_builds_t = refs.take("email_eu", "threshold", h)
    threshold = engine_mod.ThresholdEngine(h, tci)
    lap("threshold_build")
    oracle, ref_builds_o = refs.take("email_eu", "mst-oracle", h)
    lap("oracle_build")
    ref_builds = {"ete": ref_builds, "threshold": ref_builds_t,
                  "mst-oracle": ref_builds_o}

    rng = np.random.default_rng(23)
    us, vs = rng.integers(0, h.n, FRONTIER_PAIRS), rng.integers(
        0, h.n, FRONTIER_PAIRS)
    eus, evs = rng.integers(0, h.n, ETE_PAIRS), rng.integers(0, h.n,
                                                              ETE_PAIRS)
    # the counted run: every count to 0, drive the path, read
    reset_counts(counters)
    lj.GATHER_LAUNCHES = 0
    mr, mr_row = timed_frontier_batch(frontier, us, vs)
    sr, sr_row = timed_frontier_batch(frontier, us, vs, s=2)
    frontier_counts = read_counts(counters)
    t0 = time.perf_counter()
    ete_mr = ete.mr_batch(eus, evs)
    ete_ms = (time.perf_counter() - t0) * 1e3
    ete_on_pairs = ete.mr_batch(us, vs)
    counts = read_counts(counters)
    gather = lj.GATHER_LAUNCHES
    lap("counted_run")
    if any(frontier_counts.values()):
        raise AssertionError(f"frontier launched a kernel: {frontier_counts}")
    want_counts = {name: 0 for name in counters}
    want_counts["label_join"] = 2
    if counts != want_counts or gather != 2:
        raise AssertionError(f"backends_path: launches {counts}, gather "
                             f"{gather}; expected one gather launch per ete "
                             f"batch (2)")
    if mr.dtype != np.int64 or sr.dtype != np.bool_:
        raise AssertionError(f"frontier dtypes {mr.dtype}, {sr.dtype}")
    if not np.array_equal(sr, mr >= 2):
        raise AssertionError("frontier: s_reach_batch(s=2) != mr_batch >= 2")
    if ete_mr.dtype != np.int32 or not np.array_equal(ete_on_pairs, mr):
        raise AssertionError("ete's kernel batch differs from frontier's")
    plain = engine_mod.ETEEngine(h, ete.ete, device=device)
    if not np.array_equal(plain.mr_batch(eus, evs), ete_mr):
        raise AssertionError("ete: kernel batch differs from batched_mr")
    lap("ete_plain")

    # online (Base*), threshold and the oracle on pairs of distinct answers
    few = spread_pairs(mr, ONLINE_PAIRS)
    few_u, few_v = us[few], vs[few]
    t0 = time.perf_counter()
    online_mr = [online.mr(int(u), int(v)) for u, v in zip(few_u, few_v)]
    online_ms = (time.perf_counter() - t0) * 1e3 / ONLINE_PAIRS
    t0 = time.perf_counter()
    threshold_mr = [threshold.mr(int(u), int(v))
                    for u, v in zip(few_u, few_v)]
    threshold_ms = (time.perf_counter() - t0) * 1e3 / ONLINE_PAIRS
    oracle_mr = forest_mr(oracle, few_u, few_v).tolist()
    if not (online_mr == threshold_mr == oracle_mr == mr[few].tolist()):
        raise AssertionError(f"backends_path: online {online_mr}, threshold "
                             f"{threshold_mr}, oracle {oracle_mr}, frontier "
                             f"{mr[few].tolist()}")
    lap("online_threshold_oracle")

    # the workload ops of these engines (workloads_path, email-Eu part)
    workloads, workload_gather = email_eu_workloads(
        wl, lj, counters, h, frontier, online, ete, us, vs, mr, few)
    lap("workloads")

    # the ete kernel at this path's shape, against its plain version
    bu = torch.from_numpy(eus).to(device)
    bv = torch.from_numpy(evs).to(device)
    fused = lj.label_join_gather(snap.ranks, snap.svals, bu, bv)
    gather_err = check_equal("ete by id", fused, plain_gather_chunked(
        lj.label_join_gather_ref, snap.ranks, snap.svals, bu, bv))
    scratch = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                          device=device)
    bound_ms, bound_by, bound_counts = label_join_gather_bound(snap.svals,
                                                               bu, bv)
    ete_kernel = {
        "shape": [ETE_PAIRS, snap.lmax], "n": h.n,
        "route_lanes_per_query": lj.lanes_per_query(snap.lmax),
        "route": ("warp per row" if lj.lanes_per_query(snap.lmax) == 0
                  else "lanes per query"),
        "ms": cuda_ms(lambda: lj.label_join_gather(snap.ranks, snap.svals,
                                                   bu, bv), reps=30),
        "cold_ms": cuda_ms_cold(
            lambda: lj.label_join_gather(snap.ranks, snap.svals, bu, bv),
            scratch, reps=10),
        "plain_ms": cuda_ms(lambda: plain_gather_chunked(
            lj.label_join_gather_ref, snap.ranks, snap.svals, bu, bv),
            reps=3, warmup=1),
        "torch_ops_ms": cuda_ms(lambda: snap.mr(bu, bv), reps=20),
        "bound_ms": bound_ms, "bound_by": bound_by, **bound_counts,
        "max_abs_err": gather_err}
    del scratch
    lap("ete_kernel_timing")

    # one update on online and frontier, against engines rebuilt whole
    ins, dels = edit_batch(np.random.default_rng(29), h)
    t0 = time.perf_counter()
    online.update(inserts=ins, deletes=dels)
    online_update_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    frontier.update(inserts=ins, deletes=dels)
    torch.cuda.synchronize()
    frontier_update_s = time.perf_counter() - t0
    h2 = frontier.h
    fresh_frontier = api.build_engine(h2, "frontier")
    fresh_online = api.build_engine(h2, "online")
    lap("update_and_rebuild")
    # the splice appends the touched pairs: equal as a set of pairs
    if not np.array_equal(canonical_coo(frontier.g._coo),
                          canonical_coo(fresh_frontier.g._coo)):
        raise AssertionError("frontier: spliced line graph != rebuilt")
    for rows, fresh_rows in ((online.cache.nbrs, fresh_online.cache.nbrs),
                             (online.cache.ods, fresh_online.cache.ods)):
        if len(rows) != len(fresh_rows) or not all(
                np.array_equal(a, b) for a, b in zip(rows, fresh_rows)):
            raise AssertionError("online: patched neighbor cache != rebuilt")
    mr2 = frontier.mr_batch(us, vs)
    if not np.array_equal(mr2, fresh_frontier.mr_batch(us, vs)):
        raise AssertionError("frontier: answers after update != rebuilt")
    online_mr2 = [online.mr(int(u), int(v)) for u, v in zip(few_u, few_v)]
    if online_mr2 != mr2[few].tolist():
        raise AssertionError(f"online after update {online_mr2} != frontier "
                             f"{mr2[few].tolist()}")
    lap("update_checks")
    del fresh_frontier, fresh_online
    torch.cuda.empty_cache()

    # frontier on the main path's graph, beside hl-index's answers
    t0 = time.perf_counter()
    main_frontier = api.build_engine(main_h, "frontier")
    main_build_s = time.perf_counter() - t0
    reset_counts(counters)
    main_got, main_row = timed_frontier_batch(main_frontier, *main_pairs)
    main_edges = int(main_frontier.g.src.numel())
    main_counts = read_counts(counters)
    if any(main_counts.values()):
        raise AssertionError(f"frontier launched a kernel: {main_counts}")
    if not np.array_equal(main_got, main_mr):
        raise AssertionError("frontier on the main graph != hl-index")
    lap("main_graph_frontier")
    del main_frontier
    torch.cuda.empty_cache()

    emit({"phase": "backends_path", "n": h.n, "m": h.m, "nnz": h.nnz,
          "mean_vertex_degree": float(h.vertex_degrees.mean()),
          "label_mass_proxy": proxy, "plans": plans,
          "line_graph_directed_edges": line_graph_edges,
          "neighbor_cache_bytes": cache_bytes,
          "ete_labels": ete.ete.num_labels, "ete_lmax": snap.lmax,
          "ete_snapshot_bytes": snap.nbytes(),
          "threshold_comp_shape": list(threshold.tci.comp.shape),
          "threshold_bytes": threshold.nbytes(),
          "host_seconds": seconds,
          # host_seconds' ete_build / threshold_build / oracle_build are
          # the parent's wait and wrapping; each build ran in a worker
          "reference_builds": ref_builds,
          "frontier_mr_batch": mr_row, "frontier_s_reach_batch": dict(
              sr_row, s=2),
          "ete": {"queries": ETE_PAIRS, "batch_ms": ete_ms,
                  "launches": gather, "kernel": ete_kernel,
                  "answers_equal_frontier_on": FRONTIER_PAIRS},
          "online_pairs": ONLINE_PAIRS, "online_ms_per_query": online_ms,
          "threshold_ms_per_query": threshold_ms,
          "few_pairs": few.tolist(), "few_pair_answers": online_mr,
          "few_pair_answers_after_update": online_mr2,
          "update": {"inserts": ins, "deletes": dels,
                     "online_seconds": round(online_update_s, 3),
                     "frontier_seconds": round(frontier_update_s, 3)},
          "main_graph": {"n": main_h.n, "m": main_h.m,
                         "build_seconds": round(main_build_s, 3),
                         "line_graph_directed_edges": main_edges,
                         "frontier_mr_batch": main_row},
          "answer_histogram": np.bincount(mr).tolist(),
          "workloads": workloads,
          "seconds": clock.seconds()})
    return gather, ete_kernel, workload_gather


def ms_stats(times):
    """Calls, median and max of a list of host-clock milliseconds."""
    return {"calls": len(times), "median_ms": statistics.median(times),
            "max_ms": max(times)}


def timed_calls(fn, args):
    """``fn(*a)`` for each ``a`` in ``args`` on the host clock (device work
    synchronised): the results and each call's milliseconds."""
    out, times = [], []
    for a in args:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out.append(fn(*a))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, times


def needs_walk(h, u, v, k):
    """No hyperedge of size ``k`` or more holds both ``u`` and ``v``: a
    witness of strength ``k`` for them is a walk of two or more."""
    shared = np.intersect1d(h.edges_of(int(u)), h.edges_of(int(v)))
    return bool(k) and not (h.edge_sizes[shared] >= k).any()


def bounded_sweeps(frontier, args):
    """``frontier.s_reach_k(*a)`` for each ``a`` (one bounded sweep on the
    card each): the answers, each call's host ms and each sweep's record."""
    sweeps = []

    def sweep(u, v, s, k):
        out = frontier.s_reach_k(u, v, s, k)
        sweeps.append(frontier.last_sweeps[0])
        return out

    out, ms = timed_calls(sweep, args)
    return out, ms, sweeps


def check_same(tag, got, want):
    """Equal in value and type (arrays also in dtype and shape)."""
    if isinstance(want, np.ndarray):
        ok = (isinstance(got, np.ndarray) and got.dtype == want.dtype
              and np.array_equal(got, want))
    else:
        ok = got == want and type(got) is type(want)
    if not ok:
        raise AssertionError(f"{tag}: {got!r} != {want!r}")


def workload_requests(serve_mod, rng, n, pools):
    """The service's seeded mixed traffic (``WORKLOAD_TRAFFIC``), shuffled
    over the three tenants, and the answer each must resolve to: the
    engine's direct answers (``pools``) for the workload kinds, the plain
    join's for MR / s-reach and ``mr_set``."""
    specs = []
    pool_u, pool_v, pool_mr = pools["pairs"]
    for i in range(WORKLOAD_TRAFFIC["mr"]):
        specs.append((serve_mod.MRRequest, (int(pool_u[i]), int(pool_v[i])),
                      int(pool_mr[i])))
    s_vals = rng.integers(1, 9, WORKLOAD_TRAFFIC["s_reach"])
    for i, s in enumerate(s_vals):
        j = -1 - i
        specs.append((serve_mod.SReachRequest,
                      (int(pool_u[j]), int(pool_v[j]), int(s)),
                      bool(pool_mr[j] >= s)))
    for (u, k), want in pools["top_s"][:WORKLOAD_TRAFFIC["top_s"]]:
        specs.append((serve_mod.TopSRequest, (u, k), tuple(
            zip(want[0].tolist(), want[1].tolist()))))
    for us, vs, want in pools["mr_set"][:WORKLOAD_TRAFFIC["mr_set"]]:
        specs.append((serve_mod.MRSetRequest, (tuple(us.tolist()),
                                               tuple(vs.tolist())), want))
    for args, want in pools["s_reach_k"][:WORKLOAD_TRAFFIC["s_reach_k"]]:
        specs.append((serve_mod.SReachKRequest, args, want))
    for args, want in pools["witness"][:WORKLOAD_TRAFFIC["witness"]]:
        specs.append((serve_mod.WitnessRequest, args, want))
    for args, want in pools["s_distance"][:WORKLOAD_TRAFFIC["s_distance"]]:
        specs.append((serve_mod.SDistanceRequest, args, want))
    order = rng.permutation(len(specs))
    tenants = [t for t, _ in SERVICE_TENANTS]
    tenant = rng.integers(0, len(tenants), len(specs))
    reqs, want = [], []
    for i, t in zip(order, tenant):
        cls, args, w = specs[i]
        reqs.append(cls(*args, tenant=tenants[t]))
        want.append(w)
    return reqs, want


def workload_service_run(api, serve_mod, eng, reqs, counters):
    """One ``drain()`` run of ``reqs`` through ``api.serve(eng)`` (kernels
    on, one admission pass), every count set to 0 just before and read
    just after: the futures' results, the stats, the launches and the
    host seconds of the run."""
    lj = counters["label_join"]
    tenants = tuple(serve_mod.TenantSpec(t, w) for t, w in SERVICE_TENANTS)
    cfg = serve_mod.ServiceConfig(max_batch=65_536, tenants=tenants,
                                  use_kernels=True)
    reset_counts(counters)
    lj.GATHER_LAUNCHES = 0
    svc = api.serve(eng, config=cfg, start=False)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        futs = svc.submit_many(reqs)
        svc.drain()
        got = [f.result(timeout=300) for f in futs]
        run_s = time.perf_counter() - t0
    finally:
        svc.close()
    counts = read_counts(counters)
    counts["label_join_gather"] = lj.GATHER_LAUNCHES
    return got, svc.stats(), counts, run_s


def distance_pairs(rng, h, oracle, pool_u, pool_v, pool_mr):
    """``S_DISTANCE_PAIRS`` queries at ``S_DISTANCE_S``: a quarter across
    an overlap of ``s`` or more next to a landmark (one member of the
    landmark, one of its neighbor; two hyperedges apart unless they share
    another), a quarter inside one hyperedge of the pool (one apart), the
    rest random pool pairs (on this graph nearly all 0)."""
    s, out = S_DISTANCE_S, []
    for lm in oracle.landmarks:
        nbrs, ods = h.neighbors_od(lm)
        e = int(nbrs[np.flatnonzero(ods >= s)[0]])
        only_u = np.setdiff1d(h.edge(lm), h.edge(e))
        only_v = np.setdiff1d(h.edge(e), h.edge(lm))
        if only_u.size and only_v.size:
            out.append((int(rng.choice(only_u)), int(rng.choice(only_v)), s))
        if len(out) == S_DISTANCE_PAIRS // 4:
            break
    inside = np.flatnonzero(pool_mr >= s)[:S_DISTANCE_PAIRS // 4]
    rand = np.flatnonzero(pool_mr < s)[:S_DISTANCE_PAIRS - len(out)
                                       - inside.size]
    out += [(int(pool_u[i]), int(pool_v[i]), s)
            for i in np.concatenate([inside, rand])]
    return out


def phase_workloads_path(api, wl, serve_mod, counters, eng, device):
    """The five workload families on the main path's engine (hl-index,
    kernels on, as ``service_path`` left it: updated), each op against a
    plain answer; then the same ops mixed into request traffic through
    ``api.serve``.  ``top_s`` / ``mr_set`` / ``mr_from_set`` are one
    ``label_join_gather`` launch each; witnesses, the gated ``s_reach_k``
    and ``s_distance`` are host BFS; ``s_reach_k`` is held to ``frontier``
    built on the same graph (its bounded sweep on the card)."""
    clock = Phase()
    lj = counters["label_join"]
    h, n = eng.h, eng.h.n
    if not eng.use_kernels or eng.name != "hl-index":
        raise AssertionError("workloads_path needs the kernel hl-index engine")
    snap = eng.snapshot()
    seconds = {}
    t_step = time.perf_counter()

    def lap(name):
        nonlocal t_step
        torch.cuda.synchronize()
        now = time.perf_counter()
        seconds[name] = round(now - t_step, 3)
        t_step = now

    def plain(us, vs):
        """The same snapshot joined by ``batched_mr`` (kernels off)."""
        return snap.mr(np.asarray(us, np.int64),
                       np.asarray(vs, np.int64)).cpu().numpy()

    rng = np.random.default_rng(37)
    pool_u, pool_v = rng.integers(0, n, 8192), rng.integers(0, n, 8192)
    # every other pair: two members of one hyperedge (MR at least its
    # size), the pairs a user asks about inside a group; random pairs on
    # this graph almost all answer 0 or 1
    for j, e in enumerate(rng.choice(np.flatnonzero(h.edge_sizes >= 2),
                                     pool_u.size // 2)):
        pool_u[2 * j], pool_v[2 * j] = rng.choice(h.edge(int(e)), 2,
                                                  replace=False)
    pool_mr = plain(pool_u, pool_v)
    reach = np.flatnonzero(pool_mr >= 1)
    top_args = [(int(u), TOP_S_K) for u in rng.integers(0, n, TOP_S_SOURCES)]
    set_args = [(rng.choice(n, MR_SET_SIZE, replace=False),
                 rng.choice(n, MR_SET_SIZE, replace=False))
                for _ in range(MR_SET_CALLS)]
    from_args = [(rng.choice(n, FROM_SET_SOURCES, replace=False),
                  rng.integers(0, n, FROM_SET_TARGETS))
                 for _ in range(FROM_SET_CALLS)]
    wit = reach[spread_pairs(pool_mr[reach], WITNESS_PAIRS // 2)]
    wit_args = [(int(pool_u[i]), int(pool_v[i])) for i in wit]
    srk = reach[:S_REACH_K_PAIRS]
    srk_args = [(int(pool_u[i]), int(pool_v[i]), int(pool_mr[i]), k)
                for i in srk for k in range(1, S_REACH_K_MAX + 1)]
    lap("arguments")

    # the counted run: every count to 0, drive each op, read
    reset_counts(counters)
    lj.GATHER_LAUNCHES = 0
    top, top_ms = timed_calls(eng.top_s, top_args)
    sets, set_ms = timed_calls(eng.mr_set, set_args)
    froms, from_ms = timed_calls(eng.mr_from_set, from_args)
    gather_label_ops = lj.GATHER_LAUNCHES
    t0 = time.perf_counter()
    oracle = eng.distance_oracle(S_DISTANCE_S)
    oracle_s = time.perf_counter() - t0
    sd_args = distance_pairs(rng, h, oracle, pool_u, pool_v, pool_mr)
    dists, sd_ms = timed_calls(eng.s_distance, sd_args)
    # half the witnesses on pairs across an overlap of 2 or more that no
    # hyperedge of size MR holds: their walks need the BFS at k >= 2
    across = [(u, v) for u, v, _ in sd_args[:S_DISTANCE_PAIRS // 4]]
    across_mr = plain([a[0] for a in across], [a[1] for a in across])
    wit_args += [a for a, k in zip(across, across_mr)
                 if needs_walk(h, *a, k)][:WITNESS_PAIRS - len(wit_args)]
    wit_args += [(int(pool_u[i]), int(pool_v[i])) for i in reach[
        :WITNESS_PAIRS]][:WITNESS_PAIRS - len(wit_args)]
    wits, wit_ms = timed_calls(eng.mr_witness, wit_args)
    srks, srk_ms = timed_calls(eng.s_reach_k, srk_args)
    counts = read_counts(counters)
    gather = lj.GATHER_LAUNCHES
    lap("counted_run")
    want_counts = {name: 0 for name in counters}
    want_counts["label_join"] = TOP_S_SOURCES + MR_SET_CALLS + FROM_SET_CALLS
    if counts != want_counts or gather != gather_label_ops or \
            gather != want_counts["label_join"]:
        raise AssertionError(f"workloads_path: launches {counts}, gather "
                             f"{gather} ({gather_label_ops} by the label "
                             f"ops); expected one per top_s / mr_set / "
                             f"mr_from_set")
    if eng.distance_oracle(S_DISTANCE_S) is not oracle:
        raise AssertionError("workloads_path: the distance oracle was not "
                             "cached")

    # each op against its plain answer (tolerance 0, types included)
    for (u, k), got in zip(top_args, top):
        want = wl.select_top_s(plain(np.full(n, u), np.arange(n)), u, k)
        for g, w in zip(got, want):
            check_same(f"top_s({u}, {k})", g, w)
    for (us, vs), got in zip(set_args, sets):
        qu, qv = wl.cross_pairs(np.unique(us), np.unique(vs))
        check_same("mr_set", got, int(plain(qu, qv).max()))
    for (us, tg), got in zip(from_args, froms):
        src = np.unique(us)
        qu, qv = wl.cross_pairs(src, tg)
        check_same("mr_from_set", got, plain(qu, qv).astype(np.int64)
                   .reshape(src.size, tg.size).max(axis=0))
    for (u, v), w in zip(wit_args, wits):
        if not isinstance(w, wl.Witness) or (w.u, w.v) != (u, v) or \
                w.s != eng.mr(u, v) or not wl.verify_witness(h, w):
            raise AssertionError(f"workloads_path: witness {w}")
    lap("label_op_checks")
    t0 = time.perf_counter()
    frontier = api.build_engine(h, "frontier")
    frontier_build_s = time.perf_counter() - t0
    reset_counts(counters)
    fronts, front_ms, sweeps = bounded_sweeps(frontier, srk_args)
    if any(read_counts(counters).values()):
        raise AssertionError("workloads_path: frontier launched a kernel")
    for args, got, want in zip(srk_args, srks, fronts):
        check_same(f"s_reach_k{args}", got, want)
    lap("s_reach_k_frontier")
    sd_mr = plain([a[0] for a in sd_args], [a[1] for a in sd_args])
    exact = [wl.bounded_s_distance(h, *a) for a in sd_args]
    for a, got, m_, x in zip(sd_args, dists, sd_mr, exact):
        if type(got) is not int or (got == 0) != (m_ < a[2]) or \
                got < x or (x == 0) != (got == 0):
            raise AssertionError(f"workloads_path: s_distance{a} = {got}, "
                                 f"MR {m_}, exact {x}")
    lap("s_distance_checks")

    # top_s split (one source): the mr_batch row, the host selection, and
    # the kernel alone at n ids, queued
    u0 = top_args[0][0]
    row_ms, rows = [], []
    sel_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        row = eng.mr_batch(np.full(n, u0, np.int64), np.arange(n))
        t1 = time.perf_counter()
        wl.select_top_s(row, u0, TOP_S_K)
        t2 = time.perf_counter()
        row_ms.append((t1 - t0) * 1e3)
        sel_ms.append((t2 - t1) * 1e3)
    bu = torch.full((n,), u0, dtype=torch.int64, device=device)
    bv = torch.arange(n, dtype=torch.int64, device=device)
    top_kernel_ms = cuda_ms_queued(
        lambda: lj.label_join_gather(snap.ranks, snap.svals, bu, bv), 50)
    top_bound = label_join_gather_bound(snap.svals, bu, bv)[:2]
    qu, qv = wl.cross_pairs(np.unique(set_args[0][0]),
                            np.unique(set_args[0][1]))
    su = torch.from_numpy(qu).to(device)
    sv = torch.from_numpy(qv).to(device)
    set_kernel_ms = cuda_ms_queued(
        lambda: lj.label_join_gather(snap.ranks, snap.svals, su, sv), 50)
    set_bound = label_join_gather_bound(snap.svals, su, sv)[:2]
    peaks = {"mr_set_65536_pairs": peak_rise(
        lambda: eng.mr_set(*set_args[0])),
        "top_s": peak_rise(lambda: eng.top_s(u0, TOP_S_K))}
    del bu, bv, su, sv
    lap("split_and_memory")

    # an id of n reaches no launch, and the card still launches after
    before = lj.GATHER_LAUNCHES
    for call in (lambda: eng.mr_set([0], [n]),
                 lambda: eng.mr_from_set([0], [n]),
                 lambda: eng.top_s(n, TOP_S_K)):
        try:
            call()
        except IndexError:
            pass
        else:
            raise AssertionError("workloads_path: an id of n was accepted")
    if lj.GATHER_LAUNCHES != before:
        raise AssertionError("workloads_path: an id of n reached a launch")
    again = eng.top_s(*top_args[0])
    torch.cuda.synchronize()
    if lj.GATHER_LAUNCHES != before + 1 or any(
            not np.array_equal(a, b) for a, b in zip(again, top[0])):
        raise AssertionError("workloads_path: no launch after the refusal")
    lap("out_of_range_ids")

    # the ops mixed into request traffic through the service
    pools = {"pairs": (pool_u, pool_v, pool_mr),
             "top_s": list(zip(top_args, top)),
             "s_reach_k": list(zip(srk_args, srks)),
             "witness": list(zip(wit_args, wits)),
             "s_distance": list(zip(sd_args, dists))}
    svc_sets = []
    for _ in range(WORKLOAD_TRAFFIC["mr_set"]):
        us = rng.choice(n, SERVICE_MR_SET_SIZE, replace=False)
        vs = rng.choice(n, SERVICE_MR_SET_SIZE, replace=False)
        svc_sets.append((us, vs, int(plain(*wl.cross_pairs(
            np.unique(us), np.unique(vs))).max())))
    pools["mr_set"] = svc_sets
    reqs, want = workload_requests(serve_mod, rng, n, pools)
    lap("service_requests")
    got, st, svc_counts, run_s = workload_service_run(
        api, serve_mod, eng, reqs, counters)
    for r, g, w in zip(reqs, got, want):
        check_same(f"service {r.kind}", g, w)
    kinds = {k: v for k, v in WORKLOAD_TRAFFIC.items()
             if k not in ("mr", "s_reach")}
    if st.workload_answered != kinds or st.answered != len(reqs):
        raise AssertionError(f"workloads_path: service stats {st.as_dict()}")
    padded_groups = sum(st.bucket_histogram.values())
    svc_want = {name: 0 for name in counters}
    svc_want["label_join"] = padded_groups + kinds["top_s"] + kinds["mr_set"]
    svc_want["label_join_gather"] = svc_want["label_join"]
    if svc_counts != svc_want or st.kernel_batches != padded_groups or \
            st.batches != padded_groups + len(kinds):
        raise AssertionError(f"workloads_path: service launches "
                             f"{svc_counts}, stats {st.as_dict()}")
    plain_reqs = [r for r in reqs if r.kind in ("mr", "s_reach")]
    _, alone, alone_counts, alone_s = workload_service_run(
        api, serve_mod, eng, plain_reqs, counters)
    if alone.bucket_histogram != st.bucket_histogram or \
            alone.padded_queries != st.padded_queries:
        raise AssertionError(f"workloads_path: buckets {st.bucket_histogram}"
                             f" with the workload kinds, "
                             f"{alone.bucket_histogram} without")
    lap("service")

    rounds = [rec["rounds"][0] for rec in sweeps]
    emit({"phase": "workloads_path", "n": n, "m": h.m,
          "engine_version": eng.version, "lmax": snap.lmax,
          "ops": {
              "top_s": {**ms_stats(top_ms), "k": TOP_S_K,
                        "launches": TOP_S_SOURCES,
                        "split_one_source": {
                            "mr_batch_median_ms": statistics.median(row_ms),
                            "selection_median_ms": statistics.median(sel_ms),
                            "kernel_queued_ms": top_kernel_ms,
                            "kernel_bound_ms": top_bound[0],
                            "kernel_bound_by": top_bound[1]},
                        "answers_per_call": [len(t[0]) for t in top]},
              "mr_set": {**ms_stats(set_ms), "pairs_per_call":
                         MR_SET_SIZE ** 2, "launches": MR_SET_CALLS,
                         "kernel_queued_ms": set_kernel_ms,
                         "kernel_bound_ms": set_bound[0],
                         "kernel_bound_by": set_bound[1],
                         "answers": sets},
              "mr_from_set": {**ms_stats(from_ms), "pairs_per_call":
                              FROM_SET_SOURCES * FROM_SET_TARGETS,
                              "launches": FROM_SET_CALLS},
              "witness": {**ms_stats(wit_ms), "launches": 0,
                          "strengths": [w.s for w in wits],
                          "walk_lengths": [len(w.walk) for w in wits]},
              "s_reach_k": {**ms_stats(srk_ms), "launches": 0,
                            "pairs": S_REACH_K_PAIRS,
                            "k": [1, S_REACH_K_MAX],
                            "true": int(sum(srks)),
                            "frontier": {**ms_stats(front_ms),
                                         "build_seconds": round(
                                             frontier_build_s, 3),
                                         "rounds_run_max": max(rounds),
                                         "alive_edges_by_s": {
                                             int(rec["s"]): rec["alive_edges"]
                                             for rec in sweeps}}},
              "s_distance": {**ms_stats(sd_ms), "launches": 0,
                             "s": S_DISTANCE_S,
                             "oracle_build_seconds": round(oracle_s, 3),
                             "landmarks": oracle.num_landmarks,
                             "oracle_bytes": oracle.nbytes(),
                             "bounds": np.bincount(dists).tolist(),
                             "exact": np.bincount(exact).tolist()}},
          "peak_rise_bytes": peaks,
          "service": {"requests": dict(WORKLOAD_TRAFFIC),
                      "mr_set_size": SERVICE_MR_SET_SIZE,
                      "seconds": round(run_s, 3),
                      "mr_s_reach_alone_seconds": round(alone_s, 3),
                      "batches": st.batches,
                      "bucket_histogram": st.bucket_histogram,
                      "workload_answered": st.workload_answered,
                      "launches": svc_counts["label_join_gather"]},
          "label_join_gather_launches": gather
          + svc_counts["label_join_gather"],
          "host_seconds": seconds, "seconds": clock.seconds()})
    del frontier
    torch.cuda.empty_cache()
    return gather + svc_counts["label_join_gather"]


def email_eu_workloads(wl, lj, counters, h, frontier, online, ete, us, vs,
                       mr, few):
    """The workload ops of the email-Eu engines of ``backends_path``:
    ``frontier``'s bounded sweep on the card against Base*'s host BFS,
    and ``ete``'s label ops (``label_join_gather`` at ``[n, 140]``)
    against ``frontier``'s answers.  Returns the phase's record and its
    launches."""
    t_start = time.perf_counter()
    cfg = EMAIL_EU_S_REACH_K
    pair = [i for i in range(cfg["pairs"]) for _ in cfg["s"] for _ in cfg["k"]]
    args = [(int(us[i]), int(vs[i]), s, k) for i in range(cfg["pairs"])
            for s in cfg["s"] for k in cfg["k"]]
    reset_counts(counters)
    lj.GATHER_LAUNCHES = 0
    fronts, front_ms, sweeps = bounded_sweeps(frontier, args)
    hosts, host_ms_ = timed_calls(online.s_reach_k, args)
    for a, got, want in zip(args, fronts, hosts):
        check_same(f"email-Eu s_reach_k{a}", got, want)
    for i, a, got in zip(pair, args, fronts):
        if got and mr[i] < a[2]:       # a bounded walk is a walk
            raise AssertionError(f"email-Eu s_reach_k{a}: MR is {mr[i]}")
    n = h.n
    srcs = [int(u) for u in us[few[:EMAIL_EU_TOP_S]]]
    tops, top_ms = timed_calls(ete.top_s, [(u, TOP_S_K) for u in srcs])
    for u, got in zip(srcs, tops):
        row = frontier.mr_batch(np.full(n, u, np.int64), np.arange(n))
        for g, w in zip(got, wl.select_top_s(row, u, TOP_S_K)):
            check_same(f"ete top_s({u})", g, w)
    rng = np.random.default_rng(41)
    set_args = [(rng.choice(n, EMAIL_EU_SET_SIZE, replace=False),
                 rng.choice(n, EMAIL_EU_SET_SIZE, replace=False))
                for _ in range(EMAIL_EU_SETS)]
    sets, set_ms = timed_calls(ete.mr_set, set_args)
    for (a, b), got in zip(set_args, sets):
        qu, qv = wl.cross_pairs(np.unique(a), np.unique(b))
        check_same("ete mr_set", got, int(frontier.mr_batch(qu, qv).max()))
    wit_args = [(int(u), int(v)) for u, v in zip(us[few], vs[few])]
    wits, wit_ms = timed_calls(ete.mr_witness, wit_args)
    for (u, v), w, want in zip(wit_args, wits, mr[few]):
        if w.s != int(want) or not wl.verify_witness(h, w):
            raise AssertionError(f"email-Eu ete witness {w}, MR {want}")
    counts = read_counts(counters)
    gather = lj.GATHER_LAUNCHES
    want_counts = {name: 0 for name in counters}
    want_counts["label_join"] = len(srcs) + len(set_args)
    if counts != want_counts or gather != want_counts["label_join"]:
        raise AssertionError(f"email-Eu workloads: launches {counts}, "
                             f"gather {gather}")
    record = {
        "frontier_s_reach_k": {**ms_stats(front_ms), **cfg,
                               "true": int(sum(fronts)),
                               "rounds_run_max": max(
                                   rec["rounds"][0] for rec in sweeps),
                               "alive_edges_by_s": {
                                   int(rec["s"]): rec["alive_edges"]
                                   for rec in sweeps}},
        "online_s_reach_k": ms_stats(host_ms_),
        "ete_top_s": {**ms_stats(top_ms), "launches": len(srcs)},
        "ete_mr_set": {**ms_stats(set_ms), "launches": len(set_args),
                       "set_size": EMAIL_EU_SET_SIZE},
        "ete_witness": {**ms_stats(wit_ms),
                        "strengths": [w.s for w in wits],
                        "walk_lengths": [len(w.walk) for w in wits]},
        "label_join_gather_launches": gather,
        "seconds": round(time.perf_counter() - t_start, 3)}
    return record, gather


def closure_workloads(wl, semiring, eng, answers, us, vs):
    """``mr_witness`` and ``top_s`` on a closure engine (every hyperedge a
    hub: the witness BFS meets anywhere), against the host W*; the
    witnesses on pairs of distinct MR whose walks need two hyperedges or
    more."""
    t_start = time.perf_counter()
    h, n = eng.h, eng.h.n
    # pairs that no hyperedge of size MR holds: the walk needs the BFS
    walk = np.flatnonzero([needs_walk(h, u, v, k)
                           for u, v, k in zip(us, vs, answers)])
    first = walk[np.unique(answers[walk], return_index=True)[1]]
    idx = np.concatenate([first, np.setdiff1d(walk, first)])[
        :CLOSURE_WITNESSES]
    if idx.size < CLOSURE_WITNESSES:
        raise AssertionError(f"closure_path: {idx.size} pairs need a walk")
    args = [(int(us[i]), int(vs[i])) for i in idx]
    wits, wit_ms = timed_calls(eng.mr_witness, args)
    for (u, v), w, i in zip(args, wits, idx):
        if w.s != int(answers[i]) or not wl.verify_witness(h, w):
            raise AssertionError(f"closure witness {w}, MR {answers[i]}")
    srcs = [int(u) for u in us[:CLOSURE_TOP_S]]
    tops, top_ms = timed_calls(eng.top_s, [(u, TOP_S_K) for u in srcs])
    for u, got in zip(srcs, tops):
        row = semiring.vertex_mr_from_edge_mr(
            h, eng.w_star, np.full(n, u, np.int64), np.arange(n))
        for g, w in zip(got, wl.select_top_s(row, u, TOP_S_K)):
            check_same(f"closure top_s({u})", g, w)
    return {"witness": {**ms_stats(wit_ms), "strengths": [w.s for w in wits],
                        "walk_lengths": [len(w.walk) for w in wits]},
            "top_s": {**ms_stats(top_ms), "k": TOP_S_K,
                      "route": "batched_mr (no kernel)"},
            "seconds": round(time.perf_counter() - t_start, 3)}


def counts_since(counters, before):
    """Launches per kernel since ``before`` (a ``read_counts`` reading,
    with ``label_join_gather`` from ``GATHER_LAUNCHES``)."""
    now = read_counts(counters)
    now["label_join_gather"] = counters["label_join"].GATHER_LAUNCHES
    return {k: now[k] - before.get(k, 0) for k in now}


def counts_now(counters):
    return counts_since(counters, {})


def same_index_rows(a, b):
    """Whether two ``HLIndex``es hold the same rank, perm and every label
    and dual row, byte for byte: each ragged field compared whole, as its
    row lengths and the concatenation of its rows."""
    if not (a.rank.tobytes() == b.rank.tobytes()
            and a.perm.tobytes() == b.perm.tobytes()):
        return False
    for f in ("labels_edge", "labels_rank", "labels_s", "dual_u", "dual_s"):
        ra, rb = getattr(a, f), getattr(b, f)
        la = np.fromiter((x.size for x in ra), np.int64, len(ra))
        lb = np.fromiter((x.size for x in rb), np.int64, len(rb))
        if not np.array_equal(la, lb):
            return False
        ca = np.concatenate(ra) if len(ra) else np.empty(0, np.int64)
        cb = np.concatenate(rb) if len(rb) else np.empty(0, np.int64)
        if ca.dtype != cb.dtype or ca.tobytes() != cb.tobytes():
            return False
    return True


def same_graph(a, b):
    return (a.n, a.m) == (b.n, b.m) and all(
        getattr(a, f).dtype == getattr(b, f).dtype
        and getattr(a, f).tobytes() == getattr(b, f).tobytes()
        for f in ("e_ptr", "e_idx", "v_ptr", "v_idx"))


def timed_s(fn):
    """(result, host seconds of ``fn``, device work synchronised)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def store_wal_records(rng, h):
    """The WAL phase's 8 records: 7 inserts over vertices of degree 0
    (each its own new line-graph component) and 1 delete of the first."""
    free = np.flatnonzero(np.diff(h.v_ptr) == 0)
    need = sum(STORE_INSERT_SIZES)
    if free.size < need:
        raise AssertionError(f"store_path: {free.size} vertices of degree "
                             f"0, the WAL records need {need}")
    picked = rng.choice(free, need, replace=False)
    cuts = np.cumsum(STORE_INSERT_SIZES)[:-1]
    return [sorted(int(v) for v in part) for part in np.split(picked, cuts)]


def store_pairs(rng, h, edges):
    """The phase's ``STORE_PAIRS`` query pairs: every other pair two
    members of one hyperedge (random pairs on this graph almost all answer
    0 or 1), the rest random, and the last ones every ordered pair of
    vertices of each WAL insert in ``edges`` (0 before their record, the
    insert's size after it)."""
    us, vs = rng.integers(0, h.n, STORE_PAIRS), rng.integers(0, h.n,
                                                              STORE_PAIRS)
    sizes = h.edge_sizes
    inside = rng.choice(np.flatnonzero(sizes >= 2), STORE_PAIRS // 2)
    size = sizes[inside]
    i = (rng.random(inside.size) * size).astype(np.int64)
    j = (i + 1 + (rng.random(inside.size) * (size - 1)).astype(np.int64)) \
        % size
    us[0::2] = h.e_idx[h.e_ptr[inside] + i]
    vs[0::2] = h.e_idx[h.e_ptr[inside] + j]
    wal = np.array([(a, b) for e in edges for a in e for b in e if a != b],
                   np.int64)
    us[-len(wal):], vs[-len(wal):] = wal[:, 0], wal[:, 1]
    return us, vs


def drop_page_cache(*paths):
    """Evict each file's clean pages from the host's page cache
    (``POSIX_FADV_DONTNEED``), so that the next read comes from the disk;
    returns the share of their pages still resident after it."""
    resident = total = 0
    for path in paths:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
        r, t = resident_pages(path)
        resident, total = resident + r, total + t
    return resident / max(total, 1)


def resident_pages(path):
    """(pages of ``path`` in the page cache, pages of ``path``), read with
    ``mincore`` on a read-only map (which faults nothing in)."""
    size = os.path.getsize(path)
    if size == 0:
        return 0, 0
    page = os.sysconf("SC_PAGE_SIZE")
    pages = (size + page - 1) // page
    view = np.memmap(path, dtype=np.uint8, mode="r")
    vec = np.zeros(pages, np.uint8)
    libc = ctypes.CDLL(None, use_errno=True)
    rc = libc.mincore(ctypes.c_void_p(view.ctypes.data),
                      ctypes.c_size_t(size),
                      vec.ctypes.data_as(ctypes.c_void_p))
    del view
    if rc != 0:
        raise OSError(ctypes.get_errno(), f"mincore({path})")
    return int((vec & 1).sum()), pages


def if_evicted(seconds, resident_share):
    """A time taken after ``drop_page_cache``, or None where the eviction
    left more than 1 % of the pages resident (a tmpfs or 9p mount keeps
    them): such a time would be a page-cache time under a cold name."""
    return seconds if resident_share <= 0.01 else None


def mount_of(path):
    """(mount point, filesystem type) that holds ``path``."""
    best, fstype = "", "unknown"
    path = os.path.realpath(path)
    with open("/proc/mounts") as f:
        for line in f:
            fields = line.split()
            mnt = fields[1]
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) >= len(best):
                best, fstype = mnt, fields[2]
    return best, fstype


def plain_threshold_closure(h, ov, tc, ops, device):
    """W* of ``h`` by the closure's plain versions on the card (B·Bᵀ in
    float32, then ``threshold_step_ref`` rounds), int32 on the card; beside it
    each kernel held to its plain version on the same operands: ``overlap``
    on the incidence, ``threshold_step`` on every round's input.  Returns
    (W*, {kernel: max abs err})."""
    b_inc = torch.from_numpy(h.to_incidence(np.float32)).to(device)
    w = ov.overlap_ref(b_inc)
    errs = {"overlap": (ov.overlap(b_inc.to(torch.bfloat16)) - w)
            .abs().max().item()}
    w = w.to(torch.int32)
    del b_inc
    t = torch.unique(w)
    t = t[t > 0]
    r = tc.threshold_adjacency(w, t, dtype=torch.bfloat16)
    err = 0.0
    for _ in range(ops.default_rounds(h.m)):
        want = tc.threshold_step_ref(r)
        err = max(err, (tc.threshold_step(r).float() - want.float())
                  .abs().max().item())
        r = want
    errs["threshold_step"] = err
    mr = tc.largest_threshold(r, t.to(torch.float32))
    del r
    mr.diagonal().copy_(w.diagonal())
    return mr.to(torch.int32), errs


def submit_and_drain(svc, reqs):
    futs = svc.submit_many(reqs)
    svc.drain()
    return futs


def phase_store_path(api, store_mod, serve_mod, ops, counters, eng, build_s,
                     device):
    """The durable store on the main path's engine (89k/70k, as
    ``workloads_path`` leaves it), then on the closure of primary-school:
    checkpoint through the service, load with and without CRCs, restart
    of the service on the card (answers through ``label_join_gather``), a
    WAL of 8 records replayed, a torn tail, a closure insert replayed
    through ``overlap`` + ``threshold_step``, and ``build_sharded``
    through its fork pool with CUDA live.  Every kernel answer is held to
    the plain join of the same snapshot, and the replayed W* to the
    closure's plain versions; loads and restarts are timed from the page
    cache and again with the files evicted from it (null where the mount
    kept them resident).  Everything is written under one
    ``tempfile.mkdtemp()`` directory, removed at the end.  Returns
    (launches, max abs err per kernel)."""
    clock = Phase()
    lj, ov, tc = (counters[k] for k in ("label_join", "overlap",
                                        "threshold_step"))
    from repro_torch.core.hlindex import build_fast, build_sharded
    from repro_torch.core.semiring import vertex_mr_from_edge_mr
    from repro_torch.device import host_to_device
    root = tempfile.mkdtemp(prefix="chip_smoke_store_")
    out = {"phase": "store_path"}
    errs = {"label_join_gather": 0, "overlap": 0.0, "threshold_step": 0.0}

    def plain_join(tag, got, snap, qu, qv):
        """The plain join (``batched_mr``) of ``snap`` on the same pairs;
        fails unless the kernel's answers ``got`` equal it."""
        want = snap.mr(np.asarray(qu, np.int64),
                       np.asarray(qv, np.int64)).cpu().numpy()
        err = int(np.abs(got.astype(np.int64) - want).max(initial=0))
        errs["label_join_gather"] = max(errs["label_join_gather"], err)
        if err:
            raise AssertionError(f"store_path: {tag}: label_join_gather "
                                 f"differs from the plain join by {err}")
        return want

    def files(d):
        gc.collect()        # no map of a file may pin its pages
        return [p for p in Path(d).iterdir() if p.is_file()]

    try:
        free = shutil.disk_usage(root).free
        if free < STORE_DISK_BYTES:
            raise AssertionError(f"store_path: {free} B free under {root}, "
                                 f"the phase writes up to "
                                 f"{STORE_DISK_BYTES} B")
        mount, fstype = mount_of(root)
        reset_counts(counters)
        lj.GATHER_LAUNCHES = 0
        h, rng = eng.h, np.random.default_rng(41)
        edges = store_wal_records(rng, h)
        us, vs = store_pairs(rng, h, edges)

        # 1. checkpoint through the service; load with / without CRCs,
        # from the disk (pages evicted) and from the page cache
        main_dir = os.path.join(root, "main")
        svc = api.ReachabilityService(eng, use_kernels=True, start=False)
        store = api.IndexStore(main_dir)
        version, save_s = timed_s(lambda: svc.checkpoint(store))
        ckpt = store.current_checkpoint()
        file_bytes = ckpt.stat().st_size
        resident = {"load_verify": drop_page_cache(ckpt)}
        cold, load_cold_s = timed_s(lambda: api.load_index(ckpt))
        loaded, load_verify_s = timed_s(lambda: api.load_index(ckpt))
        lazy, load_lazy_s = timed_s(
            lambda: api.load_index(ckpt, verify=False))
        for tag, e in (("cold", cold), ("verify", loaded), ("lazy", lazy)):
            if not (e.version == version == eng.version
                    and same_graph(e.h, eng.h)
                    and same_index_rows(e.idx, eng.idx)):
                raise AssertionError(f"store_path: load ({tag}) differs "
                                     f"from the checkpointed engine")
        _, snapshot_s = timed_s(lazy.snapshot)
        del cold, loaded, lazy, e
        resident["load_lazy"] = drop_page_cache(*files(main_dir))
        lazy, lazy_cold_s = timed_s(
            lambda: api.load_index(ckpt, verify=False))
        _, snapshot_cold_s = timed_s(lazy.snapshot)
        del lazy
        manifest = store.manifest()
        checkpoint = {
            "version": version, "file_bytes": file_bytes,
            "segment_bytes": {s["name"]: s["nbytes"]
                              for s in manifest["segments"]},
            "labels": eng.idx.num_labels, "save_seconds": save_s,
            "load_verify_cold_seconds": if_evicted(
                load_cold_s, resident["load_verify"]),
            "load_verify_seconds": load_verify_s,
            "load_lazy_seconds": load_lazy_s,
            "snapshot_from_load_seconds": snapshot_s,
            "load_lazy_cold_seconds": if_evicted(lazy_cold_s,
                                                resident["load_lazy"]),
            "snapshot_from_cold_load_seconds": if_evicted(
                snapshot_cold_s, resident["load_lazy"])}

        # 2. restart: the call to the first answer, snapshot landed, with
        # the store's files evicted, then from the page cache (the live
        # engine's answers are taken first, outside the count)
        want, live_batch_s = timed_s(lambda: eng.mr_batch(us, vs))
        plain_join("live mr_batch", want, eng.snapshot(), us, vs)
        reqs, rus, rvs, rs = service_requests(
            serve_mod, rng, h.n, STORE_REQUESTS // 2, STORE_REQUESTS // 2)
        want_reqs = expected_answers(eng.mr_batch(rus, rvs), rs)

        def restart():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rs_ = api.ReachabilityService.restore(main_dir, use_kernels=True,
                                                  start=False)
            fut = rs_.mr(int(us[0]), int(vs[0]))
            rs_.drain()
            answer = fut.result(timeout=60)
            torch.cuda.synchronize()
            return rs_, answer, time.perf_counter() - t0

        before = counts_now(counters)
        resident["restart"] = drop_page_cache(*files(main_dir))
        csvc, first_cold, first_answer_cold_s = restart()
        csvc.close()
        csvc.engine.detach_wal().close()
        del csvc
        rsvc, first, first_answer_s = restart()
        reng = rsvc.engine
        snap = reng.snapshot()
        if snap.ranks.device.type != device.type:
            raise AssertionError("store_path: restored snapshot not on "
                                 "the card")
        if not (reng.version == eng.version and same_graph(reng.h, eng.h)
                and same_index_rows(reng.idx, eng.idx)
                and snapshots_equal(snap, eng.snapshot())):
            raise AssertionError("store_path: the restored service's engine "
                                 "differs from the live one")
        reng.use_kernels = True
        got, restored_batch_s = timed_s(lambda: reng.mr_batch(us, vs))
        plain = plain_join("restored mr_batch", got, snap, us, vs)
        if (first != int(plain[0]) or first_cold != int(plain[0])
                or not np.array_equal(got, want)):
            raise AssertionError("store_path: restored mr_batch differs "
                                 "from the live engine")
        futs, serve_s = timed_s(lambda: submit_and_drain(rsvc, reqs))
        plain_reqs = expected_answers(
            snap.mr(rus.astype(np.int64), rvs.astype(np.int64))
            .cpu().numpy(), rs)
        check_service_answers("store_path restored service (plain join)",
                              futs, plain_reqs)
        check_service_answers("store_path restored service (live engine)",
                              futs, want_reqs)
        st = rsvc.stats()
        rsvc.close()
        reng.detach_wal().close()
        restart_counts = counts_since(counters, before)
        # one launch per first answer (two restarts), per service batch
        # after it, and the 2^20 mr_batch
        if (restart_counts["label_join_gather"] != 2 + st.batches
                or st.kernel_batches != st.batches):
            raise AssertionError(f"store_path: restart launches "
                                 f"{restart_counts}, service {st.as_dict()}")
        del reng, rsvc, snap
        restart = {"first_answer_cold_seconds": if_evicted(
                       first_answer_cold_s, resident["restart"]),
                   "first_answer_seconds": first_answer_s,
                   "build_fast_minimize_seconds": build_s,
                   "mr_batch_pairs": STORE_PAIRS,
                   "pairs_inside_a_hyperedge": STORE_PAIRS // 2,
                   "answers_at_least_2": int((want >= 2).sum()),
                   "restored_mr_batch_seconds": restored_batch_s,
                   "live_mr_batch_seconds": live_batch_s,
                   "service_requests": len(reqs),
                   "service_seconds": serve_s,
                   "service_batches": st.batches,
                   "launches": restart_counts}

        # 3. the WAL: 8 records live through the attached store, replayed
        append_s = []
        orig_append = store.append

        def timed_append(version, inserts, deletes):
            t = time.perf_counter()
            orig_append(version, inserts, deletes)
            append_s.append(time.perf_counter() - t)

        store.append = timed_append
        records, want7 = [], None
        for edge in edges + [None]:
            if edge is None:                   # the 8th: delete the 1st
                # the engine as 7 records leave it (an update installs a
                # new graph and index; it writes into neither old one)
                h7, idx7, want7 = eng.h, eng.idx, eng.mr_batch(us, vs)
                victim = int(eng.h.edges_of(edges[0][0])[0])
                ins, dels = [], [victim]
            else:
                ins, dels = [edge], []
            _, update_s = timed_s(lambda: svc.update(inserts=ins,
                                                     deletes=dels))
            records.append({"inserts": ins, "deletes": dels,
                            "update_seconds": update_s,
                            "scope": int(eng.idx.stats.get(
                                "maintenance_scope", -1)),
                            "append_seconds": append_s[-1]})
        store.append = orig_append
        live_version = eng.version
        replayed, replay_s = timed_s(lambda: store_mod.IndexStore(
            main_dir).restore(attach=False))
        if replayed.version != live_version:
            raise AssertionError(f"store_path: replay reached version "
                                 f"{replayed.version}, live "
                                 f"{live_version}")
        replayed.use_kernels = True
        want8 = eng.mr_batch(us, vs)
        rsnap = replayed.snapshot()
        got8 = replayed.mr_batch(us, vs)
        plain_join("replayed mr_batch", got8, rsnap, us, vs)
        if not (snapshots_equal(rsnap, eng.snapshot())
                and np.array_equal(got8, want8)
                and same_index_rows(replayed.idx, eng.idx)):
            raise AssertionError("store_path: replayed engine differs from "
                                 "the live one")
        # the pairs among the WAL's vertices must tell the states apart
        changed = {"by_the_wal": int((want8 != want).sum()),
                   "by_the_delete": int((want8 != want7).sum())}
        if not changed["by_the_delete"]:
            raise AssertionError("store_path: no pair's answer tells the "
                                 "torn restore from the full one")
        del replayed, rsnap
        wal = {"records": records, "replay_restore_seconds": replay_s,
               "live_version": live_version,
               "append_seconds_mean": statistics.mean(append_s),
               "pairs_changed": changed}

        # 4. a torn tail: the 8th record cut mid-payload
        wal_path = next(Path(main_dir).glob("wal-*.log"))
        recs, valid, _ = store_mod.scan_wal(wal_path)
        with open(wal_path, "r+b") as f:
            f.truncate(valid - 3)
        tail_status = store_mod.scan_wal(wal_path)[2]
        torn, torn_s = timed_s(lambda: store_mod.IndexStore(
            main_dir).restore(attach=False))
        torn.use_kernels = True
        tsnap = torn.snapshot()
        got7 = torn.mr_batch(us, vs)
        plain_join("torn-tail mr_batch", got7, tsnap, us, vs)
        eng7 = type(eng)(h7, idx7, device=device)
        if (tail_status != "torn-payload" or torn.version != live_version - 1
                or not np.array_equal(got7, want7)
                or not same_graph(torn.h, h7)
                or not same_index_rows(torn.idx, idx7)
                or not snapshots_equal(tsnap, eng7.snapshot())):
            raise AssertionError(f"store_path: torn tail {tail_status}, "
                                 f"version {torn.version} (live "
                                 f"{live_version}), or it differs from the "
                                 f"engine after 7 records")
        del torn, tsnap, eng7, h7, idx7
        eng.detach_wal()
        store.close()
        svc.close()
        torn_out = {"records_before": len(recs), "tail_status": tail_status,
                    "restored_version": live_version - 1,
                    "restore_seconds": torn_s}

        # 5. the closure: W* on disk, restart, one insert replayed
        ch = api.random_hypergraph(**CLOSURE_GRAPH)
        cus = rng.integers(0, ch.n, 4096)
        cvs = rng.integers(0, ch.n, 4096)

        def build_and_answer():
            e = api.build_engine(ch, "closure", method="threshold")
            return e, e.mr_batch(cus, cvs)

        (ceng, cwant), cbuild_s = timed_s(build_and_answer)
        cdir = os.path.join(root, "closure")
        cstore = api.IndexStore(cdir)
        _, csave_s = timed_s(lambda: cstore.checkpoint(ceng))
        cstore.attach(ceng)
        cfile = cstore.current_checkpoint()
        resident["closure_load_verify"] = drop_page_cache(cfile)
        cl_cold, cload_cold_s = timed_s(lambda: api.load_index(cfile))
        cl, cload_verify_s = timed_s(lambda: api.load_index(cfile))
        cl_lazy, cload_lazy_s = timed_s(
            lambda: api.load_index(cfile, verify=False))
        if not all(e.w_star.dtype == ceng.w_star.dtype == np.int32
                   and np.array_equal(e.w_star, ceng.w_star)
                   for e in (cl_cold, cl, cl_lazy)):
            raise AssertionError("store_path: closure W* differs after the "
                                 "round trip")
        _, land_mmap_s = timed_s(lambda: host_to_device(cl.w_star, device))
        _, land_heap_s = timed_s(
            lambda: torch.from_numpy(ceng.w_star).to(device))
        del cl_cold, cl, cl_lazy

        def restore_and_answer():
            e = store_mod.IndexStore(cdir).restore(attach=False)
            return e, e.mr_batch(cus, cvs)

        resident["closure_restart"] = drop_page_cache(*files(cdir))
        (cr, cgot), cfirst_cold_s = timed_s(restore_and_answer)
        del cr
        (cr, cgot_warm), cfirst_s = timed_s(restore_and_answer)
        if not (np.array_equal(cgot, cwant) and np.array_equal(cgot_warm,
                                                               cwant)):
            raise AssertionError("store_path: restored closure answers "
                                 "differ")
        del cr
        cins = [sorted(int(x) for x in rng.choice(ch.n, 3, replace=False))]
        _, clive_s = timed_s(lambda: ceng.update(inserts=cins))
        cwant2 = ceng.mr_batch(cus, cvs)
        before = counts_now(counters)
        (cr2, cgot2), creplay_s = timed_s(restore_and_answer)
        replay_counts = counts_since(counters, before)
        rounds = ops.default_rounds(ceng.h.m)
        # the replayed W* against the closure's plain versions on the
        # card; their kernel comparisons are left out of the launches
        before_cmp = counts_now(counters)
        w_plain, kernel_errs = plain_threshold_closure(cr2.h, ov, tc, ops,
                                                       device)
        w_err = (host_to_device(cr2.w_star, device) - w_plain) \
            .abs().max().item()
        w_plain = w_plain.cpu().numpy()
        compare_counts = counts_since(counters, before_cmp)
        for k in ("overlap", "threshold_step"):
            errs[k] = max(kernel_errs[k], w_err)
        plain_answers = vertex_mr_from_edge_mr(cr2.h, w_plain, cus, cvs)
        if (replay_counts["overlap"] != 1
                or replay_counts["threshold_step"] != rounds
                or cr2.version != ceng.version
                or cr2.w_star.dtype != ceng.w_star.dtype
                or w_err or kernel_errs["overlap"]
                or kernel_errs["threshold_step"]
                or not np.array_equal(cr2.w_star, ceng.w_star)
                or not np.array_equal(cgot2, plain_answers)
                or not np.array_equal(cgot2, cwant2)):
            raise AssertionError(f"store_path: closure replay launches "
                                 f"{replay_counts} (rounds {rounds}), "
                                 f"version {cr2.version}, W* err {w_err}, "
                                 f"kernel errs {kernel_errs}")
        ceng.detach_wal()
        cstore.close()
        del cr2, ceng, w_plain
        closure = {"n": ch.n, "m": ch.m, "method": "threshold",
                   "w_star_bytes": int(ch.m) * int(ch.m) * 4,
                   "file_bytes": cfile.stat().st_size,
                   "build_and_first_answer_seconds": cbuild_s,
                   "save_seconds": csave_s,
                   "load_verify_cold_seconds": if_evicted(
                       cload_cold_s, resident["closure_load_verify"]),
                   "load_verify_seconds": cload_verify_s,
                   "load_lazy_seconds": cload_lazy_s,
                   "w_star_to_card_from_mmap_seconds": land_mmap_s,
                   "w_star_to_card_from_heap_seconds": land_heap_s,
                   "restore_first_answer_cold_seconds": if_evicted(
                       cfirst_cold_s, resident["closure_restart"]),
                   "restore_first_answer_seconds": cfirst_s,
                   "live_update_seconds": clive_s,
                   "replay_restore_first_answer_seconds": creplay_s,
                   "insert": cins, "replay_launches": replay_counts,
                   "replay_w_star_max_abs_err": w_err,
                   "replay_kernel_max_abs_err": kernel_errs}

        # 6. build_sharded through the fork pool, with CUDA live
        hs = api.random_hypergraph(**SMALL_GRAPH)
        h4 = api.from_edge_lists(
            [hs.edge(e) + k * hs.n for k in range(SHARDED_COPIES)
             for e in range(hs.m)], n=SHARDED_COPIES * hs.n)
        sharded, sharded_s = timed_s(lambda: build_sharded(
            h4, workers=SHARDED_WORKERS, num_shards=SHARDED_COPIES))
        serial, serial_s = timed_s(lambda: build_fast(h4))
        sharded_out = {"n": h4.n, "m": h4.m, "workers": SHARDED_WORKERS,
                       "num_shards": SHARDED_COPIES,
                       "shards": int(sharded.stats["shards"]),
                       "components": int(sharded.stats["components"]),
                       "pool_fallback": float(sharded.stats["pool_fallback"]),
                       "build_sharded_seconds": sharded_s,
                       "build_fast_seconds": serial_s}
        if (sharded_out["pool_fallback"] != 0
                or sharded_out["components"] < SHARDED_COPIES
                or sharded_out["shards"] != SHARDED_COPIES
                or not same_index_rows(sharded, serial)):
            raise AssertionError(f"store_path: build_sharded {sharded_out}, "
                                 f"or its labels differ from build_fast")
        launches = {k: v - compare_counts.get(k, 0)
                    for k, v in counts_now(counters).items()}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out.update(filesystem={"mount": mount, "type": fstype},
               page_cache_resident_after_drop=resident,
               checkpoint=checkpoint, restart=restart, wal=wal,
               torn_tail=torn_out, closure=closure,
               build_sharded=sharded_out, launches=launches,
               comparison_launches=compare_counts, max_abs_err=errs,
               seconds=clock.seconds())
    emit(out)
    return launches, errs


# -- the benchmark suite and the examples -------------------------------------

def bench_published(main_eng, closure_eng):
    """The suite's pieces that take a built engine, at the published sizes
    of walmart-trips (``main_eng``, 89k/70k) and primary-school
    (``closure_eng``, the ``closure`` backend's threshold build): exp1's
    Min-* rows, ``kernels_bench`` (a 2^20 ``label_join_gather`` batch on
    the 89k/70k snapshot; the closure rows, ``overlap`` and
    ``threshold_step`` on primary-school's line graph) and
    ``bench_serving``'s service-vs-per-call comparison on both engines."""
    from repro_torch.benchmarks import bench_serving, kernels_bench
    from repro_torch.benchmarks import paper_tables
    from repro_torch.core.semiring import vertex_mr_from_edge_mr

    ps = closure_eng.h
    out, seconds = {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        seconds[name] = round(time.perf_counter() - t0, 3)

    timed("exp1.WA", lambda: paper_tables.exp1_query_time(
        "WA", n_q=BENCH_EXP1_PAIRS, engine=main_eng))
    timed("kernels_bench.label_join.WA", lambda: kernels_bench.label_join_bench(
        0, 0, BENCH_JOIN_PAIRS, 256, engine=main_eng, oracle_sample=0))
    timed("kernels_bench.closure.PS", lambda: kernels_bench.closure_bench(
        h=ps, reps=1))
    timed("kernels_bench.overlap.PS",
          lambda: kernels_bench.overlap_bench(ps))
    timed("kernels_bench.threshold_step.PS",
          lambda: kernels_bench.threshold_bench(ps))
    timed("bench_serving.WA", lambda: bench_serving.bench_published(
        main_eng, BENCH_WA_REQUESTS, 500))
    timed("bench_serving.PS", lambda: bench_serving.bench_published(
        closure_eng, BENCH_PS_REQUESTS, 256,
        reference=lambda us, vs: vertex_mr_from_edge_mr(
            ps, closure_eng.w_star, us, vs),
        reference_name="the host W* lookup (vertex_mr_from_edge_mr)"))
    return out, seconds


def run_examples():
    """The four examples' ``main`` on the card, their answers checked."""
    import importlib

    out, seconds = {}, {}
    for name in BENCH_EXAMPLES:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        t0 = time.perf_counter()
        out[name] = mod.main(device="cuda")
        torch.cuda.synchronize()
        seconds[f"examples.{name}"] = round(time.perf_counter() - t0, 3)
    if out["quickstart"]["figure1"] != (2, 2, True):
        raise AssertionError(f"Figure 1: {out['quickstart']['figure1']}")
    dist = out["distributed_reachability"]
    if not (all(dist["closure_correct"].values()) and dist["threshold_correct"]
            and all(dist["engine_correct"].values())
            and dist["planned"] == "sharded"):
        raise AssertionError(f"distributed_reachability: {dist}")
    # a 2 x 2 round: r * c contractions (allgather), r * c * r (ring)
    if dist["round_launches"] != {"allgather": 4, "ring": 8}:
        raise AssertionError(f"round launches {dist['round_launches']}")
    if not out["serving_quickstart"].get("deadline"):
        raise AssertionError("serving_quickstart: no deadline error")
    return out, seconds


def phase_bench_path(counters, main_eng, closure_eng):
    """Every ported benchmark script and example to its end on the card:
    ``python -m repro_torch.benchmarks.<script> --quick`` through each
    script's ``main`` (its JSON into ``build/bench_torch/``), the four
    examples, the port's docs check; then the pieces at published sizes on
    the engines ``main_path`` and ``closure_path`` built (no build
    repeated).  Every count is set to 0 just before and read just after;
    every script's own assertions (oracle answers, kernel against plain
    version) hold or the phase fails."""
    from repro_torch.benchmarks import (bench_construction,
                                        bench_maintenance,
                                        bench_persistence,
                                        bench_service_scale, bench_serving,
                                        bench_sharded, bench_workloads,
                                        kernels_bench)
    from repro_torch.benchmarks import run as run_mod
    from repro_torch.benchmarks.common import default_out
    from repro_torch.tools import check_docs

    lj = counters["label_join"]
    clock = Phase()
    seconds = {}
    reset_counts(counters)
    lj.GATHER_LAUNCHES = 0

    t0 = time.perf_counter()
    rows = run_mod.collect(quick=True)
    seconds["run --quick"] = round(time.perf_counter() - t0, 3)
    agree = [r for r in rows if r[0].endswith(".agrees-with-oracle")]
    if not agree or any(r[1] != 1.0 for r in agree):
        raise AssertionError(f"agrees-with-oracle rows: {agree}")
    scripts = {"kernels": kernels_bench, "serving": bench_serving,
               "service_scale": bench_service_scale,
               "workloads": bench_workloads,
               "persistence": bench_persistence,
               "maintenance": bench_maintenance,
               "construction": bench_construction}
    docs = {}
    for name, mod in scripts.items():
        t0 = time.perf_counter()
        mod.main(["--quick"])
        torch.cuda.synchronize()
        seconds[f"{mod.__name__.rsplit('.', 1)[1]} --quick"] = round(
            time.perf_counter() - t0, 3)
        with open(default_out(name)) as f:
            docs[name] = json.load(f)
    t0 = time.perf_counter()
    bench_sharded.main([])
    seconds["bench_sharded"] = round(time.perf_counter() - t0, 3)
    with open(default_out("sharded")) as f:
        docs["sharded"] = json.load(f)
    examples, ex_seconds = run_examples()
    seconds.update(ex_seconds)
    t0 = time.perf_counter()
    problems = check_docs.problems()
    seconds["check_docs"] = round(time.perf_counter() - t0, 3)
    if problems:
        raise AssertionError(f"docs check: {problems}")
    published, pub_seconds = bench_published(main_eng, closure_eng)
    seconds.update(pub_seconds)
    launches = read_counts(counters)
    launches["label_join_gather"] = lj.GATHER_LAUNCHES

    for name, doc in docs.items():
        if doc["env"]["device"] != "cuda":
            raise AssertionError(f"BENCH_{name}: ran on {doc['env']}")
    fallbacks = [r["pool_fallback"] for r in docs["construction"]["results"]]
    if any(fallbacks):
        raise AssertionError(f"bench_construction pool_fallback {fallbacks}")
    for name, n in launches.items():
        if n < 1:
            raise AssertionError(f"bench_path launched {name} no time")
    kernel_rows = {k: docs["kernels"][k] for k in
                   ("label_join", "maxmin_matmul", "overlap",
                    "threshold_step")}
    kernel_rows.update({f"{k}.published": published[k] for k in (
        "kernels_bench.label_join.WA", "kernels_bench.overlap.PS",
        "kernels_bench.threshold_step.PS")})
    emit({"phase": "bench_path", "seconds_by_script": seconds,
          "launches": launches, "rows": [list(r) for r in rows],
          "published_rows": (published["exp1.WA"]
                             + published["kernels_bench.closure.PS"]),
          "kernels_bench": {k: {f: v.get(f) for f in (
              "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
              "roofline", "shape", "m", "batch_q", "graph",
              "torch_ops_snapshot_batch_us", "host_merge_join_batch_us")}
              for k, v in kernel_rows.items()},
          "serving": {"quick": docs["serving"]["backends"],
                      "published": [published["bench_serving.WA"],
                                    published["bench_serving.PS"]]},
          "service_scale_grid": [{k: c[k] for k in (
              "tenants", "replicas", "priority_mix", "qps",
              "fairness_ratio", "p99_s_by_priority")}
              for c in docs["service_scale"]["grid"]],
          "workloads": docs["workloads"]["mr_set_kernel_vs_host"],
          "persistence": docs["persistence"]["results"],
          "maintenance": docs["maintenance"]["sharded_results"],
          "construction": docs["construction"]["results"],
          "sharded": docs["sharded"]["results"],
          "examples": {k: {f: v for f, v in ex.items()
                           if f not in ("first20", "witnesses")}
                       for k, ex in examples.items()},
          "docs_check": "ok", "seconds": clock.seconds()})
    return launches


def dryrun_kernel_rows(cd, mm, ov, tc, launches, maxmin_launches, device):
    """Each dense kernel at the dry-run's production shapes: kernel ms
    (CUDA events, one launch a run, median of three), the plain version
    where one card holds it, the library call where there is one, the
    bound, and the whole output held to the plain (or library) answer.
    Operands: random float32 for ``maxmin_matmul``, random 0/1 bf16 for
    ``threshold_step``, the dry-run's own incidence for ``overlap``.
    ``launches`` are the phase's counts, ``maxmin_launches`` each maxmin
    round's as its record measured them; these launches come after the
    phase's counted window."""
    dev = device
    gen = torch.Generator(device=dev)
    gen.manual_seed(71)
    m, blk = DRYRUN_M, DRYRUN_M // 16
    rows, errs = {}, {}

    for sched, (rm, k, n) in (("allgather", (blk, m, blk)),
                              ("ring", (blk, blk, blk))):
        count = maxmin_launches[sched]
        a = torch.rand((rm, k), generator=gen, device=dev)
        b = torch.rand((k, n), generator=gen, device=dev)
        plain_ms, want = cuda_once(lambda: mm.maxmin_matmul_ref(a, b,
                                                                block=128))
        err = float((mm.maxmin_matmul(a, b) - want).abs().max())
        bound_ms, bound_by = maxmin_bound(rm, k, n)
        ms = cuda_ms(lambda: mm.maxmin_matmul(a, b), reps=1, warmup=1)
        rows[f"maxmin_matmul float32 [{rm}, {k}] x [{k}, {n}] ({sched})"] = {
            "launches": count, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "max_abs_err": err}
        errs["maxmin_matmul"] = max(errs.get("maxmin_matmul", 0.0), err)
        del a, b, want

    r = (torch.rand((1, m, m), generator=gen, device=dev,
                    dtype=torch.bfloat16) < 0.5).to(torch.bfloat16)
    got = tc.threshold_step(r)
    plain_ms, want = cuda_once(lambda: tc.threshold_step_ref(r))
    err = float((got != want).any())     # 0/1 values: the max abs err
    del got, want
    bound_ms, bound_by = threshold_bound(1, m, 2)
    rows[f"threshold_step bf16 [1, {m}, {m}]"] = {
        "launches": launches["threshold_step"],
        "ms": cuda_ms(lambda: tc.threshold_step(r), reps=1, warmup=1),
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bf16_ceiling_ms": bf16_ceiling_ms(2.0 * m ** 3),
        "library_ms": cuda_ms(lambda: torch.bmm(r, r), reps=1, warmup=1),
        "library": "torch.bmm(R, R) bf16", "max_abs_err": err}
    errs["threshold_step"] = err
    del r
    torch.cuda.empty_cache()

    from repro_torch.core.hypergraph import random_hypergraph
    params = cd.dryrun_graph_params(m)
    b_inc = cd.incidence(random_hypergraph(**params), dev)
    n = b_inc.shape[1]
    want = torch.matmul(b_inc, b_inc.T)      # bf16: exact, overlaps <= 8
    err = float((ov.overlap(b_inc) - want.float()).abs().max())
    del want
    bound_ms, bound_by = overlap_bound(m, n, 2)
    rows[f"overlap bf16 B [{m}, {n}]"] = {
        "launches": launches["overlap"],
        "ms": cuda_ms(lambda: ov.overlap(b_inc), reps=1, warmup=1),
        # the plain version's float32 operand and product are 40 GB here
        "plain_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
        "bf16_ceiling_ms": bf16_ceiling_ms(2.0 * m * m * n),
        "library_ms": cuda_ms(lambda: torch.matmul(b_inc, b_inc.T), reps=1,
                              warmup=1),
        "library": "torch.matmul(B, B.T) bf16", "max_abs_err": err}
    errs["overlap"] = err
    del b_inc
    torch.cuda.empty_cache()
    return rows, errs


def phase_dryrun_path(counters, mm, ov, tc, device):
    """The closure dry-run at m = ``DRYRUN_RUN_M`` (16,384: a quarter of
    the paper's 65,536, for the script's time; ``repro_torch.launch.
    closure_dryrun.main``, in process): eight records under
    ``build/dryrun_core``, each cell's analytic terms priced at H100
    rates and the four device computations run once on the card (one
    ``overlap`` for W, 256 + 4,096 float32 ``maxmin_matmul`` launches for
    the allgather and ring rounds, 32 + 6 ``threshold_step`` slices),
    64 x 64 sampled entries of every output held to the plain version
    (error 0).  Counts are set to 0 just before ``main`` and read just
    after.  Then each kernel at the production shapes (m = 65,536), timed
    beside its bound and library call (``dryrun_kernel_rows``).  Returns
    (launches, rows, errs)."""
    from repro_torch.launch import closure_dryrun as cd
    clock = Phase()
    reset_counts(counters)
    records = cd.main(["--out", str(DRYRUN_OUT), "--m", str(DRYRUN_RUN_M),
                       "--S", str(DRYRUN_S), "--device", device.type])
    launches = read_counts(counters)
    torch.cuda.empty_cache()
    run_seconds = clock.seconds()
    n_boolean = sum(len(cd.thresholds_of(kind, DRYRUN_S))
                    for kind in ("threshold", "bisection"))
    want = {"label_join": 0, "maxmin_matmul": 16 * 16 + 16 ** 3,
            "overlap": 1, "threshold_step": n_boolean}
    if launches != want:
        raise AssertionError(f"dryrun_path: launches {launches}, "
                             f"expected {want}")
    tags = [cd.cell_tag(*cell) for cell in cd.CELLS]
    files = sorted(p.stem for p in DRYRUN_OUT.glob("*.json"))
    if files != sorted(tags):
        raise AssertionError(f"dryrun_path: records {files}")
    cells = {}
    for tag, rec in zip(tags, records):
        if rec["status"] != "ok":
            raise AssertionError(f"dryrun_path {tag}: {rec['error']}")
        if rec["run_s"] is None or rec["max_abs_err"] != 0.0:
            raise AssertionError(f"dryrun_path {tag}: run_s "
                                 f"{rec['run_s']}, err {rec['max_abs_err']}")
        cells[tag] = {k: rec[k] for k in (
            "n_devices", "flops_analytic", "hbm_bytes", "t_compute_s",
            "t_memory_s", "t_collective_s", "dominant", "mfu_bound",
            "run_s", "run_bound_s", "peak_bytes", "max_abs_err", "run_of",
            "launches")}
        if "slice_s" in rec:             # the boolean runs, slice by slice
            cells[tag]["slice_s"] = rec["slice_s"]
        cells[tag]["run_over_bound"] = rec["run_s"] / rec["run_bound_s"]
        cells[tag]["collective_bytes"] = rec["collective_executed"][
            "total_bytes"]
    # each maxmin round's own count, as its record measured it: r * c
    # launches on allgather, r * c * r on ring
    maxmin_launches = {rec["schedule"]: rec["launches"].get(
        "maxmin_matmul", 0) for rec in records if rec["kind"] == "maxmin"}
    if maxmin_launches != {"allgather": 16 * 16, "ring": 16 ** 3}:
        raise AssertionError(f"dryrun_path: maxmin launches by schedule "
                             f"{maxmin_launches}")
    rows, errs = dryrun_kernel_rows(cd, mm, ov, tc, launches,
                                    maxmin_launches, device)
    emit({"phase": "dryrun_path", "m": DRYRUN_RUN_M, "S": DRYRUN_S,
          "reduced": [f"m: {DRYRUN_M} cut to {DRYRUN_RUN_M} for the cells "
                      f"and their rounds (the script's time limit); the "
                      f"kernel rows stay at m = {DRYRUN_M}"],
          "kernel_rows_m": DRYRUN_M,
          "data": records[0]["data"], "cells": cells, "launches": launches,
          "kernel_rows": rows, "run_seconds": run_seconds,
          "seconds": clock.seconds()})
    return launches, rows, errs


def teacher_forced(model, tokens, compute_dtype, cache_dtype, frames=None):
    """(decode logits along ``tokens``, the full forward's logits), both
    float32 [B, S, V] and computed in ``compute_dtype`` (the model's
    config is swapped for the call only), the decode through a cache of
    ``cache_dtype``; an encdec model takes ``frames`` in its forward and
    in ``prefill_cross`` before the decode."""
    import dataclasses
    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    extra = () if frames is None else (frames,)
    try:
        with torch.no_grad():
            full, _ = model.apply(tokens, *extra)
            full = full.float()
            cache = model.init_cache(tokens.shape[0], tokens.shape[1],
                                     dtype=cache_dtype)
            if frames is not None:
                cache = model.prefill_cross(cache, frames)
            steps = []
            for t in range(tokens.shape[1]):
                lg, cache = model.decode_step(cache, tokens[:, t:t + 1], t)
                steps.append(lg[:, 0].float())
            del cache
    finally:
        model.cfg = cfg
    return torch.stack(steps, 1), full


def decode_checks(model, tokens, frames=None):
    """The teacher-forced decode checks along ``tokens``.  Float32
    compute and cache: decode against forward at the reference's
    ``_DECODE_TOL`` (the reference's own check, which it runs on 2-layer
    smoke configs).  The config's bf16 with the served bf16 cache: the
    decode's root-mean-square departure from the float32 forward against
    the bf16 forward's own, at most ``BF16_DEPARTURE_RATIO`` times it (a
    bf16 fault, such as a cast in the wrong place or a wrong cache write,
    puts the decode far past the forward's rounding).  Raises on either;
    returns the readings."""
    dec32, fwd32 = teacher_forced(model, tokens, "float32", torch.float32,
                                  frames)
    diff = (dec32 - fwd32).abs()
    excess = float((diff - (DECODE_TOL["atol"] + DECODE_TOL["rtol"]
                            * fwd32.abs())).max())
    out = {"decode_vs_forward_max_abs_diff": float(diff.max()),
           "decode_vs_forward_excess": excess}
    del dec32, diff
    dec16, fwd16 = teacher_forced(model, tokens, model.cfg.compute_dtype,
                                  torch.bfloat16, frames)
    dec_dep, fwd_dep = dec16 - fwd32, fwd16 - fwd32
    out.update(
        bf16_decode_rms_departure=float(dec_dep.pow(2).mean().sqrt()),
        bf16_forward_rms_departure=float(fwd_dep.pow(2).mean().sqrt()),
        bf16_decode_max_departure=float(dec_dep.abs().max()),
        bf16_forward_max_departure=float(fwd_dep.abs().max()),
        bf16_decode_vs_forward_max_abs_diff=float((dec16 - fwd16).abs()
                                                  .max()))
    out["bf16_departure_ratio"] = (out["bf16_decode_rms_departure"]
                                   / out["bf16_forward_rms_departure"])
    name = model.cfg.name
    if not excess <= 0.0:
        raise AssertionError(
            f"lm_serve_path {name}: float32 decode logits differ from the "
            f"forward's by {out['decode_vs_forward_max_abs_diff']} (over "
            f"_DECODE_TOL by {excess})")
    if not out["bf16_departure_ratio"] <= BF16_DEPARTURE_RATIO:
        raise AssertionError(
            f"lm_serve_path {name}: the bf16 decode departs from the "
            f"float32 forward {out['bf16_departure_ratio']} times as far "
            f"as the bf16 forward (limit {BF16_DEPARTURE_RATIO})")
    return out


def lm_serve_run(lserve, cfg, reduced, device):
    """One model through ``launch/serve.py``'s path on the card: seeded
    weights, ``LM_BATCH`` prompts of ``LM_PROMPT`` tokens prefilled, then
    ``LM_GEN`` greedy tokens (bf16 cache, as the launcher), then the
    teacher-forced checks along the served stream (``decode_checks``)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lserve.build(cfg, seed=0, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    res = lserve.serve(model, batch=LM_BATCH, prompt_len=LM_PROMPT,
                       gen=LM_GEN, seed=0)
    toks = res["tokens"]
    if toks.shape != (LM_BATCH, LM_GEN) or toks.min() < 0 \
            or toks.max() >= cfg.vocab:
        raise AssertionError(f"lm_serve_path {cfg.name}: tokens {toks}")
    stream = torch.from_numpy(np.concatenate(
        [res["prompts"], toks], axis=1)).to(device)
    serve_peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    checks = decode_checks(model, stream, res["frames"])
    check_s = time.perf_counter() - t0
    out = {"arch": cfg.name, "family": cfg.family, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab,
           "compute_dtype": cfg.compute_dtype, "reduced": reduced,
           "params": sum(p.numel() for p in model.parameters()),
           "config_n_params": cfg.n_params(),
           "batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_GEN,
           "build_s": build_s, "prefill_ms": res["prefill_s"] * 1e3,
           "decode_ms": res["decode_s"] * 1e3,
           "decode_ms_per_token": res["decode_s"] * 1e3 / LM_GEN,
           "tokens_per_s": res["tokens_per_s"],
           "sample_tokens": toks[0][:8].tolist(), **checks,
           "check_s": check_s, "serve_peak_bytes": serve_peak,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    if res["frames"] is not None:
        out["frames_shape"] = list(res["frames"].shape)
    del model, res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_lm_serve_path(counters, device):
    """LM serving through ``repro_torch.launch.serve`` (``build`` +
    ``serve``: prefill through the cache, greedy decode) on the card:
    ``qwen3-1.7b``, ``qwen2-moe-a2.7b`` (``moe_apply``, 60 experts,
    top-4), ``falcon-mamba-7b``, ``recurrentgemma-2b`` and
    ``whisper-large-v3`` at their published widths, each on the depth
    ``LM_SERVE_LAYERS`` (``LM_MOE_LAYERS``) gives it (Whisper's
    seeded frames encoded into the cross K/V by ``prefill_cross`` in the
    prefill).  At prompt 16 + 8 tokens the hybrid's 2,048 window never
    wraps here; the CPU tests cover the wrap.  Each run serves in the
    config's bf16 and is held
    to its own forward along the served stream by ``decode_checks``: the
    reference's teacher-forced check at ``_DECODE_TOL`` in float32, and
    the bf16 decode's departure from the float32 forward against the
    bf16 forward's.  The LM path reaches none of the port's kernels:
    their counts stay 0."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as lserve
    clock = Phase()
    reset_counts(counters)
    def cut(arch):
        cfg, layers = get_config(arch), LM_SERVE_LAYERS[arch]
        names = ("n_layers", "enc_layers") if cfg.enc_layers else (
            "n_layers",)
        return (dataclasses.replace(cfg, **dict.fromkeys(names, layers)),
                [f"{', '.join(names)}: {cfg.n_layers} cut to {layers}"])
    runs = [lm_serve_run(lserve, *cut(LM_ARCH), device)]
    moe = dataclasses.replace(get_config(LM_MOE_ARCH),
                              n_layers=LM_MOE_LAYERS)
    runs.append(lm_serve_run(lserve, moe, [
        f"n_layers: 24 cut to {LM_MOE_LAYERS}"], device))
    for arch in LM_FAMILY_ARCHS:
        runs.append(lm_serve_run(lserve, *cut(arch), device))
    launches = read_counts(counters)
    if any(launches.values()):
        raise AssertionError(f"lm_serve_path launched kernels {launches}")
    for run in runs:
        print(f"lm_serve {run['arch']}: prefill {run['prefill_ms']:.1f} ms"
              f"   decode {run['decode_ms_per_token']:.2f} ms a token "
              f"({run['tokens_per_s']:.1f} tok/s), peak "
              f"{run['peak_bytes']} B", flush=True)
    emit({"phase": "lm_serve_path", "runs": runs,
          "seconds": clock.seconds()})
    return runs


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def lm_train_run(ltrain, cfg, device):
    """``run_training`` on ``cfg`` at ``LM_TRAIN_BATCH`` x ``LM_TRAIN_SEQ``
    for ``LM_TRAIN_STEPS`` steps on the card, checkpointing at the end into
    a temporary directory (removed after); the loss must stay finite and
    the mean of its last 5 values fall below that of its first 5."""
    import signal
    tmp = tempfile.mkdtemp(prefix="lm_train_")
    sigterm = signal.getsignal(signal.SIGTERM)   # the supervisor takes it
    try:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step, params, opt, log = ltrain.run_training(
            cfg, steps=LM_TRAIN_STEPS, batch=LM_TRAIN_BATCH,
            seq=LM_TRAIN_SEQ, ckpt_dir=tmp, ckpt_every=LM_TRAIN_STEPS,
            seed=0, device=device)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        n_params = sum(p.numel() for p in params.values())
        ckpt_bytes = dir_bytes(tmp)
        del params, opt
    finally:
        signal.signal(signal.SIGTERM, sigterm)
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    losses = [m["loss"] for m in log]
    step_s = [m["step_time_s"] for m in log]
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if step != LM_TRAIN_STEPS or not np.isfinite(losses).all() \
            or not last < first:
        raise AssertionError(f"lm_train_path {cfg.name}: step {step}, "
                             f"losses {losses}")
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    steady = statistics.median(step_s[1:])
    return {"arch": cfg.name, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "vocab": cfg.vocab, "params": n_params,
            "config_n_params": cfg.n_params(), "batch": LM_TRAIN_BATCH,
            "seq": LM_TRAIN_SEQ, "microbatch": cfg.microbatch,
            "remat": cfg.remat, "remat_policy": cfg.remat_policy,
            "steps": step, "losses": losses,
            "loss_first5": first, "loss_last5": last,
            "grad_norms": [m["grad_norm"] for m in log],
            "step_s": step_s, "first_step_s": step_s[0],
            "median_step_s": steady, "tokens_per_s": tokens / steady,
            "model_flops_per_s": 6 * n_params * tokens / steady,
            "wall_s": wall_s, "ckpt_bytes": ckpt_bytes, "peak_bytes": peak,
            "straggler_events": [m["step"] for m in log
                                 if m["step_time_s"] > 3 * steady]}


def lm_restart_check(cfg, device):
    """The reference's ``test_restart_resumes_identically`` at ``cfg``'s
    widths under ``torch.use_deterministic_algorithms``: a supervised run
    to ``LM_RESTART_AT`` that checkpoints there, then on to
    ``LM_RESTART_STEPS`` by the same step function; a model drawn from
    another seed is resumed by a supervisor from that checkpoint
    (``resume_or_init``) and run on over the same stream by the same
    step function (no checkpoint at its end since the MoE and VLM train
    rank cells came: a second 8.7 GB write, for the script's time).  Its
    parameters are held to the uninterrupted run's at ``RESTART_TOL``.
    The checkpoint at the break goes to a temporary directory, removed
    after."""
    from repro_torch.models import build_model
    from repro_torch.train import (AdamConfig, SupervisorConfig,
                                   SyntheticStream, TrainSupervisor,
                                   adam_init, make_train_step, model_params)

    class TimedSupervisor(TrainSupervisor):
        save_s: list

        def _save(self, step, params, opt_state):
            t0 = time.perf_counter()
            super()._save(step, params, opt_state)
            self.save_s.append(time.perf_counter() - t0)

    opt_cfg = AdamConfig(lr=3e-4, total_steps=LM_RESTART_STEPS,
                         warmup_steps=max(LM_RESTART_STEPS // 20, 1))

    def make(seed, max_steps, d):
        model = build_model(cfg, device=device)
        model.init(torch.Generator(device=device).manual_seed(seed))
        params = model_params(model)
        opt = adam_init(params, opt_cfg)
        data = iter(SyntheticStream(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                                    seed=7))
        sup = TimedSupervisor(SupervisorConfig(
            ckpt_dir=d, ckpt_every=max_steps, max_steps=max_steps,
            handle_sigterm=False), make_train_step(model, cfg, opt_cfg),
            data, async_ckpt=False)
        sup.save_s = []
        return params, opt, sup, data

    tmp = tempfile.mkdtemp(prefix="lm_restart_")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        params, opt, sup, data = make(0, LM_RESTART_AT, tmp)
        _, params, opt, log_full = sup.run(params, opt)
        losses_full = [m["loss"] for m in log_full]
        for _ in range(LM_RESTART_STEPS - LM_RESTART_AT):
            params, opt, m = sup.train_step(params, opt, next(data))
            losses_full.append(float(m["loss"]))
        full = {k: v.detach().clone() for k, v in params.items()}
        saves = list(sup.save_s)
        ckpt_bytes = dir_bytes(tmp)
        del params, opt, sup
        gc.collect()
        torch.cuda.empty_cache()
        params, opt, sup, data = make(1, LM_RESTART_STEPS, tmp)
        for _ in range(LM_RESTART_AT):
            next(data)                   # stream position after the save
        t0 = time.perf_counter()
        start, params, opt = sup.resume_or_init(params, opt)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if start != LM_RESTART_AT:
            raise AssertionError(f"lm_train_path restart: resumed from "
                                 f"step {start}")
        log_res = []
        for _ in range(LM_RESTART_STEPS - start):
            params, opt, m = sup.train_step(params, opt, next(data))
            log_res.append({"loss": float(m["loss"])})
        p_res = params
        worst, excess = 0.0, -math.inf
        for k, want in full.items():
            diff = (p_res[k].detach() - want).abs()
            worst = max(worst, float(diff.max()))
            excess = max(excess, float((diff - (RESTART_TOL["atol"]
                                                + RESTART_TOL["rtol"]
                                                * want.abs())).max()))
        del params, opt, p_res, full, sup
    finally:
        torch.use_deterministic_algorithms(was)
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    out = {"layers": cfg.n_layers, "steps": LM_RESTART_STEPS,
           "checkpoint_at": LM_RESTART_AT, "deterministic": True,
           "max_abs_diff": worst, "excess_over_tolerance": excess,
           "tolerance": RESTART_TOL, "losses_full": losses_full,
           "losses_resumed": [m["loss"] for m in log_res],
           "ckpt_bytes": ckpt_bytes, "save_s": saves,
           "restore_s": restore_s}
    print(f"lm_train restart: max |diff| {worst} (excess over rtol 1e-5, "
          f"atol 1e-6: {excess}), checkpoint {ckpt_bytes} B, saves "
          f"{[round(x, 3) for x in saves]} s, restore {restore_s:.3f} s",
          flush=True)
    if not excess <= 0.0:
        raise AssertionError(f"lm_train_path restart: resumed parameters "
                             f"differ by {worst} (over the tolerance by "
                             f"{excess})")
    return out


def phase_lm_train_path(counters, device):
    """LM training through ``repro_torch.launch.train.run_training`` on
    the card: ``qwen3-1.7b`` at its published widths on
    ``LM_TRAIN_RUN_LAYERS`` of its 28 layers (float32 master weights and
    AdamW moments, bf16 compute, the config's microbatches and block
    remat), then the restart check at its widths
    on ``LM_RESTART_LAYERS`` layers.  No kernel of the port is on this
    path: the counts stay 0."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import train as ltrain
    clock = Phase()
    reset_counts(counters)
    cfg = dataclasses.replace(get_config(LM_ARCH),
                              n_layers=LM_TRAIN_RUN_LAYERS)
    run = lm_train_run(ltrain, cfg, device)
    run["reduced"] = [f"n_layers: 28 cut to {LM_TRAIN_RUN_LAYERS}"]
    print(f"lm_train {run['arch']}: {run['median_step_s']:.3f} s a step "
          f"({run['tokens_per_s']:.0f} tok/s), loss {run['loss_first5']:.3f}"
          f" -> {run['loss_last5']:.3f}, peak {run['peak_bytes']} B",
          flush=True)
    small = dataclasses.replace(cfg, n_layers=LM_RESTART_LAYERS)
    restart = lm_restart_check(small, device)
    restart["reduced"] = [f"n_layers: 28 cut to {LM_RESTART_LAYERS}"]
    launches = read_counts(counters)
    if any(launches.values()):
        raise AssertionError(f"lm_train_path launched kernels {launches}")
    emit({"phase": "lm_train_path", "run": run, "restart": restart,
          "launches": launches, "seconds": clock.seconds()})
    return run, restart


def lm_dryrun_summary(records, rows):
    """The dry-run's counts by status and the roofline of its ``ok``
    cells, by mesh: each cell's dominant term and the lowest and highest
    ``mfu_bound``."""
    status = {}
    for rec in records:
        status[rec["status"]] = status.get(rec["status"], 0) + 1
    out = {"records": len(records), "status": status}
    for mesh, mesh_rows in rows.items():
        mfu = [r["mfu_bound"] for r in mesh_rows]
        dominant = {}
        for r in mesh_rows:
            dominant[r["dominant"]] = dominant.get(r["dominant"], 0) + 1
        out[mesh] = {
            "cells": len(mesh_rows), "dominant_counts": dominant,
            "dominant": {f"{r['arch']} {r['shape']}": r["dominant"]
                         for r in mesh_rows},
            "mfu_bound_min": min(mfu), "mfu_bound_max": max(mfu),
            "mfu_bound_min_cell": min(
                mesh_rows, key=lambda r: r["mfu_bound"])["arch"],
            "mfu_bound_max_cell": max(
                mesh_rows, key=lambda r: r["mfu_bound"])["arch"]}
    return out


def lm_cell(name, seq):
    """The shape cell ``name`` at ``seq`` tokens (``LM_DRYRUN_RUNS``,
    ``LM_RANK_CELLS``)."""
    import dataclasses
    from repro_torch.launch.shapes import SHAPES
    return dataclasses.replace(SHAPES[name], seq_len=seq)


def lm_rank_cell(name, seq, mesh_shape):
    """A rank cell's shape (``LM_RANK_CELLS``) on the cell mesh
    ``mesh_shape``: ``lm_cell``, a train cell at ``LM_RANK_TRAIN_BATCH``
    rows a data coordinate (what one device of its production mesh
    trains)."""
    import dataclasses
    cell = lm_cell(name, seq)
    if cell.kind == "train":
        cell = dataclasses.replace(
            cell, global_batch=LM_RANK_TRAIN_BATCH * mesh_shape[0])
    return cell


def save_sample(path, sample):
    """A training run's ``sample`` (``dryrun.run_cell``) as one ``.npz``."""
    arrays = {k: np.asarray(sample[k]) for k in ("loss", "grad_norm")}
    for part in ("params", "m"):
        for name, (idx, val) in sample[part].items():
            arrays[f"{part}/{name}/idx"] = idx
            arrays[f"{part}/{name}/val"] = val
    np.savez(path, **arrays)


def load_sample(path):
    """``save_sample``'s sample back."""
    with np.load(path) as f:
        out = {k: f[k].tolist() for k in ("loss", "grad_norm")}
        for part in ("params", "m"):
            out[part] = {}
            for key in f.files:
                if key.startswith(part + "/") and key.endswith("/idx"):
                    name = key[len(part) + 1:-len("/idx")]
                    out[part][name] = (f[key], f[f"{part}/{name}/val"])
    return out


def lm_rank_grid(mesh_shape):
    """The (data, model) grid of ``RANK_WORLD`` ranks a rank cell runs on:
    the cell's model axis, the rest of the world over data."""
    return RANK_WORLD // mesh_shape[-1], mesh_shape[-1]


class RoutingTape:
    """Each MoE layer's experts a token (``[t, top_k]`` int64), in call
    order, from the router's top-k in a run's ``moe_apply`` calls under
    autograd (a training step's forward and remat recompute): recorded
    (the same softmax and top-k of the same router logits as
    ``moe_apply`` takes, so the same choice), or, given ``replay``, fed
    to another run's calls in place of their own top-k (the gates read
    from that run's probabilities at those experts), counting in
    ``flips`` the tokens whose own top-k differs."""

    def __init__(self, replay=None):
        self.calls = [] if replay is None else list(replay)
        self.replay = replay is not None
        self.at = 0
        self.flips = 0

    @contextlib.contextmanager
    def on(self, layers):
        moe_apply, topk = layers.moe_apply, torch.topk

        def forced(probs, k, dim=-1):
            # the call's one top-k, the router's; later calls are torch's
            torch.topk = topk
            want = torch.as_tensor(self.calls[self.at], device=probs.device)
            self.at += 1
            own = topk(probs, k, dim=dim).indices
            self.flips += int((own.sort(dim=-1).values
                               != want.sort(dim=-1).values).any(-1).sum())
            return probs.gather(dim, want), want

        def routed(p, cfg, x):
            if not torch.is_grad_enabled():
                return moe_apply(p, cfg, x)
            if not self.replay:
                with torch.no_grad():
                    probs = torch.softmax(layers.dense_apply(
                        p.router, x.reshape(-1, x.shape[-1]).float()),
                        dim=-1)
                    self.calls.append(topk(probs, cfg.top_k, dim=-1)
                                      .indices.cpu().numpy())
                return moe_apply(p, cfg, x)
            torch.topk = forced
            try:
                return moe_apply(p, cfg, x)
            finally:
                torch.topk = topk
        layers.moe_apply = routed
        try:
            yield self
        finally:
            layers.moe_apply = moe_apply


def routed_key(key, over):
    """The one-process float32 step a ``ROUTED_TRAIN_LABELS`` cell is held
    to: ``key``'s run (``lm_reference_key``) routed as its expert
    layout's float32 ranks."""
    return key[:4] + ("float32",) + key[5:] + (
        "routed", over.get("expert_sharding", ""))


def lm_rank_worker(rank, world, work, spec):
    """One rank of ``lm_dryrun_path``'s rank cells (a spawned process):
    each cell's ``lm_rank_grid`` ``ProcessMesh`` on the shared card (made
    once, in the cells' order), then each of ``LM_RANK_CELLS`` through
    ``lower_cell(..., run=True, ranks=pm)`` (the
    rank's blocks drawn from the one-process model's generator, its rows
    and cache slots; a warm-up and ``LM_DRYRUN_RUN_REPS`` timed passes).
    Writes ``rank<r>.json`` (the records, by the cell's place in
    ``LM_RANK_CELLS``) and each cell's gathered logits into ``work``; rank
    0 also each float32 ``ROUTED_TRAIN_LABELS`` cell's routing
    (``RoutingTape``, ``routes-<i>.npz``)."""
    import datetime
    import torch.distributed as tdist
    from repro_torch import api
    from repro_torch.launch import dryrun
    from repro_torch.models import layers

    device = torch.device(spec["device"])
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": rank, "cells": {}}
    tdist.init_process_group(
        "gloo", init_method="file://" + os.path.join(work, "init"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=spec["timeout"]))
    try:
        # device=None: cuda:0 under gloo (every rank on the one card)
        meshes = {}
        for cell in LM_RANK_CELLS:
            grid = lm_rank_grid(cell[5])
            if grid not in meshes:
                meshes[grid] = api.make_process_mesh(
                    grid, ("data", "model"),
                    device=None if device.type == "cuda" else device)
        for i, (label, arch, over, name, seq, mesh_shape, _) in enumerate(
                LM_RANK_CELLS):
            pm = meshes[lm_rank_grid(mesh_shape)]
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            logits, sample = [], []
            routed = (label in ROUTED_TRAIN_LABELS
                      and over.get("compute_dtype") == "float32")
            tape = RoutingTape()
            t0 = time.perf_counter()
            with tape.on(layers) if routed else contextlib.nullcontext():
                rec = dryrun.lower_cell(
                    arch, lm_rank_cell(name, seq, mesh_shape),
                    mesh_shape=mesh_shape,
                    overrides=over or None, device=device, run=True,
                    run_reps=LM_DRYRUN_RUN_REPS, ranks=pm, logits=logits,
                    sample=sample)
            rec["cell_s"] = time.perf_counter() - t0
            if routed and rank == 0:
                np.savez(os.path.join(work, f"routes-{i}.npz"), *tape.calls)
            if sample:
                save_sample(os.path.join(work, f"sample-{i}-{rank}.npz"),
                            sample[0])
            else:
                np.save(os.path.join(work, f"logits-{i}-{rank}.npy"),
                        logits[0].numpy())
            out["cells"][str(i)] = rec
    finally:
        tdist.destroy_process_group()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def rms(t):
    return float(t.double().pow(2).mean().sqrt())


def train_cell_checks(tag, samples, f32, bf16, dtype):
    """A train rank cell's ``samples`` (one a rank: ``dryrun.run_cell``'s
    loss and gradient norm of each pass and ``whole_sample`` of the new
    parameters and first moments, the rank's entries) against the
    one-process float32 and bf16 steps' whole samples.  The ranks' entries
    must tile each whole sample.  In float32 compute: each pass's loss and
    gradient norm on every rank and each rank's sampled parameters at
    ``TRAIN_TOL`` of the one-process float32 step, and its sampled first
    moments within ``TRAIN_MOMENT_RMS`` of theirs by root-mean-square
    (relative).  The sampled parameters' root-mean-square departure from
    the one-process float32 step, against the one-process bf16 step's;
    in bf16 their ratio is at most ``BF16_DEPARTURE_RATIO``.  Returns the
    numbers."""
    def at(whole, idx):
        pos = np.searchsorted(whole[0], idx)
        if not np.array_equal(whole[0][np.minimum(pos, len(whole[0]) - 1)],
                              idx):
            raise AssertionError(f"{tag}: a rank sampled entries the whole "
                                 f"sample lacks")
        return whole[1][pos]

    def rms_np(a):
        return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))

    for r, smp in enumerate(samples):
        empty = [k for k, (idx, _) in smp["params"].items() if not idx.size]
        if empty:
            raise AssertionError(f"{tag}: rank {r} sampled no entry of "
                                 f"{empty}")
    # a ZeRO-1 rank samples the moments it holds: together the ranks'
    # entries cover each whole sample
    for name, (idx, _) in f32["m"].items():
        covered = np.zeros(idx.shape, bool)
        for smp in samples:
            if name in smp["m"]:
                got = smp["m"][name][0]
                at(f32["m"][name], got)    # entries of the whole sample only
                covered[np.searchsorted(idx, got)] = True
        if not covered.all():
            raise AssertionError(f"{tag}: the ranks' first moments of {name} "
                                 f"do not cover the whole sample")

    moment_rel = 0.0
    if dtype == "float32":
        for r, smp in enumerate(samples):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(smp[k], f32[k], **TRAIN_TOL,
                                           err_msg=f"{tag}: rank {r} {k}")
            for name, (idx, val) in smp["params"].items():
                np.testing.assert_allclose(
                    val, at(f32["params"][name], idx), **TRAIN_TOL,
                    err_msg=f"{tag}: rank {r} parameter {name}")
            for name, (idx, val) in smp["m"].items():
                want = at(f32["m"][name], idx)
                scale = rms_np(want)
                # a sample the step leaves at zero (embedding rows of
                # tokens no rank drew) must be zero on the rank too
                rel = (rms_np(val - want) / scale if scale else
                       math.inf if np.abs(val).max(initial=0.0) > 0
                       else 0.0)
                moment_rel = max(moment_rel, rel)
                if not rel <= TRAIN_MOMENT_RMS:
                    raise AssertionError(
                        f"{tag}: rank {r}'s first moment of {name} departs "
                        f"{rel} of its root-mean-square from the one-process "
                        f"float32 step's (limit {TRAIN_MOMENT_RMS})")
    # the ranks' entries joined into each whole sample
    joined, want32, want16 = [], [], []
    for name, (idx, val32) in f32["params"].items():
        vals = np.full(val32.shape, np.nan, np.float32)
        for smp in samples:
            idx_r, val_r = smp["params"][name]
            vals[np.searchsorted(idx, idx_r)] = val_r
        if np.isnan(vals).any():
            raise AssertionError(f"{tag}: the ranks' samples of {name} do "
                                 f"not tile the whole sample")
        joined.append(vals)
        want32.append(val32)
        want16.append(at(bf16["params"][name], idx))
    joined, want32, want16 = (np.concatenate(a) for a in (joined, want32,
                                                          want16))
    ranks_dep, one_dep = rms_np(joined - want32), rms_np(want16 - want32)
    ratio = ranks_dep / one_dep
    if dtype == "bfloat16" and not ratio <= BF16_DEPARTURE_RATIO:
        raise AssertionError(
            f"{tag}: the ranks' bf16 step departs from the float32 step "
            f"{ratio} times as far as the one-process bf16 step (limit "
            f"{BF16_DEPARTURE_RATIO})")
    return {"rms_departure": (ranks_dep, one_dep), "departure_ratio": ratio,
            "loss": samples[0]["loss"], "grad_norm": samples[0]["grad_norm"],
            "loss_one_process": {"float32": f32["loss"],
                                 "bfloat16": bf16["loss"]},
            "grad_norm_one_process": {"float32": f32["grad_norm"],
                                      "bfloat16": bf16["grad_norm"]},
            "moment_rms_departure": moment_rel if dtype == "float32"
            else None, "sampled_entries": int(joined.size)}


def lm_reference_key(arch, over, name, seq, dtype, rows):
    """The one-process run of ``rows`` rows a rank cell is held to: the
    expert layout splits nothing at model axis 1, so it is left out, and
    so is the cell's compute dtype (both one-process runs are made)."""
    kept = tuple(sorted((k, v) for k, v in over.items()
                        if k not in ("expert_sharding", "compute_dtype")))
    return arch, kept, name, seq, dtype, rows


def lm_one_process(name, seq, mesh_shape):
    """A rank cell's one-process run: its shape (``lm_rank_cell``), the
    data axis of its mesh at model axis 1 (the data rows the ranks' data
    axis covers, which one process runs) and its rows."""
    cell = lm_rank_cell(name, seq, mesh_shape)
    data = mesh_shape[0] // lm_rank_grid(mesh_shape)[0]
    return cell, data, -(-cell.global_batch // data)


def lm_rank_cells(dryrun, device, one):
    """``LM_RANK_CELLS`` on ``RANK_WORLD`` spawned ranks
    (``lm_rank_worker``), each held to its one-process run at model axis
    1 (same weights from seed 0, batch and cache from seed 1, same
    ``run_batch``): the parent runs the cell in float32 compute and in the
    published bf16 (``one`` holds the runs it has already made, by
    ``lm_reference_key``: (record, logits)), and the ranks' gathered
    logits must depart from the float32 logits by at most
    ``BF16_DEPARTURE_RATIO`` times the one-process bf16 run's
    root-mean-square departure.  A train cell (the step from zero
    moments: a warm-up and the timed pass) is held by
    ``train_cell_checks`` instead: its float32 run to the one-process
    float32 step (loss, gradient norm, sampled parameters and first
    moments), its bf16 run by the same departure gate over the sampled
    parameters; a ``ROUTED_TRAIN_LABELS`` cell's one-process float32 step
    runs after the ranks, on their routing (``RoutingTape``).  Also held:
    the gathered logits byte-equal on every rank, each rank's peak under
    ``2 / (d x k)`` of the one-process run's in the cell's compute
    dtype (bf16 but for the float32 train cell; ``d`` x ``k`` the ranks'
    grid: the
    one-process run covers the ranks' ``d`` data rows, and ``k`` is the
    cell's model axis), each rank's counted collectives
    equal to the closed
    form's (``dryrun.closed_form_mismatch``: the expert-parallel
    all-to-all's bytes over the model line), the run's checks (every
    all-reduced tensor and every MoE routing equal along the line among
    them).  Returns one summary a cell."""
    from repro_torch.models import layers
    clock = Phase()
    refs = dict(one)

    def one_process(key, arch, cell, data, tape=None):
        gc.collect()
        torch.cuda.empty_cache()
        logits, sample = [], []
        with tape.on(layers) if tape else contextlib.nullcontext():
            rec = dryrun.lower_cell(
                arch, cell, mesh_shape=(data, 1),
                overrides=dict(key[1], compute_dtype=key[4]), device=device,
                run=True, run_reps=LM_DRYRUN_RUN_REPS, logits=logits,
                sample=sample)
        refs[key] = (rec, sample[0] if sample else logits[0])

    for label, arch, over, name, seq, mesh_shape, _ in LM_RANK_CELLS:
        # one process runs every data row the ranks' data axis covers
        cell, data, rows = lm_one_process(name, seq, mesh_shape)
        for dtype in ("float32", "bfloat16"):
            key = lm_reference_key(arch, over, name, seq, dtype, rows)
            # a routed cell's float32 step comes after the ranks
            if key not in refs and not (
                    label in ROUTED_TRAIN_LABELS and dtype == "float32"):
                one_process(key, arch, cell, data)
    one_process_s = clock.seconds()
    gc.collect()
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_lm_ranks_")
    try:
        spec = {"device": device.type, "timeout": LM_RANK_TIMEOUT_S}
        reports, ranks_s = timed_s(lambda: run_ranks(work, spec,
                                                     lm_rank_worker))
        flips = {}
        for i, (label, arch, over, name, seq, mesh_shape, _) in enumerate(
                LM_RANK_CELLS):
            if label in ROUTED_TRAIN_LABELS and \
                    over.get("compute_dtype") == "float32":
                cell, data, rows = lm_one_process(name, seq, mesh_shape)
                with np.load(os.path.join(work, f"routes-{i}.npz")) as f:
                    tape = RoutingTape(replay=[f[k] for k in f.files])
                one_process(routed_key(lm_reference_key(
                    arch, over, name, seq, "float32", rows), over), arch,
                    cell, data, tape)
                if tape.at != len(tape.calls):
                    raise AssertionError(f"{label}: {tape.at} of "
                                         f"{len(tape.calls)} routings "
                                         f"replayed")
                flips[over.get("expert_sharding", "")] = tape.flips
        gathered = [[load_sample(os.path.join(work, f"sample-{i}-{r}.npz"))
                     if cell[3].startswith("train") else
                     torch.from_numpy(np.load(os.path.join(
                         work, f"logits-{i}-{r}.npy")))
                     for r in range(RANK_WORLD)]
                    for i, cell in enumerate(LM_RANK_CELLS)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = []
    for i, (label, arch, over, name, seq, mesh_shape, reduced) in enumerate(
            LM_RANK_CELLS):
        recs = [rep["cells"][str(i)] for rep in reports]
        tag = (f"lm_dryrun ranks {arch} ({label}) {name} at {seq} on "
               f"{mesh_shape}")
        rec = recs[0]
        if any(r["status"] != "ok" or "run_reason" in r or
               r.get("run_s") is None for r in recs):
            raise AssertionError(f"{tag}: {[r.get('run_reason') for r in recs]}")
        got = gathered[i]
        rows = lm_one_process(name, seq, mesh_shape)[2]
        f32, bf16 = (refs[lm_reference_key(arch, over, name, seq, d, rows)]
                     if d == "bfloat16" or label not in ROUTED_TRAIN_LABELS
                     else refs[routed_key(lm_reference_key(
                         arch, over, name, seq, d, rows), over)]
                     for d in ("float32", "bfloat16"))
        dtype = over.get("compute_dtype", "bfloat16")
        if name.startswith("train"):
            held = train_cell_checks(tag, got, f32[1], bf16[1], dtype)
            tag = f"{tag} in {dtype}"
            ranks_dep, one_dep = held["rms_departure"]
            ratio = held["departure_ratio"]
        else:
            if any(not torch.equal(g, got[0]) for g in got):
                raise AssertionError(f"{tag}: the gathered logits differ "
                                     f"between ranks")
            if got[0].shape != f32[1].shape:
                raise AssertionError(f"{tag}: logits {tuple(got[0].shape)}, "
                                     f"one process {tuple(f32[1].shape)}")
            ranks_dep, one_dep = rms(got[0] - f32[1]), rms(bf16[1] - f32[1])
            ratio = ranks_dep / one_dep
            held = {}
            if not ratio <= BF16_DEPARTURE_RATIO:
                raise AssertionError(
                    f"{tag}: the ranks' logits depart from the float32 run "
                    f"{ratio} times as far as the one-process bf16 run "
                    f"(limit {BF16_DEPARTURE_RATIO})")
        grid = lm_rank_grid(mesh_shape)
        # the one-process run in the cell's compute dtype (bf16 but for
        # the float32 train cell)
        one_peak = (f32 if dtype == "float32" else bf16)[0]["peak_bytes"]
        peaks = [r["peak_bytes"] for r in rec["run_ranks"]]
        # the one-process run covers the ranks' grid[0] data rows, which
        # grid[0] x grid[1] ranks share
        shares = grid[0] * grid[1]
        if not all(p < one_peak * 2 / shares for p in peaks):
            raise AssertionError(f"{tag}: rank peaks {peaks} not under 2 / "
                                 f"{shares} of the one-process run's "
                                 f"{one_peak}")
        for r in recs:
            why = dryrun.closed_form_mismatch(
                r["run_collective"], r["collective_executed"], grid)
            if why is not None:
                raise AssertionError(f"{tag}: counted collectives part from "
                                     f"the closed form: {why}")
        if any(r["run_checks"] != rec["run_checks"] for r in recs):
            raise AssertionError(f"{tag}: the ranks' checks differ")
        a2a = [c["bytes"]["all-to-all"] for c in rec["run_collective"]]
        row = {
            "label": label, "arch": arch, "overrides": over,
            "cell": name, "seq_len": seq, "mesh_shape": list(mesh_shape),
            "reduced": list(reduced),
            "ranks": list(grid), "run_batch": rec["run_batch"],
            "run_s": rec["run_s"], "run_exchange_s": rec["run_exchange_s"],
            "run_bound_s": rec["run_bound_s"],
            "run_bound_by": rec["run_bound_by"],
            "run_ranks": rec["run_ranks"],
            "collective_executed": rec["collective_executed"],
            "all_to_all_bytes": a2a,
            "peak_bytes_one_process": one_peak,
            "one_process_run_s": {"float32": f32[0]["run_s"],
                                  "bfloat16": bf16[0]["run_s"]},
            "rms_departure": {"ranks_bf16": ranks_dep, "one_bf16": one_dep},
            "departure_ratio": ratio, "cell_s": [r["cell_s"] for r in recs],
            "run_checks": rec["run_checks"], **held}
        if label in ROUTED_TRAIN_LABELS:
            row["routing_flips"] = flips[over.get("expert_sharding", "")]
        print(f"{tag} over {RANK_WORLD} ranks {grid}: batch "
              f"{rec['run_batch']}, run_s per rank "
              f"{[round(r['run_s'], 4) for r in rec['run_ranks']]} (slowest "
              f"{rec['run_s']:.4f} s; one process bf16 "
              f"{row['one_process_run_s']['bfloat16']:.4f} s, float32 "
              f"{row['one_process_run_s']['float32']:.4f} s, bound / "
              f"{grid[1]} "
              f"{rec['run_bound_s']:.4f} s), exchange "
              f"{[round(r['run_exchange_s'], 4) for r in rec['run_ranks']]}"
              f" s, collectives a rank {rec['run_collective'][0]['counts']}"
              f" = the closed form's, {rec['collective_executed']['total_bytes']}"
              f" B (all-to-all a rank {a2a} B), peak {peaks} B (one process "
              f"{one_peak} B), rms departure {ranks_dep:.5g} against "
              f"{one_dep:.5g} ({ratio:.3f}x), checks {rec['run_checks']}"
              + (f"; loss {held['loss']} (one process "
                 f"{held['loss_one_process']}), grad_norm "
                 f"{held['grad_norm']} (one process "
                 f"{held['grad_norm_one_process']}), first moments' rms "
                 f"departure {held['moment_rms_departure']}"
                 if held else "")
              + (f"; one process routed as the float32 ranks (its own "
                 f"top-k differs on {row['routing_flips']} token routings)"
                 if "routing_flips" in row else ""), flush=True)
        out.append(row)
    return {"cells": out, "one_process_s": one_process_s,
            "ranks_s": ranks_s, "seconds": clock.seconds()}


def phase_lm_dryrun_path(counters, device):
    """The LM dry-run (``repro_torch.launch.dryrun.main``, in process):
    every (arch x shape) cell on the 16 x 16 and 2 x 16 x 16 meshes into
    ``build/dryrun_lm`` (80 records: 64 ``ok``, 16 ``skipped``), priced by
    ``benchmarks/roofline.roofline_table`` at H100 rates for both meshes;
    then one card's share of three ``qwen3-1.7b`` cells at its widths
    on ``LM_DRYRUN_LAYERS`` of its 28 layers, on data-parallel meshes
    (``LM_DRYRUN_RUNS``), each
    through the port's own step with ``run=True``: its time beside its
    bound, its flops, its peak memory and its checks (outputs finite,
    every parameter changed, the logits' shape, the cache written at
    ``pos`` only); then ``lm_rank_cells``: the serving cells with the
    ``model`` axis split, four ranks sharing the card (so a rank's
    ``run_s`` is not what four cards would take): the dense
    ``qwen3-1.7b``, ``qwen2-moe-a2.7b``'s widths with FFN-split and with
    expert-parallel experts (an all-to-all each way over ``model``),
    ``llava-next-mistral-7b``'s prefill, and both cells of
    ``falcon-mamba-7b``, ``recurrentgemma-2b`` (on (2, 2) ranks) and
    ``whisper-large-v3`` (each cut to size as its ``LM_RANK_CELLS`` entry
    says), and ``qwen3-1.7b``'s training step on (1, 4) ranks and on
    (2, 2) ranks with ZeRO-1 over ``data``, and ``qwen2-moe-a2.7b``'s
    (FFN-split and expert-parallel) and ``llava-next-mistral-7b``'s on
    (1, 4) ranks, in float32 and bf16.  No kernel of the port is on this
    path: the counts stay 0."""
    from repro_torch.benchmarks import roofline
    from repro_torch.launch import dryrun
    clock = Phase()
    reset_counts(counters)
    shutil.rmtree(LM_DRYRUN_OUT, ignore_errors=True)
    records = dryrun.main(["--all", "--both-meshes", "--out",
                           str(LM_DRYRUN_OUT), "--device", device.type])
    rows = {mesh: roofline.roofline_table(str(LM_DRYRUN_OUT), mesh)
            for mesh in ("sp", "mp")}
    summary = lm_dryrun_summary(records, rows)
    files = len(list(LM_DRYRUN_OUT.glob("*__[sm]p.json")))
    if summary["status"] != LM_DRYRUN_CELLS or files != 80 or any(
            summary[m]["cells"] != 32 for m in rows):
        raise AssertionError(f"lm_dryrun_path: {summary['status']}, "
                             f"{files} files, {[summary[m]['cells'] for m in rows]}"
                             f" roofline rows")
    summary["seconds"] = clock.seconds()
    print(f"lm_dryrun: {summary['records']} records {summary['status']}; "
          + "; ".join(f"{m}: dominant {summary[m]['dominant_counts']}, "
                      f"mfu_bound {summary[m]['mfu_bound_min']:.4f} "
                      f"({summary[m]['mfu_bound_min_cell']}) .. "
                      f"{summary[m]['mfu_bound_max']:.4f} "
                      f"({summary[m]['mfu_bound_max_cell']})"
                      for m in rows), flush=True)
    runs = []
    one = {}                 # one-process runs the rank cells reuse
    for shape, seq, mesh_shape in LM_DRYRUN_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        logits = []
        rec = dryrun.lower_cell(LM_ARCH, lm_cell(shape, seq),
                                mesh_shape=mesh_shape,
                                overrides=LM_DRYRUN_DEPTH, device=device,
                                run=True, run_reps=LM_DRYRUN_RUN_REPS,
                                logits=logits)
        rec["seq_len"] = seq
        rec["reduced"] = [f"n_layers: 28 cut to {LM_DRYRUN_LAYERS}"]
        # a rank cell's one-process bf16 run, where this is it
        if (shape, seq, mesh_shape[0]) in {
                (n, q, m[0]) for _, a, o, n, q, m, _ in LM_RANK_CELLS
                if a == LM_ARCH and o == LM_DRYRUN_DEPTH}:
            one[lm_reference_key(LM_ARCH, LM_DRYRUN_DEPTH, shape, seq,
                                 "bfloat16", rec["run_batch"])] = (
                rec, logits[0])
        rec["cell_s"] = time.perf_counter() - t0
        if rec["status"] != "ok" or rec.get("run_s") is None:
            raise AssertionError(f"lm_dryrun_path {shape}: {rec}")
        rec["tflops_per_s"] = rec["run_flops"] / rec["run_s"] / 1e12
        rec["run_over_bound"] = rec["run_s"] / rec["run_bound_s"]
        print(f"lm_dryrun {LM_ARCH} {shape} at {seq} on {mesh_shape}: batch "
              f"{rec['run_batch']}, run {rec['run_s']:.4f} s against a "
              f"bound of {rec['run_bound_s']:.4f} s ({rec['run_bound_by']}; "
              f"{rec['run_over_bound']:.2f}x), {rec['run_flops']:.4e} flops "
              f"({rec['tflops_per_s']:.2f} TFLOP/s), peak "
              f"{rec['peak_bytes']} B, checks {rec['run_checks']}",
              flush=True)
        runs.append(rec)
    del logits
    ranks = lm_rank_cells(dryrun, device, one)
    del one
    gc.collect()
    torch.cuda.empty_cache()
    launches = read_counts(counters)
    if any(launches.values()):
        raise AssertionError(f"lm_dryrun_path launched kernels {launches}")
    emit({"phase": "lm_dryrun_path", "dryrun": summary, "runs": runs,
          "ranks": ranks, "launches": launches, "seconds": clock.seconds()})
    return summary, runs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1
    from repro_torch import api
    from repro_torch.device import find_nvcc
    from repro_torch.core import engine as engine_mod
    from repro_torch.core import query as query_mod
    from repro_torch.core import distributed as dist
    from repro_torch.core import semiring
    from repro_torch.core.query import searchsorted_join
    from repro_torch.kernels import build as build_mod
    from repro_torch.kernels import label_join as lj
    from repro_torch.kernels import maxmin_matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.kernels import overlap as ov
    from repro_torch.kernels import threshold_closure as tc
    from repro_torch import serve as serve_mod
    from repro_torch import store as store_mod
    from repro_torch import workloads as wl

    device = torch.device("cuda")
    counters = {"label_join": lj, "maxmin_matmul": mm, "overlap": ov,
                "threshold_step": tc}
    phase_env(build_mod, find_nvcc())
    refs = HostReferences()
    err_checks, gather_err_checks = phase_kernel_checks(
        lj, searchsorted_join, build_mod, device)
    dense_errs = phase_dense_kernel_checks(mm, ov, tc, device)
    (launches, gather_launches, err_main, gather_err_main, times,
     gather_times, main_eng, main_build_s) = phase_main_path(
         api, engine_mod, lj, searchsorted_join, device, refs)
    # the backends path runs frontier on this graph beside hl-index's
    # answers; the service path then updates main_eng in place
    main_h = main_eng.h
    main_rng = np.random.default_rng(31)
    main_pairs = (main_rng.integers(0, main_h.n, FRONTIER_PAIRS),
                  main_rng.integers(0, main_h.n, FRONTIER_PAIRS))
    main_mr = main_eng.mr_batch(*main_pairs)
    # sharded_path's label regime is held to this engine's labels and
    # answers as main_path built them
    sharded_pairs = inside_pairs(np.random.default_rng(59), main_h, 2**20)
    main = {"h": main_h, "idx": main_eng.idx, "pairs": sharded_pairs,
            "answers": main_eng.mr_batch(*sharded_pairs),
            "build_seconds": main_build_s}
    # rank_label_path's ranks must reach these labels
    main_digest = index_digest(main_eng.idx)
    service_launches, service_dense = phase_service_path(
        api, engine_mod, serve_mod, query_mod, ops, counters, main_eng,
        device)
    workload_launches = phase_workloads_path(api, wl, serve_mod, counters,
                                             main_eng, device)
    store_launches, store_errs = phase_store_path(
        api, store_mod, serve_mod, ops, counters, main_eng, main_build_s,
        device)
    # main_eng stays for bench_path (its snapshot is some 11 MB)
    phase_wide_labels(api, engine_mod, lj, device)
    (dense_launches, dense_pads, path_rows, closure_w,
     closure_eng) = phase_closure_path(api, semiring, ops, counters, wl,
                                       device, refs)
    sharded_launches, sharded_errs, sharded_rows, rank_inputs = \
        phase_sharded_path(api, dist, counters, closure_w, main, device)
    del closure_w, main
    torch.cuda.empty_cache()
    rank_launches, rank_errs = phase_rank_path(api, dist, counters,
                                               rank_inputs, device)
    del rank_inputs
    rank_label_launches, rank_label_errs, rank_label_rows = \
        phase_rank_label_path(api, counters, main_digest, device)
    phase_closure_small(api, ops, counters, device)
    backends_launches, ete_kernel, ete_workload_launches = \
        phase_backends_path(api, engine_mod, lj, counters, wl, main_h,
                            main_pairs, main_mr, device, refs)
    workload_launches += ete_workload_launches
    bench_launches = phase_bench_path(counters, main_eng, closure_eng)
    del main_eng, closure_eng
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_launches, dryrun_rows, dryrun_errs = phase_dryrun_path(
        counters, mm, ov, tc, device)
    phase_lm_serve_path(counters, device)
    phase_lm_train_path(counters, device)
    phase_lm_dryrun_path(counters, device)
    torch.cuda.synchronize()

    kernels = [{
        "name": "label_join", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/label_join.cu",
        "replaces": "src/repro/kernels/label_join.py:106",
        "launches": (launches + service_launches + backends_launches
                     + workload_launches + store_launches["label_join"]
                     + sharded_launches["label_join"]
                     + rank_launches.get("label_join", 0)
                     + rank_label_launches["label_join"]
                     + bench_launches["label_join"]),
        "launches_by_path": {"main_path": launches,
                             "service_path": service_launches,
                             "backends_path": backends_launches,
                             "workloads_path": workload_launches,
                             "store_path": store_launches["label_join"],
                             "sharded_path": sharded_launches["label_join"],
                             "rank_path": rank_launches.get("label_join", 0),
                             "rank_label_path": rank_label_launches[
                                 "label_join"],
                             "bench_path": bench_launches["label_join"]},
        "max_abs_err": max(err_checks, err_main,
                           store_errs["label_join_gather"],
                           sharded_errs["label_join_gather"],
                           rank_errs["label_join_gather"],
                           rank_label_errs["label_join"],
                           rank_label_errs["label_join_gather"]),
        "ms": times["ms"], "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
        "library_ms": None,    # no single PyTorch call computes this join
        "torch_ops_ms": times["torch_ops_ms"], "shape": times["shape"],
        "launches_include": "both entry points (one kernel body)",
        # the rows entry at the rows a rank assembles (rank_label_path)
        "rank_rows_shape": rank_label_rows["label_join"],
    }, {
        "name": "label_join_gather", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/label_join.cu",
        "replaces": "src/repro/kernels/label_join.py:106",
        "launches": (gather_launches + service_launches + backends_launches
                     + workload_launches
                     + store_launches["label_join_gather"]
                     + sharded_launches["label_join_gather"]
                     + rank_launches.get("label_join_gather", 0)
                     + rank_label_launches["label_join_gather"]
                     + bench_launches["label_join_gather"]),
        "launches_by_path": {"main_path": gather_launches,
                             "service_path": service_launches,
                             "backends_path": backends_launches,
                             "workloads_path": workload_launches,
                             "store_path": store_launches[
                                 "label_join_gather"],
                             "sharded_path": sharded_launches[
                                 "label_join_gather"],
                             "rank_path": rank_launches.get(
                                 "label_join_gather", 0),
                             "rank_label_path": rank_label_launches[
                                 "label_join_gather"],
                             "bench_path": bench_launches[
                                 "label_join_gather"]},
        "max_abs_err": max(gather_err_checks, gather_err_main,
                           ete_kernel["max_abs_err"],
                           store_errs["label_join_gather"],
                           sharded_errs["label_join_gather"],
                           rank_errs["label_join_gather"]),
        "ms": gather_times["ms"], "cold_ms": gather_times["cold_ms"],
        "plain_ms": gather_times["plain_ms"],
        "bound_ms": gather_times["bound_ms"],
        "bound_by": gather_times["bound_by"],
        "library_ms": None,    # no single PyTorch call gathers and joins
        "torch_ops_ms": gather_times["torch_ops_ms"],
        "shape": gather_times["shape"],
        "distinct_rows": gather_times["distinct_rows"],
        # the same kernel at the ete backend's shape (backends_path)
        "ete_shape": {k: ete_kernel[k] for k in (
            "shape", "route", "ms", "cold_ms", "plain_ms", "torch_ops_ms",
            "bound_ms", "bound_by", "distinct_rows")},
        # the same kernel on the sharded backend's two snapshots
        "sharded_shapes": {k: v for k, v in sharded_rows.items()
                           if k.startswith("label_join_gather")},
    }]
    replaces = {"maxmin_matmul": "src/repro/kernels/maxmin_matmul.py:70",
                "overlap": "src/repro/kernels/overlap.py:47",
                "threshold_step": "src/repro/kernels/threshold_closure.py:54"}
    for name in DENSE_KERNELS:
        row = path_rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": (dense_launches[name] + service_dense[name]
                         + store_launches[name] + sharded_launches[name]
                         + rank_launches.get(name, 0)
                         + rank_label_launches.get(name, 0)
                         + bench_launches[name] + dryrun_launches[name]),
            "launches_by_path": {"closure_path": dense_launches[name],
                                 "service_path": service_dense[name],
                                 "store_path": store_launches[name],
                                 "sharded_path": sharded_launches[name],
                                 "rank_path": rank_launches.get(name, 0),
                                 "rank_label_path":
                                     rank_label_launches.get(name, 0),
                                 "bench_path": bench_launches[name],
                                 "dryrun_path": dryrun_launches[name]},
            "max_abs_err": max(dense_errs[name], row["max_abs_err"],
                               store_errs.get(name, 0),
                               sharded_errs[name], rank_errs.get(name, 0),
                               rank_label_errs.get(name, 0),
                               dryrun_errs[name]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["shape"]})
        # at the closure dry-run's production shapes (m = 65,536)
        kernels[-1]["dryrun_shapes"] = {
            k: v for k, v in dryrun_rows.items() if k.startswith(name)}
        if name == "maxmin_matmul":
            # float32, at the sharded closure's whole and block shapes
            kernels[-1]["float32"] = {k: v for k, v in sharded_rows.items()
                                      if k.startswith("[")}
        if name in TENSOR_CORE_KERNELS:
            kernels[-1].update(dtype=row["dtype"],
                               library_f32_ms=row["library_f32_ms"],
                               padded_launches=dense_pads[name])
    rows_row = rank_label_rows["overlap_rows"]
    kernels.append({
        "name": "overlap_rows", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/overlap.cu",
        # a second entry of the overlap kernel: W's rows a rank owns; the
        # reference computes them as a sharded x @ x.T in XLA
        # (src/repro/core/hypergraph.py:285)
        "replaces": "src/repro/kernels/overlap.py:47",
        "launches": rank_label_launches["overlap_rows"],
        "launches_by_path": {"rank_label_path":
                                 rank_label_launches["overlap_rows"]},
        "max_abs_err": rank_label_errs["overlap_rows"],
        **{k: rows_row[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "shape",
                                    "dtype", "library_f32_ms")}})
    for k in kernels:
        if k["launches"] < 1 or k["max_abs_err"] != 0:
            raise AssertionError(f"kernel {k['name']}: {k['launches']} "
                                 f"launches, max abs err {k['max_abs_err']}")
    emit({"kernels": kernels})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        HostReferences.close_all()
    sys.exit(code)
