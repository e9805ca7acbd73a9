"""HL-index construction — Algorithms 2 (basic) and 3 (fast).

The HL-index is a vertex-to-hyperedge (VTE) labeling: ``L(u) = {(e, s)}``
meaning ``u ~s~> e``.  Construction processes hyperedges in descending
importance (w(e) = Σ_{v∈e}|E(v)|², ties by smaller id) and runs a pruned
bottleneck-Dijkstra from each root hyperedge.

Algorithm 3's two optimizations, implemented faithfully:

* **MCD** (maximum cover degree, Def. 8 / Lemmas 4-5): the transitive-cover
  check collapses to comparing the candidate step overlap with ``MCD(root)``
  — a scalar maintained for free as walks visit hyperedges.
* **neighbor-index M** (Lemma 6): ``N(e)`` is computed exactly once, stored
  sparsely, and entries proven redundant (``OD(e_u,e_v) ≤ WOD(walk to
  e_u)``) are evicted eagerly, keeping the peak size far below the full
  adjacency.

Implementation notes vs the pseudocode (documented deviations):
  * line 9 (``MCD(e_u) ← max(s, MCD(e_u))``) is skipped for the root pop —
    otherwise ``MCD(e) = |e|`` would prune the root's own traversal; the
    paper's text ("MCD(e) equals its lower bound when construction from e
    starts") implies the root's MCD is read once, before the loop.
  * pushes re-check ``O(e_v) > O(root)`` explicitly: ``M(e_u)`` may have
    been initialized under an earlier root with higher importance, so the
    line-17 exclusion alone does not cover the current root (Lemma 3 is
    the justification either way).
  * a stale-pop guard skips queue duplicates (first pop carries max s).

Counterpart of ``repro/core/hlindex.py``: host-side numpy, same names in
the same order, algorithms unchanged (label byte-identity rests on numpy's
stable tie-breaking).  Sharded construction (``build_sharded`` and its
fork pool) runs on the host as in the reference; over a logical mesh
(``core/mesh.py``) of more than one block it defaults its workers and
shards from the block count and may form the neighbor overlaps with the
``overlap`` kernel on the mesh's device (``neighbor_csr(h, mesh=)``).  On
a ``ProcessMesh`` the shards run on the ranks and cross in one ragged
all-gather (``build_sharded``).
"""
from __future__ import annotations

import dataclasses
import heapq
import multiprocessing
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .hypergraph import Hypergraph, NeighborCSR, induced_subhypergraph, \
    neighbor_csr

__all__ = ["HLIndex", "build_basic", "build_fast", "build_sharded",
           "pad_label_rows", "splice_rank", "CONSTRUCTION_MODES"]

# Safety valve for the fork-based shard pool: the window is *per shard
# result* (it restarts every time any shard completes), so a healthy
# long build keeps extending it and only a pool making no progress at
# all — e.g. a lock inherited across fork — is presumed wedged,
# terminated, and rerun inline (recorded as ``stats["pool_fallback"]``).
_WORKER_TIMEOUT_S = 300.0

# Offload the neighbor-overlap precompute to a device mesh only once the
# host's vectorized pair pass would materialize more than this many
# ordered co-incidence pairs (Σ_u d_u²) ...
_DEVICE_OVERLAP_PAIRS = 5e7
# ... and only while the dense [m, m] overlap matrix the device route
# materializes (~12 bytes/entry) stays affordable.
_DEVICE_OVERLAP_DENSE_BUDGET = 4 * 2**30


def auto_device_overlaps(h: Hypergraph) -> bool:
    """Whether the neighbor-overlap precompute for ``h`` should run on a
    device mesh: the host pair pass would walk more than
    ``_DEVICE_OVERLAP_PAIRS`` ordered co-incidence pairs *and* the dense
    [m, m] footprint of the device route stays affordable.  The
    reference's rule, unchanged; shared by ``build_sharded`` and the
    sharded engine's build-time ``NeighborCSR`` precompute so both pick
    the same route."""
    deg = h.vertex_degrees
    return bool(float((deg * deg).sum()) > _DEVICE_OVERLAP_PAIRS
                and 12.0 * h.m * h.m <= _DEVICE_OVERLAP_DENSE_BUDGET)

# When a multi-block mesh defaults the worker count (the engine's
# construction="auto" path), the fork pool only engages once the shared
# neighbor index carries at least this many entries — below it the
# per-shard traversals finish faster than the pool's fixed start +
# pickle cost.  An explicit ``workers=`` is always honored as given.
_POOL_MIN_NEIGHBOR_ENTRIES = 1_000_000


def splice_rank(old_rank: np.ndarray, old_to_new: np.ndarray,
                sub_edges: np.ndarray, sub_rank: np.ndarray,
                m_new: int) -> np.ndarray:
    """Compose a global importance rank for a graph after scoped
    maintenance: surviving hyperedges outside the rebuilt scope keep
    their old rank *values* unchanged, hyperedges inside the scope get
    fresh keys above every old value, ordered by sub-index importance.

    Keeping old values (rather than recompacting to ``0..m_new-1``)
    means the untouched vertices' ``labels_rank`` arrays stay valid
    byte-for-byte and are reused by the splice without a regather — rank
    is an opaque sort key everywhere it is consumed (merge-joins, padded
    snapshots, ``perm = argsort(rank)``), never a dense array index, so
    gaps are harmless.  Keys stay far below the int32 padding sentinel:
    each update raises the maximum by at most the scope size, and
    ``apply_updates`` falls back to a dense rebuild before ``2^30``.

    ``sub_edges`` [m_sub] maps local sub-index hyperedge ids to new
    global ids; ``sub_rank`` [m_sub] is the sub-index's own rank array.
    Requires the scope to be a union of whole line-graph components —
    then no label list ever mixes hubs from the two groups, so how the
    groups interleave cannot affect any merge-join (rank is only ever
    compared between hubs reachable from a common vertex), and any total
    order per group yields a correct index (order only affects
    minimality).
    """
    new_rank = np.full(m_new, -1, np.int64)
    old_ids = np.nonzero(old_to_new >= 0)[0]
    new_rank[old_to_new[old_ids]] = old_rank[old_ids]
    base = int(old_rank.max()) + 1 if old_rank.size else 0
    new_rank[sub_edges] = base + sub_rank
    if (new_rank < 0).any():
        raise ValueError("splice_rank: some hyperedge is neither a "
                         "surviving edge nor in the scope")
    return new_rank


def pad_label_rows(row_ranks, row_svals, pad_to=None):
    """Pack ragged per-vertex (rank, s) label rows into the padded dense
    form consumed by the batched query engine: one concatenate + fancy-
    index scatter, no per-row Python copies.

    Returns (ranks [n, Lmax] int32 ascending with INT32_MAX padding,
    svals [n, Lmax] int32 with 0 padding, lengths [n] int32).
    """
    n = len(row_ranks)
    lengths = np.array([a.size for a in row_svals], np.int32)
    lmax = int(pad_to if pad_to is not None else (lengths.max() if n else 0))
    ranks = np.full((n, lmax), np.iinfo(np.int32).max, np.int32)
    svals = np.zeros((n, lmax), np.int32)
    total = int(lengths.sum())
    if total and lmax:
        rows = np.repeat(np.arange(n), lengths)
        starts = np.cumsum(lengths, dtype=np.int64) - lengths
        cols = np.arange(total, dtype=np.int64) - np.repeat(starts, lengths)
        ranks[rows, cols] = np.concatenate(row_ranks)
        svals[rows, cols] = np.concatenate(row_svals)
    return ranks, svals, lengths


@dataclasses.dataclass
class HLIndex:
    """Per-vertex labels, sorted by hyperedge importance rank (ascending)."""

    h: Hypergraph
    rank: np.ndarray                  # [m] importance rank of each hyperedge
    perm: np.ndarray                  # [m] perm[rank] = hyperedge id
    labels_edge: List[np.ndarray]     # per vertex: hyperedge ids
    labels_rank: List[np.ndarray]     # per vertex: ranks (ascending — merge key)
    labels_s: List[np.ndarray]        # per vertex: s values
    dual_u: List[np.ndarray]          # per hyperedge: vertices (D(e))
    dual_s: List[np.ndarray]          # per hyperedge: s values (non-ascending)
    stats: Dict[str, float]

    @property
    def num_labels(self) -> int:
        return int(sum(a.size for a in self.labels_s))

    def label_dict(self, u: int) -> Dict[int, int]:
        return {int(e): int(s) for e, s in
                zip(self.labels_edge[u], self.labels_s[u])}

    def nbytes(self) -> int:
        """Index size: one (hyperedge id, s) pair per label, 4+4 bytes."""
        return self.num_labels * 8

    def as_padded(self, pad_to: Optional[int] = None):
        """Dense padded export for the batched query engine.

        Returns (ranks [n, Lmax] int32 ascending with INT32_MAX padding,
        svals [n, Lmax] int32 with 0 padding, lengths [n]).
        """
        return pad_label_rows(self.labels_rank, self.labels_s, pad_to)


class _Builder:
    """Shared state for Algorithms 2/3."""

    def __init__(self, h: Hypergraph):
        self.h = h
        self.rank = h.importance_order()
        self.perm = np.argsort(self.rank)
        self.sizes = h.edge_sizes
        self.labels: List[List[Tuple[int, int]]] = [[] for _ in range(h.n)]
        self.dual: List[List[Tuple[int, int]]] = [[] for _ in range(h.m)]
        self.visited_v = np.full(h.n, -1, np.int64)
        self.visited_e = np.full(h.m, -1, np.int64)
        self.stats: Dict[str, float] = dict(pops=0, pushes=0, neighbor_inits=0,
                                            m_peak_entries=0, m_total_inserts=0,
                                            cover_checks=0)

    def add_labels(self, root: int, e_u: int, s: int) -> None:
        for u in self.h.edge(e_u):
            u = int(u)
            if self.visited_v[u] == root:
                continue
            self.visited_v[u] = root
            self.labels[u].append((root, s))
            self.dual[root].append((u, s))

    def finish(self) -> HLIndex:
        h, rank = self.h, self.rank
        le, lr, ls = [], [], []
        for u in range(h.n):
            if self.labels[u]:
                e = np.array([t[0] for t in self.labels[u]], np.int64)
                s = np.array([t[1] for t in self.labels[u]], np.int64)
            else:
                e = np.empty(0, np.int64)
                s = np.empty(0, np.int64)
            r = rank[e] if e.size else np.empty(0, np.int64)
            # construction visits roots in ascending rank, so r is sorted
            le.append(e)
            lr.append(r)
            ls.append(s)
        du, ds = [], []
        for e in range(h.m):
            if self.dual[e]:
                du.append(np.array([t[0] for t in self.dual[e]], np.int64))
                ds.append(np.array([t[1] for t in self.dual[e]], np.int64))
            else:
                du.append(np.empty(0, np.int64))
                ds.append(np.empty(0, np.int64))
        return HLIndex(h=h, rank=rank, perm=self.perm, labels_edge=le,
                       labels_rank=lr, labels_s=ls, dual_u=du, dual_s=ds,
                       stats=self.stats)


# ---------------------------------------------------------------------------
# Algorithm 2 — basic construction (online transitive-cover detection)
# ---------------------------------------------------------------------------

def _covered_by_higher(h: Hypergraph, b: _Builder, root: int, e_u: int,
                       s: int, neighbors: Optional[NeighborCSR]) -> bool:
    """Line 8 of Alg. 2: ∃ e_w with O(e_w) < O(root), e_w ~s~> root and
    e_w ~s~> e_u.  Both conditions hold iff the ≥s-threshold component of
    ``e_u`` (which contains ``root`` — the current walk has WOD = s)
    contains any hyperedge of higher importance.  BFS with early exit.
    """
    b.stats["cover_checks"] += 1
    root_rank = b.rank[root]
    seen = {e_u}
    stack = [e_u]
    while stack:
        e = stack.pop()
        if b.rank[e] < root_rank:
            return True
        nb, od = (neighbors.row(e) if neighbors is not None
                  else h.neighbors_od(e))
        for e2, w in zip(nb, od):
            e2 = int(e2)
            if int(w) >= s and e2 not in seen:
                seen.add(e2)
                stack.append(e2)
    return False


def build_basic(h: Hypergraph, cover_check: bool = True, *,
                neighbors: Optional[NeighborCSR] = None) -> HLIndex:
    """Algorithm 2.  ``cover_check=False`` degenerates to plain pruned
    labeling (needed by ablation benchmarks).  ``neighbors`` is an
    optional precomputed ``NeighborCSR`` — same traversal, no per-edge
    neighborhood recomputation (output is identical either way)."""
    b = _Builder(h)
    rank, sizes = b.rank, b.sizes
    for root in [int(x) for x in b.perm]:
        q: List[Tuple[int, int]] = [(-int(sizes[root]), root)]
        while q:
            neg_s, e_u = heapq.heappop(q)
            s = -neg_s
            if b.visited_e[e_u] == root:
                continue
            b.visited_e[e_u] = root
            b.stats["pops"] += 1
            if cover_check and _covered_by_higher(h, b, root, e_u, s,
                                                  neighbors):
                continue
            b.add_labels(root, e_u, s)
            nb, od = (neighbors.row(e_u) if neighbors is not None
                      else h.neighbors_od(e_u))
            for e_v, w in zip(nb, od):
                e_v, w = int(e_v), int(w)
                if rank[e_v] <= rank[root]:          # line 14 (Lemma 3)
                    continue
                if b.visited_e[e_v] == root:         # line 15
                    continue
                heapq.heappush(q, (-min(s, w), e_v))
                b.stats["pushes"] += 1
    return b.finish()


# ---------------------------------------------------------------------------
# Algorithm 3 — fast construction (MCD + neighbor-index M)
# ---------------------------------------------------------------------------

def build_fast(h: Hypergraph, *,
               neighbors: Optional[NeighborCSR] = None) -> HLIndex:
    """Algorithm 3.  ``neighbors`` is an optional precomputed
    ``NeighborCSR`` used for the one-shot M initialization (Lemma 6)
    instead of computing ``N(e)`` on the fly — the output is identical
    either way (the CSR rows are byte-equal to ``neighbors_od``)."""
    b = _Builder(h)
    rank, sizes = b.rank, b.sizes
    mcd = np.zeros(h.m, np.int64)
    M: List[Optional[Dict[int, int]]] = [None] * h.m
    m_entries = 0

    for root in [int(x) for x in b.perm]:
        if mcd[root] == sizes[root]:                 # line 4
            continue
        mcd_root = int(mcd[root])                    # Lemma 5: lower bound is exact now
        q: List[Tuple[int, int]] = [(-int(sizes[root]), root)]
        while q:
            neg_s, e_u = heapq.heappop(q)
            s = -neg_s
            if b.visited_e[e_u] == root:
                continue
            b.visited_e[e_u] = root                  # line 8
            b.stats["pops"] += 1
            if e_u != root and s > mcd[e_u]:
                mcd[e_u] = s                         # line 9
            b.add_labels(root, e_u, s)               # lines 10-13
            if M[e_u] is None:                       # lines 14-18
                b.stats["neighbor_inits"] += 1
                entries: Dict[int, int] = {}
                nb, od = (neighbors.row(e_u) if neighbors is not None
                          else h.neighbors_od(e_u))
                for e_v, w in zip(nb, od):
                    e_v = int(e_v)
                    if rank[e_v] <= rank[root]:      # line 17 (Lemma 3)
                        continue
                    entries[e_v] = int(w)
                M[e_u] = entries
                m_entries += len(entries)
                b.stats["m_total_inserts"] += len(entries)
                b.stats["m_peak_entries"] = max(b.stats["m_peak_entries"], m_entries)
            evict: List[int] = []
            for e_v, w in M[e_u].items():            # lines 19-24
                if (w > mcd_root and b.visited_e[e_v] != root
                        and rank[e_v] > rank[root]):  # line 20 (+ explicit rank guard)
                    heapq.heappush(q, (-min(s, w), e_v))
                    b.stats["pushes"] += 1
                if w <= s:                           # lines 22-24 (Lemma 6)
                    evict.append(e_v)
            for e_v in evict:
                del M[e_u][e_v]
                m_entries -= 1
                other = M[e_v]
                if other is not None and e_u in other:
                    del other[e_u]
                    m_entries -= 1
    b.stats["m_final_entries"] = m_entries
    return b.finish()


# ---------------------------------------------------------------------------
# Sharded construction — component shards, optionally in a fork pool
# ---------------------------------------------------------------------------

def _assign_shards(comp: np.ndarray, cost: np.ndarray,
                   num_shards: int) -> List[np.ndarray]:
    """Partition line-graph components into ``num_shards`` work shards,
    balanced by estimated traversal cost (greedy longest-processing-time:
    heaviest component to the least-loaded shard; ties resolved by lower
    component label / lower shard index, so the partition is
    deterministic).  Returns sorted global hyperedge-id arrays, empty
    shards dropped."""
    n_comp = int(comp.max()) + 1 if comp.size else 0
    k = max(1, min(int(num_shards), n_comp))
    order = np.lexsort((np.arange(n_comp), -cost))   # heaviest first
    load = np.zeros(k, np.float64)
    shard_of = np.zeros(n_comp, np.int64)
    for c in order:
        s = int(np.argmin(load))                     # first minimum on ties
        shard_of[c] = s
        load[s] += cost[c]
    shards = [np.nonzero(shard_of[comp] == s)[0] for s in range(k)]
    return [s for s in shards if s.size]


def _shard_worker(payload) -> HLIndex:
    """Build (and optionally minimize) one shard's sub-index.  Module
    level so the fork-based shard pool can pickle it; workers touch only
    numpy — never torch, so a child forked from a process that holds a
    CUDA context never touches it."""
    sub_h, sub_nbr, base, minimizer = payload
    idx = base(sub_h, neighbors=sub_nbr)
    if minimizer is not None:
        idx = minimizer(idx)
    return idx


def _shard_worker_indexed(indexed_payload):
    i, payload = indexed_payload
    return i, _shard_worker(payload)


def _run_shard_pool(payloads, workers: int) -> Optional[List[HLIndex]]:
    """Run shard builds in forked worker processes; ``None`` means the
    pool was unavailable, wedged, or errored and the caller should run
    inline.  Workers execute pure numpy code, so the usual fork hazard (a
    child touching locks or a CUDA context inherited mid-flight) does not
    apply — but a *progress* timeout still guards the pathological case:
    the window restarts on every completed shard, so a long healthy build
    keeps extending it and only a pool producing nothing at all is
    declared wedged.  On any failure the children are *terminated* (not
    abandoned) so the inline rerun never races live duplicates for CPU
    and memory."""
    try:
        ctx = multiprocessing.get_context("fork")
    except ValueError:                               # platform without fork
        return None
    try:
        pool = ctx.Pool(processes=min(int(workers), len(payloads)))
    except OSError:
        return None
    try:
        out: List[Optional[HLIndex]] = [None] * len(payloads)
        it = pool.imap_unordered(_shard_worker_indexed,
                                 list(enumerate(payloads)))
        for _ in range(len(payloads)):
            i, idx = it.next(timeout=_WORKER_TIMEOUT_S)
            out[i] = idx
    except Exception:
        # no progress inside the window, a worker error, or a broken
        # pool: kill the children and let the caller rerun inline (a
        # genuine shard bug reproduces there with a clean traceback)
        pool.terminate()
        pool.join()
        return None
    pool.close()
    pool.join()
    return out


# the shard stats the merge reads: summed, then the peak (max)
_SHARD_COUNTERS = ("pops", "pushes", "neighbor_inits", "m_total_inserts",
                   "cover_checks", "m_final_entries", "m_peak_entries")


@dataclasses.dataclass
class _ShardLabels:
    """What the merge reads of one shard's sub-index, as it crossed
    between ranks (an ``HLIndex`` answers the same attributes)."""
    perm: np.ndarray
    labels_edge: List[np.ndarray]
    labels_s: List[np.ndarray]
    dual_u: List[np.ndarray]
    dual_s: List[np.ndarray]
    stats: Dict[str, float]


def _world_of(mesh) -> int:
    """The world size of a ``ProcessMesh`` (1 for anything else)."""
    from .mesh import ProcessMesh
    return mesh.world_size if isinstance(mesh, ProcessMesh) else 1


def _shard_vertices(h: Hypergraph, ids: np.ndarray) -> np.ndarray:
    """The sorted vertices of hyperedges ``ids``: the ``verts`` of
    ``induced_subhypergraph(h, ids)``, without building the subgraph."""
    keep = np.zeros(h.m, bool)
    keep[ids] = True
    owner = np.repeat(np.arange(h.m), np.diff(h.e_ptr))
    return np.unique(h.e_idx[keep[owner]])


def _pack_shard(s: int, sub) -> np.ndarray:
    """Shard ``s``'s sub-index as one flat int64 array: ``[s, n, m]``,
    ``perm``, the label and dual row lengths, the four flat label / dual
    arrays, then the counters' float64 bits."""
    n, m = len(sub.labels_edge), len(sub.dual_u)

    def flat(rows):
        return (np.concatenate(rows).astype(np.int64, copy=False)
                if rows else np.empty(0, np.int64))
    counts = np.array([float(sub.stats.get(k, 0)) for k in _SHARD_COUNTERS],
                      np.float64).view(np.int64)
    return np.concatenate([
        np.array([s, n, m], np.int64), np.asarray(sub.perm, np.int64),
        np.fromiter((a.size for a in sub.labels_edge), np.int64, n),
        np.fromiter((a.size for a in sub.dual_u), np.int64, m),
        flat(sub.labels_edge), flat(sub.labels_s), flat(sub.dual_u),
        flat(sub.dual_s), counts])


def _unpack_shards(blob: np.ndarray):
    """The ``(s, _ShardLabels)`` packed back to back in ``blob``."""
    at = 0

    def take(k):
        nonlocal at
        at += k
        return blob[at - k:at]

    def rows(lengths):
        flat = take(int(lengths.sum()))
        return np.split(flat, np.cumsum(lengths)[:-1]) if lengths.size else []
    while at < blob.size:
        s, n, m = (int(x) for x in take(3))
        perm = take(m)
        le_len, du_len = take(n), take(m)
        labels_edge, labels_s = rows(le_len), rows(le_len)
        dual_u, dual_s = rows(du_len), rows(du_len)
        counts = take(len(_SHARD_COUNTERS)).view(np.float64)
        yield s, _ShardLabels(perm, labels_edge, labels_s, dual_u, dual_s,
                              dict(zip(_SHARD_COUNTERS, map(float,
                                                            counts))))


def _exchange_shards(mine: List[int], built: list, pool_fallback: bool,
                     n_shards: int, mesh,
                     error: Optional[BaseException] = None
                     ) -> Tuple[list, bool]:
    """Every rank's shards, in shard order, on every rank: this rank's
    ``built`` sub-indexes (shards ``mine``) packed flat, one ragged
    all-gather, every part unpacked (this rank's too, so every rank
    merges the same arrays).  ``pool_fallback`` is true where any rank's
    pool fell back.  A rank whose shards failed passes its ``error``
    instead, and every rank raises after the exchange."""
    import torch

    from .collectives import exchange_device, gather_ragged_or_raise

    blob = None
    if error is None:
        blob = torch.from_numpy(np.concatenate(
            [np.array([int(pool_fallback)], np.int64)]
            + [_pack_shard(s, sub) for s, sub in zip(mine, built)])).to(
                exchange_device(mesh))
    parts = gather_ragged_or_raise(blob, mesh, "build_sharded", error)
    out: list = [None] * n_shards
    fallback = False
    for part in parts:
        part = part.cpu().numpy()
        fallback |= bool(part[0])
        for s, labels in _unpack_shards(part[1:]):
            out[s] = labels
    return out, fallback


def build_sharded(h: Hypergraph, *,
                  base: Callable[..., HLIndex] = build_fast,
                  minimizer: Optional[Callable[[HLIndex], HLIndex]] = None,
                  num_shards: Optional[int] = None,
                  workers: Optional[int] = None,
                  mesh=None,
                  device_overlaps: Optional[bool] = None,
                  neighbors: Optional[NeighborCSR] = None) -> HLIndex:
    """Parallel sharded HL-index construction — byte-identical output to
    ``base(h)`` (and, with ``minimizer``, to ``minimizer(base(h))``).

    The rank-ordered root sequence is partitioned into work shards at
    **line-graph component boundaries** — the finest grain at which the
    construction state (the MCD array and the neighbor index M of
    Algorithm 3, Lemmas 4-6) provably never crosses a cut: a cover
    relation rides an s-overlap walk, which is a line-graph path, so no
    cover check, MCD update, or M entry can involve two components.
    Each shard therefore replays exactly the serial traversal restricted
    to its components, in the same relative root order:

    1. The shared neighbor index is precomputed once as a ``NeighborCSR``
       (the host pair pass, or on the mesh's device when ``mesh`` has more
       than one block — see ``neighbor_csr``; ``neighbors`` hands in a
       prebuilt one) instead of once per hyperedge on the fly.
    2. Components are balanced into shards (greedy LPT on estimated
       traversal cost) and each shard runs ``base`` (+ ``minimizer``) on
       its induced sub-hypergraph, optionally in ``workers`` forked
       processes.  Per-shard minimization is exact too: Algorithm 4's
       dual sets are hub-confined, hence component-confined.
    3. The merge is a deterministic cover-check reconciliation pass: it
       verifies each shard's scope is neighbor-closed
       (``NeighborCSR.induced`` — the condition under which per-shard
       MCD cover state equals the serial builder's) and that each
       shard's local importance order mirrors the global order restricted
       to it, then splices labels/duals back into global id and rank
       space.  Any violation raises instead of silently merging.

    Why byte-identical: a vertex's incident hyperedges all share that
    vertex pairwise, so they are line-graph adjacent and live in one
    component — every label row is produced whole by exactly one shard,
    in the serial root order.  ``induced_subhypergraph`` on whole
    components preserves vertex degrees, hence importance weights, and
    its sorted-id mapping preserves the tie-break, so per-shard
    traversals pop and push in exactly the serial order.

    Stats: the traversal counters (``pops``, ``pushes``,
    ``neighbor_inits``, ``m_total_inserts``, ``cover_checks``,
    ``m_final_entries``) sum to exactly the serial builder's values;
    ``m_peak_entries`` is the max over shards (≤ the serial peak, which
    interleaves components).  Extra keys: ``shards``, ``components``,
    ``construction``, ``pool_fallback`` (1.0 when the fork pool made no
    progress or failed and the shards reran inline), ``neighbor_reused``.

    ``num_shards`` defaults to ``workers``, else the mesh's block count,
    else 1; shard counts that exceed the component count are clamped.
    ``workers=None`` with a multi-block ``mesh`` defaults to
    ``min(blocks, cpu_count)`` forked workers, engaged only once the
    neighbor index is heavy enough to amortize the pool's fixed cost
    (``_POOL_MIN_NEIGHBOR_ENTRIES``); an explicit ``workers`` is always
    honored as given, and ``workers`` ≤ 1 runs shards inline
    (byte-identical either way).  The workers run numpy only, so the pool
    is safe to fork from a process that has initialised CUDA.
    ``device_overlaps`` controls where the neighbor precompute runs:
    ``None`` offloads to the mesh only when ``auto_device_overlaps(h)``
    says so; ``True`` forces the mesh route (requires a multi-block
    ``mesh`` — raises otherwise), ``False`` forces the host pass.

    On a ``ProcessMesh`` of more than one rank every rank calls this with
    the same arguments (SPMD) and gets the same ``HLIndex``: the shard
    plan is computed alike on every rank, shard ``s`` runs on rank
    ``s % world`` (inline, or in that rank's own fork pool when
    ``workers > 1`` and it holds more than one shard), the shards' labels,
    duals and counters cross as flat int64 arrays in one
    ``all_gather_ragged``, and every rank runs the merge below in shard
    order.  A rank whose shards fail still joins that exchange, and every
    rank then raises ``RuntimeError`` naming it.  The mesh overlap route
    there is ``neighbor_csr``'s rank route.
    """
    devices = int(mesh.devices.size) if mesh is not None else 1
    if device_overlaps and devices <= 1:
        raise ValueError(
            "device_overlaps=True needs a multi-device mesh to offload "
            f"to; got {'no mesh' if mesh is None else f'{devices} device'}")
    auto_workers = workers is None
    if auto_workers and devices > 1:
        workers = min(devices, multiprocessing.cpu_count())
    if num_shards is None:
        num_shards = max(workers or 0, devices, 1)
    if h.m == 0:
        idx = base(h)
        if minimizer is not None:
            idx = minimizer(idx)
        idx.stats.update(shards=0, components=0, construction="sharded",
                         pool_fallback=0.0)
        return idx
    neighbor_reused = neighbors is not None
    if neighbors is not None:
        nbr = neighbors
    else:
        if device_overlaps is None:
            device_overlaps = auto_device_overlaps(h)
        nbr = neighbor_csr(h, mesh=mesh if device_overlaps else None)
    if auto_workers and nbr.idx.size < _POOL_MIN_NEIGHBOR_ENTRIES:
        workers = None          # defaulted pool would not amortize
    comp = nbr.components()
    row_len = np.diff(nbr.ptr).astype(np.float64)
    cost = np.bincount(comp, weights=row_len + 1.0,
                       minlength=int(comp.max()) + 1)
    shards = _assign_shards(comp, cost, num_shards)

    rank = h.importance_order()
    perm = np.argsort(rank)
    # on ranks, shard s runs on rank s % world; every rank knows every
    # shard's hyperedges and vertices, for the merge
    on_ranks = _world_of(mesh) > 1
    mine = (set(range(mesh.rank, len(shards), mesh.world_size))
            if on_ranks else set(range(len(shards))))
    metas = [(ids, _shard_vertices(h, ids)) if s not in mine else None
             for s, ids in enumerate(shards)]
    sub_idxs, pool_fallback, error = None, False, None
    try:
        payloads = []
        for s in sorted(mine):
            ids = shards[s]
            sub_h, verts = induced_subhypergraph(h, ids)
            sub_nbr = nbr.induced(ids)      # raises unless neighbor-closed
            payloads.append((sub_h, sub_nbr, base, minimizer))
            metas[s] = (ids, verts)
        if workers and int(workers) > 1 and len(payloads) > 1:
            sub_idxs = _run_shard_pool(payloads, int(workers))
            pool_fallback = sub_idxs is None
            if pool_fallback:
                warnings.warn(
                    "build_sharded: the shard worker pool made no "
                    "progress (or errored) and was terminated; rerunning "
                    "shards inline", RuntimeWarning, stacklevel=2)
        if sub_idxs is None:
            sub_idxs = [_shard_worker(p) for p in payloads]
    except Exception as exc:
        if not on_ranks:
            raise
        # the other ranks wait in the exchange: join it, then all raise
        error = exc
    if on_ranks:
        sub_idxs, pool_fallback = _exchange_shards(
            sorted(mine), sub_idxs, pool_fallback, len(shards), mesh, error)

    empty = np.empty(0, np.int64)
    le: List[np.ndarray] = [empty] * h.n
    lr: List[np.ndarray] = [empty] * h.n
    ls: List[np.ndarray] = [empty] * h.n
    du: List[np.ndarray] = [empty] * h.m
    ds: List[np.ndarray] = [empty] * h.m
    counters = _SHARD_COUNTERS[:-1]
    stats: Dict[str, float] = {k: 0.0 for k in counters}
    stats["m_peak_entries"] = 0.0
    for (ids, verts), sub in zip(metas, sub_idxs):
        # reconciliation: the shard's local rank order must mirror the
        # global order restricted to it (degrees — hence importance —
        # are preserved on whole components; anything else is a bug)
        if not np.array_equal(ids[sub.perm], ids[np.argsort(rank[ids])]):
            raise RuntimeError(
                "sharded construction: a shard's local importance order "
                "diverged from the global order — scope is not a union "
                "of whole line-graph components")
        for lu in range(len(sub.labels_edge)):
            gu = int(verts[lu])
            e = ids[sub.labels_edge[lu]]
            le[gu] = e
            lr[gu] = rank[e]
            ls[gu] = sub.labels_s[lu]
        for lei in range(len(sub.dual_u)):
            ge = int(ids[lei])
            du[ge] = verts[sub.dual_u[lei]]
            ds[ge] = sub.dual_s[lei]
        for key in counters:
            stats[key] += float(sub.stats.get(key, 0))
        stats["m_peak_entries"] = max(stats["m_peak_entries"],
                                      float(sub.stats.get("m_peak_entries",
                                                          0)))
    stats.update(shards=len(shards), components=int(comp.max()) + 1,
                 construction="sharded", pool_fallback=float(pool_fallback),
                 neighbor_reused=float(neighbor_reused))
    return HLIndex(h=h, rank=rank, perm=perm, labels_edge=le,
                   labels_rank=lr, labels_s=ls, dual_u=du, dual_s=ds,
                   stats=stats)


# Construction-mode registry: the builder options `HLIndexEngine.build`
# (repro_torch.core.engine) accepts for its `construction=` opt.
CONSTRUCTION_MODES: Dict[str, Callable[..., HLIndex]] = {
    "serial": build_fast,        # Algorithm 3, one host thread
    "sharded": build_sharded,    # component-sharded parallel construction
}
