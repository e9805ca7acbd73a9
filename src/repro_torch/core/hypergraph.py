"""Hypergraph data structure: CSR-style incidence, generators, compaction.

The hypergraph H = (V, E) is stored as a dual CSR pair:
  * edge -> vertices  (``e_ptr`` / ``e_idx``): hyperedge membership lists
  * vertex -> edges   (``v_ptr`` / ``v_idx``): incidence lists E(u)

Vertex ids are ``0..n-1``, hyperedge ids ``0..m-1``.  All arrays are numpy
int32/int64; this structure is the host-side substrate consumed by the
paper's construction algorithms (Alg. 1-4) and exported as a dense
incidence matrix / line graph for the device engines (see ``to_incidence``
and ``line_graph``).

Counterpart of ``repro/core/hypergraph.py``, same names in the same order.
``neighbor_csr(h, mesh=...)`` on a logical grid of more than one block
(``core/mesh.py``) forms the overlap matrix with the ``overlap`` kernel
on the mesh's device (``_mesh_overlap_matrix``); ``torch`` is imported
there, inside the call, and nowhere else in this module.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

__all__ = [
    "Hypergraph",
    "NeighborCSR",
    "neighbor_csr",
    "from_edge_lists",
    "compact",
    "induced_subhypergraph",
    "apply_edge_edits",
    "random_hypergraph",
    "planted_chain_hypergraph",
    "colocation_hypergraph",
    "paper_figure1",
]


@dataclasses.dataclass(frozen=True)
class Hypergraph:
    """Immutable CSR hypergraph."""

    n: int                 # |V|
    m: int                 # |E|
    e_ptr: np.ndarray      # [m+1]  offsets into e_idx
    e_idx: np.ndarray      # [nnz]  vertex ids, sorted within each hyperedge
    v_ptr: np.ndarray      # [n+1]  offsets into v_idx
    v_idx: np.ndarray      # [nnz]  hyperedge ids, sorted within each vertex

    # -- basic accessors ---------------------------------------------------
    def edge(self, e: int) -> np.ndarray:
        """Vertices of hyperedge ``e`` (sorted)."""
        return self.e_idx[self.e_ptr[e]:self.e_ptr[e + 1]]

    def edges_of(self, u: int) -> np.ndarray:
        """E(u): hyperedges containing vertex ``u`` (sorted)."""
        return self.v_idx[self.v_ptr[u]:self.v_ptr[u + 1]]

    def edge_size(self, e: int) -> int:
        return int(self.e_ptr[e + 1] - self.e_ptr[e])

    def degree(self, u: int) -> int:
        return int(self.v_ptr[u + 1] - self.v_ptr[u])

    @property
    def nnz(self) -> int:
        return int(self.e_idx.shape[0])

    @property
    def edge_sizes(self) -> np.ndarray:
        return np.diff(self.e_ptr)

    @property
    def vertex_degrees(self) -> np.ndarray:
        return np.diff(self.v_ptr)

    @property
    def delta(self) -> int:
        """δ = max hyperedge size."""
        return int(self.edge_sizes.max()) if self.m else 0

    @property
    def d_max(self) -> int:
        """d = max vertex degree."""
        return int(self.vertex_degrees.max()) if self.n else 0

    # -- neighbor computation (the expensive primitive the paper optimizes)
    def neighbors_od(self, e: int) -> Tuple[np.ndarray, np.ndarray]:
        """N(e) with overlap degrees, computed on the fly in O(δ·d).

        Returns (neighbor_edge_ids, overlap_degrees), excluding ``e``.
        """
        counts: Dict[int, int] = {}
        for u in self.edge(e):
            for e2 in self.edges_of(int(u)):
                e2 = int(e2)
                if e2 != e:
                    counts[e2] = counts.get(e2, 0) + 1
        if not counts:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        nbrs = np.fromiter(counts.keys(), dtype=np.int64, count=len(counts))
        ods = np.fromiter(counts.values(), dtype=np.int64, count=len(counts))
        order = np.argsort(nbrs)
        return nbrs[order], ods[order]

    def overlap(self, e1: int, e2: int) -> int:
        """OD(e1, e2) = |e1 ∩ e2| via sorted-list intersection."""
        return int(np.intersect1d(self.edge(e1), self.edge(e2),
                                  assume_unique=True).size)

    # -- hyperedge importance order (Section V-A) --------------------------
    def importance_order(self) -> np.ndarray:
        """Total order O over hyperedges: rank[e] = position (0 = most
        important).  Weight w(e) = Σ_{v∈e} |E(v)|², ties by smaller id.
        """
        deg2 = self.vertex_degrees.astype(np.float64) ** 2
        w = np.zeros(self.m, np.float64)
        np.add.at(w, np.repeat(np.arange(self.m), self.edge_sizes), deg2[self.e_idx])
        # descending weight, ascending id on ties -> lexsort on (-w, id)
        perm = np.lexsort((np.arange(self.m), -w))    # perm[rank] = edge id
        rank = np.empty(self.m, np.int64)
        rank[perm] = np.arange(self.m)
        return rank

    # -- dense exports for the device engines ------------------------------
    def to_incidence(self, dtype=np.float32) -> np.ndarray:
        """Dense incidence matrix B [m, n], B[e, v] = 1 iff v ∈ e."""
        B = np.zeros((self.m, self.n), dtype=dtype)
        B[np.repeat(np.arange(self.m), self.edge_sizes), self.e_idx] = 1
        return B

    def line_graph(self, dtype=np.int32) -> np.ndarray:
        """W [m, m]: W[i,j] = OD(e_i, e_j) for i≠j; W[i,i] = |e_i|.

        The diagonal |e_i| encodes the single-hyperedge walk (WOD({e}) =
        |e|, Sec. II), making W the correct (max,min)-semiring seed.
        """
        B = self.to_incidence(np.float32)
        W = (B @ B.T).astype(dtype)
        np.fill_diagonal(W, self.edge_sizes.astype(dtype))
        return W

    def stats(self) -> Dict[str, float]:
        return dict(n=self.n, m=self.m, nnz=self.nnz,
                    eta_avg=float(self.vertex_degrees.mean()) if self.n else 0.0,
                    eta_max=self.d_max, delta=self.delta)


# ---------------------------------------------------------------------------
# shared neighbor index (line-graph adjacency as one read-only CSR)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NeighborCSR:
    """The full line-graph adjacency ``N(e)`` with overlap degrees, as one
    read-only CSR — the shared neighbor index consumed by sharded HL-index
    construction (``build_sharded``).

    Per row the content is exactly ``Hypergraph.neighbors_od(e)``:
    neighbor hyperedge ids ascending, overlap degrees aligned — so a
    traversal reading rows from here is step-for-step identical to one
    computing neighborhoods on the fly, just without the O(δ·d) Python
    dict pass per hyperedge.
    """

    ptr: np.ndarray       # [m+1] int64 offsets
    idx: np.ndarray       # [L]   int64 neighbor ids, ascending per row
    od: np.ndarray        # [L]   int64 overlap degrees

    @property
    def m(self) -> int:
        return int(self.ptr.size - 1)

    def row(self, e: int) -> Tuple[np.ndarray, np.ndarray]:
        """``(neighbors, overlap_degrees)`` of hyperedge ``e`` — same
        content and order as ``Hypergraph.neighbors_od(e)``."""
        lo, hi = self.ptr[e], self.ptr[e + 1]
        return self.idx[lo:hi], self.od[lo:hi]

    def nbytes(self) -> int:
        return int(self.ptr.nbytes + self.idx.nbytes + self.od.nbytes)

    def components(self) -> np.ndarray:
        """[m] int64 line-graph component label per hyperedge; labels are
        assigned in ascending order of each component's smallest id, so
        the labeling is deterministic.

        Vectorized min-label propagation with pointer jumping (labels
        always point at a smaller id inside the same component, so
        ``l[l]`` is a legal shortcut): O(log diameter) rounds of pure
        numpy over the CSR — this runs serially on the sharded build's
        critical path before any parallelism starts, so no interpreted
        per-entry loop."""
        m = self.m
        if m == 0:
            return np.empty(0, np.int64)
        rows = np.repeat(np.arange(m), np.diff(self.ptr))
        labels = np.arange(m)
        while True:
            nb_min = np.full(m, m, np.int64)
            np.minimum.at(nb_min, rows, labels[self.idx])
            new = np.minimum(labels, nb_min)
            new = np.minimum(new, new[new])          # pointer jumping
            if np.array_equal(new, labels):
                break
            labels = new
        # converged: labels[e] == smallest id in e's component; compact
        # to 0..C-1 in ascending-smallest-id order
        _, inv = np.unique(labels, return_inverse=True)
        return inv.astype(np.int64)

    def induced(self, edge_ids: np.ndarray) -> "NeighborCSR":
        """The CSR restricted to ``edge_ids`` (sorted), with neighbor ids
        remapped to local positions.  ``edge_ids`` must be neighbor-closed
        (a union of whole line-graph components) — a neighbor outside the
        set raises ``ValueError``, which is the cover-check reconciliation
        guard of sharded construction: cover relations ride s-overlap
        walks, i.e. line-graph paths, so closure here is exactly what
        keeps per-shard MCD state equal to the serial builder's."""
        ids = np.asarray(edge_ids, np.int64)
        local = np.full(self.m, -1, np.int64)
        local[ids] = np.arange(ids.size)
        sizes = self.ptr[ids + 1] - self.ptr[ids]
        total = int(sizes.sum())
        ptr = np.zeros(ids.size + 1, np.int64)
        np.cumsum(sizes, out=ptr[1:])
        if total == 0:
            return NeighborCSR(ptr, np.empty(0, np.int64),
                               np.empty(0, np.int64))
        take = (np.repeat(self.ptr[ids], sizes)
                + np.arange(total) - np.repeat(ptr[:-1], sizes))
        lidx = local[self.idx[take]]
        if (lidx < 0).any():
            bad = int(self.idx[take][lidx < 0][0])
            raise ValueError(
                f"edge_ids is not neighbor-closed: hyperedge {bad} is a "
                f"line-graph neighbor of the set but not in it")
        return NeighborCSR(ptr, lidx, self.od[take])

    def updated(self, new_h: Hypergraph, old_to_new: np.ndarray,
                touched: np.ndarray) -> "NeighborCSR":
        """The CSR for ``new_h`` after an ``apply_edge_edits`` step, built
        by a 1-hop patch instead of a fresh O(Σd²) pair pass.

        ``old_to_new``/``touched`` are the extra outputs of
        ``apply_edge_edits``.  An untouched surviving hyperedge has, by
        construction of the 1-hop set, no deleted or inserted neighbors
        and unchanged overlap degrees, so its row is the old row with ids
        remapped — and since ``old_to_new`` is monotone on survivors, the
        remap preserves the ascending neighbor order.  Touched rows are
        recomputed from ``new_h.neighbors_od``, which is what a fresh
        ``neighbor_csr(new_h)`` holds for them; the result is therefore
        byte-identical to a fresh build (asserted in tests).
        """
        m_new = new_h.m
        if m_new == 0:
            return NeighborCSR(np.zeros(1, np.int64),
                               np.empty(0, np.int64), np.empty(0, np.int64))
        touched = np.asarray(touched, np.int64)
        tmask = np.zeros(m_new, bool)
        tmask[touched] = True
        surv = np.nonzero(np.asarray(old_to_new, np.int64) >= 0)[0]
        keep_old = surv[~tmask[old_to_new[surv]]]
        fresh = [new_h.neighbors_od(int(t)) for t in touched]
        counts = np.zeros(m_new, np.int64)
        sizes = self.ptr[keep_old + 1] - self.ptr[keep_old]
        counts[old_to_new[keep_old]] = sizes
        counts[touched] = [nb.size for nb, _ in fresh]
        ptr = np.zeros(m_new + 1, np.int64)
        np.cumsum(counts, out=ptr[1:])
        idx = np.empty(int(ptr[-1]), np.int64)
        od = np.empty(int(ptr[-1]), np.int64)
        if keep_old.size and int(sizes.sum()):
            off = np.cumsum(sizes) - sizes
            span = np.arange(int(sizes.sum()))
            take = np.repeat(self.ptr[keep_old], sizes) + span \
                - np.repeat(off, sizes)
            dest = np.repeat(ptr[old_to_new[keep_old]], sizes) + span \
                - np.repeat(off, sizes)
            idx[dest] = old_to_new[self.idx[take]]
            od[dest] = self.od[take]
        for t, (nb, w) in zip(touched, fresh):
            lo = ptr[int(t)]
            idx[lo:lo + nb.size] = nb
            od[lo:lo + nb.size] = w
        return NeighborCSR(ptr, idx, od)


def _mesh_overlap_matrix(h: Hypergraph, mesh) -> np.ndarray:
    """Dense pairwise-overlap matrix |e_i ∩ e_j| computed on the mesh's
    device: the incidence rows padded with zero rows to a multiple of the
    block count (the reference's row sharding over every mesh axis), one
    launch of the ``overlap`` kernel on the card (its plain version on the
    CPU), the result cropped and pulled back for CSR extraction.  The
    kernel reads bf16 0/1 and sums in float32, exact while overlaps stay
    below 2^24 (they are at most δ)."""
    import torch

    from ..kernels.overlap import overlap

    nd = int(mesh.devices.size)
    b = h.to_incidence(np.float32)
    pad = (-h.m) % nd
    if pad:
        b = np.pad(b, ((0, pad), (0, 0)))
    b_dev = torch.from_numpy(b).to(mesh.device)
    if b_dev.device.type == "cuda":
        b_dev = b_dev.to(torch.bfloat16)      # the kernel's type, exact
    w = overlap(b_dev)[:h.m, :h.m]
    return w.cpu().numpy().astype(np.int64)


def _rank_neighbor_csr(h: Hypergraph, mesh) -> NeighborCSR:
    """The mesh overlap route on a ``ProcessMesh``: the incidence rows
    block-split over every rank (rank k holds rows [k·b, (k+1)·b) of the
    rows padded to a multiple of the world size, as the reference's
    sharding over every mesh axis), one ``overlap_rows`` product of this
    rank's rows with the whole incidence (its plain version on the CPU),
    the diagonal entries of its rows zeroed, and its rows' ``(col,
    count)`` pairs extracted in row-major order.  One
    ``all_gather_ragged`` of ``[row counts, cols, counts]`` gives every
    rank the whole ``NeighborCSR``.  No rank holds more than its
    ``[b, m]`` rows of W.  A rank whose rows fail (out of device memory)
    still joins the exchange, and every rank raises."""
    import torch

    from ..kernels.overlap import overlap_rows
    from .collectives import gather_ragged_or_raise

    m, world, rank = h.m, mesh.world_size, mesh.rank
    rows = -(-m // world)
    lo, hi = min(rank * rows, m), min((rank + 1) * rows, m)
    mine, error = None, None
    try:
        dev = mesh.device
        b_dev = torch.from_numpy(h.to_incidence(np.float32)).to(dev)
        if dev.type == "cuda":
            b_dev = b_dev.to(torch.bfloat16)  # the kernel's type, exact
        w = overlap_rows(b_dev[lo:hi].contiguous(), b_dev)
        del b_dev
        local = torch.arange(hi - lo, device=dev)
        w[local, local + lo] = 0
        nz = torch.nonzero(w)                 # row-major: ascending per row
        od = w[nz[:, 0], nz[:, 1]].to(torch.int64)
        counts = torch.bincount(nz[:, 0], minlength=hi - lo)
        mine = torch.cat([counts, nz[:, 1], od])
        del w, nz, od
    except Exception as exc:
        error = exc
    parts = gather_ragged_or_raise(mine, mesh, "neighbor_csr", error)
    row_counts, cols, ods = [], [], []
    for k, part in enumerate(parts):
        part = part.cpu().numpy()
        nk = min((k + 1) * rows, m) - min(k * rows, m)
        c = part[:nk]
        total = int(c.sum())
        row_counts.append(c)
        cols.append(part[nk:nk + total])
        ods.append(part[nk + total:nk + 2 * total])
    ptr = np.zeros(m + 1, np.int64)
    np.cumsum(np.concatenate(row_counts), out=ptr[1:])
    return NeighborCSR(ptr, np.concatenate(cols).astype(np.int64),
                       np.concatenate(ods).astype(np.int64))


def neighbor_csr(h: Hypergraph, *, mesh=None) -> NeighborCSR:
    """All line-graph neighborhoods at once, as a shared ``NeighborCSR``.

    Row content is byte-identical to ``h.neighbors_od(e)`` for every
    ``e`` (asserted in tests) — this is the precomputed neighbor index
    that lets HL-index construction drop its per-hyperedge O(δ·d) host
    dict pass (``repro_torch.core.hlindex``, Lemma 6 regime).

    Two paths, same output:
      * host (default): every ordered co-incidence pair ``(e1, e2)``
        sharing a vertex is generated in one vectorized pass and
        deduplicated with counts — O(Σ d_u²) memory, no dense [m, m].
      * ``mesh`` with more than one block: the O(m²·n̄) overlap products
        run on the mesh's device (one ``overlap`` launch,
        ``_mesh_overlap_matrix``) and only the CSR extraction stays on
        the host.  A one-block mesh takes the host path, as in the
        reference.  On a ``ProcessMesh`` of more than one rank each rank
        computes only its rows' overlaps (``_rank_neighbor_csr``) and one
        ragged all-gather assembles the same index on every rank.
    """
    m = h.m
    empty = NeighborCSR(np.zeros(max(m, 0) + 1, np.int64),
                        np.empty(0, np.int64), np.empty(0, np.int64))
    if m == 0 or h.nnz == 0:
        return empty
    if mesh is not None and int(mesh.devices.size) > 1:
        from .mesh import ProcessMesh
        if isinstance(mesh, ProcessMesh):
            return _rank_neighbor_csr(h, mesh)
        w = _mesh_overlap_matrix(h, mesh)
        np.fill_diagonal(w, 0)
        rows, cols = np.nonzero(w)            # row-major: ascending per row
        od = w[rows, cols]
        counts = np.bincount(rows, minlength=m)
        ptr = np.zeros(m + 1, np.int64)
        np.cumsum(counts, out=ptr[1:])
        return NeighborCSR(ptr, cols.astype(np.int64), od.astype(np.int64))
    deg = h.vertex_degrees
    pair_counts = deg * deg
    total = int(pair_counts.sum())
    if total == 0:
        return empty
    # within vertex u's block of d² ordered pairs, entry k is
    # (E(u)[k // d], E(u)[k % d]); all blocks emitted in one shot
    starts = np.cumsum(pair_counts) - pair_counts
    pos = np.arange(total) - np.repeat(starts, pair_counts)
    du = np.repeat(deg, pair_counts)
    vstart = np.repeat(h.v_ptr[:-1], pair_counts)
    a = h.v_idx[vstart + pos // du]
    b = h.v_idx[vstart + pos % du]
    mask = a != b
    key = a[mask] * np.int64(m) + b[mask]
    uniq, counts = np.unique(key, return_counts=True)
    rows = uniq // m
    cols = uniq % m
    row_counts = np.bincount(rows, minlength=m)
    ptr = np.zeros(m + 1, np.int64)
    np.cumsum(row_counts, out=ptr[1:])
    return NeighborCSR(ptr, cols.astype(np.int64), counts.astype(np.int64))


# ---------------------------------------------------------------------------
# construction helpers
# ---------------------------------------------------------------------------

def from_edge_lists(edges: Sequence[Iterable[int]], n: int | None = None) -> Hypergraph:
    """Build a Hypergraph from an iterable of vertex iterables.

    Empty hyperedges are dropped; duplicate vertices within a hyperedge are
    deduplicated; vertex lists are sorted.
    """
    cleaned: List[np.ndarray] = []
    for ed in edges:
        arr = np.unique(np.asarray(list(ed), dtype=np.int64))
        if arr.size:
            cleaned.append(arr)
    m = len(cleaned)
    if n is None:
        n = int(max((a.max() for a in cleaned), default=-1)) + 1
    sizes = np.array([a.size for a in cleaned], np.int64)
    e_ptr = np.zeros(m + 1, np.int64)
    np.cumsum(sizes, out=e_ptr[1:])
    e_idx = (np.concatenate(cleaned) if m else np.empty(0, np.int64))

    # invert to vertex -> edges
    order = np.argsort(e_idx, kind="stable")
    v_sorted = e_idx[order]
    eid = np.repeat(np.arange(m, dtype=np.int64), sizes)[order]
    v_ptr = np.zeros(n + 1, np.int64)
    np.add.at(v_ptr, v_sorted + 1, 1)
    np.cumsum(v_ptr, out=v_ptr)
    return Hypergraph(n=n, m=m, e_ptr=e_ptr, e_idx=e_idx, v_ptr=v_ptr, v_idx=eid)


def compact(h: Hypergraph) -> Tuple[Hypergraph, np.ndarray]:
    """Graph compaction (paper Appendix B style): remove hyperedges that are
    exact duplicates of another hyperedge (identical vertex sets).  Duplicate
    hyperedges contribute no new reachability: OD(e, dup(e)) = |e| and both
    have identical neighborhoods, so any walk through the duplicate can be
    rerouted through the representative with equal WOD.

    Returns (compacted graph, representative_map [m] mapping old edge id to
    kept edge id in the *original* id space).
    """
    seen: Dict[bytes, int] = {}
    keep: List[int] = []
    rep = np.empty(h.m, np.int64)
    for e in range(h.m):
        key = h.edge(e).tobytes()
        if key in seen:
            rep[e] = seen[key]
        else:
            seen[key] = e
            rep[e] = e
            keep.append(e)
    if len(keep) == h.m:
        return h, rep
    g = from_edge_lists([h.edge(e) for e in keep], n=h.n)
    return g, rep


def induced_subhypergraph(h: Hypergraph, edge_ids: Sequence[int]
                          ) -> Tuple[Hypergraph, np.ndarray]:
    """Sub-hypergraph induced by ``edge_ids`` with compacted vertex ids.

    Local hyperedge ``i`` is global ``edge_ids[i]`` (callers should pass
    sorted ids so local order mirrors global order); local vertex ``j``
    is global ``verts[j]``.  Returns ``(sub, verts)``.

    When ``edge_ids`` is a union of whole line-graph components, every
    hyperedge incident to an extracted vertex is itself extracted, so
    vertex degrees — and therefore the importance order — inside the
    sub-hypergraph coincide with the global ones restricted to it.  This
    is the extraction primitive behind scoped index maintenance
    (roadmap item A6).
    """
    ids = np.asarray(list(edge_ids), np.int64)
    if ids.size == 0:
        return from_edge_lists([], n=0), np.empty(0, np.int64)
    sizes = h.e_ptr[ids + 1] - h.e_ptr[ids]
    flat = h.e_idx[np.concatenate([np.arange(h.e_ptr[e], h.e_ptr[e + 1])
                                   for e in ids])]
    verts, local = np.unique(flat, return_inverse=True)
    e_ptr = np.zeros(ids.size + 1, np.int64)
    np.cumsum(sizes, out=e_ptr[1:])
    edges = [local[e_ptr[i]:e_ptr[i + 1]] for i in range(ids.size)]
    return from_edge_lists(edges, n=int(verts.size)), verts


def apply_edge_edits(h: Hypergraph, inserts: Sequence[Iterable[int]] = (),
                     deletes: Sequence[int] = ()
                     ) -> Tuple[Hypergraph, np.ndarray, np.ndarray]:
    """Apply hyperedge deletions then insertions; the pure graph edit
    shared by index maintenance and every engine's ``update`` path.

    Surviving hyperedges keep their relative order (ids compacted),
    inserted hyperedges are appended in argument order.  Vertex ids are
    never renumbered; inserting vertices beyond ``h.n`` grows ``n``.

    Returns ``(new_h, old_to_new, touched)``:
      * ``old_to_new`` [m_old] int64 — new id of each old hyperedge,
        -1 for deleted ones;
      * ``touched`` — sorted new ids of hyperedges whose line-graph
        neighborhood may have changed: the inserted hyperedges, their
        neighbors, and the surviving neighbors of deleted hyperedges.
        (Adjacency caches only need refreshing on this 1-hop set; index
        maintenance expands it to whole components.)

    Cost is O(nnz) vectorized: surviving hyperedges are already clean
    (sorted, deduplicated), so the edited CSR is assembled by masked
    copies — no per-hyperedge re-cleaning.
    """
    del_set = {int(d) for d in deletes}
    for d in del_set:
        if not 0 <= d < h.m:
            raise IndexError(f"delete of hyperedge {d} out of range "
                             f"[0, {h.m})")
    cleaned_inserts: List[np.ndarray] = []
    for ed in inserts:
        arr = np.unique(np.asarray(list(ed), dtype=np.int64))
        if arr.size == 0:
            continue                       # empty hyperedges never exist
        if arr.min() < 0:
            raise IndexError(f"insert with negative vertex id {arr.min()}")
        cleaned_inserts.append(arr)

    keep_mask = np.ones(h.m, bool)
    keep_mask[list(del_set)] = False
    old_to_new = np.where(keep_mask, np.cumsum(keep_mask) - 1, -1)
    sizes = h.edge_sizes
    kept_sizes = sizes[keep_mask]
    kept_idx = h.e_idx[np.repeat(keep_mask, sizes)]
    first_insert_id = int(kept_sizes.size)

    ins_sizes = np.array([a.size for a in cleaned_inserts], np.int64)
    all_sizes = np.concatenate([kept_sizes, ins_sizes])
    m_new = int(all_sizes.size)
    e_ptr = np.zeros(m_new + 1, np.int64)
    np.cumsum(all_sizes, out=e_ptr[1:])
    e_idx = np.concatenate([kept_idx] + cleaned_inserts) \
        if m_new else np.empty(0, np.int64)
    n_new = h.n
    if cleaned_inserts:
        n_new = max(n_new, int(max(a.max() for a in cleaned_inserts)) + 1)
    # invert to vertex -> edges (same construction as from_edge_lists)
    order = np.argsort(e_idx, kind="stable")
    v_sorted = e_idx[order]
    eid = np.repeat(np.arange(m_new, dtype=np.int64), all_sizes)[order]
    v_ptr = np.zeros(n_new + 1, np.int64)
    np.add.at(v_ptr, v_sorted + 1, 1)
    np.cumsum(v_ptr, out=v_ptr)
    new_h = Hypergraph(n=n_new, m=m_new, e_ptr=e_ptr, e_idx=e_idx,
                       v_ptr=v_ptr, v_idx=eid)

    touched = set(range(first_insert_id, new_h.m))
    for t in list(touched):
        nb, _ = new_h.neighbors_od(t)
        touched.update(int(e) for e in nb)
    for d in del_set:
        nb, _ = h.neighbors_od(d)
        for e in nb:
            e_new = int(old_to_new[int(e)])
            if e_new >= 0:
                touched.add(e_new)
    return new_h, old_to_new, np.fromiter(sorted(touched), np.int64,
                                          len(touched))


# ---------------------------------------------------------------------------
# generators (tests / benchmarks / case study)
# ---------------------------------------------------------------------------

def random_hypergraph(n: int, m: int, *, min_size: int = 2, max_size: int = 6,
                      seed: int = 0) -> Hypergraph:
    """Uniform random hypergraph: each hyperedge samples its size then its
    vertices without replacement.  Mirrors the paper's synthetic workloads.
    """
    rng = np.random.default_rng(seed)
    edges = []
    for _ in range(m):
        k = int(rng.integers(min_size, max_size + 1))
        k = min(k, n)
        edges.append(rng.choice(n, size=k, replace=False))
    return from_edge_lists(edges, n=n)


def planted_chain_hypergraph(n_chains: int, chain_len: int, overlap: int,
                             extra_size: int = 2, seed: int = 0) -> Hypergraph:
    """Chains of hyperedges with a planted overlap s — ground-truth MR along
    each chain is exactly ``overlap`` (plus |e| on the diagonal), used by
    property tests to pin known answers.
    """
    rng = np.random.default_rng(seed)
    edges = []
    base = 0
    for _ in range(n_chains):
        prev = [base + i for i in range(overlap + extra_size)]
        base += len(prev)
        edges.append(list(prev))
        for _ in range(chain_len - 1):
            shared = prev[-overlap:]
            fresh = [base + i for i in range(extra_size)]
            base += extra_size
            cur = shared + fresh
            edges.append(cur)
            prev = cur
    _ = rng  # reserved for future noise injection
    return from_edge_lists(edges)


def colocation_hypergraph(n_people: int, n_places: int, n_days: int,
                          p_checkin: float = 0.02, seed: int = 0) -> Hypergraph:
    """BrightKite-style co-location hypergraph for the epidemic case study
    (Exp-5): one hyperedge per (place, day) = set of people checked in.
    """
    rng = np.random.default_rng(seed)
    edges = []
    for _ in range(n_places * n_days):
        mask = rng.random(n_people) < p_checkin
        people = np.nonzero(mask)[0]
        if people.size >= 2:
            edges.append(people)
    return from_edge_lists(edges, n=n_people)


def paper_figure1() -> Hypergraph:
    """The running example of the paper (Figure 1).

    Reconstructed to satisfy every worked example in the text:
      * e2 and e5 share {v5, v6}; e5 ∩ e3 = {v10}               (Example 2)
      * {e2, e6} is a 2-walk joining v5 and v9; no 3-walk        (Example 1)
      * v1 reaches v10 via {e7, e2, e5} with WOD 2               (Example 3)
      * OD(e7, e4) = 2, |e7| = 3, |e4| = 4, |e1| = 2             (Examples 4/5)
      * Table II: |e2| = 6, (v9: e3@3, e6@3), (v10: e5@3, e3@3),
        OD(e2,e6) = 2, OD(e2,e4) = 2, OD(e2,e1) = 2, OD(e2,e7) = 3 …

    Vertex ids are v1..v12 -> 0..11; hyperedge ids e1..e7 -> 0..6.
    """
    e = {
        1: [1, 2],                  # e1 = {v1, v2}
        2: [3, 4, 5, 6, 7, 8],      # e2 = {v3..v8}
        3: [9, 10, 12],             # e3 = {v9, v10, v12}
        4: [3, 4, 11, 12],          # e4 = {v3, v4, v11, v12}
        5: [5, 6, 10],              # e5 = {v5, v6, v10}
        6: [7, 8, 9],               # e6 = {v7, v8, v9}
        7: [1, 3, 4],               # e7 = {v1, v3, v4}
    }
    return from_edge_lists([[v - 1 for v in e[i]] for i in range(1, 8)], n=12)
