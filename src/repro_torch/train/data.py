"""Data pipeline: deterministic synthetic LM streams and the hypergraph
dedup / contamination stage.

Counterpart of ``repro/train/data.py``: the same numpy draws from the
same seeds, so both packages train on the same batches.  The batches are
numpy; the train step moves them to the model's device.

Dedup semantics: each document is a hyperedge over its k-gram shingle
vertices; two documents are "s-contaminated" iff they are s-reachable at
threshold ``s`` (a chain of documents, each sharing at least s shingles
with the next: transitive near-duplicate clusters, not just pairs).
``dedup_corpus`` keeps one representative per s-component, the
hyperedge-level s-reachability equivalence of the paper, on this
package's own ``core.hypergraph`` and ``core.baselines``.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core.baselines import _DSU, line_graph_edges
from ..core.hypergraph import Hypergraph, from_edge_lists
from ..models.common import ArchConfig

__all__ = ["SyntheticStream", "make_batch", "shingle_hypergraph",
           "dedup_corpus"]


class SyntheticStream:
    """Infinite deterministic token stream: token sequences drawn from a
    per-shard rng (``shard`` / ``num_shards``: the process index on
    several hosts) with a mild Zipf skew, so losses are learnable."""

    def __init__(self, cfg: ArchConfig, batch: int, seq: int, *,
                 seed: int = 0, shard: int = 0, num_shards: int = 1):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.rng = np.random.default_rng(seed * num_shards + shard)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = 1.0 / ranks
        self.p = p / p.sum()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        return make_batch(self.cfg, self.batch, self.seq, self.rng, self.p)


def make_batch(cfg: ArchConfig, batch: int, seq: int,
               rng: np.random.Generator,
               p: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """One batch for any family (with the stub modality inputs the family
    needs); tokens / labels are next-token shifted."""
    stream = rng.choice(cfg.vocab, size=(batch, seq + 1),
                        p=p) if p is not None else \
        rng.integers(0, cfg.vocab, (batch, seq + 1))
    out: Dict[str, np.ndarray] = {
        "tokens": stream[:, :-1].astype(np.int32),
        "labels": stream[:, 1:].astype(np.int32),
    }
    if cfg.family == "vlm":
        np_ = min(cfg.num_patches, seq // 2)
        out["tokens"] = out["tokens"][:, :seq - np_]
        out["patch_embeds"] = rng.normal(
            size=(batch, np_, cfg.vision_dim)).astype(np.float32)
    elif cfg.family == "encdec":
        out["frames"] = rng.normal(
            size=(batch, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# hypergraph dedup stage
# ---------------------------------------------------------------------------

def shingle_hypergraph(docs: Sequence[np.ndarray], k: int = 4,
                       num_buckets: int = 1 << 20) -> Hypergraph:
    """Documents (token id arrays) -> hypergraph: one hyperedge per
    document over its hashed k-gram shingle vertices, re-indexed
    densely."""
    edges: List[np.ndarray] = []
    mult = np.uint64(1000003)
    for doc in docs:
        d = np.asarray(doc, np.uint64)
        if d.size < k:
            h = d
        else:
            h = np.zeros(d.size - k + 1, np.uint64)
            for i in range(k):
                h = h * mult + d[i:d.size - k + 1 + i]
        edges.append(np.unique(h % np.uint64(num_buckets)).astype(np.int64))
    all_v = np.unique(np.concatenate(edges)) if edges else np.empty(0, np.int64)
    remap = {int(v): i for i, v in enumerate(all_v)}
    dense = [np.array([remap[int(v)] for v in e], np.int64) for e in edges]
    return from_edge_lists(dense, n=len(all_v))


def dedup_corpus(docs: Sequence[np.ndarray], s: int, k: int = 4
                 ) -> Tuple[List[int], np.ndarray]:
    """Keep one representative per s-reachability component of the
    shingle hypergraph -> (kept document indices, component id per
    document)."""
    h = shingle_hypergraph(docs, k)
    src, dst, od = line_graph_edges(h)
    dsu = _DSU(h.m)
    for a, b, w in zip(src, dst, od):
        if w >= s:
            dsu.union(int(a), int(b))
    comp = np.array([dsu.find(e) for e in range(h.m)], np.int64)
    kept: List[int] = []
    seen = set()
    for i, c in enumerate(comp):
        if int(c) not in seen:
            seen.add(int(c))
            kept.append(i)
    return kept, comp
