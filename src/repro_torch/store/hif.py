"""HIF (Hypergraph Interchange Format) import/export.

HIF is the community-standard JSON schema for exchanging hypergraphs
(https://github.com/pszufe/HIF-standard): a top-level object with
``network-type``, optional ``metadata``, and three arrays —

    "nodes":      [{"node": <id>, ...}, ...]        (may be empty)
    "edges":      [{"edge": <id>, ...}, ...]        (may be empty)
    "incidences": [{"edge": <id>, "node": <id>}, ...]

Node/edge ids are arbitrary JSON scalars (strings, ints); the importer
densifies them by first appearance — the ``nodes``/``edges`` arrays
first (so isolated vertices and their declared order survive), then the
incidence stream.  Within one hyperedge, duplicate (edge, node)
incidences canonicalize away (``from_edge_lists`` dedup-sorts members,
as everywhere in this repo); *distinct hyperedges with identical member
sets are preserved* — only ``Hypergraph.compact`` merges those.  Edges
declared with no incidences are dropped — a memberless hyperedge has no
reachability meaning here.  Directed networks are rejected.

``write_hif`` emits dense integer ids, so import → export → import is
an identity on the ``Hypergraph`` arrays.

Counterpart of ``repro/store/hif.py``, over the port's
``from_edge_lists``: both packages read a file into identical arrays and
write identical files.
"""
from __future__ import annotations

import json
from typing import Optional

from ..core.hypergraph import Hypergraph, from_edge_lists

__all__ = ["read_hif", "write_hif"]


def _scalar_id(entry, key):
    """An HIF array entry is either a bare scalar id or an object
    carrying the id under ``key``."""
    if isinstance(entry, dict):
        if key not in entry:
            raise ValueError(f"HIF {key} record without a {key!r} field: "
                             f"{entry!r}")
        return entry[key]
    return entry


def read_hif(path) -> Hypergraph:
    """Load an HIF JSON file as a dense :class:`Hypergraph`."""
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "incidences" not in doc:
        raise ValueError(f"{path}: not an HIF document (no 'incidences')")
    ntype = doc.get("network-type", "undirected")
    if ntype == "directed":
        raise ValueError(f"{path}: directed HIF networks are not supported "
                         f"(reachability here is undirected set-overlap)")

    node_ids: dict = {}
    edge_ids: dict = {}

    def node_of(raw) -> int:
        if raw not in node_ids:
            node_ids[raw] = len(node_ids)
        return node_ids[raw]

    def edge_of(raw) -> int:
        if raw not in edge_ids:
            edge_ids[raw] = len(edge_ids)
        return edge_ids[raw]

    for entry in doc.get("nodes", []):
        node_of(_scalar_id(entry, "node"))
    for entry in doc.get("edges", []):
        edge_of(_scalar_id(entry, "edge"))

    members = [[] for _ in range(len(edge_ids))]
    for inc in doc["incidences"]:
        if not isinstance(inc, dict) or "edge" not in inc or "node" not in inc:
            raise ValueError(f"{path}: malformed incidence record: {inc!r}")
        e = edge_of(inc["edge"])
        while e >= len(members):
            members.append([])
        members[e].append(node_of(inc["node"]))

    # memberless hyperedges carry no reachability information — drop them
    edges = [mem for mem in members if mem]
    return from_edge_lists(edges, n=len(node_ids))


def write_hif(path, h: Hypergraph, *, metadata: Optional[dict] = None) -> None:
    """Write ``h`` as an HIF JSON file with dense integer ids."""
    doc = {
        "network-type": "undirected",
        "metadata": dict(metadata) if metadata else {},
        "nodes": [{"node": int(v)} for v in range(h.n)],
        "edges": [{"edge": int(e)} for e in range(h.m)],
        "incidences": [
            {"edge": int(e), "node": int(h.e_idx[k])}
            for e in range(h.m)
            for k in range(int(h.e_ptr[e]), int(h.e_ptr[e + 1]))
        ],
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
