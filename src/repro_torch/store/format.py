"""Versioned, mmap-loadable on-disk index format (layout ``aligned-segments-v1``).

One checkpoint is one file:

    [ 32-byte header | segment 0 | pad | segment 1 | ... | JSON manifest ]

* **header** — magic ``HLSTORE\\0``, the u32 format version, and the
  manifest's (offset, length, CRC-32), all little-endian.  The manifest
  lives at the *end* of the file so segment offsets can be recorded
  absolutely without a two-pass length fixup; a truncated file therefore
  fails the manifest CRC instead of loading silently.
* **segments** — each index array (labels, ranks, the hypergraph CSR,
  optional ``NeighborCSR`` / closure blocks) as one contiguous
  little-endian raw block, 64-byte aligned, with name / dtype / shape /
  offset / CRC-32 recorded in the manifest's segment table.
* **manifest** — JSON: format version, backend name, engine version
  lineage, payload kind, the engine options needed to reconstruct the
  update path (builder, minimizer, ...), index stats, and the segment
  table.

``load_index`` maps the whole file once (``np.memmap`` read-only) and
hands every array out as a zero-copy view into it, so a service restart
is page-in + one snapshot landing on the device — construction never
runs, and label bytes are identical to the saved engine's.
``verify=True`` (default) checks every segment CRC at load;
``verify=False`` defers integrity to the OS page cache for pure-lazy
startup.

Counterpart of ``repro/store/format.py``.  The format is the reference's,
byte for byte: for the same graph, options and update history both
packages write identical files, and each loads the other's.  Loaded
arrays stay read-only host views; whatever lands them in a tensor copies
them (``repro_torch.device.host_to_device``).  Not ported yet (roadmap
item A10b): the ``sharded`` backend's payloads — saving needs its engine,
and loading a ``sharded`` checkpoint raises ``NotImplementedError`` once
its manifest is read, before any array reaches the device — and
``mesh=``, which raises ``NotImplementedError``.
"""
from __future__ import annotations

import functools
import json
import os
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.engine import ClosureEngine, HLIndexBasicEngine, HLIndexEngine
from ..core.hlindex import HLIndex, build_basic, build_fast, build_sharded
from ..core.hypergraph import Hypergraph, NeighborCSR
from ..core.minimal import minimize
from ..device import DeviceLike, resolve_device

__all__ = [
    "FORMAT_VERSION", "FORMAT_REGISTRY", "MAGIC",
    "StoreError", "CorruptStore", "StoreUnsupported",
    "save_index", "load_index", "read_manifest", "load_segments",
]

MAGIC = b"HLSTORE\x00"

# On-disk format version -> layout codename.  Every version this build
# can *read* has a row here (the reference's table, unchanged).
FORMAT_VERSION = 1
FORMAT_REGISTRY: Dict[int, str] = {
    1: "aligned-segments-v1",
}

_ALIGN = 64
# magic[8] | format u32 | manifest offset u64 | manifest len u64 | crc u32
_HEADER = struct.Struct("<8sIQQI")

# backends whose resident structure serializes; everything else is
# index-free (online/frontier/mst-oracle/...) — rebuilding those is the
# cheap path by design, so persisting them would only persist the graph
_STORABLE = ("hl-index", "hl-index-basic", "closure", "sharded")


class StoreError(RuntimeError):
    """Persistence-layer misuse or lineage violation."""


class CorruptStore(StoreError):
    """A checkpoint file failed magic / CRC / structural validation."""


class StoreUnsupported(NotImplementedError):
    """Raised for engines whose backend has no serializable index form."""


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "loading onto a device mesh is not ported yet (roadmap item "
            "A10b: the sharded backend and its mesh); pass mesh=None")


# ---------------------------------------------------------------------------
# segment file primitives
# ---------------------------------------------------------------------------

def _le(a: np.ndarray) -> np.ndarray:
    """Contiguous little-endian view/copy of ``a`` (no-op on LE hosts)."""
    a = np.ascontiguousarray(a)
    if a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("<"))
    return a


def _crc(buf) -> int:
    return zlib.crc32(buf) & 0xFFFFFFFF


def _write_store_file(path, meta: Dict, segments: Sequence[Tuple[str, np.ndarray]]) -> Dict:
    """Write header + aligned segments + trailing manifest; fsync."""
    with open(path, "wb") as f:
        f.write(b"\x00" * _HEADER.size)
        off = _HEADER.size
        entries: List[Dict] = []
        for name, arr in segments:
            arr = _le(np.asarray(arr))
            pad = (-off) % _ALIGN
            f.write(b"\x00" * pad)
            off += pad
            data = arr.tobytes()
            f.write(data)
            entries.append({"name": name, "dtype": arr.dtype.str,
                            "shape": list(arr.shape), "offset": off,
                            "nbytes": len(data), "crc32": _crc(data)})
            off += len(data)
        manifest = dict(meta)
        manifest["format"] = FORMAT_VERSION
        manifest["layout"] = FORMAT_REGISTRY[FORMAT_VERSION]
        manifest["segments"] = entries
        blob = json.dumps(manifest, sort_keys=True).encode()
        f.write(blob)
        f.seek(0)
        f.write(_HEADER.pack(MAGIC, FORMAT_VERSION, off, len(blob),
                             _crc(blob)))
        f.flush()
        os.fsync(f.fileno())
    return manifest


def read_manifest(path) -> Dict:
    """Header + manifest of a checkpoint file (CRC-verified, no arrays)."""
    with open(path, "rb") as f:
        head = f.read(_HEADER.size)
        if len(head) < _HEADER.size:
            raise CorruptStore(f"{path}: truncated header "
                               f"({len(head)} < {_HEADER.size} bytes)")
        magic, fmt, moff, mlen, mcrc = _HEADER.unpack(head)
        if magic != MAGIC:
            raise CorruptStore(f"{path}: bad magic {magic!r} — not an "
                               f"HL-index store file")
        if fmt not in FORMAT_REGISTRY:
            raise CorruptStore(
                f"{path}: on-disk format version {fmt} is not readable by "
                f"this build (known: {sorted(FORMAT_REGISTRY)})")
        f.seek(moff)
        blob = f.read(mlen)
    if len(blob) != mlen or _crc(blob) != mcrc:
        raise CorruptStore(f"{path}: manifest checksum mismatch — the file "
                           f"is truncated or corrupt")
    return json.loads(blob)


def load_segments(path, *, verify: bool = True) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """(manifest, {segment name -> array}) with every array a zero-copy
    read-only view into one ``np.memmap`` of the file.  ``verify`` checks
    each segment's CRC-32 (reads every page once); ``verify=False`` keeps
    the load pure-lazy."""
    manifest = read_manifest(path)
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    arrays: Dict[str, np.ndarray] = {}
    for seg in manifest["segments"]:
        lo, hi = seg["offset"], seg["offset"] + seg["nbytes"]
        if hi > raw.size:
            raise CorruptStore(f"{path}: segment {seg['name']!r} extends "
                               f"past end of file")
        buf = raw[lo:hi]
        if verify and _crc(buf) != seg["crc32"]:
            raise CorruptStore(f"{path}: segment {seg['name']!r} checksum "
                               f"mismatch")
        arrays[seg["name"]] = buf.view(np.dtype(seg["dtype"])) \
                                 .reshape(seg["shape"])
    return manifest, arrays


# ---------------------------------------------------------------------------
# ragged list <-> (ptr, values) segments
# ---------------------------------------------------------------------------

def _ragged(arrs: Sequence[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    ptr = np.zeros(len(arrs) + 1, np.int64)
    if len(arrs):
        np.cumsum(np.fromiter((a.size for a in arrs), np.int64, len(arrs)),
                  out=ptr[1:])
        vals = (np.concatenate([np.asarray(a) for a in arrs])
                if int(ptr[-1]) else np.empty(0, np.int64))
    else:
        vals = np.empty(0, np.int64)
    return ptr, vals


def _unragged(ptr: np.ndarray, vals: np.ndarray) -> List[np.ndarray]:
    # rows are sliced from a plain ndarray view of the mapped segment
    # (still zero-copy, its base is the np.memmap): a slice of the
    # np.memmap itself runs memmap's Python __array_finalize__, which
    # made this loop most of a load on the 89k/70k index
    vals = np.asarray(vals)
    bounds = np.asarray(ptr).tolist()
    return [vals[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]


def _jsonable_stats(stats: Dict) -> Dict:
    out = {}
    for k, v in stats.items():
        if isinstance(v, (bool, int, np.integer)):
            out[k] = int(v)
        elif isinstance(v, (float, np.floating)):
            out[k] = float(v)
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

def _hlindex_opts(engine) -> Dict:
    """Recover the build options a restored engine needs so its *scoped
    update path* keeps using the same builder/minimizer as the original
    (construction mode, worker pool, cover_check for the basic variant)."""
    opts: Dict = {"construction": engine.construction,
                  "minimize_labels": engine._minimizer is not None}
    kw = dict(getattr(engine._builder, "keywords", {}))
    base = kw.pop("base", None)
    opts["workers"] = kw.get("workers")
    opts["num_shards"] = kw.get("num_shards")
    if engine.name == "hl-index-basic":
        src = getattr(base, "keywords", kw)
        opts["cover_check"] = bool(src.get("cover_check", True))
    return opts


def _hlindex_segments(idx: HLIndex) -> List[Tuple[str, np.ndarray]]:
    # the three per-vertex label lists share row lengths (one (edge,
    # rank, s) triple per label), so one ptr array indexes all three;
    # likewise one dual ptr for the per-hyperedge (vertex, s) pairs
    lptr, ledge = _ragged(idx.labels_edge)
    _, lrank = _ragged(idx.labels_rank)
    _, lsval = _ragged(idx.labels_s)
    dptr, dvert = _ragged(idx.dual_u)
    _, dsval = _ragged(idx.dual_s)
    return [("idx.rank", idx.rank), ("idx.perm", idx.perm),
            ("labels.ptr", lptr), ("labels.edge", ledge),
            ("labels.rank", lrank), ("labels.s", lsval),
            ("dual.ptr", dptr), ("dual.u", dvert), ("dual.s", dsval)]


def save_index(path, engine, *, neighbors: Optional[NeighborCSR] = None) -> Dict:
    """Serialize ``engine`` (graph + resident index structure + enough
    metadata to reconstruct its update path) into one checkpoint file at
    ``path``.  Returns the written manifest.

    Payload kinds by backend:

    * ``hl-index`` / ``hl-index-basic`` — rank, perm, label and dual
      lists as ragged (ptr, values) segments (payload ``labels``);
    * ``closure`` — the dense host ``int32`` W* matrix (payload
      ``closure``).

    ``neighbors`` optionally embeds a ``NeighborCSR`` block (segments
    ``nbr.*``) so a restart can skip the neighbor-overlap precompute;
    read it back via ``load_segments``.  Index-free backends raise
    ``StoreUnsupported`` — persisting them would persist nothing but the
    graph — and so does ``sharded``, whose engine is roadmap item A10b.
    """
    name = getattr(engine, "name", None)
    if name not in _STORABLE:
        raise StoreUnsupported(
            f"backend {name!r} has no serializable index structure; "
            f"storable backends: {list(_STORABLE)}")
    if name == "sharded":
        raise StoreUnsupported(
            "saving a 'sharded' engine is not ported yet (roadmap item "
            "A10b: the sharded backend and its store payloads)")
    h = engine.h
    meta: Dict = {"backend": name, "engine_version": int(engine.version),
                  "n": int(h.n), "m": int(h.m)}
    segments: List[Tuple[str, np.ndarray]] = [
        ("h.e_ptr", h.e_ptr), ("h.e_idx", h.e_idx),
        ("h.v_ptr", h.v_ptr), ("h.v_idx", h.v_idx)]

    if name in ("hl-index", "hl-index-basic"):
        meta["payload"] = "labels"
        meta["engine_opts"] = _hlindex_opts(engine)
        meta["stats"] = _jsonable_stats(engine.idx.stats)
        segments += _hlindex_segments(engine.idx)
    else:                                              # closure
        meta["payload"] = "closure"
        meta["engine_opts"] = {"method": engine._method}
        segments.append(("w_star", np.asarray(engine.w_star)))

    if neighbors is not None:
        segments += [("nbr.ptr", neighbors.ptr), ("nbr.idx", neighbors.idx),
                     ("nbr.od", neighbors.od)]
    return _write_store_file(path, meta, segments)


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------

def _hlindex_builder(backend: str, opts: Dict):
    workers = opts.get("workers")
    num_shards = opts.get("num_shards")
    if backend == "hl-index-basic":
        base = functools.partial(build_basic,
                                 cover_check=opts.get("cover_check", True))
    else:
        base = build_fast
    if opts.get("construction") == "sharded":
        if backend == "hl-index-basic":
            return functools.partial(build_sharded, base=base,
                                     workers=workers, num_shards=num_shards)
        return functools.partial(build_sharded, workers=workers,
                                 num_shards=num_shards)
    return base


def _load_hlindex(h: Hypergraph, manifest: Dict, seg: Dict[str, np.ndarray]) -> HLIndex:
    lptr = seg["labels.ptr"]
    dptr = seg["dual.ptr"]
    return HLIndex(h=h, rank=seg["idx.rank"], perm=seg["idx.perm"],
                   labels_edge=_unragged(lptr, seg["labels.edge"]),
                   labels_rank=_unragged(lptr, seg["labels.rank"]),
                   labels_s=_unragged(lptr, seg["labels.s"]),
                   dual_u=_unragged(dptr, seg["dual.u"]),
                   dual_s=_unragged(dptr, seg["dual.s"]),
                   stats=dict(manifest.get("stats", {})))


def load_index(path, *, device: DeviceLike = None, mesh=None,
               verify: bool = True, expect_backend: Optional[str] = None):
    """Load a checkpoint written by ``save_index`` (of either package)
    back into a live engine.  Label/rank/CSR arrays — and a closure's
    W* — are zero-copy read-only views into one ``np.memmap`` of the
    file, byte-identical to the saved engine's and paged in lazily, and
    ``engine.version`` resumes the saved lineage.  ``device`` is where
    the engine's snapshot lands (``None`` means ``"cuda"`` and raises on
    a host without a CUDA device, as ``build`` does); nothing reaches it
    until the first batch query or ``snapshot()``.  ``expect_backend``
    asserts the checkpoint's backend.

    A ``sharded`` checkpoint and ``mesh=`` raise ``NotImplementedError``
    (roadmap item A10b)."""
    _refuse_mesh(mesh)
    dev = resolve_device(device)
    manifest = read_manifest(path)
    backend = manifest["backend"]
    if expect_backend is not None and backend != expect_backend:
        raise StoreError(
            f"{path} holds a {backend!r} checkpoint, not the requested "
            f"{expect_backend!r}")
    if backend == "sharded":
        raise NotImplementedError(
            f"{path} holds a 'sharded' checkpoint (payload "
            f"{manifest.get('payload')!r}); loading it is not ported yet "
            f"(roadmap item A10b: the sharded backend and its store "
            f"payloads)")
    manifest, seg = load_segments(path, verify=verify)
    h = Hypergraph(n=int(manifest["n"]), m=int(manifest["m"]),
                   e_ptr=seg["h.e_ptr"], e_idx=seg["h.e_idx"],
                   v_ptr=seg["h.v_ptr"], v_idx=seg["h.v_idx"])
    opts = manifest.get("engine_opts", {})
    version = int(manifest["engine_version"])
    if backend == "closure":
        eng = ClosureEngine(h, seg["w_star"],
                            method=opts.get("method", "maxmin"), device=dev)
    else:
        cls = HLIndexEngine if backend == "hl-index" else HLIndexBasicEngine
        idx = _load_hlindex(h, manifest, seg)
        minimizer = minimize if opts.get("minimize_labels") else None
        eng = cls(h, idx, builder=_hlindex_builder(backend, opts),
                  minimizer=minimizer, device=dev)
        eng.construction = opts.get("construction", "serial")
    eng.version = version
    return eng
