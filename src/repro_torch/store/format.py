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
them (``repro_torch.device.host_to_device``).  A ``sharded`` checkpoint
holds one of three payloads (labels, a float32 closure trimmed to edge-id
order, or the resident snapshot with its slot map) and loads onto the
mesh ``load_index(mesh=)`` names, re-padded for that grid.

On ranks (an engine built on a ``ProcessMesh``, ``load_index(mesh=pm)``)
every rank calls with the same path: global rank 0 writes the file and
the others write nothing, every rank returns the same manifest, and a
failed write raises on every rank.  A closure's W* crosses to rank 0 one
block at a time into host memory and lands one block a rank on load
(sliced from the mapped file), so no device ever holds the whole.  The
ranks share one filesystem (one machine, or a shared mount).
"""
from __future__ import annotations

import functools
import json
import os
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from ..core.engine import ClosureEngine, HLIndexBasicEngine, HLIndexEngine
from ..core.hlindex import HLIndex, build_basic, build_fast, build_sharded
from ..core.hypergraph import Hypergraph, NeighborCSR
from ..core import collectives as coll
from ..core.mesh import LogicalMesh, ProcessMesh
from ..core.minimal import minimize
from ..core.query import DeviceSnapshot
from ..device import DeviceLike, host_to_device, resolve_device

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
      ``closure``);
    * ``sharded`` — its labels (payload ``labels``, with the engine's
      ``NeighborCSR`` by default), its resident float32 W* gathered in
      slot order and trimmed to ``[m, m]`` (payload ``closure``, re-padded
      for whatever mesh loads it), or, once ``snapshot()`` freed W*, the
      snapshot and its slot map (payload ``snapshot``).

    ``neighbors`` optionally embeds a ``NeighborCSR`` block (segments
    ``nbr.*``) so a restart can skip the neighbor-overlap precompute;
    read it back via ``load_segments``.  Index-free backends raise
    ``StoreUnsupported`` — persisting them would persist nothing but the
    graph.

    On an engine built on ranks (``rank_mesh``) every rank calls this
    with the same ``path`` (module docstring): labels and a snapshot are
    whole on every rank and rank 0 writes its own; a closure's W* blocks
    cross to rank 0 one at a time into host memory.
    """
    name = getattr(engine, "name", None)
    if name not in _STORABLE:
        raise StoreUnsupported(
            f"backend {name!r} has no serializable index structure; "
            f"storable backends: {list(_STORABLE)}")
    ranks = getattr(engine, "rank_mesh", None)
    if ranks is not None:
        return _save_on_ranks(path, engine, neighbors, ranks)
    meta, segments = _payload(engine, neighbors)
    return _write_store_file(path, meta, segments)


def _save_on_ranks(path, engine, neighbors, mesh: ProcessMesh) -> Dict:
    """``save_index`` on ranks: what must be collective first (the W*
    blocks' crossing, a snapshot derivation), then rank 0's write, one
    status word, and rank 0's manifest broadcast to every rank."""
    w_star = None
    if engine.name == "sharded" and engine._idx is None:
        if engine._w_star is not None:
            w_star = _closure_on_rank0(engine, mesh)
        else:
            engine.snapshot()        # its derivation may be collective
    manifest, error = None, None
    if mesh.rank == 0:
        try:
            meta, segments = _payload(engine, neighbors, w_star)
            manifest = _write_store_file(path, meta, segments)
        except Exception as exc:     # every rank raises below
            error = exc
    coll.agree_or_raise(mesh, "save_index", error)
    return coll.broadcast_json(manifest, mesh)


def _closure_on_rank0(engine, mesh: ProcessMesh) -> Optional[np.ndarray]:
    """The resident W* of a ``sharded`` engine on ranks in slot order,
    trimmed to ``[m, m]`` float32, assembled on rank 0's host from the
    blocks (each other rank's crosses alone, point to point); ``None`` on
    the other ranks.  The ranks off the two block axes' first line hold
    copies and send nothing."""
    blk = engine._w_star
    row_ax, col_ax = engine.axes
    br, bc = (int(x) for x in blk.shape)
    slot_of = np.asarray(engine._slot_of, np.int64)
    m = int(slot_of.size)
    out = np.zeros((m, m), np.float32) if mesh.rank == 0 else None
    like = torch.empty(0, dtype=blk.dtype, device=coll.exchange_device(mesh))
    ri = mesh.axis_names.index(row_ax)
    ci = mesh.axis_names.index(col_ax)
    for k in range(mesh.world_size):
        coords = np.unravel_index(k, mesh.dims)
        if any(int(x) for a, x in enumerate(coords) if a not in (ri, ci)):
            continue
        if k != 0 and mesh.rank == k:
            coll.exchange_pieces({0: blk}, {}, blk, mesh)
        if mesh.rank != 0:
            continue
        piece = blk if k == 0 else coll.exchange_pieces(
            {}, {k: (br, bc)}, like, mesh)[k]
        i, j = int(coords[ri]), int(coords[ci])
        rows = np.nonzero((slot_of >= i * br) & (slot_of < (i + 1) * br))[0]
        cols = np.nonzero((slot_of >= j * bc) & (slot_of < (j + 1) * bc))[0]
        out[np.ix_(rows, cols)] = piece.cpu().numpy()[np.ix_(
            slot_of[rows] - i * br, slot_of[cols] - j * bc)]
    return out


def _payload(engine, neighbors: Optional[NeighborCSR] = None,
             w_star: Optional[np.ndarray] = None
             ) -> Tuple[Dict, List[Tuple[str, np.ndarray]]]:
    """The manifest fields and segments of ``engine``'s checkpoint
    (``w_star``: a ``sharded`` closure already assembled in slot order,
    on ranks)."""
    name = engine.name
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
    elif name == "closure":
        meta["payload"] = "closure"
        meta["engine_opts"] = {"method": engine._method}
        segments.append(("w_star", np.asarray(engine.w_star)))
    else:                                              # sharded
        meta["engine_opts"] = {
            "schedule": engine.schedule, "axes": list(engine.axes),
            "rounds": engine.rounds, "workers": engine._workers,
            "num_shards": engine._num_shards,
            "minimize_labels": engine._minimizer is not None,
        }
        if engine._idx is not None:
            meta["payload"] = "labels"
            meta["stats"] = _jsonable_stats(engine._idx.stats)
            segments += _hlindex_segments(engine._idx)
            if neighbors is None:
                # persist the engine's own neighbor index by default, so
                # a restarted engine resumes 1-hop-patched scoped updates
                # without re-running the pair pass
                neighbors = engine._nbr
        elif engine._w_star is not None:
            # gather in slot order and trim the mesh padding: the saved
            # W* is mesh- and slot-layout-independent (edge-id order),
            # re-padded for whatever mesh loads it
            meta["payload"] = "closure"
            if w_star is None:
                slots = torch.from_numpy(engine._slot_of).to(
                    engine._w_star.device)
                w = engine._w_star.index_select(0, slots).index_select(
                    1, slots)
                w_star = np.ascontiguousarray(w.cpu().numpy())
            segments.append(("w_star", w_star))
        else:
            # snapshot() freed the closure; the resident snapshot IS the
            # serving structure now, so persist exactly it — plus the
            # slot map, which scoped updates on the restored engine need
            # to patch the right snapshot columns
            meta["payload"] = "snapshot"
            snap = engine.snapshot()
            segments += [("snap.ranks", snap.ranks.cpu().numpy()),
                         ("snap.svals", snap.svals.cpu().numpy()),
                         ("snap.lengths", snap.lengths.cpu().numpy()),
                         ("snap.slots", np.asarray(engine._slot_of))]

    if neighbors is not None:
        segments += [("nbr.ptr", neighbors.ptr), ("nbr.idx", neighbors.idx),
                     ("nbr.od", neighbors.od)]
    return meta, segments


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


def _load_sharded(h: Hypergraph, manifest: Dict, seg: Dict[str, np.ndarray],
                  mesh, device: DeviceLike):
    from ..core.distributed import ShardedEngine, block_of, pad_for_mesh
    from ..core.mesh import default_line_graph_mesh

    opts = manifest.get("engine_opts", {})
    axes = tuple(opts.get("axes") or ("data", "model"))
    if mesh is None:
        mesh = default_line_graph_mesh(axes, device=device)
    else:
        axes = tuple(mesh.axis_names[-2:])
    schedule = opts.get("schedule", "allgather")
    rounds = opts.get("rounds")
    workers = opts.get("workers")
    num_shards = opts.get("num_shards")
    payload = manifest["payload"]
    version = int(manifest["engine_version"])

    if payload == "labels":
        idx = _load_hlindex(h, manifest, seg)
        minimizer = minimize if opts.get("minimize_labels") else None
        nbr = (NeighborCSR(seg["nbr.ptr"], seg["nbr.idx"], seg["nbr.od"])
               if "nbr.ptr" in seg else None)
        eng = ShardedEngine(h, mesh, axes, schedule, None, h.m, rounds,
                            idx=idx, minimizer=minimizer, workers=workers,
                            num_shards=num_shards, neighbors=nbr)
    elif payload == "closure":
        # re-pad for the loading mesh (zeros are the (max, min)
        # annihilator, so padding is invariant under the closure) and
        # land it whole on the mesh's device — the layout build makes
        # (host_to_device copies the file's read-only pages: the engine
        # patches W* in place); on ranks only this rank's block, sliced
        # from the mapped file
        if isinstance(mesh, ProcessMesh):
            w_dev = block_of(seg["w_star"], mesh, axes)
        else:
            w_dev = pad_for_mesh(host_to_device(seg["w_star"], mesh.device),
                                 mesh, axes)
        eng = ShardedEngine(h, mesh, axes, schedule, w_dev, h.m, rounds,
                            workers=workers, num_shards=num_shards)
    elif payload == "snapshot":
        eng = ShardedEngine(h, mesh, axes, schedule, None, h.m, rounds,
                            workers=workers, num_shards=num_shards)
        snap = DeviceSnapshot(
            ranks=host_to_device(seg["snap.ranks"], mesh.device),
            svals=host_to_device(seg["snap.svals"], mesh.device),
            lengths=host_to_device(seg["snap.lengths"], mesh.device),
            backend="sharded", version=version)
        if isinstance(mesh, ProcessMesh) and snap.ranks.numel():
            snap = _replicated(snap, mesh, axes)
        elif int(mesh.devices.size) > 1 and snap.ranks.numel():
            snap = snap.to_mesh(mesh, axes)
        eng._snap = snap
        # restore the slot layout so scoped updates keep patching the
        # right columns; the padded width is the loaded snapshot's
        eng._m_padded = int(snap.ranks.shape[1])
        if "snap.slots" in seg:
            eng._slot_of = np.asarray(seg["snap.slots"], np.int64)
    else:
        raise CorruptStore(f"unknown sharded payload {payload!r}")
    eng.version = version
    return eng


def _replicated(snap: DeviceSnapshot, mesh: ProcessMesh,
                axes: Tuple[str, str]) -> DeviceSnapshot:
    """A closure snapshot whole on every rank, as the closure regime
    keeps it there: padded to the grid (sentinel rows and columns, as
    ``to_mesh`` pads) and recording the mesh."""
    r, c = mesh.shape[axes[0]], mesh.shape[axes[1]]
    n, lmax = (int(x) for x in snap.ranks.shape)
    pr, pc = (-n) % r, (-lmax) % c
    pad = torch.nn.functional.pad
    return DeviceSnapshot(
        ranks=pad(snap.ranks, (0, pc, 0, pr), value=np.iinfo(np.int32).max),
        svals=pad(snap.svals, (0, pc, 0, pr)),
        lengths=pad(snap.lengths, (0, pr)), backend=snap.backend,
        version=snap.version, mesh=mesh, axes=axes)


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

    ``mesh`` (a ``LogicalMesh``) is where a ``sharded`` checkpoint's
    structures land, re-padded for its grid; without one they land on
    ``default_line_graph_mesh`` of ``device``.  With a mesh and no
    ``device``, the mesh's device is taken.

    On a ``ProcessMesh`` every rank calls this with the same file and
    maps it: a ``sharded`` engine loads on the ranks (labels landing as
    blocks, a closure's W* as this rank's block of the padded whole, a
    snapshot replicated), and the other backends load whole on every
    rank with ``rank_mesh`` set, updating on the ranks as an engine built
    there does."""
    if device is None and isinstance(mesh, (LogicalMesh, ProcessMesh)):
        device = mesh.device
    dev = resolve_device(device)
    manifest, seg = load_segments(path, verify=verify)
    backend = manifest["backend"]
    if expect_backend is not None and backend != expect_backend:
        raise StoreError(
            f"{path} holds a {backend!r} checkpoint, not the requested "
            f"{expect_backend!r}")
    h = Hypergraph(n=int(manifest["n"]), m=int(manifest["m"]),
                   e_ptr=seg["h.e_ptr"], e_idx=seg["h.e_idx"],
                   v_ptr=seg["h.v_ptr"], v_idx=seg["h.v_idx"])
    if backend == "sharded":
        return _load_sharded(h, manifest, seg, mesh, dev)
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
    if isinstance(mesh, ProcessMesh):
        eng.rank_mesh = mesh     # whole on every rank, updated alike
    eng.version = version
    return eng
