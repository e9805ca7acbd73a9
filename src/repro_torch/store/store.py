"""Durable store directory: checkpoints + WAL + atomic CURRENT pointer.

Layout of a store directory::

    CURRENT                      -> name of the live checkpoint (atomic)
    checkpoint-<version>.hlidx   -> one save_index file (format.py)
    wal-<version>.log            -> the update journal following it

``checkpoint(engine)`` writes the index file (to a temp name, then
``os.replace`` + directory fsync — the file named by ``CURRENT`` is
always complete), rotates the WAL to a fresh ``wal-<version>.log``, and
deletes superseded checkpoint/WAL files — that deletion *is* the
periodic log compaction: every journaled record at or below the new
checkpoint's version is now redundant.

``restore()`` is the warm-restart path: load the ``CURRENT`` checkpoint
(mmap, no construction — ``format.load_index``) and replay the WAL's
delta suffix through the engine's own ``update`` path, so scoped
maintenance and the dirty-rows contract apply exactly as they did live.
A torn final record (crash mid-append) is dropped by checksum, never an
error.  The store then re-attaches as the engine's WAL sink, so serving
resumes with the same durability guarantees.

The store *is* the engine's WAL sink (``engine.attach_wal(store)``):
``append`` journals before the apply, ``committed`` runs after it and
triggers auto-compaction once ``checkpoint_every`` records accumulate.

Counterpart of ``repro/store/store.py``; a store directory written by
either package restores in the other.  ``restore`` and
``restore_engine`` take ``device=`` (where the restored engine's
snapshot lands; ``None`` means ``"cuda"``, as everywhere in the port).

On ranks (an engine on a ``ProcessMesh``; ``restore(mesh=pm)``) every
rank calls each method alike.  Global rank 0 writes the checkpoint
files, ``CURRENT`` and the log; the other ranks write nothing and keep
only the log's lineage (``_LogView``).  Every rank checks the lineage on
``attach``.  An update journals on rank 0 (with its fsync) before any
rank applies it: the engine's ``update`` crosses the appends' status to
every rank first, so a failed append raises on every rank and no rank's
state changes.
``restore`` reads the same checkpoint and log on every rank and replays
the same records as updates on the ranks.  The ranks share the store's
filesystem: one machine, or a shared mount.  The files are the
reference's, byte for byte.
"""
from __future__ import annotations

import os
import pathlib
from typing import Optional

from ..core import collectives as coll
from ..device import DeviceLike
from .format import (CorruptStore, StoreError, load_index, read_manifest,
                     save_index)
from .wal import WriteAheadLog, scan_wal

__all__ = ["IndexStore", "restore_engine"]

_CKPT_FMT = "checkpoint-{:012d}.hlidx"
_WAL_FMT = "wal-{:012d}.log"


def _fsync_dir(path) -> None:
    """Make a directory entry rename durable (POSIX; no-op elsewhere)."""
    try:
        fd = os.open(os.fspath(path), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class _LogView:
    """A follower rank's view of the log rank 0 writes: its lineage
    (last version, record count), read from the file and never written.
    ``append`` checks a record's version as the log does; ``committed``
    moves the lineage once the update applied, so only after every
    rank's append, rank 0's durable one included, succeeded."""

    def __init__(self, path, *, base_version: int):
        self.path = os.fspath(path)
        records = scan_wal(self.path)[0]
        self.last_version = (int(records[-1][0]) if records
                             else int(base_version))
        self.count = len(records)
        self._pending: Optional[int] = None

    def append(self, version: int, inserts, deletes) -> None:
        if int(version) != self.last_version + 1:
            raise StoreError(
                f"WAL versions are monotonic: expected record "
                f"{self.last_version + 1}, got {version}")
        self._pending = int(version)

    def committed(self) -> None:
        if self._pending is not None:
            self.last_version, self._pending = self._pending, None
            self.count += 1

    def close(self) -> None:
        pass


def _writes(engine) -> bool:
    """Whether this process writes the store's files for ``engine``:
    always off ranks, on global rank 0 alone on them."""
    mesh = getattr(engine, "rank_mesh", None)
    return mesh is None or mesh.rank == 0


def _settle(engine, what: str, error: Optional[BaseException]) -> None:
    """Off ranks, raise ``error``; on ranks, one status word, so a
    failure on any rank raises on every rank."""
    mesh = getattr(engine, "rank_mesh", None)
    if mesh is not None:
        coll.agree_or_raise(mesh, what, error)
    elif error is not None:
        raise error


class IndexStore:
    """One durable home for one engine lineage.

    Args:
      path: store directory (created if missing).
      checkpoint_every: auto-compact — write a fresh checkpoint and
        truncate the log once this many WAL records accumulate (None =
        only explicit ``checkpoint()`` calls compact).
      verify: CRC-check checkpoint segments on restore (default True).
    """

    def __init__(self, path, *, checkpoint_every: Optional[int] = None,
                 verify: bool = True):
        self.path = pathlib.Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self.checkpoint_every = checkpoint_every
        self.verify = verify
        self._wal: Optional[WriteAheadLog] = None

    # -- inspection --------------------------------------------------------

    def current_checkpoint(self) -> Optional[pathlib.Path]:
        cur = self.path / "CURRENT"
        if not cur.is_file():
            return None
        return self.path / cur.read_text().strip()

    @property
    def checkpoint_version(self) -> Optional[int]:
        p = self.current_checkpoint()
        if p is None:
            return None
        return int(p.name[len("checkpoint-"):].split(".")[0])

    @property
    def records_since_checkpoint(self) -> int:
        return self._wal.count if self._wal is not None else 0

    def manifest(self) -> dict:
        p = self.current_checkpoint()
        if p is None:
            raise StoreError(f"{self.path}: no checkpoint yet")
        return read_manifest(p)

    # -- checkpoint + compaction -------------------------------------------

    def checkpoint(self, engine, *, neighbors=None) -> pathlib.Path:
        """Write a checkpoint of ``engine`` at its current version,
        atomically swing ``CURRENT`` to it, rotate the WAL, and delete
        superseded files (log compaction).  Safe at any point of the
        lineage; crash-safe at every step (the temp file is renamed into
        place before ``CURRENT`` moves).  On ranks rank 0 writes and
        rotates; the others start an empty view of the new log."""
        version = int(engine.version)
        name = _CKPT_FMT.format(version)
        final = self.path / name
        tmp = self.path / (name + ".tmp")
        save_index(tmp, engine, neighbors=neighbors)
        error = None
        wal_path = self.path / _WAL_FMT.format(version)
        if _writes(engine):
            try:
                self._install(tmp, final, name, wal_path, version)
            except Exception as exc:       # on ranks every rank raises
                error = exc
        _settle(engine, "checkpoint", error)
        if not _writes(engine):            # rank 0 has rotated the log
            self._wal = _LogView(wal_path, base_version=version)
        return final

    def _install(self, tmp, final, name: str, wal_path, version: int):
        """Rename the written checkpoint into place, swing ``CURRENT``,
        rotate the log and delete what they supersede."""
        os.replace(tmp, final)
        cur_tmp = self.path / "CURRENT.tmp"
        cur_tmp.write_text(name + "\n")
        os.replace(cur_tmp, self.path / "CURRENT")
        _fsync_dir(self.path)
        # rotate: a fresh (empty) log follows this checkpoint — any
        # record at or below `version` is baked into the file just
        # written, so the old logs (and checkpoints) are compacted away
        if self._wal is not None:
            self._wal.close()
        if wal_path.exists():
            wal_path.unlink()
        self._wal = WriteAheadLog(wal_path, base_version=version)
        for p in self.path.glob("checkpoint-*.hlidx"):
            if p.name != name:
                p.unlink()
        for p in self.path.glob("wal-*.log"):
            if p != wal_path:
                p.unlink()
        for p in self.path.glob("*.tmp"):
            p.unlink()

    # -- the engine-facing WAL sink protocol -------------------------------

    def attach(self, engine) -> None:
        """Make this store ``engine``'s WAL sink: every subsequent
        ``engine.update`` journals durably here before applying.  The
        engine must continue the store's lineage (checkpoint version +
        logged records == engine version); an empty store seeds itself
        with a checkpoint of the engine first.  On ranks every rank
        checks the lineage (rank 0 opens the log, the others read it),
        and a mismatch on any rank raises on every rank."""
        ck = self.checkpoint_version
        if ck is None:
            self.checkpoint(engine)
            engine.attach_wal(self)
            return
        error = None
        try:
            if self._wal is None:
                path = self.path / _WAL_FMT.format(ck)
                self._wal = (WriteAheadLog(path, base_version=ck)
                             if _writes(engine)
                             else _LogView(path, base_version=ck))
            if int(engine.version) != self._wal.last_version:
                raise StoreError(
                    f"engine version {engine.version} does not continue "
                    f"this store's lineage (checkpoint {ck} + "
                    f"{self._wal.count} logged updates = version "
                    f"{self._wal.last_version}); checkpoint() it instead")
        except Exception as exc:
            error = exc
        _settle(engine, "attach", error)
        engine.attach_wal(self)

    def append(self, version: int, inserts, deletes) -> None:
        """WAL sink: journal one update durably (called by
        ``engine.update`` *before* the in-memory apply).  On ranks rank 0
        appends (with its fsync) and the other ranks check the record's
        version against their view of the log; the engine's ``update``
        then settles the status across the ranks."""
        if self._wal is None:
            raise StoreError("store has no open WAL; call checkpoint() or "
                             "attach() first")
        self._wal.append(version, inserts, deletes)

    def committed(self, engine) -> None:
        """WAL sink: the update applied (on ranks, a follower's view of
        the log moves on to its record); compact if the log grew past
        ``checkpoint_every`` records."""
        if isinstance(self._wal, _LogView):
            self._wal.committed()
        if (self.checkpoint_every is not None and self._wal is not None
                and self._wal.count >= int(self.checkpoint_every)):
            self.checkpoint(engine)

    # -- warm restart ------------------------------------------------------

    def restore(self, *, device: DeviceLike = None, mesh=None,
                verify: Optional[bool] = None,
                expect_backend: Optional[str] = None, attach: bool = True):
        """Load the ``CURRENT`` checkpoint and replay the WAL suffix.

        The checkpoint loads mmap-backed (no construction) onto
        ``device``; each logged record replays through ``engine.update``
        — the same scoped maintenance + dirty-rows path live updates
        took — with the WAL detached, so replay never re-journals.
        Replay asserts version contiguity; a torn/corrupt tail record was
        already dropped by the checksum scan.  With ``attach`` (default)
        the store then re-attaches as the engine's WAL sink and serving
        can resume.  ``mesh`` (a ``LogicalMesh``) is where a ``sharded``
        checkpoint lands, re-padded for its grid (``load_index``).  With
        a ``ProcessMesh`` every rank calls this: each loads on the ranks,
        reads the same log (rank 0 opening it, which drops a torn tail)
        and replays the same records as updates on the ranks.
        """
        p = self.current_checkpoint()
        if p is None:
            raise StoreError(f"{self.path}: nothing to restore "
                             f"(no CURRENT checkpoint)")
        verify = self.verify if verify is None else verify
        engine = load_index(p, device=device, mesh=mesh, verify=verify,
                            expect_backend=expect_backend)
        ck = int(engine.version)
        wal_path = self.path / _WAL_FMT.format(ck)
        records = []
        if not _writes(engine):
            records = scan_wal(wal_path)[0]
        elif wal_path.exists():
            # opening also truncates any torn tail for good, so the
            # subsequent attach() appends after the last *valid* record
            with WriteAheadLog(wal_path, base_version=ck) as w:
                records = w.records()
        for version, inserts, deletes in records:
            if version <= engine.version:
                continue
            if version != engine.version + 1:
                raise CorruptStore(
                    f"{wal_path}: record {version} does not continue "
                    f"engine version {engine.version} — lineage gap")
            engine.update(inserts, deletes)
        if attach:
            self.attach(engine)
        return engine

    def close(self) -> None:
        if self._wal is not None:
            self._wal.close()
            self._wal = None

    def __enter__(self) -> "IndexStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def restore_engine(path, *, device: DeviceLike = None, mesh=None,
                   verify: bool = True,
                   expect_backend: Optional[str] = None,
                   checkpoint_every: Optional[int] = None, attach: bool = True):
    """Restore an engine from either a store *directory* (checkpoint +
    WAL replay + re-attach — the ``build_engine(restore=...)`` path) or
    a single ``save_index`` *file* (plain load, no journal), landing its
    snapshot on ``device``."""
    p = pathlib.Path(path)
    if p.is_dir():
        store = IndexStore(p, checkpoint_every=checkpoint_every,
                           verify=verify)
        return store.restore(device=device, mesh=mesh,
                             expect_backend=expect_backend, attach=attach)
    return load_index(p, device=device, mesh=mesh, verify=verify,
                      expect_backend=expect_backend)
