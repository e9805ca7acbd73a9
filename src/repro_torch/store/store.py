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
"""
from __future__ import annotations

import os
import pathlib
from typing import Optional

from ..core.mesh import not_on_ranks
from ..device import DeviceLike
from .format import (CorruptStore, StoreError, load_index, read_manifest,
                     save_index)
from .wal import WriteAheadLog

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
        place before ``CURRENT`` moves)."""
        version = int(engine.version)
        name = _CKPT_FMT.format(version)
        final = self.path / name
        tmp = self.path / (name + ".tmp")
        save_index(tmp, engine, neighbors=neighbors)
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
        wal_path = self.path / _WAL_FMT.format(version)
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
        return final

    # -- the engine-facing WAL sink protocol -------------------------------

    def attach(self, engine) -> None:
        """Make this store ``engine``'s WAL sink: every subsequent
        ``engine.update`` journals durably here before applying.  The
        engine must continue the store's lineage (checkpoint version +
        logged records == engine version); an empty store seeds itself
        with a checkpoint of the engine first.  An engine built on ranks
        (a ``ProcessMesh``) raises ``NotImplementedError``: no rank
        journals for the others yet (ROADMAP A10d)."""
        not_on_ranks(getattr(engine, "rank_mesh", None),
                     "an IndexStore attached to an engine built on ranks")
        ck = self.checkpoint_version
        if ck is None:
            self.checkpoint(engine)
            engine.attach_wal(self)
            return
        if self._wal is None:
            self._wal = WriteAheadLog(self.path / _WAL_FMT.format(ck),
                                      base_version=ck)
        if int(engine.version) != self._wal.last_version:
            raise StoreError(
                f"engine version {engine.version} does not continue this "
                f"store's lineage (checkpoint {ck} + {self._wal.count} "
                f"logged updates = version {self._wal.last_version}); "
                f"checkpoint() it instead")
        engine.attach_wal(self)

    def append(self, version: int, inserts, deletes) -> None:
        """WAL sink: journal one update durably (called by
        ``engine.update`` *before* the in-memory apply)."""
        if self._wal is None:
            raise StoreError("store has no open WAL; call checkpoint() or "
                             "attach() first")
        self._wal.append(version, inserts, deletes)

    def committed(self, engine) -> None:
        """WAL sink: the update applied; compact if the log grew past
        ``checkpoint_every`` records."""
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
        checkpoint lands, re-padded for its grid (``load_index``).
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
        if wal_path.exists():
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
