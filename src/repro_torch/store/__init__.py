"""Durable index store: on-disk snapshots, write-ahead log, HIF I/O.

Three layers, as in the reference's ``repro.store`` (same names, same
file formats — each package reads what the other writes):

- ``format``: the versioned, mmap-loadable index file —
  ``save_index`` / ``load_index`` with per-segment checksums.
- ``wal`` + ``store``: the write-ahead update log and the checkpoint
  directory that together give crash-safe continuous ingest and warm
  restart (``IndexStore``, ``restore_engine``).
- ``hif``: Hypergraph Interchange Format import/export for external
  datasets (``read_hif`` / ``write_hif``).
"""
from .format import (FORMAT_REGISTRY, FORMAT_VERSION, CorruptStore,
                     StoreError, StoreUnsupported, load_index, load_segments,
                     read_manifest, save_index)
from .hif import read_hif, write_hif
from .store import IndexStore, restore_engine
from .wal import WriteAheadLog, scan_wal

__all__ = [
    "FORMAT_REGISTRY",
    "FORMAT_VERSION",
    "StoreError",
    "CorruptStore",
    "StoreUnsupported",
    "save_index",
    "load_index",
    "read_manifest",
    "load_segments",
    "WriteAheadLog",
    "scan_wal",
    "IndexStore",
    "restore_engine",
    "read_hif",
    "write_hif",
]
