"""Write-ahead update log: the durability layer in front of ``apply_updates``.

Every ``engine.update(inserts, deletes)`` with a WAL attached appends one
record — *fsynced before the in-memory structure changes* — so a crash at
any point loses at most updates that were never acknowledged:

    [ magic u32 | version u64 | payload len u32 | payload CRC-32 u32 | payload ]

The payload is the canonical JSON batch produced by
``repro_torch.core.maintenance.normalize_update_batch`` (dedup-sorted inserts,
sorted unique deletes — replaying it is byte-identical to applying the
original).  ``version`` is the engine version *after* the update applies:
records are strictly monotonic, continuing the checkpoint they follow, so
replay can assert lineage contiguity.

Torn-tail policy (the crash contract): scanning stops at the first record whose
header is truncated, whose magic is wrong, whose payload runs past EOF,
or whose CRC mismatches — that record and everything after it is
*dropped, not an error* (a crash mid-append legitimately leaves exactly
this state).  Opening the log for append truncates the torn bytes first,
so new records never land after garbage.

Counterpart of ``repro/store/wal.py``, the same record layout byte for
byte: a log written by either package replays in the other.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from typing import List, Sequence, Tuple

from .format import StoreError

__all__ = ["WriteAheadLog", "scan_wal"]

_REC_MAGIC = 0x484C5741                      # "HLWA"
_REC = struct.Struct("<IQII")                # magic, version, len, crc

WalRecord = Tuple[int, List[List[int]], List[int]]   # version, inserts, deletes


def scan_wal(path) -> Tuple[List[WalRecord], int, str]:
    """Read every valid record of a WAL file.

    Returns ``(records, valid_bytes, tail_status)`` where ``records`` is
    ``[(version, inserts, deletes), ...]`` in append order,
    ``valid_bytes`` is the prefix length holding them, and
    ``tail_status`` is ``"ok"`` or why scanning stopped
    (``"torn-header"`` / ``"torn-payload"`` / ``"bad-magic"`` /
    ``"bad-checksum"`` / ``"bad-payload"``) — the dropped tail is the
    crash contract, never an exception."""
    records: List[WalRecord] = []
    if not os.path.exists(path):
        return records, 0, "ok"
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    status = "ok"
    while True:
        if off + _REC.size > len(data):
            if off != len(data):
                status = "torn-header"
            break
        magic, version, plen, crc = _REC.unpack_from(data, off)
        if magic != _REC_MAGIC:
            status = "bad-magic"
            break
        end = off + _REC.size + plen
        if end > len(data):
            status = "torn-payload"
            break
        payload = data[off + _REC.size:end]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            status = "bad-checksum"
            break
        try:
            rec = json.loads(payload)
            records.append((int(version), rec["inserts"], rec["deletes"]))
        except (ValueError, KeyError, TypeError):
            status = "bad-payload"
            break
        off = end
    return records, off, status


class WriteAheadLog:
    """Append-only checksummed update journal.

    Opening scans the existing file, truncates any torn tail (see module
    docstring), and resumes the version lineage from the last valid
    record (or ``base_version`` — the checkpoint version this log
    follows — when empty).  ``append`` writes, flushes, and fsyncs
    before returning: callers apply the update only after it is durable.
    """

    def __init__(self, path, *, base_version: int = 0):
        self.path = os.fspath(path)
        records, valid_bytes, self.tail_status = scan_wal(self.path)
        self.last_version = int(records[-1][0]) if records else int(base_version)
        self.count = len(records)
        self._f = open(self.path, "a+b")
        if self._f.seek(0, os.SEEK_END) != valid_bytes:
            self._f.truncate(valid_bytes)    # drop the torn tail for good
        os.fsync(self._f.fileno())

    def append(self, version: int, inserts: Sequence[Sequence[int]],
               deletes: Sequence[int]) -> None:
        """Durably journal one update batch as record ``version`` (must
        be ``last_version + 1`` — the monotonic lineage invariant)."""
        version = int(version)
        if version != self.last_version + 1:
            raise StoreError(
                f"WAL versions are monotonic: expected record "
                f"{self.last_version + 1}, got {version}")
        payload = json.dumps(
            {"inserts": [[int(x) for x in e] for e in inserts],
             "deletes": [int(d) for d in deletes]},
            separators=(",", ":")).encode()
        self._f.write(_REC.pack(_REC_MAGIC, version, len(payload),
                                zlib.crc32(payload) & 0xFFFFFFFF))
        self._f.write(payload)
        self._f.flush()
        os.fsync(self._f.fileno())
        self.last_version = version
        self.count += 1

    def committed(self, engine) -> None:
        """Post-apply hook of the WAL sink protocol (see
        ``ReachabilityEngine.update``); the bare log needs no action —
        ``IndexStore`` overrides the sink to compact here."""

    def records(self) -> List[WalRecord]:
        """Re-scan the file (valid records only, append order)."""
        return scan_wal(self.path)[0]

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "WriteAheadLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
