"""The event stream a service on ranks runs on: one leader, every rank
serving.

A ``ReachabilityService`` on a ``ProcessMesh`` admits requests on global
rank 0 only (the leader): admission depends on the clock and on what
callers cancel, so two ranks fed the same requests would still cut
different micro-batches.  Every micro-batch, update, checkpoint,
keep-alive and the close the leader decides on crosses to the other
ranks (the followers) as one event of this stream, in order, so every
rank enters every collective of serving in the same order:

1. a fixed-size int64 header (``HEADER_WORDS`` words): a magic word, the
   event kind, the payload's length in words, the engine version the
   leader expects, a CRC-32 of the payload, the event's sequence number
   and the number of kind groups of a micro-batch;
2. the payload, flat int64, whose length the header gave (no second
   size exchange): a micro-batch's requests grouped by kind, an update's
   edits, or a checkpoint's store directory (``collectives.encode_json``).

Both cross by ``core/collectives.broadcast_from``.  The codecs here are
plain numpy and need no process group; ``RankStream`` is the two ends of
the stream on one rank.
"""
from __future__ import annotations

import operator
import time
import zlib
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import collectives as coll

__all__ = ["HEADER_WORDS", "KEEPALIVE", "BATCH", "UPDATE", "CHECKPOINT",
           "CLOSE", "EVENT_NAMES", "Header", "encode_header",
           "decode_header", "digest", "encode_batch", "decode_batch",
           "encode_edits", "decode_edits",
           "RankStream", "keepalive_interval"]

HEADER_WORDS = 8
_MAGIC = 0x484C5356                      # "HLSV"
KEEPALIVE, BATCH, UPDATE, CHECKPOINT, CLOSE = range(5)
EVENT_NAMES = ("keepalive", "batch", "update", "checkpoint", "close")
# an idle leader sends a keep-alive once this share of the group's
# timeout has passed without an event
KEEPALIVE_FRACTION = 0.25

# the request kinds in wire order, and the scalar fields each carries
# (``mr_set``'s two vertex sets follow as length-prefixed runs)
_KINDS = ("mr", "s_reach", "witness", "s_reach_k", "mr_set", "top_s",
          "s_distance")
_FIELDS: Dict[str, Tuple[str, ...]] = {
    "mr": ("u", "v"), "s_reach": ("u", "v", "s"), "witness": ("u", "v"),
    "s_reach_k": ("u", "v", "s", "k"), "mr_set": (),
    "top_s": ("u", "k"), "s_distance": ("u", "v", "s")}


class Header(NamedTuple):
    kind: int
    length: int
    version: int
    digest: int
    seq: int
    groups: int


def digest(payload: np.ndarray) -> int:
    """CRC-32 of the payload's bytes."""
    return zlib.crc32(np.ascontiguousarray(payload, np.int64).tobytes())


def encode_header(kind: int, payload: np.ndarray, version: int, seq: int,
                  groups: int = 0) -> np.ndarray:
    """The ``[HEADER_WORDS]`` int64 header of one event."""
    if kind not in range(len(EVENT_NAMES)):
        raise ValueError(f"unknown event kind {kind}")
    return np.array([_MAGIC, kind, payload.size, int(version),
                     digest(payload), int(seq), int(groups), 0], np.int64)


def decode_header(words) -> Header:
    """A received header, checked for the magic word and a known kind."""
    words = np.asarray(words, np.int64)
    if words.shape != (HEADER_WORDS,) or int(words[0]) != _MAGIC:
        raise ValueError(f"not a service stream header: {words.tolist()}")
    head = Header(*(int(x) for x in words[1:7]))
    if head.kind not in range(len(EVENT_NAMES)) or head.length < 0:
        raise ValueError(f"bad service stream header: {words.tolist()}")
    return head


def encode_batch(groups: Sequence[Tuple[str, Sequence]]) -> np.ndarray:
    """``[(kind, requests), ...]`` as flat int64: per group its kind's
    code and request count, then each request's fields."""
    out: List[int] = []
    for kind, requests in groups:
        out += [_KINDS.index(kind), len(requests)]
        fields = _FIELDS[kind]
        for r in requests:
            if kind == "mr_set":
                out += [len(r.us), *r.us, len(r.vs), *r.vs]
            else:
                out += [getattr(r, f) for f in fields]
    return np.array(out, np.int64)


def decode_batch(payload, types: Dict[str, type]) -> List[Tuple[str, list]]:
    """``encode_batch``'s groups back, each request rebuilt by
    ``types[kind]`` (the service's ``REQUEST_TYPES``) with the default
    tenant metadata."""
    words = np.asarray(payload, np.int64).tolist()
    pos, groups = 0, []
    while pos < len(words):
        kind, count = _KINDS[words[pos]], words[pos + 1]
        pos += 2
        cls, fields, requests = types[kind], _FIELDS[kind], []
        for _ in range(count):
            if kind == "mr_set":
                nu = words[pos]
                us = tuple(words[pos + 1:pos + 1 + nu])
                pos += 1 + nu
                nv = words[pos]
                vs = tuple(words[pos + 1:pos + 1 + nv])
                pos += 1 + nv
                requests.append(cls(us, vs))
            else:
                requests.append(cls(*words[pos:pos + len(fields)]))
                pos += len(fields)
        groups.append((kind, requests))
    return groups


def encode_edits(inserts, deletes) -> np.ndarray:
    """An update's edits as flat int64: the insert count, each insert's
    length and vertices, then the delete count and the deletes.  Raises
    ``ValueError`` / ``TypeError`` for edits that are not integers."""
    inserts = [[operator.index(x) for x in e] for e in inserts]
    deletes = [operator.index(d) for d in deletes]
    out = [len(inserts)]
    for e in inserts:
        out += [len(e), *e]
    out += [len(deletes), *deletes]
    return np.array(out, np.int64)


def decode_edits(payload) -> Tuple[List[List[int]], List[int]]:
    words = np.asarray(payload, np.int64).tolist()
    pos, inserts = 1, []
    for _ in range(words[0]):
        k = words[pos]
        inserts.append(words[pos + 1:pos + 1 + k])
        pos += 1 + k
    return inserts, words[pos + 1:pos + 1 + words[pos]]


def keepalive_interval(mesh) -> float:
    """Seconds an idle leader waits before a keep-alive:
    ``KEEPALIVE_FRACTION`` of the default group's timeout (the one
    ``init_process_group`` was given), so a follower waiting in its next
    header's broadcast never reaches the timeout while the leader lives.
    The timeout is read from the group's backend options; a torch that
    does not expose them raises ``RuntimeError`` here rather than guess
    an interval the followers might not outlive."""
    import torch.distributed.distributed_c10d as c10d
    try:
        group = c10d._get_default_group()
        backend = group._get_backend(torch.device(
            "cpu" if mesh.backend == "gloo" else mesh.device))
        timeout = backend.options._timeout.total_seconds()
    except (AttributeError, RuntimeError) as exc:
        raise RuntimeError(
            "a service on ranks cannot read the process group's timeout "
            "from this torch, so it cannot choose a keep-alive interval "
            "that its followers outlive") from exc
    return KEEPALIVE_FRACTION * timeout


class RankStream:
    """The stream on one rank of ``mesh``'s world: ``send`` on the leader
    (global rank ``src``), ``receive`` on the others.  Counts what it
    moved: ``events``, ``seconds`` in the broadcasts and the payload
    ``bytes`` received (headers included), per kind in ``by_kind``.
    Once the close event has crossed, ``closed`` is set and ``send``
    raises: no rank is left to receive."""

    def __init__(self, mesh, src: int = 0):
        self.mesh = mesh
        self.src = src
        self.seq = 0
        self.last_sent = time.monotonic()
        self.seconds = 0.0
        self.bytes = 0
        self.by_kind = {name: 0 for name in EVENT_NAMES}
        self.closed = False

    def _broadcast(self, words: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        t = torch.from_numpy(np.ascontiguousarray(words, np.int64)).to(
            coll.exchange_device(self.mesh))
        out = coll.broadcast_from(t, self.mesh, self.src).cpu().numpy()
        self.seconds += time.perf_counter() - t0
        self.bytes += out.nbytes
        return out

    def send(self, kind: int, payload=None, version: int = 0,
             groups: int = 0) -> None:
        if self.closed:
            raise RuntimeError(
                f"service stream: {EVENT_NAMES[kind]} after close: the "
                f"followers have left")
        payload = (np.zeros(0, np.int64) if payload is None
                   else np.asarray(payload, np.int64))
        self._broadcast(encode_header(kind, payload, version, self.seq,
                                      groups))
        if payload.size:
            self._broadcast(payload)
        self._count(kind)
        self.last_sent = time.monotonic()

    def receive(self) -> Tuple[Header, np.ndarray, Optional[Exception]]:
        """The next event: its header, its payload, and the error a
        follower found in it (a payload whose CRC-32 or sequence number
        is not the header's), or ``None``.  A header that cannot be read
        raises: the stream is lost."""
        head = decode_header(self._broadcast(np.zeros(HEADER_WORDS,
                                                      np.int64)))
        payload = (self._broadcast(np.zeros(head.length, np.int64))
                   if head.length else np.zeros(0, np.int64))
        error = None
        if digest(payload) != head.digest or head.seq != self.seq:
            error = ValueError(
                f"service stream: event {head.seq} ({EVENT_NAMES[head.kind]})"
                f" arrived as event {self.seq} or with another digest")
        self._count(head.kind)
        return head, payload, error

    def _count(self, kind: int) -> None:
        self.closed = kind == CLOSE
        self.seq += 1
        self.by_kind[EVENT_NAMES[kind]] += 1
