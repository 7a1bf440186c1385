"""Write-ahead log: length-prefixed, CRC32-checksummed mutation records
(port of the JAX package's ``durability/wal.py``; the frames are byte for
byte the reference's, so either package replays the other's log).

File layout::

    MAGIC (8 bytes: b"GWAL0001")
    record*

    record := <II little-endian: payload_len, crc32(payload)> payload
    payload := header-JSON utf-8 line + b"\\n" + raw float32 vector bytes

The header JSON carries the record's monotonic ``seq`` (sequence numbers
survive truncation — a snapshot truncates the file back to the magic but
the counter keeps climbing, so a snapshot manifest can name the highest
sequence it covers and recovery can skip already-snapshotted records),
the ``op`` (``add`` / ``delete`` / ``index_swap``), and op-specific
fields.  ``add`` records store chunk ids/texts/sources/metadata in the
header and the embedding matrix as raw ``float32`` bytes after the
newline, so replay reconstructs chunks with their original ids.

Torn tails: a crash can leave a partially-written final record (or, with
``fsync_every > 1``, drop a buffered suffix entirely).  ``replay``
verifies each record's checksum and stops at the first bad/short one; in
``repair`` mode the unreadable suffix is copied to a quarantine file
next to the log and the log is truncated back to the last good record,
so the next boot starts from a clean tail instead of failing.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import threading
import zlib
from typing import Any, Iterator, Optional

import numpy as np

MAGIC = b"GWAL0001"
_FRAME = struct.Struct("<II")  # payload length, crc32(payload)

# Refuse absurd frame lengths when scanning a corrupt file: a flipped
# bit in the length field must not trigger a multi-GB read attempt.
_MAX_RECORD_BYTES = 1 << 30


@dataclasses.dataclass
class WalRecord:
    """One decoded log record."""

    seq: int
    header: dict[str, Any]
    vectors: Optional[np.ndarray]  # (n, dim) float32, add records only
    offset: int  # byte offset of the frame start in the file


def _encode(header: dict[str, Any], vectors: Optional[np.ndarray]) -> bytes:
    body = json.dumps(header, separators=(",", ":")).encode("utf-8") + b"\n"
    if vectors is not None:
        body += np.ascontiguousarray(vectors, dtype=np.float32).tobytes()
    return _FRAME.pack(len(body), zlib.crc32(body)) + body


def _decode(header_line: bytes, rest: bytes) -> tuple[dict, Optional[np.ndarray]]:
    header = json.loads(header_line.decode("utf-8"))
    vectors = None
    shape = header.get("vec_shape")
    if shape:
        vectors = np.frombuffer(rest, dtype=np.float32).reshape(shape).copy()
    return header, vectors


class WriteAheadLog:
    """Appender with a configurable fsync cadence.

    ``fsync_every=1`` fsyncs synchronously after every record
    (strictest); ``N > 1`` group-commits — a background flusher thread
    fsyncs once every ~N records so the append path never blocks on the
    disk (a crash can lose the un-fsynced tail, which the ingest
    journal's resume path makes safe to lose: ``file_done`` is only
    journaled after a synchronous :meth:`flush` barrier); ``0`` never
    fsyncs on append (flush/close only).
    """

    def __init__(
        self, path: str, *, fsync_every: int = 16, start_seq: int = 0
    ) -> None:
        self.path = path
        self.fsync_every = max(0, int(fsync_every))
        self._lock = threading.Lock()
        self._seq = int(start_seq)
        self._since_fsync = 0
        self._closed = False
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        new = not os.path.exists(path) or os.path.getsize(path) == 0
        self._fh = open(path, "ab")
        if new:
            self._fh.write(MAGIC)
            self._fh.flush()
            os.fsync(self._fh.fileno())
        self._flush_event = threading.Event()
        self._flusher: Optional[threading.Thread] = None
        if self.fsync_every > 1:
            self._flusher = threading.Thread(
                target=self._flush_loop, name="wal-fsync", daemon=True
            )
            self._flusher.start()

    @property
    def last_seq(self) -> int:
        return self._seq

    def append(
        self, header: dict[str, Any], vectors: Optional[np.ndarray] = None
    ) -> int:
        """Durably append one record; returns its sequence number."""
        from generativeaiexamples_tpu_torch.durability import metrics

        with self._lock:
            self._seq += 1
            header = dict(header)
            header["seq"] = self._seq
            if vectors is not None:
                vectors = np.ascontiguousarray(vectors, dtype=np.float32)
                header["vec_shape"] = list(vectors.shape)
            # Framed identically to _encode, but written as three pieces
            # with an incremental crc so the vector matrix is never
            # copied into a temporary body buffer (it dominates the
            # record; add appends are the mutation hot path).
            head = (
                json.dumps(header, separators=(",", ":")).encode("utf-8")
                + b"\n"
            )
            length = len(head)
            crc = zlib.crc32(head)
            vec_view = None
            if vectors is not None:
                vec_view = memoryview(vectors).cast("B")
                length += len(vec_view)
                crc = zlib.crc32(vec_view, crc)
            self._fh.write(_FRAME.pack(length, crc))
            self._fh.write(head)
            if vec_view is not None:
                self._fh.write(vec_view)
            frame_len = _FRAME.size + length
            self._fh.flush()
            self._since_fsync += 1
            fsynced = False
            if self.fsync_every == 1:
                os.fsync(self._fh.fileno())
                self._since_fsync = 0
                fsynced = True
            elif self.fsync_every and self._since_fsync >= self.fsync_every:
                # Group commit: hand the fsync to the flusher thread so
                # the mutation path pays encode+write only.
                self._since_fsync = 0
                self._flush_event.set()
            metrics.record_wal_append(
                str(header.get("op", "unknown")), frame_len, fsynced, self._seq
            )
            return self._seq

    def _flush_loop(self) -> None:
        from generativeaiexamples_tpu_torch.durability import metrics

        while True:
            self._flush_event.wait()
            self._flush_event.clear()
            with self._lock:
                if self._closed or self._fh.closed:
                    return
                self._fh.flush()
                try:
                    os.fsync(self._fh.fileno())
                except OSError:
                    continue
            metrics.record_wal_fsync()

    def flush(self) -> None:
        """Flush buffers and fsync regardless of cadence."""
        from generativeaiexamples_tpu_torch.durability import metrics

        with self._lock:
            if self._fh.closed:
                return
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._since_fsync = 0
            metrics.record_wal_fsync()

    def truncate(self) -> None:
        """Reset the file to just the magic (after a snapshot covered every
        record); the sequence counter keeps climbing."""
        from generativeaiexamples_tpu_torch.durability import metrics

        with self._lock:
            self._fh.truncate(len(MAGIC))
            self._fh.seek(0, os.SEEK_END)
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._since_fsync = 0
            metrics.record_wal_truncate()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if not self._fh.closed:
                self._fh.flush()
                os.fsync(self._fh.fileno())
                self._fh.close()
        if self._flusher is not None:
            self._flush_event.set()
            self._flusher.join(timeout=5)
            self._flusher = None


def _iter_records(path: str) -> Iterator[tuple[Optional[WalRecord], int, str]]:
    """Yield ``(record, end_offset, "")`` per readable record — end_offset
    is the byte just past its frame — then ``(None, end_offset, error)``
    once if the tail is unreadable, where end_offset is the last good
    byte; iteration stops there."""
    with open(path, "rb") as fh:
        magic = fh.read(len(MAGIC))
        if magic != MAGIC:
            yield None, 0, "bad magic"
            return
        offset = len(MAGIC)
        while True:
            frame = fh.read(_FRAME.size)
            if not frame:
                return
            if len(frame) < _FRAME.size:
                yield None, offset, "short frame header"
                return
            length, crc = _FRAME.unpack(frame)
            if length > _MAX_RECORD_BYTES:
                yield None, offset, f"implausible record length {length}"
                return
            body = fh.read(length)
            if len(body) < length:
                yield None, offset, "short record body"
                return
            if zlib.crc32(body) != crc:
                yield None, offset, "checksum mismatch"
                return
            nl = body.index(b"\n") if b"\n" in body else -1
            if nl < 0:
                yield None, offset, "malformed record payload"
                return
            try:
                header, vectors = _decode(body[:nl], body[nl + 1 :])
            except Exception as exc:  # corrupt JSON / shape mismatch
                yield None, offset, f"undecodable record: {exc}"
                return
            rec = WalRecord(
                seq=int(header.get("seq", 0)),
                header=header,
                vectors=vectors,
                offset=offset,
            )
            offset += _FRAME.size + length
            yield rec, offset, ""


def replay(
    path: str, *, repair: bool = True
) -> tuple[list[WalRecord], dict[str, Any]]:
    """Read every verifiable record from ``path``.

    Returns ``(records, info)`` where info describes the tail state:
    ``torn`` (bool), ``error`` (first decode failure, if any),
    ``good_bytes`` (offset of the last readable record's end), and
    ``quarantined`` (path the bad suffix was copied to, repair mode).
    A missing file replays as empty.
    """
    info: dict[str, Any] = {
        "torn": False,
        "error": "",
        "good_bytes": 0,
        "quarantined": "",
    }
    if not os.path.exists(path):
        return [], info
    records: list[WalRecord] = []
    good_end = min(len(MAGIC), os.path.getsize(path))
    for rec, end, error in _iter_records(path):
        if error:
            info["torn"] = True
            info["error"] = error
            good_end = end
            break
        assert rec is not None
        records.append(rec)
        good_end = end
    info["good_bytes"] = good_end
    if info["torn"] and repair:
        info["quarantined"] = _quarantine(path, good_end)
    return records, info


def _quarantine(path: str, good_end: int) -> str:
    """Copy the unreadable suffix to a sibling file and truncate the log
    back to the last good record so the next boot starts clean."""
    size = os.path.getsize(path)
    if size <= good_end:
        return ""
    qpath = f"{path}.quarantine-{good_end}"
    with open(path, "rb") as src:
        src.seek(good_end)
        bad = src.read()
    with open(qpath, "wb") as dst:
        dst.write(bad)
        dst.flush()
        os.fsync(dst.fileno())
    with open(path, "r+b") as fh:
        fh.truncate(good_end)
        fh.flush()
        os.fsync(fh.fileno())
    return qpath
