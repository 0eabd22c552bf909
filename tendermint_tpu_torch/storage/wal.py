"""Write-ahead log — CRC-framed, ENDHEIGHT-marked: the port's copy of
`tendermint_tpu/storage/wal.py` (consensus/wal.go).

Every consensus input (peer message, internal message, timeout) is logged
before it is processed; on restart the tail of the log past the last
`#ENDHEIGHT` marker is replayed through the state machine (SURVEY.md §3.5).

Frame format (consensus/wal.go:207-222 equivalent):
    crc32(payload) uint32 BE | len(payload) uint32 BE | payload
payload = canonical JSON {"time_ns": int, "msg": {"type": str, ...}}.
A frame whose CRC or length doesn't check raises WALCorruptionError —
truncated final frames (crash mid-write) are tolerated and cut off.

Files rotate at `rotate_bytes` into numbered backups (wal.1 oldest …), the
head file is always `wal`; search_for_end_height scans newest→oldest,
matching the reference's autofile group semantics (consensus/wal.go:152).
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from dataclasses import dataclass
from typing import Iterator, Optional

from tendermint_tpu_torch.types import encoding

_HEADER = struct.Struct(">II")
_NONZERO = re.compile(rb"[^\x00]")
_MAX_FRAME = 2 << 20  # generous: a message is at most one block part + meta


class WALCorruptionError(Exception):
    pass


@dataclass
class WALMessage:
    """One logged consensus input."""
    time_ns: int
    msg: dict  # {"type": ..., ...}; type "endheight" is the marker

    def to_obj(self):
        return {"time_ns": self.time_ns, "msg": self.msg}

    @classmethod
    def from_obj(cls, o):
        return cls(o["time_ns"], o["msg"])


def EndHeightMessage(height: int) -> dict:
    """consensus/wal.go:35 — written after height H is committed."""
    return {"type": "endheight", "height": height}


def encode_frame(m: WALMessage) -> bytes:
    payload = encoding.cdumps(m.to_obj())
    if len(payload) > _MAX_FRAME:
        # fail at write time; otherwise the decoder rejects the frame on
        # restart and the whole WAL becomes unreadable
        raise ValueError(f"WAL frame {len(payload)}B exceeds {_MAX_FRAME}B")
    return _HEADER.pack(zlib.crc32(payload) & 0xFFFFFFFF, len(payload)) + payload


def decode_frames(data: bytes, tolerate_truncated_tail: bool = True
                  ) -> Iterator[WALMessage]:
    """Decode frames; raises WALCorruptionError on CRC/length mismatch.
    A truncated final frame (crash or snapshot mid-write) is dropped
    silently — but only when it really is FINAL: if a CRC-valid frame
    chain resumes after the undecodable region, the "truncation" is a
    corrupt length field shadowing good frames (an append-only writer
    can never put complete frames after a partial one), and dropping
    them silently is exactly the data loss this layer must refuse."""
    off = 0
    n = len(data)

    def tail_or_raise(what: str):
        if not tolerate_truncated_tail:
            raise WALCorruptionError(what)
        if _buffer_resyncs(data, off, n):
            raise WALCorruptionError(
                f"{what} but valid frames resume after it "
                "(corrupt length field?)")

    while off < n:
        if off + _HEADER.size > n:
            tail_or_raise("truncated frame header")
            return
        crc, length = _HEADER.unpack_from(data, off)
        if crc == 0 and length == 0:
            # zero-filled tail block (power loss): torn, not a frame
            tail_or_raise("zero-filled tail")
            return
        if length > _MAX_FRAME:
            raise WALCorruptionError(f"frame length {length} too large")
        start = off + _HEADER.size
        if start + length > n:
            tail_or_raise("truncated frame payload")
            return
        payload = data[start:start + length]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            raise WALCorruptionError("crc mismatch")
        try:
            yield WALMessage.from_obj(encoding.cloads(payload))
        except Exception as e:  # malformed JSON despite valid CRC
            raise WALCorruptionError(f"undecodable payload: {e}") from e
        off = start + length


def _trim_torn_tail(path: str) -> None:
    """Truncate an incomplete final frame (crash mid-write) from the WAL
    head at open time, so frames appended afterwards stay reachable —
    decode_frames stops at the first truncated frame, so appending past
    a torn tail would silently hide everything after it. Only an
    EOF-truncated frame is trimmed; a full frame with a bad CRC or an
    oversized length is real corruption and still raises at read time.

    Distinguishing torn from corrupt: a mid-file bit-flip in a LENGTH
    field can make a good frame's interior look like a frame extending
    past EOF — truncating there would silently destroy the valid frames
    after it. A genuinely torn tail is the cut-short suffix of ONE
    frame write, so no valid frame chain can resume after the torn
    point; if one does (CRC-verified to EOF, a 2^-32 false-positive per
    candidate offset), the file is corrupt, not torn, and is left
    byte-identical for the reader to reject loudly."""
    if not os.path.exists(path):
        return
    size = os.path.getsize(path)
    if size == 0:
        return
    off = 0
    torn = False
    with open(path, "rb") as f:
        # pass 1 — headers only, payloads skipped with seek, so a clean
        # restart never buffers the whole (up to rotate_bytes) head
        while off < size:
            if off + _HEADER.size > size:
                torn = True
                break
            hdr = f.read(_HEADER.size)
            crc, length = _HEADER.unpack(hdr)
            if crc == 0 and length == 0:
                # all-zero header: filesystem zero-fill of the torn tail
                # block (power loss), not a frame — real frames always
                # carry a payload. Trim from here.
                torn = True
                break
            if length > _MAX_FRAME:
                break  # corrupt, not torn: leave for the reader to reject
            if off + _HEADER.size + length > size:
                torn = True
                break
            off += _HEADER.size + length
            f.seek(off)
        if torn and off < size:
            # pass 2 (rare, crash recovery only): prefix must CRC-clean
            # and no frame chain may resync after the torn point
            f.seek(0)
            pos = 0
            while pos < off:
                crc, length = _HEADER.unpack(f.read(_HEADER.size))
                if zlib.crc32(f.read(length)) & 0xFFFFFFFF != crc:
                    return  # corrupt prefix: reader will reject loudly
                pos += _HEADER.size + length
            if _frame_chain_resyncs(f, off, size):
                return  # corrupt length field, not a torn write
    if torn and off < size:
        os.truncate(path, off)


def _buffer_resyncs(buf, start: int, end: int) -> bool:
    """True if ANY complete CRC-valid frame starts in (start, end) —
    evidence that bytes after `start` are real frames shadowed by
    corruption, not the remains of one torn write (an append-only
    writer cannot put a complete frame after a partial one). ONE valid
    frame suffices: requiring a chain to reach EOF would dismiss a
    resumed chain that itself ends in a second torn tail, and the
    failure directions are asymmetric — a false positive (a random
    window CRC-validating, ~2^-32 per candidate) refuses a trim and
    fails loudly; a false negative truncates committed frames silently.
    Zero-length frames are excluded: crc32(b"") == 0, so filesystem
    zero-fill of torn tail blocks would "validate", and a real frame
    always carries a JSON payload."""
    cand = start + 1
    while cand <= end - _HEADER.size:
        crc, length = _HEADER.unpack_from(buf, cand)
        if length == 0:
            # A valid header needs a nonzero length field, so nothing
            # inside a zero run can start a frame — jump to 7 bytes
            # before the next nonzero byte (C-level scan: a zero-filled
            # region can span tens of MB and a per-byte Python loop
            # would stall node startup for seconds).
            m = _NONZERO.search(buf, cand + _HEADER.size)
            if m is None:
                return False
            cand = max(cand + 1, m.start() - (_HEADER.size - 1))
            continue
        if length <= _MAX_FRAME and cand + _HEADER.size + length <= end:
            payload = bytes(buf[cand + _HEADER.size:
                                cand + _HEADER.size + length])
            if zlib.crc32(payload) & 0xFFFFFFFF == crc:
                return True
        cand += 1
    return False


def _frame_chain_resyncs(f, start: int, size: int) -> bool:
    """File wrapper over _buffer_resyncs. Pass 1 usually bounds the
    region to < _MAX_FRAME + header (scanned in one read), but the
    zero-header torn case (filesystem zero-fill after power loss) can
    leave up to rotate_bytes of tail — that path scans in overlapping
    windows so startup memory stays bounded. Windows overlap by
    _MAX_FRAME + header bytes, so any complete frame that starts inside
    the region is fully contained in some window."""
    chunk = 8 << 20
    overlap = _MAX_FRAME + _HEADER.size
    if size - start <= chunk + overlap:
        f.seek(start)
        buf = f.read(size - start)
        return _buffer_resyncs(buf, 0, len(buf))
    pos = start
    while pos < size:
        win_end = min(size, pos + chunk + overlap)
        f.seek(pos)
        buf = f.read(win_end - pos)
        if _buffer_resyncs(buf, 0, len(buf)):
            return True
        pos += chunk
    return False


class WAL:
    def __init__(self, path: str, rotate_bytes: int = 64 << 20,
                 max_backups: int = 16, light: bool = False,
                 readonly: bool = False):
        self.path = path
        self.rotate_bytes = rotate_bytes
        self.max_backups = max_backups
        self.light = light  # light mode skips peer messages (wal.go:121-128)
        self.readonly = readonly
        if readonly:
            # Inspection mode (the replay CLI may point at a LIVE
            # node's data dir): NO torn-tail trim — opening used to
            # truncate the live writer's partially-flushed frame, which
            # the writer then appends past, corrupting the log — no
            # `#ENDHEIGHT 0` planting, and save()/flush() are no-ops.
            # The readers already tolerate a torn head-file tail.
            self._f = None
            return
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        _trim_torn_tail(path)
        self._f = open(path, "ab")
        # A fresh WAL starts with `#ENDHEIGHT 0` (consensus/wal.go:99-104):
        # without it, a node that crashes during its FIRST height has no
        # marker for messages_after_end_height(0) to anchor on, catchup
        # replay silently finds nothing, and the restarted validator
        # stalls — double-sign protection (correctly) refuses to re-sign
        # height 1, but the votes it already cast are stranded in the WAL.
        # "Fresh" = head is EMPTY (zero bytes, possibly after trimming a
        # torn frame — NOT merely undecodable: a corrupt head must stay
        # byte-identical for the operator until the reader rejects it
        # loudly) AND no rotated backups (a restart that lands on a
        # just-rotated empty head must not plant a second height-0
        # marker mid-log).
        if self._f.tell() == 0 and not os.path.exists(f"{path}.1"):
            self.save_end_height(0)

    # -- writing -------------------------------------------------------------

    def save(self, msg: dict, time_ns: int = 0) -> None:
        if self._f is None:  # readonly inspection handle
            return
        if self.light and msg.get("peer"):
            return
        self._f.write(encode_frame(WALMessage(time_ns, msg)))
        # write-ahead guarantee: every input reaches the OS before it is
        # processed (consensus/wal.go flushes after every Save); ENDHEIGHT
        # additionally fsyncs since it gates replay decisions
        self._f.flush()
        if msg.get("type") == "endheight":
            self.flush()
        if self._f.tell() >= self.rotate_bytes:
            self._rotate()

    def save_end_height(self, height: int) -> None:
        self.save(EndHeightMessage(height))

    def flush(self) -> None:
        if self._f is None:
            return
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if self._f is None:
            return
        self._f.flush()
        self._f.close()

    def _rotate(self) -> None:
        self._f.close()
        for i in range(self.max_backups - 1, 0, -1):
            src = f"{self.path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self.path}.{i + 1}")
        os.replace(self.path, f"{self.path}.1")
        self._f = open(self.path, "ab")

    # -- reading -------------------------------------------------------------

    def _files_newest_first(self):
        files = [self.path]
        i = 1
        while os.path.exists(f"{self.path}.{i}"):
            files.append(f"{self.path}.{i}")
            i += 1
        return files

    def messages_after_end_height(self, height: int
                                  ) -> Optional[list[WALMessage]]:
        """All messages after `#ENDHEIGHT height`, or None if the marker is
        absent (consensus/wal.go:152-190: scan newest file backward)."""
        tail: list[WALMessage] = []
        for path in self._files_newest_first():
            with open(path, "rb") as f:
                # only the head file may legitimately end mid-frame (crash
                # during write); a truncated backup is real corruption
                msgs = list(decode_frames(
                    f.read(),
                    tolerate_truncated_tail=(path == self.path)))
            found_at = None
            for i in range(len(msgs) - 1, -1, -1):
                m = msgs[i]
                if (m.msg.get("type") == "endheight"
                        and m.msg.get("height") == height):
                    found_at = i
                    break
            if found_at is not None:
                return msgs[found_at + 1:] + tail
            tail = msgs + tail
        return None

    def all_messages(self) -> list[WALMessage]:
        out: list[WALMessage] = []
        for path in reversed(self._files_newest_first()):
            with open(path, "rb") as f:
                out.extend(decode_frames(
                    f.read(),
                    tolerate_truncated_tail=(path == self.path)))
        return out


class NilWAL:
    """No-op WAL (consensus/wal.go:311) for tests/ephemeral nodes."""

    def save(self, msg: dict, time_ns: int = 0) -> None: ...
    def save_end_height(self, height: int) -> None: ...
    def flush(self) -> None: ...
    def close(self) -> None: ...
    def messages_after_end_height(self, height: int): return None
    def all_messages(self): return []
