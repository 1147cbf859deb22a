"""Stream framing + control-plane codec for the out-of-process fabric.

A socket is a byte *stream*: one ``send`` can arrive as many ``recv``s and
many ``send``s can coalesce into one.  The proc fabric therefore wraps
every envelope-codec frame (``envelope.py``: magic + version + kind +
blake2b checksum + pickled payload) in a 4-byte big-endian length prefix,
and reassembles on the receiving side with :class:`FrameDecoder` — an
incremental decoder that tolerates arbitrary fragmentation (a frame fed
one byte at a time decodes identically) and interleaving (job, result,
cancel, heartbeat frames mixed on one stream come out in order).

The length prefix also bounds memory: a frame longer than
``max_frame_bytes`` raises :class:`FrameError` *before* any buffering of
its body, so a corrupted length word (or a hostile peer) cannot balloon
the receiver.  Payload corruption *inside* a frame is the envelope
codec's job — its checksum rejects the frame while the length prefix
keeps the stream in sync, so the next frame still decodes.

Control frames reuse the envelope codec's framing (same magic/version/
checksum discipline) with kinds above 0x10, carrying small pickled dicts:

====================  ====== ==============================================
kind                  value  direction / payload
====================  ====== ==============================================
``HELLO``             0x10   worker → supervisor: ``{shard_id, pid}`` on
                             connect (and on reconnect)
``CONFIG``            0x11   supervisor → worker: pickled ``ServiceConfig``
                             + proc options; the worker builds its service
                             from this
``HEARTBEAT``         0x12   worker → supervisor: liveness + queue depth,
                             inflight count and telemetry snapshots (the
                             autoscaler's sensor inputs)
``DRAIN``             0x13   supervisor → worker: finish queued work,
                             flush replies, exit 0
``BYE``               0x14   worker → supervisor: orderly goodbye
``HANDOFF_REQ``       0x15   supervisor → draining worker: export your
                             hottest cache entries
``HANDOFF_DATA``      0x16   draining worker → supervisor: ``(sig,
                             spill_bytes)`` pairs (the existing spill
                             format, pickled host arrays)
``HANDOFF_PUT``       0x17   supervisor → successor worker: ingest these
                             entries into your cache
====================  ====== ==============================================
"""

from __future__ import annotations

import pickle
import struct

from ..envelope import CodecError, _frame, _unframe, frame_kind

__all__ = [
    "CONTROL_KINDS", "FrameDecoder", "FrameError", "HELLO", "CONFIG",
    "HEARTBEAT", "DRAIN", "BYE", "HANDOFF_REQ", "HANDOFF_DATA",
    "HANDOFF_PUT", "MAX_FRAME_BYTES", "decode_control", "encode_control",
    "frame_kind", "write_frame",
]

# control-plane frame kinds (envelope kinds 0x01-0x03 carry the data plane)
HELLO = 0x10
CONFIG = 0x11
HEARTBEAT = 0x12
DRAIN = 0x13
BYE = 0x14
HANDOFF_REQ = 0x15
HANDOFF_DATA = 0x16
HANDOFF_PUT = 0x17

CONTROL_KINDS = frozenset((HELLO, CONFIG, HEARTBEAT, DRAIN, BYE,
                           HANDOFF_REQ, HANDOFF_DATA, HANDOFF_PUT))

_LEN = struct.Struct(">I")
MAX_FRAME_BYTES = 256 << 20      # 256 MiB: far above any sane envelope


class FrameError(ConnectionError):
    """Unrecoverable framing-layer failure (oversized/absurd length word).

    Unlike a payload checksum mismatch — which poisons one frame while
    the length prefix keeps the stream aligned — a bad length word means
    the receiver no longer knows where frames begin; the only safe
    recovery is dropping the connection."""


def write_frame(sock, frame: bytes) -> None:
    """Send one length-prefixed frame.  Callers serialize writes (one
    lock per socket) so concurrent senders cannot interleave prefixes."""
    sock.sendall(_LEN.pack(len(frame)) + frame)


class FrameDecoder:
    """Incremental length-prefixed frame reassembler.

    ``feed(data)`` consumes any fragmentation the transport produced and
    returns every *complete* frame body (the envelope-codec frame, prefix
    stripped) in arrival order; partial bytes are buffered for the next
    feed.  Raises :class:`FrameError` on a length word exceeding
    ``max_frame_bytes`` — the stream is unrecoverable past that point.
    """

    def __init__(self, max_frame_bytes: int = MAX_FRAME_BYTES):
        self.max_frame_bytes = int(max_frame_bytes)
        self._buf = bytearray()
        self.frames_out = 0
        self.bytes_in = 0

    def pending_bytes(self) -> int:
        return len(self._buf)

    def feed(self, data: bytes) -> list[bytes]:
        self._buf += data
        self.bytes_in += len(data)
        out: list[bytes] = []
        while True:
            if len(self._buf) < _LEN.size:
                break
            (length,) = _LEN.unpack_from(self._buf, 0)
            if length > self.max_frame_bytes:
                raise FrameError(
                    f"frame length {length} exceeds limit "
                    f"{self.max_frame_bytes} — stream out of sync or peer "
                    f"misbehaving")
            if len(self._buf) < _LEN.size + length:
                break
            frame = bytes(self._buf[_LEN.size:_LEN.size + length])
            del self._buf[:_LEN.size + length]
            out.append(frame)
            self.frames_out += 1
        return out


# ---------------------------------------------------------------------------
# control-plane codec
# ---------------------------------------------------------------------------

def encode_control(kind: int, obj: dict) -> bytes:
    if kind not in CONTROL_KINDS:
        raise ValueError(f"not a control frame kind: {kind:#x}")
    return _frame(kind, pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))


def decode_control(data: bytes) -> tuple[int, dict]:
    kind = frame_kind(data)
    if kind not in CONTROL_KINDS:
        raise CodecError(f"not a control frame: kind {kind:#x}")
    payload = _unframe(data, kind)
    try:
        return kind, pickle.loads(payload)
    except CodecError:
        raise
    except Exception as e:  # noqa: BLE001 — surface as a codec failure
        raise CodecError(
            f"control payload does not deserialize: {e!r}") from e
