"""Socket-backed :class:`~repro_torch.service.fabric.transport.Transport`.

One :class:`ProcTransport` is the supervisor-side end of one worker's
socket.  It carries the *unchanged* Job/Result/Cancel envelope frames —
the router above it cannot tell it apart from a
:class:`~repro_torch.service.fabric.transport.LocalTransport` — plus the
control-plane frames (heartbeat, bye, handoff) which it routes to the
supervisor via ``on_control`` instead of the router.

Two contracts the in-process transport gets for free need explicit work
here:

* **synchronous backpressure** — ``Session.submit`` documents that an
  over-admitted tenant sees :class:`AdmissionError` *at the call site*.
  A remote shard can only reject asynchronously, so the transport keeps a
  client-side admission window (jobs sent minus result frames received,
  sized from the worker's ``ServiceConfig.max_queued_total``) and raises
  ``AdmissionError`` before the frame ever hits the socket when the
  window is full.  The worker still enforces the real limit; the window
  is the synchronous shadow of it.
* **crash silence** — a killed worker must look exactly like
  ``LocalTransport.kill()``: no replies for in-flight work, sends raise
  :class:`TransportError`.  The reader thread reports EOF/socket errors
  through ``on_disconnect`` (the supervisor decides between reconnect
  grace and declaring the shard dead); once :meth:`kill` runs, late
  frames from a half-dead peer are dropped on the floor.

A worker that reconnects (transient socket loss, *not* a crash) is
re-attached with :meth:`attach`; the admission window carries over
because the worker flushes its undelivered replies right after the
reconnect handshake — accounting stays consistent without a reset.
"""

from __future__ import annotations

import socket
import threading
from typing import Callable, Optional

from ...queue import AdmissionError
from ..envelope import CodecError, _RESULT_KIND
from ..transport import Transport, TransportError
from .frames import (CONTROL_KINDS, DRAIN, FrameDecoder, FrameError,
                     MAX_FRAME_BYTES, decode_control, encode_control,
                     frame_kind, write_frame)


class ProcTransport(Transport):
    """Supervisor-side byte channel to one worker process.

    ``window`` is the synchronous admission window (0 disables it —
    the supervisor sizes it from the worker's ``max_queued_total``).
    ``on_control``/``on_disconnect`` are wired by the supervisor before
    the first :meth:`attach`.
    """

    def __init__(self, shard_id: str, window: int = 0,
                 max_frame_bytes: int = MAX_FRAME_BYTES):
        self.shard_id = shard_id
        self.window = int(window)
        self.max_frame_bytes = int(max_frame_bytes)
        self._on_result: Optional[Callable[[bytes], None]] = None
        self.on_control: Optional[Callable[[int, dict], None]] = None
        self.on_disconnect: Optional[Callable[[], None]] = None
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._gen = 0              # bumps per attach; stale readers exit
        self._dead = False         # kill(): crashed peer, drop everything
        self._closed = False       # close(): orderly drain, no new jobs
        self._inflight = 0         # guarded-by: _lock
        self.jobs_sent = 0
        self.results_received = 0
        self.cancels_sent = 0
        self.codec_errors = 0
        self.reconnects = 0
        self.bytes_in = 0
        self.bytes_out = 0

    # -- wiring --------------------------------------------------------------
    def set_on_result(self, cb: Callable[[bytes], None]) -> None:
        self._on_result = cb

    def attach(self, sock: socket.socket) -> None:
        """Bind a (new) connected socket and start its reader thread.
        Called once at spawn handshake and again on every reconnect."""
        with self._lock:
            if self._dead:
                raise TransportError(
                    f"shard {self.shard_id!r} already declared dead")
            old, self._sock = self._sock, sock
            self._gen += 1
            gen = self._gen
            if old is not None:
                self.reconnects += 1
        if old is not None:
            _quiet_close(old)
        t = threading.Thread(target=self._read_loop, args=(sock, gen),
                             name=f"proc-transport-{self.shard_id}",
                             daemon=True)
        t.start()

    # -- Transport interface -------------------------------------------------
    def send_job(self, data: bytes) -> None:
        with self._lock:
            if self._dead or self._closed:
                raise TransportError(f"shard {self.shard_id!r} unreachable")
            sock = self._sock
            if sock is None:
                raise TransportError(
                    f"shard {self.shard_id!r} disconnected")
            if self.window > 0 and self._inflight >= self.window:
                # synchronous shadow of the worker's admission control:
                # preserves the Session.submit raises-AdmissionError
                # contract across the process boundary
                raise AdmissionError(
                    f"shard {self.shard_id!r} admission window full "
                    f"({self._inflight}/{self.window} in flight)")
            self._inflight += 1
            self.jobs_sent += 1
            self.bytes_out += len(data) + 4
            try:
                write_frame(sock, data)
            except OSError as e:
                self._inflight -= 1
                self.jobs_sent -= 1
                raise TransportError(
                    f"shard {self.shard_id!r} send failed: {e}") from e

    def send_cancel(self, data: bytes) -> bool:
        with self._lock:
            if self._dead or self._closed:
                raise TransportError(f"shard {self.shard_id!r} unreachable")
            sock = self._sock
            if sock is None:
                raise TransportError(
                    f"shard {self.shard_id!r} disconnected")
            self.cancels_sent += 1
            self.bytes_out += len(data) + 4
            try:
                write_frame(sock, data)
            except OSError as e:
                raise TransportError(
                    f"shard {self.shard_id!r} send failed: {e}") from e
        # a remote shard can only confirm asynchronously: the honored
        # cancel comes back as a CancelledError ResultEnvelope
        return False

    def send_control(self, kind: int, obj: dict) -> None:
        """Supervisor → worker control frame (config/drain/handoff)."""
        with self._lock:
            sock = self._sock
            if sock is None or self._dead:
                raise TransportError(
                    f"shard {self.shard_id!r} unreachable")
            frame = encode_control(kind, obj)
            self.bytes_out += len(frame) + 4
            try:
                write_frame(sock, frame)
            except OSError as e:
                raise TransportError(
                    f"shard {self.shard_id!r} send failed: {e}") from e

    def close(self) -> None:
        """Orderly shutdown: tell the worker to drain, stop taking jobs.
        The socket stays open so in-flight replies and the BYE still
        arrive; the supervisor reaps the process after worker exit."""
        with self._lock:
            if self._closed or self._dead:
                return
            self._closed = True
            sock = self._sock
        if sock is not None:
            try:
                write_frame(sock, encode_control(DRAIN, {}))
            except OSError:
                pass

    def kill(self) -> None:
        """Crashed peer: silence everything, like LocalTransport.kill()."""
        with self._lock:
            if self._dead:
                return
            self._dead = True
            sock, self._sock = self._sock, None
        if sock is not None:
            _quiet_close(sock)

    # -- introspection -------------------------------------------------------
    def inflight_window(self) -> int:
        with self._lock:
            return self._inflight

    # -- reader side ---------------------------------------------------------
    def _read_loop(self, sock: socket.socket, gen: int) -> None:
        decoder = FrameDecoder(self.max_frame_bytes)
        try:
            while True:
                try:
                    chunk = sock.recv(1 << 16)
                except OSError:
                    break
                if not chunk:
                    break
                with self._lock:
                    self.bytes_in += len(chunk)
                for frame in decoder.feed(chunk):
                    self._dispatch(frame)
        except FrameError:
            # stream out of sync — unrecoverable on this connection; the
            # disconnect path below lets the supervisor decide reconnect
            # vs failover
            pass
        finally:
            _quiet_close(sock)
        with self._lock:
            stale = (gen != self._gen) or self._dead or self._closed
        if not stale and self.on_disconnect is not None:
            self.on_disconnect()

    def _dispatch(self, frame: bytes) -> None:
        try:
            kind = frame_kind(frame)
        except CodecError:
            with self._lock:
                self.codec_errors += 1
            return
        if kind == _RESULT_KIND:
            with self._lock:
                if self._dead:
                    return          # late frame from a declared-dead peer
                self.results_received += 1
                if self._inflight > 0:
                    self._inflight -= 1
            cb = self._on_result
            if cb is not None:
                cb(frame)
            return
        if kind in CONTROL_KINDS:
            try:
                kind, payload = decode_control(frame)
            except CodecError:
                with self._lock:
                    self.codec_errors += 1
                return
            cb2 = self.on_control
            if cb2 is not None:
                cb2(kind, payload)
            return
        with self._lock:            # job/cancel frames never flow this way
            self.codec_errors += 1


def _quiet_close(sock: socket.socket) -> None:
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass
