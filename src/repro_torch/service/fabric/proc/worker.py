"""Shard worker entrypoint:
``python -m repro_torch.service.fabric.proc.worker`` (the port of
``repro.service.fabric.proc.worker``).

One worker process hosts one full :class:`~repro_torch.service.server.
StratumService` — fair queue, coalescer, cross-agent CSE, intermediate
cache, compiled-plan cache — behind a framed socket to the supervisor.
The protocol from the worker's seat:

1. connect to ``--host:--port``, send ``HELLO {shard_id, pid}``;
2. receive ``CONFIG`` (pickled :class:`ServiceConfig` + proc options),
   start heartbeating, build the service on the config's device (its own
   CUDA context; a ``cuda`` device on a machine without one exits
   ``EXIT_BAD_CONFIG``, never falling back to the CPU);
3. loop: decode frames → JobEnvelope → ``service.submit`` → on future
   completion, encode the ResultEnvelope back.  CancelEnvelopes reach
   into the local fair queue exactly like
   :class:`~repro_torch.service.fabric.transport.LocalTransport` does;
4. a heartbeat thread ships liveness + queue depth + telemetry
   snapshots every ``heartbeat_s`` — the supervisor's health check and
   the autoscaler's sensors.  It starts before the service is built, so a
   slow cold start (CUDA initialisation) is not silence; beats carry
   ``ready`` once the service exists, and the segment backend's compile
   stats;
5. ``DRAIN`` (or SIGTERM, or atexit) triggers the graceful path: stop
   heartbeats, ``service.stop(drain=True)`` (finishes every queued job,
   the done-callbacks flush the replies), send ``BYE``, exit 0.

Failure posture: a lost supervisor socket is retried briefly (transient
blips re-attach and the undelivered replies are flushed after the new
HELLO); a supervisor that stays gone — or a re-parenting to init —
makes the worker exit rather than orphan itself.  A worker never
*requeues* anything: at-least-once delivery lives in the router's
``fail_shard`` on the supervisor side, where the pending table is.
"""

from __future__ import annotations

import argparse
import atexit
import importlib
import os
import pickle
import signal
import socket
import sys
import threading
import time
from typing import Optional

from ...queue import AdmissionError
from ...server import StratumService
from ..envelope import (CodecError, ResultEnvelope, _CANCEL_KIND, _JOB_KIND,
                        decode_cancel, decode_job, encode_result, frame_kind)
from ..transport import result_envelope_for
from .frames import (BYE, CONFIG, DRAIN, HANDOFF_DATA, HANDOFF_PUT,
                     HANDOFF_REQ, HEARTBEAT, HELLO, MAX_FRAME_BYTES,
                     FrameDecoder, FrameError, decode_control, encode_control,
                     write_frame)

EXIT_OK = 0
EXIT_NO_SUPERVISOR = 3
EXIT_BAD_CONFIG = 4

_RECONNECT_WINDOW_S = 5.0
_RECONNECT_STEP_S = 0.1


def _within_bytes(entries: list, max_bytes: int) -> list:
    """The hand-off's entries, most recently used first, that fit in
    ``max_bytes`` together; an entry larger than that alone is skipped."""
    out, total = [], 0
    for sig, blob in entries:
        if total + len(blob) <= max_bytes:
            out.append((sig, blob))
            total += len(blob)
    return out


class ShardWorker:
    def __init__(self, host: str, port: int, shard_id: str):
        self.host = host
        self.port = port
        self.shard_id = shard_id
        self.service: Optional[StratumService] = None
        self.heartbeat_s = 0.25
        self._sock: Optional[socket.socket] = None
        self._wlock = threading.Lock()      # one writer at a time
        self._draining = threading.Event()
        self._drained = threading.Event()
        # envelope_id -> (shard-local future, attempt): CancelEnvelopes
        # need to find the queue entry, exactly like LocalTransport
        self._inflight: dict[str, tuple] = {}
        self._ilock = threading.Lock()
        # replies that failed to send while the socket was down; flushed
        # right after a reconnect handshake (results are never droppable —
        # a lost reply is a lost job from the client's point of view until
        # failover re-runs it)
        self._unsent: list[bytes] = []
        self.handoff_imported = 0           # warm hand-off entries taken in

    # -- connection ----------------------------------------------------------
    def _connect(self) -> socket.socket:
        sock = socket.create_connection((self.host, self.port), timeout=5.0)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(None)
        return sock

    def _hello(self, sock: socket.socket) -> None:
        write_frame(sock, encode_control(
            HELLO, {"shard_id": self.shard_id, "pid": os.getpid()}))

    def _await_config(self, sock: socket.socket,
                      decoder: FrameDecoder) -> list:
        """Block until the CONFIG frame, build the service, and return any
        frames that rode in the same chunk — with a fast submitter the
        first JobEnvelope can coalesce right behind CONFIG on the stream,
        and dropping it would lose a job before the fabric even warmed
        up."""
        sock.settimeout(10.0)
        try:
            while True:
                chunk = sock.recv(1 << 16)
                if not chunk:
                    raise ConnectionError("supervisor closed during setup")
                frames = decoder.feed(chunk)
                if not frames:
                    continue
                kind, payload = decode_control(frames[0])
                if kind != CONFIG:
                    raise CodecError(f"expected CONFIG, got kind {kind:#x}")
                # op implementations register by import side effect; the
                # supervisor tells us which registries this fabric needs
                for mod in payload.get("preload", ()):
                    importlib.import_module(mod)
                cfg = pickle.loads(payload["service_config"])
                cfg.shard_id = self.shard_id
                self.heartbeat_s = float(
                    payload.get("heartbeat_s", self.heartbeat_s))
                # liveness from here on: the service's build (a CUDA
                # context, the backends) is part of the cold start
                with self._wlock:
                    self._sock = sock
                threading.Thread(target=self._heartbeat_loop,
                                 name="worker-heartbeat",
                                 daemon=True).start()
                try:
                    self.service = StratumService(cfg, autostart=True)
                except BaseException:
                    with self._wlock:      # no BYE: this is no drain
                        self._sock = None
                    self._draining.set()   # stops the heartbeats
                    self._drained.set()
                    raise
                return frames[1:]
        finally:
            sock.settimeout(None)

    def _reconnect(self) -> bool:
        """Transient socket loss: try to re-reach the supervisor inside a
        short window, re-HELLO, flush undelivered replies.  False means
        the supervisor is gone for good."""
        deadline = time.monotonic() + _RECONNECT_WINDOW_S
        while time.monotonic() < deadline and not self._draining.is_set():
            try:
                sock = self._connect()
                self._hello(sock)
            except OSError:
                time.sleep(_RECONNECT_STEP_S)
                continue
            with self._wlock:
                self._sock = sock
                backlog, self._unsent = self._unsent, []
            for frame in backlog:
                self._send_frame(frame, droppable=False)
            return True
        return False

    # -- outbound ------------------------------------------------------------
    def _send_frame(self, frame: bytes, droppable: bool = True) -> None:
        with self._wlock:
            sock = self._sock
            if sock is not None:
                try:
                    write_frame(sock, frame)
                    return
                except OSError:
                    pass
            if not droppable:
                self._unsent.append(frame)

    def _reply(self, env: ResultEnvelope) -> None:
        self._send_frame(encode_result(env), droppable=False)

    # -- job / cancel handling ----------------------------------------------
    def _on_job(self, frame: bytes) -> None:
        env = decode_job(frame)    # the serialization seam, worker side
        try:
            future = self.service.submit(env.tenant, env.batch,
                                         priority=env.priority,
                                         deadline_s=env.deadline_s,
                                         tags=env.tags,
                                         trace_key=env.envelope_id,
                                         trace_hops=env.hops)
        except Exception as e:     # noqa: BLE001 — includes AdmissionError:
            # a remote shard cannot raise into the caller's stack; the
            # rejection travels back as an error ResultEnvelope instead
            # (the transport's admission window makes this the rare path)
            self._reply(ResultEnvelope(
                envelope_id=env.envelope_id, tenant=env.tenant,
                shard_id=self.shard_id, ok=False, error=e,
                attempt=env.attempt))
            return
        envelope_id, tenant, attempt = (env.envelope_id, env.tenant,
                                        env.attempt)
        with self._ilock:
            self._inflight[envelope_id] = (future, attempt)
        future.add_done_callback(
            lambda f: self._complete(f, envelope_id, tenant, attempt))

    def _complete(self, future, envelope_id: str, tenant: str,
                  attempt: int) -> None:
        with self._ilock:
            self._inflight.pop(envelope_id, None)
        self._reply(result_envelope_for(future, envelope_id, tenant,
                                        self.shard_id, attempt))

    def _on_cancel(self, frame: bytes) -> None:
        env = decode_cancel(frame)
        with self._ilock:
            entry = self._inflight.get(env.envelope_id)
        if entry is None:
            return                  # already answered (or never arrived)
        future, attempt = entry
        if env.attempt != attempt:
            return                  # stale cancel for a superseded try
        # queue removal fires the done callback with CancelledError, which
        # travels back as an ordinary ResultEnvelope — the router resolves
        # the client future as *cancelled* on receipt
        future.cancel()

    # -- control handling ----------------------------------------------------
    def _on_control(self, frame: bytes) -> None:
        kind, payload = decode_control(frame)
        if kind == DRAIN:
            self._begin_drain()
        elif kind == HANDOFF_REQ:
            cache = getattr(self.service, "cache", None)
            entries = []
            if cache is not None:
                entries = _within_bytes(
                    cache.export_hot_entries(
                        int(payload.get("max_entries", 64))),
                    int(payload.get("max_bytes", MAX_FRAME_BYTES // 2)))
            self._send_frame(encode_control(
                HANDOFF_DATA, {"shard_id": self.shard_id,
                               "entries": entries}), droppable=False)
        elif kind == HANDOFF_PUT:
            cache = getattr(self.service, "cache", None)
            if cache is not None:
                self.handoff_imported += cache.import_spilled(
                    payload.get("entries", ()))

    # -- heartbeat ------------------------------------------------------------
    def _heartbeat_loop(self) -> None:
        while not self._draining.wait(self.heartbeat_s):
            if os.getppid() == 1:
                # re-parented to init: the supervisor died without telling
                # us.  Exit rather than orphan a busy-looping service.
                os._exit(EXIT_NO_SUPERVISOR)
            svc = self.service
            if svc is None:
                self._send_frame(encode_control(HEARTBEAT, {
                    "shard_id": self.shard_id, "pid": os.getpid(),
                    "t": time.monotonic(), "ready": False,
                    "queue_depth": 0, "inflight": 0}), droppable=True)
                continue
            # fabric-side closed-loop control piggybacks the heartbeat
            # cadence (no extra thread in the worker either); maybe_tick
            # self-rate-limits, so double-ticking with the dispatch loop
            # is harmless
            ctl = getattr(svc, "controller", None)
            if ctl is not None:
                try:
                    ctl.maybe_tick()
                except Exception:  # noqa: BLE001 — control must not kill
                    pass           # the heartbeat
            try:
                beat = {
                    "shard_id": self.shard_id,
                    "pid": os.getpid(),
                    "t": time.monotonic(),
                    "queue_depth": svc.queue_depth(),
                    "inflight": svc.inflight(),
                    "ready": True,
                    "handoff_imported": self.handoff_imported,
                    "tenants": svc.telemetry.snapshot(),
                    "global": svc.telemetry.global_snapshot(),
                }
                seg = svc._backends.get("torch")
                if seg is not None and hasattr(seg, "stats"):
                    beat["segments"] = seg.stats()
            except Exception:  # noqa: BLE001 — telemetry must not kill us
                continue
            self._send_frame(encode_control(HEARTBEAT, beat),
                             droppable=True)

    # -- drain ----------------------------------------------------------------
    def _begin_drain(self) -> None:
        """Graceful exit: finish queued work, flush replies, say BYE.
        Idempotent — DRAIN frame, SIGTERM and atexit all funnel here."""
        if self._draining.is_set():
            self._drained.wait(timeout=60.0)
            return
        self._draining.set()
        svc = self.service
        if svc is not None:
            # drain=True waits out the fair queue and every in-flight
            # super-batch; each finished job's done-callback already sent
            # its reply by the time stop() returns
            svc.stop(drain=True)
        self._send_frame(encode_control(
            BYE, {"shard_id": self.shard_id, "pid": os.getpid()}),
            droppable=True)
        with self._wlock:
            sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        self._drained.set()

    # -- main loop -------------------------------------------------------------
    def run(self) -> int:
        try:
            sock = self._connect()
            self._hello(sock)
        except OSError:
            return EXIT_NO_SUPERVISOR
        decoder = FrameDecoder()
        try:
            leftover = self._await_config(sock, decoder)
        except Exception:  # noqa: BLE001 — bad/missing CONFIG
            return EXIT_BAD_CONFIG
        for frame in leftover:      # frames that coalesced behind CONFIG
            self._handle(frame)
        while not self._draining.is_set():
            try:
                chunk = sock.recv(1 << 16)
            except OSError:
                chunk = b""
            except InterruptedError:
                continue
            if not chunk:
                if self._draining.is_set():
                    break
                if not self._reconnect():
                    # the supervisor is gone: don't orphan ourselves.
                    # Nonzero exit — this is not a graceful drain.
                    return EXIT_NO_SUPERVISOR
                with self._wlock:
                    sock = self._sock
                decoder = FrameDecoder()    # fresh stream, fresh framing
                continue
            try:
                frames = decoder.feed(chunk)
            except FrameError:
                return EXIT_BAD_CONFIG      # supervisor stream corrupt
            for frame in frames:
                self._handle(frame)
        self._drained.wait(timeout=60.0)
        return EXIT_OK

    def _handle(self, frame: bytes) -> None:
        try:
            kind = frame_kind(frame)
            if kind == _JOB_KIND:
                self._on_job(frame)
            elif kind == _CANCEL_KIND:
                self._on_cancel(frame)
            else:
                self._on_control(frame)
        except CodecError:
            pass        # checksum-corrupt frame: poisoned alone, skip it
        except Exception:  # noqa: BLE001 — one bad frame must not kill us
            pass


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.service.fabric.proc.worker",
        description="stratum shard worker: hosts one StratumService per "
                    "process behind a framed socket to its supervisor")
    ap.add_argument("--host", default="127.0.0.1",
                    help="supervisor listener host")
    ap.add_argument("--port", type=int, required=True,
                    help="supervisor listener port")
    ap.add_argument("--shard-id", required=True,
                    help="this worker's shard identity on the ring")
    args = ap.parse_args(argv)

    worker = ShardWorker(args.host, args.port, args.shard_id)

    def _sigterm(signum, frame):  # noqa: ARG001
        worker._begin_drain()
        os._exit(EXIT_OK)

    signal.signal(signal.SIGTERM, _sigterm)
    atexit.register(worker._begin_drain)
    return worker.run()


if __name__ == "__main__":
    sys.exit(main())
