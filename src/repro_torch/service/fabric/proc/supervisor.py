"""Spawns, monitors and reaps shard worker processes (the port of
``repro.service.fabric.proc.supervisor``).

The :class:`WorkerSupervisor` owns the listener socket the workers dial
back to and one :class:`_WorkerHandle` per live worker: the ``Popen``,
the :class:`~.transport.ProcTransport`, the latest heartbeat, and the
:class:`_ShardProxy` the fabric stores in place of an in-process
:class:`~repro_torch.service.server.StratumService`.

Health is judged three ways, all funnelling into one idempotent
``on_failure(shard_id, reason)`` callback (the fabric wires it to
``fail_shard`` — the existing requeue machinery — so a real ``kill -9``
loses zero jobs):

* **process exit** — ``poll()`` returns a code and no BYE was seen;
* **socket loss** — the transport reports EOF; a short reconnect grace
  lets a transiently-dropped worker re-attach (it flushes undelivered
  replies after the new HELLO) before the shard is declared dead;
* **heartbeat silence** — no frame for ``heartbeat_timeout_s`` despite a
  live process: a hung interpreter (SIGSTOP, deadlock, runaway C call)
  looks exactly like a crash to clients, so it is treated as one —
  SIGKILL first, *then* failover, so the zombie can never answer for
  work already re-homed.

Graceful removal (:meth:`graceful_stop`) escalates politely: DRAIN frame
→ wait for voluntary exit 0 → SIGTERM (the worker's handler runs the
same drain) → SIGKILL as the last resort.  ``reaped`` keeps every exit
code so tests can assert clean shutdowns and the absence of orphans.

Workers are started with ``subprocess.Popen`` (fork and exec of a fresh
interpreter running ``python -m repro_torch.service.fabric.proc.worker``),
never with ``multiprocessing``'s fork: the parent may hold a CUDA context,
which a forked child cannot use.  Each worker builds its own CUDA context
on the fabric's device.  :meth:`WorkerSupervisor.worker_stats` keeps, per
worker, the seconds from spawn to its HELLO and to its first heartbeat
with a built service, and the largest gap between two heartbeats.
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from ...telemetry import merge_tenant_snapshots
from ..envelope import CodecError
from .frames import (BYE, CONFIG, HANDOFF_DATA, HANDOFF_PUT, HANDOFF_REQ,
                     HEARTBEAT, HELLO, MAX_FRAME_BYTES, decode_control,
                     encode_control, write_frame)
from .transport import ProcTransport, TransportError

WORKER_MODULE = "repro_torch.service.fabric.proc.worker"


@dataclass
class ProcConfig:
    """Process-fabric knobs, orthogonal to the per-shard ServiceConfig."""
    host: str = "127.0.0.1"
    heartbeat_s: float = 0.25
    heartbeat_timeout_s: float = 5.0
    spawn_timeout_s: float = 30.0
    drain_timeout_s: float = 30.0
    # how long a worker whose socket dropped may reconnect before the
    # shard is declared failed (its process must still be alive)
    reconnect_grace_s: float = 1.0
    # synchronous admission window; 0 → sized from max_queued_total
    window: int = 0
    max_frame_bytes: int = MAX_FRAME_BYTES
    # hot cache entries shipped to the ring successor on scale-down
    handoff_entries: int = 64
    # modules each worker imports before building its service — op
    # implementations register with repro_torch.core by import side effect,
    # and a bare worker process hasn't imported any of them.  Only the
    # port's modules: a worker never imports the JAX package
    preload: tuple = ("repro_torch.tabular",)


class _WorkerHandle:
    def __init__(self, shard_id: str, transport: ProcTransport,
                 config_blob: bytes):
        self.shard_id = shard_id
        self.transport = transport
        self.config_blob = config_blob
        self.proc: Optional[subprocess.Popen] = None
        self.handshaken = threading.Event()
        self.handshake_t: Optional[float] = None
        self.last_beat: Optional[dict] = None
        self.last_beat_t: Optional[float] = None
        self.disconnect_t: Optional[float] = None
        self.saw_bye = False
        self.draining = False
        self.failed = False
        self.handoff_event = threading.Event()
        self.handoff_entries: list = []
        # start-up and liveness record (worker_stats)
        self.spawn_t: Optional[float] = None
        self.hello_t: Optional[float] = None
        self.ready_t: Optional[float] = None
        self.max_beat_gap_s = 0.0


class _ProxyTelemetry:
    """Heartbeat-fed stand-in for ``StratumService.telemetry`` — feeds
    :class:`~..telemetry.FabricTelemetry`'s aggregation (including
    ``retire``) without any cross-process call at snapshot time."""

    _ZERO_GLOBAL = {"super_batches": 0, "jobs_coalesced": 0,
                    "ops_deduped_cross_agent": 0, "preemptions": 0}

    def __init__(self, handle: _WorkerHandle):
        self._handle = handle

    def snapshot(self) -> dict:
        beat = self._handle.last_beat
        tenants = (beat or {}).get("tenants") or {}
        # merge normalizes shapes and deep-copies, so callers can't
        # mutate the heartbeat in place
        return merge_tenant_snapshots([tenants])

    def global_snapshot(self) -> dict:
        beat = self._handle.last_beat
        g = (beat or {}).get("global")
        if not g:
            return dict(self._ZERO_GLOBAL)
        return dict(g)


class _ShardProxy:
    """What the fabric stores per shard instead of an in-process service.
    Quacks exactly enough like :class:`StratumService` for the base
    fabric's membership paths and FabricTelemetry's aggregation."""

    def __init__(self, handle: _WorkerHandle, supervisor: "WorkerSupervisor"):
        self._handle = handle
        self._supervisor = supervisor
        self.telemetry = _ProxyTelemetry(handle)

    @property
    def shard_id(self) -> str:
        return self._handle.shard_id

    @property
    def pid(self) -> Optional[int]:
        p = self._handle.proc
        return p.pid if p is not None else None

    def queue_depth(self) -> int:
        beat = self._handle.last_beat
        return int((beat or {}).get("queue_depth", 0))

    def inflight(self) -> int:
        beat = self._handle.last_beat
        return int((beat or {}).get("inflight", 0))

    def start(self) -> "_ShardProxy":
        return self            # workers autostart their service

    def stop(self, drain: bool = True) -> None:
        if drain:
            self._supervisor.graceful_stop(self._handle.shard_id)
        else:
            self._supervisor.destroy(self._handle.shard_id)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed during handshake")
        buf += chunk
    return bytes(buf)


def _read_one_frame(sock: socket.socket, limit: int) -> bytes:
    """Exact-length read of one frame — consumes nothing past it, so the
    socket hands off to the transport's reader with clean framing."""
    (length,) = struct.unpack(">I", _recv_exact(sock, 4))
    if length > limit:
        raise ConnectionError(f"handshake frame too large ({length})")
    return _recv_exact(sock, length)


class WorkerSupervisor:
    def __init__(self, proc_config: Optional[ProcConfig] = None,
                 on_failure: Optional[Callable[[str, str], None]] = None):
        self.config = proc_config or ProcConfig()
        self.on_failure = on_failure
        self._handles: dict[str, _WorkerHandle] = {}
        self._lock = threading.RLock()
        self._closed = False
        self.reaped: dict[str, Optional[int]] = {}   # shard_id -> returncode
        self.spawns = 0
        self.failures: list[tuple[str, str]] = []
        self.handoff_entries_shipped = 0
        self._retired_stats: dict[str, dict] = {}   # shard_id -> stats
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self.config.host, 0))
        self._listener.listen(64)
        self.port = self._listener.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="proc-supervisor-accept",
            daemon=True)
        self._accept_thread.start()
        self._monitor_thread = threading.Thread(
            target=self._monitor_loop, name="proc-supervisor-monitor",
            daemon=True)
        self._monitor_thread.start()

    # -- spawn ---------------------------------------------------------------
    def spawn(self, shard_id: str, service_config) -> _ShardProxy:
        """Launch one worker process hosting ``shard_id`` and wait for its
        handshake.  Returns the fabric-facing proxy."""
        cfg = self.config
        window = cfg.window or int(
            getattr(service_config, "max_queued_total", 0))
        transport = ProcTransport(shard_id, window=window,
                                  max_frame_bytes=cfg.max_frame_bytes)
        blob = pickle.dumps(service_config,
                            protocol=pickle.HIGHEST_PROTOCOL)
        handle = _WorkerHandle(shard_id, transport, blob)
        transport.on_control = \
            lambda kind, payload: self._on_control(handle, kind, payload)
        transport.on_disconnect = lambda: self._on_disconnect(handle)
        with self._lock:
            if self._closed:
                raise RuntimeError("supervisor is shut down")
            if shard_id in self._handles:
                raise ValueError(f"shard {shard_id!r} already supervised")
            self._handles[shard_id] = handle
        env = dict(os.environ)
        src_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))))))
        env["PYTHONPATH"] = src_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        env["STRATUM_PROC_WORKER"] = shard_id
        handle.spawn_t = time.monotonic()
        try:
            handle.proc = subprocess.Popen(
                [sys.executable, "-m", WORKER_MODULE,
                 "--host", cfg.host, "--port", str(self.port),
                 "--shard-id", shard_id],
                env=env, start_new_session=True)
        except Exception:
            with self._lock:
                self._handles.pop(shard_id, None)
            raise
        self.spawns += 1
        if not handle.handshaken.wait(cfg.spawn_timeout_s):
            self.destroy(shard_id)
            raise TimeoutError(
                f"worker for shard {shard_id!r} did not handshake within "
                f"{cfg.spawn_timeout_s}s")
        return _ShardProxy(handle, self)

    # -- handshake path ------------------------------------------------------
    def _accept_loop(self) -> None:
        while True:
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return                      # listener closed: shutting down
            threading.Thread(target=self._handshake, args=(sock,),
                             name="proc-supervisor-handshake",
                             daemon=True).start()

    def _handshake(self, sock: socket.socket) -> None:
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(10.0)
            frame = _read_one_frame(sock, self.config.max_frame_bytes)
            kind, payload = decode_control(frame)
            if kind != HELLO:
                raise CodecError(f"expected HELLO, got kind {kind:#x}")
            shard_id = payload.get("shard_id", "")
            with self._lock:
                handle = self._handles.get(shard_id)
            if handle is None or handle.failed:
                sock.close()                # stranger (or zombie): refuse
                return
            if not handle.handshaken.is_set():
                # first contact: ship the service config, then go live
                write_frame(sock, encode_control(CONFIG, {
                    "service_config": handle.config_blob,
                    "heartbeat_s": self.config.heartbeat_s,
                    "preload": tuple(self.config.preload),
                }))
            sock.settimeout(None)
            handle.transport.attach(sock)
            handle.disconnect_t = None
            handle.handshake_t = time.monotonic()
            if handle.hello_t is None:
                handle.hello_t = handle.handshake_t
            handle.handshaken.set()
        except (OSError, ConnectionError, CodecError, TransportError):
            try:
                sock.close()
            except OSError:
                pass

    # -- control-plane events ------------------------------------------------
    def _on_control(self, handle: _WorkerHandle, kind: int,
                    payload: dict) -> None:
        if kind == HEARTBEAT:
            now = time.monotonic()
            prev = max(handle.last_beat_t or 0.0, handle.handshake_t or 0.0)
            if prev:
                handle.max_beat_gap_s = max(handle.max_beat_gap_s, now - prev)
            handle.last_beat = payload
            handle.last_beat_t = now
            if handle.ready_t is None and payload.get("ready", True):
                handle.ready_t = now
        elif kind == BYE:
            handle.saw_bye = True
        elif kind == HANDOFF_DATA:
            handle.handoff_entries = list(payload.get("entries", ()))
            handle.handoff_event.set()

    def _on_disconnect(self, handle: _WorkerHandle) -> None:
        if handle.draining or handle.failed or handle.saw_bye:
            return
        proc = handle.proc
        if proc is not None and proc.poll() is not None:
            # the process is gone too — no point waiting out the grace
            self._fail(handle, f"worker exited rc={proc.returncode}")
            return
        handle.disconnect_t = time.monotonic()

    # -- health monitor ------------------------------------------------------
    def _monitor_loop(self) -> None:
        cfg = self.config
        tick = max(0.05, min(cfg.heartbeat_s / 2, 0.25))
        while not self._closed:
            time.sleep(tick)
            now = time.monotonic()
            with self._lock:
                handles = list(self._handles.values())
            for h in handles:
                if h.failed or h.draining or not h.handshaken.is_set():
                    continue
                proc = h.proc
                if proc is not None and proc.poll() is not None \
                        and not h.saw_bye:
                    self._fail(h, f"worker exited rc={proc.returncode}")
                    continue
                if h.disconnect_t is not None \
                        and now - h.disconnect_t > cfg.reconnect_grace_s:
                    self._fail(h, "socket lost, reconnect grace expired")
                    continue
                last = max(h.last_beat_t or 0.0, h.handshake_t or 0.0)
                if last and now - last > cfg.heartbeat_timeout_s:
                    # alive-but-silent (hung interpreter): same as a crash
                    self._fail(h, f"no heartbeat for "
                                  f"{now - last:.1f}s")

    def _fail(self, handle: _WorkerHandle, reason: str) -> None:
        with self._lock:
            if handle.failed or handle.draining:
                return
            handle.failed = True
            self.failures.append((handle.shard_id, reason))
        # silence + kill BEFORE failover: a half-dead worker must never
        # answer for work about to be re-homed
        handle.transport.kill()
        self._reap(handle, force=True)
        cb = self.on_failure
        if cb is not None:
            try:
                cb(handle.shard_id, reason)
            except Exception:  # noqa: BLE001 — monitor must keep running
                pass

    # -- teardown ------------------------------------------------------------
    def graceful_stop(self, shard_id: str) -> None:
        """DRAIN → voluntary exit → SIGTERM → SIGKILL, then reap."""
        with self._lock:
            handle = self._handles.get(shard_id)
            if handle is None:
                return
            handle.draining = True
        cfg = self.config
        handle.transport.close()            # sends the DRAIN frame
        proc = handle.proc
        if proc is not None:
            try:
                proc.wait(timeout=cfg.drain_timeout_s)
            except subprocess.TimeoutExpired:
                proc.terminate()            # SIGTERM: worker drains + exits
                try:
                    proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        self._finish(handle)

    def destroy(self, shard_id: str) -> None:
        """Hard removal: SIGKILL and reap, no drain."""
        with self._lock:
            handle = self._handles.get(shard_id)
            if handle is None:
                return
            handle.failed = True
        handle.transport.kill()
        self._reap(handle, force=True)
        self._finish(handle)

    def _reap(self, handle: _WorkerHandle, force: bool) -> None:
        proc = handle.proc
        if proc is None:
            return
        if force and proc.poll() is None:
            try:
                proc.kill()
            except OSError:
                pass
        try:
            proc.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            pass

    def _finish(self, handle: _WorkerHandle) -> None:
        with self._lock:
            self._handles.pop(handle.shard_id, None)
            proc = handle.proc
            self.reaped[handle.shard_id] = (
                proc.returncode if proc is not None else None)
            self._retired_stats[handle.shard_id] = self._stats_of(handle)

    def shutdown(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            shard_ids = list(self._handles)
        for shard_id in shard_ids:
            self.graceful_stop(shard_id)
        try:
            self._listener.close()
        except OSError:
            pass

    # -- warm hand-off -------------------------------------------------------
    def request_handoff(self, shard_id: str,
                        timeout: float = 10.0) -> list:
        """Ask a (draining) worker for its hottest cache entries."""
        with self._lock:
            handle = self._handles.get(shard_id)
        if handle is None:
            return []
        handle.handoff_event.clear()
        try:
            # one HANDOFF_DATA frame carries the entries, so the worker
            # keeps them well under the frame limit: a frame past it would
            # desynchronise the stream and fail the worker
            handle.transport.send_control(
                HANDOFF_REQ, {"max_entries": self.config.handoff_entries,
                              "max_bytes": self.config.max_frame_bytes // 2})
        except TransportError:
            return []
        if not handle.handoff_event.wait(timeout):
            return []
        return handle.handoff_entries

    def deliver_handoff(self, shard_id: str, entries: list) -> bool:
        """Ship exported cache entries to the successor's worker."""
        if not entries:
            return False
        with self._lock:
            handle = self._handles.get(shard_id)
        if handle is None:
            return False
        try:
            handle.transport.send_control(HANDOFF_PUT, {"entries": entries})
        except TransportError:
            return False
        self.handoff_entries_shipped += len(entries)
        return True

    # -- introspection -------------------------------------------------------
    def live_workers(self) -> dict[str, Optional[int]]:
        with self._lock:
            return {sid: (h.proc.pid if h.proc is not None else None)
                    for sid, h in self._handles.items()}

    @staticmethod
    def _stats_of(h: _WorkerHandle) -> dict:
        def since_spawn(t):
            return None if t is None or h.spawn_t is None else t - h.spawn_t
        return {"pid": h.proc.pid if h.proc is not None else None,
                "hello_s": since_spawn(h.hello_t),
                "ready_s": since_spawn(h.ready_t),
                "max_beat_gap_s": h.max_beat_gap_s,
                "handoff_imported": int((h.last_beat or {}).get(
                    "handoff_imported", 0)),
                "segments": dict((h.last_beat or {}).get("segments") or {})}

    def worker_stats(self) -> dict[str, dict]:
        """Per worker, live or gone: its pid, the seconds from spawn to its
        HELLO (interpreter and imports) and to its first heartbeat with a
        built service, the largest gap between two heartbeats (or the
        handshake and the first), the warm hand-off entries it imported,
        and its last reported segment-compile stats (traces, compiles and
        their seconds)."""
        with self._lock:
            out = dict(self._retired_stats)
            out.update({sid: self._stats_of(h)
                        for sid, h in self._handles.items()})
        return out
