"""Transports carry encoded envelopes between the router and one shard.

A :class:`Transport` moves *bytes*, not objects: the router hands it an
encoded :class:`~.envelope.JobEnvelope` frame and receives encoded
:class:`~.envelope.ResultEnvelope` frames on the ``on_result`` callback it
registered.  Nothing above the codec is shared between the client side and
the shard side, which is what lets the shard move out-of-process later
(socket/RPC transports slot in here) without touching the router, the
session layer or the envelope schema.

:class:`LocalTransport` is the in-process implementation: the shard is a
:class:`~repro_torch.service.server.StratumService` living in this process, but
every submission still round-trips ``encode_job → bytes → decode_job`` and
every reply ``encode_result → bytes → decode_result`` — the serialization
seam is exercised on every message (and asserted by the round-trip tests),
not just promised.

``LocalTransport.kill()`` simulates a shard host dying: the transport stops
accepting sends and — crucially — never delivers replies for jobs already
in flight, which is exactly the silence a crashed remote peer produces.
The router's failover path (requeue onto ring successors) is tested against
this behaviour.
"""

from __future__ import annotations

import threading
from abc import ABC, abstractmethod
from typing import Callable, Optional

from ...core.analysis import AnalysisError
from ..queue import AdmissionError
from .envelope import (ResultEnvelope, decode_cancel, decode_job,
                       encode_result, FabricJobReport)


class TransportError(ConnectionError):
    """The peer shard is unreachable (dead, draining or closed)."""


def result_envelope_for(future, envelope_id: str, tenant: str,
                        shard_id: str, attempt: int) -> ResultEnvelope:
    """Terminal :class:`ResultEnvelope` for a *resolved* shard-local
    future — the one reply shape every transport sends, whether the shard
    lives in this process (:class:`LocalTransport`) or behind a socket
    (the proc fabric's worker).  The shard-side ``JobReport`` is flattened
    into the wire-safe :class:`FabricJobReport`."""
    try:
        results, report = future.result(timeout=0)
        wire_report = FabricJobReport(
            tenant=tenant, envelope_id=envelope_id,
            shard_id=shard_id,
            queue_wait_s=getattr(report, "queue_wait_s", 0.0),
            coalesced_with=getattr(report, "coalesced_with", 0),
            ops_shared_cross_agent=getattr(report,
                                           "ops_shared_cross_agent", 0),
            cache_hits=getattr(report, "cache_hits", 0),
            ops_salvaged=getattr(report, "ops_salvaged", 0),
            preemptions=getattr(report, "preemptions", 0),
            attempt=attempt,
            deadline_s=getattr(report, "deadline_s", None),
            deadline_met=getattr(report, "deadline_met", None),
            tags=tuple(getattr(report, "tags", ()) or ()),
            per_backend=dict(getattr(report, "per_backend", {}) or {}),
            hops=tuple(getattr(report, "trace", ()) or ()))
        return ResultEnvelope(envelope_id=envelope_id, tenant=tenant,
                              shard_id=shard_id, ok=True,
                              results=results, report=wire_report,
                              attempt=attempt)
    except BaseException as e:  # noqa: BLE001 — includes CancelledError
        return ResultEnvelope(envelope_id=envelope_id, tenant=tenant,
                              shard_id=shard_id, ok=False, error=e,
                              attempt=attempt)


class Transport(ABC):
    """One bidirectional byte channel between the router and one shard."""

    @abstractmethod
    def send_job(self, data: bytes) -> None:
        """Deliver one encoded JobEnvelope frame to the shard.

        Raises :class:`TransportError` when the shard is unreachable (the
        router treats that as a dead shard and fails over) and may raise
        :class:`~repro_torch.service.queue.AdmissionError` synchronously when
        an in-process shard applies backpressure."""

    @abstractmethod
    def set_on_result(self, cb: Callable[[bytes], None]) -> None:
        """Register the callback receiving encoded ResultEnvelope frames."""

    def send_cancel(self, data: bytes) -> bool:
        """Deliver one encoded CancelEnvelope frame to the shard.

        Returns True when the shard *synchronously* confirmed removal of
        the still-queued job (possible in-process); a remote transport
        returns False and delivers the confirmation — a ResultEnvelope
        carrying ``CancelledError`` — asynchronously like any reply.
        Transports predating cancellation simply don't override this, and
        the router degrades to abandoning the local future only."""
        raise NotImplementedError("transport does not support cancellation")

    @abstractmethod
    def close(self) -> None:
        """Orderly shutdown (drain-friendly); further sends raise."""


class LocalTransport(Transport):
    """In-process shard transport wrapping one :class:`StratumService`.

    All traffic crosses the wire codec in both directions; per-message
    byte counts are kept so tests and telemetry can assert the boundary
    is actually exercised.
    """

    def __init__(self, service, shard_id: str):
        self.service = service
        self.shard_id = shard_id
        self._on_result: Optional[Callable[[bytes], None]] = None
        self._lock = threading.Lock()
        self._dead = False
        self._closed = False
        # envelope_id -> (shard-local PipelineFuture, attempt), kept so a
        # CancelEnvelope can reach into the shard's queue; entries leave
        # on the terminal reply
        self._inflight: dict[str, tuple] = {}       # guarded-by: _lock
        self.jobs_received = 0
        self.results_sent = 0
        self.cancels_received = 0
        self.cancels_honored = 0
        self.bytes_in = 0
        self.bytes_out = 0

    # -- Transport interface ----------------------------------------------
    def set_on_result(self, cb: Callable[[bytes], None]) -> None:
        self._on_result = cb

    def send_job(self, data: bytes) -> None:
        with self._lock:
            if self._dead or self._closed:
                raise TransportError(f"shard {self.shard_id!r} unreachable")
            self.jobs_received += 1
            self.bytes_in += len(data)
        env = decode_job(data)     # the serialization seam, server side
        try:
            future = self.service.submit(env.tenant, env.batch,
                                         priority=env.priority,
                                         deadline_s=env.deadline_s,
                                         tags=env.tags,
                                         trace_key=env.envelope_id,
                                         trace_hops=env.hops)
        except (AdmissionError, AnalysisError):
            # in-process shard: backpressure and pre-flight analysis
            # rejections propagate synchronously so Session.submit keeps
            # its documented raises-at-submit contract.  (A remote
            # transport cannot do this and would deliver the rejection
            # via a ResultEnvelope instead.)
            raise
        except Exception as e:     # noqa: BLE001 — anything else at submit
            self._reply(ResultEnvelope(
                envelope_id=env.envelope_id, tenant=env.tenant,
                shard_id=self.shard_id, ok=False, error=e,
                attempt=env.attempt))
            return
        envelope_id, tenant, attempt = env.envelope_id, env.tenant, env.attempt
        with self._lock:
            self._inflight[envelope_id] = (future, attempt)
        future.add_done_callback(
            lambda f: self._complete(f, envelope_id, tenant, attempt))

    def send_cancel(self, data: bytes) -> bool:
        """Shard-aware cancellation: decode, find the local future, remove
        the job from this shard's fair queue if still queued.  The queue
        removal fires the future's done callback with ``CancelledError``,
        which travels back as an ordinary ResultEnvelope — the client-side
        router resolves the fabric future as *cancelled* on receipt."""
        with self._lock:
            if self._dead or self._closed:
                raise TransportError(f"shard {self.shard_id!r} unreachable")
            self.cancels_received += 1
            self.bytes_in += len(data)
        env = decode_cancel(data)      # the serialization seam, server side
        with self._lock:
            entry = self._inflight.get(env.envelope_id)
        if entry is None:
            return False               # already answered (or never arrived)
        future, attempt = entry
        if env.attempt != attempt:
            return False               # stale cancel for a superseded try
        honored = bool(future.cancel())
        if honored:
            with self._lock:
                self.cancels_honored += 1
        return honored

    def close(self) -> None:
        with self._lock:
            self._closed = True

    # -- crash simulation --------------------------------------------------
    def kill(self) -> None:
        """Hard-kill the shard: drop the connection AND silence every
        in-flight reply, like a crashed remote host."""
        with self._lock:
            self._dead = True

    # -- shard-side completion path ---------------------------------------
    def _complete(self, future, envelope_id: str, tenant: str,
                  attempt: int) -> None:
        with self._lock:
            self._inflight.pop(envelope_id, None)
        self._reply(result_envelope_for(future, envelope_id, tenant,
                                        self.shard_id, attempt))

    def _reply(self, env: ResultEnvelope) -> None:
        data = encode_result(env)  # the serialization seam, shard side
        with self._lock:
            if self._dead:         # crashed hosts don't answer
                return
            self.results_sent += 1
            self.bytes_out += len(data)
            cb = self._on_result
        if cb is not None:
            cb(data)
