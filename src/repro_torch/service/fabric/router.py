"""Routes job envelopes to shards over the consistent-hash ring.

The :class:`ShardRouter` is the fabric's client-side brain: it owns the
ring, one :class:`~.transport.Transport` per shard, and the *pending table*
— envelope_id → (envelope, future, shard) for every job whose reply has not
arrived.  Three flows meet here:

* **submit** — hash the envelope's routing key on the ring, record it
  pending, send the encoded frame.  A send that raises
  :class:`~.transport.TransportError` marks the shard dead and retries on
  the ring successor, so a submission never observes a half-dead fabric;
* **result** — decode the frame, pop the pending entry (first reply wins;
  duplicates from failover races are dropped), resolve the future —
  a ``CancelledError`` reply (the shard honored a CancelEnvelope)
  resolves it as *cancelled*, not failed;
* **cancel** — ``cancel(envelope_id)`` encodes a
  :class:`~.envelope.CancelEnvelope` to the owning shard, whose transport
  removes the still-queued job from the shard's fair queue (shard-aware
  cancellation: the admission slot and dispatch capacity free up, instead
  of only abandoning the local future);
* **membership** — ``add_shard`` extends the ring (only ~K/N keys remap,
  see ``ring.py``), ``drain_shard`` removes a shard from the ring, waits
  for its in-flight replies, then closes it; ``fail_shard`` removes it
  *and requeues its entire pending set* onto each envelope's ring
  successor with a bumped ``attempt`` — at-least-once delivery, which is
  sound here because pipelines are deterministic DAGs keyed by content
  signature (a re-run reproduces the same values and re-uses any cached
  intermediates that survived).

The router also keeps the fabric-level counters telemetry aggregates:
per-shard envelopes routed, signature-locality hits (a routing key seen
again on the shard that served it before — the measure of how well the
ring preserves cache/CSE locality), failover requeues and membership
changes.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Optional

# locality tracking is a statistics aid, not a correctness structure —
# bound it so a long-lived fabric's memory doesn't grow with every unique
# routing key ever seen
_LOCALITY_KEYS_MAX = 65536

from concurrent.futures import CancelledError

from ..observability import FAILOVER, ROUTED, make_hop
from ..session import PipelineFuture
from .envelope import (CancelEnvelope, JobEnvelope, decode_result,
                       encode_cancel, encode_job)
from .ring import ConsistentHashRing
from .transport import Transport, TransportError


class NoShardsError(RuntimeError):
    """Every shard is dead or the fabric was never given any."""


class _Pending:
    __slots__ = ("envelope", "future", "shard_id")

    def __init__(self, envelope: JobEnvelope, future: PipelineFuture,
                 shard_id: str):
        self.envelope = envelope
        self.future = future
        self.shard_id = shard_id


class ShardRouter:
    def __init__(self, vnodes: int = 64):
        self._ring = ConsistentHashRing(vnodes=vnodes)
        self._transports: dict[str, Transport] = {}    # guarded-by: _lock
        self._pending: dict[str, _Pending] = {}          # guarded-by: _lock
        self._last_shard_for_key: "OrderedDict[str, str]" = OrderedDict()  # guarded-by: _lock
        self._lock = threading.RLock()
        self._drained = threading.Condition(self._lock)
        # fabric-level counters (read by FabricTelemetry)
        self.envelopes_routed: dict[str, int] = {}
        self.locality_lookups = 0
        self.locality_hits = 0
        self.failover_requeues = 0
        self.shards_failed = 0
        self.shards_added = 0
        self.shards_drained = 0
        self.reply_codec_errors = 0
        self.cancels_sent = 0
        self.cancels_confirmed = 0
        # client-side TraceSink (set by StratumFabric when tracing is on):
        # routed/failover hops are stamped onto envelopes here, and
        # reassembled traces from result replies are stored through it
        self.trace_sink = None

    # -- membership --------------------------------------------------------
    def add_shard(self, shard_id: str, transport: Transport) -> None:
        with self._lock:
            if shard_id in self._transports:
                raise ValueError(f"shard {shard_id!r} already registered")
            transport.set_on_result(self._on_result)
            self._transports[shard_id] = transport
            self._ring.add(shard_id)
            self.envelopes_routed.setdefault(shard_id, 0)
            self.shards_added += 1

    def shard_ids(self) -> list[str]:
        with self._lock:
            return self._ring.nodes()

    def successor_of(self, shard_id: str) -> Optional[str]:
        """The next distinct live shard clockwise of ``shard_id`` on the
        ring — where the bulk of a departing shard's keys remap, and so
        the right recipient for its warm cache entries on scale-down."""
        with self._lock:
            for node in self._ring.successors(shard_id,
                                              exclude={shard_id}):
                return node
        return None

    def fail_shard(self, shard_id: str) -> int:
        """Declare ``shard_id`` dead: silence its transport, take it off
        the ring, requeue its pending work onto ring successors.  Returns
        the number of requeued envelopes."""
        with self._lock:
            transport = self._transports.pop(shard_id, None)
            if transport is None:
                return 0
            # silence the "crashed" host before anything else: a dead peer
            # must not answer for work about to be requeued elsewhere.
            # Bumping attempts under the same lock closes the window where
            # a just-arriving stale reply would still compare equal.
            if hasattr(transport, "kill"):
                transport.kill()
            if shard_id in self._ring:
                self._ring.remove(shard_id)
            self.shards_failed += 1
            orphans = [p for p in self._pending.values()
                       if p.shard_id == shard_id]
            for p in orphans:
                p.envelope.attempt += 1
        for p in orphans:
            self._stamp_env(p.envelope, FAILOVER, shard=shard_id,
                            attempt=p.envelope.attempt)
            self._route(p, is_requeue=True)
        return len(orphans)

    def drain_shard(self, shard_id: str, timeout: float = 30.0) -> None:
        """Graceful removal: stop routing new work to the shard, wait for
        its in-flight replies, then close the transport.  In-flight work
        finishes where it is — nothing is re-executed."""
        with self._lock:
            if shard_id not in self._transports:
                raise KeyError(f"unknown shard {shard_id!r}")
            if shard_id in self._ring:
                self._ring.remove(shard_id)     # new keys remap elsewhere
            deadline = time.monotonic() + timeout
            while any(p.shard_id == shard_id
                      for p in self._pending.values()):
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"shard {shard_id!r} still has in-flight work "
                        f"after {timeout}s")
                self._drained.wait(left)
            transport = self._transports.pop(shard_id)
            self.shards_drained += 1
        transport.close()

    # -- submit / result ---------------------------------------------------
    def submit(self, envelope: JobEnvelope,
               future: Optional[PipelineFuture] = None) -> PipelineFuture:
        if future is None:
            future = PipelineFuture(envelope.envelope_id, envelope.tenant,
                                    envelope.priority)
            # shard-aware cancellation: future.cancel() sends a
            # CancelEnvelope to the owning shard instead of only
            # abandoning the local handle
            eid = envelope.envelope_id
            future._cancel_hook = lambda _jid: self.cancel(eid)
        pending = _Pending(envelope, future, shard_id="")
        self._route(pending, is_requeue=False)
        return future

    def cancel(self, envelope_id: str) -> bool:
        """Ask the shard owning ``envelope_id`` to drop the still-queued
        job.  Returns True when the shard synchronously confirmed removal
        (in-process transports); the future itself resolves as cancelled
        via the CancelledError reply either way.  False when the job is
        unknown, already dispatched, or the transport cannot cancel."""
        with self._lock:
            pending = self._pending.get(envelope_id)
            if pending is None:
                return False
            transport = self._transports.get(pending.shard_id)
            if transport is None:
                return False
            data = encode_cancel(CancelEnvelope(
                envelope_id=envelope_id, tenant=pending.envelope.tenant,
                attempt=pending.envelope.attempt))
            self.cancels_sent += 1
        # outside the lock: an in-process shard replies synchronously and
        # the reply path (_on_result) re-enters the router lock
        try:
            confirmed = bool(transport.send_cancel(data))
        except (TransportError, NotImplementedError):
            return False
        if confirmed:
            with self._lock:
                self.cancels_confirmed += 1
        return confirmed

    def _stamp_env(self, env: JobEnvelope, event: str, shard: str = "",
                   **detail) -> None:
        """Append a client-side hop to a *traced* envelope (no-op when the
        envelope carries no hops, i.e. tracing is off)."""
        if not env.hops:
            return
        slack = None
        if env.deadline_t is not None:
            slack = env.deadline_t - time.perf_counter()
        hop = make_hop(event, shard=shard, slack=slack, **detail)
        if hop[1] < env.hops[-1][1]:
            hop = (hop[0], env.hops[-1][1]) + hop[2:]
        env.hops = env.hops + (hop,)
        if self.trace_sink is not None:
            self.trace_sink.emit_hop(env.envelope_id, env.tenant, hop)

    def _route(self, pending: _Pending, is_requeue: bool) -> None:
        env = pending.envelope
        if env.deadline_t is not None:
            # re-derive the REMAINING budget at every (re-)encode: queueing
            # and failover time already spent must not extend the SLO on
            # the shard that finally runs the job.  May go negative — the
            # shard then sheds immediately and the DeadlineExceeded reply
            # resolves the future
            env.deadline_s = env.deadline_t - time.perf_counter()
        try:
            data = encode_job(env)     # before any pending registration:
        except Exception as e:         # an unencodable batch must not leak
            pending.future._set_exception(e)   # a forever-pending entry
            return
        while True:
            with self._lock:
                try:
                    shard_id = self._ring.route(env.routing_key)
                except LookupError:
                    self._pending.pop(env.envelope_id, None)
                    self._drained.notify_all()
                    break
                transport = self._transports[shard_id]
                pending.shard_id = shard_id
                self._pending[env.envelope_id] = pending
                self.envelopes_routed[shard_id] = \
                    self.envelopes_routed.get(shard_id, 0) + 1
                if is_requeue:
                    self.failover_requeues += 1
                else:
                    # locality is defined over *repeat* keys only (docs:
                    # "with a stable ring this is 1.0") — a key's first
                    # appearance has no prior shard to agree with and
                    # must not dilute the rate
                    last = self._last_shard_for_key.get(env.routing_key)
                    if last is not None:
                        self.locality_lookups += 1
                        if last == shard_id:
                            self.locality_hits += 1
                    self._last_shard_for_key[env.routing_key] = shard_id
                    self._last_shard_for_key.move_to_end(env.routing_key)
                    while len(self._last_shard_for_key) \
                            > _LOCALITY_KEYS_MAX:
                        self._last_shard_for_key.popitem(last=False)
            if env.hops:
                # tracing is on (the client seeded a SUBMITTED hop): stamp
                # the placement decision and re-encode so the hop log the
                # shard receives includes it
                self._stamp_env(env, ROUTED, shard=shard_id,
                                attempt=env.attempt, requeue=is_requeue)
                data = encode_job(env)
            try:
                transport.send_job(data)
                return
            except TransportError:
                # shard died between routing and send: declare it, which
                # also requeues anything else pending there, then retry
                # this envelope on the shrunken ring
                self.fail_shard(shard_id)
                with self._lock:
                    # retry ONLY while the pending entry still points at
                    # the dead shard.  Re-homed (a concurrent fail_shard
                    # requeued it) or gone entirely (that requeue already
                    # completed or failed the future) means another path
                    # owns this envelope's fate — dispatching it again
                    # would execute the job twice and re-resolve a future
                    # the caller may already have observed
                    cur = self._pending.get(env.envelope_id)
                    if cur is None or cur.shard_id != shard_id:
                        return
                continue
            except Exception as e:   # noqa: BLE001
                # any other send failure — AdmissionError backpressure
                # from an in-process shard, or a decode bug past the
                # encode: never leak a forever-pending entry.  Surface it
                # synchronously to the submitting caller (the documented
                # Session.submit contract for AdmissionError); a failover
                # requeue has no caller on the stack, so there it
                # resolves the future instead (raising out of
                # fail_shard's orphan loop would also abandon the
                # remaining orphans)
                with self._lock:
                    self._pending.pop(env.envelope_id, None)
                    self._drained.notify_all()
                if is_requeue:
                    pending.future._set_exception(e)
                    return
                raise
        pending.future._set_exception(
            NoShardsError("no live shards on the ring"))

    def _on_result(self, data: bytes) -> None:
        try:
            env = decode_result(data)
        except Exception:  # noqa: BLE001 — corrupted reply frame
            # the envelope id is unrecoverable, so no specific future can
            # be failed; count it rather than raise into the transport's
            # callback chain (which swallows exceptions, silently hanging
            # the tenant).  A remote transport's retry layer sits below
            # this; for LocalTransport corruption means a codec bug.
            with self._lock:
                self.reply_codec_errors += 1
            return
        with self._lock:
            pending = self._pending.get(env.envelope_id)
            if pending is not None \
                    and env.attempt < pending.envelope.attempt:
                return      # stale reply from a shard declared dead
            self._pending.pop(env.envelope_id, None)
            self._drained.notify_all()
        if pending is None:         # duplicate reply after a failover race
            return
        if env.ok:
            hops = tuple(getattr(env.report, "hops", ()) or ())
            if hops and self.trace_sink is not None:
                # the shard's reply carries the full reassembled trace
                # (client seed hops + shard lifecycle hops): keep it
                # queryable client-side without re-emitting to the log
                self.trace_sink.store(env.envelope_id, env.tenant, hops)
            pending.future._set_result(env.results, env.report)
        elif isinstance(env.error, CancelledError):
            # the shard honored a CancelEnvelope: resolve as *cancelled*
            # (result() raises CancelledError, cancelled() is True) rather
            # than as a job failure
            pending.future._set_cancelled()
        else:
            pending.future._set_exception(env.error)

    # -- introspection -----------------------------------------------------
    def pending_count(self, shard_id: Optional[str] = None) -> int:
        with self._lock:
            if shard_id is None:
                return len(self._pending)
            return sum(1 for p in self._pending.values()
                       if p.shard_id == shard_id)

    def locality_hit_rate(self) -> float:
        with self._lock:
            if not self.locality_lookups:
                return 0.0
            return self.locality_hits / self.locality_lookups
