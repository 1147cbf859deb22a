"""The sharded execution fabric — N service shards behind one front door
(the port of ``repro.service.fabric.fabric``).

:class:`StratumFabric` (alias :data:`ShardedStratum`) scales the
multi-tenant execution service past one server: it runs ``n_shards``
independent :class:`~repro_torch.service.server.StratumService`
instances — each with its own fair queue, coalescer, memory gate and
intermediate cache — behind a :class:`~.router.ShardRouter` that
consistent-hashes the pipeline-signature space.  Identical sub-DAGs from
different agents hash to the same shard, so the single-server wins
(cross-agent CSE, shared-cache hits, cache-quota arbitration) stay
effective *per shard* while aggregate queue, compute and cache capacity
grow with the shard count.

Every submission crosses the serializable envelope boundary
(``envelope.py``) over a per-shard :class:`~.transport.Transport`; with
:class:`~.transport.LocalTransport` the shards share this process, but the
only thing that crosses the seam is bytes — the prerequisite for moving
shards out-of-process.

Every shard runs on the fabric's one torch device (``ServiceConfig.device``:
the CUDA device unless ``"cpu"``), resolved once here and written into the
shards' configs as a string; all of them issue their work on that device's
default stream, as the executors of one service do.

Lifecycle: ``add_shard`` grows the ring (≈K/N keys remap), ``drain_shard``
retires a shard gracefully (in-flight work finishes, new work re-routes),
and ``fail_shard`` models a crash — the dead shard's in-flight envelopes
are requeued onto ring successors, losing nothing (deterministic pipelines
make the resulting at-least-once execution safe).

    fabric = ShardedStratum(n_shards=4, memory_budget_bytes=2 << 30)
    session = fabric.session("agent-0")
    results, report = session.submit(batch).result()
    print(fabric.telemetry.report())
    fabric.stop()
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import replace
from typing import Optional

from ...kernels.common import resolve_device
from ..observability import SUBMITTED, TraceSink, make_hop
from ..priority import Priority
from ..server import ServiceConfig, StratumService
from ..session import PipelineFuture, Session
from .envelope import (JobEnvelope, next_envelope_id, routing_key_for,
                       ROUTING_POLICIES)
from .router import ShardRouter
from .telemetry import FabricTelemetry
from .transport import LocalTransport

_fabric_ids = itertools.count()


class StratumFabric:
    """N consistent-hash service shards behind a message boundary."""

    def __init__(self, n_shards: int = 2,
                 config: Optional[ServiceConfig] = None,
                 routing: str = "sources",
                 vnodes: int = 64,
                 autostart: bool = True,
                 **overrides):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if routing not in ROUTING_POLICIES:
            raise ValueError(f"unknown routing policy {routing!r}")
        if config is None:
            config = ServiceConfig(**overrides)
        elif overrides:
            raise ValueError("pass either config or keyword overrides")
        # resolved before any shard is built: no CUDA and no device raises
        # here, as StratumService() does
        self.device = resolve_device(config.device)
        self.config = replace(config, device=str(self.device))
        self.routing = routing
        self._client_id = f"fabric{next(_fabric_ids)}"
        self._lock = threading.Lock()
        self._shard_seq = itertools.count()
        self._shards: dict[str, StratumService] = {}     # live shards
        self.router = ShardRouter(vnodes=vnodes)
        self.telemetry = FabricTelemetry(self.router, self._shards_snapshot)
        # client-side trace sink: seeds every traced envelope's hop log and
        # keeps the reassembled traces the shards send back
        self.traces = TraceSink(
            trace_dir=config.trace_dir,
            component=f"client-{self._client_id}",
            enabled=config.trace)
        self.router.trace_sink = self.traces
        self._stopped = False
        for _ in range(n_shards):
            self.add_shard(autostart=autostart)

    # -- membership --------------------------------------------------------
    def add_shard(self, autostart: bool = True) -> str:
        """Bring up one more shard and join it to the ring.  Only ~K/N of
        the routing-key space remaps onto it (see ``ring.py``), so existing
        shards keep their cache/CSE locality."""
        with self._lock:
            shard_id = f"shard-{next(self._shard_seq)}"
            svc = StratumService(
                config=replace(self.config, shard_id=shard_id),
                autostart=autostart)
            self._shards[shard_id] = svc
        self.router.add_shard(shard_id, LocalTransport(svc, shard_id))
        return shard_id

    def start(self) -> "StratumFabric":
        """Start every shard created with ``autostart=False``."""
        with self._lock:
            shards = list(self._shards.values())
        for svc in shards:
            svc.start()
        return self

    def drain_shard(self, shard_id: str, timeout: float = 30.0) -> None:
        """Gracefully retire a shard: new work re-routes immediately,
        in-flight work completes where it is, then the shard stops."""
        self.router.drain_shard(shard_id, timeout=timeout)
        with self._lock:
            svc = self._shards.pop(shard_id)
        self.telemetry.retire(shard_id, svc)
        svc.stop()

    def fail_shard(self, shard_id: str) -> int:
        """Declare a shard dead (crash model).  The router silences the
        transport and requeues its pending envelopes onto ring successors;
        returns how many were requeued."""
        requeued = self.router.fail_shard(shard_id)
        with self._lock:
            svc = self._shards.pop(shard_id, None)
        if svc is not None:
            self.telemetry.retire(shard_id, svc)
            # best-effort teardown of the crashed host's threads; its
            # transport is already silenced so no replies can leak out
            svc.stop(drain=False)
        return requeued

    def shard_ids(self) -> list[str]:
        return self.router.shard_ids()

    def _shards_snapshot(self) -> dict:
        with self._lock:
            return dict(self._shards)

    # -- tenant API (Session-compatible backend) ---------------------------
    def session(self, tenant: str) -> Session:
        return Session(self, tenant)

    def submit(self, tenant: str, batch,
               priority: Priority = Priority.BATCH,
               affinity: Optional[str] = None,
               deadline_s: Optional[float] = None,
               tags=()) -> PipelineFuture:
        """Wrap ``batch`` in a :class:`JobEnvelope` and route it.  The
        routing key is derived from the batch's signature space unless
        ``affinity`` overrides it (pinning related submissions together).
        ``deadline_s``/``tags`` cross the wire with the envelope; the
        owning shard schedules EDF within the band, sheds expired work
        (the future then raises DeadlineExceeded) and echoes deadline
        attainment in the FabricJobReport."""
        if self._stopped:
            raise RuntimeError("fabric is stopped")
        key = affinity if affinity is not None \
            else routing_key_for(batch, self.routing)
        env = JobEnvelope(
            envelope_id=next_envelope_id(self._client_id),
            tenant=tenant, priority=int(Priority(priority)),
            routing_key=key, batch=batch,
            deadline_s=deadline_s,
            deadline_t=(None if deadline_s is None
                        else time.perf_counter() + deadline_s),
            tags=tuple(tags))
        if self.traces.enabled:
            # a non-empty hop log marks the envelope as traced everywhere
            # downstream (router stamps, wire codec, shard-side TraceSink)
            hop = make_hop(SUBMITTED, slack=deadline_s, tenant=tenant,
                           priority=Priority(priority).name)
            env.hops = (hop,)
            self.traces.emit_hop(env.envelope_id, tenant, hop)
        return self.router.submit(env)

    # -- lifecycle ---------------------------------------------------------
    def stop(self) -> None:
        if self._stopped:
            return
        self._stopped = True
        with self._lock:
            # keep the dict populated: telemetry stays readable after stop
            shards = list(self._shards.values())
        for svc in shards:
            svc.stop()
        self.traces.close()

    def __enter__(self) -> "StratumFabric":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


#: Docs-friendly name for the sharded front door.
ShardedStratum = StratumFabric
