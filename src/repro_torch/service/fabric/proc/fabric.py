"""The out-of-process sharded fabric — process-per-shard, same front door
(the port of ``repro.service.fabric.proc.fabric``).

:class:`ProcStratumFabric` subclasses the in-process
:class:`~repro_torch.service.fabric.fabric.StratumFabric` and changes exactly
one thing about each shard: it lives in its own worker process, reached
through a :class:`~.transport.ProcTransport` instead of a
:class:`~repro_torch.service.fabric.transport.LocalTransport`.  Everything
above the transport — the router, the envelope codec, failover requeue,
shard-aware cancellation, telemetry aggregation, ``Session`` — is
inherited unchanged, which is the point of the serializable submission
boundary the fabric was built on.

What the subclass adds:

* ``add_shard`` spawns a worker via the :class:`WorkerSupervisor` and
  registers a :class:`_ShardProxy` (heartbeat-fed ``StratumService``
  stand-in) where the base class would register a local service;
* worker failures detected by the supervisor (crash, hang, socket loss)
  are wired straight into the inherited ``fail_shard`` — the same requeue
  machinery that handles a simulated in-process crash handles a real
  ``kill -9``;
* ``scale_down`` drains a shard *warm*: the departing worker exports its
  hottest cache entries (existing spill format) and the supervisor ships
  them to the shard's ring successor before the process exits;
* optional elastic autoscaling (:class:`~.autoscale.Autoscaler`) between
  ``autoscale=(min, max)`` bounds.

    fabric = ProcStratumFabric(n_shards=4, autoscale=(1, 8))
    results, report = fabric.session("agent-0").submit(batch).result()
    fabric.stop()
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional, Tuple

from ...server import ServiceConfig
from ..fabric import StratumFabric
from ..telemetry import FabricTelemetry
from .autoscale import AutoscalePolicy, Autoscaler
from .supervisor import ProcConfig, WorkerSupervisor


class ProcStratumFabric(StratumFabric):
    """N worker processes behind the same ring, router and Session API."""

    def __init__(self, n_shards: int = 2,
                 config: Optional[ServiceConfig] = None,
                 routing: str = "sources",
                 vnodes: int = 64,
                 autostart: bool = True,
                 autoscale: Optional[Tuple[int, int]] = None,
                 proc: Optional[ProcConfig] = None,
                 **overrides):
        self.proc_config = proc or ProcConfig()
        self.supervisor = WorkerSupervisor(self.proc_config,
                                           on_failure=self._on_worker_failure)
        self.autoscaler: Optional[Autoscaler] = None
        policy: Optional[AutoscalePolicy] = None
        if autoscale is not None:
            lo, hi = autoscale
            policy = AutoscalePolicy(min_shards=int(lo), max_shards=int(hi))
            n_shards = min(max(n_shards, policy.min_shards),
                           policy.max_shards)
        # base __init__ resolves the device (raising before any spawn when
        # there is no card and no device="cpu") and drives our add_shard
        # override n_shards times, so the supervisor must exist before it
        # runs; a failure there reaps the workers already spawned
        try:
            super().__init__(n_shards=n_shards, config=config,
                             routing=routing, vnodes=vnodes,
                             autostart=autostart, **overrides)
        except BaseException:
            self.supervisor.shutdown()
            raise
        # same aggregation, plus the proc-only extras (worker pids,
        # hand-off and autoscale counters) merged into global_snapshot()
        self.telemetry = FabricTelemetry(self.router, self._shards_snapshot,
                                         extra=self._proc_extras)
        if policy is not None:
            self.autoscaler = Autoscaler(self, policy).start()

    # -- membership ----------------------------------------------------------
    def add_shard(self, shard_id: Optional[str] = None,
                  autostart: bool = True) -> str:
        """Spawn one worker process and join its shard to the ring.
        ``autostart`` is accepted for base-class compatibility; a worker
        always starts its service on boot."""
        del autostart
        with self._lock:
            if shard_id is None:
                shard_id = f"shard-{next(self._shard_seq)}"
        proxy = self.supervisor.spawn(
            shard_id, replace(self.config, shard_id=shard_id))
        with self._lock:
            self._shards[shard_id] = proxy
        self.router.add_shard(shard_id, proxy._handle.transport)
        return shard_id

    def start(self) -> "ProcStratumFabric":
        return self                 # workers autostart; nothing to do

    def shards(self) -> dict:
        """Copied snapshot of live shard proxies (autoscaler sensor)."""
        return self._shards_snapshot()

    def newest_shard(self) -> Optional[str]:
        """Most recently added live shard — the scale-down victim (its
        departure remaps the fewest long-lived keys)."""
        with self._lock:
            if len(self._shards) < 2:
                return None
            return next(reversed(self._shards))

    # -- elastic scale-down with warm hand-off -------------------------------
    def scale_down(self, shard_id: str, handoff: bool = True,
                   timeout: float = 30.0) -> None:
        """Retire ``shard_id`` gracefully, first shipping its hottest
        cache entries to its ring successor (existing spill format), so
        signatures that remap there start warm instead of recomputing."""
        if handoff:
            successor = self.router.successor_of(shard_id)
            if successor is not None:
                entries = self.supervisor.request_handoff(shard_id)
                if entries:
                    self.supervisor.deliver_handoff(successor, entries)
        self.drain_shard(shard_id, timeout=timeout)

    # -- supervisor events ----------------------------------------------------
    def _on_worker_failure(self, shard_id: str, reason: str) -> None:
        """A worker crashed or hung (supervisor health check): route it
        into the inherited failover path — requeue its pending envelopes
        onto ring successors.  Zero jobs are lost; at-least-once re-runs
        are safe because pipelines are deterministic, signature-keyed
        DAGs."""
        del reason
        if self._stopped:
            return
        self.fail_shard(shard_id)

    # -- lifecycle -------------------------------------------------------------
    def stop(self) -> None:
        if self._stopped:
            return
        if self.autoscaler is not None:
            self.autoscaler.stop()
        super().stop()              # graceful_stop per live worker
        self.supervisor.shutdown()

    # -- telemetry extras ------------------------------------------------------
    def _proc_extras(self) -> dict:
        extras = {
            "proc": {
                "workers": self.supervisor.live_workers(),
                "spawns": self.supervisor.spawns,
                "worker_failures": len(self.supervisor.failures),
                "handoff_entries_shipped":
                    self.supervisor.handoff_entries_shipped,
            }
        }
        if self.autoscaler is not None:
            extras["proc"]["autoscale"] = self.autoscaler.stats()
        return extras
