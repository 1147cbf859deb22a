"""repro_torch.service — persistent, multi-tenant stratum execution service
(the port of ``repro.service``, its sharded fabric included).

Decouples agent planning from pipeline execution (paper §3): agents submit
:class:`~repro_torch.core.fusion.PipelineBatch`es through non-blocking
:class:`Session` handles; the service coalesces concurrent submissions from
different agents into super-batches, dedups shared work via cross-agent CSE
and a shared intermediate cache with per-tenant quota arbitration,
schedules priority bands by weighted fair queuing (with starvation aging
and cooperative preemption of running low-priority work) under a global
memory budget, and resolves :class:`PipelineFuture`s with per-tenant
telemetry.  Every executor runs on the service's one torch device
(``ServiceConfig.device``: the CUDA device unless ``"cpu"``).
:class:`ShardedStratum` (``service/fabric/``) runs N such services behind a
consistent-hash router, in this process or one worker process each.  See
``docs/ARCHITECTURE.md`` and ``docs/SCHEDULING.md``.

    with StratumService(memory_budget_bytes=4 << 30) as svc:
        s1, s2 = svc.session("agent-1"), svc.session("agent-2")
        f1 = s1.submit(batch_a)          # non-blocking: keep planning
        f2 = s2.submit(batch_b)          # coalesced with batch_a
        results, report = f1.result()
        print(svc.telemetry.report())
"""

from .coalesce import SuperBatch, coalesce, cross_agent_dedup
from .control import (ControlPolicy, ServiceController,
                      merge_control_snapshots)
from .observability import (JobTrace, ThroughputCollector, TraceSink,
                            merge_window_snapshots)
from .priority import DEFAULT_WEIGHTS, Priority
from .queue import AdmissionError, DeadlineExceeded, FairQueue, Job
from .server import JobReport, ServiceConfig, StratumService
from .session import PipelineFuture, Session
from .telemetry import ServiceTelemetry, TenantStats, merge_tenant_snapshots
from .fabric import ShardedStratum, StratumFabric

__all__ = [
    "AdmissionError", "ControlPolicy", "DEFAULT_WEIGHTS",
    "DeadlineExceeded", "FairQueue", "Job", "JobReport", "JobTrace",
    "PipelineFuture", "Priority", "ServiceConfig", "ServiceController",
    "ServiceTelemetry", "Session", "ShardedStratum", "StratumFabric",
    "StratumService", "SuperBatch", "TenantStats", "ThroughputCollector",
    "TraceSink", "coalesce", "cross_agent_dedup",
    "merge_control_snapshots", "merge_tenant_snapshots",
    "merge_window_snapshots",
]
