"""Per-tenant service telemetry.

The service multiplexes many agents over one runtime, so aggregate numbers
(`RunReport`) are not attributable on their own.  This module keeps a
thread-safe per-tenant ledger fed from four places:

* submission / dispatch (queue wait, split by priority class),
* the coalescer (ops shared cross-agent),
* the preemption path (cooperative yields per tenant),
* post-run attribution: each job's post-optimization reachable signature
  set joined against ``RunReport.sig_source`` gives exact per-tenant cache
  hits, salvage restores and backend mix even for merged super-batches.

When constructed with the shared :class:`IntermediateCache`, the global
snapshot additionally surfaces the cache's cross-tenant arbitration state:
bytes charged per tenant, per-tenant evictions, and cross-tenant hits
(tenant A reusing an intermediate materialized and charged to tenant B).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from .observability import merge_window_snapshots
from .priority import Priority


@dataclass
class TenantStats:
    jobs_submitted: int = 0
    jobs_completed: int = 0
    jobs_failed: int = 0
    jobs_cancelled: int = 0
    queue_wait_s: float = 0.0
    queue_wait_max_s: float = 0.0
    ops_shared_cross_agent: int = 0
    cache_hits: int = 0
    ops_salvaged: int = 0
    preemptions: int = 0
    ops_attributed: int = 0
    # deadline attainment: jobs that carried a deadline_s, how many
    # completed within it, and how many were shed after it expired
    deadline_jobs: int = 0
    deadline_met: int = 0
    deadline_shed: int = 0
    per_backend: dict = field(default_factory=dict)
    submitted_by_priority: dict = field(default_factory=dict)
    queue_wait_by_priority: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "jobs_submitted": self.jobs_submitted,
            "jobs_completed": self.jobs_completed,
            "jobs_failed": self.jobs_failed,
            "jobs_cancelled": self.jobs_cancelled,
            "queue_wait_s": round(self.queue_wait_s, 6),
            "queue_wait_max_s": round(self.queue_wait_max_s, 6),
            "ops_shared_cross_agent": self.ops_shared_cross_agent,
            "cache_hits": self.cache_hits,
            "ops_salvaged": self.ops_salvaged,
            "preemptions": self.preemptions,
            "ops_attributed": self.ops_attributed,
            "deadline_jobs": self.deadline_jobs,
            "deadline_met": self.deadline_met,
            "deadline_shed": self.deadline_shed,
            "per_backend": dict(self.per_backend),
            "submitted_by_priority": {k.name: v for k, v
                                      in self.submitted_by_priority.items()},
            "queue_wait_by_priority": {
                k.name: round(v, 6)
                for k, v in self.queue_wait_by_priority.items()},
        }


def merge_tenant_snapshots(snapshots) -> dict:
    """Merge per-tenant ``ServiceTelemetry.snapshot()`` dicts from several
    shards into one fabric-wide view: counters and waits sum, ``*_max_*``
    fields take the max, nested per-key dicts (backends, priorities) sum
    per key, and ``"windows"`` blocks (windowed collector snapshots, see
    ``observability.windows``) merge via :func:`merge_window_snapshots`.
    Used by the sharded fabric's telemetry aggregation."""
    merged: dict[str, dict] = {}
    for snap in snapshots:
        for tenant, stats in snap.items():
            if tenant not in merged:
                merged[tenant] = {k: (dict(v) if isinstance(v, dict) else v)
                                  for k, v in stats.items()}
                continue
            out = merged[tenant]
            for k, v in stats.items():
                if k == "windows":
                    # percentile/attainment blocks don't sum per key —
                    # recombine them from their capped latency samples
                    out[k] = merge_window_snapshots([out.get(k), v])
                elif isinstance(v, dict):
                    tgt = out.setdefault(k, {})
                    for kk, vv in v.items():
                        tgt[kk] = tgt.get(kk, 0) + vv
                elif "max" in k:
                    out[k] = max(out.get(k, 0), v)
                else:
                    out[k] = out.get(k, 0) + v
    return merged


class ServiceTelemetry:
    def __init__(self, cache=None, plan_cache=None, windows=None) -> None:
        self._lock = threading.Lock()
        self._tenants: dict[str, TenantStats] = {}   # guarded-by: _lock
        self._cache = cache            # shared IntermediateCache (optional)
        self._plan_cache = plan_cache  # shared PlanCache (optional)
        self._windows = windows        # ThroughputCollector (optional)
        # zero-arg callable returning the closed-loop controller's state
        # (set by the server when control is enabled); surfaced as the
        # global snapshot's "control" block
        self.control_provider = None
        self.ops_deduped_cross_agent = 0   # global executions saved
        self.super_batches = 0
        self.jobs_coalesced = 0
        self.preemptions = 0
        # pre-flight static analysis at admission (docs/ANALYSIS.md):
        # counts, per-rule tallies and cumulative analyzer wall time
        self.analysis_runs = 0
        self.analysis_rejected = 0
        self.analysis_warned = 0
        self.analysis_cached_verdicts = 0
        self.analysis_time_s = 0.0
        self.analysis_by_rule: dict = {}            # guarded-by: _lock

    def _t(self, tenant: str) -> TenantStats:  # guarded-by: caller
        return self._tenants.setdefault(tenant, TenantStats())

    # -- recording hooks ---------------------------------------------------
    def record_submit(self, tenant: str,
                      priority: Priority = Priority.BATCH) -> None:
        with self._lock:
            t = self._t(tenant)
            t.jobs_submitted += 1
            t.submitted_by_priority[priority] = \
                t.submitted_by_priority.get(priority, 0) + 1
        if self._windows is not None:
            self._windows.record_submit()

    def record_dispatch(self, tenant: str, wait_s: float,
                        priority: Priority = Priority.BATCH,
                        depth: int = 0) -> None:
        with self._lock:
            t = self._t(tenant)
            t.queue_wait_s += wait_s
            t.queue_wait_max_s = max(t.queue_wait_max_s, wait_s)
            t.queue_wait_by_priority[priority] = \
                t.queue_wait_by_priority.get(priority, 0.0) + wait_s
        if self._windows is not None:
            self._windows.record_dispatch(wait_s, queue_depth=depth)

    def record_super_batch(self, n_jobs: int, deduped: int,
                           shared_per_tenant: dict) -> None:
        with self._lock:
            self.super_batches += 1
            self.jobs_coalesced += n_jobs
            self.ops_deduped_cross_agent += deduped
            for tenant, n in shared_per_tenant.items():
                self._t(tenant).ops_shared_cross_agent += n

    def record_preemption(self, tenant: str) -> None:
        """One job of ``tenant`` yielded at a wave boundary and requeued."""
        with self._lock:
            self.preemptions += 1
            self._t(tenant).preemptions += 1
        if self._windows is not None:
            self._windows.record_preemption()

    def record_job_done(self, tenant: str, job_sigs: set,
                        sig_source: dict) -> None:
        """Attribute run work to a finished job via its reachable sigs."""
        with self._lock:
            t = self._t(tenant)
            t.jobs_completed += 1
            for sig in job_sigs:
                src = sig_source.get(sig)
                if src is None:
                    continue
                t.ops_attributed += 1
                if src == "cache":
                    t.cache_hits += 1
                elif src == "salvage":
                    t.ops_salvaged += 1
                else:
                    t.per_backend[src] = t.per_backend.get(src, 0) + 1
        if self._windows is not None:
            self._windows.record_completion()

    def record_deadline_outcome(self, tenant: str, met: bool,
                                band=None) -> None:
        """A deadline-carrying job completed; ``met`` = within its SLO.
        ``band`` (the job's native priority band) feeds the windowed
        per-band attainment the WFQ weight rebalancer reads."""
        with self._lock:
            t = self._t(tenant)
            t.deadline_jobs += 1
            if met:
                t.deadline_met += 1
        if self._windows is not None:
            self._windows.record_deadline_outcome(met, band=band)

    def record_deadline_shed(self, tenant: str, band=None) -> None:
        """A job expired while queued and was shed (DeadlineExceeded)."""
        with self._lock:
            t = self._t(tenant)
            t.deadline_jobs += 1
            t.deadline_shed += 1
        if self._windows is not None:
            self._windows.record_shed()
            self._windows.record_deadline_outcome(False, band=band)

    def record_analysis(self, tenant: str, *, rejected: bool,
                        n_warnings: int = 0, rules=(),
                        time_s: float = 0.0, cached: bool = False) -> None:
        """One admission-time analysis verdict.  ``rules`` are the rule
        names of the findings (errors + warnings) for the per-rule tally;
        ``cached`` marks a verdict served from the structural-signature
        verdict cache (no analyzer work done)."""
        with self._lock:
            self.analysis_runs += 1
            if rejected:
                self.analysis_rejected += 1
            if n_warnings:
                self.analysis_warned += 1
            if cached:
                self.analysis_cached_verdicts += 1
            self.analysis_time_s += time_s
            for rule in rules:
                self.analysis_by_rule[rule] = \
                    self.analysis_by_rule.get(rule, 0) + 1

    def record_job_failed(self, tenant: str) -> None:
        with self._lock:
            self._t(tenant).jobs_failed += 1

    def record_job_cancelled(self, tenant: str) -> None:
        with self._lock:
            self._t(tenant).jobs_cancelled += 1

    # -- reporting ---------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {tenant: stats.as_dict()
                    for tenant, stats in self._tenants.items()}

    def global_snapshot(self) -> dict:
        with self._lock:
            d_jobs = sum(t.deadline_jobs for t in self._tenants.values())
            d_met = sum(t.deadline_met for t in self._tenants.values())
            d_shed = sum(t.deadline_shed for t in self._tenants.values())
            out = {
                "super_batches": self.super_batches,
                "jobs_coalesced": self.jobs_coalesced,
                "ops_deduped_cross_agent": self.ops_deduped_cross_agent,
                "preemptions": self.preemptions,
                # deadline attainment across every tenant of this shard
                "deadline": {
                    "jobs": d_jobs,
                    "met": d_met,
                    "shed": d_shed,
                    "attainment": (d_met / d_jobs) if d_jobs else 1.0,
                },
            }
            if self.analysis_runs:
                # admission-time static analysis (docs/ANALYSIS.md)
                out["analysis"] = {
                    "analyzed": self.analysis_runs,
                    "rejected": self.analysis_rejected,
                    "warned": self.analysis_warned,
                    "cached_verdicts": self.analysis_cached_verdicts,
                    "time_s": round(self.analysis_time_s, 6),
                    "by_rule": dict(self.analysis_by_rule),
                }
        if self._cache is not None:
            arb = self._cache.arbitration_snapshot()   # copied under lock
            out["cache_cross_tenant_hits"] = arb["cross_tenant_hits"]
            out["cache_bytes_by_tenant"] = {
                str(k): v for k, v in arb["bytes_by_tenant"].items()}
            out["cache_evictions_by_tenant"] = {
                str(k): v for k, v in arb["evictions_by_tenant"].items()}
        if self._plan_cache is not None:
            # compiled-plan reuse across the shard's tenants: hit rate is
            # the fraction of segment executions that skipped tracing
            out["plan_cache"] = self._plan_cache.snapshot()
        if self._windows is not None:
            # windowed throughput/attainment/latency (observability/)
            out["windows"] = self._windows.snapshot()
        if self.control_provider is not None:
            # closed-loop controller state: current knob values + recent
            # actuations (docs/SCHEDULING.md §5)
            try:
                ctl = self.control_provider()
            except Exception:  # noqa: BLE001 — control must not break obs
                ctl = None
            if ctl:
                out["control"] = ctl
        return out

    def report(self) -> str:
        g = self.global_snapshot()
        lines = [
            f"super-batches: {g['super_batches']} "
            f"(jobs coalesced: {g['jobs_coalesced']}, "
            f"cross-agent ops deduped: {g['ops_deduped_cross_agent']}, "
            f"preemptions: {g['preemptions']})"
        ]
        if g["deadline"]["jobs"]:
            d = g["deadline"]
            lines.append(
                f"deadlines: {d['met']}/{d['jobs']} met "
                f"(attainment {d['attainment']:.2f}, shed {d['shed']})")
        if "cache_cross_tenant_hits" in g:
            lines.append(
                f"shared cache: cross-tenant hits="
                f"{g['cache_cross_tenant_hits']} "
                f"bytes_by_tenant={g['cache_bytes_by_tenant']}")
        if "plan_cache" in g:
            pc = g["plan_cache"]
            lines.append(
                f"plan cache: {pc['entries']} compiled segment(s) "
                f"hit_rate={pc['hit_rate']:.2f} "
                f"(compiles {pc['compiles']}, evictions {pc['evictions']})")
            if pc.get("async"):
                lines.append(
                    f"compile lane: async={pc.get('async_compiles', 0)} "
                    f"inflight={pc.get('inflight', 0)} "
                    f"speculative_hits={pc.get('speculative_hits', 0)} "
                    f"dropped={pc.get('speculative_dropped', 0)} "
                    f"failures={pc.get('async_failures', 0)} "
                    f"time={pc.get('compile_time_s', 0.0):.2f}s")
        for tenant, s in sorted(self.snapshot().items()):
            lines.append(
                f"  {tenant}: jobs={s['jobs_completed']}/"
                f"{s['jobs_submitted']} "
                f"wait={s['queue_wait_s']:.3f}s "
                f"shared_ops={s['ops_shared_cross_agent']} "
                f"cache_hits={s['cache_hits']} "
                f"salvaged={s['ops_salvaged']} "
                f"preempted={s['preemptions']} "
                f"backends={s['per_backend']}")
        return "\n".join(lines)
