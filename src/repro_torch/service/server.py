"""The stratum execution service — a persistent, multi-tenant runtime (the
port of ``repro.service.server``: the same queue, coalescer, gates and
isolation; every executor's runtime on the service's one torch device).

Decouples agent *planning* from pipeline *execution* (paper §3): agents
hold :class:`~repro_torch.service.session.Session` handles and submit batches
without blocking; the service side runs

    submit → admission control → priority-stratified fair queue → coalescer
           → optimizer (cross-agent CSE) → memory gate → Runtime
           → result demux → futures + per-tenant telemetry

Key properties:

* **priority-aware fair scheduling** — jobs carry a
  :class:`~repro_torch.service.priority.Priority`; the queue serves bands by
  weighted fair queuing (INTERACTIVE ≫ BATCH ≫ SCAVENGER by default) with
  round-robin and a per-tenant cap inside each band, and ages long-waiting
  jobs upward so nothing starves (see ``docs/SCHEDULING.md``);
* **cooperative preemption** — a running low-priority super-batch polls the
  queue at wave boundaries and yields when more urgent work is waiting: its
  jobs are requeued at the front of their band carrying every completed
  intermediate (*salvage*), so the re-run redoes no finished work.  A job
  yields at most ``max_preemptions_per_job`` times, then runs to completion;
* **deadline-aware scheduling** — jobs may carry ``deadline_s``: inside the
  WFQ-chosen band, earliest-deadline-first breaks ties, jobs whose slack
  fell below ``deadline_tight_slack_s`` dispatch alone (never coalesced
  into a large super-batch), and jobs already past their deadline are shed
  with :class:`~repro_torch.service.queue.DeadlineExceeded`; attainment is
  tracked per tenant in telemetry;
* **cross-agent work sharing** — jobs gathered in one round are merged into
  a super-batch before optimization, so CSE dedups identical sub-DAGs
  emitted by *different* agents, and all tenants share one thread-safe
  :class:`IntermediateCache` with per-tenant charge accounting and quota
  arbitration (an over-quota tenant's entries are evicted first);
* **global memory budget** — a super-batch only starts executing once its
  planned peak memory fits under the service budget alongside the other
  in-flight super-batches;
* **failure isolation** — an :class:`ExecutionError` fails only the
  coalesced jobs whose DAG contains the failing op; innocent-bystander jobs
  from the same super-batch are re-executed without the poisoned peer.

The dispatcher, the executors (each with its own :class:`Runtime` and its
inter-op pool) and the plan cache's compile worker all issue their device
work on the device's one default stream, so a tensor one thread made (a
cache entry another tenant reads, a preempted run's salvage that a resume
replays) is safe to read on another without events.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional, Sequence

from ..core.analysis import (AnalysisError, AnalysisReport, analyze,
                             validate_wiring)
from ..core.api import ALL_FEATURES, Stratum
from ..core.backends import make_backends
from ..core.cache import IntermediateCache
from ..core.fusion import PipelineBatch
from ..core.plan_cache import PlanCache
from ..core.runtime import ExecutionError, ExecutionPreempted, Runtime
from ..kernels.common import resolve_device
from .coalesce import SuperBatch, coalesce, cross_agent_dedup, reachable_sigs
from .control import ControlPolicy, ServiceController
from .observability import (ANALYZED, CANCELLED, COALESCED, COMPLETED,
                            DISPATCHED, FAILED, PREEMPTED, SHED, SUBMITTED,
                            ThroughputCollector, TraceSink)
from .priority import Priority
from .queue import AdmissionError, FairQueue, Job
from .session import PipelineFuture, Session
from .telemetry import ServiceTelemetry


@dataclass
class ServiceConfig:
    memory_budget_bytes: int = 8 << 30
    # the service's torch device: None = the CUDA device (raising when
    # there is none); "cpu" runs the torch tier on the CPU
    device: Optional[str] = None
    cache_fraction: float = 0.10
    spill_dir: Optional[str] = None
    platform: str = ""
    enable: Sequence[str] = ALL_FEATURES
    hardware_threads: int = 0
    jit_cache_dir: Optional[str] = None
    # admission control
    max_queued_total: int = 1024
    max_queued_per_tenant: int = 256
    # pre-flight static analysis at admission (docs/ANALYSIS.md): when on,
    # every submit() runs the wiring/shape/lint analyzer and statically
    # invalid pipelines raise AnalysisError BEFORE taking a queue slot.
    # Per-submit SubmitOptions(verify=...) overrides this default either
    # way.  Clean verdicts are cached by structural signature, so an
    # agent's refinement stream pays the analyzer once per DAG shape.
    admission_analysis: bool = False
    # coalescing / fairness
    coalesce_window_s: float = 0.02
    coalesce_max_jobs: int = 16
    max_jobs_per_tenant_per_round: int = 2
    # priority scheduling (docs/SCHEDULING.md)
    priority_aware: bool = True          # False → priority-blind round-robin
    priority_weights: Optional[dict] = None   # Priority → WFQ weight
    aging_s: Optional[float] = 5.0       # starvation aging; None disables
    preemption: bool = True              # cooperative wave-boundary yields
    # liveness: every dispatch completes ≥1 wave before it may yield again,
    # so even a generous cap cannot livelock a low-priority job — the cap
    # only bounds resume overhead (re-optimize + salvage replay per yield)
    max_preemptions_per_job: int = 8
    # deadline-aware scheduling (docs/SCHEDULING.md): EDF tie-break inside
    # priority bands, shedding of expired jobs (futures fail with
    # DeadlineExceeded), and tight-deadline jobs dispatched alone instead
    # of coalesced; False records deadlines but schedules blind
    deadline_aware: bool = True
    # slack below which a deadline job refuses coalescing and runs alone
    deadline_tight_slack_s: float = 0.25
    # cap a compiled segment's summed est_time so a jitted program (which
    # has no internal yield points) can delay an interactive/deadline
    # preempt by at most one bounded slice; None = unbounded segments
    segment_time_budget_s: Optional[float] = None
    # shared-cache cross-tenant arbitration
    cache_arbitration: str = "quota"     # "quota" | "lru"
    cache_tenant_quota_fraction: float = 0.5
    # compiled plan-segment backends: torch-homogeneous segments execute as
    # one compiled program, cached per shard by structural signature — so
    # the thousands of structurally identical DAGs an agentic search
    # emits compile once; False → per-op dispatch only (bench baseline)
    compiled_segments: bool = True
    plan_cache_entries: int = 256
    # compiled-segment "next gear" (docs/ARCHITECTURE.md §7), off by
    # default: compile_async moves trace+jit onto a bounded background
    # thread (first touch of a new structural signature dispatches per-op
    # instead of blocking); batch_variants traces homogeneous
    # hyperparameter-variant groups as ONE vmapped solve; a positive
    # speculative_depth sizes the low-priority warm-up lane that
    # Session.precompile feeds with predicted-next plans
    compile_async: bool = False
    batch_variants: bool = False
    speculative_depth: int = 0
    # concurrency
    n_executors: int = 2
    # identity when the service runs as one shard of a sharded fabric
    # (service/fabric/); "" standalone
    shard_id: str = ""
    # observability (docs/OBSERVABILITY.md): trace=True keeps per-job hop
    # logs in memory and returns them on every JobReport; trace_dir also
    # appends each hop to a per-process JSONL event log replayable with
    # `python -m repro_torch.service.observability.replay`
    trace: bool = False
    trace_dir: Optional[str] = None
    # windowed throughput/attainment collector (ring of fixed-width
    # windows, surfaced under telemetry global_snapshot()["windows"])
    window_s: float = 1.0
    n_windows: int = 32
    # closed-loop control (docs/SCHEDULING.md §5): a ControlPolicy enables
    # the feedback controller that retunes admission limits and WFQ
    # weights from the windowed collector; None (default) keeps every
    # knob at its configured constant — the dispatch loop then pays
    # exactly one None check per tick
    control: Optional[ControlPolicy] = None


@dataclass
class JobReport:
    """Per-job view of a (possibly merged) execution."""
    tenant: str
    job_id: int
    queue_wait_s: float
    coalesced_with: int          # other jobs in the same super-batch
    ops_shared_cross_agent: int  # this job's ops shared with another tenant
    cache_hits: int
    per_backend: dict
    stratum: object              # the super-batch StratumReport-ish payload
    run: object = None           # super-batch RunReport (convenience alias)
    priority: Priority = Priority.BATCH
    preemptions: int = 0         # times this job's super-batch yielded
    ops_salvaged: int = 0        # ops restored from preemption salvage
    deadline_s: object = None    # the job's SLO (None = no deadline)
    deadline_met: object = None  # None without a deadline, else bool
    tags: tuple = ()             # opaque caller tags, echoed back
    trace: tuple = ()            # lifecycle hop log (empty unless tracing)


class StratumService:
    """Persistent multi-tenant execution service over one optimizing
    runtime.  Thread-safe; one instance serves many concurrent agents."""

    def __init__(self, config: Optional[ServiceConfig] = None,
                 autostart: bool = True, **overrides):
        if config is None:
            config = ServiceConfig(**overrides)
        elif overrides:
            raise ValueError("pass either config or keyword overrides")
        self.config = config
        # resolved once, before anything is built: no CUDA and no device
        # raises here, as Stratum() does
        self.device = resolve_device(config.device)
        self.cache: Optional[IntermediateCache] = None
        if "cache" in config.enable:
            self.cache = IntermediateCache(
                budget_bytes=int(config.memory_budget_bytes
                                 * config.cache_fraction),
                spill_dir=config.spill_dir,
                arbitration=config.cache_arbitration,
                tenant_quota_fraction=config.cache_tenant_quota_fraction)
        # compiled-plan cache, one per shard: every tenant's structurally
        # identical plans share compiled segments, and signature-locality
        # routing on the fabric turns into compiled-plan locality
        self.plan_cache: Optional[PlanCache] = None
        if config.compiled_segments:
            self.plan_cache = PlanCache(
                capacity=config.plan_cache_entries,
                compile_async=config.compile_async,
                speculative_depth=config.speculative_depth)
        self._backends = make_backends(self.plan_cache,
                                       compiled=config.compiled_segments,
                                       batch_variants=config.batch_variants)
        # the optimizer: compile-only use of the existing session object,
        # sharing the service cache (Stratum(cache=...) injection)
        self._optimizer = Stratum(
            memory_budget_bytes=config.memory_budget_bytes,
            platform=config.platform,
            enable=config.enable,
            hardware_threads=config.hardware_threads,
            jit_cache_dir=config.jit_cache_dir,
            cache=self.cache,
            compiled_segments=config.compiled_segments,
            plan_cache=self.plan_cache,
            segment_time_budget_s=config.segment_time_budget_s,
            device=self.device)
        self.queue = FairQueue(
            max_queued_total=config.max_queued_total,
            max_queued_per_tenant=config.max_queued_per_tenant,
            weights=config.priority_weights,
            aging_s=config.aging_s,
            priority_aware=config.priority_aware,
            deadline_aware=config.deadline_aware)
        self.windows = ThroughputCollector(window_s=config.window_s,
                                           n_windows=config.n_windows)
        self.telemetry = ServiceTelemetry(cache=self.cache,
                                          plan_cache=self.plan_cache,
                                          windows=self.windows)
        # per-job lifecycle traces (no-op object when tracing is off)
        self.traces = TraceSink(
            trace_dir=config.trace_dir,
            component=f"shard-{config.shard_id}" if config.shard_id
            else "service",
            enabled=config.trace)
        self.queue.on_shed = self._on_deadline_shed
        # closed-loop controller (control/): retunes admission + WFQ
        # weights from the windowed collector; None when control is off
        self.controller: Optional[ServiceController] = None
        if config.control is not None:
            self.controller = ServiceController(
                config.control, queue=self.queue, windows=self.windows,
                trace_sink=self.traces, shard_id=config.shard_id)
            self.telemetry.control_provider = self.controller.snapshot
        # admission-analysis verdict cache: structural signatures of
        # batches that analyzed clean.  Only OK verdicts are cached —
        # rejections re-analyze so the error carries exact provenance.
        # Guarded by _verdict_lock (submit runs on many caller threads).
        self._verdict_ok: "OrderedDict" = OrderedDict()
        self._verdict_max = 512
        self._verdict_lock = threading.Lock()
        self._job_ids = itertools.count()
        self._running = False
        self._dispatcher: Optional[threading.Thread] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        self._slots = threading.Semaphore(config.n_executors)
        # mirrors the semaphore so preempt checks can ask "is any executor
        # idle?" without touching semaphore internals.  Unlocked READS are
        # fine (a stale value delays/spares one yield by one poll); writes
        # go through _adjust_free_slots — a bare `+=` is a non-atomic
        # read-modify-write and concurrent finishes would drift the counter
        # permanently, silently disabling preemption
        self._free_slots = config.n_executors
        self._free_slots_lock = threading.Lock()
        # global memory gate across concurrent super-batches
        self._mem_cond = threading.Condition()
        self._mem_inflight = 0          # guarded-by: _mem_cond
        # the largest planned in-flight sum the gate has admitted, to read
        # against the budget and the device's measured peak
        self.mem_inflight_peak = 0      # guarded-by: _mem_cond
        # in-flight job accounting for drain on stop()
        self._inflight_cond = threading.Condition()
        self._inflight_jobs = 0
        if autostart:
            self.start()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "StratumService":
        if self._running:
            return self
        self.queue.reopen()     # stop() closed admissions; accept again
        self._running = True
        self._pool = ThreadPoolExecutor(
            max_workers=self.config.n_executors,
            thread_name_prefix="stratum-exec")
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="stratum-dispatch", daemon=True)
        self._dispatcher.start()
        return self

    def stop(self, drain: bool = True) -> None:
        if drain and self._running:
            # only a live dispatcher can drain the queue; with autostart=False
            # and no start(), draining would spin forever
            with self._inflight_cond:
                while self.queue.pending() or self._inflight_jobs:
                    self._inflight_cond.wait(timeout=0.1)
        self._running = False
        self.queue.kick()
        if self._dispatcher is not None:
            self._dispatcher.join(timeout=10)
        for job in self.queue.close():
            job.future._set_exception(
                AdmissionError("service stopped before job ran"))
            self.telemetry.record_job_failed(job.tenant)
            if job.trace is not None:
                job.trace.stamp(FAILED, shard=self.shard_id,
                                reason="service stopped")
                self.traces.finish(job.trace)
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        if self.plan_cache is not None:
            # drop queued background compiles and join the compile worker
            # (bounded) — a proc-fabric worker must not be held open past
            # SIGTERM by an inflight trace+jit.  Idempotent; no-op when
            # compile_async is off.
            self.plan_cache.close()
        self.traces.close()

    def __enter__(self) -> "StratumService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- tenant API --------------------------------------------------------
    def session(self, tenant: str) -> Session:
        return Session(self, tenant)

    # -- shard introspection (used by the fabric's router/telemetry) -------
    @property
    def shard_id(self) -> str:
        return self.config.shard_id

    def queue_depth(self) -> int:
        """Jobs admitted but not yet dispatched."""
        return self.queue.pending()

    def inflight(self) -> int:
        """Jobs dispatched and currently executing."""
        with self._inflight_cond:
            return self._inflight_jobs

    def submit(self, tenant: str, batch: PipelineBatch,
               priority: Priority = Priority.BATCH,
               affinity: Optional[str] = None,
               deadline_s: Optional[float] = None,
               tags: Sequence[str] = (),
               trace_key: Optional[str] = None,
               trace_hops: Sequence[tuple] = (),
               verify: Optional[bool] = None) -> PipelineFuture:
        # ``affinity`` is a sharded-fabric routing hint; a standalone
        # service has exactly one place to run the job, so it is accepted
        # (keeping Session portable across backends) and ignored.
        # ``trace_key``/``trace_hops`` let a fabric transport continue a
        # trace begun client-side: the key is the envelope id and the hops
        # are the history the envelope carried over the wire
        del affinity
        priority = Priority(priority)
        job_id = next(self._job_ids)
        future = PipelineFuture(job_id, tenant, priority)
        trace = self.traces.begin(trace_key or f"j{job_id}", tenant,
                                  hops=trace_hops)

        def _cancel(jid: int) -> bool:
            ok = self.queue.cancel(jid)
            if ok:
                self.telemetry.record_job_cancelled(tenant)
                if trace is not None:
                    trace.stamp(CANCELLED, shard=self.shard_id)
                    self.traces.finish(trace)
            return ok

        future._cancel_hook = _cancel
        job = Job(id=job_id, tenant=tenant, batch=batch, future=future,
                  priority=priority, deadline_s=deadline_s,
                  tags=tuple(tags), trace=trace)
        if trace is not None and not trace_hops:
            # a seeded trace (fabric continuation) was already stamped
            # SUBMITTED client-side
            trace.stamp(SUBMITTED, shard=self.shard_id,
                        slack=self._slack(job), priority=priority.name)
        do_verify = (verify if verify is not None
                     else self.config.admission_analysis)
        if do_verify:
            try:
                self._admission_analysis(tenant, batch, trace)
            except AnalysisError:
                if trace is not None:
                    trace.stamp(FAILED, shard=self.shard_id,
                                reason="analysis")
                    self.traces.finish(trace)
                raise
        try:
            self.queue.push(job)           # may raise AdmissionError
        except AdmissionError:
            if trace is not None:
                trace.stamp(FAILED, shard=self.shard_id, reason="admission")
                self.traces.finish(trace)
            raise
        self.telemetry.record_submit(tenant, priority)
        return future

    # -- pre-flight static analysis (docs/ANALYSIS.md) ---------------------
    @staticmethod
    def _batch_structural_key(batch: PipelineBatch):
        return tuple(ref.op.structural_signature + f":{ref.index}"
                     for ref in batch.fused_sinks())

    def _admission_analysis(self, tenant: str, batch: PipelineBatch,
                            trace) -> None:
        """Run the pre-flight analyzer; raise AnalysisError on a statically
        invalid batch.  Clean verdicts are cached by structural signature
        (shape analysis depends on structure, not tunable values or seeds)
        so agent refinement streams pay the analyzer once per DAG shape."""
        try:
            skey = self._batch_structural_key(batch)
        except Exception:  # noqa: BLE001 — e.g. cyclic DAG; analyze below
            skey = None    # will produce the real structured finding
        if skey is not None:
            with self._verdict_lock:
                cached = skey in self._verdict_ok
                if cached:
                    self._verdict_ok.move_to_end(skey)
            if cached:
                self.telemetry.record_analysis(
                    tenant, rejected=False, cached=True)
                if trace is not None:
                    trace.stamp(ANALYZED, shard=self.shard_id, cached=True)
                return
        report = analyze(
            batch, platform=self.config.platform,
            memory_budget_bytes=self.config.memory_budget_bytes,
            lowering="lowering" in self.config.enable,
            feasibility=False, device=self.device)
        self.telemetry.record_analysis(
            tenant, rejected=not report.ok,
            n_warnings=len(report.warnings),
            rules=[f.rule for f in report.findings
                   if f.severity != "info"],
            time_s=report.analysis_time_s)
        if not report.ok:
            raise AnalysisError(report.errors)
        if skey is not None:
            with self._verdict_lock:
                self._verdict_ok[skey] = True
                self._verdict_ok.move_to_end(skey)
                while len(self._verdict_ok) > self._verdict_max:
                    self._verdict_ok.popitem(last=False)
        if trace is not None:
            trace.stamp(ANALYZED, shard=self.shard_id,
                        warnings=len(report.warnings),
                        analysis_ms=round(report.analysis_time_s * 1e3, 3))

    def analyze(self, batch: PipelineBatch, *,
                feasibility: bool = True) -> AnalysisReport:
        """Full static analysis of ``batch`` against this service's
        configuration — wiring, shape inference, lint and (by default)
        compile-feasibility classification.  Torch segments that probe clean
        are marked pre-verified on this service's execution backend, so
        their first real dispatch skips the execute-time eval_shape probe.
        Never executes or queues anything."""
        torch_be = self._backends.get("torch") if feasibility else None
        allowed = (("python", "torch")
                   if "selection" in self.config.enable else ("python",))
        return analyze(
            batch, platform=self.config.platform,
            memory_budget_bytes=self.config.memory_budget_bytes,
            lowering="lowering" in self.config.enable,
            feasibility=feasibility, allowed_backends=allowed,
            segment_time_budget_s=self.config.segment_time_budget_s,
            torch_backend=torch_be, device=self.device)

    def precompile(self, tenant: str, batch: PipelineBatch) -> dict:
        """Speculative warm-up: optimize+plan ``batch`` WITHOUT queueing
        or executing it, and enqueue its torch segments on the plan cache's
        low-priority compile lane, so a likely-next submission of the same
        structure finds its programs warm.  The planning pass runs inline
        on the caller's thread (it is pure optimizer work — no queue slot,
        no admission, no telemetry side effects beyond the plan-cache
        stats); the compiles run on the background executor.  Returns a
        status-count dict, ``{}`` when ``compile_async`` is off."""
        del tenant                       # hints are not tenant-accounted
        if self.plan_cache is None or self.plan_cache.executor is None:
            return {}
        torch_be = self._backends.get("torch")
        if torch_be is None:
            return {}
        counts: dict = {}
        _s, sel, p, _c, _rw, _n, _t = self._optimizer.compile_batch(batch)
        for seg in p.segments:
            if seg.kind != "torch":
                continue
            status = torch_be.precompile_segment(seg, sel, cache=self.cache,
                                                 device=self.device)
            counts[status] = counts.get(status, 0) + 1
        return counts

    @staticmethod
    def _slack(job: Job, now: Optional[float] = None) -> Optional[float]:
        """Remaining deadline budget for a hop stamp; None = no deadline."""
        if job.deadline_t is None:
            return None
        return job.deadline_t - (time.perf_counter() if now is None else now)

    def _on_deadline_shed(self, job: Job) -> None:
        """Queue hook: a deadline-expired job was shed (its future already
        failed with DeadlineExceeded)."""
        self.telemetry.record_deadline_shed(job.tenant,
                                            band=int(job.priority))
        self.telemetry.record_job_failed(job.tenant)
        if job.trace is not None:
            job.trace.stamp(SHED, shard=self.shard_id,
                            slack=self._slack(job))
            self.traces.finish(job.trace)

    # -- dispatch ----------------------------------------------------------
    def _dispatch_loop(self) -> None:
        cfg = self.config
        while self._running:
            # closed-loop control tick piggybacks the dispatch loop (no
            # extra thread); the loop wakes at least every ~0.2s even
            # idle, so the controller's tick_interval_s is honored.  With
            # control off this is the hot path's single None check
            if self.controller is not None:
                self.controller.maybe_tick()
            # bound in-flight super-batches so the fair queue, not the
            # executor pool's FIFO, decides ordering under load
            if not self._slots.acquire(timeout=0.1):
                continue
            self._adjust_free_slots(-1)
            tight = (cfg.deadline_tight_slack_s if cfg.deadline_aware
                     else None)
            jobs = self.queue.pop_round(
                max_jobs=cfg.coalesce_max_jobs,
                max_per_tenant=cfg.max_jobs_per_tenant_per_round,
                timeout=0.1, tight_slack_s=tight)
            if not jobs:
                self._adjust_free_slots(+1)
                self._slots.release()
                continue
            # coalescing window: briefly gather more concurrent submissions
            # from the SAME band — super-batches stay priority-homogeneous,
            # so a cheap interactive probe is never welded to a bulk sweep.
            # A tight-deadline job skips the window entirely: it was popped
            # alone and every waited millisecond is deadline slack spent
            now = time.perf_counter()
            if not (cfg.deadline_aware
                    and any(j.slack(now) <= cfg.deadline_tight_slack_s
                            for j in jobs)):
                deadline = now + cfg.coalesce_window_s
                while len(jobs) < cfg.coalesce_max_jobs:
                    left = deadline - time.perf_counter()
                    if left <= 0:
                        break
                    more = self.queue.pop_round(
                        max_jobs=cfg.coalesce_max_jobs - len(jobs),
                        max_per_tenant=cfg.max_jobs_per_tenant_per_round,
                        timeout=left, band=jobs[0].band,
                        tight_slack_s=tight)
                    if not more:
                        # nothing mergeable: the window timed out, or the
                        # band holds only tight-slack jobs the extension
                        # excludes — looping again would busy-spin on the
                        # queue lock until the window closes
                        break
                    jobs.extend(more)
            with self._inflight_cond:
                self._inflight_jobs += len(jobs)
            self._pool.submit(self._execute_guarded, jobs)

    def _adjust_free_slots(self, delta: int) -> None:
        with self._free_slots_lock:
            self._free_slots += delta

    def _execute_guarded(self, jobs: list) -> None:
        try:
            self._execute_jobs(jobs, allow_retry=True, is_retry=False)
        finally:
            self._adjust_free_slots(+1)
            self._slots.release()
            with self._inflight_cond:
                self._inflight_jobs -= len(jobs)
                self._inflight_cond.notify_all()

    # -- memory gate -------------------------------------------------------
    def _acquire_mem(self, need: int) -> None:
        with self._mem_cond:
            while (self._mem_inflight
                   and self._mem_inflight + need
                   > self.config.memory_budget_bytes):
                self._mem_cond.wait()
            self._mem_inflight += need
            self.mem_inflight_peak = max(self.mem_inflight_peak,
                                         self._mem_inflight)

    def _release_mem(self, need: int) -> None:
        with self._mem_cond:
            self._mem_inflight -= need
            self._mem_cond.notify_all()

    # -- execution ---------------------------------------------------------
    def _fail_jobs(self, jobs: Sequence[Job], exc: BaseException) -> None:
        for job in jobs:
            job.future._set_exception(exc)
            self.telemetry.record_job_failed(job.tenant)
            if job.trace is not None:
                job.trace.stamp(FAILED, shard=self.shard_id,
                                slack=self._slack(job),
                                error=type(exc).__name__)
                self.traces.finish(job.trace)

    def _preempt_check_for(self, live: Sequence[Job], band: int):
        """Install a wave-boundary yield hook — only for super-batches that
        are not already top-band and have preemption budget left."""
        cfg = self.config
        if (not cfg.preemption or not cfg.priority_aware
                or band <= int(Priority.INTERACTIVE)):
            return None
        if max(j.preemptions for j in live) >= cfg.max_preemptions_per_job:
            return None     # yielded enough; now run to completion
        # yield only when the urgent work cannot be placed on an idle
        # executor anyway — otherwise preemption would just waste progress
        return lambda: (self._free_slots <= 0
                        and self.queue.has_work_above(band))

    def _requeue_preempted(self, live: list, job_sigs: list,
                           preempted: ExecutionPreempted) -> None:
        for job, sigs in zip(live, job_sigs):
            job.preemptions += 1
            # each job carries exactly its own reachable completed
            # intermediates; re-coalescing merges them back losslessly
            job.salvage = {s: v for s, v in preempted.salvage.items()
                           if s in sigs}
            self.telemetry.record_preemption(job.tenant)
            if job.trace is not None:
                job.trace.stamp(PREEMPTED, shard=self.shard_id,
                                slack=self._slack(job),
                                salvaged=len(job.salvage))
        try:
            self.queue.requeue(live)
        except AdmissionError as e:     # service shutting down mid-yield
            self._fail_jobs(live, e)

    def _isolate_invalid(self, live: list, err: AnalysisError,
                         allow_retry: bool) -> None:
        """A coalesced super-batch failed compile-time static validation.
        Re-validate each job's own pipelines so only the offending jobs
        fail — each with its OWN findings, not the merged batch's — and
        innocent coalesced bystanders re-run without the poisoned peer."""
        if len(live) == 1:
            self._fail_jobs(live, err)
            return
        good = []
        for job in live:
            try:
                errs = [f for f in validate_wiring(job.batch.fused_sinks())
                        if f.severity == "error"]
            except Exception:  # noqa: BLE001 — unvalidatable == invalid
                errs = []
                self._fail_jobs([job], err)
                continue
            if errs:
                self._fail_jobs([job], AnalysisError(errs))
            else:
                good.append(job)
        if len(good) == len(live):
            # nothing attributable (the defect only exists merged) —
            # fall back to failing the whole batch with the merged error
            self._fail_jobs(live, err)
            return
        if good:
            if allow_retry:
                self._execute_jobs(good, allow_retry=False, is_retry=True)
            else:
                self._fail_jobs(good, err)

    def _execute_jobs(self, jobs: list, allow_retry: bool,
                      is_retry: bool = False) -> None:
        now = time.perf_counter()
        live = [j for j in jobs if j.future._mark_running()]
        if not live:
            return
        depth = self.queue.pending()
        for job in live:
            # measure queue wait once, at first dispatch — a failure-isolation
            # retry must not re-record it (the second measurement would
            # include the failed run's execution time)
            if job.dispatch_wait_s is None:
                job.dispatch_wait_s = now - job.submit_t
                self.telemetry.record_dispatch(job.tenant,
                                               job.dispatch_wait_s,
                                               job.priority, depth=depth)
            if job.trace is not None:
                slack = self._slack(job, now)
                if len(live) > 1:
                    job.trace.stamp(COALESCED, shard=self.shard_id,
                                    slack=slack, n_jobs=len(live))
                job.trace.stamp(DISPATCHED, shard=self.shard_id,
                                slack=slack,
                                wait_s=round(job.dispatch_wait_s or 0.0, 6),
                                retry=is_retry, resume=job.preemptions > 0)

        merged: SuperBatch = coalesce(live)
        try:
            (sinks, sel, plan, candidates, rw, ops_submitted,
             opt_time) = self._optimizer.compile_batch(merged.batch)
        except AnalysisError as e:
            # statically invalid pipeline in the merged batch: fail only
            # the offending jobs, re-run innocent coalesced bystanders
            # (mirrors the ExecutionError isolation below)
            self._isolate_invalid(live, e, allow_retry)
            return
        except Exception as e:  # noqa: BLE001 — propagate via futures
            self._fail_jobs(live, e)
            return

        # post-optimization per-job reachable sets: used for cross-agent
        # dedup accounting, failure isolation, cache charge attribution and
        # telemetry attribution
        job_sigs = [reachable_sigs(merged.job_sinks(sinks, j))
                    for j in range(len(live))]
        deduped, shared = cross_agent_dedup(job_sigs,
                                            [j.tenant for j in live])
        if not is_retry and not any(j.preemptions for j in live):
            # neither a failure-isolation retry nor a post-preemption
            # re-dispatch is a new super-batch for accounting purposes
            self.telemetry.record_super_batch(len(live), deduped, shared)

        # cache charge attribution: an op shared by several tenants is
        # charged to the first submitter in this round (deterministic);
        # the others' reuse shows up as cross-tenant hits instead
        sig_tenant: dict = {}
        for job, sigs in zip(live, job_sigs):
            for s in sigs:
                sig_tenant.setdefault(s, job.tenant)

        # salvage from a previous preemption of any of these jobs
        preloaded: dict = {}
        for job in live:
            preloaded.update(job.salvage)

        band = min(j.band for j in live)
        need = max(plan.est_peak_mem, 0)
        self._acquire_mem(need)
        try:
            rt = Runtime(cache=self.cache, cache_candidates=candidates,
                         parallel="parallel" in self.config.enable,
                         preloaded=preloaded,
                         preempt_check=self._preempt_check_for(live, band),
                         sig_tenant=sig_tenant,
                         backends=self._backends, device=self.device)
            results, run = rt.execute(sinks, plan, sel)
        except ExecutionPreempted as p:
            self._release_mem(need)
            self._requeue_preempted(live, job_sigs, p)
            return
        except ExecutionError as e:
            self._release_mem(need)
            bad_sig = e.op.signature
            bad = [j for j, sigs in zip(live, job_sigs) if bad_sig in sigs]
            good = [j for j in live if j not in bad]
            if not bad:          # can't attribute → fail the whole batch
                self._fail_jobs(live, e)
                return
            self._fail_jobs(bad, e)
            if good:
                if allow_retry:
                    # innocent bystanders: re-run without the poisoned peer
                    self._execute_jobs(good, allow_retry=False,
                                       is_retry=True)
                else:
                    self._fail_jobs(good, e)
            return
        except Exception as e:  # noqa: BLE001
            self._release_mem(need)
            self._fail_jobs(live, e)
            return
        self._release_mem(need)

        named = dict(zip(merged.batch.names, results))
        per_job = merged.split_results(named)
        for j, (job, job_results) in enumerate(zip(live, per_job)):
            hits = sum(1 for s in job_sigs[j]
                       if run.sig_source.get(s) == "cache")
            salvaged = sum(1 for s in job_sigs[j]
                           if run.sig_source.get(s) == "salvage")
            backends: dict = {}
            for s in job_sigs[j]:
                src = run.sig_source.get(s)
                if src and src not in ("cache", "salvage"):
                    backends[src] = backends.get(src, 0) + 1
            deadline_met = None
            if job.deadline_t is not None:
                deadline_met = time.perf_counter() <= job.deadline_t
                self.telemetry.record_deadline_outcome(
                    job.tenant, deadline_met, band=int(job.priority))
            trace_hops: tuple = ()
            if job.trace is not None:
                job.trace.stamp(
                    COMPLETED, shard=self.shard_id, slack=self._slack(job),
                    backends=dict(backends), cache_hits=hits,
                    salvaged=salvaged,
                    plan_cache_hits=getattr(run, "plan_cache_hits", 0),
                    plan_cache_misses=getattr(run, "plan_cache_misses", 0),
                    plan_cache_fallback_rounds=getattr(
                        run, "plan_cache_fallback_rounds", 0),
                    deadline_met=deadline_met)
                self.traces.finish(job.trace)
                trace_hops = job.trace.as_hops()
            report = JobReport(
                tenant=job.tenant, job_id=job.id,
                queue_wait_s=job.dispatch_wait_s or 0.0,
                coalesced_with=len(live) - 1,
                ops_shared_cross_agent=shared.get(job.tenant, 0),
                cache_hits=hits, per_backend=backends,
                stratum=rw, run=run,
                priority=job.priority, preemptions=job.preemptions,
                ops_salvaged=salvaged, deadline_s=job.deadline_s,
                deadline_met=deadline_met, tags=job.tags,
                trace=trace_hops)
            self.telemetry.record_job_done(job.tenant, job_sigs[j],
                                           run.sig_source)
            job.salvage = {}    # release pinned intermediates
            job.future._set_result(job_results, report)
