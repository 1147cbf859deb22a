"""Admission-controlled, priority-stratified, tenant-fair job queue.

Four properties the service needs that a plain FIFO lacks:

* **admission control** — ``push`` rejects (raises :class:`AdmissionError`)
  once global or per-tenant queue depth limits are hit, so a runaway agent
  sheds load at the edge instead of OOMing the service;
* **priority stratification** — jobs land in one of three bands
  (:class:`~repro_torch.service.priority.Priority`); ``pop_round`` picks the band
  to serve by weighted fair queuing (credit accrual proportional to
  configurable weights), so latency-sensitive INTERACTIVE probes do not sit
  behind another agent's bulk sweep, while BATCH/SCAVENGER retain a
  configurable fraction of throughput.  Each round serves exactly one band,
  keeping coalesced super-batches priority-homogeneous (a prerequisite for
  coherent preemption decisions);
* **fairness within a band** — jobs live in per-tenant FIFOs and a round
  drains them round-robin with a per-tenant cap, so a tenant flooding the
  queue cannot starve another tenant of the same priority;
* **deadline awareness** — a job may carry ``deadline_s`` (an SLO relative
  to submission).  Within the band WFQ selected, tenants holding
  deadline-carrying work are served earliest-deadline-first (EDF) ahead of
  deadline-free tenants, which keep their round-robin order — priorities
  decide *which band* runs, deadlines only break ties *inside* it.  A job
  whose deadline has already passed while queued is **shed** at the next
  scheduling round: it is removed, its future fails with
  :class:`DeadlineExceeded`, and the optional ``on_shed`` hook fires (the
  service records attainment telemetry there) — late work stops consuming
  the capacity that could still save an attainable deadline.  A job whose
  remaining slack is below the caller's ``tight_slack_s`` is popped
  *alone*, so the coalescer cannot weld it into a large super-batch whose
  execution time it would inherit.  ``deadline_aware=False`` records
  deadlines but schedules blind (the benchmark baseline).

Starvation-proofing: a queued job is *aged* — promoted one band for every
``aging_s`` seconds it has waited — so even a SCAVENGER job under sustained
INTERACTIVE load (or with a weight-0 band) eventually reaches the top band
and is served by ordinary round-robin there.

``requeue`` re-admits cooperatively preempted jobs at the *front* of their
tenant FIFO, bypassing admission limits (they were already admitted once).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from ..core.fusion import PipelineBatch
from .observability import ADMITTED, QUEUED, REQUEUED
from .priority import DEFAULT_WEIGHTS, Priority
from .session import PipelineFuture


class AdmissionError(RuntimeError):
    """Job rejected at submission time (queue depth / tenant quota)."""


class DeadlineExceeded(RuntimeError):
    """The job's ``deadline_s`` passed before a result could be produced.

    Raised out of ``PipelineFuture.result()`` when a deadline-aware queue
    sheds the expired job (service/fabric targets) or when a local run
    finishes past the deadline.  Picklable with a plain message so it
    crosses the fabric's wire codec like any other error."""


@dataclass
class Job:
    id: int
    tenant: str
    batch: PipelineBatch
    future: PipelineFuture
    priority: Priority = Priority.BATCH
    submit_t: float = field(default_factory=time.perf_counter)
    # deadline SLO: relative seconds at submit; deadline_t is the absolute
    # perf_counter instant (derived once, so waiting never moves the goal)
    deadline_s: Optional[float] = None
    deadline_t: Optional[float] = None
    tags: tuple = ()
    # set at first dispatch; a failure-isolation retry must not re-measure
    # (the second measurement would include the failed run's execution time)
    dispatch_wait_s: Optional[float] = None
    # current effective band (≤ priority once aging promotes the job)
    band: int = -1
    # cooperative-preemption state: times this job's super-batch yielded,
    # and intermediates completed before the yield (sig → outputs tuple) so
    # the re-run loses no finished work
    preemptions: int = 0
    salvage: dict = field(default_factory=dict)
    # live JobTrace when lifecycle tracing is on (observability/), else None
    trace: object = None

    def __post_init__(self) -> None:
        if self.band < 0:
            self.band = int(self.priority)
        if self.deadline_t is None and self.deadline_s is not None:
            self.deadline_t = self.submit_t + self.deadline_s

    def slack(self, now: float) -> float:
        """Seconds until the deadline (+inf for deadline-free jobs)."""
        if self.deadline_t is None:
            return float("inf")
        return self.deadline_t - now

    def trace_slack(self) -> Optional[float]:
        """Slack for a trace hop stamp: None for deadline-free jobs."""
        if self.deadline_t is None:
            return None
        return self.deadline_t - time.perf_counter()


class FairQueue:
    """Priority-stratified weighted-fair queue with per-tenant round-robin.

    ``priority_aware=False`` collapses every job into the BATCH band,
    reproducing the original priority-blind round-robin scheduler (used as
    the baseline in ``benchmarks/e2e_agentic.py --mixed-priority``).
    """

    def __init__(self,
                 max_queued_total: int = 1024,
                 max_queued_per_tenant: int = 256,
                 weights: Optional[dict] = None,
                 aging_s: Optional[float] = 5.0,
                 priority_aware: bool = True,
                 deadline_aware: bool = True):
        self.max_queued_total = max_queued_total
        self.max_queued_per_tenant = max_queued_per_tenant
        # closed-loop control knobs (control/): per-band admission caps
        # ({} = uncapped) and an INTERACTIVE reserve — pushes into the
        # INTERACTIVE band below the reserve depth bypass the total gate
        # (tenant quota still applies), so a flood holding the queue at
        # its limit can never starve admission of latency probes
        self.band_limits: dict[int, int] = {}
        self.reserve_interactive = 0
        self.weights = {Priority(k): int(v)
                        for k, v in (weights or DEFAULT_WEIGHTS).items()}
        self.aging_s = aging_s
        self.priority_aware = priority_aware
        self.deadline_aware = deadline_aware
        # telemetry hook, called (outside the lock) per shed job AFTER its
        # future already failed with DeadlineExceeded
        self.on_shed: Optional[Callable[[Job], None]] = None
        # band → (tenant → FIFO); OrderedDict gives intra-band round-robin
        self._bands: dict[int, "OrderedDict[str, deque[Job]]"] = {
            int(p): OrderedDict() for p in Priority}
        self._credits: dict[int, float] = {int(p): 0.0 for p in Priority}   # guarded-by: _lock
        self._tenant_total: dict[str, int] = {}        # guarded-by: _lock
        self._total = 0                            # guarded-by: _lock
        # deadline-carrying jobs currently queued: the shed scan and the
        # EDF ordering are O(queued) per round, so with zero deadline jobs
        # (the common case) both must cost nothing
        self._deadline_total = 0                   # guarded-by: _lock
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._closed = False

    # ------------------------------------------------------------------
    def _band_depth_locked(self, band: int) -> int:
        return sum(len(q) for q in self._bands[band].values())

    def push(self, job: Job) -> None:
        with self._lock:
            if self._closed:
                raise AdmissionError("service is shutting down")
            if not self.priority_aware:
                job.band = int(Priority.BATCH)
            reserved = (job.band == int(Priority.INTERACTIVE)
                        and self.reserve_interactive > 0
                        and self._band_depth_locked(job.band)
                        < self.reserve_interactive)
            if not reserved:
                if self._total >= self.max_queued_total:
                    raise AdmissionError(
                        f"queue full ({self._total}/"
                        f"{self.max_queued_total})")
                limit = self.band_limits.get(job.band)
                if (limit is not None
                        and self._band_depth_locked(job.band) >= limit):
                    raise AdmissionError(
                        f"band {job.band} gated at {limit} queued jobs "
                        f"(admission controller)")
            n_tenant = self._tenant_total.get(job.tenant, 0)
            if n_tenant >= self.max_queued_per_tenant:
                raise AdmissionError(
                    f"tenant {job.tenant!r} over quota "
                    f"({n_tenant}/{self.max_queued_per_tenant})")
            band = self._bands[job.band]
            band.setdefault(job.tenant, deque()).append(job)
            self._tenant_total[job.tenant] = n_tenant + 1
            self._total += 1
            if job.deadline_t is not None:
                self._deadline_total += 1
            if job.trace is not None:
                # stamped under the lock so QUEUED always precedes the
                # dispatcher's DISPATCHED in the hop log
                job.trace.stamp(ADMITTED, slack=job.trace_slack())
                job.trace.stamp(QUEUED, slack=job.trace_slack(),
                                depth=self._total, band=job.band)
            self._not_empty.notify()

    def requeue(self, jobs: Sequence[Job]) -> None:
        """Re-admit preempted jobs at the front of their tenant FIFO.

        Bypasses depth limits — the jobs were admitted once already and
        rejecting them now would lose accepted work.  After the queue is
        closed the caller must fail the jobs instead."""
        with self._lock:
            if self._closed:
                raise AdmissionError("service is shutting down")
            for job in reversed(list(jobs)):
                if not self.priority_aware:
                    job.band = int(Priority.BATCH)
                band = self._bands[job.band]
                band.setdefault(job.tenant, deque()).appendleft(job)
                band.move_to_end(job.tenant, last=False)
                self._tenant_total[job.tenant] = \
                    self._tenant_total.get(job.tenant, 0) + 1
                self._total += 1
                if job.deadline_t is not None:
                    self._deadline_total += 1
                if job.trace is not None:
                    job.trace.stamp(REQUEUED, slack=job.trace_slack(),
                                    preemptions=job.preemptions)
            self._not_empty.notify_all()

    # -- closed-loop actuation surface (control/ServiceController) -----
    def set_limits(self, max_queued_total: Optional[int] = None,
                   band_limits: Optional[dict] = None,
                   reserve_interactive: Optional[int] = None) -> None:
        """Retune admission knobs atomically (None = leave unchanged).

        Shrinking a limit below the current depth only gates NEW pushes;
        already-admitted jobs stay queued and drain normally."""
        with self._lock:
            if max_queued_total is not None:
                self.max_queued_total = max(1, int(max_queued_total))
            if band_limits is not None:
                self.band_limits = {int(k): max(1, int(v))
                                    for k, v in band_limits.items()}
            if reserve_interactive is not None:
                self.reserve_interactive = max(0, int(reserve_interactive))

    def set_weights(self, weights: dict) -> None:
        """Replace the WFQ band weights (Priority → weight, floats ok)."""
        with self._lock:
            self.weights = {Priority(k): float(v)
                            for k, v in weights.items()}

    # ------------------------------------------------------------------
    def _age_locked(self, now: float) -> None:
        """Promote jobs one band per ``aging_s`` seconds waited."""
        if not self.aging_s or not self.priority_aware:
            return
        for b in (int(Priority.SCAVENGER), int(Priority.BATCH)):
            tenants = self._bands[b]
            for tenant in list(tenants):
                q = tenants[tenant]
                keep: deque = deque()
                for job in q:
                    target = max(0, int(job.priority)
                                 - int((now - job.submit_t) / self.aging_s))
                    if target < b:
                        job.band = b - 1   # one band per aging step
                        dst = self._bands[b - 1]
                        dst.setdefault(job.tenant, deque()).append(job)
                    else:
                        keep.append(job)
                if keep:
                    tenants[tenant] = keep
                else:
                    del tenants[tenant]

    def _select_band_locked(self) -> Optional[int]:  # guarded-by: caller
        """Weighted-fair band choice (surplus round-robin over credits)."""
        nonempty = [b for b in sorted(self._bands) if self._bands[b]]
        if not nonempty:
            return None
        if not self.priority_aware:
            return nonempty[0]
        weighted = [b for b in nonempty if self.weights.get(Priority(b), 0) > 0]
        candidates = weighted or nonempty
        if len(candidates) == 1:
            return candidates[0]
        for b in candidates:
            self._credits[b] += self.weights.get(Priority(b), 0)
        chosen = max(candidates, key=lambda b: (self._credits[b], -b))
        self._credits[chosen] -= sum(self.weights.get(Priority(b), 0)
                                     for b in candidates)
        return chosen

    def _shed_expired_locked(self, now: float) -> list[Job]:  # guarded-by: caller
        """Remove every queued job whose deadline already passed.

        Returns the shed jobs; the caller fails their futures OUTSIDE the
        lock (future callbacks may re-enter the queue)."""
        if not self.deadline_aware or not self._deadline_total:
            return []
        shed: list[Job] = []
        for tenants in self._bands.values():
            for tenant in list(tenants):
                q = tenants[tenant]
                keep: deque = deque()
                expired: list[Job] = []
                for job in q:
                    if job.deadline_t is not None and job.deadline_t <= now:
                        expired.append(job)
                    else:
                        keep.append(job)
                if not expired:
                    continue
                shed.extend(expired)
                self._total -= len(expired)
                self._deadline_total -= len(expired)
                self._tenant_total[tenant] -= len(expired)
                if not self._tenant_total[tenant]:
                    del self._tenant_total[tenant]
                if keep:
                    tenants[tenant] = keep
                else:
                    del tenants[tenant]
        return shed

    def _resolve_shed(self, shed: Sequence[Job]) -> None:
        for job in shed:
            job.future._set_exception(DeadlineExceeded(
                f"job {job.id} (tenant {job.tenant!r}) shed: deadline of "
                f"{job.deadline_s}s expired while queued"))
            if self.on_shed is not None:
                try:
                    self.on_shed(job)
                except Exception:   # noqa: BLE001 — telemetry must not kill
                    pass            # the dispatcher

    def _take_locked(self, tenants, tenant: str, q: deque, n: int,
                     now: float,
                     exclude_tight_s: Optional[float] = None) -> list[Job]:  # guarded-by: caller
        """Remove up to ``n`` jobs from one tenant FIFO — earliest-deadline
        first when any queued job carries one, plain FIFO otherwise.  With
        ``exclude_tight_s`` set (a coalescing-window extension), jobs whose
        slack is at or below it are left queued: a tight-deadline job must
        dispatch alone, never inside a growing merge."""
        edf = self.deadline_aware and self._deadline_total > 0
        idxs = range(len(q))
        if exclude_tight_s is not None and edf:
            idxs = [i for i in idxs if q[i].slack(now) > exclude_tight_s]
        if edf and any(j.deadline_t is not None for j in q):
            picked = sorted(idxs, key=lambda i: (q[i].slack(now), i))[:n]
        else:
            picked = list(idxs)[:n]
        out = [q[i] for i in picked]    # EDF order, not FIFO position
        for job in out:
            q.remove(job)
        if out:
            self._total -= len(out)
            self._deadline_total -= sum(1 for j in out
                                        if j.deadline_t is not None)
            self._tenant_total[tenant] -= len(out)
            if not self._tenant_total[tenant]:
                del self._tenant_total[tenant]
        if not q:
            del tenants[tenant]
        return out

    def pop_round(self, max_jobs: int, max_per_tenant: int = 1,
                  timeout: Optional[float] = None,
                  band: Optional[int] = None,
                  tight_slack_s: Optional[float] = None) -> list[Job]:
        """One fair scheduling round, confined to a single priority band.

        Blocks up to ``timeout`` for work, sheds deadline-expired jobs,
        ages waiting jobs, selects a band by weighted fair queuing (or uses
        ``band`` when the caller is extending an in-progress coalescing
        window — super-batches must stay priority-homogeneous), then takes
        ≤ ``max_per_tenant`` jobs from each of the band's tenants until
        ``max_jobs`` or the band drains.  Deadline-carrying tenants are
        served earliest-deadline-first ahead of the round-robin order
        (tenants rotate to the back after being served).

        When the band's most urgent job has less than ``tight_slack_s``
        of slack left, that job is returned ALONE: coalescing it into a
        large super-batch would make it inherit the merge's execution time
        and miss a deadline it could still meet.
        """
        deadline = (time.perf_counter() + timeout) if timeout else None

        def _has_work() -> bool:
            if band is None:
                return bool(self._total)
            return bool(self._bands[band])

        shed: list[Job] = []
        try:
            with self._lock:
                while not _has_work():
                    if deadline is None:
                        return []
                    left = deadline - time.perf_counter()
                    if left <= 0 or self._closed:
                        return []
                    self._not_empty.wait(left)
                now = time.perf_counter()
                shed = self._shed_expired_locked(now)
                self._age_locked(now)
                chosen = (band if band is not None
                          else self._select_band_locked())
                if chosen is None or not self._bands[chosen]:
                    return []
                tenants = self._bands[chosen]

                # EDF tie-break inside the WFQ-chosen band: serve tenants
                # by their most urgent queued deadline; deadline-free
                # tenants keep their round-robin order (sort is stable and
                # their key is +inf)
                order = list(tenants)
                if self.deadline_aware and self._deadline_total:
                    order.sort(key=lambda t: min(
                        (j.slack(now) for j in tenants[t]),
                        default=float("inf")))
                    head = tenants.get(order[0])
                    most_urgent = min(
                        (j.slack(now) for j in head), default=float("inf")
                        ) if head else float("inf")
                    if (tight_slack_s is not None and band is None
                            and most_urgent <= tight_slack_s):
                        # pop the tight job alone — never into a merge
                        return self._take_locked(tenants, order[0], head, 1,
                                                 now)
                # extension pops must leave tight jobs queued (they will
                # pop alone at the NEXT round's tight check instead)
                exclude = tight_slack_s if band is not None else None

                out: list[Job] = []
                for tenant in order:
                    if len(out) >= max_jobs:
                        break
                    q = tenants.get(tenant)
                    if not q:
                        continue
                    take = min(max_per_tenant, len(q), max_jobs - len(out))
                    got = self._take_locked(tenants, tenant, q, take, now,
                                            exclude_tight_s=exclude)
                    out.extend(got)
                    # rotate: a served tenant still queued goes to the back
                    if got and tenant in tenants:
                        tenants.move_to_end(tenant)
                return out
        finally:
            self._resolve_shed(shed)

    def cancel(self, job_id: int) -> bool:
        """Remove a still-queued job; returns False once dispatched."""
        with self._lock:
            for tenants in self._bands.values():
                for tenant, q in list(tenants.items()):
                    for job in q:
                        if job.id == job_id:
                            q.remove(job)
                            self._total -= 1
                            if job.deadline_t is not None:
                                self._deadline_total -= 1
                            self._tenant_total[tenant] -= 1
                            if not self._tenant_total[tenant]:
                                del self._tenant_total[tenant]
                            if not q:
                                del tenants[tenant]
                            job.future._set_cancelled()
                            return True
        return False

    # ------------------------------------------------------------------
    def pending(self) -> int:
        with self._lock:
            return self._total

    def pending_by_band(self) -> dict[int, int]:
        with self._lock:
            return {b: sum(len(q) for q in tenants.values())
                    for b, tenants in self._bands.items()}

    def has_work_above(self, band: int) -> bool:
        """True when a job is queued in a strictly more urgent band —
        the cooperative-preemption trigger for a running super-batch."""
        with self._lock:
            return any(self._bands[b] for b in self._bands if b < band)

    def close(self) -> list[Job]:
        """Stop admitting; drain and return whatever is still queued."""
        with self._lock:
            self._closed = True
            rest = [j for tenants in self._bands.values()
                    for q in tenants.values() for j in q]
            for tenants in self._bands.values():
                tenants.clear()
            self._tenant_total.clear()
            self._total = 0
            self._deadline_total = 0
            self._not_empty.notify_all()
            return rest

    def reopen(self) -> None:
        """Accept submissions again after ``close`` (service restart)."""
        with self._lock:
            self._closed = False

    def kick(self) -> None:
        """Wake a blocked ``pop_round`` (used on shutdown)."""
        with self._lock:
            self._not_empty.notify_all()
