"""Cross-agent batch coalescing (paper §4.2, lifted to multi-tenant).

Concurrently submitted batches from *different* agents are merged into one
super-batch before optimization.  Fusion is cheap (the unified DAG is the
union of sinks); the win is that CSE then runs across tenants: two agents
profiling the same dataset share one read, one TableVectorizer fit, one
encoder — the op executes once and both futures see its value.

The coalescer also owns **result remapping**: sink names are namespaced per
job (``j<id>/<name>``) so the merged run's name→value dict splits losslessly
back into each tenant's original names.

Super-batches are *priority-homogeneous*: the dispatcher only coalesces jobs
popped from the same priority band (see ``queue.pop_round(band=...)``), so
an INTERACTIVE probe is never welded to a bulk sweep whose execution time it
would then inherit, and a preemption decision applies to the whole merge.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

from ..core.dag import LazyRef, toposort
from ..core.fusion import PipelineBatch
from .queue import Job

_SEP = "\x1d"  # group separator: cannot collide with user pipeline names


@dataclass
class SuperBatch:
    jobs: list                   # list[Job]
    batch: PipelineBatch         # merged, namespaced
    spans: list                  # [(start, stop)] sink span per job

    def job_sinks(self, final_sinks: Sequence[LazyRef],
                  j: int) -> list[LazyRef]:
        """The (post-rewrite) sinks belonging to job ``j`` — rewrites
        preserve sink order, so spans survive optimization."""
        a, b = self.spans[j]
        return list(final_sinks[a:b])

    def split_results(self, named: dict[str, Any]) -> list[dict[str, Any]]:
        """Invert the namespacing: one ``{name: value}`` dict per job."""
        out: list[dict[str, Any]] = []
        for job in self.jobs:
            prefix = f"j{job.id}{_SEP}"
            out.append({k[len(prefix):]: v for k, v in named.items()
                        if k.startswith(prefix)})
        return out


def coalesce(jobs: Sequence[Job]) -> SuperBatch:
    sinks: list[LazyRef] = []
    names: list[str] = []
    spans: list[tuple[int, int]] = []
    for job in jobs:
        start = len(sinks)
        sinks.extend(job.batch.sinks)
        names.extend(f"j{job.id}{_SEP}{n}" for n in job.batch.names)
        spans.append((start, len(sinks)))
    return SuperBatch(jobs=list(jobs),
                      batch=PipelineBatch(sinks, names),
                      spans=spans)


# ---------------------------------------------------------------------------
# cross-agent dedup accounting
# ---------------------------------------------------------------------------

def reachable_sigs(sinks: Sequence[LazyRef]) -> set[str]:
    return {op.signature for op in toposort(sinks)}


def cross_agent_dedup(job_sigs: Sequence[set],
                      tenants: Sequence[str]) -> tuple[int, dict[str, int]]:
    """Executions saved by merging before optimization.

    For each op signature present in ≥ 2 jobs from ≥ 2 distinct tenants,
    ``len(jobs) - 1`` executions were saved (CSE keys on the signature, so
    the merged DAG materializes it once).  Returns ``(total_saved,
    shared_ops_per_tenant)`` where the per-tenant number counts how many of
    that tenant's ops were shared with another agent.
    """
    containing: dict[str, list[int]] = {}
    for j, sigs in enumerate(job_sigs):
        for sig in sigs:
            containing.setdefault(sig, []).append(j)
    total = 0
    per_tenant: dict[str, int] = {}
    for sig, js in containing.items():
        owners = {tenants[j] for j in js}
        if len(owners) < 2:
            continue
        total += len(js) - 1
        for t in owners:
            per_tenant[t] = per_tenant.get(t, 0) + 1
    return total, per_tenant
