"""Parallelization planning (paper §4.3).

The planner traverses the DAG and groups ready operators into *waves*:
sets of mutually independent ops that execute concurrently.  A wave is
admitted greedily under a worst-case memory budget (sum of each op's
backend-inflated working set + live intermediates), which is the paper's
"evaluates plans under worst-case memory budgets, selects a plan that
minimizes execution time subject to memory constraints".

Degree-of-parallelism planning (paper: avoid oversubscription from nested
parallelism): each op's *intra*-op parallelism is its backend's internal
parallelism (the native-library/Rayon analogue), so the planner caps the
number of concurrently executing ops such that
``inter_op_parallelism × intra_op_threads ≤ hardware_threads``.  On a CUDA
device the inter-op threads share the current stream, so the card runs the
ops of a wave in their launch order.

Liveness-based freeing: the planner emits, per wave, the set of intermediate
signatures whose last consumer has now run, so the runtime can drop them
(memory management, paper §3).

Segment partitioning: after waves are laid out, contiguous runs of waves
whose every op selected a *traceable* torch-tier implementation are
grouped into maximal backend-homogeneous :class:`Segment`\\ s.  A
``"torch"`` segment is executed by the TorchSegmentBackend as ONE compiled
program (per-op python dispatch disappears inside it); everything else
stays a ``"python"`` segment executed by the per-op threaded backend.  Cache probes, liveness
freeing and preemption yields happen at segment boundaries, so segmenting
changes dispatch granularity, never semantics.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional, Sequence

from .dag import LazyOp, LazyRef, consumers, toposort
from .selection import PhysicalImpl


@dataclass
class Wave:
    ops: list            # list[LazyOp], mutually independent
    est_mem: int = 0
    est_time: float = 0.0
    free_after: list = field(default_factory=list)  # signatures now dead


@dataclass
class Segment:
    """A contiguous run of waves homogeneous in execution backend."""
    kind: str            # "torch" (whole-segment program) | "python" (per-op)
    waves: list          # contiguous slice of Plan.waves
    start: int = 0       # index of the first wave within the plan

    @property
    def n_ops(self) -> int:
        return sum(len(w.ops) for w in self.waves)


@dataclass
class Plan:
    waves: list          # list[Wave]
    order: list          # full topo order (for sequential modes)
    inter_op_parallelism: int = 1
    intra_op_threads: int = 1
    est_peak_mem: int = 0
    segments: list = field(default_factory=list)   # list[Segment]

    @property
    def n_ops(self) -> int:
        return sum(len(w.ops) for w in self.waves)


@dataclass
class SchedulerConfig:
    memory_budget_bytes: int = 8 << 30
    hardware_threads: int = 0           # 0 → os.cpu_count()
    max_wave_ops: int = 64
    enable_inter_op: bool = True
    # whether torch segments will execute as ONE program (the caller's
    # runtime setting): affects only the est_peak_mem the memory gate
    # reserves — a compiled segment defers per-wave freeing to its boundary
    compiled_segments: bool = True
    # cap on a compiled segment's summed est_time: a jitted program has no
    # internal yield points, so an unbounded super-batch segment delays an
    # interactive/deadline preempt by its whole wall time.  Splitting past
    # the budget bounds that latency to one slice (preemption polls run at
    # segment boundaries).  None = maximal segments (no cap)
    segment_time_budget_s: Optional[float] = None


def plan(sinks: Sequence[LazyRef],
         selection: dict[str, PhysicalImpl],
         config: SchedulerConfig) -> Plan:
    order = toposort(sinks)
    fanout = consumers(order)
    sink_sigs = {r.signature for r in sinks}

    threads = config.hardware_threads or (os.cpu_count() or 1)

    # remaining-consumer counts for liveness — aggregated per SIGNATURE:
    # without CSE the same signature may appear as several distinct ops
    # (the runtime stores values by signature), so a value is dead only
    # when *every* op sharing the signature has been fully consumed
    remaining: dict[str, int] = {}
    for op in order:
        remaining[op.signature] = (remaining.get(op.signature, 0)
                                   + len(fanout.get(op.uid, ())))

    indeg: dict[int, int] = {}
    dependents: dict[int, list[LazyOp]] = {}
    for op in order:
        uniq_parents = {r.op.uid for r in op.inputs}
        indeg[op.uid] = len(uniq_parents)
        for pu in uniq_parents:
            dependents.setdefault(pu, []).append(op)

    by_sig = {op.signature: op for op in order}
    ready = [op for op in order if indeg[op.uid] == 0]

    def op_mem(op: LazyOp) -> int:
        impl = selection.get(op.signature)
        if impl is not None:
            return impl.est_mem(op)
        return op.meta.peak_bytes if op.meta else 0

    def op_time(op: LazyOp) -> float:
        impl = selection.get(op.signature)
        if impl is not None:
            return impl.est_time(op)
        return 1e-6

    waves: list[Wave] = []
    live_bytes = 0
    peak = 0
    scheduled: set[int] = set()

    while ready:
        # longest-estimated-time first within a wave → better packing.
        # Equal-cost ops tie-break on structural signature so AIDE-style
        # variant fans (same structure, tunables differing) land adjacent:
        # the compiled-segment variant batcher executes a group at its LAST
        # member's position, so clustering members minimizes the deferral
        # distance — and the chance a group is dropped for starving an
        # intermediate consumer.  Also makes wave layout deterministic.
        ready.sort(key=lambda o: (-op_time(o), o.structural_signature))
        wave_ops: list[LazyOp] = []
        wave_mem = 0
        deferred: list[LazyOp] = []
        limit = config.max_wave_ops if config.enable_inter_op else 1
        for op in ready:
            m = op_mem(op)
            if wave_ops and (len(wave_ops) >= limit
                             or live_bytes + wave_mem + m
                             > config.memory_budget_bytes):
                deferred.append(op)
                continue
            wave_ops.append(op)
            wave_mem += m
        peak = max(peak, live_bytes + wave_mem)

        wave = Wave(ops=wave_ops, est_mem=wave_mem,
                    est_time=max((op_time(o) for o in wave_ops), default=0.0))

        # retire consumed intermediates
        freed: list[str] = []
        for op in wave_ops:
            scheduled.add(op.uid)
            for ref in op.inputs:
                sig = ref.op.signature
                remaining[sig] -= 1
                if remaining[sig] == 0 and not any(
                        s.startswith(sig) for s in sink_sigs):
                    freed.append(sig)
        wave.free_after = freed

        live_bytes += sum(op.meta.out_bytes if op.meta else 0
                          for op in wave_ops)
        for sig in freed:
            freed_op = by_sig[sig]
            live_bytes -= freed_op.meta.out_bytes if freed_op.meta else 0
        live_bytes = max(live_bytes, 0)

        waves.append(wave)

        next_ready = list(deferred)
        for op in wave_ops:
            for dep in dependents.get(op.uid, ()):
                indeg[dep.uid] -= 1
                if indeg[dep.uid] == 0:
                    next_ready.append(dep)
        ready = next_ready

    if len(scheduled) != len(order):
        raise RuntimeError("scheduler failed to plan all ops (cycle?)")

    # degree-of-parallelism: keep inter × intra ≤ hardware threads
    widest = max((len(w.ops) for w in waves), default=1)
    inter = min(widest, threads) if config.enable_inter_op else 1
    intra = max(1, threads // max(inter, 1))

    segments = partition_segments(waves, selection,
                                  time_budget_s=config.segment_time_budget_s)
    # a compiled torch segment returns every op's outputs at once and only
    # applies per-wave liveness freeing at the segment boundary, so its
    # true peak is the sum of ALL its output bytes — raise the estimate
    # the service memory gate reserves accordingly.  Per-op runtimes
    # (compiled_segments=False) keep per-wave freeing, where the bump
    # would over-reserve and needlessly serialize concurrent super-batches
    if config.compiled_segments:
        for seg in segments:
            if seg.kind != "torch":
                continue
            seg_bytes = sum(op.meta.out_bytes if op.meta else 0
                            for w in seg.waves for op in w.ops)
            peak = max(peak, seg_bytes)

    return Plan(waves=waves, order=order, inter_op_parallelism=inter,
                intra_op_threads=intra, est_peak_mem=peak,
                segments=segments)


def partition_segments(waves: Sequence[Wave],
                       selection: dict[str, PhysicalImpl],
                       time_budget_s: Optional[float] = None
                       ) -> list[Segment]:
    """Group contiguous waves into maximal backend-homogeneous segments.

    A wave is compilable iff every op in it selected a traceable
    torch-tier implementation; contiguous compilable waves merge into one
    ``"torch"`` segment.  One-op torch runs are demoted to ``"python"`` —
    a single op gains nothing from whole-segment tracing (its impl is
    typically already jitted) but would still occupy a plan-cache entry.

    Waves whose every op selected one *custom-registered* backend kind
    (``repro_torch.core.backends.register_backend``) form segments of that kind
    the same way, so an out-of-process/Rust backend receives whole
    segments instead of being flattened onto the python path.

    ``time_budget_s`` caps a non-python segment's summed wave ``est_time``:
    compiled programs have no internal yield points, so the cap bounds how
    long a running segment can delay a cooperative preempt (the runtime
    polls at segment boundaries).  Splits happen at wave boundaries, so
    segmentation still never changes semantics."""
    # custom backend kinds are registered at runtime; resolve lazily to
    # keep core.scheduler importable before core.backends finishes loading
    from .backends.base import available_backends
    custom_kinds = set(available_backends()) - {"python", "torch"}

    def wave_kind(wave: Wave) -> str:
        kinds: set[str] = set()
        for op in wave.ops:
            impl = selection.get(op.signature)
            if impl is None:
                return "python"
            if impl.backend == "torch" and impl.traceable:
                kinds.add("torch")
            elif impl.backend in custom_kinds:
                kinds.add(impl.backend)
            else:
                return "python"
        if len(kinds) == 1:
            return kinds.pop()
        return "python"

    segments: list[Segment] = []
    for i, wave in enumerate(waves):
        kind = wave_kind(wave)
        if segments and segments[-1].kind == kind:
            segments[-1].waves.append(wave)
        else:
            segments.append(Segment(kind=kind, waves=[wave], start=i))
    # demote trivial torch segments, then re-merge adjacent same-kind runs
    merged: list[Segment] = []
    for seg in segments:
        if seg.kind == "torch" and seg.n_ops < 2:
            seg.kind = "python"
        if merged and merged[-1].kind == seg.kind:
            merged[-1].waves.extend(seg.waves)
        else:
            merged.append(seg)
    if time_budget_s is None:
        return merged
    # bound compiled-segment preempt latency: split past the est_time
    # budget (AFTER merging — adjacent same-kind segments would otherwise
    # re-coalesce and undo the cap)
    capped: list[Segment] = []
    for seg in merged:
        if seg.kind == "python":
            capped.append(seg)      # per-op path polls inside the segment
            continue
        cur: list[Wave] = []
        cur_t = 0.0
        start = seg.start
        for w in seg.waves:
            if cur and cur_t + w.est_time > time_budget_s:
                capped.append(Segment(kind=seg.kind, waves=cur,
                                      start=start))
                start += len(cur)
                cur, cur_t = [], 0.0
            cur.append(w)
            cur_t += w.est_time
        capped.append(Segment(kind=seg.kind, waves=cur, start=start))
    return capped
