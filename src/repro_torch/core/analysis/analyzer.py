"""The analyzer entry point: abstract-interpret a pipeline batch.

``analyze`` mirrors ``Stratum.compile_batch``'s stage order — lowering →
shape inference → (lint) → selection → planning → segment partitioning —
but every stage runs *guarded*: instead of raising mid-optimization the
way the execution path would, each failure becomes a :class:`Finding`
with op-level provenance, and downstream stages skip the poisoned
subgraph.  Nothing executes; the most expensive thing the analyzer does
is a fake-tensor run of single ops (and optionally a fake trace of whole
predicted segments, to discharge the runtime's first-dispatch probe).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import torch

from ..dag import LazyRef
from ..lowering import lower
from ..metadata import OpMetadata
from ..scheduler import SchedulerConfig, plan as make_plan
from ..selection import SelectionConfig, select
from .infer import infer_shapes
from .lint import lint_pipeline, segment_split_findings
from .report import AnalysisReport, Finding, SEV_ERROR, SEV_WARNING
from .wiring import validate_wiring


def _as_sinks(batch_or_sinks) -> tuple[list, int]:
    """Accept a PipelineBatch, a sequence of LazyRefs, or one LazyRef."""
    if hasattr(batch_or_sinks, "fused_sinks"):
        sinks = list(batch_or_sinks.fused_sinks())
        return sinks, len(sinks)
    if isinstance(batch_or_sinks, LazyRef):
        return [batch_or_sinks], 1
    sinks = list(batch_or_sinks)
    return sinks, len(sinks)


def _materialize_meta(order, infos) -> None:
    """Attach inferred avals as op.meta so the planner's memory model and
    impl cost hints see the same shapes the metadata pass would produce."""
    for op in order:
        if op.meta is not None:
            continue
        outs = infos.get(op.signature)
        if outs is not None and len(outs) == op.n_outputs:
            op.meta = OpMetadata(outputs=list(outs))


def _feasibility(sinks, infos, *, platform: str,
                 memory_budget_bytes: int, allowed_backends,
                 segment_time_budget_s, torch_backend, device,
                 hardware_threads):
    """Predict per-segment backend + plan-cache key without executing.

    Reuses the real ``select`` + ``scheduler.plan`` (and therefore
    ``partition_segments``) so the prediction is the partition the runtime
    will actually dispatch.  For torch segments with a live backend, also
    builds the segment program and fake-traces it on the inferred avals on
    ``device`` — on success the runtime's execute-time probe is discharged
    (``TorchSegmentBackend.mark_preverified``)."""
    findings: list = []
    summaries: list = []
    preverified = 0
    sel = select(sinks, SelectionConfig(
        platform=platform, memory_budget_bytes=memory_budget_bytes,
        allowed_backends=allowed_backends, device=device.type))
    p = make_plan(sinks, sel, SchedulerConfig(
        memory_budget_bytes=memory_budget_bytes,
        hardware_threads=hardware_threads,
        segment_time_budget_s=segment_time_budget_s))
    findings.extend(segment_split_findings(p.segments, sel))
    for seg in p.segments:
        ops = [op for w in seg.waves for op in w.ops]
        names: dict[str, int] = {}
        for op in ops:
            names[op.op_name] = names.get(op.op_name, 0) + 1
        summary = {"kind": seg.kind, "n_ops": len(ops),
                   "n_waves": len(seg.waves),
                   "ops": dict(sorted(names.items()))}
        if seg.kind == "torch":
            import hashlib
            h = hashlib.blake2b(digest_size=8)
            for op in ops:
                h.update(op.structural_signature.encode())
            summary["plan_key"] = h.hexdigest()
            if torch_backend is not None and hasattr(
                    torch_backend, "preverify_segment"):
                key = torch_backend.preverify_segment(seg, sel, infos,
                                                      device)
                summary["preverified"] = key is not None
                if key is not None:
                    preverified += 1
        summaries.append(summary)
    return findings, summaries, preverified, p


def analyze(batch_or_sinks, *,
            platform: str = "",
            memory_budget_bytes: int = 8 << 30,
            lowering: bool = True,
            use_eval_shape: bool = True,
            lint: bool = True,
            feasibility: bool = True,
            allowed_backends: Sequence[str] = ("python", "torch"),
            segment_time_budget_s: Optional[float] = None,
            extra_roots: Sequence[LazyRef] = (),
            torch_backend=None, device="cuda",
            hardware_threads: int = 0) -> AnalysisReport:
    """Statically analyze a pipeline batch; never executes data ops.

    Stages (each optional past the first):

    1. wiring/schema validation — cycles, arity, missing inputs, unknown
       impls (always on; the same rules ``compile_batch`` enforces),
    2. abstract shape/dtype inference over the lowered DAG,
    3. pipeline lint (dead outputs/ops, CSE duplicates, undeclared
       tunables),
    4. compile-feasibility classification via the real scheduler
       partitioning, predicting per-segment backend + plan-cache key, and
       — given a live ``torch_backend`` — statically discharging the
       runtime's first-dispatch probe (a fake trace of the segment on
       ``device``, the session's).  ``device`` also picks the selection
       platform, as a session's does; it is only named, never touched.
       ``hardware_threads`` shapes the waves as the session's does, so the
       predicted segments are the ones its run dispatches.
    """
    t0 = time.perf_counter()
    sinks, n_pipelines = _as_sinks(batch_or_sinks)
    findings: list = list(validate_wiring(sinks))
    cyclic = any(f.rule in ("cycle", "bad-sink") for f in findings)

    report = AnalysisReport(n_pipelines=n_pipelines)
    if cyclic:
        report.findings = tuple(findings)
        report.analysis_time_s = time.perf_counter() - t0
        return report

    error_uids = frozenset(f.op_uid for f in findings
                           if f.severity == SEV_ERROR and f.op_uid >= 0)

    lowered = sinks
    if lowering:
        try:
            lowered = lower(sinks)
        except Exception as e:
            findings.append(Finding(
                "lowering-error", SEV_ERROR,
                f"lowering raised {type(e).__name__}: {e}"))
            lowered = sinks

    from ..dag import toposort
    order = toposort(lowered)
    infos, infer_findings = infer_shapes(
        order, skip_uids=error_uids, use_eval_shape=use_eval_shape)
    findings.extend(infer_findings)

    if lint:
        try:
            findings.extend(lint_pipeline(lowered, extra_roots=extra_roots))
        except Exception as e:       # lint must never block a verdict
            findings.append(Finding(
                "lint-error", SEV_WARNING,
                f"lint pass raised {type(e).__name__}: {e}"))

    has_errors = any(f.severity == SEV_ERROR for f in findings)
    segments: list = []
    preverified = 0
    if feasibility and not has_errors:
        try:
            _materialize_meta(order, infos)
            seg_findings, segments, preverified, _p = _feasibility(
                lowered, infos, platform=platform,
                memory_budget_bytes=memory_budget_bytes,
                allowed_backends=tuple(allowed_backends),
                segment_time_budget_s=segment_time_budget_s,
                torch_backend=torch_backend, device=torch.device(device),
                hardware_threads=hardware_threads)
            findings.extend(seg_findings)
        except Exception as e:       # feasibility is advisory, not a gate
            findings.append(Finding(
                "feasibility-error", SEV_WARNING,
                f"feasibility pass raised {type(e).__name__}: {e}"))

    report.findings = tuple(findings)
    report.op_shapes = {sig: tuple((tuple(t.shape), t.dtype) for t in outs)
                        for sig, outs in infos.items()}
    report.segments = tuple(segments)
    report.n_ops = len(order)
    report.preverified_segments = preverified
    report.analysis_time_s = time.perf_counter() - t0
    return report
