"""The stratum session — the user/agent-facing entry point.

Ties the whole §4 pipeline together::

    batch → lowering → metadata → logical rewrites → metadata →
    cache-candidate marking → operator selection → parallel plan → execute

Every stage can be toggled via ``enable`` for the paper's ablation study
(Fig. 6b): ``logical`` (CSE & friends), ``lowering``, ``selection`` (native
backends), ``parallel`` (inter-op), ``cache`` (intermediate reuse).

A session runs on one device: ``device=None`` is the CUDA device, and
raises when there is none; ``device="cpu"`` runs the torch tier (and its
compiled segments) on the CPU.
"""

from __future__ import annotations

import os
import time
import warnings
from dataclasses import dataclass
from typing import Any, Optional, Sequence

from ..kernels.common import resolve_device
from .analysis import AnalysisError, AnalysisReport, analyze, validate_wiring
from .backends import make_backends
from .cache import CacheStats, IntermediateCache, mark_cache_candidates
from .dag import LazyRef, count_ops, toposort
from .fusion import PipelineBatch
from .lowering import lower
from .metadata import collect_metadata
from .plan_cache import PlanCache
from .rewrites import RewriteStats, optimize_logical
from .runtime import RunReport, Runtime, execute_reference
from .scheduler import Plan, SchedulerConfig, plan as make_plan
from .selection import SelectionConfig, check_platform, select

ALL_FEATURES = ("logical", "lowering", "selection", "parallel", "cache")


@dataclass
class StratumReport:
    rewrites: RewriteStats
    plan: Plan
    run: RunReport
    cache: Optional[CacheStats]
    ops_submitted: int
    ops_planned: int
    optimize_time_s: float
    plan_cache: Optional[dict] = None   # PlanCache.snapshot() at run end

    def summary(self) -> str:
        lines = [
            f"ops: {self.ops_submitted} submitted -> {self.ops_planned} planned",
            f"rewrites: cse={self.rewrites.cse_merged} "
            f"reads_shared={self.rewrites.reads_shared} "
            f"folded={self.rewrites.constants_folded} "
            f"pushed={self.rewrites.projections_pushed}",
            f"waves: {self.run.waves} inter_op={self.plan.inter_op_parallelism}",
            f"executed: {self.run.ops_executed} "
            f"cached: {self.run.ops_from_cache} "
            f"backends: {self.run.per_backend}",
            f"wall: {self.run.wall_time_s:.4f}s "
            f"(optimize {self.optimize_time_s:.4f}s)",
        ]
        if self.plan_cache is not None:
            lines.append(
                f"plan cache: {self.plan_cache['entries']} entries "
                f"hit_rate={self.plan_cache['hit_rate']:.2f} "
                f"(compiles {self.plan_cache['compiles']})")
        return "\n".join(lines)


_DEFAULT_CACHE_FRACTION = 0.10      # paper default
_DEFAULT_PLAN_CACHE_ENTRIES = 256
_warned_once: set = set()


def _warn_once(message: str) -> None:
    """Emit each distinct config warning once per process — a service
    constructing thousands of sessions must not spam the log."""
    if message in _warned_once:
        return
    _warned_once.add(message)
    warnings.warn(message, UserWarning, stacklevel=3)


class Stratum:
    """A stratum execution session (one per agent / tenant).

    Prefer constructing through :class:`repro_torch.client.StratumConfig`
    and a :class:`repro_torch.client.StratumClient` target — this
    constructor's flat keyword surface is retained as a stable shim for
    existing callers.
    """

    def __init__(self,
                 memory_budget_bytes: int = 8 << 30,
                 cache_fraction: Optional[float] = None,
                 spill_dir: Optional[str] = None,
                 platform: str = "",
                 enable: Sequence[str] = ALL_FEATURES,
                 hardware_threads: int = 0,
                 jit_cache_dir: Optional[str] = None,
                 cache: Optional[IntermediateCache] = None,
                 compiled_segments: bool = True,
                 plan_cache: Optional[PlanCache] = None,
                 plan_cache_entries: Optional[int] = None,
                 segment_time_budget_s: Optional[float] = None,
                 compile_async: bool = False,
                 batch_variants: bool = False,
                 speculative_depth: int = 0,
                 device=None):
        unknown = set(enable) - set(ALL_FEATURES)
        if unknown:
            raise ValueError(f"unknown features {unknown}")
        check_platform(platform)
        self.device = resolve_device(device)
        # validate cross-feature kwargs instead of silently accepting them:
        # a tuned cache_fraction with "cache" disabled (or a plan-cache
        # size with compiled segments off) is a config bug, not a no-op
        if "cache" not in enable:
            if cache_fraction is not None:
                _warn_once("Stratum(cache_fraction=...) has no effect: the "
                           "'cache' feature is disabled in enable=")
            if spill_dir is not None:
                _warn_once("Stratum(spill_dir=...) has no effect: the "
                           "'cache' feature is disabled in enable=")
        if not compiled_segments:
            if plan_cache_entries is not None:
                _warn_once("Stratum(plan_cache_entries=...) has no effect "
                           "with compiled_segments=False")
            if plan_cache is not None:
                _warn_once("Stratum(plan_cache=...) has no effect with "
                           "compiled_segments=False")
            if compile_async:
                _warn_once("Stratum(compile_async=True) has no effect "
                           "with compiled_segments=False")
            if batch_variants:
                _warn_once("Stratum(batch_variants=True) has no effect "
                           "with compiled_segments=False")
        if speculative_depth and not compile_async:
            _warn_once("Stratum(speculative_depth=...) has no effect "
                       "without compile_async=True")
        if cache_fraction is None:
            cache_fraction = _DEFAULT_CACHE_FRACTION
        if plan_cache_entries is None:
            plan_cache_entries = _DEFAULT_PLAN_CACHE_ENTRIES
        if jit_cache_dir:
            # persistent compilation cache, process-wide: inductor (and the
            # Triton kernels it writes) keep each compiled segment graph
            # there, so a long-lived stratum service compiles each (segment,
            # shape) once across sessions/processes — the analogue of the
            # paper's precompiled Rust kernels
            os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.abspath(
                jit_cache_dir)
        self.enable = tuple(enable)
        self.memory_budget_bytes = memory_budget_bytes
        self.platform = platform
        self.hardware_threads = hardware_threads
        self.segment_time_budget_s = segment_time_budget_s
        # an injected cache is shared infrastructure (the multi-tenant
        # service hands every session the same thread-safe instance)
        self.cache: Optional[IntermediateCache] = None
        if cache is not None and "cache" in enable:
            self.cache = cache
        elif "cache" in enable:
            self.cache = IntermediateCache(
                budget_bytes=int(memory_budget_bytes * cache_fraction),
                spill_dir=spill_dir)
        # compiled-plan cache + pluggable backends: an injected plan cache
        # is shared infrastructure (a service shard hands every run the
        # same instance so structurally identical plans compile once)
        self.compiled_segments = compiled_segments
        self.plan_cache: Optional[PlanCache] = None
        if compiled_segments:
            self.plan_cache = (plan_cache if plan_cache is not None
                               else PlanCache(
                                   capacity=plan_cache_entries,
                                   compile_async=compile_async,
                                   speculative_depth=speculative_depth))
        self._backends = make_backends(self.plan_cache,
                                       compiled=compiled_segments,
                                       batch_variants=batch_variants)

    # ------------------------------------------------------------------
    def compile_batch(self, batch: PipelineBatch):
        """Optimization-only path (for tests and plan inspection)."""
        t0 = time.perf_counter()
        sinks = batch.fused_sinks()
        # always-on structural validation: malformed wiring fails HERE,
        # deterministically, with one structured error type — never as an
        # op-dependent ExecutionError whose message varies with wave layout
        wiring_errors = [f for f in validate_wiring(sinks)
                         if f.severity == "error"]
        if wiring_errors:
            raise AnalysisError(wiring_errors)
        ops_submitted = count_ops(sinks)

        if "lowering" in self.enable:
            sinks = lower(sinks)
        collect_metadata(sinks)

        if "logical" in self.enable:
            sinks, rw = optimize_logical(sinks, execute_reference)
        else:
            rw = RewriteStats(ops_before=ops_submitted,
                              ops_after=count_ops(sinks))
        collect_metadata(sinks)

        candidates: set = set()
        if self.cache is not None:
            candidates = mark_cache_candidates(sinks)

        allowed = (("python", "torch") if "selection" in self.enable
                   else ("python",))
        sel = select(sinks, SelectionConfig(
            platform=self.platform,
            memory_budget_bytes=self.memory_budget_bytes,
            allowed_backends=allowed, device=self.device.type))

        p = make_plan(sinks, sel, SchedulerConfig(
            memory_budget_bytes=self.memory_budget_bytes,
            hardware_threads=self.hardware_threads,
            enable_inter_op="parallel" in self.enable,
            compiled_segments=self.compiled_segments,
            segment_time_budget_s=self.segment_time_budget_s))

        opt_time = time.perf_counter() - t0
        return sinks, sel, p, candidates, rw, ops_submitted, opt_time

    def run_batch(self, batch: PipelineBatch
                  ) -> tuple[dict[str, Any], StratumReport]:
        (sinks, sel, p, candidates, rw, ops_submitted,
         opt_time) = self.compile_batch(batch)
        rt = Runtime(cache=self.cache, cache_candidates=candidates,
                     parallel="parallel" in self.enable,
                     backends=self._backends, device=self.device)
        results, run = rt.execute(sinks, p, sel)
        report = StratumReport(
            rewrites=rw, plan=p, run=run,
            cache=self.cache.stats if self.cache else None,
            ops_submitted=ops_submitted, ops_planned=p.n_ops,
            optimize_time_s=opt_time,
            plan_cache=(self.plan_cache.snapshot()
                        if self.plan_cache else None))
        # remap results onto the (possibly rewritten) sink order
        named = dict(zip(batch.names, results))
        return named, report

    # convenience: single pipeline
    def run(self, sink: LazyRef, name: str = "pipeline_0"):
        results, report = self.run_batch(PipelineBatch([sink], [name]))
        return results[name], report

    # ------------------------------------------------------------------
    def analyze_batch(self, batch: PipelineBatch, *,
                      feasibility: bool = True,
                      verify_segments: bool = True,
                      extra_roots: Sequence[LazyRef] = ()
                      ) -> AnalysisReport:
        """Statically analyze ``batch`` without executing it.

        With ``verify_segments`` (and compiled segments on), the torch
        segments of the plan this session will dispatch (``compile_batch``:
        the analyzer's prediction skips the logical rewrites, so its
        segments can differ) are built and fake-traced against the
        metadata's avals on the session's device; successful traces are
        marked pre-verified on the backend, so the first real dispatch
        compiles them without its execute-time probe."""
        torch_be = (self._backends.get("torch")
                    if verify_segments and self.compiled_segments else None)
        allowed = (("python", "torch") if "selection" in self.enable
                   else ("python",))
        report = analyze(
            batch, platform=self.platform,
            memory_budget_bytes=self.memory_budget_bytes,
            lowering="lowering" in self.enable,
            feasibility=feasibility, allowed_backends=allowed,
            segment_time_budget_s=self.segment_time_budget_s,
            extra_roots=extra_roots, device=self.device,
            hardware_threads=self.hardware_threads)
        if torch_be is not None and feasibility and report.ok:
            sinks, sel, p, *_ = self.compile_batch(batch)
            infos = {op.signature: op.meta.outputs
                     for op in toposort(sinks) if op.meta is not None}
            report.preverified_segments = sum(
                torch_be.preverify_segment(seg, sel, infos, self.device)
                is not None
                for seg in p.segments if seg.kind == "torch")
        return report

    # ------------------------------------------------------------------
    def precompile_batch(self, batch: PipelineBatch) -> dict:
        """Speculative warm-up: plan ``batch`` WITHOUT executing it and
        enqueue its torch segments on the background compile executor at low
        priority, so a likely-next submission finds its programs warm.
        No-op ({} of zero counts) unless ``compile_async=True``.  Returns
        a status-count dict (``{"enqueued": n, "cached": m, ...}``)."""
        counts: dict = {}
        torch_be = self._backends.get("torch")
        if torch_be is None or self.plan_cache is None \
                or self.plan_cache.executor is None:
            return counts
        _sinks, sel, p, _cand, _rw, _n, _t = self.compile_batch(batch)
        for seg in p.segments:
            if seg.kind != "torch":
                continue
            status = torch_be.precompile_segment(seg, sel, cache=self.cache,
                                                 device=self.device)
            counts[status] = counts.get(status, 0) + 1
        return counts

    def close(self, timeout: float = 5.0) -> None:
        """Release background resources (the async compile executor).
        Safe to call on any session, including ones sharing an injected
        plan cache — the shutdown is idempotent."""
        if self.plan_cache is not None:
            self.plan_cache.close(timeout)
