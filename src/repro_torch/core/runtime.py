"""Execution runtime (paper §4.2–4.3).

Executes a scheduler :class:`Plan` segment by segment through pluggable
:class:`~repro_torch.core.backends.ExecutionBackend`\\ s: the runtime owns the
value store, cache handles, salvage state and preemption hooks, and each
backend-homogeneous :class:`~repro_torch.core.scheduler.Segment` is handed to
the backend registered for its kind —

* ``"python"`` (:class:`~repro_torch.core.backends.PythonThreadBackend`):
  per-op dispatch with cache probe before execution / insert-after for
  marked candidates (§4.3), late-bound physical impls (§4.2), inter-operator
  parallelism via a bounded thread pool, vmap variant batching, and
  intra-wave preemption polls;
* ``"torch"`` (:class:`~repro_torch.core.backends.TorchSegmentBackend`):
  the whole segment traced into ONE compiled program (tunable constants
  hoisted to arguments), reused across structurally identical plans
  through the shared :class:`~repro_torch.core.plan_cache.PlanCache`.

**The boundary between tiers** is the runtime's: before it calls an impl it
moves each input to that impl's side (:func:`to_tier`).  A ``"torch"`` impl
gets tensors on the session's device, a ``"python"`` impl (or an op with no
selected impl, which runs the python reference) host numpy.  Every copy
between the host and a CUDA device is counted with its bytes in
:data:`CROSSINGS`.  The inter-op threads share the current CUDA stream, so
a value produced on the card is complete before a later op reads it.  A
``"torch"`` impl that raises ends the run with :class:`ExecutionError`; it
is never retried on another tier.

Invariants preserved across backends: liveness-driven freeing of
intermediates no later than segment boundaries, and cooperative
preemption — when the caller installs a ``preempt_check``, the runtime
polls it at every segment/wave boundary (and between op completions
inside wide python waves), and, if it fires, abandons the run with
:class:`ExecutionPreempted` carrying every already-completed intermediate
(the *salvage*); a re-run passes that salvage back as ``preloaded`` so no
finished work executes twice, and a liveness rule (yield only after ≥1
newly-executed op) guarantees progress under repeated preemption.  This
is how the multi-tenant service yields a low-priority super-batch to
freshly queued higher-priority work without losing progress.

``Base`` / ``Base_par`` executors for the paper's baselines live in
benchmarks (they bypass the optimizer entirely).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import (FIRST_COMPLETED, ThreadPoolExecutor,
                                wait as _fwait)
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ..kernels.common import resolve_device
from .cache import IntermediateCache
from .dag import CONST, LazyOp, LazyRef
from .plan_cache import PlanCache
from .scheduler import Plan, Segment
from .selection import PhysicalImpl, reference_impl, vmap_group_for

# ---------------------------------------------------------------------------
# the boundary between tiers: host <-> device copies, counted with their
# bytes (read with crossings(), zeroed with reset_crossings())
# ---------------------------------------------------------------------------

CROSSINGS: dict[str, int] = {"to_device": 0, "to_device_bytes": 0,
                             "to_host": 0, "to_host_bytes": 0}
_CROSSINGS_LOCK = threading.Lock()


def count_crossing(direction: str, nbytes: int) -> None:
    with _CROSSINGS_LOCK:
        CROSSINGS[direction] += 1
        CROSSINGS[direction + "_bytes"] += int(nbytes)


def reset_crossings() -> None:
    with _CROSSINGS_LOCK:
        for key in CROSSINGS:
            CROSSINGS[key] = 0


def crossings() -> dict[str, int]:
    with _CROSSINGS_LOCK:
        return dict(CROSSINGS)


def to_host(value: Any) -> Any:
    """A tensor as host numpy (counted when it leaves a CUDA device);
    anything else unchanged."""
    if not isinstance(value, torch.Tensor):
        return value
    if value.device.type == "cuda":
        count_crossing("to_host", value.nbytes)
    return value.detach().cpu().numpy()


def to_device(value: Any, device: torch.device, *,
              float32: bool = True) -> Any:
    """A host array as a tensor on ``device`` (counted when it goes to a
    CUDA device); with ``float32`` a float64 host array becomes float32, as
    the reference's ``jnp.asarray`` makes it with x64 off.  A tensor already
    on ``device`` and a non-array value are left as they are."""
    if isinstance(value, torch.Tensor):
        if value.device == device:
            return value
        value = value.detach().cpu().numpy()
    if not isinstance(value, (np.ndarray, np.generic)):
        return value
    arr = np.asarray(value)
    if float32 and arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    elif not arr.flags.writeable:
        arr = arr.copy()            # torch.from_numpy needs a writable array
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        count_crossing("to_device", t.nbytes)
    return t.to(device)


_LINALG_LOCK = threading.Lock()
_LINALG_READY: set = set()         # guarded-by: _LINALG_LOCK


def linalg_ready(device: torch.device) -> None:
    """torch loads its CUDA linear-algebra backend at the first
    ``torch.linalg`` call, and that lazy load is not thread-safe: two
    inter-op threads making their first Cholesky at once raise "lazy wrapper
    should be called at most once".  The first call on a device is made
    here, under a lock: by the torch impls before their first linear
    algebra, and by the compiled-segment backend before a program's first
    call (its trace runs on fake tensors and loads nothing)."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    with _LINALG_LOCK:
        if device not in _LINALG_READY:
            eye = torch.eye(2, device=device)
            torch.linalg.cholesky(eye)
            torch.linalg.svd(eye)
            _LINALG_READY.add(device)


def tier_dtype(dtype) -> torch.dtype:
    """The dtype in which a traceable torch impl receives a value of
    ``dtype`` (a torch or numpy dtype, or its name): float64 as float32, as
    :func:`to_device` moves a host array for it; the rest as they are."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    else:
        name = str(np.dtype(dtype))
    return torch.float32 if name == "float64" else getattr(torch, name)


def to_tier(values: Sequence[Any], impl: Optional[PhysicalImpl],
            device: torch.device) -> list:
    """``values`` moved to the side of ``impl``'s tier: the device for a
    ``"torch"`` impl (float64 host arrays as float32 for a traceable one),
    host numpy for any other impl and for an op with no selected impl."""
    if impl is not None and impl.backend == "torch":
        return [to_device(v, device, float32=impl.traceable) for v in values]
    return [to_host(v) for v in values]


@dataclass
class RunReport:
    wall_time_s: float = 0.0
    ops_executed: int = 0
    ops_from_cache: int = 0
    ops_salvaged: int = 0   # restored from a preempted run's salvage
    waves: int = 0
    per_backend: dict = field(default_factory=dict)
    # op signature -> "cache" | "salvage" | backend name; lets multi-tenant
    # callers (service telemetry) attribute work per pipeline after merges
    sig_source: dict = field(default_factory=dict)
    # compiled plan-segment cache outcomes for THIS run (incremented by the
    # compiled-segment backend): trace/compile skipped vs paid — surfaced on
    # lifecycle trace hops so a per-job record shows whether it hit warm
    # plans
    plan_cache_hits: int = 0
    plan_cache_misses: int = 0
    # rounds dispatched per-op while an async compile ran off the critical
    # path (compile_async): cold-start cost shifted, not paid
    plan_cache_fallback_rounds: int = 0
    # op signature -> where each output lives: a tensor's device ("cuda:0",
    # "cpu"), "numpy" for a host array, else the value's type name
    placement: dict = field(default_factory=dict)


def _where(value: Any) -> str:
    if isinstance(value, torch.Tensor):
        return str(value.device)
    if isinstance(value, (np.ndarray, np.generic)):
        return "numpy"
    return type(value).__name__


class ExecutionError(RuntimeError):
    def __init__(self, op: LazyOp, cause: Exception):
        super().__init__(f"executing {op.op_name}#{op.uid}: {cause!r}")
        self.op = op
        self.cause = cause

    def __reduce__(self):
        # default exception pickling replays __init__ with ``args`` (the
        # formatted message), which doesn't match this signature; the
        # fabric's result codec needs the (op, cause) form to survive the
        # wire so tenants still see .op/.cause across the shard boundary
        return (ExecutionError, (self.op, self.cause))


class ExecutionPreempted(Exception):
    """A cooperative yield, not a failure: the run stopped at a wave
    boundary because higher-priority work arrived.  ``salvage`` maps each
    completed op signature to its outputs tuple; feeding it back to a new
    :class:`Runtime` via ``preloaded`` resumes without recomputation."""

    def __init__(self, salvage: dict, waves_done: int):
        super().__init__(f"preempted after {waves_done} wave(s); "
                         f"{len(salvage)} intermediates salvaged")
        self.salvage = salvage
        self.waves_done = waves_done

    def __reduce__(self):
        # default exception pickling replays __init__ with ``args`` (the
        # formatted message) — a TypeError at *unpickle* time on the far
        # side of a process boundary.  Keep the (salvage, waves_done) form
        # so a preemption yield crossing the proc-fabric wire (worker →
        # supervisor diagnostics) survives with its payload intact.
        return (ExecutionPreempted, (self.salvage, self.waves_done))


def execute_reference(op: LazyOp, inputs: Sequence[Any]) -> tuple:
    """Reference evaluator (used by constant folding and as fallback)."""
    if op.op_class == CONST:
        return (op.spec["value"],)
    impl = reference_impl(op.op_name)
    if impl is None:
        fn = op.spec.get("fn")
        if callable(fn):
            out = fn(*inputs, **dict(op.spec.get("kwargs", {})))
            return out if isinstance(out, tuple) else (out,)
        raise KeyError(f"no implementation registered for {op.op_name!r}")
    return impl.fn(op, inputs)


class Runtime:
    def __init__(self,
                 cache: Optional[IntermediateCache] = None,
                 cache_candidates: Optional[set] = None,
                 parallel: bool = True,
                 preloaded: Optional[dict] = None,
                 preempt_check: Optional[Callable[[], bool]] = None,
                 sig_tenant: Optional[dict] = None,
                 plan_cache: Optional[PlanCache] = None,
                 backends: Optional[dict] = None,
                 compiled_segments: bool = True,
                 device=None):
        # the session's device: "torch" impls get their inputs there
        self.device = resolve_device(device)
        self.cache = cache
        self.cache_candidates = cache_candidates or set()
        self.parallel = parallel
        # sig → outputs tuple salvaged from a preempted run of this DAG
        self.preloaded = preloaded or {}
        # polled at segment/wave boundaries; True → raise ExecutionPreempted
        self.preempt_check = preempt_check
        # sig → tenant owning the op (multi-tenant cache charge accounting)
        self.sig_tenant = sig_tenant or {}
        # segment kind → ExecutionBackend; long-lived callers (the service)
        # inject a shared set so the plan cache spans tenants and runs
        if backends is None:
            from .backends import make_backends   # lazy: avoids a cycle
            backends = make_backends(plan_cache,
                                     compiled=compiled_segments)
        self.backends = backends
        self._values: dict[str, Any] = {}      # "sig:index" -> value
        self._keys_by_sig: dict[str, list[str]] = {}   # sig -> stored keys
        self._skips: set = set()               # resume-skippable ops
        self._pool: Optional[ThreadPoolExecutor] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def _resolve_impl(self, op: LazyOp,
                      selection: dict[str, PhysicalImpl]
                      ) -> Callable[[LazyOp, Sequence[Any]], tuple]:
        impl = selection.get(op.signature)
        if impl is not None:
            return impl.fn
        return lambda o, ins: execute_reference(o, ins)

    def _gather_inputs(self, op: LazyOp) -> list:
        with self._lock:
            return [self._values[r.signature] for r in op.inputs]

    def _store(self, op: LazyOp, outputs: tuple) -> None:
        with self._lock:
            keys = self._keys_by_sig.setdefault(op.signature, [])
            for i, v in enumerate(outputs):
                key = f"{op.signature}:{i}"
                self._values[key] = v
                if key not in keys:
                    keys.append(key)

    # -- shared backend helpers (both backends mutate runtime state
    # through these, so the semantics live in exactly one place) --------
    def _mark_salvaged(self, op: LazyOp, report: RunReport) -> None:
        """Record an op restored from (or skipped thanks to) preemption
        salvage — completed work is never redone on a resume."""
        with self._lock:
            report.ops_salvaged += 1
            report.sig_source[op.signature] = "salvage"

    def _free_wave(self, wave) -> None:
        """Liveness freeing: drop dead intermediates by their exact
        per-signature key lists (prefix/equality scans can collide and
        never matched the "sig" form, which is never stored)."""
        with self._lock:
            for sig in wave.free_after:
                for key in self._keys_by_sig.pop(sig, ()):
                    self._values.pop(key, None)

    def _try_cache_hit(self, op: LazyOp, report: RunReport
                       ) -> Optional[tuple]:
        """ONE tenant-aware intermediate-cache probe; on a hit the value
        is stored and attributed (hit count, sig_source, cross-tenant
        accounting inside the cache) in a single place — every backend's
        probe goes through here so the attribution can never drift."""
        if self.cache is None or not op.cacheable:
            return None
        sig = op.signature
        hit = self.cache.get(sig, tenant=self.sig_tenant.get(sig))
        if hit is None:
            return None
        self._store(op, hit)
        with self._lock:
            report.ops_from_cache += 1
            report.sig_source[sig] = "cache"
        return hit

    def _run_ops_parallel(self, todo: list, selection: dict,
                          report: RunReport) -> None:
        """Execute mutually independent ops — on the bounded pool when the
        plan allows, with cooperative-preemption polls between op
        completions (wide waves can run for many seconds); queued ops are
        cancelled on a yield, in-flight ones drained, and everything
        finished goes into the salvage."""
        pool = self._pool
        if pool is not None and len(todo) > 1:
            pending = {pool.submit(self._run_op, op, selection, report)
                       for op in todo}
            while pending:
                done, pending = _fwait(pending,
                                       return_when=FIRST_COMPLETED)
                for f in done:
                    f.result()
                if pending and self._should_yield(report):
                    running = [f for f in pending if not f.cancel()]
                    for f in running:
                        f.result()
                    raise self._preempted(report)
        else:
            for i, op in enumerate(todo):
                if i and self._should_yield(report):
                    raise self._preempted(report)
                self._run_op(op, selection, report)

    def _run_op(self, op: LazyOp, selection: dict, report: RunReport) -> None:
        sig = op.signature
        if sig in self.preloaded:
            # salvaged from a preempted run — completed work is never redone
            self._store(op, self.preloaded[sig])
            self._mark_salvaged(op, report)
            return
        if self._try_cache_hit(op, report) is not None:
            return
        impl = selection.get(sig)
        inputs = to_tier(self._gather_inputs(op), impl, self.device)
        fn = self._resolve_impl(op, selection)
        try:
            outputs = fn(op, inputs)
        except Exception as e:  # noqa: BLE001 — surfaced with op context
            raise ExecutionError(op, e) from e
        if not isinstance(outputs, tuple):
            outputs = (outputs,)
        if len(outputs) != op.n_outputs:
            raise ExecutionError(
                op, ValueError(f"impl returned {len(outputs)} outputs, "
                               f"declared {op.n_outputs}"))
        self._store(op, outputs)
        backend = impl.backend if impl else "ref"
        with self._lock:
            report.placement[sig] = tuple(_where(v) for v in outputs)
            report.ops_executed += 1
            report.per_backend[backend] = report.per_backend.get(backend, 0) + 1
            report.sig_source[sig] = backend
        if (self.cache is not None and op.cacheable
                and sig in self.cache_candidates):
            self.cache.put(sig, outputs, tenant=self.sig_tenant.get(sig))

    # -- variant batching (§Perf H3.4) ---------------------------------
    def _batch_variants(self, wave_ops: list, selection: dict,
                        report: RunReport) -> list:
        """Execute homogeneous hyperparameter-variant groups as one vmapped
        call; returns the ops still needing individual execution."""
        groups: dict[tuple, list] = {}
        rest = []
        for op in wave_ops:
            reg = vmap_group_for(op.op_name)
            impl = selection.get(op.signature)
            if reg is None or impl is None or impl.backend != "torch" \
                    or not impl.vmappable \
                    or op.signature in self.preloaded:
                rest.append(op)
                continue
            key_fn, _ = reg
            groups.setdefault((op.op_name, key_fn(op)), []).append(op)
        for (op_name, _), ops_ in groups.items():
            if len(ops_) < 2:
                rest.extend(ops_)
                continue
            todo = []
            for op in ops_:
                # ONE tenant-aware get, result used directly: a raw
                # membership probe would skip cross-tenant hit attribution
                # for vmap-grouped ops and could race an eviction between
                # the probe and the use
                if self._try_cache_hit(op, report) is not None:
                    continue
                todo.append(op)
            if len(todo) < 2:
                rest.extend(todo)   # no group left worth one vmapped call
                continue
            _, batch_fn = vmap_group_for(op_name)
            inputs = to_tier(self._gather_inputs(todo[0]),
                             selection.get(todo[0].signature), self.device)
            try:
                outs = batch_fn(todo, inputs)
            except Exception as e:  # noqa: BLE001 — surfaced with op context
                raise ExecutionError(todo[0], e) from e
            for op, out in zip(todo, outs):
                self._store(op, out)
                if (self.cache is not None and op.cacheable
                        and op.signature in self.cache_candidates):
                    self.cache.put(op.signature, out,
                                   tenant=self.sig_tenant.get(op.signature))
            with self._lock:
                report.ops_executed += len(todo)
                report.per_backend["torch-vmap"] = \
                    report.per_backend.get("torch-vmap", 0) + len(todo)
                for op, out in zip(todo, outs):
                    report.sig_source[op.signature] = "torch-vmap"
                    report.placement[op.signature] = tuple(
                        _where(v) for v in out)
        return rest

    # ------------------------------------------------------------------
    def _resume_skips(self, plan: Plan, sinks: Sequence[LazyRef]) -> set:
        """Ops a post-preemption resume can skip entirely.

        The preempted run freed intermediates liveness-driven, so the
        salvage only holds values that were still live at the yield point.
        An op absent from the salvage whose every consumer IS salvaged (or
        transitively skippable) completed before the yield and its output
        is dead — re-executing it would redo finished work.  Computed by a
        reverse-topological sweep: an op must run iff it is an un-salvaged
        sink or feeds an op that runs."""
        sink_ops = {r.op.signature for r in sinks}
        needed: set = set()     # input sigs of ops that will execute
        skips: set = set()
        for wave in reversed(plan.waves):
            for op in wave.ops:
                sig = op.signature
                used = sig in sink_ops or sig in needed
                if sig in self.preloaded:
                    if not used:   # salvaged but dead: don't even store it
                        skips.add(sig)
                    continue
                if used:
                    for r in op.inputs:
                        needed.add(r.op.signature)
                else:
                    skips.add(sig)
        return skips

    def _should_yield(self, report: RunReport) -> bool:
        """Yield only after real progress (≥1 newly-executed op this
        dispatch) so repeated preemption can never livelock a job."""
        return (self.preempt_check is not None and report.ops_executed > 0
                and self.preempt_check())

    def _preempted(self, report: RunReport) -> ExecutionPreempted:
        with self._lock:
            salvage = {sig: tuple(self._values[k] for k in keys)
                       for sig, keys in self._keys_by_sig.items()}
        # carry forward salvage not yet replayed (second yield of a resume)
        salvage.update(self.preloaded)
        return ExecutionPreempted(salvage, waves_done=report.waves)

    def execute(self, sinks: Sequence[LazyRef], plan: Plan,
                selection: dict[str, PhysicalImpl]) -> tuple[list, RunReport]:
        report = RunReport()
        self._skips = (self._resume_skips(plan, sinks)
                       if self.preloaded else set())
        t0 = time.perf_counter()
        self._pool = None
        if self.parallel and plan.inter_op_parallelism > 1:
            self._pool = ThreadPoolExecutor(
                max_workers=plan.inter_op_parallelism)
        # plans from older callers (or hand-built tests) may predate
        # segmentation — treat the whole wave list as one per-op segment
        segments = plan.segments or [Segment(kind="python",
                                             waves=list(plan.waves))]
        python_backend = self.backends["python"]
        try:
            for seg in segments:
                # cooperative yield point at the segment boundary — the
                # salvage carries every completed intermediate to the
                # requeued re-run (python segments add wave/op-level polls)
                if self._should_yield(report):
                    raise self._preempted(report)
                backend = self.backends.get(seg.kind, python_backend)
                backend.execute_segment(self, seg, selection, report)
        finally:
            if self._pool is not None:
                # cancel queued work and wait for in-flight ops so an error
                # mid-wave can't leak threads still mutating self._values
                self._pool.shutdown(wait=True, cancel_futures=True)
                self._pool = None
        with self._lock:
            results = [self._values[r.signature] for r in sinks]
        report.wall_time_s = time.perf_counter() - t0
        return results, report
