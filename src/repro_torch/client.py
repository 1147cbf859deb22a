"""One submission surface: :class:`StratumClient` (the port of
``repro.client``, its local target).

The paper's core claim is that stratum "decouples pipeline execution from
planning" behind a *single* integration point agents can target.  Agents
program against two objects —

* :class:`SubmitOptions` — a frozen value object carrying everything a
  submission can ask for (``priority``, ``deadline_s``, ``affinity``,
  ``tenant``, ``tags``);
* :class:`StratumClient` — ``submit(batch, options) -> PipelineFuture``
  and ``run(sink)``.

The port has the ``"local"`` target (:class:`LocalTarget`, one
:class:`repro_torch.core.Stratum` session in this process).  The
``"service"`` target is ``ROADMAP.md`` A2e and the ``"fabric"`` target A5:
``connect`` raises for them until they land.  :class:`Priority`,
:class:`DeadlineExceeded` and :class:`PipelineFuture` are copies of the
reference's ``repro.service`` ones, which the local target needs; they move
to the port's ``service/`` with A2e.

Construction is uniform: one layered :class:`StratumConfig` (``optimizer``
/ ``runtime`` / ``cache`` / ``service`` sections), whose ``runtime.device``
is the session's torch device::

    from repro_torch.client import StratumConfig, SubmitOptions, connect

    cfg = StratumConfig.make(memory_budget_bytes=1 << 30, device="cpu")
    with connect("local", cfg) as client:
        results, report = client.submit(batch, SubmitOptions(
            deadline_s=60.0, tags=("probe",))).result()
"""

from __future__ import annotations

import itertools
import threading
import time
from abc import ABC, abstractmethod
from concurrent.futures import CancelledError
from dataclasses import dataclass, field, replace
from enum import IntEnum
from typing import Any, Callable, Optional, Tuple

from .core.analysis import AnalysisError, AnalysisReport
from .core.api import (ALL_FEATURES, _DEFAULT_CACHE_FRACTION,
                       _DEFAULT_PLAN_CACHE_ENTRIES, Stratum)
from .core.fusion import PipelineBatch
from .core.dag import LazyRef

__all__ = [
    "AnalysisError", "AnalysisReport", "CacheConfig", "DeadlineExceeded",
    "LocalTarget", "OptimizerConfig", "PipelineFuture", "Priority",
    "RuntimeConfig", "ServiceTuning", "StratumClient", "StratumConfig",
    "SubmitOptions", "connect",
]


# ---------------------------------------------------------------------------
# what the local target needs of repro.service (copies; ROADMAP.md A2e)
# ---------------------------------------------------------------------------

class Priority(IntEnum):
    """Job priority band; lower value = more urgent."""

    INTERACTIVE = 0
    BATCH = 1
    SCAVENGER = 2


class DeadlineExceeded(RuntimeError):
    """The job's ``deadline_s`` passed before a result could be produced:
    raised out of ``PipelineFuture.result()`` when a local run finishes
    past its deadline."""


_PENDING = "pending"
_RUNNING = "running"
_DONE = "done"
_CANCELLED = "cancelled"


class PipelineFuture:
    """Result handle for one submitted :class:`PipelineBatch`."""

    def __init__(self, job_id: int, tenant: str,
                 priority: Priority = Priority.BATCH):
        self.job_id = job_id
        self.tenant = tenant
        self.priority = priority
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._state = _PENDING
        self._results: Optional[dict[str, Any]] = None
        self._report: Any = None
        self._error: Optional[BaseException] = None
        self._callbacks: list[Callable[["PipelineFuture"], None]] = []
        self._cancel_hook: Optional[Callable[[int], bool]] = None

    # -- service side ------------------------------------------------------
    def _mark_running(self) -> bool:
        """Claim the job for execution.  True for pending jobs and for jobs
        already running (the failure-isolation retry re-executes innocent
        bystanders of a poisoned super-batch); False once cancelled/done."""
        with self._lock:
            if self._state == _PENDING:
                self._state = _RUNNING
                return True
            return self._state == _RUNNING

    def _set_result(self, results: dict[str, Any], report: Any) -> None:
        with self._lock:
            if self._state == _CANCELLED:
                return
            self._results, self._report = results, report
            self._state = _DONE
        self._finish()

    def _set_exception(self, exc: BaseException) -> None:
        with self._lock:
            if self._state == _CANCELLED:
                return
            self._error = exc
            self._state = _DONE
        self._finish()

    def _set_cancelled(self) -> None:
        with self._lock:
            if self._state == _DONE:
                return
            self._state = _CANCELLED
        self._finish()

    def _finish(self) -> None:
        self._event.set()
        callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            try:
                cb(self)
            except Exception:
                pass

    # -- agent side --------------------------------------------------------
    def done(self) -> bool:
        return self._event.is_set()

    def cancelled(self) -> bool:
        with self._lock:
            return self._state == _CANCELLED

    def cancel(self) -> bool:
        """Cancel iff the job is still queued (never pre-empts running work).

        Returns True when the job was removed from the queue."""
        hook = self._cancel_hook
        if hook is None:
            return False
        return hook(self.job_id)

    def result(self, timeout: Optional[float] = None
               ) -> tuple[dict[str, Any], Any]:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"job {self.job_id} (tenant {self.tenant!r}) not done "
                f"after {timeout}s")
        with self._lock:
            if self._state == _CANCELLED:
                raise CancelledError(f"job {self.job_id} was cancelled")
            if self._error is not None:
                raise self._error
            return self._results, self._report

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        if not self._event.wait(timeout):
            raise TimeoutError(f"job {self.job_id} not done after {timeout}s")
        with self._lock:
            if self._state == _CANCELLED:
                raise CancelledError(f"job {self.job_id} was cancelled")
            return self._error

    def add_done_callback(self, fn: Callable[["PipelineFuture"], None]
                          ) -> None:
        run_now = False
        with self._lock:
            if self._event.is_set():
                run_now = True
            else:
                self._callbacks.append(fn)
        if run_now:
            fn(self)


# ---------------------------------------------------------------------------
# submission options
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SubmitOptions:
    """Everything one submission can ask for, in one frozen value object.

    * ``priority`` — scheduling band (see ``docs/SCHEDULING.md``);
    * ``deadline_s`` — SLO relative to submission: deadline-aware targets
      schedule EDF within the band, refuse to coalesce the job once its
      slack is tight, and shed it after expiry (the future then raises
      :class:`DeadlineExceeded`); must be positive when given;
    * ``affinity`` — opaque routing-pin key on a sharded target (all
      submissions sharing it land on one shard's warm cache); ignored
      where there is only one place to run;
    * ``tenant`` — overrides the client's default tenant for this job;
    * ``tags`` — opaque strings echoed back on the job report (and across
      the fabric wire), for caller-side bookkeeping;
    * ``verify`` — per-submit override of the target's pre-flight static
      analysis default (``ServiceTuning.admission_analysis``): ``True``
      analyzes the batch before admission and raises
      :class:`~repro_torch.core.analysis.AnalysisError` from ``submit`` when it
      is statically invalid, ``False`` skips the check, ``None`` defers
      to the target's configured default.
    """

    priority: Priority = Priority.BATCH
    deadline_s: Optional[float] = None
    affinity: Optional[str] = None
    tenant: Optional[str] = None
    tags: Tuple[str, ...] = ()
    verify: Optional[bool] = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "priority", Priority(self.priority))
        object.__setattr__(self, "tags", tuple(self.tags))
        if self.verify is not None and not isinstance(self.verify, bool):
            raise ValueError(
                f"verify must be True, False or None, got {self.verify!r}")
        if self.deadline_s is not None and not self.deadline_s > 0:
            raise ValueError(
                f"deadline_s must be positive, got {self.deadline_s!r} "
                f"(a deadline in the past cannot be met)")

    def with_(self, **changes) -> "SubmitOptions":
        """Functional update (frozen dataclass convenience)."""
        return replace(self, **changes)


# ---------------------------------------------------------------------------
# layered configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OptimizerConfig:
    """What the optimizer pipeline is allowed to do."""
    enable: Tuple[str, ...] = tuple(ALL_FEATURES)
    platform: str = ""           # "" = the device's; "cpu"/"gpu" force it


@dataclass(frozen=True)
class RuntimeConfig:
    """Execution resources and the compiled-segment regime."""
    memory_budget_bytes: int = 8 << 30
    hardware_threads: int = 0            # 0 → os.cpu_count()
    # the session's torch device: None = the CUDA device (raising when there
    # is none); "cpu" runs the torch tier on the CPU
    device: Optional[str] = None
    jit_cache_dir: Optional[str] = None
    compiled_segments: bool = True
    plan_cache_entries: int = _DEFAULT_PLAN_CACHE_ENTRIES
    # bound a compiled segment's est_time so it can never delay an
    # interactive/deadline preempt by more than one slice (None = off)
    segment_time_budget_s: Optional[float] = None
    # compiled-segment "next gear" (docs/ARCHITECTURE.md §7), all off by
    # default: compile_async moves trace+jit off the critical path (first
    # touch of a new structural signature dispatches per-op while a
    # background thread compiles); batch_variants traces homogeneous
    # hyperparameter-variant groups as ONE vmapped solve; a positive
    # speculative_depth lets predictors (Session.precompile /
    # AsyncAIDESearch(speculate=True)) enqueue that many likely-next
    # shapes on the compile executor's low-priority lane
    compile_async: bool = False
    batch_variants: bool = False
    speculative_depth: int = 0


@dataclass(frozen=True)
class CacheConfig:
    """The shared intermediate cache."""
    fraction: float = _DEFAULT_CACHE_FRACTION   # of the memory budget
    spill_dir: Optional[str] = None
    arbitration: str = "quota"                  # "quota" | "lru"
    tenant_quota_fraction: float = 0.5


@dataclass(frozen=True)
class ServiceTuning:
    """Service/fabric-only knobs: admission, coalescing, scheduling,
    sharding.  Ignored by the local target (which has no queue)."""
    max_queued_total: int = 1024
    max_queued_per_tenant: int = 256
    # pre-flight static analysis at admission (docs/ANALYSIS.md): reject
    # statically-invalid pipelines at submit with AnalysisError instead of
    # failing them mid-execution.  SubmitOptions.verify overrides per job.
    admission_analysis: bool = False
    coalesce_window_s: float = 0.02
    coalesce_max_jobs: int = 16
    max_jobs_per_tenant_per_round: int = 2
    priority_aware: bool = True
    priority_weights: Optional[dict] = None
    aging_s: Optional[float] = 5.0
    preemption: bool = True
    max_preemptions_per_job: int = 8
    deadline_aware: bool = True
    deadline_tight_slack_s: float = 0.25
    n_executors: int = 2
    # fabric target only
    n_shards: int = 2
    routing: str = "sources"
    vnodes: int = 64
    # out-of-process fabric: host each shard in its own worker process
    # (real cores, real crash isolation) behind the same Session API
    processes: bool = False
    # elastic shard bounds (min, max); None = fixed n_shards.  Only
    # meaningful with processes=True — shards are spawned under
    # queue/deadline pressure and drained (with a warm cache hand-off to
    # the ring successor) when idle
    autoscale: Optional[Tuple[int, int]] = None
    worker_heartbeat_s: float = 0.25
    worker_heartbeat_timeout_s: float = 5.0
    # observability (docs/OBSERVABILITY.md): trace=True records per-job
    # lifecycle hop logs (returned on reports); trace_dir additionally
    # appends every hop to per-process JSONL event logs
    trace: bool = False
    trace_dir: Optional[str] = None
    # windowed throughput/attainment collector geometry
    window_s: float = 1.0
    n_windows: int = 32
    # closed-loop control (docs/SCHEDULING.md §5): a ControlPolicy turns
    # on the feedback controller that retunes admission limits and WFQ
    # weights from the windowed collector (and, with processes=True, is
    # shipped to every worker shard inside its ServiceConfig); None =
    # every knob stays at its configured constant
    control: Optional[Any] = None      # a ControlPolicy (service, A2e)


@dataclass(frozen=True)
class StratumConfig:
    """Layered configuration every target builds from.

    Sections: ``optimizer`` (feature toggles), ``runtime`` (budgets,
    threads, compiled segments), ``cache`` (shared intermediate cache),
    ``service`` (queueing/scheduling/sharding — service and fabric only).

    ``StratumConfig.make(...)`` accepts the most common scalars flat and
    sorts them into sections, so simple callers never spell a section out.
    """

    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    cache: CacheConfig = field(default_factory=CacheConfig)
    service: ServiceTuning = field(default_factory=ServiceTuning)

    # -- ergonomic flat constructor ---------------------------------------
    @classmethod
    def make(cls, **flat) -> "StratumConfig":
        """Build a config from flat kwargs, routing each to its section:
        ``StratumConfig.make(memory_budget_bytes=1 << 30, n_shards=4)``."""
        sections = {"optimizer": OptimizerConfig,
                    "runtime": RuntimeConfig,
                    "cache": CacheConfig,
                    "service": ServiceTuning}
        by_section: dict[str, dict] = {name: {} for name in sections}
        for key, value in flat.items():
            if key in sections:               # a whole section object
                by_section[key] = value
                continue
            for name, section_cls in sections.items():
                if key in section_cls.__dataclass_fields__:
                    by_section[name][key] = value
                    break
            else:
                raise TypeError(f"unknown config field {key!r}")
        built = {name: (v if isinstance(v, sections[name])
                        else sections[name](**v))
                 for name, v in by_section.items()}
        return cls(**built)

    # -- bridges to the legacy constructors -------------------------------
    def stratum_kwargs(self) -> dict:
        """Keyword form for :class:`repro_torch.core.Stratum` (local target)."""
        kw: dict[str, Any] = {
            "memory_budget_bytes": self.runtime.memory_budget_bytes,
            "platform": self.optimizer.platform,
            "enable": self.optimizer.enable,
            "hardware_threads": self.runtime.hardware_threads,
            "jit_cache_dir": self.runtime.jit_cache_dir,
            "compiled_segments": self.runtime.compiled_segments,
            "segment_time_budget_s": self.runtime.segment_time_budget_s,
            "device": self.runtime.device,
        }
        # pass cross-feature kwargs only where meaningful, so building a
        # client never trips Stratum's config validation warnings
        if "cache" in self.optimizer.enable:
            kw["cache_fraction"] = self.cache.fraction
            kw["spill_dir"] = self.cache.spill_dir
        if self.runtime.compiled_segments:
            kw["plan_cache_entries"] = self.runtime.plan_cache_entries
            kw["compile_async"] = self.runtime.compile_async
            kw["batch_variants"] = self.runtime.batch_variants
            if self.runtime.compile_async:
                kw["speculative_depth"] = self.runtime.speculative_depth
        return kw

    def service_config(self):
        """The service's config: the service target is ROADMAP.md A2e."""
        raise NotImplementedError(_NOT_PORTED["service"])


# ---------------------------------------------------------------------------
# the client protocol
# ---------------------------------------------------------------------------

class StratumClient(ABC):
    """Target-independent submission surface.

    ``submit`` is non-blocking on queued targets and returns a
    :class:`PipelineFuture` on every target, so
    agent code written against a client runs unchanged on a laptop-local
    session, a shared multi-tenant service, or a sharded fabric."""

    target: str = "abstract"

    def __init__(self, config: Optional[StratumConfig] = None,
                 tenant: str = "default"):
        self.config = config if config is not None else StratumConfig()
        self.tenant = tenant
        self._closed = False

    # -- core surface ------------------------------------------------------
    @abstractmethod
    def submit(self, batch: PipelineBatch,
               options: Optional[SubmitOptions] = None) -> PipelineFuture:
        """Submit one batch; resolves to ``(name → value, report)``."""

    def run_batch(self, batch: PipelineBatch,
                  options: Optional[SubmitOptions] = None,
                  timeout: Optional[float] = None):
        """Blocking convenience: ``submit(...).result(timeout)``."""
        return self.submit(batch, options).result(timeout)

    def run(self, sink: LazyRef, name: str = "pipeline_0",
            options: Optional[SubmitOptions] = None,
            timeout: Optional[float] = None):
        """Run a single pipeline; returns ``(value, report)``."""
        results, report = self.run_batch(PipelineBatch([sink], [name]),
                                         options, timeout)
        return results[name], report

    def session(self, tenant: str) -> "_ClientSession":
        """A tenant-scoped view of this client (AsyncAIDESearch drives
        one per agent)."""
        return _ClientSession(self, tenant)

    def precompile(self, batch: PipelineBatch) -> dict:
        """Speculative warm-up hint: plan ``batch`` without executing it
        and enqueue its compiled-segment builds at low priority (see
        ``compile_async`` / ``speculative_depth``).  Targets that cannot
        honor the hint return ``{}`` — it is never an error to guess."""
        return {}

    def analyze(self, batch: PipelineBatch, *,
                feasibility: bool = True) -> AnalysisReport:
        """Pre-flight static analysis of ``batch`` without executing it
        (see ``docs/ANALYSIS.md``): wiring/schema validation, shape and
        dtype inference, pipeline lint, and — with ``feasibility=True`` —
        compile-feasibility classification of the planned segments.
        Returns a typed :class:`~repro_torch.core.analysis.AnalysisReport`;
        never raises on an invalid pipeline (call
        ``report.raise_if_invalid()`` for the raising form)."""
        raise NotImplementedError  # pragma: no cover - every target overrides

    # -- observability / lifecycle ----------------------------------------
    @property
    @abstractmethod
    def telemetry(self):
        """Object with ``snapshot()`` / ``global_snapshot()`` /
        ``report()`` — uniform across targets."""

    @property
    def traces(self):
        """The target's client-side
        trace sink when lifecycle
        tracing is available (service/fabric targets), else ``None``."""
        return None

    def close(self) -> None:
        self._closed = True

    def __enter__(self) -> "StratumClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _resolve(self, options: Optional[SubmitOptions]) -> SubmitOptions:
        if self._closed:
            raise RuntimeError(f"{self.target} client is closed")
        opts = options if options is not None else SubmitOptions()
        if opts.tenant is None:
            opts = opts.with_(tenant=self.tenant)
        return opts


class _ClientSession:
    """Tenant-pinning adapter: ``submit(batch, options)`` with the
    session's tenant filled in.  Duck-compatible with
    :class:`repro.service.Session` (the service target, ROADMAP.md A2e)
    for drivers like AsyncAIDESearch."""

    def __init__(self, client: StratumClient, tenant: str):
        self._client = client
        self.tenant = tenant

    def submit(self, batch: PipelineBatch,
               options: Optional[SubmitOptions] = None,
               **legacy) -> PipelineFuture:
        opts = options if options is not None else SubmitOptions(**legacy)
        if opts.tenant is None:
            opts = opts.with_(tenant=self.tenant)
        return self._client.submit(batch, opts)

    def run_batch(self, batch: PipelineBatch,
                  timeout: Optional[float] = None,
                  options: Optional[SubmitOptions] = None, **legacy):
        return self.submit(batch, options, **legacy).result(timeout)

    def precompile(self, batch: PipelineBatch) -> dict:
        return self._client.precompile(batch)

    def analyze(self, batch: PipelineBatch, *, feasibility: bool = True):
        return self._client.analyze(batch, feasibility=feasibility)

    @property
    def telemetry(self) -> dict:
        return self._client.telemetry.snapshot().get(self.tenant, {})


# ---------------------------------------------------------------------------
# local target
# ---------------------------------------------------------------------------

class _LocalTelemetry:
    """Minimal telemetry parity for the queueless local target."""

    def __init__(self) -> None:
        self._tenants: dict[str, dict] = {}
        self.deadline_jobs = 0
        self.deadline_met = 0

    def record(self, tenant: str, met: Optional[bool]) -> None:
        t = self._tenants.setdefault(
            tenant, {"jobs_submitted": 0, "jobs_completed": 0,
                     "deadline_jobs": 0, "deadline_met": 0,
                     "deadline_shed": 0})
        t["jobs_submitted"] += 1
        t["jobs_completed"] += 1
        if met is not None:
            t["deadline_jobs"] += 1
            self.deadline_jobs += 1
            if met:
                t["deadline_met"] += 1
                self.deadline_met += 1

    def snapshot(self) -> dict:
        return {t: dict(v) for t, v in self._tenants.items()}

    def global_snapshot(self) -> dict:
        return {"deadline": {
            "jobs": self.deadline_jobs, "met": self.deadline_met,
            "shed": 0,
            "attainment": (self.deadline_met / self.deadline_jobs
                           if self.deadline_jobs else 1.0)}}

    def report(self) -> str:
        g = self.global_snapshot()["deadline"]
        return (f"local: {sum(v['jobs_completed'] for v in self._tenants.values())} "
                f"run(s); deadlines {g['met']}/{g['jobs']} met")


class LocalTarget(StratumClient):
    """In-process target: one optimizing :class:`Stratum` session.

    ``submit`` executes synchronously (there is no queue to defer into)
    and returns an already-resolved future, so caller code written for
    the async targets — including its ``DeadlineExceeded`` handling —
    works unchanged.  ``priority`` and ``affinity`` are accepted and
    ignored: with one runner and no peers there is nothing to order or
    pin."""

    target = "local"

    def __init__(self, config: Optional[StratumConfig] = None,
                 tenant: str = "default",
                 stratum: Optional[Stratum] = None):
        super().__init__(config, tenant)
        self._stratum = (stratum if stratum is not None
                         else Stratum(**self.config.stratum_kwargs()))
        self._job_ids = itertools.count()
        self._telemetry = _LocalTelemetry()

    def submit(self, batch: PipelineBatch,
               options: Optional[SubmitOptions] = None) -> PipelineFuture:
        opts = self._resolve(options)
        do_verify = (opts.verify if opts.verify is not None
                     else self.config.service.admission_analysis)
        if do_verify:
            # raise synchronously, matching the queued targets' raise-at-
            # submit admission semantics (AdmissionError parity)
            self._stratum.analyze_batch(
                batch, feasibility=False).raise_if_invalid()
        future = PipelineFuture(next(self._job_ids), opts.tenant,
                                opts.priority)
        t0 = time.perf_counter()
        try:
            results, report = self._stratum.run_batch(batch)
        except Exception as e:  # noqa: BLE001 — parity: errors via future
            future._set_exception(e)
            return future
        met: Optional[bool] = None
        if opts.deadline_s is not None:
            met = (time.perf_counter() - t0) <= opts.deadline_s
            if not met:
                self._telemetry.record(opts.tenant, met)
                future._set_exception(DeadlineExceeded(
                    f"local run finished after its {opts.deadline_s}s "
                    f"deadline"))
                return future
        self._telemetry.record(opts.tenant, met)
        future._set_result(results, report)
        return future

    def precompile(self, batch: PipelineBatch) -> dict:
        return self._stratum.precompile_batch(batch)

    def analyze(self, batch: PipelineBatch, *,
                feasibility: bool = True) -> AnalysisReport:
        return self._stratum.analyze_batch(batch, feasibility=feasibility)

    @property
    def telemetry(self) -> _LocalTelemetry:
        return self._telemetry

    @property
    def stratum(self) -> Stratum:
        """The wrapped session (plan-cache snapshots, ablation hooks)."""
        return self._stratum

    def close(self) -> None:
        if not self._closed:
            self._stratum.close()
        super().close()


# ---------------------------------------------------------------------------
# factory
# ---------------------------------------------------------------------------

TARGETS = {"local": LocalTarget}

_NOT_PORTED = {
    "service": "the multi-tenant service target is not ported yet "
               "(ROADMAP.md A2e)",
    "fabric": "the sharded fabric target is not ported yet (ROADMAP.md "
              "A5, after the service of A2e)",
}


def connect(target: str = "local",
            config: Optional[StratumConfig] = None,
            tenant: str = "default", **kwargs) -> StratumClient:
    """Build a :class:`StratumClient` for ``target`` from one
    :class:`StratumConfig`.  The port has the "local" target; "service"
    and "fabric" raise ``NotImplementedError`` until they are ported.
    Extra kwargs go to the target constructor (e.g. ``stratum=`` to front
    an existing session)."""
    if target in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[target])
    try:
        cls = TARGETS[target]
    except KeyError:
        raise ValueError(f"unknown target {target!r}; expected one of "
                         f"{sorted(TARGETS) + sorted(_NOT_PORTED)}") from None
    return cls(config=config, tenant=tenant, **kwargs)
