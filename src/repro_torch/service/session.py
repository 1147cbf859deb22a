"""Agent-facing handles: :class:`Session` and :class:`PipelineFuture`.

The paper's decoupling claim (§3): the agent keeps *planning* (drafting the
next AIDE tree node) while *execution* proceeds inside the service.  A
``Session`` is a lightweight per-tenant handle onto a shared
:class:`~repro_torch.service.server.StratumService`; ``submit`` is non-blocking
and returns a :class:`PipelineFuture` that resolves to the same
``(results, report)`` shape ``Stratum.run_batch`` produces, so a synchronous
agent can be ported by replacing ``run_batch(b)`` with
``submit(b).result()``.

``submit`` also takes a :class:`~repro_torch.service.priority.Priority`: a
latency-sensitive probe the agent is blocked on goes in as ``INTERACTIVE``,
bulk sweeps as ``BATCH`` (default) or ``SCAVENGER`` — see
``docs/SCHEDULING.md`` for the scheduling semantics.

A ``Session`` is backend-agnostic: the same handle fronts a standalone
:class:`~repro_torch.service.server.StratumService` or a sharded fabric
(:class:`~repro_torch.service.fabric.StratumFabric`) — anything exposing
``submit(tenant, batch, priority=..., affinity=...) -> PipelineFuture``
and a ``telemetry`` object with ``snapshot()``.  Against the fabric every
submission crosses the serializable envelope boundary; ``affinity`` (an
opaque string) pins related submissions to one shard by overriding the
content-derived routing key — e.g. one agent's whole search sticking to
the shard that holds its cached intermediates.
"""

from __future__ import annotations

import threading
from concurrent.futures import CancelledError
from typing import Any, Callable, Optional

from ..core.fusion import PipelineBatch
from .priority import Priority

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


class Session:
    """One tenant's handle onto an execution backend — a standalone
    :class:`StratumService` or a sharded fabric (see module docstring)."""

    def __init__(self, service, tenant: str):
        self._service = service
        self.tenant = tenant
        self._closed = False

    # -- non-blocking path (the point of the subsystem) --------------------
    def submit(self, batch: PipelineBatch,
               priority: Priority = Priority.BATCH,
               affinity: Optional[str] = None,
               deadline_s: Optional[float] = None,
               tags=(),
               options=None,
               verify: Optional[bool] = None) -> PipelineFuture:
        """Enqueue ``batch``; returns immediately.

        Prefer passing one :class:`repro_torch.client.SubmitOptions` as
        ``options`` — it carries priority, deadline, affinity and tags in
        one frozen object and is the surface every
        :class:`~repro_torch.client.StratumClient` target shares; when given it
        takes precedence over the individual keyword shims.

        ``affinity`` pins the job to the shard owning that key on a sharded
        backend (ignored by a standalone service); ``deadline_s`` is an SLO
        relative to now — a deadline-aware backend schedules EDF within the
        priority band and sheds expired work, failing the future with
        :class:`~repro_torch.service.queue.DeadlineExceeded`.  Raises
        :class:`~repro_torch.service.queue.AdmissionError` when admission control
        rejects the job (queue depth / tenant quota).

        ``verify`` overrides :attr:`ServiceConfig.admission_analysis` for
        this one submit: ``True`` forces pre-flight static analysis (raises
        :class:`~repro_torch.core.analysis.AnalysisError` on a statically-invalid
        pipeline), ``False`` skips it, ``None`` defers to the service
        default."""
        if self._closed:
            raise RuntimeError(f"session {self.tenant!r} is closed")
        tenant = self.tenant
        if options is not None:
            priority = options.priority
            affinity = options.affinity
            deadline_s = options.deadline_s
            tags = options.tags
            # SubmitOptions.tenant is documented as an override — honor it
            # (quotas/telemetry attribute to the tenant that asked)
            if options.tenant is not None:
                tenant = options.tenant
            if getattr(options, "verify", None) is not None:
                verify = options.verify
        kwargs: dict = {"priority": priority, "affinity": affinity}
        # only pass the newer options to backends that predate them, so a
        # Session still fronts any object with the original submit shape
        if deadline_s is not None:
            kwargs["deadline_s"] = deadline_s
        if tags:
            kwargs["tags"] = tuple(tags)
        if verify is not None:
            kwargs["verify"] = verify
        return self._service.submit(tenant, batch, **kwargs)

    # -- drop-in synchronous compatibility with Stratum.run_batch ----------
    def run_batch(self, batch: PipelineBatch,
                  timeout: Optional[float] = None,
                  priority: Priority = Priority.BATCH,
                  affinity: Optional[str] = None,
                  deadline_s: Optional[float] = None,
                  tags=(),
                  options=None):
        return self.submit(batch, priority=priority, affinity=affinity,
                           deadline_s=deadline_s, tags=tags,
                           options=options).result(timeout)

    def precompile(self, batch: PipelineBatch) -> dict:
        """Speculative warm-up hint: plan ``batch`` without executing it
        and enqueue its compiled segments on the service's low-priority
        background compile lane (``compile_async`` +
        ``speculative_depth``).  Returns a status-count dict; ``{}`` when
        the backend cannot honor hints — guessing is never an error."""
        if self._closed:
            raise RuntimeError(f"session {self.tenant!r} is closed")
        precompile = getattr(self._service, "precompile", None)
        if precompile is None:
            return {}
        return precompile(self.tenant, batch)

    def analyze(self, batch: PipelineBatch, *, feasibility: bool = True):
        """Run the pre-flight static analyzer on ``batch`` without
        submitting it; returns an
        :class:`~repro_torch.core.analysis.AnalysisReport`.  Raises
        ``NotImplementedError`` when the backend has no analyzer (older
        fabric shards)."""
        if self._closed:
            raise RuntimeError(f"session {self.tenant!r} is closed")
        analyze = getattr(self._service, "analyze", None)
        if analyze is None:
            raise NotImplementedError(
                f"backend {type(self._service).__name__} has no analyzer")
        return analyze(batch, feasibility=feasibility)

    @property
    def telemetry(self) -> dict:
        return self._service.telemetry.snapshot().get(self.tenant, {})

    def close(self) -> None:
        self._closed = True

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
