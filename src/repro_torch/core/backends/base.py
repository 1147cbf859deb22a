"""The pluggable execution-backend seam.

The :class:`~repro_torch.core.runtime.Runtime` no longer executes ops itself: it
walks the plan's backend-homogeneous :class:`~repro_torch.core.scheduler.Segment`
list and hands each segment to the :class:`ExecutionBackend` registered
for its kind.  The runtime instance *is* the execution context — it owns
the value store, the intermediate cache handle, the salvage/preload state
and the preemption hooks — and backends drive it through its helper
surface (``_gather_inputs`` / ``_store`` / ``_run_op`` / ``_should_yield``
/ ``_preempted``).

Backends shipped here:

* ``"python"`` — :class:`~.python_thread.PythonThreadBackend`: the per-op
  path (bounded thread pool, vmap variant batching, intra-wave preemption
  polls); it runs every op on its selected tier;
* ``"torch"``  — :class:`~.torch_segment.TorchSegmentBackend`: traces a
  whole segment of traceable torch-tier ops into ONE compiled program with
  tunable constants hoisted to arguments, cached by structural signature in
  a shared :class:`~repro_torch.core.plan_cache.PlanCache`.

A future out-of-process backend (the paper's Rust-runtime analogue) plugs
in by registering a new kind here and teaching the scheduler's
``partition_segments`` to emit segments of that kind; nothing in the
runtime loop changes.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Callable


class ExecutionBackend(ABC):
    """Executes one backend-homogeneous plan segment.

    Contract (what the runtime loop relies on):

    * every op of the segment ends in exactly one of four states, recorded
      in the run report's ``sig_source``: salvaged (preload/skip), cache
      hit, executed, or deduplicated onto an identical-signature peer;
    * outputs of every non-skipped op are in the runtime's value store
      when ``execute_segment`` returns (downstream segments read them);
    * intermediate-cache probes are tenant-aware ``get``\\ s and marked
      candidates are ``put`` back — both through the runtime's handles;
    * liveness freeing (``wave.free_after``) is applied no later than the
      segment boundary;
    * cooperative preemption may only be raised via the runtime's
      ``_preempted`` helper so salvage stays exact.
    """

    name: str = "abstract"

    @abstractmethod
    def execute_segment(self, rt, segment, selection, report) -> None:
        """Execute ``segment`` against runtime context ``rt``.

        ``selection`` maps op signature → chosen PhysicalImpl; ``report``
        is the run's mutable :class:`~repro_torch.core.runtime.RunReport`.
        May raise :class:`~repro_torch.core.runtime.ExecutionError` (op
        failure) or :class:`~repro_torch.core.runtime.ExecutionPreempted`
        (cooperative yield)."""


# ---------------------------------------------------------------------------
# backend registry: segment kind -> factory
# ---------------------------------------------------------------------------

_FACTORIES: dict[str, Callable[..., ExecutionBackend]] = {}


def register_backend(kind: str, factory: Callable[..., ExecutionBackend]
                     ) -> None:
    """Register a backend factory for a segment kind (the seam a future
    out-of-process / Rust backend bolts onto)."""
    _FACTORIES[kind] = factory


def available_backends() -> tuple:
    return tuple(sorted(_FACTORIES))


def make_backends(plan_cache=None, compiled: bool = True,
                  batch_variants: bool = False
                  ) -> dict[str, ExecutionBackend]:
    """Default backend set for a runtime: the per-op python path, plus the
    compiled torch segment path when ``compiled`` (sharing ``plan_cache``
    when given; ``batch_variants`` turns on vmap-batched variant groups
    inside compiled segments).  ``compiled=False`` reproduces the
    pre-segment per-op runtime exactly — torch segments fall back to the
    python backend, which runs each op on its selected tier."""
    from .python_thread import PythonThreadBackend
    from .torch_segment import TorchSegmentBackend
    backends: dict[str, ExecutionBackend] = {"python": PythonThreadBackend()}
    if compiled:
        backends["torch"] = TorchSegmentBackend(
            plan_cache=plan_cache, batch_variants=batch_variants)
    for kind, factory in _FACTORIES.items():
        if kind not in backends:
            backends[kind] = factory(plan_cache=plan_cache)
    return backends
