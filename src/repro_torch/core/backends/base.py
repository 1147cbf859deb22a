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
  polls); it runs every op on its selected tier, ``"torch"`` segments
  included.

The compiled-segment backend (the reference's ``"jax"``, which runs a
whole segment of traceable ops as ONE program cached by structural
signature in a shared :class:`~repro_torch.core.plan_cache.PlanCache`) is
``ROADMAP.md`` A2b; until it lands ``make_backends(compiled=True)`` raises.

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
    """Default backend set for a runtime: the per-op python path, which
    runs ``"torch"`` segments op by op on their selected tiers.  The
    compiled torch segment path (``compiled=True``, with ``plan_cache`` and
    ``batch_variants``) is ``ROADMAP.md`` A2b and raises until it lands."""
    from .python_thread import PythonThreadBackend
    if compiled:
        raise NotImplementedError(
            "compiled segments are not ported yet (ROADMAP.md A2b, the "
            "compiled-segment backend); pass compiled_segments=False")
    backends: dict[str, ExecutionBackend] = {"python": PythonThreadBackend()}
    for kind, factory in _FACTORIES.items():
        if kind not in backends:
            backends[kind] = factory(plan_cache=plan_cache)
    return backends
