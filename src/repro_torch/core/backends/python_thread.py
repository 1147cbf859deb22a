"""Per-op threaded execution — the interpreted backend.

This is the runtime's original execution path, moved behind the
:class:`~.base.ExecutionBackend` seam: each wave's ops run individually
(vmap variant groups batched first), in parallel on the runtime's bounded
thread pool when the plan allows, with cooperative-preemption polls at
every wave boundary *and* between op completions inside wide waves, and
liveness-driven freeing after each wave.
"""

from __future__ import annotations

from .base import ExecutionBackend


class PythonThreadBackend(ExecutionBackend):
    name = "python"

    def execute_segment(self, rt, segment, selection, report) -> None:
        for wave in segment.waves:
            # cooperative yield point at the wave boundary — the salvage
            # carries every completed intermediate to the requeued re-run
            if rt._should_yield(report):
                raise rt._preempted(report)
            report.waves += 1
            wave_ops = []
            for op in wave.ops:
                if op.signature in rt._skips:
                    # completed before the preempting yield; its output
                    # is dead on this resume — never re-executed
                    rt._mark_salvaged(op, report)
                    continue
                wave_ops.append(op)
            todo = rt._batch_variants(wave_ops, selection, report)
            rt._run_ops_parallel(todo, selection, report)
            rt._free_wave(wave)
