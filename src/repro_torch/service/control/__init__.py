"""Closed-loop control: retune queue knobs from observed windows.

The observability layer (PR 7) measures; this package acts on the
measurements.  A :class:`ServiceController` periodically reads the
windowed throughput/attainment/latency collector and actuates the
admission gate, the WFQ band weights, and (fabric-side, via the merged
windowed attainment the autoscaler reads) the scale-up signal — all
governed by a :class:`ControlPolicy` of targets, floors, gains and
cooldowns.  Off by default; enable with
``StratumConfig.make(control=ControlPolicy(...))``.

See ``docs/SCHEDULING.md`` §5.
"""

from .controller import (ACTION_RING, CONTROL_TRACE_KEY, ServiceController,
                         merge_control_snapshots)
from .policy import ControlPolicy

__all__ = [
    "ACTION_RING", "CONTROL_TRACE_KEY", "ControlPolicy",
    "ServiceController", "merge_control_snapshots",
]
