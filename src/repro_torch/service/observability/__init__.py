"""Per-job lifecycle tracing, windowed stats, event log, replay, live view.

See ``docs/OBSERVABILITY.md``.  Enable with
``StratumConfig.make(..., trace=True)`` (in-memory traces on every
``JobReport``) or ``trace_dir="/path"`` (plus a durable JSONL event log
replayable via ``python -m repro_torch.service.observability.replay``).
"""

from .events import TraceLog, TraceSink, hop_record, record_hop
from .trace import (ADMITTED, ANALYZED, CANCELLED, COALESCED, COMPLETED,
                    DISPATCHED, EVENTS, FAILED, FAILOVER, PREEMPTED, QUEUED,
                    REQUEUED, RETUNED, ROUTED, SHED, SUBMITTED, TERMINAL,
                    JobTrace, make_hop)
from .windows import (MAX_SAMPLES, ThroughputCollector,
                      merge_window_snapshots, percentile)

__all__ = [
    "JobTrace", "make_hop", "EVENTS", "TERMINAL",
    "SUBMITTED", "ANALYZED", "ADMITTED", "QUEUED", "COALESCED", "DISPATCHED",
    "PREEMPTED", "REQUEUED", "ROUTED", "FAILOVER", "RETUNED", "COMPLETED",
    "FAILED", "SHED", "CANCELLED",
    "TraceSink", "TraceLog", "hop_record", "record_hop",
    "ThroughputCollector", "merge_window_snapshots", "percentile",
    "MAX_SAMPLES",
]
