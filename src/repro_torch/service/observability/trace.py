"""Per-job lifecycle traces.

A trace is an append-only list of *hops*.  Each hop is a plain 5-tuple

    (event, t, shard, slack, detail)

- ``event`` — one of the lowercase constants below (``SUBMITTED`` ...),
- ``t`` — wall-clock ``time.time()`` stamp (shared across worker processes
  on one host; clamped monotone *within* a trace so replay ordering never
  inverts on clock jitter),
- ``shard`` — shard id string, ``""`` when not shard-bound yet,
- ``slack`` — remaining deadline budget in seconds at stamp time, or
  ``None`` for deadline-free jobs,
- ``detail`` — small JSON-safe dict of hop-specific fields (backend mix,
  plan-cache hits, failover attempt, shed reason, ...).

Tuples (not a class) because hops cross the fabric wire inside
``JobEnvelope.hops`` / ``FabricJobReport.hops`` and must survive the
pickled codec and JSONL round-trips unchanged.
"""

from __future__ import annotations

import time
from typing import Optional

# lifecycle events, in rough pipeline order
SUBMITTED = "submitted"
ANALYZED = "analyzed"      # pre-flight static analysis verdict at admission
ADMITTED = "admitted"
QUEUED = "queued"
COALESCED = "coalesced"
DISPATCHED = "dispatched"
PREEMPTED = "preempted"
REQUEUED = "requeued"
ROUTED = "routed"
FAILOVER = "failover"
COMPLETED = "completed"
FAILED = "failed"
SHED = "shed"
CANCELLED = "cancelled"
# not a job-lifecycle hop: a controller actuation (closed-loop retune of
# admission/weights), logged under the synthetic job key "control" so
# the event log replays scheduling-policy changes alongside job timelines
RETUNED = "retuned"

#: every known event, in canonical lifecycle order (used by replay + tests)
EVENTS = (SUBMITTED, ANALYZED, ADMITTED, QUEUED, COALESCED, DISPATCHED,
          PREEMPTED, REQUEUED, ROUTED, FAILOVER, RETUNED, COMPLETED,
          FAILED, SHED, CANCELLED)

#: events that terminate a trace — exactly one may appear, and only last
TERMINAL = (COMPLETED, FAILED, SHED, CANCELLED)


def make_hop(event: str, shard: str = "", slack: Optional[float] = None,
             t: Optional[float] = None, **detail) -> tuple:
    """Build one wire-ready hop tuple."""
    if t is None:
        t = time.time()
    if slack is not None:
        slack = float(slack)
    return (event, float(t), str(shard), slack, dict(detail))


class JobTrace:
    """Mutable per-job hop log.

    Created by a :class:`~repro_torch.service.observability.events.TraceSink`;
    ``stamp`` appends a hop (with within-trace monotone time clamp) and
    emits it to the sink's JSONL log when one is configured.
    """

    __slots__ = ("key", "tenant", "hops", "_sink")

    def __init__(self, key: str, tenant: str, hops=(), sink=None):
        self.key = key
        self.tenant = tenant
        self.hops = [tuple(h) for h in hops]
        self._sink = sink

    def stamp(self, event: str, shard: str = "",
              slack: Optional[float] = None, **detail) -> tuple:
        hop = make_hop(event, shard=shard, slack=slack, **detail)
        if self.hops and hop[1] < self.hops[-1][1]:
            # never let clock jitter order a later hop before an earlier one
            hop = (hop[0], self.hops[-1][1]) + hop[2:]
        self.hops.append(hop)
        if self._sink is not None:
            self._sink.emit_hop(self.key, self.tenant, hop)
        return hop

    def as_hops(self) -> tuple:
        """Immutable wire/report form: tuple of hop tuples."""
        return tuple(self.hops)

    @property
    def terminal(self) -> Optional[str]:
        for ev, *_rest in reversed(self.hops):
            if ev in TERMINAL:
                return ev
        return None

    def __len__(self) -> int:
        return len(self.hops)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        path = "→".join(h[0] for h in self.hops)
        return f"JobTrace({self.key!r}, {path})"
