"""Priority classes for the execution service.

Agent workloads are heterogeneous: an RL- or AIDE-driven agent interleaves
cheap latency-sensitive probes (a single candidate it is blocked on) with
bulk sweeps it merely wants finished eventually.  The service therefore
stratifies jobs into three bands:

* :attr:`Priority.INTERACTIVE` — latency-sensitive; the agent is blocked on
  the result (e.g. the refinement of the current best AIDE node).
* :attr:`Priority.BATCH` — the default; ordinary throughput work.
* :attr:`Priority.SCAVENGER` — bulk background sweeps; runs in otherwise
  idle capacity and is the first to be preempted.

Scheduling across bands is *weighted fair queuing*, not strict priority:
each band holding work accrues credit proportional to its weight and the
band with the most credit is served next, so lower bands retain a
configurable fraction of throughput even under sustained interactive load
(``DEFAULT_WEIGHTS`` gives roughly 12:3:1).  A band with weight 0 is served
only when every weighted band is empty (strict background).

Starvation-proofing is separate from the weights: a job that has waited
longer than ``aging_s`` is promoted one band (and again after another
``aging_s``), so even a weight-0 scavenger job eventually reaches the
interactive band and is served by plain round-robin there.  See
``docs/SCHEDULING.md`` for the full semantics and guarantees.
"""

from __future__ import annotations

from enum import IntEnum


class Priority(IntEnum):
    """Job priority band; lower value = more urgent."""

    INTERACTIVE = 0
    BATCH = 1
    SCAVENGER = 2


#: Default weighted-fair-queuing weights (credit accrual per scheduling
#: decision).  Roughly: under full contention, 12/16 of rounds go to
#: INTERACTIVE, 3/16 to BATCH, 1/16 to SCAVENGER.
DEFAULT_WEIGHTS: dict[Priority, int] = {
    Priority.INTERACTIVE: 12,
    Priority.BATCH: 3,
    Priority.SCAVENGER: 1,
}
