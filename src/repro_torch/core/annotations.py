"""Agent–system co-design hooks (paper §3).

Agents may annotate pipelines with lightweight metadata which stratum uses to
adjust execution:

* ``stage``: "explore" | "exploit" — explore permits lower-fidelity operator
  selection (approximate SVD, subsampled fits) and tighter iteration caps;
* ``budget_s``: soft per-pipeline time budget (runtime may early-stop
  iterative estimators);
* ``diff_of``: name of the parent pipeline when the agent emits incremental
  specifications (pipeline diffs) — fusion uses it for bookkeeping only,
  since hash-consing already recovers sharing structurally.
"""

from __future__ import annotations

from typing import Any

from .dag import LazyRef

KNOWN_KEYS = ("stage", "budget_s", "diff_of", "fidelity")


def annotate(sink: LazyRef, **notes: Any) -> LazyRef:
    """Attach annotations to every op reachable from ``sink``.

    Annotations do not affect operator signatures (they are hints, not
    semantics) — mutating in place is deliberate: cache keys must not change.
    """
    for key in notes:
        if key not in KNOWN_KEYS:
            raise KeyError(f"unknown annotation {key!r}; known: {KNOWN_KEYS}")
    from .dag import toposort
    for op in toposort([sink]):
        merged = dict(op.annotations)
        merged.update(notes)
        op.annotations = merged
    return sink
