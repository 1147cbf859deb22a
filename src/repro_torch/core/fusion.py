"""Pipeline-batch fusion (paper §4.2: "Agents emit pipeline variants in
overlapping batches.  Stratum fuses each batch into a unified DAG").

Fusion itself is trivial in a hash-consed world — the unified DAG is just the
union of the pipelines' sinks; CSE then merges every structurally identical
subgraph across pipelines (shared reads, shared preprocessing prefixes).
What this module adds on top:

* :class:`PipelineBatch` bookkeeping (which sink belongs to which pipeline,
  agent annotations, per-pipeline results de-multiplexing),
* *variant batching*: detection of homogeneous sink groups — identical DAG
  shape differing only in a scalar hyperparameter spec — which the runtime
  can execute as one vmapped program (the accelerator analogue of the paper's
  inter-operator parallelism; see DESIGN.md §2).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Sequence

import hashlib

from .dag import LazyRef, toposort


@dataclass
class PipelineBatch:
    """A batch of agent-emitted pipelines; each pipeline is one sink ref."""
    sinks: list                      # list[LazyRef]
    names: list = field(default_factory=list)
    annotations: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.names:
            self.names = [f"pipeline_{i}" for i in range(len(self.sinks))]
        if len(self.names) != len(self.sinks):
            raise ValueError("names/sinks length mismatch")

    def fused_sinks(self) -> list:
        return list(self.sinks)

    def demux(self, results: Sequence[Any]) -> dict[str, Any]:
        return dict(zip(self.names, results))


# ---------------------------------------------------------------------------
# variant batching: group sinks whose DAGs are isomorphic up to scalar specs
# ---------------------------------------------------------------------------

def _shape_signature(ref: LazyRef, ignore_keys: frozenset) -> str:
    """Signature of the DAG *shape*: op names, wiring and non-ignored spec
    entries — but not the ignored hyperparameter values."""
    h = hashlib.blake2b(digest_size=16)
    order = toposort([ref])
    index = {op.uid: i for i, op in enumerate(order)}
    for op in order:
        h.update(op.op_name.encode())
        for k in sorted(op.spec):
            if k in ignore_keys:
                h.update(f"<{k}>".encode())
            else:
                h.update(f"{k}={op.spec[k]!r}".encode())
        for r in op.inputs:
            h.update(f"{index[r.op.uid]}:{r.index}".encode())
    h.update(f"@{index[ref.op.uid]}:{ref.index}".encode())
    return h.hexdigest()


def group_variants(sinks: Sequence[LazyRef],
                   hyperparam_keys: Sequence[str] = ("alpha", "l1_ratio",
                                                     "learning_rate", "reg"),
                   ) -> list[list[int]]:
    """Return groups of sink indices that are hyperparameter-only variants of
    one another.  Groups of size ≥ 2 are vmap candidates."""
    ignore = frozenset(hyperparam_keys)
    buckets: dict[str, list[int]] = defaultdict(list)
    for i, ref in enumerate(sinks):
        buckets[_shape_signature(ref, ignore)].append(i)
    return [idxs for idxs in buckets.values()]
