"""Logical rewrites (paper §4.2): CSE / read sharing, projection pushdown,
constant folding, DCE — applied after metadata collection, preserving semantic
equivalence.

Rewrite ordering is workload-dependent (paper: "delaying projection pushdown
for higher CSE opportunities"); the default pipeline is therefore
``cse → constant_fold → cse → project_pushdown → cse`` — CSE first maximizes
sharing across fused pipelines *before* pushdown specializes subgraphs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from .dag import (CONST,
                  GENERIC,
                  LazyOp,
                  LazyRef,
                  PROJECT,
                  SOURCE,
                  TRANSFORM,
                  count_ops,
                  host_array,
                  rebuild,
                  toposort)

# ---------------------------------------------------------------------------
# structural properties: which transforms commute with column projection
# (paper: "structural properties (e.g. selection and projection)")
# ---------------------------------------------------------------------------

_COLUMNWISE: set[str] = set()     # op(x)[:, cols] == op(x[:, cols])
_ROW_PRESERVING: set[str] = set() # output rows == input rows (filter pushdown)


def declare_columnwise(*op_names: str) -> None:
    _COLUMNWISE.update(op_names)


def declare_row_preserving(*op_names: str) -> None:
    _ROW_PRESERVING.update(op_names)


@dataclass
class RewriteStats:
    cse_merged: int = 0
    reads_shared: int = 0
    constants_folded: int = 0
    projections_pushed: int = 0
    ops_before: int = 0
    ops_after: int = 0

    def merge(self, other: "RewriteStats") -> None:
        self.cse_merged += other.cse_merged
        self.reads_shared += other.reads_shared
        self.constants_folded += other.constants_folded
        self.projections_pushed += other.projections_pushed


# ---------------------------------------------------------------------------
# CSE + read sharing: hash-consing on the content signature
# ---------------------------------------------------------------------------

def cse(sinks: Sequence[LazyRef], stats: Optional[RewriteStats] = None
        ) -> list[LazyRef]:
    """Merge ops with equal signatures.  Unseeded non-deterministic ops have
    unique signatures by construction (dag.py), so they are never merged —
    the paper's correctness condition for reuse."""
    canonical: dict[str, LazyOp] = {}

    def replace(op: LazyOp, new_inputs: tuple) -> Optional[LazyOp]:
        cand = op if all(a.op is b.op for a, b in zip(new_inputs, op.inputs)) \
            else op.with_inputs(new_inputs)
        sig = cand.signature
        if sig in canonical:
            if stats is not None:
                if op.op_class == SOURCE:
                    stats.reads_shared += 1
                else:
                    stats.cse_merged += 1
            return canonical[sig]
        canonical[sig] = cand
        return cand

    return rebuild(sinks, replace)


# ---------------------------------------------------------------------------
# constant folding: evaluate deterministic ops over CONST inputs at plan time
# ---------------------------------------------------------------------------

_MAX_FOLD_BYTES = 1 << 20  # never fold anything producing > 1 MiB


def constant_fold(sinks: Sequence[LazyRef], execute_ref,
                  stats: Optional[RewriteStats] = None) -> list[LazyRef]:
    """``execute_ref(op, input_values) -> tuple(outputs)`` is the reference
    backend evaluator (injected to avoid a core→runtime import cycle)."""

    def replace(op: LazyOp, new_inputs: tuple) -> Optional[LazyOp]:
        if (op.op_class in (SOURCE, GENERIC) or not op.deterministic
                or op.op_class == CONST or not new_inputs):
            return None
        if not all(r.op.op_class == CONST for r in new_inputs):
            return None
        if op.meta is not None and op.meta.out_bytes > _MAX_FOLD_BYTES:
            return None
        values = [host_array(r.op.spec["value"]) for r in new_inputs]
        try:
            outs = execute_ref(op, values)
        except Exception:
            return None  # not foldable — leave for runtime
        if stats is not None:
            stats.constants_folded += 1
        if op.n_outputs == 1:
            return LazyOp("const", CONST,
                          spec={"value": host_array(outs[0])})
        # multi-output folding not supported; keep op
        return None

    return rebuild(sinks, replace)


# ---------------------------------------------------------------------------
# projection pushdown: project(columnwise_op(x)) -> columnwise_op(project(x))
# ---------------------------------------------------------------------------

def project_pushdown(sinks: Sequence[LazyRef],
                     stats: Optional[RewriteStats] = None) -> list[LazyRef]:

    def replace(op: LazyOp, new_inputs: tuple) -> Optional[LazyOp]:
        if op.op_class != PROJECT or len(new_inputs) != 1:
            return None
        child = new_inputs[0].op
        movable = (child.op_class == TRANSFORM
                   and child.op_name in _COLUMNWISE
                   and child.n_outputs == 1
                   and len(child.inputs) == 1)
        if not movable:
            return None
        # project(T(x)) == T(project(x)) for columnwise T
        pushed = op.with_inputs(child.inputs)
        new_child = child.with_inputs((pushed.out(0),))
        if stats is not None:
            stats.projections_pushed += 1
        return new_child

    # iterate to fixpoint (a projection can sink through a chain)
    prev = -1
    cur = count_ops(sinks)
    out = list(sinks)
    while cur != prev:
        out = rebuild(out, replace)
        prev, cur = cur, count_ops(out)
    return out


# ---------------------------------------------------------------------------
# API-aware rewrite: boosting prefix sharing (beyond-paper; the paper's
# "API-aware rewrites" category §4.2).  A k-tree GBT is a strict prefix of
# the K>k-tree GBT with otherwise identical spec/inputs/seed — so a grid
# over n_trees needs ONE fit of max(n_trees); smaller models are extracted
# with a cheap `gbt_prefix` op.
# ---------------------------------------------------------------------------

def gbt_prefix_sharing(sinks: Sequence[LazyRef],
                       stats: Optional[RewriteStats] = None
                       ) -> list[LazyRef]:
    from .dag import toposort as _topo

    groups: dict[tuple, list[LazyOp]] = {}
    for op in _topo(sinks):
        if op.op_name != "gbt_fit":
            continue
        key_spec = tuple(sorted((k, v) for k, v in op.spec.items()
                                if k != "n_trees"))
        key = (key_spec, op.seed,
               tuple(r.signature for r in op.inputs))
        groups.setdefault(key, []).append(op)

    replacements: dict[int, LazyOp] = {}
    for ops_ in groups.values():
        if len(ops_) < 2:
            continue
        biggest = max(ops_, key=lambda o: o.spec["n_trees"])
        for op in ops_:
            if op is biggest:
                continue
            replacements[op.uid] = op  # marker; rebuilt below
        for op in ops_:
            if op is not biggest and stats is not None:
                stats.cse_merged += 1

    if not replacements:
        return list(sinks)

    by_key: dict[int, LazyOp] = {}
    for ops_ in groups.values():
        biggest = max(ops_, key=lambda o: o.spec["n_trees"])
        for op in ops_:
            if op is not biggest:
                by_key[op.uid] = biggest

    def replace(op: LazyOp, new_inputs: tuple) -> Optional[LazyOp]:
        big = by_key.get(op.uid)
        if big is None:
            return None
        # rebuild the big fit over the (possibly rewritten) inputs
        big_new = big.with_inputs(new_inputs)
        return LazyOp("gbt_prefix", TRANSFORM,
                      spec={"n_trees": op.spec["n_trees"]},
                      inputs=(big_new.out(0),))

    return rebuild(sinks, replace)


# ---------------------------------------------------------------------------
# the default rewrite pipeline
# ---------------------------------------------------------------------------

def optimize_logical(sinks: Sequence[LazyRef], execute_ref=None,
                     enable: Sequence[str] = ("cse", "fold", "pushdown",
                                              "gbt_prefix"),
                     ) -> tuple[list[LazyRef], RewriteStats]:
    stats = RewriteStats(ops_before=count_ops(sinks))
    out = list(sinks)
    if "cse" in enable:
        out = cse(out, stats)
    if "fold" in enable and execute_ref is not None:
        out = constant_fold(out, execute_ref, stats)
        out = cse(out, stats)
    if "pushdown" in enable:
        out = project_pushdown(out, stats)
        out = cse(out, stats)
    if "gbt_prefix" in enable:
        out = gbt_prefix_sharing(out, stats)
        out = cse(out, stats)
    stats.ops_after = count_ops(out)
    return out, stats
