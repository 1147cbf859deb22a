"""Pipeline lint — legal-but-suspicious patterns over the same IR.

Four rule families, each with op-level provenance:

* ``dead-output`` — an output of a multi-output op that no consumer reads
  and that is not a sink: the op still computes it, the value is discarded.
* ``dead-op`` — ops reachable from ``extra_roots`` (e.g. steps declared by
  an orchestrator) but from no sink: they never execute, which is usually
  a wiring mistake in the program that built the DAG.
* ``duplicate-subgraph`` — distinct op objects sharing a content signature;
  CSE will merge them, so this is free information about batch redundancy.
* ``undeclared-tunable`` — structurally identical ops whose specs differ
  only in scalar fields *not* declared tunable: each variant occupies its
  own plan-cache entry and compiles separately, defeating the
  structural-signature cache (``dag.declare_tunable`` is the fix).  Only
  raised for ops with a traceable torch impl — others never enter the plan
  cache.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

from ..dag import LazyRef, tunable_fields, toposort
from ..selection import impls_for
from .report import Finding, SEV_INFO, SEV_WARNING

_SCALAR = (int, float, bool)


def _has_traceable_torch(op_name: str) -> bool:
    return any(i.backend == "torch" and i.traceable
               for i in impls_for(op_name))


def _blind_signature(op, memo: dict) -> str:
    """Content signature with ALL scalar spec values (and seeds) blanked —
    two ops share it iff declaring their differing scalars tunable would
    let them share one compiled plan."""
    cached = memo.get(op.uid)
    if cached is not None:
        return cached
    h = hashlib.blake2b(digest_size=16)
    h.update(op.op_name.encode())
    h.update(str(op.n_outputs).encode())
    for k in sorted(op.spec):
        v = op.spec[k]
        if isinstance(v, bool) or not isinstance(v, _SCALAR):
            # bools and non-scalars select code paths — keep their value
            h.update(f"{k}={v!r}".encode())
        else:
            h.update(f"<{k}>".encode())
    for ref in op.inputs:
        h.update(_blind_signature(ref.op, memo).encode())
        h.update(str(ref.index).encode())
    sig = h.hexdigest()
    memo[op.uid] = sig
    return sig


def lint_pipeline(sinks: Sequence[LazyRef],
                  extra_roots: Sequence[LazyRef] = ()) -> list:
    findings: list = []
    order = toposort(sinks)

    # ---- dead outputs -------------------------------------------------
    consumed: dict[int, set] = {}
    for op in order:
        for ref in op.inputs:
            consumed.setdefault(ref.op.uid, set()).add(ref.index)
    for ref in sinks:
        consumed.setdefault(ref.op.uid, set()).add(ref.index)
    for op in order:
        if op.n_outputs <= 1:
            continue
        unused = sorted(set(range(op.n_outputs))
                        - consumed.get(op.uid, set()))
        if unused:
            findings.append(Finding(
                "dead-output", SEV_INFO,
                f"outputs {unused} are computed but never consumed",
                op_name=op.op_name, op_uid=op.uid,
                detail=(("unused", tuple(unused)),)))

    # ---- dead ops (declared roots that reach no sink) -----------------
    if extra_roots:
        live = {op.uid for op in order}
        declared = toposort([r for r in extra_roots
                             if isinstance(r, LazyRef)])
        for op in declared:
            if op.uid not in live:
                findings.append(Finding(
                    "dead-op", SEV_WARNING,
                    "op is declared by the program but reaches no sink; "
                    "it will never execute",
                    op_name=op.op_name, op_uid=op.uid))

    # ---- duplicate subgraphs (CSE fodder) -----------------------------
    by_sig: dict[str, int] = {}
    for op in order:
        by_sig[op.signature] = by_sig.get(op.signature, 0) + 1
    dup_groups = sum(1 for n in by_sig.values() if n > 1)
    redundant = sum(n - 1 for n in by_sig.values() if n > 1)
    if dup_groups:
        findings.append(Finding(
            "duplicate-subgraph", SEV_INFO,
            f"{dup_groups} duplicated subgraph(s) ({redundant} redundant "
            "ops) — CSE will merge them",
            detail=(("groups", dup_groups), ("redundant_ops", redundant))))

    # ---- undeclared tunables ------------------------------------------
    memo: dict = {}
    groups: dict[str, list] = {}
    for op in order:
        if not op.spec or not _has_traceable_torch(op.op_name):
            continue
        if not any(isinstance(v, _SCALAR) and not isinstance(v, bool)
                   for v in op.spec.values()):
            continue
        groups.setdefault(_blind_signature(op, memo), []).append(op)
    for members in groups.values():
        if len(members) < 2:
            continue
        declared = tunable_fields(members[0].op_name)
        varying: set = set()
        for k in members[0].spec:
            v0 = members[0].spec[k]
            if not isinstance(v0, _SCALAR) or isinstance(v0, bool):
                continue
            if any(m.spec.get(k) != v0 for m in members[1:]):
                varying.add(k)
        undeclared = sorted(varying - set(declared))
        if undeclared:
            op = members[0]
            findings.append(Finding(
                "undeclared-tunable", SEV_WARNING,
                f"spec field(s) {undeclared} vary across {len(members)} "
                "structurally-identical ops but are not declared tunable; "
                "each variant compiles its own plan-cache entry "
                "(dag.declare_tunable to share one)",
                op_name=op.op_name, op_uid=op.uid,
                detail=(("fields", tuple(undeclared)),
                        ("variants", len(members)))))
    return findings


def segment_split_findings(segments, selection) -> list:
    """Non-traceable ops that split an otherwise-compilable run: python
    segments sandwiched between torch segments, attributed to the ops in
    them lacking a traceable torch-tier impl."""
    findings: list = []
    for i, seg in enumerate(segments):
        if seg.kind != "python" or not (0 < i < len(segments) - 1):
            continue
        if not (segments[i - 1].kind == "torch"
                and segments[i + 1].kind == "torch"):
            continue
        culprits: dict[str, int] = {}
        uid = -1
        name = ""
        for wave in seg.waves:
            for op in wave.ops:
                impl = selection.get(op.signature)
                traceable = (impl is not None and impl.backend == "torch"
                             and impl.traceable)
                if not traceable:
                    culprits[op.op_name] = culprits.get(op.op_name, 0) + 1
                    if uid < 0:
                        uid, name = op.uid, op.op_name
        if culprits:
            findings.append(Finding(
                "segment-split", SEV_INFO,
                f"non-traceable op(s) {sorted(culprits)} split two "
                "compilable segments; a traceable torch impl would fuse "
                "them into one compiled program",
                op_name=name, op_uid=uid,
                detail=tuple(sorted(culprits.items()))))
    return findings
