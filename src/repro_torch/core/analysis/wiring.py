"""Wiring/schema validation — the cheap, always-on layer of the analyzer.

Checks only structural facts that make execution *certain* to fail: cycles,
out-of-range output references, missing required inputs, CONST ops without a
payload, and op names with no registered implementation of any kind.  The
rules deliberately mirror :func:`repro_torch.core.runtime.execute_reference`'s
fallback chain (registry impl → reference impl → ``spec["fn"]`` callable),
so anything flagged here is exactly what the runtime would later surface as
an op-dependent ``ExecutionError`` at dispatch time.

``validate_wiring`` runs on every submission (``Stratum.compile_batch``
calls it unconditionally) so malformed DAGs fail deterministically and
early even with admission analysis off — one structured error type,
independent of wave layout.
"""

from __future__ import annotations

from typing import Sequence

from ..dag import (CONST, ESTIMATOR, EVAL, FILTER, LazyRef, PROJECT,
                   TRANSFORM, toposort)
from ..lowering import is_lowerable
from ..selection import impls_for, reference_impl
from .report import Finding, SEV_ERROR

# op classes whose semantics require at least one input (a source/const/
# generic op may legitimately take none)
_NEEDS_INPUT = (TRANSFORM, PROJECT, FILTER, ESTIMATOR, EVAL)


def _has_implementation(op) -> bool:
    """Mirror of execute_reference's dispatch chain, without executing."""
    if op.op_class == CONST:
        return True
    if is_lowerable(op.op_name):       # composites dissolve before dispatch
        return True
    if impls_for(op.op_name):
        return True
    if reference_impl(op.op_name) is not None:
        return True
    return callable(op.spec.get("fn"))


def validate_wiring(sinks: Sequence[LazyRef]) -> list:
    """Return error findings for structurally-invalid wiring; [] if clean."""
    findings: list = []
    try:
        order = toposort(sinks)
    except ValueError as e:
        return [Finding("cycle", SEV_ERROR, str(e))]
    except RecursionError:
        return [Finding("cycle", SEV_ERROR,
                        "pipeline DAG too deep or cyclic")]

    for i, ref in enumerate(sinks):
        if not isinstance(ref, LazyRef):
            findings.append(Finding(
                "bad-sink", SEV_ERROR,
                f"sink {i} is {type(ref).__name__}, expected LazyRef"))
        elif not 0 <= ref.index < ref.op.n_outputs:
            findings.append(Finding(
                "bad-arity", SEV_ERROR,
                f"sink {i} references output {ref.index} of "
                f"{ref.op.op_name!r}, which has {ref.op.n_outputs}",
                op_name=ref.op.op_name, op_uid=ref.op.uid))

    for op in order:
        if op.n_outputs < 1:
            findings.append(Finding(
                "bad-arity", SEV_ERROR,
                f"op declares n_outputs={op.n_outputs}",
                op_name=op.op_name, op_uid=op.uid))
        for ref in op.inputs:
            if not 0 <= ref.index < ref.op.n_outputs:
                findings.append(Finding(
                    "bad-arity", SEV_ERROR,
                    f"input references output {ref.index} of "
                    f"{ref.op.op_name!r}, which has {ref.op.n_outputs}",
                    op_name=op.op_name, op_uid=op.uid,
                    detail=(("producer", ref.op.op_name),
                            ("index", ref.index))))
        if op.op_class == CONST and "value" not in op.spec:
            findings.append(Finding(
                "const-missing-value", SEV_ERROR,
                "CONST op has no 'value' in its spec",
                op_name=op.op_name, op_uid=op.uid))
        if op.op_class in _NEEDS_INPUT and not op.inputs:
            findings.append(Finding(
                "missing-input", SEV_ERROR,
                f"{op.op_class} op has no inputs",
                op_name=op.op_name, op_uid=op.uid))
        if not _has_implementation(op):
            findings.append(Finding(
                "unknown-op", SEV_ERROR,
                f"no implementation registered for {op.op_name!r} "
                "(no physical impl, no reference impl, no lowering, "
                "no spec['fn'] callable)",
                op_name=op.op_name, op_uid=op.uid))
    return findings
