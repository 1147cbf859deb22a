"""Typed findings, the analysis report, and the picklable rejection error.

Everything in this module is built from primitives (tuples, strings, ints)
so a report — or an :class:`AnalysisError` raised at admission — pickles
through the fabric envelope codec unchanged, exactly like ``AdmissionError``
and ``ExecutionError`` do.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

SEV_ERROR = "error"        # pipeline is statically invalid; execution WILL fail
SEV_WARNING = "warning"    # legal but suspicious (perf or cache pathology)
SEV_INFO = "info"          # observations (CSE opportunities, dead outputs)

SEVERITIES = (SEV_ERROR, SEV_WARNING, SEV_INFO)


@dataclass(frozen=True)
class Finding:
    """One analyzer observation, with op-level provenance.

    ``detail`` is a tuple of ``(key, value)`` pairs (primitives only) so the
    finding stays hashable and picklable.
    """
    rule: str                # e.g. "cycle", "unknown-op", "shape-mismatch"
    severity: str            # one of SEVERITIES
    message: str
    op_name: str = ""        # "" for DAG-level findings
    op_uid: int = -1         # uid of the offending op (-1 for DAG-level)
    detail: tuple = ()       # extra provenance: ((key, value), ...)

    def __post_init__(self) -> None:
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    def as_dict(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "message": self.message, "op_name": self.op_name,
                "op_uid": self.op_uid, "detail": dict(self.detail)}

    def __str__(self) -> str:
        where = f" @{self.op_name}" if self.op_name else ""
        return f"[{self.severity}] {self.rule}{where}: {self.message}"


@dataclass
class AnalysisReport:
    """Result of statically analyzing a pipeline batch.

    ``op_shapes`` maps op signature -> tuple of ``(shape, dtype)`` pairs, one
    per output — the inferred abstract value of every op the shape pass
    reached.  ``segments`` is the compile-feasibility classification: one
    summary dict per predicted execution segment (kind, op count, and for
    compiled segments the predicted plan-cache key digest).
    """
    findings: tuple = ()                 # tuple[Finding]
    op_shapes: dict = field(default_factory=dict)
    segments: tuple = ()                 # tuple[dict]
    n_ops: int = 0
    n_pipelines: int = 0
    analysis_time_s: float = 0.0
    preverified_segments: int = 0        # compiled segments whose probe was
    #                                      statically discharged (see
    #                                      TorchSegmentBackend.mark_preverified)

    # -- views ----------------------------------------------------------
    @property
    def errors(self) -> tuple:
        return tuple(f for f in self.findings if f.severity == SEV_ERROR)

    @property
    def warnings(self) -> tuple:
        return tuple(f for f in self.findings if f.severity == SEV_WARNING)

    @property
    def infos(self) -> tuple:
        return tuple(f for f in self.findings if f.severity == SEV_INFO)

    @property
    def ok(self) -> bool:
        return not self.errors

    def by_rule(self) -> dict[str, int]:
        tally: dict[str, int] = {}
        for f in self.findings:
            tally[f.rule] = tally.get(f.rule, 0) + 1
        return tally

    def raise_if_invalid(self) -> None:
        if not self.ok:
            raise AnalysisError(self.errors)

    # -- serialization --------------------------------------------------
    def as_dict(self) -> dict:
        return {
            "ok": self.ok,
            "findings": [f.as_dict() for f in self.findings],
            "op_shapes": {sig: [list(pair) for pair in outs]
                          for sig, outs in self.op_shapes.items()},
            "segments": [dict(s) for s in self.segments],
            "n_ops": self.n_ops,
            "n_pipelines": self.n_pipelines,
            "analysis_time_s": self.analysis_time_s,
            "preverified_segments": self.preverified_segments,
        }

    def summary(self) -> str:
        head = ("OK" if self.ok
                else f"REJECTED ({len(self.errors)} errors)")
        lines = [f"analysis: {head} — {self.n_ops} ops, "
                 f"{len(self.segments)} segments, "
                 f"{self.analysis_time_s * 1e3:.2f}ms"]
        lines.extend(str(f) for f in self.findings)
        return "\n".join(lines)


class AnalysisError(RuntimeError):
    """A pipeline was rejected by static analysis before execution.

    Carries the error findings with op-level provenance.  Picklable with
    plain pickle (findings are frozen primitive dataclasses), so it rides
    the fabric envelope codec across process boundaries intact — the same
    contract ``AdmissionError`` has at ``Session.submit``.
    """

    def __init__(self, findings: Sequence[Finding], message: str = ""):
        self.findings = tuple(findings)
        if not message:
            errs = [f for f in self.findings if f.severity == SEV_ERROR]
            shown = "; ".join(
                f"{f.rule}@{f.op_name or '<dag>'}: {f.message}"
                for f in errs[:3])
            more = f" (+{len(errs) - 3} more)" if len(errs) > 3 else ""
            message = f"pipeline rejected by static analysis: {shown}{more}"
        super().__init__(message)

    @property
    def rules(self) -> tuple:
        return tuple(f.rule for f in self.findings)

    def __reduce__(self):
        return (AnalysisError, (self.findings, self.args[0]))


def find(findings: Sequence[Finding], rule: str,
         severity: Optional[str] = None) -> list:
    """Filter helper used by tests and the AIDE repair loop."""
    return [f for f in findings
            if f.rule == rule and (severity is None
                                   or f.severity == severity)]
