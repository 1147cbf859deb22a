"""Static pipeline analysis: pre-flight verification without execution.

See docs/ANALYSIS.md for the rule catalog, report format and admission
semantics.  Public surface:

* :func:`analyze` — full analysis (wiring, shape inference, lint,
  compile feasibility) returning an :class:`AnalysisReport`,
* :func:`validate_wiring` — the cheap always-on structural subset,
* :class:`AnalysisError` — the picklable rejection raised at submit,
* :func:`register_check` — extend the shape pass with per-op
  input-consistency rules.
"""

from .analyzer import analyze
from .infer import has_check, infer_shapes, register_check
from .lint import lint_pipeline
from .report import (AnalysisError, AnalysisReport, Finding, SEV_ERROR,
                     SEV_INFO, SEV_WARNING, find)
from .wiring import validate_wiring

__all__ = [
    "analyze", "AnalysisError", "AnalysisReport", "Finding",
    "SEV_ERROR", "SEV_INFO", "SEV_WARNING", "find", "has_check",
    "infer_shapes", "lint_pipeline", "register_check", "validate_wiring",
]
