"""Static pipeline analysis: pre-flight verification without execution.

The port carries the cheap always-on structural subset that
``Stratum.compile_batch`` runs on every batch:

* :func:`validate_wiring` — wiring/schema validation,
* :class:`AnalysisError` — the picklable rejection it raises,
* :class:`AnalysisReport` / :class:`Finding` — the typed report.

The full analysis of the reference (``analyze``: shape inference, lint,
compile feasibility) is ``ROADMAP.md`` A2c.
"""

from .report import (AnalysisError, AnalysisReport, Finding, SEV_ERROR,
                     SEV_INFO, SEV_WARNING, find)
from .wiring import validate_wiring

__all__ = [
    "AnalysisError", "AnalysisReport", "Finding",
    "SEV_ERROR", "SEV_INFO", "SEV_WARNING", "find", "validate_wiring",
]
