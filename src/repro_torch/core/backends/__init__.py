"""Pluggable execution backends for the stratum runtime.

See :mod:`.base` for the seam and :mod:`.python_thread` for the per-op
path.  The whole-segment compiled backend with the structural plan cache
is ``ROADMAP.md`` A2b.
"""

from .base import (ExecutionBackend, available_backends, make_backends,
                   register_backend)
from .python_thread import PythonThreadBackend

__all__ = [
    "ExecutionBackend",
    "PythonThreadBackend",
    "available_backends",
    "make_backends",
    "register_backend",
]
