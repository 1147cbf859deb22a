"""Pluggable execution backends for the stratum runtime.

See :mod:`.base` for the seam, :mod:`.python_thread` for the per-op
path and :mod:`.torch_segment` for whole-segment compilation with the
structural plan cache.
"""

from .base import (ExecutionBackend, available_backends, make_backends,
                   register_backend)
from .python_thread import PythonThreadBackend
from .torch_segment import TorchSegmentBackend

__all__ = [
    "ExecutionBackend",
    "PythonThreadBackend",
    "TorchSegmentBackend",
    "available_backends",
    "make_backends",
    "register_backend",
]
