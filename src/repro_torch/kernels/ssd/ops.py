"""Public SSD wrappers: ``ssd_scan`` runs the plain recurrence for a CPU
tensor and, for a CUDA tensor, the CUDA kernel of its (N, P) (zamba2's 64 /
64 or xlstm's 512 / 513; any other shape raises); ``ssd_step`` is the decode
step, plain torch ops on any device (the JAX package computes it outside any
Pallas kernel too)."""

from __future__ import annotations

import torch

from ..common import kernel_device
from .kernel import ssd_scan_cuda
from .ref import ssd_ref, ssd_step

__all__ = ["ssd_scan", "ssd_step"]


def ssd_scan(c, b, x, log_a, gate):
    """Chunked linear-recurrence scan.  c, b: (B, H, S, N); x: (B, H, S, P);
    log_a, gate: (B, H, S).  Returns (y (B, H, S, P) in x's dtype, s_final
    (B, H, N, P) fp32).  The plain version is differentiable; the kernel has
    no backward and raises where a gradient is wanted."""
    tensors = (c, b, x, log_a, gate)
    if kernel_device(*tensors) == "cuda":
        if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
            raise NotImplementedError(
                "the SSD kernel has no backward yet: hybrid training is "
                "queued in ROADMAP.md")
        return ssd_scan_cuda(c, b, x, log_a, gate)
    return ssd_ref(c, b, x, log_a, gate)
