"""Public SSD wrappers: ``ssd_scan`` runs the plain recurrence for a CPU
tensor and, for a CUDA tensor, the CUDA kernel of its (N, P) (zamba2's 64 /
64 or xlstm's 512 / 513; any other shape raises); ``ssd_step`` is the decode
step, plain torch ops on any device (the JAX package computes it outside any
Pallas kernel too).

Where a gradient is wanted, ``ssd_scan`` goes through an
``autograd.Function`` whose backward is ``ssd_scan_bwd``: the backward
kernel on the card (at 64 / 64; xlstm's 512 / 513 raises), its plain
chunked twin ``ssd_chunked_bwd_ref`` on the CPU.  It saves the inputs, not
the states: the backward runs the recurrence again.

c and b may have a head dim of 1, shared by x's heads (zamba2's block):
both paths read them over the heads, and their gradients come back summed
over the heads in that shape, so no per-head gradient is cast or folded."""

from __future__ import annotations

import torch

from ..common import kernel_device
from .kernel import check_bwd_shape, ssd_scan_bwd_cuda, ssd_scan_cuda
from .ref import ssd_chunked_bwd_ref, ssd_ref, ssd_step

__all__ = ["ssd_scan", "ssd_scan_bwd", "ssd_step"]


def _forward(c, b, x, log_a, gate):
    if kernel_device(c, b, x, log_a, gate) == "cuda":
        return ssd_scan_cuda(c, b, x, log_a, gate)
    return ssd_ref(c, b, x, log_a, gate)


def ssd_scan_bwd(c, b, x, log_a, gate, dy, ds_final=None):
    """(dc, db, dx, dlog_a, dgate) of the scan for the upstream dy and the
    optional ds_final (``ref.ssd_chunked_bwd_ref``): dc and db of c's shape,
    summed over the heads where its head dim is 1; dx, dc, db in the
    inputs' dtype from the kernel, fp32 from the plain version; dlog_a and
    dgate fp32."""
    tensors = (c, b, x, log_a, gate, dy) + (
        () if ds_final is None else (ds_final,))
    if kernel_device(*tensors) == "cuda":
        return ssd_scan_bwd_cuda(c, b, x, log_a, gate, dy, ds_final)
    return ssd_chunked_bwd_ref(c, b, x, log_a, gate, dy, ds_final)


class _SsdScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, c, b, x, log_a, gate):
        ctx.save_for_backward(c, b, x, log_a, gate)
        ctx.set_materialize_grads(False)
        return _forward(c, b, x, log_a, gate)

    @staticmethod
    def backward(ctx, dy, ds_final):
        inputs = ctx.saved_tensors
        x = inputs[2]
        if dy is None:                   # only s_final is used
            dy = torch.zeros_like(x)
        grads = ssd_scan_bwd(*inputs, dy, ds_final)
        return tuple(g.to(t.dtype) for g, t in zip(grads, inputs))


def ssd_scan(c, b, x, log_a, gate):
    """Chunked linear-recurrence scan.  c, b: (B, H, S, N), or (B, 1, S, N)
    shared by the heads; x: (B, H, S, P); log_a, gate: (B, H, S).  Returns
    (y (B, H, S, P) in x's dtype, s_final (B, H, N, P) fp32),
    differentiable in all five inputs."""
    tensors = (c, b, x, log_a, gate)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        if kernel_device(*tensors) == "cuda":
            check_bwd_shape(c.shape[-1], x.shape[-1])
        return _SsdScan.apply(*tensors)
    return _forward(*tensors)
