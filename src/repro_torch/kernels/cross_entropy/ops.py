"""Fused cross-entropy public wrapper (the counterpart of
``repro.kernels.cross_entropy.ops``): an ``autograd.Function`` whose forward
is the CUDA kernel for a CUDA tensor (the chunked plain version for a CPU
one) and whose backward is the chunked recompute of JAX's ``_ce_bwd``.

``n_valid`` supports padded unembedding matrices: columns at or past it are
excluded from the softmax exactly.  The kernel masks them itself, so it
serves both branches of JAX's ``_forward_dispatch`` (the Pallas kernel at
``n_valid == V`` and ``_forward_chunked`` below it).
"""

from __future__ import annotations

import torch

from ..common import kernel_device
from .kernel import ce_forward_cuda
from .ref import ce_backward_chunked, ce_forward_chunked


def ce_forward(x, w, labels, n_valid: int | None = None):
    """(lse, label_logit), each (T,) fp32."""
    n_valid = w.shape[1] if n_valid is None else int(n_valid)
    if kernel_device(x, w, labels) == "cuda":
        return ce_forward_cuda(x, w, labels, n_valid)
    return ce_forward_chunked(x, w, labels, n_valid)


class _FusedCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, labels, valid, n_valid):
        lse, ll = ce_forward(x, w, labels, n_valid)
        vf = valid.float()
        loss = ((lse - ll) * vf).sum() / vf.sum().clamp_min(1.0)
        ctx.save_for_backward(x, w, labels, valid, lse)
        ctx.n_valid = n_valid
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w, labels, valid, lse = ctx.saved_tensors
        dx, dw = ce_backward_chunked(x, w, labels, valid, lse, g,
                                     ctx.n_valid)
        return dx, dw, None, None, None


def fused_cross_entropy(x, w, labels, valid=None, n_valid: int | None = None):
    """Mean NLL of labels under softmax(x @ w[:, :n_valid]) without
    materializing the logits.  x: (..., D); w: (D, V); labels: (...) int;
    valid: optional bool mask of labels' shape."""
    x2 = x.reshape(-1, x.shape[-1])
    lab = labels.reshape(-1).to(torch.int32)
    val = (torch.ones(lab.shape, dtype=torch.bool, device=lab.device)
           if valid is None else valid.reshape(-1))
    nv = w.shape[1] if n_valid is None else int(n_valid)
    return _FusedCrossEntropy.apply(x2, w, lab, val, nv)
