"""Public RMSNorm wrappers: the plain versions for a CPU tensor, the kernels
for a CUDA tensor (the forward in Triton, the backward in CUDA C++).  Where a
gradient is wanted, ``rmsnorm`` goes through an ``autograd.Function`` whose
backward is ``rmsnorm_bwd``."""

from __future__ import annotations

import torch

from ..common import kernel_device
from .kernel import rmsnorm_bwd_cuda, rmsnorm_triton
from .ref import rmsnorm_bwd_ref, rmsnorm_ref


def _forward(x, weight, eps):
    if kernel_device(x, weight) == "cuda":
        return rmsnorm_triton(x, weight, eps=eps)
    return rmsnorm_ref(x, weight, eps=eps)


def rmsnorm_bwd(x, weight, dy, eps: float = 1e-6):
    """(dx, dw) of rmsnorm for the upstream gradient ``dy``."""
    if kernel_device(x, weight, dy) == "cuda":
        return rmsnorm_bwd_cuda(x, weight, dy, eps=eps)
    return rmsnorm_bwd_ref(x, weight, dy, eps=eps)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _forward(x, weight, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, weight, dy.to(x.dtype), ctx.eps)
        return dx, dw.to(weight.dtype), None


def rmsnorm(x, weight, eps: float = 1e-6):
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _RMSNorm.apply(x, weight, eps)
    return _forward(x, weight, eps)
