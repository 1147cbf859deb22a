"""Public grouped-matmul wrapper: the plain version for a CPU tensor, the
CUDA kernel for a CUDA tensor.  Where a gradient is wanted, ``moe_gmm`` goes
through an ``autograd.Function`` whose backward is ``moe_gmm_bwd``: the
kernel on the card, the plain backward on the CPU (with equal groups its
batched form, as the forward's)."""

from __future__ import annotations

import torch

from ..common import kernel_device
from .kernel import moe_gmm_bwd_cuda, moe_gmm_cuda
from .ref import (moe_gmm_bwd_equal_ref, moe_gmm_bwd_ref, moe_gmm_equal_ref,
                  moe_gmm_ref)


def _forward(x, w, group_sizes, equal_groups):
    if kernel_device(x, w, group_sizes) == "cuda":
        return moe_gmm_cuda(x, w, group_sizes)
    if equal_groups is not None:
        return moe_gmm_equal_ref(x, w, equal_groups)
    return moe_gmm_ref(x, w, group_sizes)


def moe_gmm_bwd(x, w, dy, group_sizes, equal_groups: int | None = None):
    """(dx, dw) of the grouped matmul for the upstream gradient ``dy``;
    ``equal_groups`` as in :func:`moe_gmm`."""
    if kernel_device(x, w, dy, group_sizes) == "cuda":
        return moe_gmm_bwd_cuda(x, w, dy, group_sizes)
    if equal_groups is not None:
        return moe_gmm_bwd_equal_ref(x, w, dy, equal_groups)
    return moe_gmm_bwd_ref(x, w, dy, group_sizes)


class _MoeGmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group_sizes, equal_groups):
        ctx.save_for_backward(x, w, group_sizes)
        ctx.equal_groups = equal_groups
        return _forward(x, w, group_sizes, equal_groups)

    @staticmethod
    def backward(ctx, dy):
        x, w, group_sizes = ctx.saved_tensors
        dx, dw = moe_gmm_bwd(x, w, dy.to(x.dtype).contiguous(), group_sizes,
                             ctx.equal_groups)
        return dx, dw, None, None


def moe_gmm(x, w, group_sizes, equal_groups: int | None = None):
    """Per-expert matmul over expert-sorted rows.  x: (T, D); w: (E, D, F);
    group_sizes: (E,) int → (T, F) in x's dtype, accumulated in fp32.

    ``equal_groups=C`` promises that every group has exactly C rows (the
    capacity-based dispatch always does): the plain version then runs one
    batched product, as the JAX package's reference path does.  The kernel
    reads the sizes on the device either way.  The group sizes get no
    gradient."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _MoeGmm.apply(x, w, group_sizes, equal_groups)
    return _forward(x, w, group_sizes, equal_groups)
