"""Public grouped-matmul wrapper: the plain version for a CPU tensor, the
CUDA kernel for a CUDA tensor."""

from __future__ import annotations

import torch

from ..common import kernel_device
from .kernel import moe_gmm_cuda
from .ref import moe_gmm_equal_ref, moe_gmm_ref


def moe_gmm(x, w, group_sizes, equal_groups: int | None = None):
    """Per-expert matmul over expert-sorted rows.  x: (T, D); w: (E, D, F);
    group_sizes: (E,) int → (T, F) in x's dtype, accumulated in fp32.

    ``equal_groups=C`` promises that every group has exactly C rows (the
    capacity-based dispatch always does): the plain version then runs one
    batched product, as the JAX package's reference path does.  The kernel
    reads the sizes on the device either way.  It has no backward and
    raises where a gradient is wanted."""
    if kernel_device(x, w, group_sizes) == "cuda":
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            raise NotImplementedError(
                "the moe_gmm kernel has no backward yet: MoE training is "
                "queued in ROADMAP.md")
        return moe_gmm_cuda(x, w, group_sizes)
    if equal_groups is not None:
        return moe_gmm_equal_ref(x, w, equal_groups)
    return moe_gmm_ref(x, w, group_sizes)
