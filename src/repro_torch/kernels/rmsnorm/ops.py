"""Public RMSNorm wrapper: the plain version for a CPU tensor, the Triton
kernel for a CUDA tensor."""

from __future__ import annotations

from ..common import kernel_device
from .kernel import rmsnorm_triton
from .ref import rmsnorm_ref


def rmsnorm(x, weight, eps: float = 1e-6):
    if kernel_device(x, weight) == "cuda":
        return rmsnorm_triton(x, weight, eps=eps)
    return rmsnorm_ref(x, weight, eps=eps)
