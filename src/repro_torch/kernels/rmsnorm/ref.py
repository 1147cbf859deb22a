"""Plain PyTorch RMSNorm (the counterpart of ``repro.kernels.rmsnorm.ref``)."""

from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    """x: (..., D); weight: (D,).  fp32 statistics, output in x.dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)
