"""Plain PyTorch RMSNorm (the counterpart of ``repro.kernels.rmsnorm.ref``)."""

from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    """x: (..., D); weight: (D,).  fp32 statistics, output in x.dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-6):
    """The gradient of :func:`rmsnorm_ref`: (dx in x.dtype, dw in fp32).

    With r = rsqrt(mean(x²) + eps), x̂ = x·r and g = dy·w:
    dx = r·(g − x̂·mean(g·x̂)), dw = Σ_rows dy·x̂."""
    D = x.shape[-1]
    xf = x.float()
    rstd = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    xhat = xf * rstd
    dyf = dy.float()
    g = dyf * weight.float()
    dx = rstd * (g - xhat * (g * xhat).mean(dim=-1, keepdim=True))
    dw = (dyf * xhat).reshape(-1, D).sum(dim=0)
    return dx.to(x.dtype), dw
