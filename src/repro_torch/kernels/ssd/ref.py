"""Plain PyTorch SSD linear recurrence (the counterpart of
``repro.kernels.ssd.ref`` and of the decode step in ``repro.kernels.ssd.ops``).

Per head, with state S ∈ R^{N×P}:

    S_t = a_t · S_{t-1} + g_t · b_t x_tᵀ          (a_t = exp(log_a_t))
    y_t = c_tᵀ S_t

``ssd_ref`` runs the recurrence step by step in fp32: the CPU path of
``ssd_scan`` and the oracle the CUDA kernel is held against on the card.
"""

from __future__ import annotations

import torch


def ssd_step(s, c_t, b_t, x_t, log_a_t, gate_t):
    """One step of the recurrence (the decode step).  s: (B, H, N, P) fp32;
    c_t, b_t: (B, H, N); x_t: (B, H, P); log_a_t, gate_t: (B, H).
    Returns (y_t (B, H, P) in x_t's dtype, s_new (B, H, N, P) fp32)."""
    a = torch.exp(log_a_t.float())[..., None, None]
    g = gate_t.float()[..., None, None]
    outer = b_t.float()[..., :, None] * x_t.float()[..., None, :]
    s_new = a * s + g * outer
    y = torch.einsum("bhn,bhnp->bhp", c_t.float(), s_new)
    return y.to(x_t.dtype), s_new


def ssd_ref(c, b, x, log_a, gate, s0=None):
    """c, b: (B, H, S, N); x: (B, H, S, P); log_a, gate: (B, H, S);
    s0: optional (B, H, N, P) initial state.
    Returns (y (B, H, S, P) in x's dtype, s_final (B, H, N, P) fp32)."""
    B, H, S, N = c.shape
    P = x.shape[-1]
    s = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
         if s0 is None else s0.float())
    ys = []
    for t in range(S):
        y, s = ssd_step(s, c[:, :, t], b[:, :, t], x[:, :, t],
                        log_a[:, :, t], gate[:, :, t])
        ys.append(y)
    return torch.stack(ys, dim=2), s
