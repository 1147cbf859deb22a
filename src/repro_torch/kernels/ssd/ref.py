"""Plain PyTorch SSD linear recurrence (the counterpart of
``repro.kernels.ssd.ref`` and of the decode step in ``repro.kernels.ssd.ops``).

Per head, with state S ∈ R^{N×P}:

    S_t = a_t · S_{t-1} + g_t · b_t x_tᵀ          (a_t = exp(log_a_t))
    y_t = c_tᵀ S_t

``ssd_ref`` runs the recurrence step by step in fp32: the CPU path of
``ssd_scan`` and the oracle the CUDA kernels are held against on the card.
``ssd_chunked_ref`` computes the same function in the kernels' chunked
decomposition (the Mamba2 "state-space duality" form of the JAX package's
Pallas kernel), in fp32, with the chunk length an argument;
``ssd_chunk_m`` is its first part, each chunk's masked, decayed c·bᵀ and
gates, which the wide CUDA kernel's first pass writes and the card check
holds against this.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


def _chunks(t, chunk):
    """(B, H, S, ...) → (B, H, S/chunk, chunk, ...), rows past S zero (the
    JAX wrapper's padding: log_a = gate = 0 there, so they add nothing)."""
    B, H, S = t.shape[:3]
    n = -(-S // chunk) * chunk
    pad = [0, 0] * (t.dim() - 3) + [0, n - S]
    return F.pad(t.float(), pad).reshape(B, H, n // chunk, chunk,
                                         *t.shape[3:])


def ssd_chunk_m(c, b, log_a, gate, chunk=64):
    """Each chunk's M[i, j] = (c_i·b_j) exp(l_i − l_j) g_j for j <= i, else 0
    (the mask a select taken before the exp, as in the kernels), with l the
    inclusive cumulative sum of log_a within the chunk, and the gates
    exp(l_i), w_j = exp(l_L − l_j) g_j and exp(l_L).  c, b: (B, H, S, N);
    log_a, gate: (B, H, S).  Returns M (B, H, n, L, L), e and w (B, H, n, L)
    and decay (B, H, n), fp32."""
    l = _chunks(log_a, chunk).cumsum(-1)
    g = _chunks(gate, chunk)
    ltot = l[..., -1:]
    cb = _chunks(c, chunk) @ _chunks(b, chunk).transpose(-1, -2)
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=c.device).tril()
    diff = torch.where(tri, l[..., :, None] - l[..., None, :], 0.0)
    m = torch.where(tri, cb * torch.exp(diff) * g[..., None, :], 0.0)
    return m, torch.exp(l), torch.exp(ltot - l) * g, torch.exp(ltot[..., 0])


def ssd_chunked_ref(c, b, x, log_a, gate, chunk=64):
    """``ssd_ref``'s function in the chunked form, fp32: per chunk
    y = exp(l_i)·(c S) + M x and S ← exp(l_L) S + (b·w)ᵀ x.  Same arguments
    and results as ``ssd_ref`` (no initial state)."""
    B, H, S, N = c.shape
    P = x.shape[-1]
    m, e, w, decay = ssd_chunk_m(c, b, log_a, gate, chunk)
    cc, bb, xx = (_chunks(t, chunk) for t in (c, b, x))
    s = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for k in range(cc.shape[2]):
        ys.append(e[:, :, k, :, None] * (cc[:, :, k] @ s)
                  + m[:, :, k] @ xx[:, :, k])
        s = (decay[:, :, k, None, None] * s
             + (bb[:, :, k] * w[:, :, k, :, None]).transpose(-1, -2)
             @ xx[:, :, k])
    y = torch.cat(ys, dim=2)[:, :, :S]
    return y.to(x.dtype), s
