"""Plain PyTorch SSD linear recurrence (the counterpart of
``repro.kernels.ssd.ref`` and of the decode step in ``repro.kernels.ssd.ops``).

Per head, with state S ∈ R^{N×P}:

    S_t = a_t · S_{t-1} + g_t · b_t x_tᵀ          (a_t = exp(log_a_t))
    y_t = c_tᵀ S_t

``ssd_ref`` runs the recurrence step by step in fp32: the CPU path of
``ssd_scan`` and the oracle the CUDA kernels are held against on the card.
``ssd_bwd_ref`` is its backward (the counterpart of ``jax.vjp`` of the JAX
``ssd_ref``), written as the two sweeps of ``csrc/ssd_scan_bwd.cu``.
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
    BH = B * H
    s = (torch.zeros((BH, N, P), dtype=torch.float32, device=x.device)
         if s0 is None else s0.float().reshape(BH, N, P))
    # every position's inputs cast, a_t = exp(log_a_t) and the step's
    # shapes made once before the loop (as the JAX oracle does before its
    # scan), the heads folded into one batch dim and one unbind each: a
    # step is then ssd_step's arithmetic alone, its product one bmm
    cs = c.float().reshape(BH, S, 1, N).unbind(1)        # (BH, 1, N)
    bs = b.float().reshape(BH, S, N, 1).unbind(1)        # (BH, N, 1)
    xs = x.float().reshape(BH, S, 1, P).unbind(1)        # (BH, 1, P)
    a_s = torch.exp(log_a.float()).reshape(BH, S, 1, 1).unbind(1)
    gs = gate.float().reshape(BH, S, 1, 1).unbind(1)     # (BH, 1, 1)
    ys = []
    for t in range(S):
        s = a_s[t] * s + gs[t] * (bs[t] * xs[t])
        ys.append(torch.bmm(cs[t], s))                   # (BH, 1, P)
    y = torch.cat(ys, dim=1).reshape(B, H, S, P)
    return y.to(x.dtype), s.reshape(B, H, N, P)


def ssd_bwd_ref(c, b, x, log_a, gate, dy, ds_final=None):
    """The gradients of ``ssd_ref``'s (y, s_final) for the upstream dy
    (B, H, S, P) and the optional ds_final (B, H, N, P), in two sweeps.
    With G_t = ∂L/∂S_t = c_t dy_tᵀ + a_{t+1}·G_{t+1} (G after the last row
    is ds_final, else 0):

        forward:  S_t again in fp32, dc_t = S_t dy_t, r_t = c_t·dc_t
        reverse:  db_t = g_t·G_t x_t, dx_t = g_t·G_tᵀ b_t,
                  dgate_t = b_t·G_t x_t
        dlog_a_t = Σ_{u ≥ t} (r_u − g_u·dgate_u) + ⟨ds_final, S_last⟩

    Returns (dc, db, dx, dlog_a, dgate) in fp32, per head: where c and b
    are shared by the heads, the caller's expand folds dc and db."""
    B, H, S, N = c.shape
    P = x.shape[-1]
    BH = B * H
    cf = c.float().reshape(BH, S, N)
    bf = b.float().reshape(BH, S, N)
    cs = cf.reshape(BH, S, N, 1).unbind(1)              # (BH, N, 1)
    bs = bf.reshape(BH, S, N, 1).unbind(1)
    xs = x.float().reshape(BH, S, 1, P).unbind(1)        # (BH, 1, P)
    dys = dy.float().reshape(BH, S, 1, P).unbind(1)
    a_s = torch.exp(log_a.float()).reshape(BH, S, 1, 1).unbind(1)
    g = gate.float().reshape(BH, S)
    gs = g.reshape(BH, S, 1, 1).unbind(1)
    s = torch.zeros((BH, N, P), dtype=torch.float32, device=x.device)
    dcs = []
    for t in range(S):                                   # as ssd_ref
        s = a_s[t] * s + gs[t] * (bs[t] * xs[t])
        dcs.append(torch.bmm(s, dys[t].transpose(1, 2)))  # (BH, N, 1)
    dc = torch.cat(dcs, dim=2).transpose(1, 2)           # (BH, S, N)
    r = (cf * dc).sum(-1)
    G = (torch.zeros_like(s) if ds_final is None
         else ds_final.float().reshape(BH, N, P).clone())
    gx, gtb = [None] * S, [None] * S
    for t in range(S - 1, -1, -1):
        if t < S - 1:
            G = a_s[t + 1] * G
        G = G + cs[t] * dys[t]
        gx[t] = torch.bmm(G, xs[t].transpose(1, 2))       # (BH, N, 1)
        gtb[t] = torch.bmm(G.transpose(1, 2), bs[t])      # (BH, P, 1)
    gx = torch.cat(gx, dim=2).transpose(1, 2)            # (BH, S, N)
    gtb = torch.cat(gtb, dim=2).transpose(1, 2)          # (BH, S, P)
    dgate = (bf * gx).sum(-1)
    dlog_a = (r - g * dgate).flip(-1).cumsum(-1).flip(-1)
    if ds_final is not None:
        dlog_a = dlog_a + (ds_final.float().reshape(BH, N, P) * s).sum(
            (1, 2))[:, None]
    return (dc.reshape(B, H, S, N), (g[..., None] * gx).reshape(B, H, S, N),
            (g[..., None] * gtb).reshape(B, H, S, P),
            dlog_a.reshape(B, H, S), dgate.reshape(B, H, S))


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
