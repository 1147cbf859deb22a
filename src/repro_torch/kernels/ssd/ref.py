"""Plain PyTorch SSD linear recurrence (the counterpart of
``repro.kernels.ssd.ref`` and of the decode step in ``repro.kernels.ssd.ops``).

Per head, with state S ∈ R^{N×P}:

    S_t = a_t · S_{t-1} + g_t · b_t x_tᵀ          (a_t = exp(log_a_t))
    y_t = c_tᵀ S_t

``ssd_ref`` runs the recurrence step by step in fp32: the CPU path of
``ssd_scan`` and the oracle the CUDA kernels are held against on the card.
``ssd_bwd_ref`` is its backward (the counterpart of ``jax.vjp`` of the JAX
``ssd_ref``), step by step in two sweeps: the oracle of the backward.
``ssd_chunked_ref`` computes the same function in the kernels' chunked
decomposition (the Mamba2 "state-space duality" form of the JAX package's
Pallas kernel), in fp32, with the chunk length an argument;
``ssd_chunk_m`` is its first part, each chunk's masked, decayed c·bᵀ and
gates, which the wide CUDA kernel's first pass writes and the card check
holds against this.  ``ssd_chunked_bwd_ref`` is the backward in the same
chunked form, the decomposition of ``csrc/ssd_scan_bwd.cu``: the CPU path of
the backward and the plain version the kernel is held against.
``ssd_dlog_a_telescoped`` is dlog_a in the form ``csrc/ssd_scan_bwd_wide.cu``
takes it, a reverse sum over the whole sequence, from the backward's dc and
dgate.
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
    """c, b: (B, H, S, N), or (B, 1, S, N) shared by the heads; x: (B, H,
    S, P); log_a, gate: (B, H, S); s0: optional (B, H, N, P) initial state.
    Returns (y (B, H, S, P) in x's dtype, s_final (B, H, N, P) fp32)."""
    B, _, S, N = c.shape
    H, P = x.shape[1], x.shape[-1]
    c, b = (t.expand(B, H, S, N) for t in (c, b))
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


def _chunks(t, chunk, dtype=torch.float32):
    """(B, H, S, ...) → (B, H, S/chunk, chunk, ...) in ``dtype``, rows past
    S zero (the JAX wrapper's padding: log_a = gate = 0 there, so they add
    nothing)."""
    B, H, S = t.shape[:3]
    n = -(-S // chunk) * chunk
    pad = [0, 0] * (t.dim() - 3) + [0, n - S]
    return F.pad(t.to(dtype), pad).reshape(B, H, n // chunk, chunk,
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


def ssd_chunked_bwd_ref(c, b, x, log_a, gate, dy, ds_final=None, chunk=64):
    """``ssd_bwd_ref``'s function in the chunked form of the backward kernel,
    fp32.  c, b: (B, Hc, S, N) with Hc = H, or Hc = 1 for a c and b shared
    by the heads; x, dy: (B, H, S, P); log_a, gate: (B, H, S); ds_final:
    (B, H, N, P) or None for zero.

    Per chunk, with l the inclusive cumulative sum of log_a within it,
    e_i = exp(l_i), u_j = exp(l_L − l_j), w_j = u_j g_j, D_ij =
    exp(l_i − l_j) g_j for j <= i (the mask a select taken before the exp),
    M = (c bᵀ) ∘ D, S_in the state entering the chunk and Ĝ the gradient
    that reaches its last state from later chunks (ds_final at the last):

        S_in ← exp(l_L) S_in + bᵀ(w ∘ x)    Ĝ ← exp(l_L) Ĝ + cᵀ(e ∘ dy)
        dx = Mᵀ dy + w ∘ (b Ĝ)              dM = tril(dy xᵀ)
        dc = e ∘ (dy S_inᵀ) + (dM ∘ D) b     db = (dM ∘ D)ᵀ c + w ∘ (x Ĝᵀ)
        dgate_j = Σ_i dM_ij (c_i·b_j) exp(l_i − l_j) + u_j b_j·(Ĝ x_j)
        dlog_a_t = Σ_{u >= t in the chunk} (c_u·dc_u − g_u dgate_u)
                   + exp(l_L)⟨Ĝ, S_in⟩ + Σ_j w_j b_j·(Ĝ x_j)

    (the last term is ⟨Ĝ, S_out⟩, the state leaving the chunk: dlog_a needs
    no pass over the chunks).  The gates' cumulative sums and exps are taken
    in fp64 and rounded once, so that l_i − l_j keeps fp32's relative
    precision however far l falls.  Returns (dc, db, dx, dlog_a, dgate) in
    fp32: dc and db of c's shape, summed over the heads where Hc = 1."""
    B, Hc, S, N = c.shape
    H, P = x.shape[1], x.shape[-1]
    if Hc == 1 and H > 1:
        c, b = (t.expand(B, H, S, N) for t in (c, b))
    cc, bb, xx, dyy = (_chunks(t, chunk) for t in (c, b, x, dy))
    l = _chunks(log_a, chunk, torch.float64).cumsum(-1)     # (B, H, n, L)
    g = _chunks(gate, chunk)
    ltot = l[..., -1:]
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    E = torch.where(tri, torch.exp(torch.where(
        tri, l[..., :, None] - l[..., None, :], 0.0)), 0.0).float()  # [i, j]
    e, u = torch.exp(l).float(), torch.exp(ltot - l).float()
    decay = torch.exp(ltot[..., 0]).float()                     # (B, H, n)
    w = u * g
    # the state passes: S_in entering each chunk, Ĝ reaching each chunk's end
    n = cc.shape[2]
    s = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    s_in = []
    for k in range(n):
        s_in.append(s)
        s = (decay[:, :, k, None, None] * s
             + (bb[:, :, k] * w[:, :, k, :, None]).transpose(-1, -2)
             @ xx[:, :, k])
    G = (torch.zeros_like(s) if ds_final is None
         else ds_final.float().reshape(B, H, N, P))
    g_hat = [None] * n
    for k in range(n - 1, -1, -1):
        g_hat[k] = G
        G = (decay[:, :, k, None, None] * G
             + (cc[:, :, k] * e[:, :, k, :, None]).transpose(-1, -2)
             @ dyy[:, :, k])
    s_in, g_hat = torch.stack(s_in, 2), torch.stack(g_hat, 2)
    # each chunk on its own, given its S_in and Ĝ
    cb = cc @ bb.transpose(-1, -2)                              # [i, j]
    D = E * g[..., None, :]
    dm = dyy @ xx.transpose(-1, -2)                             # [i, j]
    pd = dm * D                                                 # dM ∘ D
    xg = xx @ g_hat.transpose(-1, -2)                           # x Ĝᵀ
    dx = ((cb * D).transpose(-1, -2) @ dyy
          + w[..., None] * (bb @ g_hat))
    dc = e[..., None] * (dyy @ s_in.transpose(-1, -2)) + pd @ bb
    db = pd.transpose(-1, -2) @ cc + w[..., None] * xg
    q = (bb * xg).sum(-1)                                       # b_j·(Ĝ x_j)
    dgate = (dm * cb * E).sum(-2) + u * q
    v = (cc * dc).sum(-1) - g * dgate
    carry = (decay * (g_hat * s_in).sum((-2, -1))
             + (w * q).sum(-1))[..., None]
    dlog_a = v.flip(-1).cumsum(-1).flip(-1) + carry
    dc, db, dx, dlog_a, dgate = (
        t.reshape(B, H, n * chunk, *t.shape[4:])[:, :, :S]
        for t in (dc, db, dx, dlog_a, dgate))
    if Hc == 1 and H > 1:
        dc, db = (t.sum(1, keepdim=True) for t in (dc, db))
    return dc, db, dx, dlog_a, dgate


def ssd_dlog_a_telescoped(c, b, x, log_a, gate, dc, dgate, ds_final=None,
                          chunk=64):
    """dlog_a as ``csrc/ssd_scan_bwd_wide.cu`` takes it.  ⟨G_t, S_t⟩
    telescopes over the whole sequence (⟨G_t, S_t⟩ − ⟨G_{t−1}, S_{t−1}⟩ =
    c_t·dc_t − g_t dgate_t), so

        dlog_a_t = Σ_{u ≥ t} (c_u·dc_u − g_u dgate_u) + ⟨ds_final, S_final⟩,
        ⟨ds_final, S_final⟩ = exp(l_L)⟨ds_final, S_in⟩
                              + Σ_j w_j b_j·(ds_final x_j)

    over the last chunk (l, w as in ``ssd_chunked_bwd_ref``, S_in the state
    entering it): no per-chunk ⟨Ĝ, S_in⟩, and at S ≤ ``chunk`` the constant
    is the twin's carry term for term.  The sum over u in fp64.  c, b: (B,
    H, S, N) per head; x: (B, H, S, P); log_a, gate: (B, H, S); dc, dgate:
    the backward's (fp32); ds_final: (B, H, N, P) or None for zero.
    Returns dlog_a (B, H, S) fp32."""
    S = c.shape[2]
    v = (c.float() * dc.float()).sum(-1) - gate.float() * dgate.float()
    dlog_a = v.double().flip(-1).cumsum(-1).flip(-1)
    if ds_final is not None:
        s0 = (S - 1) // chunk * chunk            # the last chunk's first row
        l = log_a[:, :, s0:].double().cumsum(-1)
        ltot = l[..., -1:]
        w = torch.exp(ltot - l).float() * gate[:, :, s0:].float()
        ds = ds_final.float()
        s_in = (ssd_chunked_ref(*(t[:, :, :s0] for t in
                                  (c, b, x, log_a, gate)), chunk)[1]
                if s0 else torch.zeros_like(ds))
        q = (b[:, :, s0:].float()
             * (x[:, :, s0:].float() @ ds.transpose(-1, -2))).sum(-1)
        const = (torch.exp(ltot[..., 0]).float() * (ds * s_in).sum((-2, -1))
                 + (w * q).sum(-1))
        dlog_a = dlog_a + const.double()[..., None]
    return dlog_a.float()
