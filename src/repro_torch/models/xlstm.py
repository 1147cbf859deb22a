"""xLSTM blocks (the counterpart of ``repro.models.xlstm``): the mLSTM
(matrix memory, on the chunked SSD scan) and the sLSTM (scalar memory with
recurrent gating, a sequential loop).

The JAX package's documented deviations from the xLSTM reference are kept:
the mLSTM input gate is σ(i); the normalizer n_t = f·n_{t-1} + i·k_t rides
in the SSD state as an extra value column of ones, so y = (q·S)/max(|q·n|, 1)
comes out of the same scan; no causal conv on the q/k path.

Dtypes follow JAX's promotion: ``x (bf16) @ w_gates (fp32)`` and
``zx (bf16) + b (fp32)`` are fp32; the q scale and the normalizer division
run in the model dtype (the scale is rounded to that dtype first, as JAX
does with a Python scalar).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ssd.ops import ssd_scan, ssd_step
from .config import ModelConfig


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _q_scale(dh: int, dtype: torch.dtype) -> float:
    """dh**-0.5 rounded to ``dtype``: JAX turns the Python scalar of
    ``q * dh ** -0.5`` into q's dtype before the product (for bf16,
    0.044189453125 in place of 0.0441941738...)."""
    return float(torch.tensor(dh ** -0.5, dtype=dtype))


def _mlstm_qkvg(params, x, cfg: ModelConfig):
    """Block width: up-projection to 2D = (main m | output gate z); q/k/v
    are D→D over the main branch.  Returns q, k, v (B, S, H, dh), the input
    and forget gate pre-activations (B, S, H) fp32, and z (B, S, D)."""
    B, S, D = x.shape
    H = cfg.n_heads
    dh = D // H
    up = x @ params["w_up"]                             # (B, S, 2D)
    m, z = up.chunk(2, dim=-1)
    q = m @ params["w_q"]
    k = m @ params["w_k"]
    v = m @ params["w_v"]
    gates = x.float() @ params["w_gates"] + params["b_gates"]  # (B, S, 2H)
    i_raw, f_raw = gates.chunk(2, dim=-1)
    return (q.view(B, S, H, dh), k.view(B, S, H, dh), v.view(B, S, H, dh),
            i_raw, f_raw, z)


def _ones_augmented(v):
    """v (B, S, H, dh) with a column of ones appended: a (B, S, H, dh + 1)
    view of a buffer whose rows have a pitch of a multiple of 8 elements, so
    that the SSD kernel reads each row 16-byte aligned without a copy."""
    B, S, H, dh = v.shape
    buf = torch.empty((B, S, H, -(-(dh + 1) // 8) * 8), dtype=v.dtype,
                      device=v.device)
    buf[..., :dh] = v
    buf[..., dh] = 1
    return buf[..., :dh + 1]


def _normalized(y_aug, dh: int):
    """y / max(|n|, 1) in y's dtype, n the last (normalizer) column."""
    y, n = y_aug[..., :dh], y_aug[..., dh:]
    return y / torch.clamp(n.abs(), min=1.0)


def mlstm_block(params, x, cfg: ModelConfig, return_state: bool = False):
    """x: (B, S, D) → (B, S, D).  return_state → also the final
    (B, H, dh, dh + 1) fp32 matrix memory (normalizer column included)."""
    B, S, D = x.shape
    H = cfg.n_heads
    dh = D // H
    q, k, v, i_raw, f_raw, z = _mlstm_qkvg(params, x, cfg)
    log_a = F.logsigmoid(f_raw)                         # (B, S, H) fp32
    gate = torch.sigmoid(i_raw)

    # (B, H, S, ·) views of the (B, S, H, ·) tensors: the kernel reads
    # through strides, and its y keeps v_aug's layout
    q = q * _q_scale(dh, q.dtype)
    y_aug, s_fin = ssd_scan(q.transpose(1, 2), k.transpose(1, 2),
                            _ones_augmented(v).transpose(1, 2),
                            log_a.transpose(1, 2), gate.transpose(1, 2))
    y = _normalized(y_aug, dh).transpose(1, 2).reshape(B, S, D)
    out = (y * F.silu(z)) @ params["w_down"]            # gated output
    if return_state:
        return out, s_fin
    return out


def mlstm_decode_step(params, x, cfg: ModelConfig, state):
    """x: (B, 1, D); state: (B, H, dh, dh + 1) fp32.  Returns (out
    (B, 1, D), new state); the input state is not modified."""
    B, _, D = x.shape
    dh = D // cfg.n_heads
    q, k, v, i_raw, f_raw, z = _mlstm_qkvg(params, x, cfg)
    log_a = F.logsigmoid(f_raw)[:, 0]                   # (B, H)
    gate = torch.sigmoid(i_raw)[:, 0]
    v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    y_aug, state = ssd_step(state, q[:, 0] * _q_scale(dh, q.dtype), k[:, 0],
                            v_aug[:, 0], log_a, gate)
    y = _normalized(y_aug, dh).reshape(B, 1, D)
    return (y * F.silu(z)) @ params["w_down"], state


# ---------------------------------------------------------------------------
# sLSTM: a sequential loop over time (no parallel form exists)
# ---------------------------------------------------------------------------

def _slstm_gates(z, c_prev, n_prev, m_prev, out=None):
    """One sLSTM step from its pre-activations z (..., 4dh) fp32 (the input
    projection plus the recurrent one) and the previous c, n, m (..., dh),
    with exponential gating and the stabilizer state m.  Returns (h, c, n,
    m).  ``out``: tensors to write a = log σ(f_raw) + m_prev, the gates i,
    f (after the stabilizer), g and o, and c, n and h into (the scan keeps
    them for its backward)."""
    i_raw, f_raw, g_raw, o_raw = z.chunk(4, dim=-1)
    o_ = (None,) * 8 if out is None else out
    a = torch.add(F.logsigmoid(f_raw), m_prev, out=o_[0])
    m = torch.maximum(a, i_raw)                         # stabilizer
    i = torch.exp(i_raw - m, out=o_[1])
    f = torch.exp(a - m, out=o_[2])
    g = torch.tanh(g_raw, out=o_[3])
    o = torch.sigmoid(o_raw, out=o_[4])
    c = torch.addcmul(f * c_prev, i, g, out=o_[5])      # f·c + i·g
    n = torch.addcmul(i, f, n_prev, out=o_[6])          # f·n + i
    h = torch.div(o * c, torch.clamp(n, min=1.0), out=o_[7])
    return h, c, n, m


def _slstm_cell(params, h_prev, c_prev, n_prev, m_prev, zx_t, cfg):
    """One sLSTM step (the decode step).  h/c/n/m: (B, H, dh) fp32; zx_t:
    (B, 4D) fp32, the input projection x_t @ w_x + b (hoisted out of the
    loop by the callers).  The recurrent product is the scan's per-head
    batched product, so a step computes what a step of
    :class:`_SlstmScan` does."""
    B = zx_t.shape[0]
    H = cfg.n_heads
    dh = cfg.d_model // H
    # block-diagonal recurrent weights per head: (H, dh, 4dh)
    z = torch.baddbmm(zx_t.view(B, H, 4 * dh).transpose(0, 1),
                      h_prev.transpose(0, 1), params["r"]).transpose(0, 1)
    return _slstm_gates(z.float(), c_prev, n_prev, m_prev)


def _scan_forward(zx, r):
    """The sLSTM's loop over time with no autograd graph.  zx: (B, S, 4D)
    fp32 (x @ w_x + b); r: (H, dh, 4dh) fp32.  Returns the pre-activations
    Z (S, H, B, 4dh) and ``keep`` (8, S, H, B, dh): a, i, f, g, o, c, n, h
    of every step, each written in place (``out=``)."""
    B, S, _ = zx.shape
    H, dh = r.shape[0], r.shape[1]
    zxh = zx.view(B, S, H, 4 * dh).permute(1, 2, 0, 3)   # (S, H, B, 4dh)
    kw = dict(dtype=torch.float32, device=zx.device)
    Z = torch.empty((S, H, B, 4 * dh), **kw)
    keep = torch.empty((8, S, H, B, dh), **kw)           # a i f g o c n h
    h = c = n = torch.zeros((H, B, dh), **kw)
    m = torch.full((H, B, dh), -1e30, **kw)
    for t in range(S):
        z = torch.baddbmm(zxh[t], h, r, out=Z[t])
        h, c, n, m = _slstm_gates(z, c, n, m, out=keep[:, t])
    return Z, keep


def _scan_backward(r, Z, keep, hs_grad, dh_c, dc_c, dn_c, dm_c):
    """The scan's backward, written out: the factors that do not depend on
    the carried gradients for all steps at once, then a reverse loop that
    carries dh, dc, dn and dm (~20 ops a step).  hs_grad: (S, H, B, dh),
    the output's gradient; dh_c .. dm_c: (H, B, dh), the final state's.
    Returns dZ (S, H, B, 4dh), the pre-activations' gradient, and dr."""
    S, H, B, dh4 = Z.shape
    dh = dh4 // 4
    A, I, Fg, G, O, C, N, Hs = keep
    i_raw, f_raw = Z[..., :dh], Z[..., dh:2 * dh]
    zero = torch.zeros((1, H, B, dh), dtype=Z.dtype, device=Z.device)
    c_prev, n_prev = (torch.cat([zero, t[:-1]]) for t in (C, N))
    # each step's local factors, all steps at once: h = o·c/max(n, 1)
    inv = 1.0 / torch.clamp(N, min=1.0)
    k_c = O * inv                                         # dh → dc
    k_o = C * inv                                         # dh → do
    k_n = -(Hs * inv) * (N >= 1.0)                        # dh → dn
    w_a = torch.where(A == i_raw, 0.5, (A > i_raw).to(Z.dtype))
    w_i = 1.0 - w_a                                       # m = max(a, i_raw)
    s_f = torch.sigmoid(-f_raw)                           # log σ(f_raw)'
    t_g = 1.0 - G * G                                     # tanh'
    s_o = O * (1.0 - O)                                   # σ'
    dZ = torch.empty_like(Z)
    r_t = r.transpose(1, 2)
    for t in range(S - 1, -1, -1):
        dz = dZ[t]
        d_i_raw, d_f_raw, d_g_raw, d_o_raw = dz.chunk(4, dim=-1)
        dht = hs_grad[t] + dh_c
        dc = torch.addcmul(dc_c, dht, k_c[t])
        dn = torch.addcmul(dn_c, dht, k_n[t])
        torch.mul(dht * k_o[t], s_o[t], out=d_o_raw)
        di = torch.addcmul(dn, dc, G[t])              # c = f·c_prev + i·g,
        df = torch.addcmul(dc * c_prev[t], dn, n_prev[t])   # n = f·n + i
        torch.mul(dc * I[t], t_g[t], out=d_g_raw)
        dc_c, dn_c = dc * Fg[t], dn * Fg[t]
        di = di * I[t]                                 # i = exp(i_raw - m)
        df = df * Fg[t]                                # f = exp(a - m)
        dm = dm_c - di - df
        torch.addcmul(di, dm, w_i[t], out=d_i_raw)
        dm_c = torch.addcmul(df, dm, w_a[t])           # da, and dm_prev
        torch.mul(dm_c, s_f[t], out=d_f_raw)
        dh_c = torch.bmm(dz, r_t)
    # dr = Σ_t h_{t-1}ᵀ dz_t per head
    h_prev = torch.cat([zero, Hs[:-1]])
    dr = torch.bmm(h_prev.permute(1, 3, 0, 2).reshape(H, dh, S * B),
                   dZ.transpose(0, 1).reshape(H, S * B, dh4))
    return dZ, dr


# The scan's two loops on the card when it is differentiated (training),
# captured as CUDA graphs: ~36 small ops a step are host-bound eagerly (~13
# µs each on the H100's host against ~2 µs on the card).  One capture of
# each loop for the latest shape; a call copies its inputs into the graph's,
# replays it and clones the outputs (the next replay overwrites them).
_GRAPHS: dict = {}


def release_scan_graphs() -> None:
    """Drop the captured graphs and their memory pools."""
    _GRAPHS.clear()


def _replayed(kind: str, fn, *inputs):
    """``fn(*inputs)``'s outputs (a tuple of tensors): eagerly on the CPU;
    on the card replayed from a CUDA graph captured once per (kind, input
    shapes) — the same kernels, so the same bits."""
    if not inputs[0].is_cuda:
        return fn(*inputs)
    key = (kind, inputs[0].device,
           tuple(tuple(t.shape) for t in inputs))
    entry = _GRAPHS.get(key)
    if entry is None:
        for old in [k for k in _GRAPHS if k[0] == kind]:
            del _GRAPHS[old]
        static_in = tuple(t.clone() for t in inputs)
        side = torch.cuda.Stream(inputs[0].device)
        side.wait_stream(torch.cuda.current_stream(inputs[0].device))
        with torch.cuda.stream(side):             # warm up, off the graph
            fn(*static_in)
        torch.cuda.current_stream(inputs[0].device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_out = fn(*static_in)
        entry = _GRAPHS[key] = (graph, static_in, static_out)
    graph, static_in, static_out = entry
    for dst, src in zip(static_in, inputs):
        dst.copy_(src)
    graph.replay()
    return tuple(t.clone() for t in static_out)


class _SlstmScan(torch.autograd.Function):
    """The sLSTM's loop over time, forward and backward, in plain torch
    (:func:`_scan_forward`, :func:`_scan_backward`), replayed from CUDA
    graphs on the card where a gradient is wanted (:func:`_replayed`).  The
    forward keeps each step's values in place of
    an autograd graph; the backward is written out and gives the gradients
    autograd through the loop gives (maximum splits a tie, clamp passes at
    its bound).

    zx: (B, S, 4D) fp32 (x @ w_x + b); r: (H, dh, 4dh) fp32.  Returns hs
    (B, S, H, dh) fp32 and the final (h, c, n, m), each (B, H, dh)."""

    @staticmethod
    def forward(ctx, zx, r):
        if any(ctx.needs_input_grad):       # training: the graphs pay off
            Z, keep = _replayed("forward", _scan_forward, zx, r)
        else:                               # serving: one call a shape
            Z, keep = _scan_forward(zx, r)
        ctx.save_for_backward(r, Z, keep)
        ctx.set_materialize_grads(False)
        final = (keep[k, -1].transpose(0, 1) for k in (7, 5, 6))
        m = torch.maximum(keep[0, -1], Z[-1, ..., :r.shape[1]])
        return (keep[7].permute(2, 0, 1, 3), *final, m.transpose(0, 1))

    @staticmethod
    def backward(ctx, d_hs, d_h, d_c, d_n, d_m):
        r, Z, keep = ctx.saved_tensors
        S, H, B, _ = Z.shape
        dh = r.shape[1]
        zeros = torch.zeros((H, B, dh), dtype=Z.dtype, device=Z.device)
        carry = [zeros if g is None else g.transpose(0, 1).contiguous()
                 for g in (d_h, d_c, d_n, d_m)]
        hs_grad = (torch.zeros((S, H, B, dh), dtype=Z.dtype, device=Z.device)
                   if d_hs is None else d_hs.permute(1, 2, 0, 3))
        dZ, dr = _replayed("backward", _scan_backward, r, Z, keep,
                           hs_grad, *carry)
        return dZ.permute(2, 0, 1, 3).reshape(B, S, -1), dr


def _slstm_input(params, x):
    """x @ w_x + b for every position at once: (B, S, 4D), fp32 (JAX's
    promotion of the model-dtype product plus the fp32 bias)."""
    return (x @ params["w_x"]) + params["b"]


def slstm_init_state(B: int, cfg: ModelConfig, device) -> tuple:
    """(h, c, n, m), each (B, H, dh) fp32: zeros, and m = -1e30."""
    H = cfg.n_heads
    z = torch.zeros((B, H, cfg.d_model // H), dtype=torch.float32,
                    device=device)
    return z, z.clone(), z.clone(), torch.full_like(z, -1e30)


def slstm_block(params, x, cfg: ModelConfig, return_state: bool = False):
    """x: (B, S, D) → (B, S, D), a loop over time (:class:`_SlstmScan`).
    return_state → also the final (h, c, n, m)."""
    B, S, D = x.shape
    zx = _slstm_input(params, x)                        # (B, S, 4D)
    hs, h, c, n, m = _SlstmScan.apply(zx, params["r"])
    y = hs.reshape(B, S, D).to(x.dtype)
    out = y @ params["w_out"]
    if return_state:
        return out, (h, c, n, m)
    return out


def slstm_decode_step(params, x, cfg: ModelConfig, state):
    """x: (B, 1, D); state: (h, c, n, m) each (B, H, dh) fp32.  Returns
    (out (B, 1, D), new state)."""
    h, c, n, m = state
    h, c, n, m = _slstm_cell(params, h, c, n, m,
                             _slstm_input(params, x)[:, 0], cfg)
    B = x.shape[0]
    y = h.reshape(B, 1, -1).to(x.dtype)
    return y @ params["w_out"], (h, c, n, m)
