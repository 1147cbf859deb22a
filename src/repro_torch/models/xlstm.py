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

def _slstm_cell(params, h_prev, c_prev, n_prev, m_prev, zx_t, cfg):
    """One sLSTM step with exponential gating and the stabilizer state m.
    h/c/n/m: (B, H, dh) fp32; zx_t: (B, 4D) fp32, the input projection
    x_t @ w_x + b (hoisted out of the loop by the callers)."""
    B = zx_t.shape[0]
    H = cfg.n_heads
    dh = cfg.d_model // H
    # block-diagonal recurrent weights per head: (H, dh, 4dh)
    zh = torch.einsum("bhd,hdk->bhk", h_prev, params["r"])
    z = zx_t.view(B, H, 4 * dh) + zh
    i_raw, f_raw, g_raw, o_raw = z.float().chunk(4, dim=-1)

    log_f = F.logsigmoid(f_raw)
    m_new = torch.maximum(log_f + m_prev, i_raw)        # stabilizer
    i = torch.exp(i_raw - m_new)
    f = torch.exp(log_f + m_prev - m_new)
    g = torch.tanh(g_raw)
    o = torch.sigmoid(o_raw)
    c_new = f * c_prev + i * g
    n_new = f * n_prev + i
    h_new = o * c_new / torch.clamp(n_new, min=1.0)
    return h_new, c_new, n_new, m_new


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
    """x: (B, S, D) → (B, S, D), a loop over time.  return_state → also the
    final (h, c, n, m)."""
    B, S, D = x.shape
    zx = _slstm_input(params, x)                        # (B, S, 4D)
    h, c, n, m = slstm_init_state(B, cfg, x.device)
    hs = []
    for t in range(S):
        h, c, n, m = _slstm_cell(params, h, c, n, m, zx[:, t], cfg)
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(B, S, D).to(x.dtype)
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
