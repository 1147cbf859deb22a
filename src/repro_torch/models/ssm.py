"""Mamba2 block (zamba2 backbone) on the chunked SSD kernel (the counterpart
of ``repro.models.ssm``).

It keeps the JAX package's one documented simplification: the short causal
conv acts on the x branch only (the reference Mamba2 applies it to x, B and
C).

Prefill: ``ssd_scan`` (the CUDA kernel for a CUDA tensor).  Decode: the O(1)
recurrent step ``ssd_step`` with (conv_state, ssd_state).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ssd.ops import ssd_scan, ssd_step
from .config import ModelConfig


def _split_proj(params, x, cfg: ModelConfig):
    """in_proj → views (x_in (B,S,di), z (B,S,di), b (B,S,N), c (B,S,N),
    dt (B,S,H)) of the one projection."""
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    proj = x @ params["w_in"]                      # (B, S, 2di + 2N + H)
    return torch.split(proj, [di, di, N, N, H], dim=-1)


def _causal_conv(x, w, state=None):
    """Depthwise causal conv, kernel k.  x: (B, S, C); w: (k, C).
    state: (B, k-1, C) carried for decode.  Returns (y, new_state)."""
    k = w.shape[0]
    w = w.to(x.dtype)              # conv taps stored fp32; keep the stream
    if state is None:              # in the model dtype
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                # (B, S+k-1, C)
    S = x.shape[1]
    out = xp[:, 0:S] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + S] * w[i]
    new_state = xp[:, -(k - 1):] if k > 1 else None
    return out, new_state


def _gates(params, dt, cfg: ModelConfig):
    """(log_a, gate), each (B, S, H) fp32: gate = softplus(dt + dt_bias),
    log_a = gate · (−exp(a_log))."""
    dtb = F.softplus(dt.float() + params["dt_bias"].float())
    a = -torch.exp(params["a_log"].float())        # (H,) negative
    return dtb * a, dtb


def _skip(params, cfg: ModelConfig, dtype):
    """d_skip repeated over each head's P channels: (di,)."""
    return params["d_skip"].to(dtype).repeat_interleave(cfg.ssm_head_dim)


def mamba_block(params, x, cfg: ModelConfig, return_state: bool = False):
    """x: (B, S, D) → (B, S, D) (prefill path).
    return_state → also (conv_state (B, k-1, di) fp32, ssd_state
    (B, H, N, P) fp32)."""
    B, S, _ = x.shape
    di, H, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim

    xs_raw, z, b, c, dt = _split_proj(params, x, cfg)
    xs, _ = _causal_conv(xs_raw, params["w_conv"])
    xs = F.silu(xs)

    log_a, gate = _gates(params, dt, cfg)          # (B, S, H)
    # (B, H, S, ·) views: x through the strides of its (B, S, H, P) layout,
    # b and c (B, 1, S, N), shared by all heads (the scan reads them with a
    # head stride of 0 and returns their gradients summed over the heads),
    # no copies
    xh = xs.view(B, S, H, P).transpose(1, 2)
    y, s_fin = ssd_scan(c[:, None], b[:, None], xh, log_a.transpose(1, 2),
                        gate.transpose(1, 2))      # y (B, H, S, P)
    y = y.transpose(1, 2).reshape(B, S, di)
    y = y + xs * _skip(params, cfg, x.dtype)
    y = y * F.silu(z)
    out = y @ params["w_out"]
    if return_state:
        conv_state = xs_raw[:, -(cfg.conv_kernel - 1):].float()
        return out, (conv_state, s_fin)
    return out


def mamba_decode_step(params, x, cfg: ModelConfig, conv_state, ssd_state):
    """x: (B, 1, D); conv_state: (B, k-1, di); ssd_state: (B, H, N, P) fp32.
    Returns (out (B, 1, D), new conv_state in x's dtype, new ssd_state);
    the inputs are not modified."""
    B = x.shape[0]
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim

    xs, z, b, c, dt = _split_proj(params, x, cfg)
    xs, conv_state = _causal_conv(xs, params["w_conv"], conv_state)
    xs = F.silu(xs)

    log_a, gate = _gates(params, dt, cfg)          # (B, 1, H)
    bh = b[:, 0, None, :].expand(B, H, N)
    ch = c[:, 0, None, :].expand(B, H, N)
    y, ssd_state = ssd_step(ssd_state, ch, bh, xs.reshape(B, H, P),
                            log_a[:, 0], gate[:, 0])   # (B, H, P)
    y = y.reshape(B, 1, di) + xs * _skip(params, cfg, x.dtype)
    y = y * F.silu(z)
    return y @ params["w_out"], conv_state, ssd_state
