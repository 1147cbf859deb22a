"""Plain PyTorch single-token decode attention over a KV cache (the
counterpart of ``repro.kernels.decode_attention.ref``)."""

from __future__ import annotations

import torch


def decode_attention_ref(q, k, v, lengths=None, scale: float | None = None,
                         return_lse: bool = False):
    """q: (B, Hq, D) — one new token per sequence.
    k, v: (B, S, Hkv, D) — cache (time-major, the serving layout).
    lengths: (B,) valid cache lengths (positions ≥ length are masked).
    Returns (B, Hq, D) in q.dtype; with return_lse also the fp32 row max m
    and sum l = Σ exp(s − m) of the scaled scores, each (B, Hq)."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {Hq} and {Hkv}")
    group = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5

    kq = k.repeat_interleave(group, dim=2)           # (B, S, Hq, D)
    vq = v.repeat_interleave(group, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q.float(), kq.float()) * scale
    if lengths is not None:
        pos = torch.arange(S, device=q.device)[None, None, :]
        s = s.masked_fill(pos >= lengths[:, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhs,bshd->bhd", e / l, vq.float()).to(q.dtype)
    if return_lse:
        return out, m[..., 0], l[..., 0]
    return out
