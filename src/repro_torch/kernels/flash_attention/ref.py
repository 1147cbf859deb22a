"""Plain PyTorch attention (the counterpart of
``repro.kernels.flash_attention.ref.attention_ref``): GQA, causal, optional
local window, the full (Sq, Sk) score matrix in fp32."""

from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  scale: float | None = None):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D); GQA via Hq % Hkv == 0.
    window > 0 → local attention of that width.  Queries occupy the last Sq
    positions of the Sk context.  Returns (B, Hq, Sq, D) in q.dtype."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {Hq} and {Hkv}")
    group = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5

    kq = k.repeat_interleave(group, dim=1)           # (B, Hq, Sk, D)
    vq = v.repeat_interleave(group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kq.float()) * scale
    q_pos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    scores = scores.masked_fill(~mask, float("-inf"))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), vq)
    return out.to(q.dtype)
