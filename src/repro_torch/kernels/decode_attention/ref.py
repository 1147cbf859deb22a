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
    and sum l = Σ exp(s − m) of the scaled scores, each (B, Hq).

    A row with ``lengths[b] == 0`` gives what the kernel gives: out 0,
    m = -1e30 and l = 0, so it weighs nothing in an LSE merge (a shard of a
    sequence-sharded cache past the sequence's end).  The JAX oracle gives
    NaN there; every other row is computed as it computes it."""
    B, Hq, D = q.shape
    _, S, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {Hq} and {Hkv}")
    group = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5

    kq = k.repeat_interleave(group, dim=2)           # (B, S, Hq, D)
    vq = v.repeat_interleave(group, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q.float(), kq.float()) * scale
    empty = None
    if lengths is not None:
        pos = torch.arange(S, device=q.device)[None, None, :]
        s = s.masked_fill(pos >= lengths[:, None, None], float("-inf"))
        empty = (lengths == 0)[:, None, None]
    m = s.amax(dim=-1, keepdim=True)
    if empty is not None:                 # exp(-inf - 0) = 0 on empty rows
        m = torch.where(empty, torch.zeros_like(m), m)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhs,bshd->bhd", e / l, vq.float())
    if empty is not None:
        out = torch.where(empty, torch.zeros_like(out), out)
        m = torch.where(empty, torch.full_like(m, -1e30), m)
    out = out.to(q.dtype)
    if return_lse:
        return out, m[..., 0], l[..., 0]
    return out
