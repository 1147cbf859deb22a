"""Distributed flash-decode (the counterpart of
``repro.distributed.ring_decode``): one-token attention over a KV cache
sharded by sequence over ``model``, without gathering the cache.

Each model-rank holds an S/tp slice of every lane's cache.  It writes the
new token where its slice owns the position, runs the decode kernel
(``kernels/decode_attention``) with ``return_lse`` over its slice, and the
ranks merge their (out, m, l):

    M = max_i m_i,   w_i = exp(m_i − M),
    out = Σ_i out_i·l_i·w_i / Σ_i l_i·w_i

— one max and one sum of (B, H, dh)-sized tensors a layer.  A slice that
lies past a lane's length has local length 0: the kernel (and its plain
version) give out 0, m = −1e30 and l = 0 there, which weighs nothing.  The
kernel's out is bf16 and normalised; the merge reweights it in fp32 (the
reference merges unnormalised fp32 partial sums).
"""

from __future__ import annotations

import torch

from ..kernels import decode_attention
from .collectives import all_reduce
from .context import current_context


def seq_sharded_decode(q, k_cache, v_cache, cache_len, new_k, new_v,
                       scale: float):
    """q: (B, Hq, dh), the new token's post-rope query (all heads).
    k_cache / v_cache: (B, S/tp, Hkv, dh), this rank's sequence slice,
    written IN PLACE.  cache_len: (B,) int32, the lanes' lengths.
    new_k / new_v: (B, Hkv, dh), the new token's K/V, written at
    cache_len by the rank whose slice holds it.
    Returns (out (B, Hq, dh) in q's dtype, k_cache, v_cache)."""
    mesh = current_context().mesh
    B, s_loc = k_cache.shape[:2]
    lo = mesh.index("model") * s_loc
    lane = torch.arange(B, device=q.device)
    pos = cache_len.long() - lo
    owns = ((pos >= 0) & (pos < s_loc))[:, None, None]
    row = pos.clamp(0, s_loc - 1)
    k_cache[lane, row] = torch.where(owns, new_k.to(k_cache.dtype),
                                     k_cache[lane, row])
    v_cache[lane, row] = torch.where(owns, new_v.to(v_cache.dtype),
                                     v_cache[lane, row])
    lengths = (cache_len.long() + 1 - lo).clamp(0, s_loc).to(torch.int32)
    out, m, l = decode_attention(q, k_cache, v_cache, lengths, scale=scale,
                                 return_lse=True)
    big_m = all_reduce(m, "model", mesh, op="max")
    lw = l * torch.exp(m - big_m)                        # (B, Hq)
    parts = torch.cat([out.float() * lw[..., None], lw[..., None]], dim=-1)
    tot = all_reduce(parts, "model", mesh)
    merged = tot[..., :-1] / tot[..., -1:].clamp_min(1e-30)
    return merged.to(q.dtype), k_cache, v_cache
