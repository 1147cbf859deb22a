"""Shared layer primitives (the counterpart of ``repro.models.layers``).

Plain functions over parameter dicts of tensors.  Kernel hot spots route
through ``repro_torch.kernels``, which dispatch on the tensor's device.  The
JAX package's logical sharding annotations are layout hints and are left
out.

Under a sharding context (``repro_torch.distributed``) each rank computes
its part, as GSPMD partitions the reference under the policy's specs: a
layer whose projections arrive split over ``model`` (fewer columns than
the config's full width) runs the rank's heads or F slice, with its input
through ``enter_split`` and the fp32 partial products of ``wo`` /
``w_down`` summed through ``leave_split`` (``split_matmul``); the
embedding looks up the rank's vocab rows and sums; decode over a
sequence-sharded cache merges the ranks' partial attention
(``distributed/ring_decode.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..distributed.collectives import (enter_split, gather_full,
                                       leave_split, shard_bounds)
from ..distributed.context import current_context
from ..kernels import decode_attention, flash_attention, rmsnorm
from .config import ModelConfig


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def split_matmul(x, w, mesh):
    """``x @ w``; where ``w`` is the rank's slice of the contracted dim
    (``wo``, ``w_down`` under TP), the ranks' fp32 partial products summed
    and rounded once, as the one-device product rounds its fp32
    accumulator once."""
    if mesh is None:
        return x @ w
    return leave_split(x.float() @ w.float(), "model", mesh).to(x.dtype)


def split_mesh(local: int, full: int):
    """The context's mesh when a dim arrives as a shard over ``model``
    (``local`` < ``full``), else None."""
    if local == full:
        return None
    ctx = current_context()
    if ctx is None:
        raise ValueError(f"a parameter dim of {local} where the config has "
                         f"{full}, with no sharding context")
    return ctx.mesh


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm(params, x, eps: float):
    return rmsnorm(x, params["w"], eps=eps)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float):
    """Half-split (rotate-half) rotary embedding.
    x: (B, S, H, Dh); positions: (B, S) int."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[..., None].float() * freqs        # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA) — prefill path and cached-decode path
# ---------------------------------------------------------------------------

def attention_qkv(params, x, cfg: ModelConfig, positions):
    """Project + rope.  x: (B, S, D) → q (B,S,H,dh), k/v (B,S,Hkv,dh)."""
    B, S, _ = x.shape
    dh = cfg.d_head
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    # the rank's heads under TP, all of them otherwise
    q = q.reshape(B, S, -1, dh)
    k = k.reshape(B, S, -1, dh)
    v = v.reshape(B, S, -1, dh)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_block(params, x, cfg: ModelConfig, positions):
    """Full self-attention over x (prefill).  Returns (out, k, v) — k/v
    handed back so prefill can populate the cache (the rank's kv heads
    under TP)."""
    B, S, _ = x.shape
    mesh = split_mesh(params["wq"].shape[1], cfg.n_heads * cfg.d_head)
    if mesh is not None:
        x = enter_split(x, "model", mesh)
    q, k, v = attention_qkv(params, x, cfg, positions)
    # (B, H, S, dh) views of the (B, S, H, dh) tensors: the kernel reads
    # through strides, and its output keeps q's layout, so the transpose back
    # is contiguous and the reshape is free.
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=True)
    o = o.transpose(1, 2).reshape(B, S, -1)
    return split_matmul(o, params["wo"], mesh), k, v


def attention_decode(params, x, cfg: ModelConfig, k_cache, v_cache,
                     cache_len):
    """One-token decode.  x: (B, 1, D); caches: (B, S_max, Hkv, dh);
    cache_len: (B,) int32.  Returns (out (B,1,D), k_cache, v_cache).

    The new K/V row of each lane is written into the caches IN PLACE (the
    JAX version returns updated copies; a copy of a 28-layer cache per token
    is what the in-place write saves).  A lane whose cache is full
    (cache_len == S_max) writes nothing, as JAX's ``mode="drop"`` scatter.

    With a sharding context whose kv_cache rule shards S over ``model``,
    the caches are the rank's S/tp slice and the distributed flash-decode
    runs (``seq_sharded_decode``: local partial attention on the decode
    kernel, then the LSE merge).  Under TP the rank's q and new K/V heads
    are gathered over ``model`` first (B·H·dh, small), and the merged
    output is cut back to the rank's heads before ``wo``."""
    B = x.shape[0]
    positions = cache_len[:, None]                       # (B, 1)
    mesh = split_mesh(params["wq"].shape[1], cfg.n_heads * cfg.d_head)
    q, k, v = attention_qkv(params, x, cfg, positions)

    ctx = current_context()
    kv_rule = ctx.spec("kv_cache") if ctx is not None else None
    if kv_rule is not None and len(kv_rule) > 1 and kv_rule[1] == "model":
        from ..distributed.ring_decode import seq_sharded_decode
        q, k, v = q[:, 0], k[:, 0], v[:, 0]
        if mesh is not None:           # every head, then the rank's again
            hq, hk = q.shape[1], k.shape[1]
            tp = mesh.axes_size("model")
            heads = gather_full(torch.cat([q, k, v], dim=1), (None, "model"),
                                mesh).view(B, tp, hq + 2 * hk, -1)
            q, k, v = (t.reshape(B, tp * t.shape[2], -1) for t in
                       heads.split([hq, hk, hk], dim=2))
        o, k_cache, v_cache = seq_sharded_decode(
            q, k_cache, v_cache, cache_len, k, v, scale=cfg.d_head ** -0.5)
        if mesh is not None:
            o = o.narrow(1, mesh.index("model") * hq, hq)
    else:
        # per-lane scatter write (continuous batching: ragged lengths).  A
        # full lane rewrites its last row with the value it already holds,
        # so the write needs no host sync to find which lanes to skip.
        s_max = k_cache.shape[1]
        lane = torch.arange(B, device=x.device)
        full = (cache_len >= s_max)[:, None, None]
        row = cache_len.clamp(max=s_max - 1).long()
        k_cache[lane, row] = torch.where(full, k_cache[lane, row],
                                         k[:, 0].to(k_cache.dtype))
        v_cache[lane, row] = torch.where(full, v_cache[lane, row],
                                         v[:, 0].to(v_cache.dtype))
        lengths = torch.clamp(cache_len + 1, max=s_max).to(torch.int32)
        o = decode_attention(q[:, 0], k_cache, v_cache, lengths)
    return split_matmul(o.reshape(B, 1, -1), params["wo"], mesh), k_cache, \
        v_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_block(params, x, cfg: ModelConfig, act: Optional[str] = None):
    """The MLP; under TP the rank's F slice, its partial output summed."""
    act = act or cfg.act
    mesh = split_mesh(params["w_up"].shape[1], cfg.d_ff)
    if mesh is not None:
        x = enter_split(x, "model", mesh)
    if act == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    elif act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    elif act == "relu2":                      # nemotron squared-ReLU
        h = torch.square(F.relu(x @ params["w_up"]))
    else:
        raise ValueError(act)
    return split_matmul(h, params["w_down"], mesh)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def embed(params, tokens, cfg: ModelConfig):
    """The token rows; with the table split by vocab over ``model``, the
    rank looks up the rows it holds (zero elsewhere) and the ranks sum."""
    # F.embedding rather than tok[tokens]: the same rows, and its backward
    # on CUDA sums each row's gradients in a fixed order (a sort, then a
    # segmented sum), so a training run repeats bit for bit (the checkpoint
    # resume test relies on it)
    tok = params["tok"]
    mesh = split_mesh(tok.shape[0], cfg.vocab_padded)
    if mesh is None:
        return F.embedding(tokens, tok).to(dtype_of(cfg))
    lo, hi = shard_bounds(cfg.vocab_padded, mesh.axes_size("model"),
                          mesh.index("model"))
    local = tokens.long() - lo
    inside = ((local >= 0) & (local < hi - lo))[..., None]
    rows = F.embedding(local.clamp(0, hi - lo - 1), tok)
    rows = torch.where(inside, rows, torch.zeros_like(rows))
    return leave_split(rows, "model", mesh).to(dtype_of(cfg))
