"""Shared layer primitives (the counterpart of ``repro.models.layers``).

Plain functions over parameter dicts of tensors.  Kernel hot spots route
through ``repro_torch.kernels``, which dispatch on the tensor's device.  The
JAX package's logical sharding annotations are no-ops without a sharding
context and are left out; the sequence-sharded decode branch waits for the
distributed slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import decode_attention, flash_attention, rmsnorm
from .config import ModelConfig


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


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
    q = q.reshape(B, S, cfg.n_heads, dh)
    k = k.reshape(B, S, cfg.n_kv_heads, dh)
    v = v.reshape(B, S, cfg.n_kv_heads, dh)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_block(params, x, cfg: ModelConfig, positions):
    """Full self-attention over x (prefill).  Returns (out, k, v) — k/v
    handed back so prefill can populate the cache."""
    B, S, _ = x.shape
    q, k, v = attention_qkv(params, x, cfg, positions)
    # (B, H, S, dh) views of the (B, S, H, dh) tensors: the kernel reads
    # through strides, and its output keeps q's layout, so the transpose back
    # is contiguous and the reshape is free.
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=True)
    o = o.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.d_head)
    return o @ params["wo"], k, v


def attention_decode(params, x, cfg: ModelConfig, k_cache, v_cache,
                     cache_len):
    """One-token decode.  x: (B, 1, D); caches: (B, S_max, Hkv, dh);
    cache_len: (B,) int32.  Returns (out (B,1,D), k_cache, v_cache).

    The new K/V row of each lane is written into the caches IN PLACE (the
    JAX version returns updated copies; a copy of a 28-layer cache per token
    is what the in-place write saves).  A lane whose cache is full
    (cache_len == S_max) writes nothing, as JAX's ``mode="drop"`` scatter."""
    B = x.shape[0]
    s_max = k_cache.shape[1]
    positions = cache_len[:, None]                       # (B, 1)
    q, k, v = attention_qkv(params, x, cfg, positions)

    # per-lane scatter write (continuous batching: ragged lengths).  A full
    # lane rewrites its last row with the value it already holds, so the
    # write needs no host sync to find which lanes to skip.
    lane = torch.arange(B, device=x.device)
    full = (cache_len >= s_max)[:, None, None]
    row = cache_len.clamp(max=s_max - 1).long()
    k_cache[lane, row] = torch.where(full, k_cache[lane, row],
                                     k[:, 0].to(k_cache.dtype))
    v_cache[lane, row] = torch.where(full, v_cache[lane, row],
                                     v[:, 0].to(v_cache.dtype))
    lengths = torch.clamp(cache_len + 1, max=s_max).to(torch.int32)
    o = decode_attention(q[:, 0], k_cache, v_cache, lengths)
    out = o.reshape(B, 1, cfg.n_heads * cfg.d_head) @ params["wo"]
    return out, k_cache, v_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_block(params, x, cfg: ModelConfig, act: Optional[str] = None):
    act = act or cfg.act
    if act == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    elif act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    elif act == "relu2":                      # nemotron squared-ReLU
        h = torch.square(F.relu(x @ params["w_up"]))
    else:
        raise ValueError(act)
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def embed(params, tokens, cfg: ModelConfig):
    # F.embedding rather than tok[tokens]: the same rows, and its backward
    # on CUDA sums each row's gradients in a fixed order (a sort, then a
    # segmented sum), so a training run repeats bit for bit (the checkpoint
    # resume test relies on it)
    return F.embedding(tokens, params["tok"]).to(dtype_of(cfg))
