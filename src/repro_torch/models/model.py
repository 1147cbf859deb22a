"""Model assembly for the dense family: params, forward, prefill and decode
(the counterpart of ``repro.models.model``).

Parameters are a dict tree shaped like the JAX package's: per-layer weights
stacked on a leading layer axis, weights in the (in, out) layout.  Python
loops over the layers take the place of ``lax.scan``; the per-layer views
come from one ``torch.unbind`` of each stacked tensor.  With ``cfg.remat``
and a gradient wanted, each layer runs under ``torch.utils.checkpoint``
(``jax.checkpoint`` in the JAX package).  The hybrid (SSD), ssm (SSD) and moe
(grouped matmul) families, and the vlm/audio frontends, come with later
slices of the port and raise here.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels import fused_cross_entropy
from ..kernels.common import resolve_device
from .config import ModelConfig
from .layers import (attention_block, attention_decode, dtype_of, embed,
                     mlp_block, norm)

_LATER = {
    "hybrid": "the hybrid/ssm serving slice (SSD kernel)",
    "ssm": "the hybrid/ssm serving slice (SSD kernel)",
    "moe": "the MoE slice (grouped-matmul kernel)",
    "vlm": "a later slice (precomputed-embedding frontends)",
    "audio": "a later slice (precomputed-embedding frontends)",
}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet; it "
            f"comes with {_LATER[cfg.family]} (see ROADMAP.md)")


def _layers(tree, n: int) -> list:
    """The per-layer views of a stacked parameter tree, from one
    ``torch.unbind`` of each stacked tensor.  Selecting ``tree[i]`` for
    each layer instead would give each layer its own ``SelectBackward``,
    and each of those allocates a zero gradient the size of the whole stack
    (for ``w_up`` of qwen2-7b at 4 layers, 543 MB a layer); the backward of
    one unbind stacks the layers' gradients once."""
    if isinstance(tree, dict):
        per_key = {k: _layers(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    views = torch.unbind(tree, 0)
    if len(views) != n:
        raise ValueError(f"stacked tensor has {len(views)} layers, not {n}")
    return list(views)


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------


def _dense_(out: torch.Tensor, gen: torch.Generator, scale=None):
    """Fill ``out`` (in, out)-shaped with N(0, 1)·scale drawn in fp32, the
    scales of the JAX package's ``_dense``; scale defaults to in**-0.5."""
    scale = scale if scale is not None else out.shape[0] ** -0.5
    tmp = torch.randn(out.shape, generator=gen, dtype=torch.float32,
                      device=out.device)
    out.copy_(tmp.mul_(scale))
    return out


def init_params(cfg: ModelConfig,
                generator: Optional[torch.Generator] = None, *, device=None):
    """Random parameters on ``device``, drawn from ``generator`` (by
    default a new one seeded with 0, as JAX's default key is PRNGKey(0)).  Shapes and scales follow the JAX package's
    ``init_params``; the numbers differ (torch and JAX generators differ —
    load JAX's parameters with :func:`repro_torch.models.convert.
    params_from_numpy` to compare the two).  Each layer is drawn straight
    into its slot of the stacked tensor, so the fp32 draw is one layer at a
    time: a full-width model needs no more than its bf16 size plus one
    layer's largest fp32 matrix."""
    _check_family(cfg)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    dt = dtype_of(cfg)
    L, D, dh, F_ = cfg.n_layers, cfg.d_model, cfg.d_head, cfg.d_ff

    def empty(*shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device=device)

    attn = {"wq": empty(L, D, cfg.n_heads * dh),
            "wk": empty(L, D, cfg.n_kv_heads * dh),
            "wv": empty(L, D, cfg.n_kv_heads * dh),
            "wo": empty(L, cfg.n_heads * dh, D)}
    if cfg.qkv_bias:
        attn["bq"] = torch.zeros((L, cfg.n_heads * dh), dtype=dt,
                                 device=device)
        attn["bk"] = torch.zeros((L, cfg.n_kv_heads * dh), dtype=dt,
                                 device=device)
        attn["bv"] = torch.zeros((L, cfg.n_kv_heads * dh), dtype=dt,
                                 device=device)
    mlp = {"w_up": empty(L, D, F_), "w_down": empty(L, F_, D)}
    if cfg.act == "swiglu":
        mlp["w_gate"] = empty(L, D, F_)
    for i in range(L):
        for name in ("wq", "wk", "wv", "wo"):
            _dense_(attn[name][i], generator)
        for name in ("w_up", "w_down", "w_gate"):
            if name in mlp:
                _dense_(mlp[name][i], generator)

    ones = lambda *s: torch.ones(s, dtype=torch.float32, device=device)
    params: dict[str, Any] = {
        "embed": {"tok": _dense_(empty(cfg.vocab_padded, D), generator,
                                 scale=0.02)},
        "layers": {"attn_norm": {"w": ones(L, D)}, "attn": attn,
                   "mlp_norm": {"w": ones(L, D)}, "mlp": mlp},
        "final_norm": {"w": ones(D)},
        "lm_head": _dense_(empty(D, cfg.vocab_padded), generator,
                           scale=D ** -0.5),
    }
    return params


# ---------------------------------------------------------------------------
# forward (prefill trunk)
# ---------------------------------------------------------------------------


def _attn_mlp_block(lp, x, cfg: ModelConfig, positions):
    h, k, v = attention_block(lp["attn"], norm(lp["attn_norm"], x,
                                               cfg.norm_eps), cfg, positions)
    x = x + h
    x = x + mlp_block(lp["mlp"], norm(lp["mlp_norm"], x, cfg.norm_eps), cfg)
    return x, (k, v)


def _remat_layer(lp, x, cfg: ModelConfig, positions):
    """One layer that keeps only its input for the backward and runs its
    forward again there (layer-granular remat, JAX's ``remat_policy
    "full"``).  Under it each layer's 2 rmsnorm and 1 flash-attention
    forwards launch twice a step.  The k/v it would hand to prefill are
    dropped: remat applies only when they are not collected."""
    if cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r}: only 'full' is ported; the "
            "'dots' policy (save the matmul outputs) is queued in ROADMAP.md")
    x, _ = checkpoint(_attn_mlp_block, lp, x, cfg, positions,
                      use_reentrant=False)
    return x


def forward(params, inputs: dict, cfg: ModelConfig, collect: bool = False):
    """inputs: {"tokens": (B,S)}.  Returns (hidden (B,S,D), states): with
    ``collect`` the per-layer (k, v), each (B, S, Hkv, dh), else None."""
    _check_family(cfg)
    tokens = inputs["tokens"]
    x = embed(params["embed"], tokens, cfg)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    remat = cfg.remat and not collect and torch.is_grad_enabled()
    kvs = []
    for lp in _layers(params["layers"], cfg.n_layers):
        if remat:
            x = _remat_layer(lp, x, cfg, positions)
            continue
        x, kv = _attn_mlp_block(lp, x, cfg, positions)
        if collect:
            kvs.append(kv)
    x = norm(params["final_norm"], x, cfg.norm_eps)
    return x, (kvs if collect else None)


def loss_fn(params, inputs: dict, cfg: ModelConfig):
    """Causal-LM loss (labels = inputs shifted by the data pipeline;
    negative labels are padding)."""
    hidden, _ = forward(params, inputs, cfg)
    labels = inputs["labels"]
    valid = labels >= 0
    labels = labels.clamp_min(0)
    return fused_cross_entropy(hidden, params["lm_head"], labels,
                               valid=valid, n_valid=cfg.vocab)


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype=None, device=None):
    """Decode state: the per-lane KV cache (L, B, S_max, Hkv, dh) and
    lengths (B,) int32."""
    _check_family(cfg)
    device = resolve_device(device)
    dt = dtype or dtype_of(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"kv": {"k": torch.zeros(shape, dtype=dt, device=device),
                   "v": torch.zeros(shape, dtype=dt, device=device)},
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def decode_step(params, state: dict, tokens, cfg: ModelConfig):
    """One decode step.  tokens: (B, 1) int.  Returns (logits
    (B, vocab_padded) fp32, new_state).

    The KV caches of ``state`` are updated IN PLACE (see
    ``layers.attention_decode``) and shared by the returned state; only
    ``len`` is a new tensor.  A caller that needs the old cache copies it
    first."""
    _check_family(cfg)
    x = embed(params["embed"], tokens, cfg)
    cache_len = state["len"]
    kc_all, vc_all = state["kv"]["k"], state["kv"]["v"]
    for i, lp in enumerate(_layers(params["layers"], cfg.n_layers)):
        a, _, _ = attention_decode(
            lp["attn"], norm(lp["attn_norm"], x, cfg.norm_eps), cfg,
            kc_all[i], vc_all[i], cache_len)
        x = x + a
        x = x + mlp_block(lp["mlp"], norm(lp["mlp_norm"], x, cfg.norm_eps),
                          cfg)
    x = norm(params["final_norm"], x, cfg.norm_eps)
    logits = (x[:, 0] @ params["lm_head"]).float()
    return logits, {"kv": state["kv"], "len": cache_len + 1}


def prefill(params, inputs: dict, cfg: ModelConfig, max_len: int):
    """Run the full prompt, returning (last_logits, decode state): the
    per-layer K/V of the trunk written into a ``max_len`` cache."""
    tokens = inputs["tokens"]
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"prompt of {S} tokens exceeds max_len {max_len}")
    hidden, kvs = forward(params, inputs, cfg, collect=True)
    state = init_decode_state(cfg, B, max_len, device=tokens.device)
    for i, (k, v) in enumerate(kvs):
        state["kv"]["k"][i, :, :S] = k        # in place into the new cache
        state["kv"]["v"][i, :, :S] = v
    state["len"] = torch.full((B,), S, dtype=torch.int32,
                              device=tokens.device)
    logits = (hidden[:, -1] @ params["lm_head"]).float()
    return logits, state
