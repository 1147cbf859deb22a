"""Model assembly for the dense, moe, hybrid, ssm, vlm and audio families:
params, forward, prefill and decode (the counterpart of
``repro.models.model``).

Parameters are a dict tree shaped like the JAX package's: per-layer weights
stacked on a leading layer axis, weights in the (in, out) layout.  Python
loops over the layers take the place of ``lax.scan``; the per-layer views
come from one ``torch.unbind`` of each stacked tensor.  With ``cfg.remat``
and a gradient wanted, each layer runs under ``torch.utils.checkpoint``
(``jax.checkpoint`` in the JAX package).

The moe family (granite, arctic) is the dense layer stack with a routed
expert FFN (``models/moe.py``) in place of the MLP; it is served, not
trained.  The hybrid family (zamba2) is served, not trained: groups of
``attn_every`` Mamba2 layers, each group followed by the *same* shared
attention+MLP block, then a tail of Mamba2 layers.  The ssm family (xlstm)
is served, not trained: ``n_layers / slstm_period`` segments, each
``slstm_period - 1`` mLSTM blocks (the SSD scan at N = d_head, P = d_head +
1) and one sLSTM block (a sequential loop in plain torch), each block
pre-normed and residual, with no attention and no MLP.  The vlm family
(internvl2) and the audio family (musicgen) are the dense layer stack fed by
precomputed embeddings: their frontends (a ViT, EnCodec) are stubs in the
JAX package too, so they have no embedding table; ``forward`` takes
``{"embeds": (B, S, D)}`` and ``decode_step`` a (B, 1, D) embedding.
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
from .moe import moe_ffn
from .ssm import mamba_block, mamba_decode_step
from .xlstm import (mlstm_block, mlstm_decode_step, slstm_block,
                    slstm_decode_step, slstm_init_state)

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


def hybrid_layout(cfg: ModelConfig) -> tuple[int, int, int]:
    """(groups, Mamba layers per group, tail Mamba layers) of the hybrid
    family: the shared attention block follows each group."""
    per = cfg.attn_every
    n_groups = cfg.n_layers // per
    return n_groups, per, cfg.n_layers - n_groups * per


def ssm_layout(cfg: ModelConfig) -> tuple[int, int]:
    """(segments, mLSTM blocks per segment) of the ssm family: each segment
    ends with one sLSTM block."""
    return cfg.n_layers // cfg.slstm_period, cfg.slstm_period - 1


def _xlstm_layers(params, cfg: ModelConfig) -> list:
    """The ssm family's blocks by segment: (the segment's mLSTM layers,
    its sLSTM layer) for each segment."""
    n_seg, per = ssm_layout(cfg)
    mlstm = [_layers(seg, per) for seg in _layers(params["mlstm"], n_seg)]
    return list(zip(mlstm, _layers(params["slstm"], n_seg)))


def _mamba_layers(params, cfg: ModelConfig) -> tuple[list, list]:
    """The hybrid family's Mamba layers in order: (one list per group,
    unbinding the (G, per) axes of ``groups``; the tail's list)."""
    n_groups, per, tail = hybrid_layout(cfg)
    groups = [_layers(g, per) for g in _layers(params["groups"], n_groups)]
    return groups, (_layers(params["tail"], tail) if tail else [])


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


def _slots(t: torch.Tensor, lead: tuple) -> list:
    """The per-layer views of a tensor with leading layer axes ``lead``
    (one view of the whole tensor for ``lead == ()``)."""
    return list(t.view(-1, *t.shape[len(lead):]).unbind(0)) if lead else [t]


def _attn_layer_params(cfg: ModelConfig, lead: tuple, gen, device):
    """Attention + FFN layer parameters stacked on the axes ``lead`` (() for
    the hybrid family's one shared block).  The FFN is an MLP or, for the
    moe family, the router (fp32) and the experts' swiglu weights, with
    arctic's dense MLP beside them.  Layer by layer, the draws go wq, wk,
    wv, wo, then the MLP's w_up, w_down, w_gate, or the router, w_gate,
    w_up, w_down and the dense MLP's, at the JAX package's scales."""
    dt = dtype_of(cfg)
    D, dh, F_ = cfg.d_model, cfg.d_head, cfg.d_ff

    def empty(*shape, dtype=dt):
        return torch.empty(lead + shape, dtype=dtype, device=device)

    def zeros(*shape, dtype=dt):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    def mlp():
        p = {"w_up": empty(D, F_), "w_down": empty(F_, D)}
        if cfg.act == "swiglu":
            p["w_gate"] = empty(D, F_)
        return p, [(p[n], None) for n in ("w_up", "w_down", "w_gate")
                   if n in p]

    attn = {"wq": empty(D, cfg.n_heads * dh),
            "wk": empty(D, cfg.n_kv_heads * dh),
            "wv": empty(D, cfg.n_kv_heads * dh),
            "wo": empty(cfg.n_heads * dh, D)}
    if cfg.qkv_bias:
        attn["bq"] = zeros(cfg.n_heads * dh)
        attn["bk"] = zeros(cfg.n_kv_heads * dh)
        attn["bv"] = zeros(cfg.n_kv_heads * dh)
    # (tensor, scale) in draw order; scale None: in**-0.5 of a layer's slot
    draws = [(attn[n], None) for n in ("wq", "wk", "wv", "wo")]
    if cfg.family == "moe":
        E, Fe = cfg.n_experts_padded, cfg.d_ff_expert
        moe = {"router": empty(D, E, dtype=torch.float32),
               "w_gate": empty(E, D, Fe), "w_up": empty(E, D, Fe),
               "w_down": empty(E, Fe, D)}
        draws += [(moe["router"], None), (moe["w_gate"], D ** -0.5),
                  (moe["w_up"], D ** -0.5), (moe["w_down"], Fe ** -0.5)]
        if cfg.moe_dense_residual:
            moe["dense"], more = mlp()
            draws += more
        ffn = {"moe": moe}
    else:
        mlp_p, more = mlp()
        ffn = {"mlp": mlp_p}
        draws += more
    for layer in zip(*(_slots(t, lead) for t, _ in draws)):
        for t, (_, scale) in zip(layer, draws):
            _dense_(t, gen, scale)
    ones = zeros(D, dtype=torch.float32).fill_(1.0)
    return {"attn_norm": {"w": ones}, "attn": attn,
            "mlp_norm": {"w": ones.clone()}, **ffn}


def _mamba_params(cfg: ModelConfig, lead: tuple, gen, device):
    """Mamba2 layer parameters stacked on the axes ``lead``; layer by layer,
    the draws go w_in, w_conv, w_out.  dt_bias and a_log are 0 and d_skip 1,
    as in the JAX package."""
    dt = dtype_of(cfg)
    D, di, N, H, k = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                      cfg.ssm_heads, cfg.conv_kernel)

    def new(*shape, dtype=dt, fill=None):
        t = torch.empty(lead + shape, dtype=dtype, device=device)
        return t if fill is None else t.fill_(fill)

    p = {"norm": {"w": new(D, dtype=torch.float32, fill=1.0)},
         "w_in": new(D, 2 * di + 2 * N + H),
         "w_conv": new(k, di, dtype=torch.float32),
         "w_out": new(di, D),
         "dt_bias": new(H, dtype=torch.float32, fill=0.0),
         "a_log": new(H, dtype=torch.float32, fill=0.0),
         "d_skip": new(H, dtype=torch.float32, fill=1.0)}
    for w_in, w_conv, w_out in zip(_slots(p["w_in"], lead),
                                   _slots(p["w_conv"], lead),
                                   _slots(p["w_out"], lead)):
        _dense_(w_in, gen)
        _dense_(w_conv, gen, scale=k ** -0.5)
        _dense_(w_out, gen)
    return p


def _mlstm_params(cfg: ModelConfig, lead: tuple, gen, device):
    """mLSTM block parameters stacked on the axes ``lead``; layer by layer,
    the draws go w_up, w_q, w_k, w_v, w_gates (fp32), w_down.  b_gates is 0
    for the input gates and 3 for the forget gates, as in the JAX
    package."""
    dt = dtype_of(cfg)
    D, H = cfg.d_model, cfg.n_heads

    def new(*shape, dtype=dt):
        return torch.empty(lead + shape, dtype=dtype, device=device)

    p = {"norm": {"w": new(D, dtype=torch.float32).fill_(1.0)},
         "w_up": new(D, 2 * D), "w_q": new(D, D), "w_k": new(D, D),
         "w_v": new(D, D), "w_gates": new(D, 2 * H, dtype=torch.float32),
         "b_gates": new(2 * H, dtype=torch.float32),
         "w_down": new(D, D)}
    p["b_gates"][..., :H] = 0.0
    p["b_gates"][..., H:] = 3.0
    draws = [p[n] for n in ("w_up", "w_q", "w_k", "w_v", "w_gates",
                            "w_down")]
    for layer in zip(*(_slots(t, lead) for t in draws)):
        for t in layer:
            _dense_(t, gen)
    return p


def _slstm_params(cfg: ModelConfig, lead: tuple, gen, device):
    """sLSTM block parameters stacked on the axes ``lead``; layer by layer,
    the draws go w_x, r (fp32, per-head recurrent weights at scale
    dh**-0.5), w_out; the bias is 0."""
    dt = dtype_of(cfg)
    D, H = cfg.d_model, cfg.n_heads
    dh = D // H

    def new(*shape, dtype=dt):
        return torch.empty(lead + shape, dtype=dtype, device=device)

    p = {"norm": {"w": new(D, dtype=torch.float32).fill_(1.0)},
         "w_x": new(D, 4 * D), "r": new(H, dh, 4 * dh, dtype=torch.float32),
         "b": new(4 * D, dtype=torch.float32).zero_(), "w_out": new(D, D)}
    for w_x, r, w_out in zip(_slots(p["w_x"], lead), _slots(p["r"], lead),
                             _slots(p["w_out"], lead)):
        _dense_(w_x, gen)
        _dense_(r, gen, scale=dh ** -0.5)
        _dense_(w_out, gen)
    return p


def init_params(cfg: ModelConfig,
                generator: Optional[torch.Generator] = None, *, device=None):
    """Random parameters on ``device``, drawn from ``generator`` (by
    default a new one seeded with 0, as JAX's default key is PRNGKey(0)).
    Shapes, dtypes and scales follow the JAX package's ``init_params``,
    including the hybrid family's tree: ``groups`` (G, per, ...), ``tail``
    (T, ...) and one ``shared_attn`` layer, the ssm family's: ``mlstm``
    (n_seg, period - 1, ...) and ``slstm`` (n_seg, ...), and no ``embed``
    table where ``cfg.frontend`` feeds precomputed embeddings (vlm,
    audio).  The numbers differ (torch and JAX generators differ — load
    JAX's parameters with :func:`repro_torch.models.convert.params_from_numpy`
    to compare the two).  Each layer is drawn straight into its slot of the
    stacked tensor, so the fp32 draw is one layer at a time: a full-width
    model needs no more than its bf16 size plus one layer's largest fp32
    matrix."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    dt = dtype_of(cfg)
    D = cfg.d_model
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        trunk = {"layers": _attn_layer_params(cfg, (cfg.n_layers,),
                                              generator, device)}
    elif cfg.family == "ssm":
        n_seg, per = ssm_layout(cfg)
        trunk = {"mlstm": _mlstm_params(cfg, (n_seg, per), generator,
                                        device),
                 "slstm": _slstm_params(cfg, (n_seg,), generator, device)}
    elif cfg.family == "hybrid":
        n_groups, per, tail = hybrid_layout(cfg)
        trunk = {"groups": _mamba_params(cfg, (n_groups, per), generator,
                                         device)}
        if tail:
            trunk["tail"] = _mamba_params(cfg, (tail,), generator, device)
        trunk["shared_attn"] = _attn_layer_params(cfg, (), generator, device)
    else:
        raise ValueError(cfg.family)

    def empty(*shape):
        return torch.empty(shape, dtype=dt, device=device)

    params: dict[str, Any] = {}
    if cfg.frontend == "none":
        params["embed"] = {"tok": _dense_(empty(cfg.vocab_padded, D),
                                          generator, scale=0.02)}
    params.update(trunk)
    params["final_norm"] = {"w": torch.ones(D, dtype=torch.float32,
                                            device=device)}
    params["lm_head"] = _dense_(empty(D, cfg.vocab_padded), generator,
                                scale=D ** -0.5)
    return params


# ---------------------------------------------------------------------------
# forward (prefill trunk)
# ---------------------------------------------------------------------------


def _ffn(lp, x, cfg: ModelConfig):
    """The layer's FFN on its normed input: the routed experts for the moe
    family, else the MLP."""
    h = norm(lp["mlp_norm"], x, cfg.norm_eps)
    if cfg.family == "moe":
        return moe_ffn(lp["moe"], h, cfg)
    return mlp_block(lp["mlp"], h, cfg)


def _attn_mlp_block(lp, x, cfg: ModelConfig, positions):
    h, k, v = attention_block(lp["attn"], norm(lp["attn_norm"], x,
                                               cfg.norm_eps), cfg, positions)
    x = x + h
    x = x + _ffn(lp, x, cfg)
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


def _hybrid_trunk(params, x, cfg: ModelConfig, positions, collect: bool):
    """The hybrid family's trunk: each group of Mamba2 layers, then the
    shared attention+MLP block (the same weights every time), then the
    tail.  With ``collect`` also its states (see :func:`forward`)."""
    groups, tail = _mamba_layers(params, cfg)
    mamba_states, kvs = [], []

    def mamba(lp, x):
        h = norm(lp["norm"], x, cfg.norm_eps)
        if collect:
            y, st = mamba_block(lp, h, cfg, return_state=True)
            mamba_states.append(st)
            return x + y
        return x + mamba_block(lp, h, cfg)

    for group in groups:
        for lp in group:
            x = mamba(lp, x)
        x, kv = _attn_mlp_block(params["shared_attn"], x, cfg, positions)
        if collect:
            kvs.append(kv)
    for lp in tail:
        x = mamba(lp, x)
    return x, ({"mamba": mamba_states, "kv": kvs} if collect else None)


def _ssm_trunk(params, x, cfg: ModelConfig, collect: bool):
    """The ssm family's trunk: each segment's mLSTM blocks, then its sLSTM
    block, each pre-normed and residual.  With ``collect`` also its states
    (see :func:`forward`)."""
    m_states, s_states = [], []
    for mlstm, slp in _xlstm_layers(params, cfg):
        for lp in mlstm:
            h = norm(lp["norm"], x, cfg.norm_eps)
            if collect:
                y, st = mlstm_block(lp, h, cfg, return_state=True)
                m_states.append(st)
            else:
                y = mlstm_block(lp, h, cfg)
            x = x + y
        h = norm(slp["norm"], x, cfg.norm_eps)
        if collect:
            y, st = slstm_block(slp, h, cfg, return_state=True)
            s_states.append(st)
        else:
            y = slstm_block(slp, h, cfg)
        x = x + y
    return x, ({"mlstm": m_states, "slstm": s_states} if collect else None)


def _input_key(cfg: ModelConfig) -> str:
    """The inputs' key: "tokens", or "embeds" where ``cfg.frontend`` feeds
    precomputed embeddings (vlm, audio)."""
    return "tokens" if cfg.frontend == "none" else "embeds"


def _trunk_input(params, token_or_embed, cfg: ModelConfig):
    """The trunk's input in the model's dtype: (B, S) tokens embedded, or
    (B, S, D) precomputed embeddings cast."""
    if cfg.frontend == "none":
        return embed(params["embed"], token_or_embed, cfg)
    return token_or_embed.to(dtype_of(cfg))


def forward(params, inputs: dict, cfg: ModelConfig, collect: bool = False):
    """inputs: {"tokens": (B,S)}, or {"embeds": (B,S,D)} for the vlm and
    audio families.  Returns (hidden (B,S,D), states), the states None
    unless ``collect``: for the dense, moe, vlm and audio families the
    per-layer (k, v), each (B, S, Hkv, dh); for the hybrid family {"mamba": the
    (conv_state (B, k-1, di) fp32, ssd_state (B, H, N, P) fp32) of each
    Mamba2 layer in order, "kv": the (k, v) of each application of the
    shared block}; for the ssm family {"mlstm": the (B, H, dh, dh + 1) fp32
    memory of each mLSTM block in order, "slstm": the (h, c, n, m) of each
    sLSTM block}."""
    x = _trunk_input(params, inputs[_input_key(cfg)], cfg)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    if cfg.family in ("hybrid", "ssm"):
        if cfg.family == "hybrid":
            x, states = _hybrid_trunk(params, x, cfg, positions, collect)
        else:
            x, states = _ssm_trunk(params, x, cfg, collect)
        return norm(params["final_norm"], x, cfg.norm_eps), states
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
    """Decode state: the per-lane KV caches (n, B, S_max, Hkv, dh), with n
    the layers (dense, moe, vlm, audio) or the applications of the shared
    block (hybrid), and lengths (B,) int32.  The hybrid family adds a conv
    state (L, B, k-1, di) and an SSD state (L, B, H, N, P) per Mamba2
    layer, both fp32.  The ssm family has no KV cache: its state is the
    mLSTM memories (n_seg, period - 1, B, H, dh, dh + 1) and the sLSTM's
    (h, c, n, m), each (n_seg, B, H, dh), all fp32 (m starts at -1e30), and
    the lengths."""
    device = resolve_device(device)
    if cfg.family == "ssm":
        n_seg, per = ssm_layout(cfg)
        H = cfg.n_heads
        dh = cfg.d_model // H
        slstm = slstm_init_state(n_seg * batch, cfg, device)
        return {"mlstm": torch.zeros((n_seg, per, batch, H, dh, dh + 1),
                                     dtype=torch.float32, device=device),
                "slstm": tuple(t.view(n_seg, batch, H, dh) for t in slstm),
                "len": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}
    dt = dtype or dtype_of(cfg)
    n_kv = (hybrid_layout(cfg)[0] if cfg.family == "hybrid"
            else cfg.n_layers)
    shape = (n_kv, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    state = {"kv": {"k": torch.zeros(shape, dtype=dt, device=device),
                    "v": torch.zeros(shape, dtype=dt, device=device)},
             "len": torch.zeros((batch,), dtype=torch.int32, device=device)}
    if cfg.family == "hybrid":
        f32 = dict(dtype=torch.float32, device=device)
        state["conv"] = torch.zeros((cfg.n_layers, batch, cfg.conv_kernel - 1,
                                     cfg.d_inner), **f32)
        state["ssd"] = torch.zeros((cfg.n_layers, batch, cfg.ssm_heads,
                                    cfg.ssm_state, cfg.ssm_head_dim), **f32)
    return state


def _hybrid_decode(params, state: dict, x, cfg: ModelConfig):
    """The hybrid trunk for one token, updating the state's caches in
    place."""
    groups, tail = _mamba_layers(params, cfg)
    conv_all, ssd_all = state["conv"], state["ssd"]
    kc_all, vc_all = state["kv"]["k"], state["kv"]["v"]
    sa = params["shared_attn"]
    li = 0

    def mamba(lp, x, i):
        y, cs, ss = mamba_decode_step(lp, norm(lp["norm"], x, cfg.norm_eps),
                                      cfg, conv_all[i], ssd_all[i])
        conv_all[i].copy_(cs)
        ssd_all[i].copy_(ss)
        return x + y

    for g, group in enumerate(groups):
        for lp in group:
            x = mamba(lp, x, li)
            li += 1
        a, _, _ = attention_decode(
            sa["attn"], norm(sa["attn_norm"], x, cfg.norm_eps), cfg,
            kc_all[g], vc_all[g], state["len"])
        x = x + a
        x = x + mlp_block(sa["mlp"], norm(sa["mlp_norm"], x, cfg.norm_eps),
                          cfg)
    for lp in tail:
        x = mamba(lp, x, li)
        li += 1
    return x


def _ssm_decode(params, state: dict, x, cfg: ModelConfig):
    """The ssm trunk for one token, updating the state's mLSTM memories and
    sLSTM (h, c, n, m) in place."""
    m_all, s_all = state["mlstm"], state["slstm"]
    for g, (mlstm, slp) in enumerate(_xlstm_layers(params, cfg)):
        for j, lp in enumerate(mlstm):
            y, st = mlstm_decode_step(lp, norm(lp["norm"], x, cfg.norm_eps),
                                      cfg, m_all[g, j])
            m_all[g, j].copy_(st)
            x = x + y
        y, st = slstm_decode_step(slp, norm(slp["norm"], x, cfg.norm_eps),
                                  cfg, tuple(t[g] for t in s_all))
        for buf, new in zip(s_all, st):
            buf[g].copy_(new)
        x = x + y
    return x


def decode_step(params, state: dict, token_or_embed, cfg: ModelConfig):
    """One decode step.  token_or_embed: (B, 1) int, or a (B, 1, D)
    embedding for the vlm and audio families.  Returns (logits
    (B, vocab_padded) fp32, new_state).

    The KV caches of ``state`` (see ``layers.attention_decode``), for the
    hybrid family its conv and SSD states, and for the ssm family its mLSTM
    and sLSTM states are updated IN PLACE and shared by the returned state;
    only ``len`` is a new tensor.  (The JAX
    package returns new arrays, and its new conv state has the model's
    dtype; here the fp32 buffer keeps the same values.)  A caller that needs
    the old state copies it first."""
    x = _trunk_input(params, token_or_embed, cfg)
    cache_len = state["len"]
    if cfg.family == "hybrid":
        x = _hybrid_decode(params, state, x, cfg)
    elif cfg.family == "ssm":
        x = _ssm_decode(params, state, x, cfg)
    else:
        kc_all, vc_all = state["kv"]["k"], state["kv"]["v"]
        for i, lp in enumerate(_layers(params["layers"], cfg.n_layers)):
            a, _, _ = attention_decode(
                lp["attn"], norm(lp["attn_norm"], x, cfg.norm_eps), cfg,
                kc_all[i], vc_all[i], cache_len)
            x = x + a
            x = x + _ffn(lp, x, cfg)
    x = norm(params["final_norm"], x, cfg.norm_eps)
    logits = (x[:, 0] @ params["lm_head"]).float()
    return logits, {**state, "len": cache_len + 1}


def prefill(params, inputs: dict, cfg: ModelConfig, max_len: int):
    """Run the full prompt (``tokens`` (B, S), or ``embeds`` (B, S, D) for
    the vlm and audio families), returning (last_logits, decode state): the
    K/V of the trunk written into a ``max_len`` cache; for the hybrid family
    also the conv and SSD states of each Mamba2 layer; for the ssm family
    the mLSTM and sLSTM states of each block (no cache)."""
    prompt = inputs[_input_key(cfg)]
    B, S = prompt.shape[:2]
    if S > max_len:
        raise ValueError(f"prompt of {S} tokens exceeds max_len {max_len}")
    hidden, states = forward(params, inputs, cfg, collect=True)
    state = init_decode_state(cfg, B, max_len, device=prompt.device)
    kvs = states
    if cfg.family == "ssm":
        per = ssm_layout(cfg)[1]
        for i, st in enumerate(states["mlstm"]):
            state["mlstm"][i // per, i % per].copy_(st)
        for g, st in enumerate(states["slstm"]):
            for buf, new in zip(state["slstm"], st):
                buf[g].copy_(new)
        kvs = []
    elif cfg.family == "hybrid":
        for i, (conv, ssd) in enumerate(states["mamba"]):
            state["conv"][i].copy_(conv)
            state["ssd"][i].copy_(ssd)
        kvs = states["kv"]
    for i, (k, v) in enumerate(kvs):
        state["kv"]["k"][i, :, :S] = k        # in place into the new cache
        state["kv"]["v"][i, :, :S] = v
    state["len"] = torch.full((B,), S, dtype=torch.int32,
                              device=prompt.device)
    logits = (hidden[:, -1] @ params["lm_head"]).float()
    return logits, state
