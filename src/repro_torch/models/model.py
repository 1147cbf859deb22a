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
expert FFN (``models/moe.py``) in place of the MLP; it is served and
trained (its grouped products have a backward kernel).  The hybrid family
(zamba2) is served and trained (the SSD scan has a backward kernel at its
N = P = 64): groups of ``attn_every`` Mamba2 layers, each group followed by
the *same* shared attention+MLP block, then a tail of Mamba2 layers.  The
ssm family (xlstm) is served and trained (the SSD scan has a backward
kernel at its N = d_head, P = d_head + 1 too): ``n_layers /
slstm_period`` segments, each ``slstm_period - 1`` mLSTM blocks (the SSD
scan) and one sLSTM block (a sequential loop in plain torch, its backward
written out), each block pre-normed and residual, with no attention and no
MLP.  The vlm family
(internvl2) and the audio family (musicgen) are the dense layer stack fed by
precomputed embeddings: their frontends (a ViT, EnCodec) are stubs in the
JAX package too, so they have no embedding table; ``forward`` takes
``{"embeds": (B, S, D)}`` and ``decode_step`` a (B, 1, D) embedding.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..distributed.collectives import gather_full
from ..distributed.context import current_context, use_context
from ..distributed.policy import (params_for_use, strip_lead,
                                  tree_map_with_path)
from ..kernels import fused_cross_entropy
from ..kernels.common import resolve_device
from ..optim.optimizers import tree_map
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
    if out.is_meta:                      # param_specs: shapes only
        return out
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


def _placed(fn, cfg: ModelConfig, lead: tuple, gen, device, place,
            path: str):
    """``fn(cfg, lead, gen, device)``'s tree; with ``place``, each layer is
    drawn whole (``lead == ()``, the same draws in the same order as one
    slot of the stacked call) and only ``place(path/key, len(lead), t)``,
    this rank's shard of it, is kept in the stacked tensors."""
    if place is None:
        return fn(cfg, lead, gen, device)
    out = None
    for i in range(math.prod(lead)):
        layer = fn(cfg, (), gen, device)
        local = tree_map_with_path(
            lambda p, t: place(p, len(lead), t), layer, f"{path}/")
        if out is None:
            out = tree_map(lambda t: torch.empty(
                lead + t.shape, dtype=t.dtype, device=t.device), local)
        tree_map(lambda o, t: o.view(-1, *t.shape)[i].copy_(t), out, local)
        del layer, local
    return out


def init_params(cfg: ModelConfig,
                generator: Optional[torch.Generator] = None, *, device=None,
                place=None):
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
    matrix.  On ``device="meta"`` nothing is drawn (:func:`param_specs`).

    ``place(path, lead, tensor)`` keeps a rank's shard: each layer is drawn
    whole, one at a time, and only ``place``'s result is kept (``lead`` is
    the number of stacked layer dims the full leaf at ``path`` has and the
    drawn one lacks).  The numbers are those of the unsharded call with
    the same generator, so every rank of a mesh draws its shards of one
    model without holding the whole of it."""
    device = resolve_device(device)
    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    dt = dtype_of(cfg)
    D = cfg.d_model
    args = (generator, device, place)
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        trunk = {"layers": _placed(_attn_layer_params, cfg, (cfg.n_layers,),
                                   *args, "layers")}
    elif cfg.family == "ssm":
        n_seg, per = ssm_layout(cfg)
        trunk = {"mlstm": _placed(_mlstm_params, cfg, (n_seg, per), *args,
                                  "mlstm"),
                 "slstm": _placed(_slstm_params, cfg, (n_seg,), *args,
                                  "slstm")}
    elif cfg.family == "hybrid":
        n_groups, per, tail = hybrid_layout(cfg)
        trunk = {"groups": _placed(_mamba_params, cfg, (n_groups, per),
                                   *args, "groups")}
        if tail:
            trunk["tail"] = _placed(_mamba_params, cfg, (tail,), *args,
                                    "tail")
        trunk["shared_attn"] = _placed(_attn_layer_params, cfg, (), *args,
                                       "shared_attn")
    else:
        raise ValueError(cfg.family)

    def drawn(path, shape, scale):
        t = _dense_(torch.empty(shape, dtype=dt, device=device), generator,
                    scale=scale)
        return t if place is None else place(path, 0, t)

    params: dict[str, Any] = {}
    if cfg.frontend == "none":
        params["embed"] = {"tok": drawn("embed/tok", (cfg.vocab_padded, D),
                                        0.02)}
    params.update(trunk)
    params["final_norm"] = {"w": torch.ones(D, dtype=torch.float32,
                                            device=device)}
    params["lm_head"] = drawn("lm_head", (D, cfg.vocab_padded), D ** -0.5)
    return params


def param_specs(cfg: ModelConfig):
    """The parameter tree as meta tensors: shapes and dtypes of
    :func:`init_params` without allocation (the reference's
    ``jax.eval_shape`` over it)."""
    return init_params(cfg, device="meta")


# ---------------------------------------------------------------------------
# forward (prefill trunk)
# ---------------------------------------------------------------------------


def _specs(key: str, lead: int):
    """The specs of one layer of ``params[key]`` under the context (None
    without one): each layer gathers what it computes whole
    (``distributed.policy.params_for_use``)."""
    ctx = current_context()
    if ctx is None or ctx.param_specs is None:
        return None
    return strip_lead(ctx.param_specs[key], lead)


def _use(tree, specs, cfg: ModelConfig):
    return tree if specs is None else params_for_use(tree, specs, cfg)


def _ffn(lp, x, cfg: ModelConfig):
    """The layer's FFN on its normed input: the routed experts for the moe
    family, else the MLP."""
    h = norm(lp["mlp_norm"], x, cfg.norm_eps)
    if cfg.family == "moe":
        return moe_ffn(lp["moe"], h, cfg)
    return mlp_block(lp["mlp"], h, cfg)


def _attn_mlp_block(lp, x, cfg: ModelConfig, positions, specs=None):
    lp = _use(lp, specs, cfg)
    h, k, v = attention_block(lp["attn"], norm(lp["attn_norm"], x,
                                               cfg.norm_eps), cfg, positions)
    x = x + h
    x = x + _ffn(lp, x, cfg)
    return x, (k, v)


def _remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)`` keeping only its inputs for the backward and running it
    again there (layer-granular remat, JAX's ``remat_policy "full"``)."""
    if cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r}: only 'full' is ported; the "
            "'dots' policy (save the matmul outputs) is queued in ROADMAP.md")
    return checkpoint(_in_context, current_context(), fn, *args,
                      use_reentrant=False)


def _remat_layer(lp, x, cfg: ModelConfig, positions, specs=None):
    """One attention+FFN layer under :func:`_remat`.  Under it each layer's
    2 rmsnorm and 1 flash-attention forwards launch twice a step.  The k/v
    it would hand to prefill are dropped: remat applies only when they are
    not collected."""
    x, _ = _remat(cfg, _attn_mlp_block, lp, x, cfg, positions, specs)
    return x


def _in_context(ctx, fn, *args):
    """``fn(*args)`` under ``ctx``: the backward recomputes the layer on
    autograd's device thread, where the caller's (thread-local) sharding
    context is not set."""
    with use_context(ctx):
        return fn(*args)


def _mamba_layer(lp, x, cfg: ModelConfig, specs=None, return_state=False):
    """One pre-normed, residual Mamba2 layer; with ``return_state`` also
    the block's state."""
    lp = _use(lp, specs, cfg)
    h = norm(lp["norm"], x, cfg.norm_eps)
    if return_state:
        y, st = mamba_block(lp, h, cfg, return_state=True)
        return x + y, st
    return x + mamba_block(lp, h, cfg)


def _hybrid_trunk(params, x, cfg: ModelConfig, positions, collect: bool):
    """The hybrid family's trunk: each group of Mamba2 layers, then the
    shared attention+MLP block (the same weights every time), then the
    tail.  With ``collect`` also its states (see :func:`forward`).

    With ``cfg.remat`` and a gradient wanted, each Mamba2 layer and each
    application of the shared block runs under :func:`_remat`.  The JAX
    package remats the same layers and also each group around them
    (``src/repro/models/model.py:_trunk``); that nesting changes no number
    and would run every grouped layer's forward a third time, so the port
    keeps the layer granularity: each Mamba2 layer's rmsnorm and SSD scan,
    and the shared block's 2 rmsnorms and flash forward, launch twice."""
    groups, tail = _mamba_layers(params, cfg)
    remat = cfg.remat and not collect and torch.is_grad_enabled()
    mamba_states, kvs = [], []
    g_specs, t_specs = _specs("groups", 2), _specs("tail", 1) if tail \
        else None
    a_specs = _specs("shared_attn", 0)

    def mamba(lp, x, specs):
        if remat:
            return _remat(cfg, _mamba_layer, lp, x, cfg, specs)
        if not collect:
            return _mamba_layer(lp, x, cfg, specs)
        x, st = _mamba_layer(lp, x, cfg, specs, return_state=True)
        mamba_states.append(st)
        return x

    for group in groups:
        for lp in group:
            x = mamba(lp, x, g_specs)
        if remat:
            x = _remat_layer(params["shared_attn"], x, cfg, positions,
                             a_specs)
            continue
        x, kv = _attn_mlp_block(params["shared_attn"], x, cfg, positions,
                                a_specs)
        if collect:
            kvs.append(kv)
    for lp in tail:
        x = mamba(lp, x, t_specs)
    return x, ({"mamba": mamba_states, "kv": kvs} if collect else None)


def _xlstm_layer(block, lp, x, cfg: ModelConfig, specs=None,
                 return_state=False):
    """One pre-normed, residual xLSTM block (``block``: ``mlstm_block`` or
    ``slstm_block``); with ``return_state`` also the block's state."""
    lp = _use(lp, specs, cfg)
    h = norm(lp["norm"], x, cfg.norm_eps)
    if return_state:
        y, st = block(lp, h, cfg, return_state=True)
        return x + y, st
    return x + block(lp, h, cfg)


def _ssm_trunk(params, x, cfg: ModelConfig, collect: bool):
    """The ssm family's trunk: each segment's mLSTM blocks, then its sLSTM
    block, each pre-normed and residual.  With ``collect`` also its states
    (see :func:`forward`).

    With ``cfg.remat`` and a gradient wanted, each mLSTM block runs under
    :func:`_remat`; the sLSTM block runs outside it, its scan keeping each
    step's values (~0.8 GB a block at an xlstm-1.3b train microbatch)
    where the remat would run its loop over time twice (on the H100, 2.90
    s a step at a 28.8 GiB peak outside against 3.92 s at 25.1 GiB under
    it, PERF.md §6).  The JAX package remats each mLSTM block and also each
    segment around them (``src/repro/models/model.py:_trunk``); that
    nesting changes no number and would run every mLSTM block's forward a
    third time, so the port keeps the block granularity, as
    :func:`_hybrid_trunk` does: each mLSTM block's rmsnorm and wide SSD
    scan launch twice, the sLSTM block's once."""
    remat = cfg.remat and not collect and torch.is_grad_enabled()
    m_states, s_states = [], []
    m_specs, s_specs = _specs("mlstm", 2), _specs("slstm", 1)

    def layer(block, lp, x, specs, states, under_remat):
        if under_remat:
            return _remat(cfg, _xlstm_layer, block, lp, x, cfg, specs)
        if not collect:
            return _xlstm_layer(block, lp, x, cfg, specs)
        x, st = _xlstm_layer(block, lp, x, cfg, specs, return_state=True)
        states.append(st)
        return x

    for mlstm, slp in _xlstm_layers(params, cfg):
        for lp in mlstm:
            x = layer(mlstm_block, lp, x, m_specs, m_states, remat)
        x = layer(slstm_block, slp, x, s_specs, s_states, False)
    return x, ({"mlstm": m_states, "slstm": s_states} if collect else None)


def _input_key(cfg: ModelConfig) -> str:
    """The inputs' key: "tokens", or "embeds" where ``cfg.frontend`` feeds
    precomputed embeddings (vlm, audio)."""
    return "tokens" if cfg.frontend == "none" else "embeds"


def _trunk_input(params, token_or_embed, cfg: ModelConfig):
    """The trunk's input in the model's dtype: (B, S) tokens embedded, or
    (B, S, D) precomputed embeddings cast."""
    if cfg.frontend == "none":
        return embed(_use(params["embed"], _specs("embed", 0), cfg),
                     token_or_embed, cfg)
    return token_or_embed.to(dtype_of(cfg))


def lm_head(params, cfg: ModelConfig, keep_vocab: bool = True):
    """The unembedding as the caller computes with it: under a context its
    FSDP dim gathered, and its vocab dim the rank's slice where
    ``keep_vocab`` (else gathered too)."""
    ctx = current_context()
    if ctx is None or ctx.param_specs is None:
        return params["lm_head"]
    return params_for_use({"lm_head": params["lm_head"]},
                          {"lm_head": ctx.param_specs["lm_head"]}, cfg,
                          keep_vocab=keep_vocab)["lm_head"]


def _logits(params, h, cfg: ModelConfig):
    """fp32 logits (B, vocab_padded) of the hidden states h (B, D); under a
    context the ranks' vocab slices are gathered."""
    logits = (h @ lm_head(params, cfg)).float()
    if logits.shape[-1] != cfg.vocab_padded:
        logits = gather_full(logits, (None, "model"), current_context().mesh)
    return logits


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
    specs = _specs("layers", 1)
    for lp in _layers(params["layers"], cfg.n_layers):
        if remat:
            x = _remat_layer(lp, x, cfg, positions, specs)
            continue
        x, kv = _attn_mlp_block(lp, x, cfg, positions, specs)
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
    sa = _use(params["shared_attn"], _specs("shared_attn", 0), cfg)
    g_specs, t_specs = _specs("groups", 2), _specs("tail", 1) if tail \
        else None
    li = 0

    def mamba(lp, x, i, specs):
        lp = _use(lp, specs, cfg)
        y, cs, ss = mamba_decode_step(lp, norm(lp["norm"], x, cfg.norm_eps),
                                      cfg, conv_all[i], ssd_all[i])
        conv_all[i].copy_(cs)
        ssd_all[i].copy_(ss)
        return x + y

    for g, group in enumerate(groups):
        for lp in group:
            x = mamba(lp, x, li, g_specs)
            li += 1
        a, _, _ = attention_decode(
            sa["attn"], norm(sa["attn_norm"], x, cfg.norm_eps), cfg,
            kc_all[g], vc_all[g], state["len"])
        x = x + a
        x = x + mlp_block(sa["mlp"], norm(sa["mlp_norm"], x, cfg.norm_eps),
                          cfg)
    for lp in tail:
        x = mamba(lp, x, li, t_specs)
        li += 1
    return x


def _ssm_decode(params, state: dict, x, cfg: ModelConfig):
    """The ssm trunk for one token, updating the state's mLSTM memories and
    sLSTM (h, c, n, m) in place."""
    m_all, s_all = state["mlstm"], state["slstm"]
    m_specs, s_specs = _specs("mlstm", 2), _specs("slstm", 1)
    for g, (mlstm, slp) in enumerate(_xlstm_layers(params, cfg)):
        slp = _use(slp, s_specs, cfg)
        for j, lp in enumerate(mlstm):
            lp = _use(lp, m_specs, cfg)
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
        specs = _specs("layers", 1)
        for i, lp in enumerate(_layers(params["layers"], cfg.n_layers)):
            lp = _use(lp, specs, cfg)
            a, _, _ = attention_decode(
                lp["attn"], norm(lp["attn_norm"], x, cfg.norm_eps), cfg,
                kc_all[i], vc_all[i], cache_len)
            x = x + a
            x = x + _ffn(lp, x, cfg)
    x = norm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, x[:, 0], cfg), {**state, "len": cache_len + 1}


def prefill(params, inputs: dict, cfg: ModelConfig, max_len: int):
    """Run the full prompt (``tokens`` (B, S), or ``embeds`` (B, S, D) for
    the vlm and audio families), returning (last_logits, decode state): the
    K/V of the trunk written into a ``max_len`` cache; for the hybrid family
    also the conv and SSD states of each Mamba2 layer; for the ssm family
    the mLSTM and sLSTM states of each block (no cache).

    Under a context whose kv_cache rule shards S over ``model``, the state
    is this rank's part (``decode_state_pspecs``): the rank's lanes, and of
    each cache its S/tp slice, into which the rank writes the prompt's K/V
    of every head (gathered over ``model`` under TP)."""
    prompt = inputs[_input_key(cfg)]
    B, S = prompt.shape[:2]
    if S > max_len:
        raise ValueError(f"prompt of {S} tokens exceeds max_len {max_len}")
    hidden, states = forward(params, inputs, cfg, collect=True)
    ctx = current_context()
    kv_rule = ctx.spec("kv_cache_stacked") if ctx is not None else None
    lo, s_loc = 0, max_len
    if kv_rule is not None and kv_rule[2] == "model":
        mesh = ctx.mesh
        tp = mesh.axes_size("model")
        if max_len % tp:
            raise ValueError(f"a cache of {max_len} does not split over "
                             f"{tp} model ranks")
        s_loc = max_len // tp
        lo = mesh.index("model") * s_loc
    state = init_decode_state(cfg, B, s_loc, device=prompt.device)
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
    hi = min(S, lo + s_loc)
    for i, (k, v) in enumerate(kvs):
        if k.shape[2] != cfg.n_kv_heads:           # the rank's heads (TP)
            k, v = (gather_full(t, (None, None, "model", None), ctx.mesh)
                    for t in (k, v))
        if hi > lo:                   # in place into the new cache
            state["kv"]["k"][i, :, :hi - lo] = k[:, lo:hi]
            state["kv"]["v"][i, :, :hi - lo] = v[:, lo:hi]
    state["len"] = torch.full((B,), S, dtype=torch.int32,
                              device=prompt.device)
    return _logits(params, hidden[:, -1], cfg), state
