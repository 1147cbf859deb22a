"""Mixture-of-Experts FFN (the counterpart of ``repro.models.moe``), with
its expert- and data-parallel branches.

Routing: top-k softmax over the real experts (the padding experts masked
to -inf: granite's 40 experts are padded to 48).  Capacity: each expert
takes at most C = ⌈T·k/E⌉·1.25 of the call's T tokens (E the real
experts); assignments past C are dropped in token order (GShard-style).  C
depends on the call's T, so a decode step of B lanes has its own capacity
and the lanes of one call share it.  The three expert products run through
the ``moe_gmm`` grouped matmul with equal groups of C.

The combine is deterministic: each assignment's weighted contribution is
copied back to its (token, k) place, zero where dropped, and the k axis is
summed in fp32 in a fixed order (the JAX package scatter-adds;
``index_add_`` on CUDA would add in another order on every run).

Under autograd the dispatch (an index assignment into the buffer), the
grouped products (``moe_gmm``'s backward) and the combine give the
reference's gradients: a padding expert's router column gets 0 (its logit
is masked to -inf before the top-k), and a dropped assignment gives nothing
(it writes the buffer's overflow row, which is cut off before the
products, and its place in the combine stays 0).

Expert parallelism (a context with ``ep_axis``): every rank routes the same
tokens, serves its E/ep experts (at offset idx·E/ep) and the ranks sum
their partial outputs — one all-reduce a layer.  The capacity is sized from
all the tokens routed, so where the batch is split over the data axes the
rank first gathers it, as the reference's region sees the whole batch.
Data parallelism without EP (a context with ``dp_axes``): each rank routes
only its own tokens with all experts, its capacity sized from its own T, so
the drops follow the shard.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.collectives import (enter_split, gather_on_use,
                                       leave_split)
from ..distributed.context import current_context
from ..kernels import moe_gmm
from .config import ModelConfig
from .layers import mlp_block

CAPACITY_FACTOR = 1.25

# When a list, each local MoE call appends its routing as the device tensors
# it already holds: {"tokens": T, "capacity": C, "order": the sort of the
# T·k assignments (assignment j is token j // k's), and in that order
# "expert", the local expert (n_local for another rank's), and "keep",
# whether it got a slot}.  Nothing is launched or read back on the path;
# the caller counts loads and drops after the run.  None: off.
ROUTING_STATS: list | None = None


def capacity(cfg: ModelConfig, T: int) -> int:
    """Rows per expert for a call of T tokens, sized over the REAL experts
    (padding never receives tokens), in Python integers as in JAX."""
    return int(max(1, -(-T * cfg.top_k // cfg.n_experts) * CAPACITY_FACTOR))


def _route(params, x_flat, cfg: ModelConfig):
    """x_flat: (T, D) → (weights (T, k) fp32, experts (T, k))."""
    logits = x_flat.float() @ params["router"].float()
    e_pad = cfg.n_experts_padded
    if e_pad > cfg.n_experts:
        pad = torch.arange(e_pad, device=logits.device) >= cfg.n_experts
        logits = logits.masked_fill(pad, float("-inf"))
    weights, experts = torch.topk(logits, cfg.top_k, dim=-1, sorted=True)
    return torch.softmax(weights, dim=-1), experts


def _expert_compute(params, xe, n_local: int, cap: int):
    """xe: (n_local·C, D) expert-sorted rows (equal groups of C)."""
    sizes = torch.full((n_local,), cap, dtype=torch.int32, device=xe.device)
    h_gate = moe_gmm(xe, params["w_gate"], sizes, equal_groups=cap)
    h_up = moe_gmm(xe, params["w_up"], sizes, equal_groups=cap)
    h = F.silu(h_gate) * h_up
    return moe_gmm(h, params["w_down"], sizes, equal_groups=cap)


def _moe_local(params, x_flat, cfg: ModelConfig, n_local: int,
               expert_offset: int, out_dtype=None):
    """Dispatch, compute and combine for the local experts: all of them
    (n_local = E_padded, expert_offset = 0), or a rank's slice under EP.
    The combine is fp32, returned in ``out_dtype`` (x's by default)."""
    T, D = x_flat.shape
    k = cfg.top_k
    cap = capacity(cfg, T)
    dev = x_flat.device

    weights, experts = _route(params, x_flat, cfg)          # (T, k) each

    tok = torch.arange(T, device=dev).repeat_interleave(k)  # (T·k,)
    exp = experts.reshape(-1) - expert_offset               # local ids
    wgt = weights.reshape(-1)
    mine = (exp >= 0) & (exp < n_local)

    # position of each assignment within its expert's capacity-C buffer;
    # other ranks' assignments get the sentinel key n_local, so the sorted
    # key is monotone (searchsorted needs it)
    key = torch.where(mine, exp, torch.full_like(exp, n_local))
    order = torch.argsort(key, stable=True)
    key_sorted = key[order]
    pos_in_e = torch.arange(T * k, device=dev) - torch.searchsorted(
        key_sorted, key_sorted, side="left")
    keep = mine[order] & (pos_in_e < cap)
    slot = torch.where(keep, key_sorted * cap + pos_in_e,
                       torch.full_like(pos_in_e, n_local * cap))

    # tokens into the (n_local·C, D) dispatch buffer (+1 overflow row)
    buf = torch.zeros((n_local * cap + 1, D), dtype=x_flat.dtype, device=dev)
    buf[slot] = x_flat[tok[order]]
    ye = _expert_compute(params, buf[:-1], n_local, cap)

    if ROUTING_STATS is not None:
        ROUTING_STATS.append({"tokens": T, "capacity": cap, "order": order,
                              "expert": key_sorted, "keep": keep})

    # combine: each slot's row times its assignment's weight (fp32) is
    # copied to the assignment's (token, k) place; the slots no assignment
    # filled go to one more place, cut off, and a dropped assignment's
    # place stays 0.  Every place is written by at most one slot, so the
    # backward is a gather: a gather of ye by slot would scatter-add back
    # into ye, with every dropped assignment on one row, which serialises
    # on the card (~15 ms a call at a training microbatch's 30,000 drops)
    n_slots = n_local * cap
    assign = torch.full((n_slots + 1,), T * k, dtype=order.dtype, device=dev)
    assign[slot] = order              # dropped ones land on the last entry
    w_slot = torch.zeros(n_slots + 1, dtype=wgt.dtype, device=dev)
    w_slot[slot] = wgt[order]
    contrib = ye * w_slot[:-1, None]
    placed = torch.zeros((T * k + 1, D), dtype=contrib.dtype, device=dev)
    placed = placed.index_copy(0, assign[:-1], contrib)
    return placed[:-1].view(T, k, D).sum(dim=1).to(out_dtype or x_flat.dtype)


def _batch_axes(ctx):
    """The axes the activations' batch dim is split over (None: whole)."""
    rule = ctx.spec("act_btd")
    entry = rule[0] if rule is not None else None
    return entry if entry is not None and ctx.mesh.axes_size(entry) > 1 \
        else None


def _moe_ep(params, x_flat, cfg: ModelConfig, ctx):
    """EP: this rank's experts over every token; partial outputs summed.
    Training through it on the card (its backward through the all-reduce)
    is not ported and raises; the dry run's count on fake CPU tensors
    differentiates it."""
    if x_flat.is_cuda and torch.is_grad_enabled() and (
            x_flat.requires_grad or any(
                params[n].requires_grad
                for n in ("router", "w_gate", "w_up", "w_down"))):
        raise NotImplementedError(
            "training through the expert-parallel MoE is not ported to the "
            "card: it is queued in ROADMAP.md (A3)")
    mesh, axis = ctx.mesh, ctx.ep_axis
    E = cfg.n_experts_padded
    n_local = E // mesh.axes_size(axis)
    idx = mesh.index(axis)
    local = {"router": enter_split(params["router"], axis, mesh)}
    for name in ("w_gate", "w_up", "w_down"):
        w = params[name]
        local[name] = w if w.shape[0] == n_local else \
            w.narrow(0, idx * n_local, n_local)
    bdp = _batch_axes(ctx)
    T = x_flat.shape[0]
    xs = x_flat
    if bdp is not None:            # the whole batch, as the region sees it
        xs = gather_on_use(x_flat, 0, bdp, mesh, T * mesh.axes_size(bdp),
                           ctx.dp_axes)
    # the ranks' partial combines summed in fp32 and rounded once, as the
    # one-device combine is (the reference rounds each to bf16 first)
    y = _moe_local(local, enter_split(xs, axis, mesh), cfg, n_local,
                   idx * n_local, out_dtype=torch.float32)
    y = leave_split(y, axis, mesh).to(x_flat.dtype)
    if bdp is not None:
        y = y.narrow(0, mesh.index(bdp) * T, T)
    return y


def _moe_dp(params, x_flat, cfg: ModelConfig, ctx):
    """DP: each rank routes its own tokens with every expert.  Where the
    activations arrive whole, the rank takes its 1/dp of the rows and the
    ranks' outputs are gathered back."""
    E = cfg.n_experts_padded
    if _batch_axes(ctx) is not None:      # already the rank's own tokens
        return _moe_local(params, x_flat, cfg, E, 0)
    mesh, axes = ctx.mesh, ctx.dp_axes
    T = x_flat.shape[0]
    n = T // mesh.axes_size(axes)
    mine = enter_split(x_flat, axes, mesh).narrow(0, mesh.index(axes) * n, n)
    y = _moe_local(params, mine, cfg, E, 0)
    return gather_on_use(y, 0, axes, mesh, T)


def moe_ffn(params, x, cfg: ModelConfig):
    """x: (B, S, D) → (B, S, D).  With a sharding context whose
    ``ep_axis`` is set, the expert-parallel branch; with batch axes and no
    EP, and T divisible by their size, the data-parallel one; otherwise all
    experts on this device, the capacity sized from the call's B·S
    tokens."""
    B, S, D = x.shape
    x_flat = x.reshape(-1, D)
    ctx = current_context()
    if ctx is not None and ctx.ep_axis is not None:
        y = _moe_ep(params, x_flat, cfg, ctx)
    elif (ctx is not None and ctx.dp_axes
          and (_batch_axes(ctx) is not None or
               x_flat.shape[0] % ctx.mesh.axes_size(ctx.dp_axes) == 0)):
        y = _moe_dp(params, x_flat, cfg, ctx)
    else:
        y = _moe_local(params, x_flat, cfg, cfg.n_experts_padded, 0)
    y = y.view(B, S, D)
    if cfg.moe_dense_residual:
        y = y + mlp_block(params["dense"], x, cfg)
    return y
