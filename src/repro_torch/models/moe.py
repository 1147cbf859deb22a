"""Mixture-of-Experts FFN, the local path (the counterpart of
``repro.models.moe`` without its expert- and data-parallel ``shard_map``
branches, which come with the distributed slice).

Routing: top-k softmax over the real experts (the padding experts masked
to -inf: granite's 40 experts are padded to 48).  Capacity: each expert
takes at most C = ⌈T·k/E⌉·1.25 of the call's T tokens (E the real
experts); assignments past C are dropped in token order (GShard-style).  C
depends on the call's T, so a decode step of B lanes has its own capacity
and the lanes of one call share it.  The three expert products run through
the ``moe_gmm`` grouped matmul with equal groups of C.

The combine is deterministic: each assignment's weighted contribution goes
back to its (token, k) place, zero where dropped, and the k axis is summed
in fp32 in a fixed order (the JAX package scatter-adds; ``index_add_`` on
CUDA would add in another order on every run).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
               expert_offset: int):
    """Dispatch, compute and combine for the local experts (all of them
    here: n_local = E_padded, expert_offset = 0)."""
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

    # combine, in (token, k) order: the inverse of the sort gives each
    # assignment its slot
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=dev)
    rows = ye[slot[inv].clamp(max=n_local * cap - 1)]
    wgt_kept = torch.where(keep[inv], wgt, 0.0)     # ye's rows are finite
    return (rows * wgt_kept[:, None]).view(T, k, D).sum(dim=1).to(
        x_flat.dtype)


def moe_ffn(params, x, cfg: ModelConfig):
    """x: (B, S, D) → (B, S, D), all experts on this device.  The capacity
    is sized from the call's B·S tokens."""
    B, S, D = x.shape
    y = _moe_local(params, x.reshape(-1, D), cfg, cfg.n_experts_padded, 0)
    y = y.view(B, S, D)
    if cfg.moe_dense_residual:
        y = y + mlp_block(params["dense"], x, cfg)
    return y
