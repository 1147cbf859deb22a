"""AdamW and Adafactor on trees (nested dicts) of tensors (the counterpart of
``repro.optim.optimizers``).

State trees mirror the parameter tree.  Unlike the JAX package, which returns
new arrays, ``update`` writes the new parameters and state IN PLACE and
returns the same trees: a full-width model's fp32 moments are 8 B a
parameter, and a second copy of them is what the in-place update saves.
Updates run per tensor under ``torch.no_grad``, in fp32, and round once to
the parameter's dtype.  ``count`` is a 0-d int32 tensor on the parameters'
device, so the schedules, bias corrections and the whole step need no
host sync.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple]     # (grads, state, params, step=None) -> (params, state, gnorm)
    name: str = "opt"


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the dict structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _global_norm(leaves) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` (in place) to a global norm of at most ``max_norm``;
    returns (grads, the norm before clipping)."""
    leaves = tree_leaves(grads)
    norm = _global_norm(leaves)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in leaves:
        g.mul_(scale)
    return grads, norm


def _lr(lr, count: torch.Tensor):
    return lr(count) if callable(lr) else lr


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(lr: float | Callable = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          grad_clip: float = 1.0) -> Optimizer:

    def init(params):
        first = tree_leaves(params)[0]
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=first.device)}

    @torch.no_grad()
    def update(grads, state, params, step=None):
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        state["count"].add_(1)
        count = state["count"]
        lr_t = _lr(lr, count)
        cf = count.float()
        bc1 = 1 - b1 ** cf
        bc2 = 1 - b2 ** cf
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]),
                              tree_leaves(state["v"])):
            gf = g.float()
            m.mul_(b1).add_(gf, alpha=1 - b1)
            v.mul_(b2).addcmul_(gf, gf, value=1 - b2)
            pf = p.float()
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * pf
            p.copy_(pf - lr_t * upd)
        return params, state, gnorm

    return Optimizer(init=init, update=update, name="adamw")


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no first moment)
# ---------------------------------------------------------------------------

def adafactor(lr: float | Callable = 1e-3, decay: float = 0.8,
              eps: float = 1e-30, clip_threshold: float = 1.0,
              weight_decay: float = 0.0, grad_clip: float = 1.0) -> Optimizer:

    def _factored(shape) -> bool:
        return len(shape) >= 2

    def init(params):
        def st(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        first = tree_leaves(params)[0]
        return {"s": tree_map(st, params),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=first.device)}

    @torch.no_grad()
    def update(grads, state, params, step=None):
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        state["count"].add_(1)
        count = state["count"]
        lr_t = _lr(lr, count)
        beta = 1.0 - count.float() ** -decay
        slots = _slot_leaves(state["s"])
        for p, g, s in zip(tree_leaves(params), tree_leaves(grads), slots):
            gf = g.float()
            g2 = gf * gf + eps
            if _factored(p.shape):
                s["vr"].copy_(beta * s["vr"] + (1 - beta) * g2.mean(dim=-1))
                s["vc"].copy_(beta * s["vc"] + (1 - beta) * g2.mean(dim=-2))
                vr, vc = s["vr"], s["vc"]
                denom = (vr / torch.clamp(vr.mean(dim=-1, keepdim=True),
                                          min=eps))[..., None] \
                    * vc[..., None, :]
                u = gf * torch.rsqrt(torch.clamp(denom, min=eps))
            else:
                s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
                u = gf * torch.rsqrt(torch.clamp(s["v"], min=eps))
            # update clipping (RMS <= clip_threshold)
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            pf = p.float()
            p.copy_(pf - (lr_t * u + weight_decay * lr_t * pf))
        return params, state, gnorm

    return Optimizer(init=init, update=update, name="adafactor")


def _slot_leaves(tree) -> list:
    """The per-parameter slot dicts ({"vr", "vc"} or {"v"}) of an Adafactor
    state tree, in parameter order."""
    if isinstance(tree, dict) and ("v" in tree or "vr" in tree):
        return [tree]
    return [s for v in tree.values() for s in _slot_leaves(v)]


def pick_optimizer(n_params: int, lr=None) -> Optimizer:
    """Policy: Adafactor at >= 100B params (memory), AdamW below."""
    if n_params >= 100e9:
        return adafactor(lr=lr or 1e-3)
    return adamw(lr=lr or 3e-4)


__all__ = ["Optimizer", "adamw", "adafactor", "pick_optimizer",
           "clip_by_global_norm", "tree_leaves", "tree_map"]
